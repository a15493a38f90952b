// Kernel K1, the physics of one control step: see fused_step.cuh.
#include "fused_step.cuh"

SG_DEFINE_FUSED_STEP()
