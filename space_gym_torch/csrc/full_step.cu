// Kernel K3 with the uniforms drawn outside the kernel and read from device
// memory (in_kernel_rng=False): see full_step.cuh.
#include "full_step.cuh"

SG_DEFINE_FULL_STEP(sg_full_step, MemRows)
