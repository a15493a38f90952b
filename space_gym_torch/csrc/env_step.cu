// Kernel K2, physics, observation and reward of one control step: see
// env_step.cuh.
#include "env_step.cuh"

SG_DEFINE_ENV_STEP()
