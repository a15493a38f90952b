// Kernel K3-tf: the whole env step with threefry2x32 uniforms computed in the
// kernel from two key words, the bits of jax.random.uniform (replaces
// space_gym_tpu/ops/pallas_full.py:500 with in_kernel_rng="threefry",
// :529-536, :75-109): see full_step.cuh and rng.cuh.
#include "full_step.cuh"

SG_DEFINE_FULL_STEP(sg_full_step_threefry, ThreefryRows)
SG_DEFINE_FILL_UNIFORMS(sg_fill_uniforms_threefry, ThreefryRows)
