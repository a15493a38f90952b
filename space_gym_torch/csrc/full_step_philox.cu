// Kernel K3-hw: the whole env step with Philox4x32-10 uniforms computed in the
// kernel from two key words, where the TPU kernel seeds its core's hardware
// generator (replaces space_gym_tpu/ops/pallas_full.py:500 with
// in_kernel_rng="hw", :518-528): see full_step.cuh and rng.cuh.
#include "full_step.cuh"

SG_DEFINE_FULL_STEP(sg_full_step_philox, PhiloxRows)
SG_DEFINE_FILL_UNIFORMS(sg_fill_uniforms_philox, PhiloxRows)
