// K4: K SAC updates in one launch, every phase reading its minibatch tiles
// from device memory.  Replaces space_gym_tpu/models/fused_sac.py:759 (the
// (K, 2, T) grid kernel).  The device code is sac_update.cuh.
#include "sac_update.cuh"

SAC_UPDATE_ENTRY(sg_sac_update, false)
