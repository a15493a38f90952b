// K5: K SAC updates in one launch with one tile per block, fetched once per
// update into shared memory for both phases, the next update's tile copied in
// (cp.async, two buffers) while this one computes.  Replaces
// space_gym_tpu/models/fused_sac.py:852 and :866 (the folded (K,) grid
// kernels).  The device code is sac_update.cuh.
#include "sac_update.cuh"

SAC_UPDATE_ENTRY(sg_sac_update_fold, true)
