// K6: K TD3 updates in one launch.  Replaces
// space_gym_tpu/models/fused_td3.py:421 (the (K, 2, T) grid kernel).  The
// device code is td3_update.cuh.
#include "td3_update.cuh"

TD3_UPDATE_ENTRY()
