"""Partial tiles in K4 and K5 (csrc/sac_update.cuh) built for the host: a
batch, or a ring's lanes, that the tile of TS samples does not divide, down
to rows whose stride is no multiple of 4 floats, and a block that folds
several tiles (more tiles than blocks).  The samples past a row's end must
add nothing: each case is held to the plain version on the real samples
alone, K5 to K4 bit for bit (tests/learner_host.py says how), also in a
cluster of 2 blocks and without clusters (the recorded bits).
"""
import pytest

from .learner_host import check_sac, host_library, sac_clusters
from .torch_scenarios import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return host_library("sac_update", tmp_path_factory)


# h, obs_dim, K, B, ring lanes (0: gathered minibatches), mm_bf16, blocks resident, alpha_floor
CASES = [
    (256, 13, 1, 90, 0, False, 2, 0.0),      # tiles of 64 and 26 samples, rows 90 floats apart
    (256, 13, 1, 90, 45, True, 2, 0.0),      # ring lanes 45: one partial tile a ring row
    (128, 13, 1, 300, 0, True, 1, 0.0),      # three tiles (128, 128, 44) on one block
]


@pytest.mark.parametrize("h,obs_dim,K,B,lanes,bf,sms,alpha_floor", CASES)
def test_host_built_kernels_take_partial_tiles(host_lib, h, obs_dim, K, B, lanes, bf, sms,
                                               alpha_floor):
    check_sac(host_lib, h, obs_dim, K, B, lanes, bf, sms, alpha_floor)


# h, obs_dim, K, B, ring lanes, mm_bf16, blocks resident, the largest cluster, the
# cluster size the plan takes, the digest of K4's outputs (C = 1: the launch's
# without clusters)
CLUSTER_CASES = [
    (256, 13, 1, 90, 45, True, 2, 2, 2, None),       # a partial tile in each block
    (256, 13, 1, 90, 45, True, 2, 1, 1, "92b393280a162676"),
    (256, 13, 1, 90, 0, False, 2, 2, 2, None),       # 64 and 26 samples, rows 90 floats apart
]


@pytest.mark.parametrize("h,obs_dim,K,B,lanes,bf,sms,cmax,want_c,want", CLUSTER_CASES)
def test_host_built_kernels_take_partial_tiles_in_clusters(host_lib, h, obs_dim, K, B, lanes, bf,
                                                           sms, cmax, want_c, want):
    sac_clusters(host_lib, h, obs_dim, K, B, lanes, bf, sms, cmax, want_c, want)
