"""Partial tiles in K6 (csrc/td3_update.cuh) built for the host: a batch, or
a ring's lanes, that the tile of TS samples does not divide, down to rows
whose stride is no multiple of 4 floats.  The samples past a row's end must
add nothing, the actor's -1/B seed included: each case is held to the plain
version on the real samples alone (tests/learner_host.py says how), also in
a cluster of 2 blocks and without clusters (the recorded bits).
"""
import pytest

from .learner_host import check_td3, host_library, td3_clusters
from .torch_scenarios import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return host_library("td3_update", tmp_path_factory)


# h, obs_dim, K, B, ring lanes (0: gathered minibatches), mm_bf16, blocks resident,
# policy_delay, plain updates taken before (the starting count)
CASES = [
    (256, 13, 1, 90, 0, True, 2, 2, 2),      # tiles of 64 and 26 samples; a delayed update
    (256, 13, 1, 90, 45, False, 2, 1, 1),    # ring lanes 45, one partial tile a row; delay 1
]


@pytest.mark.parametrize("h,obs_dim,K,B,lanes,bf,sms,delay,warm", CASES)
def test_host_built_kernel_takes_partial_tiles(host_lib, h, obs_dim, K, B, lanes, bf, sms, delay,
                                               warm):
    check_td3(host_lib, h, obs_dim, K, B, lanes, bf, sms, delay, warm)


# h, obs_dim, K, B, ring lanes, mm_bf16, blocks resident, policy_delay, plain updates
# taken before, the largest cluster, the cluster size the plan takes, the digest of
# K6's outputs (C = 1: the launch's without clusters)
CLUSTER_CASES = [
    (256, 13, 1, 90, 45, True, 2, 2, 2, 2, 2, None),     # a partial tile a block; delayed
    (256, 13, 1, 90, 45, True, 2, 2, 1, 1, 1, "972870e738dc8c16"),
    (256, 13, 1, 90, 0, False, 2, 1, 1, 2, 2, None),     # 64 and 26 samples; delay 1
]


@pytest.mark.parametrize("h,obs_dim,K,B,lanes,bf,sms,delay,warm,cmax,want_c,want", CLUSTER_CASES)
def test_host_built_kernel_takes_partial_tiles_in_clusters(host_lib, h, obs_dim, K, B, lanes, bf,
                                                           sms, delay, warm, cmax, want_c, want):
    td3_clusters(host_lib, h, obs_dim, K, B, lanes, bf, sms, delay, warm, cmax, want_c, want)
