"""K6 (csrc/td3_update.cuh) built for the host, held to the plain version
`update_k_reference` (tests/learner_host.py says how): every tile, both data
modes, both product paths, more tiles than blocks, three widths, delayed and
non-delayed updates, an odd starting count with policy_delay 2 and 3, and
clusters of 1 and 2 blocks (the bits of 1 those of the launch without
clusters; those of 2 also with the last block of each cluster lagging).
More of the tensor-core path is in tests/test_torch_td3_kernel_host_bf16.py.
"""
import ctypes

import pytest

from .learner_host import check_td3, host_library, td3_clusters, td3_lagging
from .torch_scenarios import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return host_library("td3_update", tmp_path_factory)


# h, obs_dim, K, B, ring lanes (0: gathered minibatches), mm_bf16, blocks resident,
# policy_delay, plain updates taken before (the starting count)
CASES = [
    (256, 13, 3, 128, 64, False, 4, 2, 1),   # odd count: updates 1, 2, 3; two ring rows a batch
    (256, 17, 2, 128, 0, False, 1, 2, 2),    # two tiles on one block; delayed then not
    (256, 13, 2, 128, 64, True, 4, 2, 1),    # bf16-rounded products; not delayed then delayed
    (512, 7, 2, 64, 32, False, 4, 3, 2),     # delay 3 from count 2: only update 3 is delayed
    (128, 13, 3, 256, 128, False, 4, 3, 1),  # delay 3 from an odd count
    (384, 9, 1, 64, 0, True, 2, 1, 1),       # delay 1: every update is delayed
]


@pytest.mark.parametrize("h,obs_dim,K,B,lanes,bf,sms,delay,warm", CASES)
def test_host_built_kernel_matches_the_plain_version(host_lib, h, obs_dim, K, B, lanes, bf, sms,
                                                     delay, warm):
    check_td3(host_lib, h, obs_dim, K, B, lanes, bf, sms, delay, warm)


def test_host_build_rejects_a_width_that_is_not_built(host_lib):
    # H, W, obs_dim, tiles, mm_bf16, the largest cluster (1: none) -> grid, smem, cluster
    plan = (ctypes.c_int * 3)()
    host_lib.host_set_sms(4)
    rest = 40 * 64 + 2 * 64 + 40 * 64 + 12 * 64 + 2 * 64 * 8 + 32
    # float32: a chunk of 16 float32 weight rows; bf16: two stages of 32 x 256 bf16
    for bf, weights in ((0, 16 * 256), (1, 32 * 256)):
        assert host_lib.sg_td3_update_plan(640, 40, 13, 4, bf, 1, plan) == -1
        assert host_lib.sg_td3_update_plan(256, 40, 13, 6, bf, 1, plan) == 0 and plan[0] == 4
        assert plan[1] == 4 * (2 * 64 * 256 + weights + rest) and plan[2] == 1
        assert host_lib.sg_td3_update_plan(256, 40, 13, 2, bf, 1, plan) == 0 and plan[0] == 2
        # a ring so wide that the kernel's shared memory cannot hold a tile of it
        assert host_lib.sg_td3_update_plan(512, 2000, 13, 4, bf, 1, plan) == -2
        # with clusters: 2 of 2 blocks for 6 tiles on 4 blocks (2, 2, 1, 1 tiles),
        # and the exchange rows (the misc values and a critic's 18 rows of H)
        assert host_lib.sg_td3_update_plan(256, 40, 13, 6, bf, 8, plan) == 0
        assert (plan[0], plan[2]) == (4, 2)
        assert plan[1] == 4 * (2 * 64 * 256 + weights + rest + 8 + 18 * 256)


# h, obs_dim, K, B, ring lanes, mm_bf16, blocks resident, policy_delay, plain updates
# taken before, the largest cluster, the cluster size the plan takes, the digest of
# K6's outputs (C = 1: the launch's without clusters)
CLUSTER_CASES = [
    (256, 13, 1, 128, 64, False, 2, 2, 1, 1, 1, "01e99872e164c6ec"),
    (256, 13, 2, 256, 64, False, 4, 2, 1, 2, 2, None),   # not delayed, then delayed
    (128, 13, 1, 256, 128, False, 2, 1, 1, 2, 2, None),  # delay 1: delayed
]


@pytest.mark.parametrize("h,obs_dim,K,B,lanes,bf,sms,delay,warm,cmax,want_c,want", CLUSTER_CASES)
def test_host_built_kernel_in_clusters(host_lib, h, obs_dim, K, B, lanes, bf, sms, delay, warm,
                                       cmax, want_c, want):
    td3_clusters(host_lib, h, obs_dim, K, B, lanes, bf, sms, delay, warm, cmax, want_c, want)


# h, obs_dim, K, B, ring lanes, mm_bf16, blocks resident, policy_delay, plain updates
# taken before, the largest cluster, the cluster size the plan takes
LAG_CASES = [
    (256, 13, 2, 256, 64, False, 4, 2, 1, 2, 2),   # not delayed, then delayed
]


@pytest.mark.parametrize("h,obs_dim,K,B,lanes,bf,sms,delay,warm,cmax,want_c", LAG_CASES)
def test_host_built_kernel_in_clusters_with_a_lagging_block(
        host_lib, h, obs_dim, K, B, lanes, bf, sms, delay, warm, cmax, want_c):
    """The last block of each cluster lagging behind the others gives the
    same bits: no block rewrites its exchange rows while another still
    reads them."""
    td3_lagging(host_lib, h, obs_dim, K, B, lanes, bf, sms, delay, warm, cmax, want_c)
