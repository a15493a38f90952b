"""K6's bf16 mode (csrc/td3_update.cuh on the emulated tensor cores, MTile)
built for the host at the smallest shapes: one tile on one block, K of 2, at
the narrowest and the widest width (tests/test_torch_td3_kernel_host.py has
H=256 and 384).  Each case holds the kernel to the plain version with bf16-rounded
products and K launches of one update to one launch of K, bit for bit
(tests/learner_host.py): a launch builds the bf16 shadow of the six networks'
W1 and W2 anew, so equal bits show that every weight a launch moves (the
critics on every update; the actor and both targets, by their polyak step,
on a delayed one) reaches its shadow row before the next product reads it.
Also in clusters of 1, 2 and 4 blocks (the bits of 1 those of the launch
without clusters; those of 2 also with the last block of each cluster
lagging).
"""
import pytest

from .learner_host import check_td3, host_library, td3_clusters, td3_lagging
from .torch_scenarios import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return host_library("td3_update", tmp_path_factory)


# h, obs_dim, K, B, ring lanes (0: gathered minibatches), mm_bf16, blocks resident,
# policy_delay, plain updates taken before (the starting count)
CASES = [
    (128, 13, 2, 128, 128, True, 1, 1, 1),   # the narrowest width, policy_delay 1: both
                                             # updates move the targets
    (512, 7, 2, 32, 32, True, 1, 2, 1),      # the widest, policy_delay 2 from an odd count:
                                             # not delayed, then delayed
]


@pytest.mark.parametrize("h,obs_dim,K,B,lanes,bf,sms,delay,warm", CASES)
def test_host_built_kernel_bf16_mode(host_lib, h, obs_dim, K, B, lanes, bf, sms, delay, warm):
    check_td3(host_lib, h, obs_dim, K, B, lanes, bf, sms, delay, warm)


# h, obs_dim, K, B, ring lanes, mm_bf16, blocks resident, policy_delay, plain updates
# taken before, the largest cluster, the cluster size the plan takes, the digest of
# K6's outputs (C = 1: the launch's without clusters)
CLUSTER_CASES = [
    (256, 13, 1, 128, 64, True, 2, 2, 1, 1, 1, "e95946ad29a2779e"),
    (256, 13, 1, 256, 0, True, 4, 2, 2, 4, 4, None),     # delayed
    (128, 13, 1, 256, 128, True, 2, 2, 2, 2, 2, None),   # delayed; dz2 packed from float32
    (128, 13, 1, 256, 128, True, 2, 2, 1, 1, 1, "7569e21c975d9c94"),
    (256, 7, 1, 256, 0, True, 4, 2, 2, 2, 2, None),     # b2, w3 and heads flushed apart
]


@pytest.mark.parametrize("h,obs_dim,K,B,lanes,bf,sms,delay,warm,cmax,want_c,want", CLUSTER_CASES)
def test_host_built_kernel_bf16_mode_in_clusters(host_lib, h, obs_dim, K, B, lanes, bf, sms, delay,
                                                 warm, cmax, want_c, want):
    td3_clusters(host_lib, h, obs_dim, K, B, lanes, bf, sms, delay, warm, cmax, want_c, want)


# h, obs_dim, K, B, ring lanes, mm_bf16, blocks resident, policy_delay, plain updates
# taken before, the largest cluster, the cluster size the plan takes
LAG_CASES = [
    (256, 13, 1, 256, 0, True, 4, 2, 2, 2, 2),     # delayed
]


@pytest.mark.parametrize("h,obs_dim,K,B,lanes,bf,sms,delay,warm,cmax,want_c", LAG_CASES)
def test_host_built_kernel_in_clusters_with_a_lagging_block(
        host_lib, h, obs_dim, K, B, lanes, bf, sms, delay, warm, cmax, want_c):
    """The last block of each cluster lagging behind the others gives the
    same bits: no block rewrites its exchange rows while another still
    reads them."""
    td3_lagging(host_lib, h, obs_dim, K, B, lanes, bf, sms, delay, warm, cmax, want_c)
