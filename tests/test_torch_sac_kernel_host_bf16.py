"""K4 and K5 (csrc/sac_update.cuh) built for the host, bf16 mode: the
products on the emulated tensor cores (MTile), held to the plain version with
bf16-rounded products (tests/learner_host.py says how), also in clusters of 1,
2 and 4 blocks (the bits of 1 those of the launch without clusters; those of
2 also with the last block of each cluster lagging).  The float32 mode and
the fragments are in tests/test_torch_sac_kernel_host.py.
"""
import pytest

from .learner_host import check_sac, host_library, sac_clusters, sac_lagging
from .torch_scenarios import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return host_library("sac_update", tmp_path_factory)


# h, obs_dim, K, B, ring lanes (0: gathered minibatches), mm_bf16, blocks resident, alpha_floor
CASES = [
    (256, 13, 1, 128, 64, True, 4, 0.0),     # bf16-rounded products
    (384, 9, 1, 64, 0, True, 2, 0.0),
    # the tensor-core path at the other widths, and with more tiles than blocks
    (128, 13, 1, 256, 128, True, 4, 0.0),
    (512, 7, 1, 32, 32, True, 2, 0.0),
    (256, 17, 2, 128, 0, True, 1, 0.3),
]


@pytest.mark.parametrize("h,obs_dim,K,B,lanes,bf,sms,alpha_floor", CASES)
def test_host_built_kernels_match_the_plain_version(host_lib, h, obs_dim, K, B, lanes, bf, sms,
                                                    alpha_floor):
    check_sac(host_lib, h, obs_dim, K, B, lanes, bf, sms, alpha_floor)


# h, obs_dim, K, B, ring lanes, mm_bf16, blocks resident, the largest cluster, the
# cluster size the plan takes, the digest of K4's outputs (C = 1: the launch's
# without clusters)
CLUSTER_CASES = [
    (256, 13, 1, 128, 64, True, 2, 1, 1, "a2b724619ddcccb0"),
    (256, 13, 2, 128, 64, True, 2, 2, 2, None),      # and K launches of one update
    (256, 13, 1, 256, 0, True, 4, 4, 4, None),
    (128, 13, 1, 256, 128, True, 2, 4, 1, "9d5093505a28688d"),     # no room: no cluster
    (256, 7, 1, 256, 64, True, 4, 2, 2, None),       # b2, w3 and heads flushed apart
]


@pytest.mark.parametrize("h,obs_dim,K,B,lanes,bf,sms,cmax,want_c,want", CLUSTER_CASES)
def test_host_built_kernels_in_clusters(host_lib, h, obs_dim, K, B, lanes, bf, sms, cmax, want_c,
                                        want):
    sac_clusters(host_lib, h, obs_dim, K, B, lanes, bf, sms, cmax, want_c, want)


# h, obs_dim, K, B, ring lanes, mm_bf16, blocks resident, the largest cluster, the
# cluster size the plan takes
LAG_CASES = [
    (256, 13, 1, 128, 64, True, 2, 2, 2),
    (256, 7, 1, 256, 64, True, 4, 2, 2),       # b2, w3 and heads flushed apart
]


@pytest.mark.parametrize("h,obs_dim,K,B,lanes,bf,sms,cmax,want_c", LAG_CASES)
def test_host_built_kernels_in_clusters_with_a_lagging_block(
        host_lib, h, obs_dim, K, B, lanes, bf, sms, cmax, want_c):
    """The last block of each cluster lagging behind the others gives the
    same bits: no block rewrites its exchange rows while another still
    reads them."""
    sac_lagging(host_lib, h, obs_dim, K, B, lanes, bf, sms, cmax, want_c)
