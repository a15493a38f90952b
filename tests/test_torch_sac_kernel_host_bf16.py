"""K4 and K5 (csrc/sac_update.cuh) built for the host, bf16 mode: the
products on the emulated tensor cores (MTile), held to the plain version with
bf16-rounded products (tests/learner_host.py says how).  The float32 mode and
the fragments are in tests/test_torch_sac_kernel_host.py.
"""
import pytest

from .learner_host import check_sac, host_library
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
