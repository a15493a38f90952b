"""K6's bf16 mode (csrc/td3_update.cuh on the emulated tensor cores, MTile)
built for the host at the smallest shapes: one tile on one block, K of 2, at
the narrowest and the widest width (tests/test_torch_td3_kernel_host.py has
H=256 and 384).  Each case holds the kernel to the plain version with bf16-rounded
products and K launches of one update to one launch of K, bit for bit
(tests/learner_host.py): a launch builds the bf16 shadow of the six networks'
W1 and W2 anew, so equal bits show that every weight a launch moves (the
critics on every update; the actor and both targets, by their polyak step,
on a delayed one) reaches its shadow row before the next product reads it.
"""
import pytest

from .learner_host import check_td3, host_library
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
