"""K4 and K5 (csrc/sac_update.cuh) built for the host, float32 mode: held to
the plain version `update_k_reference` (tests/learner_host.py says how);
also the plan's refusals and sizes, and the emulated tensor-core fragments
that the bf16 mode (tests/test_torch_sac_kernel_host_bf16.py) runs on.
Cases cover every tile, both data modes, more tiles than blocks (K5 folds the
further tiles of a block in turn and equals K4 bit for bit) and four widths.
"""
import ctypes

import numpy as np
import pytest
import torch

from .learner_host import check_sac, host_library
from .torch_scenarios import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return host_library("sac_update", tmp_path_factory)


# h, obs_dim, K, B, ring lanes (0: gathered minibatches), mm_bf16, blocks resident, alpha_floor
CASES = [
    (256, 13, 2, 128, 64, False, 4, 0.0),    # the flagship width, two replay rows a minibatch
    (256, 17, 2, 128, 0, False, 1, 0.3),     # two tiles on one block; the floor clamps
    (512, 7, 1, 64, 32, False, 4, 0.0),
    (128, 13, 1, 256, 128, False, 4, 0.0),
]


@pytest.mark.parametrize("h,obs_dim,K,B,lanes,bf,sms,alpha_floor", CASES)
def test_host_built_kernels_match_the_plain_version(host_lib, h, obs_dim, K, B, lanes, bf, sms,
                                                    alpha_floor):
    check_sac(host_lib, h, obs_dim, K, B, lanes, bf, sms, alpha_floor)


def test_host_build_rejects_a_width_that_is_not_built(host_lib):
    plan = (ctypes.c_int * 2)()
    host_lib.host_set_sms(4)
    for bf in (0, 1):
        assert host_lib.sg_sac_update_plan(640, 40, 4, bf, plan) == -1
    rest = 40 * 64 + 4 * 64 + 40 * 64 + 28 * 64 + 4 * 64 * 8 + 32
    # float32: a chunk of 16 float32 weight rows; bf16: two stages of 32 x 256 bf16
    for bf, weights in ((0, 16 * 256), (1, 32 * 256)):
        assert host_lib.sg_sac_update_plan(256, 40, 4, bf, plan) == 0 and plan[0] == 4
        assert plan[1] == 4 * (2 * 64 * 256 + weights + rest)
    # every width fits the card's 227 KB with K5's two tile buffers, and K5
    # plans K4's grid whatever the tiles: min(tiles, resident blocks)
    for h in (128, 256, 384, 512):
        for bf in (0, 1):
            assert host_lib.sg_sac_update_fold_plan(h, 40, 4, bf, plan) == 0, (h, bf)
            assert plan[1] <= 232448
            assert host_lib.sg_sac_update_fold_plan(h, 40, 9, bf, plan) == 0 and plan[0] == 4


# The fragment sources of host_mma_tile: A by ldmatrix, packed from the rows of
# A, packed from the rows of A^T; B by ldmatrix.trans from the rows of B, by
# ldmatrix from the rows of B^T, packed from the rows of B.
@pytest.mark.parametrize("amode", [0, 1, 2], ids=["a-ldmatrix", "a-rows", "a-cols"])
@pytest.mark.parametrize("bmode", [0, 1, 2], ids=["b-ldmatrix-trans", "b-ldmatrix", "b-rows"])
def test_emulated_mma_fragments(host_lib, amode, bmode):
    """One warp's two m16n8k16 products through the emulated ldmatrix and
    mma.sync, against a plain (16, 16) x (16, 8) product each: bf16 values,
    exact products, float32 sums."""
    rng = np.random.default_rng(3 * amode + bmode)
    bf16 = lambda a: torch.as_tensor(a, dtype=torch.float32).to(torch.bfloat16).float()
    A = bf16(rng.standard_normal((16, 16))).contiguous()
    B = bf16(rng.standard_normal((16, 16))).contiguous()
    D = torch.full((16, 16), float("nan"))
    assert host_lib.host_mma_tile(A.data_ptr(), B.data_ptr(), D.data_ptr(), amode, bmode) == 0
    want = A.double() @ B.double()
    for nt in (0, 1):
        cols = slice(8 * nt, 8 * nt + 8)
        np.testing.assert_allclose(D[:, cols].numpy(), want[:, cols].numpy(), rtol=1e-6,
                                   atol=1e-5)
