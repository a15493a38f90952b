"""K4 and K5 (csrc/sac_update.cuh) built for the host, float32 mode: held to
the plain version `update_k_reference` (tests/learner_host.py says how);
also the plan's refusals, sizes and thread block clusters, and the emulated
tensor-core fragments that the bf16 mode
(tests/test_torch_sac_kernel_host_bf16.py) runs on.  Cases cover every tile,
both data modes, more tiles than blocks (K5 folds the further tiles of a
block in turn and equals K4 bit for bit), four widths, and clusters of 1, 2
and 4 blocks (the bits of 1 those of the launch without clusters; those of
2 and 4 also with the last block of each cluster lagging).
"""
import ctypes

import numpy as np
import pytest
import torch

from .learner_host import check_sac, host_library, sac_clusters, sac_lagging
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
    # H, W, obs_dim, tiles, mm_bf16, the largest cluster (1: none) -> grid, smem, cluster
    plan = (ctypes.c_int * 3)()
    host_lib.host_set_sms(4)
    for bf in (0, 1):
        assert host_lib.sg_sac_update_plan(640, 40, 13, 4, bf, 1, plan) == -1
    rest = 40 * 64 + 4 * 64 + 40 * 64 + 28 * 64 + 4 * 64 * 8 + 32
    # float32: a chunk of 16 float32 weight rows; bf16: two stages of 32 x 256 bf16
    for bf, weights in ((0, 16 * 256), (1, 32 * 256)):
        assert host_lib.sg_sac_update_plan(256, 40, 13, 4, bf, 1, plan) == 0 and plan[0] == 4
        assert plan[1] == 4 * (2 * 64 * 256 + weights + rest) and plan[2] == 1
    # every width fits the card's 227 KB with K5's two tile buffers, and K5
    # plans K4's grid whatever the tiles: min(tiles, resident blocks)
    for h in (128, 256, 384, 512):
        for bf in (0, 1):
            assert host_lib.sg_sac_update_fold_plan(h, 40, 13, 4, bf, 1, plan) == 0, (h, bf)
            assert plan[1] <= 232448
            assert host_lib.sg_sac_update_fold_plan(h, 40, 13, 9, bf, 1, plan) == 0 and plan[0] == 4


def test_host_build_plans_clusters(host_lib):
    """The plan takes the largest cluster of 8, 4 or 2 blocks that gives no
    block more tiles than the grid without clusters, holds as many tiles in
    each of a cluster's blocks, and leaves room for the exchange rows; K4 and
    K5 plan the same; the shared memory grows by the exchange rows."""
    plan = (ctypes.c_int * 3)()

    def planned(fold, h, tiles, sms, cmax=8, bf=1, W=40, od=13):
        host_lib.host_set_sms(sms)
        fn = host_lib.sg_sac_update_fold_plan if fold else host_lib.sg_sac_update_plan
        assert fn(h, W, od, tiles, bf, cmax, plan) == 0
        return plan[0], plan[2]

    for fold in (False, True):
        assert planned(fold, 256, 16, 8) == (8, 8)          # two tiles a block either way
        assert planned(fold, 256, 16, 8, cmax=4) == (8, 4)
        assert planned(fold, 256, 12, 6) == (6, 2)          # 4 clusters of 4 would hold 3 tiles
        assert planned(fold, 256, 9, 4) == (4, 1)           # 3, 2, 2, 2 tiles: no even cluster
        assert planned(fold, 256, 6, 4) == (4, 2)           # 2, 2, 1, 1 tiles: clusters of 2
        assert planned(fold, 256, 4, 8, cmax=1) == (4, 1)
        assert planned(fold, 128, 8, 8) == (8, 1)           # K5 leaves no room at H=128
        assert planned(fold, 384, 8, 8) == (8, 4)           # a warp's 32 rows: 384 / 32 C
        assert planned(fold, 256, 8, 8, od=16) == (8, 1)     # no room for 22 rows
    host_lib.host_set_sms(4)
    assert host_lib.sg_sac_update_plan(256, 40, 13, 4, 1, 1, plan) == 0
    alone = plan[1]
    assert host_lib.sg_sac_update_plan(256, 40, 13, 4, 1, 4, plan) == 0 and plan[2] == 4
    assert plan[1] == alone + 4 * (8 + 19 * 256)     # the misc values and 19 rows of H


# h, obs_dim, K, B, ring lanes, mm_bf16, blocks resident, the largest cluster, the
# cluster size the plan takes, the digest of K4's outputs (C = 1: the launch's
# without clusters)
CLUSTER_CASES = [
    (256, 13, 1, 128, 64, False, 2, 1, 1, "3fe22cc4942ccfe4"),
    (256, 13, 1, 256, 64, False, 4, 2, 2, None),
    (256, 13, 1, 256, 0, False, 4, 4, 4, None),
    (128, 13, 1, 256, 128, False, 2, 2, 1, "0301fdfcfed6cefb"),    # no room: no cluster
]


@pytest.mark.parametrize("h,obs_dim,K,B,lanes,bf,sms,cmax,want_c,want", CLUSTER_CASES)
def test_host_built_kernels_in_clusters(host_lib, h, obs_dim, K, B, lanes, bf, sms, cmax, want_c,
                                        want):
    sac_clusters(host_lib, h, obs_dim, K, B, lanes, bf, sms, cmax, want_c, want)


# h, obs_dim, K, B, ring lanes, mm_bf16, blocks resident, the largest cluster, the
# cluster size the plan takes
LAG_CASES = [
    (256, 13, 1, 256, 64, False, 4, 2, 2),
    (256, 13, 1, 256, 0, False, 4, 4, 4),
]


@pytest.mark.parametrize("h,obs_dim,K,B,lanes,bf,sms,cmax,want_c", LAG_CASES)
def test_host_built_kernels_in_clusters_with_a_lagging_block(
        host_lib, h, obs_dim, K, B, lanes, bf, sms, cmax, want_c):
    """The last block of each cluster lagging behind the others gives the
    same bits: no block rewrites its exchange rows while another still
    reads them."""
    sac_lagging(host_lib, h, obs_dim, K, B, lanes, bf, sms, cmax, want_c)


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
