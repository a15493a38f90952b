"""The learner kernels' LOGIC on the CPU: csrc/sac_update.cuh compiled by g++
against the stand-in CUDA headers of csrc/host/ (one OS thread per CUDA
thread, real barriers), held to the plain version `update_k_reference`.

The CUDA kernels K4 and K5 run only on a card (tests/test_torch_cuda.py).
This build says nothing about the card, but it runs the same source, so it
catches a wrong index, a missing barrier or wrong arithmetic here: every
tile, both data modes, more tiles than blocks, four widths, and both
product paths: float32 on the CUDA cores (mm_bf16=False) and the tensor
cores (mm_bf16=True), whose ldmatrix and mma.sync instructions the host
build emulates lane by lane with the fragment layouts of the PTX ISA
(csrc/host/mma_emul.h; `test_emulated_mma_fragments` holds them to a plain
product).  Tolerances as in tests/test_torch_fused_sac.py; K5 equals K4 bit
for bit in both modes.
"""
import ctypes
import math
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from space_gym_torch.models import fused_sac
from space_gym_torch.models.replay import Transition, pack_slab, replay_cols, unpack_flat
from space_gym_torch.utils.cuda_build import CSRC
from .torch_scenarios import one_torch_thread  # noqa: F401 (autouse)

HYPER = dict(gamma=0.99, tau=0.005, lr=3e-4, target_entropy=-2.0)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernels for the host")
    out = tmp_path_factory.mktemp("sac_host") / "libsac_update_host.so"
    host = os.path.join(CSRC, "host")
    subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-I", host,
                    "-o", str(out), os.path.join(host, "sac_update_host.cpp")],
                   check=True, capture_output=True, text=True, timeout=600)
    lib = ctypes.CDLL(str(out))
    p, i, fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.host_mma_tile.argtypes = [p, p, p, i, i]
    lib.host_mma_tile.restype = i
    for name in ("sg_sac_update", "sg_sac_update_fold"):
        fn = getattr(lib, name)
        fn.argtypes = [p] * 14 + [i] * 10 + [fl] * 6 + [p]
        fn.restype = i
        plan = getattr(lib, name + "_plan")
        plan.argtypes = [i, i, i, i, ctypes.POINTER(ctypes.c_int)]
        plan.restype = i
    return lib


def host_launch(lib, h, f, data, row_idx, noises, obs_dim, fold, bf, sms, alpha_floor=0.0):
    """What fused_sac._launch does on the card, on CPU tensors: scratch
    poisoned with NaN, state copied, the host library called."""
    name = "sg_sac_update_fold" if fold else "sg_sac_update"
    lib.host_set_sms(sms)
    K, B = noises.shape[:2]
    W = data.shape[1]
    ts = fused_sac.KERNEL_TILE[h]
    lanes, rpb = (B, 0) if row_idx is None else (data.shape[2], B // data.shape[2])
    n_tiles = B // ts
    plan = (ctypes.c_int * 2)()
    err = getattr(lib, name + "_plan")(h, W, n_tiles, int(bf), plan)
    if err:
        return err, None, None
    grid = plan[0]
    nan = float("nan")
    noise = noises.reshape(K, B, 4).transpose(1, 2).contiguous()
    partials = torch.full((grid, 2 * (obs_dim + 5 + h) + 1, h), nan)
    # the products' weights: the transposed copies in float32, the bf16 shadow
    wt = None if bf else torch.full((3, h, h), nan)
    wb = torch.full((5 * (128 + h), h), nan, dtype=torch.bfloat16) if bf else None
    stash = torch.full((n_tiles, 2, ts, h), nan)
    losses = torch.full((K, 2), nan)
    state = [t.clone().contiguous() for t in (f.w, f.vec, f.mw, f.vw, f.mvec, f.vvec)]
    ri = row_idx.to(torch.int32).contiguous() if row_idx is not None else None
    err = getattr(lib, name)(
        *[t.data_ptr() for t in state], data.data_ptr(), ri.data_ptr() if rpb else None,
        noise.data_ptr(), losses.data_ptr(), partials.data_ptr(),
        None if wt is None else wt.data_ptr(), stash.data_ptr(),
        None if wb is None else wb.data_ptr(), h, K, B, W, lanes, rpb, obs_dim, grid, int(bf), int(alpha_floor > 0),
        HYPER["gamma"], HYPER["tau"], HYPER["lr"], HYPER["target_entropy"], float(f.count),
        math.log(alpha_floor) if alpha_floor > 0 else 0.0, None)
    w, vec, mw, vw, mvec, vvec = state
    return err, fused_sac.FusedState(w, vec, mw, mvec, vw, vvec, f.count + K), losses


def make_case(h, obs_dim, K, B, lanes, seed):
    ns = fused_sac.build(h)
    rng = np.random.default_rng(seed)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32))

    shapes = dict(a_w1=(128, h), a_b1=(h,), a_w2=(h, h), a_b2=(h,), a_wh=(h, 4), a_bh=(4,),
                  c_w1=(2, 128, h), c_b1=(2, h), c_w2=(2, h, h), c_b2=(2, h), c_w3=(2, h),
                  c_b3=(2,), t_w1=(2, 128, h), t_b1=(2, h), t_w2=(2, h, h), t_b2=(2, h),
                  t_w3=(2, h), t_b3=(2,), log_alpha=())
    fields = {}
    for k, sh in shapes.items():
        scale = 0.1 if k.endswith("w1") else 1 / math.sqrt(h) if "w" in k else 0.05
        a = f32(rng.standard_normal(sh) * scale)
        if k.endswith("w1"):
            a[..., obs_dim + (0 if k == "a_w1" else 2):, :] = 0
        fields[k] = a
    packed = fused_sac.PackedParams(**fields)

    def slab(lead):
        return Transition(obs=f32(rng.standard_normal(lead + (obs_dim,))),
                          action=f32(rng.uniform(-1, 1, lead + (2,))),
                          reward=f32(rng.standard_normal(lead)),
                          next_obs=f32(rng.standard_normal(lead + (obs_dim,))),
                          discount=f32(rng.random(lead) > 0.1))

    noises = f32(rng.standard_normal((K, B, 2, 2)))
    hyper = dict(HYPER, obs_dim=obs_dim)
    # one plain update first, so that the moments are not zero
    packed, adam, _, _ = ns.update_k_reference(packed, ns.adam_init(packed), slab((1, B)),
                                               noises[:1], **hyper)
    if lanes:
        rows = 6
        data = pack_slab(slab((rows, lanes)), obs_dim, 2)
        idx = rng.integers(0, rows, K * B // lanes)
        idx[-1] = idx[0]
        row_idx = torch.as_tensor(idx)
        w = replay_cols(obs_dim, 2)[-1]
        batches = unpack_flat(data[row_idx].transpose(1, 2).reshape(K, B, w), obs_dim, 2)
    else:
        batches = slab((K, B))
        data, row_idx = pack_slab(batches, obs_dim, 2), None
    return ns, packed, adam, data, row_idx, batches, noises, hyper


# h, obs_dim, K, B, ring lanes (0: gathered minibatches), mm_bf16, blocks resident, alpha_floor
CASES = [
    (256, 13, 2, 128, 64, False, 4, 0.0),    # the flagship width, two replay rows a minibatch
    (256, 17, 2, 128, 0, False, 1, 0.3),     # two tiles on one block; the floor clamps
    (256, 13, 1, 128, 64, True, 4, 0.0),     # bf16-rounded products
    (512, 7, 1, 64, 32, False, 4, 0.0),
    (128, 13, 1, 256, 128, False, 4, 0.0),
    (384, 9, 1, 64, 0, True, 2, 0.0),
    # the tensor-core path at the other widths, and with more tiles than blocks
    (128, 13, 1, 256, 128, True, 4, 0.0),
    (512, 7, 1, 32, 32, True, 2, 0.0),
    (256, 17, 2, 128, 0, True, 1, 0.3),
]


@pytest.mark.parametrize("h,obs_dim,K,B,lanes,bf,sms,alpha_floor", CASES)
def test_host_built_kernels_match_the_plain_version(host_lib, h, obs_dim, K, B, lanes, bf, sms,
                                                    alpha_floor):
    ns, packed, adam, data, row_idx, batches, noises, hyper = make_case(
        h, obs_dim, K, B, lanes, seed=h + obs_dim)
    want_p, want_ad, want_cl, want_al = ns.update_k_reference(
        packed, adam, batches, noises, mm_bf16=bf, alpha_floor=alpha_floor, **hyper)
    f0 = ns.fused_init(packed, adam)
    n_tiles = B // fused_sac.KERNEL_TILE[h]
    results = []
    for fold in (False, True):
        err, f1, losses = host_launch(host_lib, h, f0, data, row_idx, noises, obs_dim, fold, bf,
                                      sms, alpha_floor)
        if fold and n_tiles > sms:
            assert err == -3, "K5 keeps one tile per block and says so when they do not fit"
            continue
        assert err == 0
        results.append((f1, losses))
        got_p, got_ad = ns.fused_unpack(f1)
        assert got_ad.count == want_ad.count
        # float32: the tolerances of tests/test_torch_fused_sac.py.  bf16: the
        # kernel rounds dq and the rank-one products where the plain version
        # does not, so any element may be off by 2.5 lr per update.
        ptol = dict(rtol=0, atol=2.5 * HYPER["lr"] * K) if bf else dict(rtol=2e-4, atol=2e-5)
        mtol = dict(rtol=0.05, atol=1e-3) if bf else dict(rtol=2e-3, atol=2e-5)
        np.testing.assert_allclose(losses[:, 0].numpy(), want_cl.numpy(),
                                   rtol=1e-3 if bf else 1e-4, atol=1e-5)
        np.testing.assert_allclose(losses[:, 1].numpy(), want_al.numpy(), rtol=1e-3, atol=1e-4
                                   if bf else 1e-5)
        for fld in fused_sac.PackedParams._fields:
            np.testing.assert_allclose(getattr(got_p, fld).numpy(), getattr(want_p, fld).numpy(),
                                       err_msg=f"param {fld}", **ptol)
            np.testing.assert_allclose(getattr(got_ad.m, fld).numpy(),
                                       getattr(want_ad.m, fld).numpy(),
                                       err_msg=f"adam m {fld}", **mtol)
            if bf:
                d = (getattr(got_p, fld) - getattr(want_p, fld)).abs()
                assert (d <= 1e-4).float().mean().item() > 0.99, fld
        for fld in ("a_w1", "c_w1", "t_w1"):  # the padded first-layer rows stay zero
            pad = getattr(got_p, fld)[..., obs_dim + (0 if fld == "a_w1" else 2):, :]
            assert (pad == 0).all(), fld
        if alpha_floor:
            assert float(got_p.log_alpha) >= math.log(alpha_floor) - 1e-6
    if len(results) == 2:
        (a, la), (b, lb) = results
        assert all(torch.equal(x, y) for x, y in zip(a[:6], b[:6])) and torch.equal(la, lb), \
            "K5 equals K4 bit for bit"
    if K > 1:  # K updates in one launch equal K launches of one update, the count carried on
        f1, rpb = f0, (B // lanes if lanes else 0)
        for k in range(K):
            d = data if lanes else data[k:k + 1]
            ri = row_idx[k * rpb:(k + 1) * rpb] if lanes else None
            err, f1, lk = host_launch(host_lib, h, f1, d, ri, noises[k:k + 1], obs_dim, False, bf,
                                      sms, alpha_floor)
            assert err == 0 and torch.equal(lk[0], results[0][1][k])
        assert all(torch.equal(x, y) for x, y in zip(f1[:6], results[0][0][:6]))


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
    # every width fits the card's 227 KB with K5's two tile buffers
    for h in (128, 256, 384, 512):
        for bf in (0, 1):
            assert host_lib.sg_sac_update_fold_plan(h, 40, 4, bf, plan) == 0, (h, bf)
            assert plan[1] <= 232448


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
