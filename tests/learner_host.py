"""The learner kernels' LOGIC on the CPU, shared by the host-build tests
(tests/test_torch_sac_kernel_host*.py, tests/test_torch_td3_kernel_host*.py):
csrc/sac_update.cuh (K4, K5) and csrc/td3_update.cuh (K6) compiled by g++
against the stand-in CUDA headers of csrc/host/ (one fiber per CUDA
thread, real barriers), launched by the card's own launch code
(models/learner_kernels.py, `launch`: its plan, scratch and C arguments),
and held to the plain version `update_k_reference`.

The CUDA kernels run only on a card (tests/test_torch_cuda.py).  This build
says nothing about the card, but it runs the same source, so it catches a
wrong index, a missing barrier or wrong arithmetic here.  Both product paths
run: float32 on the CUDA cores (mm_bf16=False) and the tensor cores
(mm_bf16=True), whose ldmatrix and mma.sync instructions the host build
emulates lane by lane with the fragment layouts of the PTX ISA
(csrc/host/mma_emul.h).  Tolerances as in tests/test_torch_fused_sac.py and
tests/test_torch_fused_td3.py; K5 equals K4 bit for bit, a second call gives
the same bits, and K launches of one update give the bits of one launch of K.

A library is compiled once per test process and width-independent; a case
costs seconds to tens of seconds, so cases stay at K <= 3 and a few tiles.
"""
import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from space_gym_torch.models import fused_sac, fused_td3, learner_kernels
from space_gym_torch.models.replay import Transition, pack_slab, replay_cols, unpack_flat
from space_gym_torch.utils.cuda_build import CSRC

SAC_HYPER = dict(gamma=0.99, tau=0.005, lr=3e-4, target_entropy=-2.0)
TD3_HYPER = dict(gamma=0.99, tau=0.005, lr=3e-4, smooth_std=0.2, smooth_clip=0.5)


@functools.cache
def _build(name: str, out_dir: str):
    """csrc/host/<name>_host.cpp compiled into out_dir and loaded, its own
    entry points typed (learner_kernels types the kernels' on first use)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernels for the host")
    out = os.path.join(out_dir, f"lib{name}_host.so")
    host = os.path.join(CSRC, "host")
    subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-I", host,
                    "-o", out, os.path.join(host, f"{name}_host.cpp")],
                   check=True, capture_output=True, text=True, timeout=600)
    lib = ctypes.CDLL(out)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.host_set_lag.argtypes = [i]
    kernels = ((learner_kernels.SAC, learner_kernels.SAC_FOLD) if name == "sac_update"
               else (learner_kernels.TD3,))
    for kernel in kernels:  # the tests also call the plans directly
        learner_kernels.entry_points(lib, kernel)
    if name == "sac_update":
        lib.host_mma_tile.argtypes = [p, p, p, i, i]
        lib.host_mma_tile.restype = i
    return lib


def host_library(name: str, tmp_path_factory):
    """The host build of csrc/<name>.cuh ("sac_update" or "td3_update")."""
    return _build(name, str(tmp_path_factory.getbasetemp()))


def _f32(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def _slab(rng, obs_dim, lead):
    """Transitions with leading shape `lead`, drawn from rng."""
    return Transition(obs=_f32(rng.standard_normal(lead + (obs_dim,))),
                      action=_f32(rng.uniform(-1, 1, lead + (2,))),
                      reward=_f32(rng.standard_normal(lead)),
                      next_obs=_f32(rng.standard_normal(lead + (obs_dim,))),
                      discount=_f32(rng.random(lead) > 0.1))


def _data(rng, obs_dim, K, B, lanes):
    """Gathered (K, B) minibatches (lanes 0), or a ring of 6 rows of `lanes`
    with K * B // lanes row indices (a repeated one) and the same minibatches
    gathered: (data, row_idx, batches)."""
    if lanes:
        rows = 6
        data = pack_slab(_slab(rng, obs_dim, (rows, lanes)), obs_dim, 2)
        idx = rng.integers(0, rows, K * B // lanes)
        idx[-1] = idx[0]
        row_idx = torch.as_tensor(idx)
        w = replay_cols(obs_dim, 2)[-1]
        batches = unpack_flat(data[row_idx].transpose(1, 2).reshape(K, B, w), obs_dim, 2)
        return data, row_idx, batches
    batches = _slab(rng, obs_dim, (K, B))
    return pack_slab(batches, obs_dim, 2), None, batches


def digest(f, losses) -> str:
    """SHA-256 (16 hex digits) of what a launch wrote: the state and the losses."""
    h = hashlib.sha256()
    for t in (*f[:6], losses):
        h.update(t.numpy().tobytes())
    return h.hexdigest()[:16]


# ------------------------------------------------------------ a launch --
def _nan(shape, dtype, device):
    """Scratch poisoned with NaN: a launch must write what it reads."""
    return torch.full(shape, float("nan"), dtype=dtype, device=device)


def host_launch(lib, kernel, f, data, row_idx, noises, scalars, obs_dim, bf, sms, cmax, planned):
    """What the entry points launch on the card (learner_kernels.launch), on
    CPU tensors: the host library with `sms` blocks resident, the scratch
    poisoned with NaN, the state copied; clusters of at most cmax blocks.
    `planned` (a list) receives the plan's (grid, C).  Returns (the copied
    state, updated, and the losses)."""
    lib.host_set_sms(sms)
    f = f._replace(**{n: getattr(f, n).clone() for n in ("w", "vec", "mw", "vw", "mvec", "vvec")})
    losses, grid, cluster = learner_kernels.launch(
        kernel, f, data, row_idx, noises, scalars, obs_dim=obs_dim, mm_bf16=bf, cluster_max=cmax,
        lib=lib, empty=_nan)
    if planned is not None:
        planned.append((grid, cluster))
    return f, losses


# ------------------------------------------------------------ K4 and K5 --
def sac_launch(lib, f, data, row_idx, noises, obs_dim, fold, bf, sms, alpha_floor=0.0,
               cmax=learner_kernels.CLUSTER_MAX, planned=None):
    """K4 (K5 with `fold`) through host_launch; returns (state', losses)."""
    kernel = learner_kernels.SAC_FOLD if fold else learner_kernels.SAC
    scalars = fused_sac.kernel_scalars(f.count, alpha_floor=alpha_floor, **SAC_HYPER)
    f1, losses = host_launch(lib, kernel, f, data, row_idx, noises, scalars, obs_dim, bf, sms,
                             cmax, planned)
    return f1._replace(count=f.count + noises.shape[0]), losses


def sac_case(h, obs_dim, K, B, lanes, seed):
    ns = fused_sac.build(h)
    rng = np.random.default_rng(seed)
    shapes = dict(a_w1=(128, h), a_b1=(h,), a_w2=(h, h), a_b2=(h,), a_wh=(h, 4), a_bh=(4,),
                  c_w1=(2, 128, h), c_b1=(2, h), c_w2=(2, h, h), c_b2=(2, h), c_w3=(2, h),
                  c_b3=(2,), t_w1=(2, 128, h), t_b1=(2, h), t_w2=(2, h, h), t_b2=(2, h),
                  t_w3=(2, h), t_b3=(2,), log_alpha=())
    fields = {}
    for k, sh in shapes.items():
        scale = 0.1 if k.endswith("w1") else 1 / math.sqrt(h) if "w" in k else 0.05
        a = _f32(rng.standard_normal(sh) * scale)
        if k.endswith("w1"):
            a[..., obs_dim + (0 if k == "a_w1" else 2):, :] = 0
        fields[k] = a
    packed = fused_sac.PackedParams(**fields)
    noises = _f32(rng.standard_normal((K, B, 2, 2)))
    hyper = dict(SAC_HYPER, obs_dim=obs_dim)
    # one plain update first, so that the moments are not zero
    packed, adam, _, _ = ns.update_k_reference(packed, ns.adam_init(packed),
                                               _slab(rng, obs_dim, (1, B)), noises[:1], **hyper)
    data, row_idx, batches = _data(rng, obs_dim, K, B, lanes)
    return ns, packed, adam, data, row_idx, batches, noises, hyper


def check_sac(lib, h, obs_dim, K, B, lanes, bf, sms, alpha_floor,
              cmax=learner_kernels.CLUSTER_MAX, planned=None):
    """K4 and K5 on one case against the plain version, K5 against K4 bit for
    bit, and (K > 1) K launches of one update against one launch of K; in
    clusters of at most cmax blocks.  Returns K4's digest; `planned` receives
    the plans' (grid, C)."""
    ns, packed, adam, data, row_idx, batches, noises, hyper = sac_case(
        h, obs_dim, K, B, lanes, seed=h + obs_dim)
    want_p, want_ad, want_cl, want_al = ns.update_k_reference(
        packed, adam, batches, noises, mm_bf16=bf, alpha_floor=alpha_floor, **hyper)
    f0 = ns.fused_init(packed, adam)
    results = []
    for fold in (False, True):
        f1, losses = sac_launch(lib, f0, data, row_idx, noises, obs_dim, fold, bf, sms,
                                alpha_floor, cmax, planned)
        results.append((f1, losses))
        got_p, got_ad = ns.fused_unpack(f1)
        assert got_ad.count == want_ad.count
        # float32: the tolerances of tests/test_torch_fused_sac.py.  bf16: the
        # kernel rounds dq and the rank-one products where the plain version
        # does not, so any element may be off by 2.5 lr per update.
        ptol = (dict(rtol=0, atol=2.5 * SAC_HYPER["lr"] * K) if bf
                else dict(rtol=2e-4, atol=2e-5))
        mtol = dict(rtol=0.05, atol=1e-3) if bf else dict(rtol=2e-3, atol=2e-5)
        np.testing.assert_allclose(losses[:, 0].numpy(), want_cl.numpy(),
                                   rtol=1e-3 if bf else 1e-4, atol=1e-5)
        np.testing.assert_allclose(losses[:, 1].numpy(), want_al.numpy(), rtol=1e-3,
                                   atol=1e-4 if bf else 1e-5)
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
    (a, la), (b, lb) = results
    assert all(torch.equal(x, y) for x, y in zip(a[:6], b[:6])) and torch.equal(la, lb), \
        "K5 equals K4 bit for bit"
    if K > 1:  # K updates in one launch equal K launches of one update, the count carried on
        f1, rpb = f0, (B // lanes if lanes else 0)
        for k in range(K):
            d = data if lanes else data[k:k + 1]
            ri = row_idx[k * rpb:(k + 1) * rpb] if lanes else None
            f1, lk = sac_launch(lib, f1, d, ri, noises[k:k + 1], obs_dim, False, bf, sms,
                                alpha_floor, cmax)
            assert torch.equal(lk[0], results[0][1][k])
        assert all(torch.equal(x, y) for x, y in zip(f1[:6], results[0][0][:6]))
    return digest(*results[0])


def sac_clusters(lib, h, obs_dim, K, B, lanes, bf, sms, cmax, want_c, want_digest):
    """check_sac in clusters of at most cmax blocks: the plan takes want_c,
    and where given the digest of K4's outputs is want_digest (with C = 1
    that of the launch without clusters, recorded from it before clusters
    existed; the inputs pass through PyTorch on one thread, as the tests'
    `one_torch_thread` runs it, whose sums the digest depends on)."""
    planned = []
    got = check_sac(lib, h, obs_dim, K, B, lanes, bf, sms, 0.0, cmax, planned)
    assert {c for _, c in planned} == {want_c}
    if want_digest:
        assert got == want_digest


def lagging_bits(lib, launch, want_c):
    """The digest of launch() (state, losses), run as it comes and with
    the last block of every cluster lagging behind the others
    (csrc/host/cuda_runtime.h, EMUL_LAG): the two must agree, since a block
    that rewrote its exchange rows while another still read them would give
    the lagging block other sums.  `launch` takes `planned`, which must see
    clusters of want_c > 1 blocks."""
    assert want_c > 1
    planned, got = [], []
    for lag in (0, 1):
        lib.host_set_lag(lag)
        try:
            f1, losses = launch(planned)
        finally:
            lib.host_set_lag(0)
        got.append(digest(f1, losses))
    assert {c for _, c in planned} == {want_c}
    assert got[0] == got[1], "a lagging block changes the bits"


def sac_lagging(lib, h, obs_dim, K, B, lanes, bf, sms, cmax, want_c):
    """K4 gives the same bits with the last block of each cluster lagging."""
    ns, packed, adam, data, row_idx, batches, noises, hyper = sac_case(
        h, obs_dim, K, B, lanes, seed=h + obs_dim)
    f0 = ns.fused_init(packed, adam)
    lagging_bits(lib, lambda planned: sac_launch(lib, f0, data, row_idx, noises, obs_dim,
                                                 False, bf, sms, 0.0, cmax, planned), want_c)


# ----------------------------------------------------------------- K6 --
def td3_launch(lib, f, data, row_idx, noises, obs_dim, bf, sms, delay,
               cmax=learner_kernels.CLUSTER_MAX, planned=None):
    """K6 through host_launch; returns (state', losses)."""
    K = noises.shape[0]
    scalars = fused_td3.kernel_scalars(f.count, f.count_a, policy_delay=delay, **TD3_HYPER)
    f1, losses = host_launch(lib, learner_kernels.TD3, f, data, row_idx, noises, scalars, obs_dim,
                             bf, sms, cmax, planned)
    return f1._replace(count=f.count + K,
                       count_a=f.count_a + fused_td3.applied_steps(f.count, K, delay)), losses


def td3_case(h, obs_dim, K, B, lanes, delay, warm, seed):
    """A learner that has taken `warm` plain updates (so the moments are not
    zero and the count is `warm`), data in either mode, and the normals."""
    ns = fused_td3.build(h)
    rng = np.random.default_rng(seed)
    actor = dict(w1=(128, h), b1=(h,), w2=(h, h), b2=(h,), wh=(h, 2), bh=(2,))
    critic = dict(w1=(2, 128, h), b1=(2, h), w2=(2, h, h), b2=(2, h), w3=(2, h), b3=(2,))
    fields = {}
    for pre, shapes in (("a_", actor), ("ta_", actor), ("c_", critic), ("t_", critic)):
        for k, sh in shapes.items():
            scale = 0.1 if k == "w1" else 1 / math.sqrt(h) if "w" in k else 0.05
            a = _f32(rng.standard_normal(sh) * scale)
            if k == "w1":
                a[..., obs_dim + (0 if pre in ("a_", "ta_") else 2):, :] = 0
            fields[pre + k] = a
    packed = fused_td3.PackedParams(**fields)
    noises = _f32(rng.standard_normal((K, B, 2)))
    hyper = dict(TD3_HYPER, obs_dim=obs_dim, policy_delay=delay)
    packed, adam, _, _ = ns.update_k_reference(
        packed, ns.adam_init(packed), _slab(rng, obs_dim, (warm, B)),
        _f32(rng.standard_normal((warm, B, 2))), **hyper)
    assert adam.count == warm
    data, row_idx, batches = _data(rng, obs_dim, K, B, lanes)
    return ns, packed, adam, data, row_idx, batches, noises, hyper


def check_td3(lib, h, obs_dim, K, B, lanes, bf, sms, delay, warm,
              cmax=learner_kernels.CLUSTER_MAX, planned=None):
    """K6 on one case against the plain version, twice for equal bits, the
    counts and the delay, and K launches of one update against one launch of
    K; in clusters of at most cmax blocks.  In bf16 mode that last check also
    finds a stale shadow row: a launch builds the shadow anew, so the weights
    a delayed update moves must reach their shadow rows for one launch of K to
    give the same bits.  Returns the digest; `planned` receives the plans'
    (grid, C)."""
    ns, packed, adam, data, row_idx, batches, noises, hyper = td3_case(
        h, obs_dim, K, B, lanes, delay, warm, seed=h + obs_dim)
    want_p, want_ad, want_cl, want_al = ns.update_k_reference(
        packed, adam, batches, noises, mm_bf16=bf, **hyper)
    f0 = ns.fused_init(packed, adam)
    runs = []
    for _ in range(2):
        f1, losses = td3_launch(lib, f0, data, row_idx, noises, obs_dim, bf, sms, delay, cmax,
                                planned)
        runs.append((f1, losses))
    assert all(torch.equal(a, b) for a, b in zip(runs[0][0][:6], runs[1][0][:6]))
    assert torch.equal(runs[0][1], runs[1][1]), "a second call gives the same bits"
    f1, losses = runs[0]
    got_p, got_ad = ns.fused_unpack(f1)
    assert (got_ad.count, got_ad.count_a) == (want_ad.count, want_ad.count_a)
    assert want_ad.count == warm + K
    # float32: the tolerances of tests/test_torch_fused_td3.py.  bf16: the
    # kernel rounds dq and the rank-one products where the plain version does
    # not, so any element may be off by 2.5 lr per update.
    ptol = dict(rtol=0, atol=2.5 * TD3_HYPER["lr"] * K) if bf else dict(rtol=2e-4, atol=2e-5)
    mtol = dict(rtol=0.05, atol=1e-3) if bf else dict(rtol=2e-3, atol=2e-5)
    np.testing.assert_allclose(losses[:, 0].numpy(), want_cl.numpy(), rtol=1e-3 if bf else 1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(losses[:, 1].numpy(), want_al.numpy(), rtol=1e-3,
                               atol=1e-4 if bf else 1e-5)
    for fld in fused_td3.PackedParams._fields:
        np.testing.assert_allclose(getattr(got_p, fld).numpy(), getattr(want_p, fld).numpy(),
                                   err_msg=f"param {fld}", **ptol)
        np.testing.assert_allclose(getattr(got_ad.m, fld).numpy(),
                                   getattr(want_ad.m, fld).numpy(),
                                   err_msg=f"adam m {fld}", **mtol)
        if bf:
            d = (getattr(got_p, fld) - getattr(want_p, fld)).abs()
            assert (d <= 1e-4).float().mean().item() > 0.99, fld
    for fld in ("a_w1", "ta_w1", "c_w1", "t_w1"):  # the padded first-layer rows stay zero
        pad = getattr(got_p, fld)[..., obs_dim + (0 if "a_" in fld else 2):, :]
        assert (pad == 0).all(), fld
        assert (getattr(got_ad.m, fld)[..., obs_dim + (0 if "a_" in fld else 2):, :] == 0).all()
    # the targets' moment slots are never written
    for fld in fused_td3.TACTOR_FIELDS + fused_td3.TARGET_FIELDS:
        assert (getattr(got_ad.m, fld) == 0).all() and (getattr(got_ad.v, fld) == 0).all(), fld
    # the delay: without a delayed update the actor and both targets stand still
    n_act = fused_td3.applied_steps(warm, K, delay)
    assert want_ad.count_a - adam.count_a == n_act
    moved = not torch.equal(got_p.a_w2, packed.a_w2)
    assert moved == (n_act > 0)
    assert torch.equal(got_p.ta_w2, packed.ta_w2) == (n_act == 0)
    assert torch.equal(got_p.t_w2, packed.t_w2) == (n_act == 0)
    # K updates in one launch equal K launches of one update, both counts carried on
    f2, rpb = f0, (B // lanes if lanes else 0)
    for k in range(K):
        d = data if lanes else data[k:k + 1]
        ri = row_idx[k * rpb:(k + 1) * rpb] if lanes else None
        f2, lk = td3_launch(lib, f2, d, ri, noises[k:k + 1], obs_dim, bf, sms, delay, cmax)
        assert torch.equal(lk[0], losses[k])
    assert all(torch.equal(x, y) for x, y in zip(f2[:6], f1[:6]))
    assert (f2.count, f2.count_a) == (f1.count, f1.count_a)
    return digest(f1, losses)


def td3_clusters(lib, h, obs_dim, K, B, lanes, bf, sms, delay, warm, cmax, want_c, want_digest):
    """check_td3 in clusters of at most cmax blocks: the plan takes want_c,
    and where given the digest of K6's outputs is want_digest (with C = 1
    that of the launch without clusters, recorded as sac_clusters says)."""
    planned = []
    got = check_td3(lib, h, obs_dim, K, B, lanes, bf, sms, delay, warm, cmax, planned)
    assert {c for _, c in planned} == {want_c}
    if want_digest:
        assert got == want_digest


def td3_lagging(lib, h, obs_dim, K, B, lanes, bf, sms, delay, warm, cmax, want_c):
    """K6 gives the same bits with the last block of each cluster lagging."""
    ns, packed, adam, data, row_idx, batches, noises, hyper = td3_case(
        h, obs_dim, K, B, lanes, delay, warm, seed=h + obs_dim)
    f0 = ns.fused_init(packed, adam)
    lagging_bits(lib, lambda planned: td3_launch(lib, f0, data, row_idx, noises, obs_dim, bf,
                                                 sms, delay, cmax, planned), want_c)
