"""The TD3 learner kernel's LOGIC on the CPU: csrc/td3_update.cuh compiled by
g++ against the stand-in CUDA headers of csrc/host/ (one OS thread per CUDA
thread, real barriers), held to the plain version `update_k_reference`.

The CUDA kernel K6 runs only on a card (tests/test_torch_cuda.py).  This build
says nothing about the card, but it runs the same source, so it catches a
wrong index, a missing barrier or wrong arithmetic here: every tile, both data
modes, bf16 rounding, more tiles than blocks, three widths, delayed and
non-delayed updates, an odd starting count with policy_delay 2 and 3.
Tolerances as in tests/test_torch_fused_td3.py; a second call and K launches
of one update give the bits of one launch of K.
"""
import ctypes
import math
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from space_gym_torch.models import fused_td3
from space_gym_torch.models.replay import Transition, pack_slab, replay_cols, unpack_flat
from space_gym_torch.utils.cuda_build import CSRC
from .torch_scenarios import one_torch_thread  # noqa: F401 (autouse)

HYPER = dict(gamma=0.99, tau=0.005, lr=3e-4, smooth_std=0.2, smooth_clip=0.5)
STATE = ("w", "vec", "mw", "mvec", "vw", "vvec")


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel for the host")
    out = tmp_path_factory.mktemp("td3_host") / "libtd3_update_host.so"
    host = os.path.join(CSRC, "host")
    subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-I", host,
                    "-o", str(out), os.path.join(host, "td3_update_host.cpp")],
                   check=True, capture_output=True, text=True, timeout=600)
    lib = ctypes.CDLL(str(out))
    p, i, fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.sg_td3_update.argtypes = [p] * 14 + [i] * 12 + [fl] * 5 + [p]
    lib.sg_td3_update.restype = i
    lib.sg_td3_update_plan.argtypes = [i, i, i, ctypes.POINTER(ctypes.c_int)]
    lib.sg_td3_update_plan.restype = i
    return lib


def host_launch(lib, h, f, data, row_idx, noises, obs_dim, bf, sms, delay):
    """What fused_td3._launch does on the card, on CPU tensors: scratch
    poisoned with NaN, state copied, the host library called."""
    lib.host_set_sms(sms)
    K, B = noises.shape[:2]
    W = data.shape[1]
    ts = fused_td3.KERNEL_TILE[h]
    lanes, rpb = (B, 0) if row_idx is None else (data.shape[2], B // data.shape[2])
    n_tiles = B // ts
    plan = (ctypes.c_int * 2)()
    err = lib.sg_td3_update_plan(h, W, n_tiles, plan)
    if err:
        return err, None, None
    grid = plan[0]
    nan = float("nan")
    noise = noises.transpose(1, 2).contiguous()
    partials = torch.full((grid, 2 * (obs_dim + 5 + h) + 1, h), nan)
    wt = torch.full((3, h, h), nan)
    stash = torch.full((n_tiles, 2, ts, h), nan)
    alp = torch.full((K, grid), nan)
    losses = torch.full((K, 2), nan)
    state = [t.clone().contiguous() for t in (f.w, f.vec, f.mw, f.vw, f.mvec, f.vvec)]
    ri = row_idx.to(torch.int32).contiguous() if row_idx is not None else None
    err = lib.sg_td3_update(
        *[t.data_ptr() for t in state], data.data_ptr(), ri.data_ptr() if rpb else None,
        noise.data_ptr(), losses.data_ptr(), partials.data_ptr(), wt.data_ptr(),
        stash.data_ptr(), alp.data_ptr(), h, K, B, W, lanes, rpb, obs_dim, grid, int(bf),
        f.count, f.count_a, delay, HYPER["gamma"], HYPER["tau"], HYPER["lr"],
        HYPER["smooth_std"], HYPER["smooth_clip"], None)
    w, vec, mw, vw, mvec, vvec = state
    return err, fused_td3.FusedState(
        w, vec, mw, mvec, vw, vvec, f.count + K,
        f.count_a + fused_td3.applied_steps(f.count, K, delay)), losses


def make_case(h, obs_dim, K, B, lanes, delay, warm, seed):
    """A learner that has taken `warm` plain updates (so the moments are not
    zero and the count is `warm`), data in either mode, and the normals."""
    ns = fused_td3.build(h)
    rng = np.random.default_rng(seed)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32))

    actor = dict(w1=(128, h), b1=(h,), w2=(h, h), b2=(h,), wh=(h, 2), bh=(2,))
    critic = dict(w1=(2, 128, h), b1=(2, h), w2=(2, h, h), b2=(2, h), w3=(2, h), b3=(2,))
    fields = {}
    for pre, shapes in (("a_", actor), ("ta_", actor), ("c_", critic), ("t_", critic)):
        for k, sh in shapes.items():
            scale = 0.1 if k == "w1" else 1 / math.sqrt(h) if "w" in k else 0.05
            a = f32(rng.standard_normal(sh) * scale)
            if k == "w1":
                a[..., obs_dim + (0 if pre in ("a_", "ta_") else 2):, :] = 0
            fields[pre + k] = a
    packed = fused_td3.PackedParams(**fields)

    def slab(lead):
        return Transition(obs=f32(rng.standard_normal(lead + (obs_dim,))),
                          action=f32(rng.uniform(-1, 1, lead + (2,))),
                          reward=f32(rng.standard_normal(lead)),
                          next_obs=f32(rng.standard_normal(lead + (obs_dim,))),
                          discount=f32(rng.random(lead) > 0.1))

    noises = f32(rng.standard_normal((K, B, 2)))
    hyper = dict(HYPER, obs_dim=obs_dim, policy_delay=delay)
    packed, adam, _, _ = ns.update_k_reference(
        packed, ns.adam_init(packed), slab((warm, B)), f32(rng.standard_normal((warm, B, 2))),
        **hyper)
    assert adam.count == warm
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
    ns, packed, adam, data, row_idx, batches, noises, hyper = make_case(
        h, obs_dim, K, B, lanes, delay, warm, seed=h + obs_dim)
    want_p, want_ad, want_cl, want_al = ns.update_k_reference(
        packed, adam, batches, noises, mm_bf16=bf, **hyper)
    f0 = ns.fused_init(packed, adam)
    runs = []
    for _ in range(2):
        err, f1, losses = host_launch(host_lib, h, f0, data, row_idx, noises, obs_dim, bf, sms,
                                      delay)
        assert err == 0
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
    ptol = dict(rtol=0, atol=2.5 * HYPER["lr"] * K) if bf else dict(rtol=2e-4, atol=2e-5)
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
        err, f2, lk = host_launch(host_lib, h, f2, d, ri, noises[k:k + 1], obs_dim, bf, sms, delay)
        assert err == 0 and torch.equal(lk[0], losses[k])
    assert all(torch.equal(x, y) for x, y in zip(f2[:6], f1[:6]))
    assert (f2.count, f2.count_a) == (f1.count, f1.count_a)


def test_host_build_rejects_a_width_that_is_not_built(host_lib):
    plan = (ctypes.c_int * 2)()
    host_lib.host_set_sms(4)
    assert host_lib.sg_td3_update_plan(640, 40, 4, plan) == -1
    assert host_lib.sg_td3_update_plan(256, 40, 6, plan) == 0 and plan[0] == 4
    assert plan[1] == 4 * (2 * 64 * 256 + 16 * 256 + 40 * 64 + 2 * 64 + 40 * 64 + 12 * 64
                           + 2 * 64 * 8 + 32)
    assert host_lib.sg_td3_update_plan(256, 40, 2, plan) == 0 and plan[0] == 2
    # a ring so wide that the kernel's shared memory cannot hold a tile of it
    assert host_lib.sg_td3_update_plan(512, 2000, 4, plan) == -2
