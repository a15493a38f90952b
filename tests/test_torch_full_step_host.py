"""K3, K3-tf and K3-hw (csrc/full_step.cuh) built for the host: the kernel's
LOGIC on the CPU, held to its plain twin (ops/full_step_plain.py).

csrc/host/full_step_host.cpp compiles the kernel body with g++
(-ffp-contract=off, as the card's build has -fmad=false) against the stand-in
headers of csrc/host/: one fiber per CUDA thread, the persistent grid's
blocks, their barriers, ballots, shuffles and atomics as real ones.  It says
nothing about the card, but it runs the same source, so a wrong tile index, a
missing barrier or a compacted lane written back to the wrong slot fails here;
a race between warps that the fibers' two orders do not hit can pass.

Every case runs one row source (uniforms from memory, threefry, Philox) on
one env family and tableau, at two batches, each with more tiles than the
emulated grid has blocks and a ragged last tile: B = 676 (a last tile of 36
lanes) on two blocks of three tiles, and B = 677 (not a multiple of 4, so no
row is 16-byte aligned) on one block of six tiles.  Lanes truncate, crash, reach their
goal (Goal) or leave the world, so resets and resamples run in every tile.  Tolerances as in
tests/test_torch_full_step.py's float32 counterparts on the card
(tests/test_torch_cuda.py): flags and integer rows equal, floats within atol
1e-5 (state, obs) and 1e-3 (reward); every output written.
"""
import ctypes
import functools
import os
import shutil
import subprocess

import pytest
import torch

from space_gym_torch import get_config
from space_gym_torch.ops.full_step import FullStep
from space_gym_torch.ops.kernel_params import TABLEAU_IDS, TASK_IDS
from space_gym_torch.ops.rng_plain import key_words
from space_gym_torch.utils.cuda_build import CSRC

from .torch_scenarios import (firing_operands, one_torch_thread,  # noqa: F401 (autouse)
                              pattern_operands)

TOL_STATE = 1e-5
TOL_REWARD = 1e-3
ENTRY = {False: "sg_full_step", "threefry": "sg_full_step_threefry",
         "philox": "sg_full_step_philox"}
# (B, emulated SMs): three tiles a block on two blocks; six tiles on one block
BATCHES = ((676, 2), (677, 1))


@functools.cache
def _build(out_dir: str):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel for the host")
    out = os.path.join(out_dir, "libfull_step_host.so")
    host = os.path.join(CSRC, "host")
    subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-shared", "-fPIC", "-pthread",
                    "-I", host, "-o", out, os.path.join(host, "full_step_host.cpp")],
                   check=True, capture_output=True, text=True, timeout=600)
    lib = ctypes.CDLL(out)
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in ENTRY.values():
        getattr(lib, fn).argtypes = [p] + [i] * 5 + [p] * 7 + [i] + [p] * 11 + [i, p]
        getattr(lib, fn).restype = i
        getattr(lib, fn + "_info").argtypes = [i] * 6 + [p]
        getattr(lib, fn + "_info").restype = i
        getattr(lib, fn + "_at").argtypes = [p] + [i] * 5 + [p] * 7 + [i] + [p] * 11 + [i, i, p]
        getattr(lib, fn + "_at").restype = i
    lib.host_set_sms.argtypes = [i]
    return lib


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return _build(str(tmp_path_factory.getbasetemp()))


def host_step(lib, full, rows, sms, lane0=0):
    """What FullStep._launch does on the card, through the host build: the
    outputs poisoned first (NaN, -777 for the integer rows, 0xAB for the
    flags' bytes)."""
    B = rows[0].shape[1]
    rows = [t.contiguous() for t in rows]
    outs = [torch.full((r, B), float("nan")) for r in full.out_rows()[:8]]
    outs += [torch.full((full.n_int_rows, B), -777, dtype=torch.int32),
             torch.full((3, B), 0xAB, dtype=torch.uint8)]
    lib.host_set_sms(sms)
    entry = ENTRY[full.rng] + ("_at" if lane0 else "")
    err = getattr(lib, entry)(
        ctypes.addressof(full.params), TASK_IDS[full.cfg.task], full.cfg.n_planets, full.n_tiles,
        full.cols, TABLEAU_IDS[full.tableau], *[t.data_ptr() for t in rows[:7]],
        full.n_uniform_rows, rows[7].data_ptr(), *[t.data_ptr() for t in outs], B,
        *((lane0,) if lane0 else ()), None)
    assert err == 0
    assert (outs[-1] <= 1).all(), "every flag written, as 0 or 1"
    return outs[:-1] + [outs[-1].view(torch.bool)]


@pytest.mark.parametrize("tableau,substeps,refine", [("bs3", 1, 8), ("dp5", 2, 12)])
@pytest.mark.parametrize("env_id", ["GoalContinuous2P-v0", "GoalContinuous3P-v0",
                                    "GoalContinuous4P-v0", "KeplerRandomOrbits-v0",
                                    "DoNotCrashContinuous-v0"])
@pytest.mark.parametrize("rng", [False, "threefry", "philox"], ids=["mem", "threefry", "philox"])
def test_host_built_full_step_matches_plain_twin(host_lib, rng, env_id, tableau, substeps,
                                                 refine):
    cfg = get_config(env_id)
    full = FullStep(cfg, substeps, refine, tableau, in_kernel_rng=rng)
    for B, sms in BATCHES:
        rows = pattern_operands(cfg, B, seed=B, raw_action=True)
        if rng:
            rows[6] = key_words([0x5EED0000 + B, 0x0000C0DE])
        want = full.step_rows(*rows)
        got = host_step(host_lib, full, rows, sms)
        flags, ints = want[-1], want[-2]
        assert torch.equal(got[-1], flags), f"B={B}: flags"
        assert torch.equal(got[-2], ints), f"B={B}: integer rows"
        for i, (g, w) in enumerate(zip(got[:-2], want[:-2])):
            tol = TOL_REWARD if i == 7 else TOL_STATE
            assert torch.allclose(g, w, rtol=0, atol=tol, equal_nan=True), (B, i)
        done = flags[2].bool()
        assert done.sum() > 20 and (~done).sum() > B // 2, f"B={B}: too few lanes done or live"
        if cfg.task == "goal":
            reached = (got[2] != rows[3]).any(0) & ~done
            assert reached.sum() > 20, f"B={B}: too few lanes resampled"


def test_host_build_launch_geometry(host_lib):
    """The persistent grid: min(tiles, resident blocks) blocks, an equal
    share of the tiles each; the shared memory of the list of deferred lanes
    (its count, then 6 * NPW + 10 words a slot, 128 slots: csrc/env_lanes.cuh),
    the two rare-lane lists' counts, the two lists and one stage of the input
    rows."""
    cfg = get_config("GoalContinuous2P-v0")
    full = FullStep(cfg, 1, 8, "bs3")
    rows = sum(full.in_rows()) - full.in_rows()[6]
    out = (ctypes.c_int * 8)()
    for tab, npw in (("bs3", 3), ("dp5", 4)):
        for B, sms, grid in ((676, 2, 2), (677, 1, 1), (100, 4, 1), (128 * 9, 4, 3)):
            host_lib.host_set_sms(sms)
            assert host_lib.sg_full_step_info(TASK_IDS["goal"], 2, 4, 2, TABLEAU_IDS[tab], B,
                                              out) == 0
            info = dict(zip(FullStep.INFO_KEYS, out))
            assert info["tiles"] == -(-B // 128) and info["grid"] == grid, (B, info)
            assert info["threads"] == 128 and info["sms"] == sms
        assert info["smem_bytes"] == (16 + (6 * npw + 10) * 128 * 4
                                      + 2 * 4 + 2 * 384 * 4 + rows * 128 * 4), tab


@pytest.mark.parametrize("env_id", ["GoalContinuous2P-v0", "KeplerRandomOrbits-v0"])
def test_host_built_full_step_when_the_lists_fill(host_lib, env_id):
    """Every lane of nine tiles on one block done (truncated): the block's
    list of done lanes (three tiles' worth) fills, and the lanes past its
    end reset where they are, the rest at the block's end."""
    cfg = get_config(env_id)
    full = FullStep(cfg, 1, 8, "bs3")
    B = 128 * 9
    rows = pattern_operands(cfg, B, seed=3, raw_action=True)
    rows[7][-3] = cfg.max_episode_steps - 1  # the step count row
    want = full.step_rows(*rows)
    got = host_step(host_lib, full, rows, 1)
    assert want[-1][2].all()
    assert torch.equal(got[-1], want[-1]) and torch.equal(got[-2], want[-2])
    for i, (g, w) in enumerate(zip(got[:-2], want[:-2])):
        tol = TOL_REWARD if i == 7 else TOL_STATE
        assert torch.allclose(g, w, rtol=0, atol=tol, equal_nan=True), i


@pytest.mark.parametrize("tableau,substeps,refine", [("bs3", 1, 8), ("dp5", 2, 12)])
@pytest.mark.parametrize("env_id,rng", [("GoalContinuous2P-v0", False),
                                        ("KeplerRandomOrbits-v0", "philox")],
                         ids=["goal2p-mem", "kepler-philox"])
def test_host_built_full_step_defers_firing_lanes(host_lib, env_id, rng, tableau, substeps,
                                                  refine):
    """Three lanes in four head into planet 0 (`firing_operands`): a block's
    firing lanes (about 288 on each of two blocks of three tiles at B = 676,
    about 508 on one block of six at B = 677) are more than its list of
    deferred lanes holds (128), so the list fills, the lanes past it refine
    in place and the list's lanes are finished, and reset, by the block's
    threads at its end.  Every row and flag as the plain twin's."""
    cfg = get_config(env_id)
    full = FullStep(cfg, substeps, refine, tableau, in_kernel_rng=rng)
    for B, sms in BATCHES:
        rows = firing_operands(cfg, B, seed=B, raw_action=True)
        if rng:
            rows[6] = key_words([0x5EED0001 + B, 0x0000C0DE])
        want = full.step_rows(*rows)
        got = host_step(host_lib, full, rows, sms)
        assert torch.equal(got[-1], want[-1]), f"B={B}: flags"
        assert torch.equal(got[-2], want[-2]), f"B={B}: integer rows"
        for i, (g, w) in enumerate(zip(got[:-2], want[:-2])):
            tol = TOL_REWARD if i == 7 else TOL_STATE
            assert torch.allclose(g, w, rtol=0, atol=tol, equal_nan=True), (B, i)
        block = (torch.arange(B) // 128) % sms  # the block that walks each lane's tile
        fired = [int(want[-1][0][block == b].sum()) for b in range(sms)]
        assert min(fired) > 128, f"B={B}: lanes whose events fire in each block {fired}"


@pytest.mark.parametrize("rng", ["threefry", "philox"])
def test_host_built_full_step_at_a_lane_offset(host_lib, rng):
    """K3-tf and K3-hw at lane0 (the `_at` entry points: a rank's block of
    lanes split over ranks) hold to the plain twin at the same offset, and
    the twin to the same lanes of an offset-0 step of the whole width."""
    cfg = get_config("GoalContinuous2P-v0")
    full = FullStep(cfg, 1, 8, "bs3", in_kernel_rng=rng)
    B, lane0 = 676, 677
    rows = pattern_operands(cfg, lane0 + B, seed=5, raw_action=True)
    rows[6] = key_words([0x5EED0002, 0x0000C0DE])
    wide = full.step_rows(*rows)
    block = FullStep.lane_block(rows, lane0)
    want = full.step_rows(*block, lane0=lane0)
    for w, g in zip(wide, want):
        assert torch.equal(w[:, lane0:], g)
    got = host_step(host_lib, full, block, 2, lane0=lane0)
    assert torch.equal(got[-1], want[-1]) and torch.equal(got[-2], want[-2])
    for i, (g, w) in enumerate(zip(got[:-2], want[:-2])):
        tol = TOL_REWARD if i == 7 else TOL_STATE
        assert torch.allclose(g, w, rtol=0, atol=tol, equal_nan=True), i
    assert want[-1][2].sum() > 20  # resets drew from the offset stream
