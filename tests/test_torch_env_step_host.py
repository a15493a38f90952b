"""K1 (csrc/fused_step.cuh) and K2 (csrc/env_step.cuh) built for the host:
the kernels' LOGIC on the CPU, held to their plain twins
(PhysicsStep.plain_rows, EnvStep.plain_rows).

csrc/host/env_step_host.cpp compiles both kernel bodies with g++
(-ffp-contract=off, as the card's build has -fmad=false) against the
stand-in headers of csrc/host/: one fiber per CUDA thread, ballots,
shuffles and atomics as real ones.  It says nothing about the card, but it
runs the same source.

Every case runs K1 and K2 on one env family and tableau at B = 676 (a ragged
last tile of 36 lanes) on two emulated blocks of three tiles each, and B =
677 (not a multiple of 4, so no row is 16-byte aligned) on one block of six
tiles.  Lanes crash into a planet, leave the world or reach their goal, so
events fire in every tile, the blocks' lists of deferred lanes fill with the
lanes of several tiles, and on one block of six tiles the Kepler and
DoNotCrash lanes that fire are more than a list holds.  Tolerances as on the card
(tests/test_torch_cuda.py): terminated flags equal, floats within atol 1e-5
(state, obs) and 1e-3 (reward); every output written.
"""
import ctypes
import functools
import os
import shutil
import subprocess

import pytest
import torch

from space_gym_torch import get_config
from space_gym_torch.ops.env_step import EnvStep
from space_gym_torch.ops.full_step import FullStep
from space_gym_torch.ops.kernel_params import TABLEAU_IDS, TASK_IDS
from space_gym_torch.ops.physics_step import PhysicsStep
from space_gym_torch.utils.cuda_build import CSRC

from .torch_scenarios import (firing_operands, one_torch_thread,  # noqa: F401 (autouse)
                              pattern_operands)

TOL_STATE = 1e-5
TOL_REWARD = 1e-3
# (B, emulated SMs): three tiles a block on two blocks; six tiles on one block
BATCHES = ((676, 2), (677, 1))
ENV_IDS = ("GoalContinuous2P-v0", "GoalContinuous3P-v0", "GoalContinuous4P-v0",
           "KeplerRandomOrbits-v0", "DoNotCrashContinuous-v0")


@functools.cache
def _build(out_dir: str):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernels for the host")
    out = os.path.join(out_dir, "libenv_step_host.so")
    host = os.path.join(CSRC, "host")
    subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-shared", "-fPIC", "-pthread",
                    "-I", host, "-o", out, os.path.join(host, "env_step_host.cpp")],
                   check=True, capture_output=True, text=True, timeout=600)
    lib = ctypes.CDLL(out)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.sg_fused_step.argtypes = [p, i, i] + [p] * 5 + [i, p]
    lib.sg_fused_step.restype = i
    lib.sg_env_step.argtypes = [p] + [i] * 3 + [p] * 9 + [i, p]
    lib.sg_env_step.restype = i
    lib.host_set_sms.argtypes = [i]
    lib.sg_fused_step_info.argtypes = [i] * 3 + [p]
    lib.sg_env_step_info.argtypes = [i] * 4 + [p]
    return lib


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return _build(str(tmp_path_factory.getbasetemp()))


def host_k1(lib, k1, rows, sms):
    """What PhysicsStep.step_rows does on the card, through the host build
    on `sms` emulated SMs (one block each): the outputs poisoned first (NaN,
    -777)."""
    lib.host_set_sms(sms)
    y, a, p = (t.contiguous() for t in rows)
    B = y.shape[1]
    yo = torch.full((6, B), float("nan"))
    term = torch.full((1, B), -777, dtype=torch.int32)
    err = lib.sg_fused_step(ctypes.addressof(k1.params), k1.cfg.n_planets,
                            TABLEAU_IDS[k1.tableau], y.data_ptr(), a.data_ptr(), p.data_ptr(),
                            yo.data_ptr(), term.data_ptr(), B, None)
    assert err == 0
    return yo, term


def host_k2(lib, k2, rows, sms):
    """What EnvStep.step_rows does on the card, through the host build."""
    lib.host_set_sms(sms)
    ins = [t.contiguous() for t in rows]
    B = ins[0].shape[1]
    r = k2.out_rows()
    outs = [torch.full((r[0], B), float("nan")), torch.full((r[1], B), -777, dtype=torch.int32),
            torch.full((r[2], B), float("nan")), torch.full((r[3], B), float("nan"))]
    err = lib.sg_env_step(ctypes.addressof(k2.params), TASK_IDS[k2.cfg.task], k2.cfg.n_planets,
                          TABLEAU_IDS[k2.tableau], *[t.data_ptr() for t in ins],
                          *[t.data_ptr() for t in outs], B, None)
    assert err == 0
    return outs


def check_k1(lib, k1, rows, sms):
    got = host_k1(lib, k1, rows, sms)
    want = k1.step_rows(*rows)
    assert torch.equal(got[1], want[1]), "terminated"
    assert torch.allclose(got[0], want[0], rtol=0, atol=TOL_STATE), "state"
    return want[1]


def check_k2(lib, k2, rows, sms):
    got = host_k2(lib, k2, rows, sms)
    want = k2.step_rows(*rows)
    assert torch.equal(got[1], want[1]), "terminated"
    for i, tol in ((0, TOL_STATE), (2, TOL_STATE), (3, TOL_REWARD)):
        assert torch.allclose(got[i], want[i], rtol=0, atol=tol, equal_nan=True), i
    return want[1]


@pytest.mark.parametrize("tableau,substeps,refine", [("bs3", 1, 8), ("dp5", 2, 12)])
@pytest.mark.parametrize("env_id", ENV_IDS)
def test_host_built_env_kernels_match_plain_twins(host_lib, env_id, tableau, substeps, refine):
    cfg = get_config(env_id)
    k1 = PhysicsStep(cfg, substeps, refine, tableau)
    k2 = EnvStep(cfg, substeps, refine, tableau)
    for B, sms in BATCHES:
        rows = pattern_operands(cfg, B, seed=B)
        t1 = check_k1(host_lib, k1, rows[:3], sms)
        t2 = check_k2(host_lib, k2, rows[:5], sms)
        assert torch.equal(t1, t2)
        assert 20 < int(t1.sum()) < B // 2, f"B={B}: {int(t1.sum())} lanes terminated"


@pytest.mark.parametrize("env_id,tableau,substeps,refine",
                         [("GoalContinuous2P-v0", "bs3", 1, 8),
                          ("KeplerRandomOrbits-v0", "dp5", 2, 12)])
def test_host_built_env_kernels_when_the_list_overflows(host_lib, env_id, tableau, substeps,
                                                        refine):
    """Three lanes in four head into planet 0, on two blocks of four tiles:
    a block's firing lanes (about 384) are three times what its list holds
    (128), so the list fills, the lanes past it refine in place and the
    list's lanes are finished by all the block's threads."""
    cfg = get_config(env_id)
    k1 = PhysicsStep(cfg, substeps, refine, tableau)
    k2 = EnvStep(cfg, substeps, refine, tableau)
    B = 1024
    rows = firing_operands(cfg, B, seed=5)
    t1 = check_k1(host_lib, k1, rows[:3], 2)
    t2 = check_k2(host_lib, k2, rows[:5], 2)
    assert torch.equal(t1, t2)
    assert int(t1.sum()) > 3 * 2 * 128, int(t1.sum())


def test_host_build_launch_geometry(host_lib):
    """The persistent grid: min(tiles, resident blocks) blocks of 128 threads,
    each walking an equal share of the tiles, with its list in dynamic shared
    memory: the count, then 6 * NPW + 10 words a slot, 128 slots."""
    out = (ctypes.c_int * 8)()
    for B, sms, grid in ((676, 2, 2), (677, 1, 1), (100, 4, 1), (128 * 9, 4, 4)):
        host_lib.host_set_sms(sms)
        for tab, npw in (("bs3", 3), ("dp5", 4)):
            assert host_lib.sg_fused_step_info(2, TABLEAU_IDS[tab], B, out) == 0
            k1 = dict(zip(FullStep.INFO_KEYS, out))
            assert host_lib.sg_env_step_info(TASK_IDS["goal"], 2, TABLEAU_IDS[tab], B, out) == 0
            k2 = dict(zip(FullStep.INFO_KEYS, out))
            for info in (k1, k2):
                assert info["tiles"] == -(-B // 128) and info["grid"] == grid, (B, info)
                assert info["threads"] == 128 and info["sms"] == sms
                assert info["smem_bytes"] == 16 + (6 * npw + 10) * 128 * 4
