"""Chip smoke run of space_gym_torch on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and swallowed):
  1. card: name and power limit (nvidia-smi), torch and CUDA versions;
  2. build: every kernel under space_gym_torch/csrc/ with nvcc for sm_90a,
     one nvcc per source, all at once; registers and spills per kernel;
  3. kernels against their plain PyTorch twins on the card, same inputs, at
     B=65536 on states with live, truncating, crashing and goal-reaching
     lanes: K1 (csrc/fused_step.cu), K2 (csrc/env_step.cu, four env families,
     both tableaux; K1 and K2 also on a state where four lanes in five fire
     an event, more than the blocks' lists of deferred lanes hold) and K3
     (csrc/full_step.cu; also at B=65537, whose rows
     are not 16-byte aligned and whose last tile is ragged); the two in-kernel generators
     (csrc/rng.cuh) bit for bit against ops/rng_plain.py, and K3-tf
     (csrc/full_step_threefry.cu) and K3-hw (csrc/full_step_philox.cu) given
     key words bit for bit against K3 fed the generator's block; both also
     at a lane offset (a rank's block of lanes), bit for bit the same lanes
     of an offset-0 launch of twice the width;
  4. the main path at full width: EnvEngine("GoalContinuous2P-v0") on the
     card, B=262144 lanes, random policy, BS3 x 1 substep / refine 8 for 256
     steps, once per source of uniforms (bulk draw: three repeats, the median
     reported; "threefry"; "philox") and DP5 x 2 / refine 12 for 32, each
     after 32 warm-up steps, with the launch counts, env steps/s, kernel
     times and their bounds, and device time by kernel over a short profiled
     window, and the registers, residency and waves of the K3
     instantiation that ran (and of K1's and K2's at the same shapes); the
     engine on the card is also held against
     the engine on the CPU on a small input;
  5. the other tiers at full width, a few steps each with the launch counts
     set to 0 before: fuse="env" (K2), fuse="physics" (K1) and
     physics="fixed" (no kernel), each held against fuse="full" from the same
     states and uniforms on live lanes that did not reach their goal;
  5b. physics="adaptive" (float64, no kernel) at B=4096 and 65536 for 8
     steps on given uniforms, the first 512 lanes of each step held against
     the CPU engine from the same state (flags equal, states within 1e-10),
     with ms per step, outer solver steps per lane, lanes through Brent's
     method and host reads per step, then one float32 step at B=262144;
     the adapters: make("GoalContinuous2P-v0") on the card over the golden
     single steps (atol 1e-10), and VectorEnv at 4096 and 262144 envs under
     physics="kernel" (one K3 launch a step, counted and seen by the
     profiler) and "fixed", with ms per step and the NumPy boundary's share;
  6. the learner kernels K4 (csrc/sac_update.cu) and K5
     (csrc/sac_update_fold.cu) against their plain version
     `update_k_reference` on the card at K=4, B=8192, H=256, from gathered
     minibatches and from rows of a replay ring, in float32 and with
     bfloat16-rounded products; each call twice, equal bits; K updates in one
     launch against K launches of one update, equal bits; K5 against K4,
     equal bits; the same at H=512 (B=4096, and B=8192, whose 256 tiles are
     more than the card's blocks: K5 folds several a block) and on a batch
     with partial tiles (B=8156 gathered, ring lanes of 2039); the bf16 mode
     runs its products on the tensor cores, so the HMMA instructions in K4's,
     K5's and K6's SASS are counted after the build (none is a failure);
     the TD3 learner kernel K6 (csrc/td3_update.cu) against its plain version
     the same way, with policy_delay 2 and 3 from an odd update count, at
     H=512, and on partial tiles, in both modes, the two step counts held to
     the plain version's;
  4b. the main path as `python -m space_gym_torch.bench` runs it: the
     rollout at B=262144, BS3 x 1 / refine 8, captured into one CUDA graph,
     once per source of uniforms: held over 16 steps to the same steps run
     eagerly and to the loop of `step` from one generator state (equal
     SHA-256 digests of observations, rewards, dones, the final state and
     the generator), then timed captured and eager over 256 steps without a
     trajectory, its launch counts (a graph's launches times its replays)
     and the device's idle share from the profiler;
  7. the training paths at full width on GoalContinuous2P-v0, lanes 2048,
     rollout 8, K=32 updates of B=8192 per train_iter, H=256, ring of 2048
     rows: SACTrainer with `fused_fold` False (K4) then True (K5), then
     TD3Trainer (K6), all over the captured rollout; for each the launch
     counts set to 0 before and read after, the warm-up gate, finite
     losses, ms per train_iter split into rollout and K-update, device time
     per launch; then PPOTrainer and DQNTrainer (GoalDiscrete3-v0) at the
     JAX trainers' defaults; for all five, one train_iter on the captured
     rollout against one on the eager loop from one state and generator
     state, every leaf equal, and ms per train_iter both ways;
  7b. one `python -m space_gym_torch.bench` run, its line printed;
  7c. the sharded fused trainers (`scale_path`): SAC with K4 and with K5
     and TD3 with K6 at the training path's shape (warm-up of one rollout,
     so that all 3 train_iters update) under `init_distributed` at world 1
     over NCCL, `make_mesh` and `place(..., trainer_state_shardings(...))`,
     every leaf bit for bit the unsharded trainer's, the launch counts set
     to 0 before and read after; then two processes on the one card over
     gloo (`--scale-worker`), 1024 lanes each: the ranks' learner states
     bit for bit equal, each rank's lanes within 1e-5 of the one-process
     run; ms per train_iter of every run and of the gathers;
  7d. physics="native" (the C++ runtime, g++) on every golden step of five
     envs bit for bit physics="host" (sgt_has_blas() printed), and make()
     over the golden steps in the native, host and device modes, ms per step;
  7e. `python -m space_gym_torch.run_agent` on docs/goal2p_sac_best.npz with
     the actor on the card: two episodes without GIFs, one with GIFs into
     build/replays/;
  7f. adversarial states (tests/test_fuzz.py) through K3 and physics="fixed"
     on the card, flags against the CPU on >= 99.9% of lanes, every output
     finite, and a bang-bang rollout at 512 lanes (2000 steps through K3,
     64 through "fixed", whose plain tail takes about 0.1 s a step);
  7g. the device parity tier (`parity_path`, no kernel): the numpy-exact
     library (ops/exact.py) built with g++, the tiling twin's sampler oracle
     on the card (3 Goal configs x 4 seeds x 20 resamples, bitwise against
     HostTiling), all 14 golden files replayed through the parity engine on
     the card (flags equal on every step and errors <= 1e-10; the bitwise
     counts, ms per step and host round trips per step printed), then the
     same 14 files on the CPU, every step bitwise;
  8. a JSON line of the bench line and the train_iter times, one of phases
     7c-7f, one of phase 7g, a `kernels`
     JSON line (K1, K2, K3, K3-tf, K3-hw, K4, K5, K6), the card line again,
     and the final {"ok": true, "device": ...} line.

Everything is made from seeds; it needs no network and imports no JAX.

    python3 chip_smoke.py --sac-bits

prints instead, for the checkout the script lies in, a SHA-256 of K4's, K5's
and K6's outputs (w, vec, the moments, the losses) on the inputs of phase 6's
first cases at H=256, float32 and bf16 mode, gathered minibatches and ring,
and their ms per launch in both modes at the training path's shapes, each
without thread block clusters (C=1) and in the plan's (C printed beside each
line): two checkouts that print the same digest for a kernel, mode and C on
one card compute the same bits there.

    python3 chip_smoke.py --env-bits

prints instead a SHA-256 of everything K1, K2, K3, K3-tf and K3-hw write over
three steps from a seeded state, for every env family and both tableaux, and
each kernel's ms per launch at the main path's shapes: a copy of this script
run from two checkouts on one card prints equal digests where the two
compute the same bits.

    python3 chip_smoke.py --rollout-bits

prints instead a SHA-256 of a captured collect rollout, as the benchmark's
collect cells run it (float32, DP5 x 2 / refine 12, 262144 lanes, the random
policy, 256 steps a call, no trajectory), after 4 calls from seed 0: the
carried state's rows, the observation and each call's reward and done sums;
for GoalContinuous2P-v0 with the bulk draw, threefry and Philox,
GoalContinuous4P-v0 and GoalDiscrete3-v0.  It uses only the engine's
public API, so a copy of this script runs in an older checkout too: equal
digests from two checkouts on one card mean equal bits.

    python3 chip_smoke.py --scale-worker RANK N PORT

is one rank of phase 7c's two-process run (the phase starts both).

    python3 chip_smoke.py --parity

runs phase 7g alone (no kernel is built).

    python3 chip_smoke.py --phase-clock

prints instead where a launch of K1, K2, K3 and K3-hw (the main path's
state, both tableaux) and of K4, of K5 and of K6 (tensor-core path, the
training path's shapes) spends its time, by phase or stage, from builds with
the phase clock (-DSG_PHASE_CLOCK): for want of a profiler of a kernel's
insides.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

# The H100 SXM's peaks and the learner kernels' work counts are the
# benchmark's (benchmark/roofline.py); the bound of a kernel is the larger
# of bytes/BW and ops/FLOPS.
from benchmark.roofline import (BF16_OPS_PER_S, F32_OPS_PER_S, HBM_BYTES_PER_S, sac_work,
                                td3_products, td3_work)

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "build", "reports")  # ptxas reports; gitignored
# Integer operations of one uniform from the in-kernel generators
# (csrc/rng.cuh): threefry2x32 is 20 rounds of add, rotate, xor, 5 key
# injections of 3 adds, the index add and 4 for the float; Philox4x32-10 is 10
# rounds of 4 multiplies and 4 xors plus 9 key bumps of 2 adds for 4 uniforms,
# and 4 each for the float.  They are counted at the f32 rate: the card's
# int32 rate is no higher, so the bound stays a lower bound.
RNG_OPS_PER_UNIFORM = {False: 0, "threefry": 20 * 3 + 5 * 3 + 1 + 4,
                       "philox": (10 * 8 + 9 * 2) / 4 + 4}
RNG_NAMES = {False: "bulk draw", "threefry": "threefry", "philox": "philox"}

MAIN_ENV = "GoalContinuous2P-v0"
MAIN_B = 262144
CHECK_B = 65536
# Tolerances of kernel vs plain twin in float32 on lanes whose flags and
# integer rows agree: the kernels are built without FMA contraction, so the
# two differ by the ulps of rsqrtf/sinf/cosf/logf, amplified at most by the
# Goal reward's distance factor (goal_vel_reward_scale * distance_fctr = 500).
TOL_STATE = 1e-5
TOL_REWARD = 1e-3
MIN_FLAG_AGREEMENT = 0.999
# Tolerances of one tier against another from the same state and uniforms, on
# live lanes that did not reach their goal (tests/test_pallas_full.py::
# test_full_matches_env_fused_on_live_lanes).  The reward's is rtol 1e-3 as
# in test_full_kernel_tiny_vs_fixed_always_on, with TOL_REWARD as atol: the
# fixed tier's physics takes its norms and divisions in another order than
# the kernels', and the Goal reward multiplies the position differences by
# 500, so over 2e6 lane-steps the float32 tail reaches 1.1e-4.
TOL_TIER = 2e-5
TOL_TIER_REWARD = (1e-3, TOL_REWARD)  # rtol, atol
TIER_STEPS = 8
# Steps run before a timed window, so that clocks and caches settle.
WARMUP_STEPS = 32
# physics="adaptive" on the card against the same engine on the CPU (both
# float64, plain PyTorch): the card's libm differs from glibc's by ulps
ADAPTIVE_STEPS = 8
ADAPTIVE_BATCHES = (4096, 65536)
ADAPTIVE_CHECK_LANES = 512
TOL_ADAPTIVE = 1e-10
# make(...) on the card against the golden single-step tier
# (tests/test_golden_parity.py::test_single_step_device_physics)
TOL_GOLDEN = 1e-10
VEC_STEPS = 8
VEC_BATCHES = (4096, MAIN_B)


def fail(msg: str):
    # on both streams: a caller that keeps only the end of one still sees why
    print(f"FAILED: {msg}", flush=True)
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def gpu_clocks() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean ms per call of fn, timed with CUDA events after a warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_device_ms(fn, kernel: str, iters: int = 50, warmup: int = 5, tries: int = 3) -> float:
    """Mean device time per launch of the kernel whose name contains `kernel`
    over `iters` calls of fn (torch.profiler, the launches it recorded).
    Unlike events around a loop of calls, this excludes the host's time to
    make each call.  The profiler's buffer may drop events, at times a whole
    window of them: a window with under 90% of the launches is taken again,
    and after `tries` such windows the time is CUDA-event time per wrapper
    call, which is printed as such."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    for attempt in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and kernel in e.key]
        n = sum(e.count for e in hits)
        if n >= 0.9 * iters:
            return sum(e.self_device_time_total for e in hits) / n / 1e3
        print(f"  the profiler saw {n} of {iters} launches of {kernel} (window {attempt + 1} "
              f"of {tries})", flush=True)
    ms = cuda_ms(fn, iters, warmup=0)
    print(f"  {kernel}: no full profiler window; {ms:.5f} ms per wrapper call by CUDA events "
          f"stands in for the device time", flush=True)
    return ms


# ------------------------------------------------------------- op counting --
def rhs_ops(cfg, tab, sub, B, n_term):
    """Operations side of bound_ms, a lower bound of this data's work: only the
    gravity right-hand sides (csrc/physics.cuh::sg_rhs, about 10 + 12 P float
    ops each), 1 + stages per substep of them per lane (FSAL), and a lane that
    terminates stops after its first substep.  Events, refinement, observation,
    reward and resets come on top; the bytes side bounds both kernels."""
    stages = 6 if tab == "dp5" else 3
    return (10 + 12 * cfg.n_planets) * ((B - n_term) * (1 + sub * stages)
                                        + n_term * (1 + stages))


# --------------------------------------------------------------- scenarios --
def scenario(cfg, B: int, seed: int, device, translated: bool = False):
    """(B, rows) operands of one full step with lanes in every branch:
    lane % 10 == 0 truncates, 1 crashes into planet 0, 2 reaches its goal
    (Goal) or flies out of the world, 3 carries a known goal tile; the rest
    are live lanes of a fresh episode.  The action is the raw one K3 takes
    (FullStep.apply), or with `translated` the one K1 and K2 take
    (`tail_rows`)."""
    from space_gym_torch.engine import EnvEngine

    rng = np.random.default_rng(seed)
    eng = EnvEngine(cfg, device=device)
    u0 = torch.as_tensor(rng.random((B, eng.n_reset_rand), dtype=np.float32), device=device)
    state, _ = eng.reset(B, u=u0)
    y = state.y.clone()
    p = state.planets_pos
    g = state.goal_pos
    lane = torch.arange(B, device=device)
    steps = torch.full((B,), 3, dtype=torch.int32, device=device)
    steps[lane % 10 == 0] = cfg.max_episode_steps - 1
    crash = lane % 10 == 1
    r0 = cfg.planet_radii[0]
    y[crash, 0] = p[crash, 0, 0] + r0 + 0.02
    y[crash, 1] = p[crash, 0, 1]
    y[crash, 3] = -2.0
    y[crash, 4] = 0.0
    special = lane % 10 == 2
    if cfg.task == "goal":
        y[special, 0:2] = g[special]
        y[special, 3:6] = 0.0
    else:
        y[special, 0] = cfg.world_size / 2 - 0.01
        y[special, 1] = 0.0
        y[special, 3] = 3.0
        y[special, 4] = 0.0
    action = torch.as_tensor(rng.uniform(-1, 1, (B, 2)).astype(np.float32), device=device)
    ts = state.tiling
    if cfg.task == "goal":
        goal_tile = ts.goal_tile.clone()
        known = lane % 10 == 3
        goal_tile[known] = ((ts.ship_tile[known] + 1) % cfg.tiling.n_tiles).to(torch.int32)
        ts = ts._replace(goal_tile=goal_tile)
    u = torch.as_tensor(rng.random((B, eng.n_step_rand), dtype=np.float32), device=device)
    state = state._replace(y=y, steps=steps, tiling=ts)
    ops = list(eng.kernel_operands(state, action, u))
    if translated:
        ops[1] = eng._translate_action(action)
    return ops


def tail_rows(ops):
    """K2's component-major operands (y, a, p, g, ref; K1 takes the first
    three) from the (B, rows) ones of `scenario(..., translated=True)`."""
    return [t.reshape(t.shape[0], -1).t().contiguous() for t in ops[:5]]


def main_rows(eng, state, raw_action, u):
    """The operands of one step of the main path's engine: K3's
    (`FullStep.step_rows`, the raw action) and K2's (`tail_rows`, the action
    translated)."""
    rows = eng.full.to_rows(*eng.kernel_operands(state, raw_action, u))
    return rows, [rows[0], eng._translate_action(raw_action).t().contiguous(), *rows[2:5]]


def bits(t):
    """A float tensor's bits as int32, so that equal NaNs compare equal; any
    other tensor as it is."""
    return t.view(torch.int32) if t.is_floating_point() else t


def firing_rows(cfg, B: int, seed: int, device):
    """Component-major operands of K2 (y, a, p, g, ref; K1 takes the first
    three) in which most lanes' events fire: of every five lanes three sit
    just outside planet 0's surface heading into it and one just inside the
    world's border heading out.  Where B is more than the lanes the card
    holds at once, a block walks several tiles and its firing lanes are more
    than its list of deferred lanes holds (csrc/env_lanes.cuh, 128)."""
    ops = scenario(cfg, B, seed, device, translated=True)
    y, p = ops[0].clone(), ops[2]
    lane = torch.arange(B, device=device)
    crash = lane % 5 < 3
    y[crash, 0] = p[crash, 0, 0] + cfg.planet_radii[0] + 0.02
    y[crash, 1] = p[crash, 0, 1]
    y[crash, 3], y[crash, 4] = -2.0, 0.0
    out = lane % 5 == 3
    y[out, 0], y[out, 1] = cfg.world_size / 2 - 0.01, 0.0
    y[out, 3], y[out, 4] = 3.0, 0.0
    ops[0] = y
    return tail_rows(ops)


OUT_NAMES = ("y", "planets", "goal", "ref", "col_shift", "obs", "final_obs", "reward")


def compare(got, want, float_tols):
    """Kernel outputs vs plain outputs: agreement of flags and integer rows,
    max float error on the lanes where both agree (NaN on both sides agrees:
    the reference formula gives it there too)."""
    flags_g, flags_w = got[-1], want[-1]
    ints_g, ints_w = got[-2], want[-2]
    agree = (flags_g == flags_w).all(0) & (ints_g == ints_w).all(0)
    frac = agree.float().mean().item()
    errs, where, top = [], "", -1.0
    for name, g, w, tol in zip(OUT_NAMES, got[:-2], want[:-2], float_tols):
        both_nan = torch.isnan(g) & torch.isnan(w)
        d = torch.where(both_nan, 0.0, (g - w).abs())
        d = torch.where(agree[None, :], d, 0.0)
        d = torch.where(torch.isnan(d), float("inf"), d)
        worst = d.max().item()
        r, lane = divmod(int(torch.argmax(d).item()), d.shape[1])
        at = (f"{name}[{r}] of lane {lane} (lane % 10 = {lane % 10}, flags "
              f"{want[-1][:, lane].tolist()}): kernel {g[r, lane].item()!r} plain "
              f"{w[r, lane].item()!r}")
        if not worst <= tol:
            fail(f"{at}, error above {tol}")
        if worst > top:
            top, where = worst, at
        errs.append(worst)
    return frac, int((~agree).sum().item()), errs, where


def bound(byts, ops):
    return {"bytes": byts / HBM_BYTES_PER_S * 1e3, "operations": ops / F32_OPS_PER_S * 1e3}


def print_build(reports):
    for name, (secs, text) in sorted(reports.items()):
        with open(os.path.join(OUT_DIR, f"ptxas_{name}.txt"), "w") as f:
            f.write(text)
        entry, spill = None, ""
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                entry, spill = m.group(1), ""
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m and entry:
                spill = f", spill stores {m.group(1)} B, loads {m.group(2)} B"
            m = re.search(r"Used (\d+) registers", line)
            if m and entry:
                print(f"  {name}: {entry[:72]}: {m.group(1)} registers{spill}", flush=True)
                entry = None
        print(f"  {name}.cu built in {secs:.1f} s", flush=True)


def check_k1(dev, B):
    """K1 against its plain twin; returns the max float error."""
    from space_gym_torch import get_config
    from space_gym_torch.ops.physics_step import PhysicsStep

    cfg = get_config(MAIN_ENV)
    worst = 0.0
    states = {"branches": tail_rows(scenario(cfg, B, seed=1, device=dev, translated=True))[:3],
              "most lanes fire": firing_rows(cfg, MAIN_B, 1, dev)[:3]}
    for tab, sub, ref in (("dp5", 2, 12), ("bs3", 1, 8)):
        k1 = PhysicsStep(cfg, sub, ref, tab)
        for state, rows in states.items():
            yo, term = k1.step_rows(*rows)
            yw, tw = k1.plain_rows(*rows)
            agree = (term == tw)[0]
            err = (yo[:, agree] - yw[:, agree]).abs().max().item()
            frac = agree.float().mean().item()
            print(f"K1 {MAIN_ENV} {tab}x{sub} r{ref} B={rows[0].shape[1]} ({state}): flag "
                  f"agreement {frac:.6f} "
                  f"({int((~agree).sum())} lanes), terminated {int(tw.sum())}, max|err| "
                  f"{err:.3g}", flush=True)
            if frac < MIN_FLAG_AGREEMENT or not err <= TOL_STATE or int(tw.sum()) == 0:
                fail("K1 disagrees with its plain twin, or no lane terminated")
            worst = max(worst, err)
    return worst


def check_k3(dev, B):
    """K3 against its plain twin on every task; returns the max float error."""
    from space_gym_torch import get_config
    from space_gym_torch.ops.full_step import FullStep

    worst = 0.0
    # the last at B + 1: a ragged last tile, and no row 16-byte aligned
    checks = [(MAIN_ENV, "bs3", 1, 8, B), (MAIN_ENV, "dp5", 2, 12, B),
              ("GoalContinuous4P-v0", "bs3", 1, 8, B), ("KeplerRandomOrbits-v0", "bs3", 1, 8, B),
              ("DoNotCrashContinuous-v0", "bs3", 1, 8, B), (MAIN_ENV, "bs3", 1, 8, B + 1)]
    for env_id, tab, sub, ref, B in checks:
        cfg = get_config(env_id)
        full = FullStep(cfg, sub, ref, tab)
        rows = full.to_rows(*scenario(cfg, B, seed=2, device=dev))
        got = full.step_rows(*rows)
        want = full.plain(*rows)
        frac, n_bad, errs, where = compare(got, want, [TOL_STATE] * 7 + [TOL_REWARD])
        fl = want[-1].sum(1).tolist()
        print(f"K3 {env_id} {tab}x{sub} r{ref} B={B}: flag+int agreement {frac:.6f} "
              f"({n_bad} lanes); terminated/truncated/done {fl}; max|err| state {errs[0]:.3g} "
              f"obs {max(errs[5:7]):.3g} reward {errs[7]:.3g} all {max(errs):.3g}; largest: {where}",
              flush=True)
        if frac < MIN_FLAG_AGREEMENT:
            fail(f"K3 {env_id}: flags/int rows agree on {frac:.6f} of lanes")
        if min(fl) == 0:
            fail(f"K3 {env_id}: a terminated/truncated/done branch was not exercised")
        worst = max(worst, max(errs))
    return worst


def float_err(got, want, agree):
    """Max |got - want| over the lanes in `agree`; NaN on both sides agrees."""
    d = torch.where(torch.isnan(got) & torch.isnan(want), 0.0, (got - want).abs())
    d = torch.where(agree[None, :], d, 0.0)
    return torch.where(torch.isnan(d), float("inf"), d).max().item()


def compare_k2(got, want):
    """K2 outputs (y, terminated, obs, reward) vs the twin's: flag agreement
    and the float errors on agreeing lanes, by K1's and K3's tolerance rules."""
    agree = (got[1] == want[1])[0]
    frac = agree.float().mean().item()
    errs = [float_err(got[i], want[i], agree) for i in (0, 2, 3)]
    for name, err, tol in zip(("y", "obs", "reward"), errs, (TOL_STATE, TOL_STATE, TOL_REWARD)):
        if not err <= tol:
            fail(f"K2 {name}: error {err:.3g} above {tol}")
    return frac, errs


def check_k2(dev, B):
    """K2 against its plain twin on every task and both tableaux; returns the
    max float error."""
    from space_gym_torch import get_config
    from space_gym_torch.ops.env_step import EnvStep

    worst = 0.0
    for env_id in (MAIN_ENV, "GoalContinuous4P-v0", "KeplerRandomOrbits-v0",
                   "DoNotCrashContinuous-v0"):
        cfg = get_config(env_id)
        states = {"branches": tail_rows(scenario(cfg, B, seed=4, device=dev, translated=True))}
        if env_id in (MAIN_ENV, "KeplerRandomOrbits-v0"):
            states["most lanes fire"] = firing_rows(cfg, MAIN_B, 4, dev)
        for tab, sub, ref in (("bs3", 1, 8), ("dp5", 2, 12)):
            k2 = EnvStep(cfg, sub, ref, tab)
            for state, rows in states.items():
                got = k2.step_rows(*rows)
                want = k2.plain_rows(*rows)
                frac, errs = compare_k2(got, want)
                n_term = int(want[1].sum())
                print(f"K2 {env_id} {tab}x{sub} r{ref} B={rows[0].shape[1]} ({state}): flag agreement "
                      f"{frac:.6f}, terminated {n_term}; max|err| state {errs[0]:.3g} obs "
                      f"{errs[1]:.3g} reward {errs[2]:.3g}", flush=True)
                if frac < MIN_FLAG_AGREEMENT or n_term == 0:
                    fail(f"K2 {env_id}: flags agree on {frac:.6f} of lanes, {n_term} terminated")
                worst = max(worst, max(errs))
    return worst


def check_rng(dev, B):
    """The in-kernel generators bit for bit against their plain versions, then
    K3-tf and K3-hw given the key words against K3 fed the generator's block:
    every output bit-identical."""
    from space_gym_torch import get_config
    from space_gym_torch.ops.full_step import FullStep
    from space_gym_torch.ops.rng_plain import key_words

    key = key_words([0xCAFEF00D, 0x80000042], dev)
    for env_id, tab, sub, ref in ((MAIN_ENV, "bs3", 1, 8), (MAIN_ENV, "dp5", 2, 12),
                                  ("GoalContinuous4P-v0", "bs3", 1, 8),
                                  ("KeplerRandomOrbits-v0", "bs3", 1, 8),
                                  ("DoNotCrashContinuous-v0", "bs3", 1, 8)):
        cfg = get_config(env_id)
        mem = FullStep(cfg, sub, ref, tab)
        ops = scenario(cfg, B, seed=6, device=dev)
        for mode in ("threefry", "philox"):
            keyed = FullStep(cfg, sub, ref, tab, in_kernel_rng=mode)
            u = keyed.kernel_uniforms(key, B)
            want_u = keyed.plain_uniforms(key, B)
            same = torch.equal(u.view(torch.int32), want_u.view(torch.int32))
            in_range = bool(((u >= 0) & (u < 1)).all())
            rows = mem.to_rows(*ops[:7], u.t())
            got = keyed.step_rows(*rows[:6], key, rows[7])
            want = mem.step_rows(*rows)
            bad = [n for n, g, w in zip(OUT_NAMES + ("int_rows", "flags"), got, want)
                   if not torch.equal(bits(g), bits(w))]
            print(f"rng {mode} {env_id} {tab}x{sub} B={B}: ({keyed.n_uniform_rows}, {B}) block "
                  f"bitwise equal to the plain version: {same}, in [0, 1): {in_range}, mean "
                  f"{u.mean().item():.6f}; K3 with the key vs K3 fed the block: "
                  f"{'all outputs bit-identical' if not bad else 'differ in ' + str(bad)}; "
                  f"done lanes {int(want[-1][2].sum())}", flush=True)
            if not (same and in_range) or bad or int(want[-1][2].sum()) == 0:
                fail(f"in-kernel {mode} disagrees with its plain version or with K3")
            check_lane_offset(cfg, mem, keyed, key, B, seed=6, device=dev)


def check_lane_offset(cfg, mem, keyed, key, B, seed, device):
    """K3-tf or K3-hw at lane0 = B (a rank's second block of lanes): its block
    of uniforms bit for bit the plain version's and the same lanes of an
    offset-0 block of 2B; the step bit for bit K3 fed that block, and the
    same lanes of an offset-0 launch of 2B lanes."""
    u_off = keyed.kernel_uniforms(key, B, lane0=B)
    plain = keyed.plain_uniforms(key, B, B)
    same_u = (torch.equal(u_off.view(torch.int32), plain.view(torch.int32))
              and torch.equal(u_off, keyed.kernel_uniforms(key, 2 * B)[:, B:]))
    wide_rows = mem.to_rows(*scenario(cfg, 2 * B, seed=seed + 1, device=device))
    wide = keyed.step_rows(*wide_rows[:6], key, wide_rows[7])
    block = mem.lane_block(wide_rows, B)
    got = keyed.step_rows(*block[:6], key, block[7], lane0=B)
    fed = mem.step_rows(*block[:6], u_off, block[7])
    bad = [n for n, g, w, f in zip(OUT_NAMES + ("int_rows", "flags"), got, wide, fed)
           if not (torch.equal(bits(g), bits(w[:, B:])) and torch.equal(bits(g), bits(f)))]
    print(f"  {keyed.rng} at lane0={B}: block bitwise equal to the plain version and to lanes "
          f"{B}.. of a {2 * B}-lane block: {same_u}; the step against lanes {B}.. of the "
          f"{2 * B}-lane launch and against K3 fed the block: "
          f"{'all outputs bit-identical' if not bad else 'differ in ' + str(bad)}; done lanes "
          f"{int(got[-1][2].sum())}", flush=True)
    if not same_u or bad or int(got[-1][2].sum()) == 0:
        fail(f"in-kernel {keyed.rng} at a lane offset disagrees")


def check_engine(dev, small=512, steps=8):
    """The engine on `dev` against the engine on the CPU, same uniforms,
    teacher-forced from the CPU trajectory; returns the max obs error."""
    from space_gym_torch import get_config
    from space_gym_torch.engine import EnvEngine, state_from_numpy, state_to_numpy

    cfg = get_config(MAIN_ENV)
    eg = EnvEngine(cfg, tableau="bs3", substeps=1, refine_iters=8, device=dev)
    ec = EnvEngine(cfg, tableau="bs3", substeps=1, refine_iters=8, device="cpu")
    rng = np.random.default_rng(3)
    u0 = rng.random((small, eg.n_reset_rand), dtype=np.float32)
    _, og = eg.reset(small, u=torch.as_tensor(u0, device=dev))
    sc, oc = ec.reset(small, u=torch.as_tensor(u0))
    worst = (og.cpu() - oc).abs().max().item()
    for _ in range(steps):
        a = torch.as_tensor(rng.uniform(-1, 1, (small, 2)).astype(np.float32))
        u = torch.as_tensor(rng.random((small, eg.n_step_rand), dtype=np.float32))
        sg = state_from_numpy(state_to_numpy(sc), device=dev)
        _, tg = eg.step(sg, a.to(dev), u=u.to(dev))
        sc, tc = ec.step(sc, a, u=u)
        same = (tg.done.cpu() == tc.done) & (tg.terminated.cpu() == tc.terminated)
        if same.float().mean().item() < 0.99:
            fail("engine on the card and on the CPU disagree on done flags")
        worst = max(worst, (tg.final_obs.cpu()[same] - tc.final_obs[same]).abs().max().item())
    print(f"engine {dev} vs cpu, {MAIN_ENV} B={small} x {steps} steps: "
          f"max|obs err| {worst:.3g}", flush=True)
    if not worst <= TOL_STATE:
        fail("engine on the card disagrees with the engine on the CPU")


KERNELS = ("full_step", "full_step_threefry", "full_step_philox", "env_step", "fused_step",
           "sac_update", "sac_update_fold", "td3_update")


def reset_launches():
    """Set every launch count to 0 (utils/profiling.py)."""
    from space_gym_torch.utils import profiling

    profiling.reset_counts()


def read_launches():
    """Launch counts by kernel since the last reset: the launches each wrapper
    made, a CUDA graph's launches once per replay included (utils/profiling.py)."""
    from space_gym_torch.utils import profiling

    counts = profiling.counts()
    return {k: counts.get(k, 0) for k in KERNELS}


K3_NAMES = {False: "full_step", "threefry": "full_step_threefry", "philox": "full_step_philox"}


def warm_engine(dev, B, tab, sub, ref, rng=False, seed=0, env_id=MAIN_ENV):
    """The main path's engine on `env_id` (GoalContinuous2P-v0) with K3's
    uniforms from `rng`, B lanes after WARMUP_STEPS of the random policy:
    (engine, generator, policy, state, obs)."""
    from space_gym_torch import get_config
    from space_gym_torch.engine import EnvEngine

    eng = EnvEngine(get_config(env_id), tableau=tab, substeps=sub, refine_iters=ref,
                    device=dev, in_kernel_rng=rng)
    g = eng.generator(seed)
    policy = eng.random_policy()
    state, obs = eng.init(B, g)
    for _ in range(WARMUP_STEPS):
        state, ts = eng.step(state, policy(g, obs), g)
        obs = ts.obs
    return eng, g, policy, state, obs


def launch_line(full, B):
    """Registers, local memory, residency and waves of the instantiation that
    a launch of B lanes runs (`kernel_info` of FullStep, EnvStep or
    PhysicsStep)."""
    k = full.kernel_info(B)
    waves = k["tiles"] / (k["blocks_per_sm"] * k["sms"])
    return (f"{k['registers']} registers, {k['local_bytes']} B local memory a thread, "
            f"{k['blocks_per_sm']} blocks of {k['threads']} threads resident per SM "
            f"({k['smem_bytes']} B dynamic shared memory a block), {k['sms']} SMs, grid "
            f"{k['grid']} for {k['tiles']} lane tiles: {waves:.3f} waves"), k


def main_path(dev, card, B, tab, sub, ref, n_steps, rng=False, time_ms=cuda_ms, plain_iters=3,
              kernel_ms=None):
    """The main path at full width with K3's uniforms from `rng`; returns its
    measurements.  With the bulk draw it also holds K1 and K2 against their
    twins on the run's last state and times them there."""
    kernel_ms = kernel_ms or kernel_device_ms
    from space_gym_torch import get_config
    from space_gym_torch.ops.env_step import EnvStep
    from space_gym_torch.ops.physics_step import PhysicsStep

    cfg = get_config(MAIN_ENV)
    eng, g, policy, state, obs = warm_engine(dev, B, tab, sub, ref, rng)
    name = K3_NAMES[rng]
    rew_sum = torch.zeros((), device=dev)
    done_sum = torch.zeros((), dtype=torch.int64, device=dev)
    term_sum = torch.zeros((), dtype=torch.int64, device=dev)

    def run():
        nonlocal state, obs, rew_sum, done_sum, term_sum
        for _ in range(n_steps):
            state, ts = eng.step(state, policy(g, obs), g)
            obs = ts.obs
            rew_sum += ts.reward.sum()
            done_sum += ts.done.sum()
            term_sum += ts.terminated.sum()

    reset_launches()
    w0 = time.perf_counter()
    ms_total = time_ms(run, iters=1, warmup=0)
    wall = time.perf_counter() - w0
    launches = read_launches()
    clocks = gpu_clocks() if torch.device(dev).type == "cuda" else "n/a"
    if launches[name] != n_steps or sum(launches.values()) != n_steps:
        fail(f"{name} launched {launches[name]} times in {n_steps} steps: {launches}")
    if not all(torch.isfinite(t).all().item() for t in
               (state.y, state.planets_pos, state.goal_pos, obs)):
        fail("main path state or observation not finite")
    if obs.shape != (B, cfg.obs_dim):
        fail(f"observation of shape {tuple(obs.shape)}")
    n_done = int(done_sum.item())
    if n_done == 0:
        fail("no lane reset in the main-path run")

    # K3 alone on this run's last state, held against its plain twin on the
    # same operands (the main path's own shape and state), then timed.  With
    # an in-kernel source the twin runs on the plain generator's block.
    full = eng.full
    n_u = full.n_uniform_rows
    u = eng.draw_key(g) if rng else torch.rand((B, n_u), generator=g, device=dev)
    rows, tail = main_rows(eng, state, policy(g, obs), u)

    def plain_call():
        u_rows = full.plain_uniforms(rows[6], B) if rng else rows[6]
        return full.plain(*rows[:6], u_rows, rows[7])

    out = full.step_rows(*rows)
    want = plain_call()
    frac, n_bad, errs, where = compare(out, want, [TOL_STATE] * 7 + [TOL_REWARD])
    k3_err = max(errs)
    print(f"K3 ({RNG_NAMES[rng]}) vs plain on the main path's state, {tab}x{sub} r{ref} B={B}: "
          f"flag+int agreement {frac:.6f} ({n_bad} lanes); terminated/truncated/done "
          f"{want[-1].sum(1).tolist()}; max|err| {k3_err:.3g}; largest: {where}", flush=True)
    if frac < MIN_FLAG_AGREEMENT:
        fail(f"K3 on the main path's state: flags/int rows agree on {frac:.6f} of lanes")
    k3_call_ms = time_ms(lambda: full.step_rows(*rows), iters=200, warmup=20)
    k3_ms = kernel_ms(lambda: full.step_rows(*rows), "full_step_kernel")
    k3_plain_ms = time_ms(plain_call, iters=plain_iters, warmup=1)
    # the one library call that computes the random part's function: the bulk draw
    rand_ms = time_ms(lambda: torch.rand((B, n_u), generator=g, device=dev), iters=50, warmup=5)
    flags = out[-1]
    n_term, n_done1 = int(flags[0].sum()), int(flags[2].sum())
    n_reached = int(((out[2] != rows[3]).any(0) & (flags[2] == 0)).sum())
    # A lane takes its resample rows of u only where it reached its goal and
    # its reset rows only where it is done: read from memory (bulk draw) or
    # computed (in-kernel source).  Count what this data needs.
    gp = 3 + 3 * cfg.tiling.n_tiles
    u_taken = n_reached * gp + n_done1 * (n_u - gp)
    k3_ops = rhs_ops(cfg, tab, sub, B, n_term) + RNG_OPS_PER_UNIFORM[rng] * u_taken
    k3_bytes = full.bytes_per_lane() * B + (8 if rng else 4 * (u_taken - n_u * B))
    k3_bound = bound(k3_bytes, k3_ops)

    ms_step = ms_total / n_steps
    sps = B * n_steps / (ms_total / 1e3)
    print(f"main path {MAIN_ENV} B={B} {tab}x{sub} r{ref} uniforms by {RNG_NAMES[rng]}, "
          f"{n_steps} steps on {card}: "
          f"{sps:.6g} env-steps/s, {ms_step:.5f} ms/step (host wall {wall:.3f} s), "
          f"K3 {k3_ms:.5f} ms/launch on the device ({100 * k3_ms / ms_step:.1f}% of the step; "
          f"{k3_call_ms:.5f} ms per wrapper call back to back), "
          f"plain twin {k3_plain_ms:.3f} ms/step; torch.rand(({B}, {n_u})) {rand_ms:.5f} ms; "
          f"reward sum {rew_sum.item():.6g}, "
          f"dones {n_done}, terminated {int(term_sum.item())}; launches {launches}; "
          f"after the window sm clock, power: {clocks}", flush=True)
    info_text, info = launch_line(full, B)
    print(f"  K3 launch: {info_text}", flush=True)
    print(f"  K3 bound: operand list {full.bytes_per_lane()} B/lane-step -> "
          f"{full.bytes_per_lane() * B / HBM_BYTES_PER_S * 1e3:.5f} ms at "
          f"{HBM_BYTES_PER_S / 1e12} TB/s; this data's bytes {k3_bytes / B:.1f} B/lane -> "
          f"{k3_bound['bytes']:.5f} ms ({n_done1} lanes done, {n_reached} reached, "
          f"{u_taken / B:.2f} uniforms/lane taken); "
          f"{k3_ops / B:.0f} ops/lane -> {k3_bound['operations']:.5f} ms at "
          f"{F32_OPS_PER_S / 1e12} TFLOP/s f32", flush=True)
    res = dict(rng=rng, launches=launches, k3_err=k3_err, k3_ms=k3_ms, k3_plain_ms=k3_plain_ms,
               k3_bound=k3_bound, rand_ms=rand_ms, sps=sps, ms_step=ms_step, dones=n_done,
               k3_launch=info)
    if rng:
        return res

    # K1 and K2 at the same shapes and configuration, on the same state and
    # actions (translated, as they take them).
    k1 = PhysicsStep(cfg, sub, ref, tab)
    yo, term = k1.step_rows(*tail[:3])
    yw, tw = k1.plain_rows(*tail[:3])
    agree = (term == tw)[0]
    k1_err = float_err(yo, yw, agree)
    print(f"K1 vs plain on the main path's state, {tab}x{sub} r{ref} B={B}: flag agreement "
          f"{agree.float().mean().item():.6f}, max|err| {k1_err:.3g}", flush=True)
    if agree.float().mean().item() < MIN_FLAG_AGREEMENT or not k1_err <= TOL_STATE:
        fail("K1 disagrees with its plain twin on the main path's state")
    k1_call_ms = time_ms(lambda: k1.step_rows(*tail[:3]), iters=200, warmup=20)
    k1_ms = kernel_ms(lambda: k1.step_rows(*tail[:3]), "fused_step_kernel")
    k1_plain_ms = time_ms(lambda: k1.plain_rows(*tail[:3]), iters=plain_iters, warmup=1)
    k1_bound = bound(4 * (6 + 2 + 2 * cfg.n_planets + 6 + 1) * B,
                     rhs_ops(cfg, tab, sub, B, int(tw.sum())))
    print(f"  K1: {k1_ms:.5f} ms/launch on the device ({k1_call_ms:.5f} ms per wrapper call), "
          f"plain {k1_plain_ms:.3f} ms, bound bytes {k1_bound['bytes']:.5f} ms, operations "
          f"{k1_bound['operations']:.5f} ms", flush=True)
    print(f"  K1 launch: {launch_line(k1, B)[0]}", flush=True)

    k2 = EnvStep(cfg, sub, ref, tab)
    got2 = k2.step_rows(*tail)
    want2 = k2.plain_rows(*tail)
    frac2, errs2 = compare_k2(got2, want2)
    k2_err = max(errs2)
    print(f"K2 vs plain on the main path's state, {tab}x{sub} r{ref} B={B}: flag agreement "
          f"{frac2:.6f}, max|err| state {errs2[0]:.3g} obs {errs2[1]:.3g} reward {errs2[2]:.3g}",
          flush=True)
    if frac2 < MIN_FLAG_AGREEMENT:
        fail("K2 disagrees with its plain twin on the main path's state")
    k2_call_ms = time_ms(lambda: k2.step_rows(*tail), iters=200, warmup=20)
    k2_ms = kernel_ms(lambda: k2.step_rows(*tail), "env_step_kernel")
    k2_plain_ms = time_ms(lambda: k2.plain_rows(*tail), iters=plain_iters, warmup=1)
    k2_bound = bound(k2.bytes_per_lane() * B, rhs_ops(cfg, tab, sub, B, int(want2[1].sum())))
    print(f"  K2: {k2_ms:.5f} ms/launch on the device ({k2_call_ms:.5f} ms per wrapper call), "
          f"plain {k2_plain_ms:.3f} ms, bound bytes {k2_bound['bytes']:.5f} ms "
          f"({k2.bytes_per_lane()} B/lane), operations {k2_bound['operations']:.5f} ms", flush=True)
    print(f"  K2 launch: {launch_line(k2, B)[0]}", flush=True)
    res.update(k1_err=k1_err, k1_ms=k1_ms, k1_plain_ms=k1_plain_ms, k1_bound=k1_bound,
               k2_err=k2_err, k2_ms=k2_ms, k2_plain_ms=k2_plain_ms, k2_bound=k2_bound)
    return res


def tier_path(dev, card, B, tier, n_steps=TIER_STEPS):
    """One of the engine's other tiers at full width for a few steps, with the
    launch counts set to 0 before, held step by step against fuse="full" from
    the same state, actions and uniforms on live lanes that did not reach
    their goal.  DP5 x 2 / refine 12, which every tier has.  Returns the
    launch counts and ms/step."""
    from space_gym_torch import get_config
    from space_gym_torch.engine import EnvEngine

    cfg = get_config(MAIN_ENV)
    kw = {"fixed": dict(physics="fixed"), "env": dict(fuse="env"),
          "physics": dict(fuse="physics")}[tier]
    ref_eng = EnvEngine(cfg, device=dev)
    eng = EnvEngine(cfg, device=dev, **kw)
    if eng.n_step_rand != ref_eng.n_step_rand or eng.n_reset_rand != ref_eng.n_reset_rand:
        fail(f"tier {tier} consumes {eng.n_step_rand} uniforms a step, fuse='full' "
             f"{ref_eng.n_step_rand}")
    g = ref_eng.generator(7)
    policy = ref_eng.random_policy()
    state, obs = ref_eng.init(B, g)
    for _ in range(WARMUP_STEPS):
        state, ts = ref_eng.step(state, policy(g, obs), g)
        obs = ts.obs
    eng.step(state, policy(g, obs), g)  # builds and loads the tier's kernel
    torch.cuda.synchronize()

    # the tier alone, on its own trajectory, between a reset and a read of
    # the launch counts; every step's inputs and outputs are kept
    reset_launches()
    trace = []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n_steps):
        a = policy(g, obs)
        u = torch.rand((B, eng.n_step_rand), generator=g, device=dev)
        new_state, ts = eng.step(state, a, u=u)
        trace.append((state, a, u, new_state, ts))
        state, obs = new_state, ts.obs
    end.record()
    torch.cuda.synchronize()
    tier_ms = start.elapsed_time(end)
    launches = read_launches()

    # then fuse="full" from each step's state, action and uniforms
    worst = {"y": 0.0, "obs": 0.0, "reward": 0.0}
    compared = 0
    rtol, atol = TOL_TIER_REWARD
    for state0, a, u, st, tt in trace:
        sf, tf = ref_eng.step(state0, a, u=u)
        same = (tt.done == tf.done) & (tt.terminated == tf.terminated)
        if same.float().mean().item() < MIN_FLAG_AGREEMENT:
            fail(f"tier {tier}: done flags agree with fuse='full' on "
                 f"{same.float().mean().item():.6f} of lanes")
        reached = (state0.goal_pos - sf.y[:, :2]).norm(dim=1) < cfg.goal_radius
        m = same & ~tf.done & ~reached
        if int(m.sum()) < B // 2:
            fail(f"tier {tier}: only {int(m.sum())} live lanes to compare")
        compared += int(m.sum())
        worst["y"] = max(worst["y"], (st.y - sf.y)[m].abs().max().item())
        worst["obs"] = max(worst["obs"], (tt.obs - tf.obs)[m].abs().max().item())
        over = ((tt.reward - tf.reward).abs() - rtol * tf.reward.abs())[m].max().item()
        worst["reward"] = max(worst["reward"], over)
        if not (worst["y"] <= TOL_TIER and worst["obs"] <= TOL_TIER and over <= atol):
            fail(f"tier {tier} disagrees with fuse='full': {worst}")
        if not all(torch.isfinite(t).all().item() for t in (st.y, tt.obs, tt.reward)):
            fail(f"tier {tier}: state, observation or reward not finite")
    want = {"env": "env_step", "physics": "fused_step", "fixed": None}[tier]
    for k, v in launches.items():
        if v != (n_steps if k == want else 0):
            fail(f"tier {tier}: launches {launches} in {n_steps} steps")
    print(f"tier {tier} {MAIN_ENV} B={B} dp5x2 r12, {n_steps} steps on {card}: "
          f"{tier_ms / n_steps:.4f} ms/step, launches {launches}; against fuse='full' on "
          f"{compared} live lane-steps: max|err| state {worst['y']:.3g} obs {worst['obs']:.3g}, "
          f"reward error beyond rtol {TOL_TIER_REWARD[0]}: {worst['reward']:.3g}", flush=True)
    return dict(launches=launches, ms_step=tier_ms / n_steps)


def sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def adaptive_path(dev, card, batches=ADAPTIVE_BATCHES, n_steps=ADAPTIVE_STEPS,
                  check_lanes=ADAPTIVE_CHECK_LANES, wide=MAIN_B):
    """physics="adaptive" (ops/rk45.py::solve_step under the tail; no kernel)
    on the card in float64 at each batch size for `n_steps` steps of a random
    policy on given uniforms, the launch counts set to 0 before and read
    after (no kernel may launch); one lane in 16 starts on a crash course, so
    that Brent's method runs.  At each step the first `check_lanes`
    lanes are held against the same engine on the CPU from the card's
    pre-step state with the same actions and uniforms: flags equal, state
    and observations within TOL_ADAPTIVE.  Then one float32 step at the main
    path's width.  Prints ms per step (host clock: the solver reads its loop
    conditions on the host), the outer steps per lane, the lanes that ran
    Brent's method and the host reads per step."""
    from space_gym_torch import get_config
    from space_gym_torch.engine import EnvEngine

    cfg = get_config(MAIN_ENV)
    out = {}
    for B in batches:
        eng = EnvEngine(cfg, physics="adaptive", dtype=torch.float64, device=dev)
        cpu = EnvEngine(cfg, physics="adaptive", dtype=torch.float64, device="cpu")
        rng = np.random.default_rng(B)
        state, _ = eng.reset(B, u=torch.as_tensor(rng.random((B, eng.n_reset_rand)), device=dev))
        state = state._replace(y=crash_course(cfg, state, every=16))
        reset_launches()
        ms, outer_mean, outer_max, brent, syncs = [], [], [], 0, 0
        worst = 0.0
        for _ in range(n_steps):
            act = torch.as_tensor(rng.uniform(-1, 1, (B, 2)), device=dev)
            u = torch.as_tensor(rng.random((B, eng.n_step_rand)), device=dev)
            pre = state
            sync(dev)
            t0 = time.perf_counter()
            state, ts = eng.step(state, act, u=u)
            sync(dev)
            ms.append((time.perf_counter() - t0) * 1e3)
            st = eng.solve_stats
            n = st["n_steps"].double()
            outer_mean.append(n.mean().item())
            outer_max.append(int(n.max().item()))
            brent += st["brent_lanes"]
            syncs += st["syncs"]
            # the CPU from the card's pre-step state, on the first lanes
            k = check_lanes
            pre_c = first_lanes(pre, k)
            sc, tc = cpu.step(pre_c, act[:k].cpu(), u=u[:k].cpu())
            for f in ("terminated", "truncated", "done"):
                if not torch.equal(getattr(ts, f)[:k].cpu(), getattr(tc, f)):
                    fail(f"adaptive B={B}: {f} flags differ between the card and the CPU")
            for got, want in ((state.y[:k], sc.y), (ts.obs[:k], tc.obs),
                              (ts.final_obs[:k], tc.final_obs)):
                worst = max(worst, (got.cpu() - want).abs().max().item())
            if not worst <= TOL_ADAPTIVE:
                fail(f"adaptive B={B}: the card and the CPU differ by {worst:.3g}")
            if not torch.isfinite(state.y).all():
                fail(f"adaptive B={B}: a state is not finite (a failed solve)")
        launches = read_launches()
        if any(launches.values()):
            fail(f"adaptive B={B}: a kernel was launched: {launches}")
        if brent < B // 16:
            fail(f"adaptive B={B}: only {brent} lanes ran Brent's method; the {B // 16} on a "
                 f"crash course should have")
        ms_med = float(np.median(ms))
        print(f"adaptive {MAIN_ENV} float64 B={B} on {card}: {ms_med:.3f} ms/step (median of "
              f"{n_steps}; {', '.join(f'{m:.3f}' for m in ms)}), outer steps per lane mean "
              f"{np.mean(outer_mean):.4f} max {max(outer_max)}, lanes through Brent "
              f"{brent / n_steps:.1f}/step, host reads {syncs / n_steps:.1f}/step; first "
              f"{check_lanes} lanes against the CPU: flags equal, max|err| {worst:.3g}; "
              f"launches {launches}", flush=True)
        out[B] = dict(ms_step=ms_med, outer_mean=float(np.mean(outer_mean)),
                      outer_max=max(outer_max), brent_per_step=brent / n_steps,
                      syncs_per_step=syncs / n_steps, max_abs_err=worst)
    eng = EnvEngine(cfg, physics="adaptive", dtype=torch.float32, device=dev)
    g = eng.generator(3)
    policy = eng.random_policy()
    state, obs = eng.init(wide, g)
    times = []
    for _ in range(2):  # the first step also settles the allocator
        sync(dev)
        t0 = time.perf_counter()
        state, ts = eng.step(state, policy(g, obs), g)
        sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
        obs = ts.obs
    if not (torch.isfinite(state.y).all() and torch.isfinite(ts.obs).all()):
        fail("adaptive float32: a state or observation is not finite")
    st = eng.solve_stats
    print(f"adaptive {MAIN_ENV} float32 B={wide} on {card}: {times[1]:.3f} ms/step (first step "
          f"{times[0]:.3f}), outer steps per lane max {int(st['n_steps'].max())}, host reads "
          f"{st['syncs']}", flush=True)
    out["float32"] = dict(B=wide, ms_step=times[1], syncs=st["syncs"])
    return out


def crash_course(cfg, state, every):
    """The state's y with every `every`-th lane (from lane 1) just outside
    planet 0 and flying into it, so that its first step ends at an event."""
    y = state.y.clone()
    crash = torch.arange(y.shape[0], device=y.device) % every == 1
    p0 = state.planets_pos[crash, 0]
    y[crash, 0] = p0[:, 0] + cfg.planet_radii[0] + 0.02
    y[crash, 1] = p0[:, 1]
    y[crash, 3] = -2.0
    y[crash, 4] = 0.0
    return y


def first_lanes(state, k):
    """The first k lanes of a state (NamedTuples of tensors), on the CPU."""
    if state is None:
        return None
    if isinstance(state, tuple):
        return type(state)(*[first_lanes(v, k) for v in state])
    return state[:k].cpu()


def golden_steps(env, env_id):
    """ep0 of the recorded episode of `env_id` (tests/goldens/, seed 42),
    each step from its recorded pre-step state through `env`: returns the
    largest state error and the ms per step on the host clock."""
    g = np.load(os.path.join(HERE, "tests", "goldens", f"{env_id}.npz"))
    p = "ep0_"
    np.random.seed(int(g["seed"]))
    env.seed(int(g["seed"]))
    env.reset()
    env.planets_pos = g[p + "reset_planets"]
    worst, n = 0.0, len(g[p + "actions"])
    t0 = time.perf_counter()
    for t in range(n):
        env._state_vec = g[p + "pre_states"][t].copy()
        env.goal_pos = (g[p + "reset_goal"] if t == 0 else g[p + "goals"][t - 1]).copy()
        env._elapsed_steps = 0
        _, _, done, _ = env.step(g[p + "actions"][t])
        if done != (bool(g[p + "dones"][t]) and not bool(g[p + "truncated"][t])):
            fail(f"make({env_id!r}): done differs from the golden at step {t}")
        worst = max(worst, float(np.abs(env._state_vec - g[p + "post_states"][t]).max()))
    return worst, (time.perf_counter() - t0) * 1e3 / n, n


def adapter_path(dev, card, batches=VEC_BATCHES, n_steps=VEC_STEPS, profile=True):
    """The adapters on the card.  make("GoalContinuous2P-v0") (physics=
    "device": solve_step on one float64 lane) over the recorded golden steps
    at TOL_GOLDEN; then VectorEnv at each width under physics="kernel" (K3,
    one launch a step: the counts set to 0 before and read after, and seen
    by the profiler) and "fixed" (no kernel), with ms per `step` and the
    share of it spent at the NumPy boundary (the copies and the `infos`
    list, timed apart from the engine's step in a second run of the steps)."""
    import space_gym_torch

    env = space_gym_torch.make(MAIN_ENV, device=dev)
    if env.device != torch.device(dev):
        fail(f"make ran on {env.device}, not {dev}")
    reset_launches()
    worst, ms_golden, n_golden = golden_steps(env, MAIN_ENV)
    launches = read_launches()
    if not worst <= TOL_GOLDEN or any(launches.values()):
        fail(f"make({MAIN_ENV!r}) on the card: golden steps max|err| {worst:.3g}, launches "
             f"{launches}")
    print(f"make {MAIN_ENV} physics='device' on {card}: {n_golden} golden steps, max|err| "
          f"{worst:.3g} (tolerance {TOL_GOLDEN}), {ms_golden:.3f} ms/step", flush=True)
    out = {"make": dict(ms_step=ms_golden, max_abs_err=worst, steps=n_golden)}
    for physics in ("kernel", "fixed"):
        for B in batches:
            venv = space_gym_torch.VectorEnv(MAIN_ENV, num_envs=B, physics=physics, device=dev)
            rng = np.random.default_rng(B)
            acts = [rng.uniform(-1, 1, (B, 2)).astype(np.float32) for _ in range(n_steps)]
            venv.reset()
            venv.step(acts[0])  # builds and loads the kernel
            sync(dev)
            reset_launches()
            t0 = time.perf_counter()
            for a in acts:
                obs, rewards, dones, infos = venv.step(a)
            total = (time.perf_counter() - t0) * 1e3 / n_steps
            launches = read_launches()
            want = n_steps if physics == "kernel" else 0
            if launches["full_step"] != want or sum(launches.values()) != want:
                fail(f"VectorEnv physics={physics!r} B={B}: launches {launches} in {n_steps} "
                     f"steps")
            if not (np.isfinite(obs).all() and len(infos) == B
                    and all(("terminal_observation" in i) == d for i, d in zip(infos, dones))):
                fail(f"VectorEnv physics={physics!r} B={B}: outputs or infos are wrong")
            # the same steps in their parts: the actions' upload, the
            # engine's step, the copies back and the infos list
            eng, state, g = venv.engine, venv._state, venv._generator
            parts = np.zeros(3)
            for a in acts:
                sync(dev)
                t0 = time.perf_counter()
                at = torch.as_tensor(a, device=dev)
                sync(dev)
                t1 = time.perf_counter()
                state, ts = eng.step(state, at, g)
                sync(dev)
                t2 = time.perf_counter()
                venv._to_host(ts)
                parts += (t1 - t0, t2 - t1, time.perf_counter() - t2)
            engine_ms = float(parts[1] * 1e3 / n_steps)
            share = float((parts[0] + parts[2]) / parts.sum())
            hits = None
            if physics == "kernel" and profile:
                _, _, hits, counted = counted_window(lambda: [venv.step(a) for a in acts],
                                                     "full_step_kernel", n_steps, top=3)
                if hits != n_steps or counted["full_step"] != hits:
                    fail(f"VectorEnv physics='kernel' B={B}: the profiler saw {hits} K3 launches "
                         f"in {n_steps} steps, the counts say {counted}")
            print(f"VectorEnv physics={physics!r} {MAIN_ENV} B={B} on {card}: {total:.4f} "
                  f"ms/step, engine alone {engine_ms:.4f} ms/step, NumPy boundary "
                  f"{100 * share:.1f}% of a step; launches {launches}"
                  + (f", profiler: {hits} K3 launches" if hits is not None else ""), flush=True)
            out[f"{physics}_{B}"] = dict(ms_step=total, engine_ms=engine_ms, boundary=share,
                                         launches=launches["full_step"])
    return out


def profile_main_path(dev, B, tab, sub, ref, rng=False, n_steps=8, top=10):
    """Device time by kernel over a short window of the main path with K3's
    uniforms from `rng` (torch.profiler, CUDA activity); prints the largest
    entries."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from space_gym_torch import get_config
    from space_gym_torch.engine import EnvEngine

    eng = EnvEngine(get_config(MAIN_ENV), tableau=tab, substeps=sub, refine_iters=ref, device=dev,
                    in_kernel_rng=rng)
    g = eng.generator(1)
    policy = eng.random_policy()
    state, obs = eng.init(B, g)
    for _ in range(2):
        state, ts = eng.step(state, policy(g, obs), g)
        obs = ts.obs
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n_steps):
            state, ts = eng.step(state, policy(g, obs), g)
            obs = ts.obs
        torch.cuda.synchronize()
    # device-side events only: the CPU ops above them report their kernels' time too
    rows = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    if not rows:
        print("profiler: no device time recorded in this environment", flush=True)
        return
    busy = sum(r[1] for r in rows)
    print(f"profile {MAIN_ENV} B={B} {tab}x{sub} r{ref} uniforms by {RNG_NAMES[rng]}, "
          f"{n_steps} steps: kernels busy "
          f"{busy / n_steps / 1e3:.4f} ms/step (profiler on)", flush=True)
    for key, us, count in rows[:top]:
        print(f"  {100 * us / busy:5.1f}%  {us / n_steps / 1e3:.4f} ms/step  "
              f"{count / n_steps:g}/step  {key[:100]}", flush=True)


# ------------------------------------------------- the captured rollout --
ROLLOUT_CHECK_STEPS = 16


def digest(*tensors) -> str:
    """SHA-256 (first 16 hex digits) of the tensors' bytes, in order."""
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def leaves(tree):
    """Every leaf of a state (NamedTuples, dicts, the replay ring), in order."""
    from space_gym_torch.utils import checkpoint

    return checkpoint._flatten(tree, [])


def state_digest(state) -> str:
    return digest(*[t for t in leaves(state) if isinstance(t, torch.Tensor)])


def device_window(fn, kernel, n_steps, top=8):
    """fn() under torch.profiler: (device busy ms, the window's ms from the
    first device activity to the last, launches of the kernel whose name
    contains `kernel`).  Busy is the union of the device intervals.  Prints
    the `top` kernels by device time per step of the n_steps."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA and e.time_range.end > e.time_range.start)
    hits = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA and kernel in e.name)
    if not spans:
        return None, None, hits
    rows = sorted(((e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                  reverse=True)
    total = sum(r[0] for r in rows)
    for us, count, key in rows[:top]:
        print(f"  {100 * us / total:5.1f}%  {us / n_steps / 1e3:.5f} ms/step  "
              f"{count / n_steps:g}/step  {key[:90]}", flush=True)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for a, b in spans[1:]:
        if a > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    busy += cur_e - cur_s
    return busy / 1e3, (spans[-1][1] - spans[0][0]) / 1e3, hits


def counted_window(fn, kernel, n_steps, tries=3, top=8):
    """device_window of fn(), which should launch the kernel whose name
    contains `kernel` n_steps times, with the launch counts set to 0 just
    before and read just after.  The profiler's buffer may drop events
    (kernel_device_ms): a window in which it saw fewer launches is taken
    again, up to `tries` windows.  Returns (busy, window, hits, launches) of
    the last window."""
    for attempt in range(tries):
        reset_launches()
        busy, window, hits = device_window(fn, kernel, n_steps, top)
        launches = read_launches()
        if hits >= n_steps:
            break
        print(f"  the profiler saw {hits} of {n_steps} launches of {kernel} (window "
              f"{attempt + 1} of {tries})", flush=True)
    return busy, window, hits, launches


def rollout_path(dev, card, rng, B=MAIN_B, n_steps=256):
    """The main path as the bench runs it: EnvEngine.capture_rollout of the
    random policy at B lanes, BS3 x 1 / refine 8, K3's uniforms from `rng`,
    no trajectory, one captured CUDA graph.  First the captured rollout
    against the eager loops from one generator state over
    ROLLOUT_CHECK_STEPS steps with a trajectory: the same steps unrolled
    (`EnvEngine.rollout`) and the loop of `step`; equal SHA-256 digests of
    obs, reward, done and the final state, or the run fails.  Then
    env-steps/s captured and eager over n_steps, and one captured rollout
    under the profiler with the counts set to 0 just before: the device's
    idle share, and K3's launches that the profiler saw on the device,
    which must equal n_steps and the count the graph's replay added
    (utils/graphs.py).  The launches returned are the profiler's."""
    from space_gym_torch import get_config
    from space_gym_torch.engine import EnvEngine

    eng = EnvEngine(get_config(MAIN_ENV), tableau="bs3", substeps=1, refine_iters=8, device=dev,
                    in_kernel_rng=rng)
    g = eng.generator(11)
    policy = eng.random_policy()
    state, obs = eng.init(B, g)
    for _ in range(WARMUP_STEPS):
        state, ts = eng.step(state, policy(g, obs), g)
        obs = ts.obs
    g0 = g.get_state()
    T = ROLLOUT_CHECK_STEPS
    digests = {}
    for how in ("captured", "unrolled", "step loop"):
        g.set_state(g0)
        if how == "step loop":
            s, o, obs_l, rew_l, done_l = state, obs, [], [], []
            for _ in range(T):
                obs_l.append(o)
                s, ts = eng.step(s, policy(g, o), g)
                o = ts.obs
                rew_l.append(ts.reward)
                done_l.append(ts.done)
            traj_obs, rew, done = torch.stack(obs_l), torch.stack(rew_l), torch.stack(done_l)
        else:
            s, o, traj = (eng.capture_rollout(policy, T, g)(state, obs) if how == "captured"
                          else eng.rollout(state, obs, policy, T, g))
            traj_obs, rew, done = traj.obs, traj.reward, traj.done
        torch.cuda.synchronize()
        digests[how] = (digest(traj_obs), digest(rew), digest(done), state_digest(s),
                        digest(o), digest(g.get_state()))
    print(f"rollout {MAIN_ENV} B={B} bs3x1 r8 uniforms by {RNG_NAMES[rng]}, {T} steps from one "
          f"generator state, SHA-256 of obs / reward / done / final state / final obs / "
          f"generator after: " + "; ".join(f"{k} {' '.join(v)}" for k, v in digests.items()),
          flush=True)
    if len(set(digests.values())) != 1:
        fail(f"the captured rollout ({RNG_NAMES[rng]}) differs from the eager loop")

    # throughput, captured and eager, no trajectory (the bench's run)
    captured = eng.capture_rollout(policy, n_steps, g, trajectory=False)

    def run(graph):
        nonlocal state, obs
        state, obs, traj = (captured(state, obs) if graph else
                            eng.rollout(state, obs, policy, n_steps, g, trajectory=False))
        return traj

    w0 = time.perf_counter()
    run(True)                                      # captures the graph
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - w0
    ms = {}
    for graph in (True, False, False, True):       # in turns
        ms.setdefault("captured" if graph else "eager", []).append(
            cuda_ms(lambda: run(graph), iters=1, warmup=0))
    print(f"profile of a captured rollout, {MAIN_ENV} B={B} uniforms by {RNG_NAMES[rng]}, "
          f"{n_steps} steps (profiler on), device time by kernel:", flush=True)
    name = K3_NAMES[rng]
    busy, window, hits, launches = counted_window(lambda: run(True), "full_step_kernel", n_steps)
    if hits != n_steps or launches[name] != hits or sum(launches.values()) != hits:
        fail(f"captured rollout of {n_steps} steps: the profiler saw {hits} {name} launches on "
             f"the device, the counts say {launches}")
    launches[name] = hits
    traj = run(True)
    if not np.isfinite(float(traj.reward_sum)) or int(traj.done_sum) == 0:
        fail(f"captured rollout: reward sum {float(traj.reward_sum)}, dones {int(traj.done_sum)}")
    sps = {k: B * n_steps / (min(v) / 1e3) for k, v in ms.items()}
    idle = None if busy is None else 1 - busy / window
    print(f"rollout {MAIN_ENV} B={B} bs3x1 r8 uniforms by {RNG_NAMES[rng]}, {n_steps} steps, "
          f"no trajectory, on {card}: captured {sps['captured']:.6g} env-steps/s "
          f"({min(ms['captured']) / n_steps:.5f} ms/step; runs "
          + ", ".join(f"{t:.3f}" for t in ms["captured"])
          + f" ms), eager {sps['eager']:.6g} ({min(ms['eager']) / n_steps:.5f} ms/step; runs "
          + ", ".join(f"{t:.3f}" for t in ms["eager"])
          + f" ms); first call {capture_s:.3f} s (warm-up and capture); profiled captured run: "
          "device busy "
          + (f"{busy:.3f} of {window:.3f} ms, idle share {100 * idle:.1f}%, "
             if busy is not None else "not recorded, ")
          + f"{hits} {name} launches seen on the device, counts {launches}", flush=True)
    return dict(rng=rng, launches=launches, sps=sps, ms=ms, idle=idle, digests=digests)


# ------------------------------------------- the learner kernels K4, K5, K6 --
SAC_LANES, SAC_ROLLOUT, SAC_K, SAC_B, SAC_H, SAC_ROWS = 2048, 8, 32, 8192, 256, 2048
SAC_HYPER = dict(gamma=0.99, tau=0.005, lr=3e-4, target_entropy=-2.0)
TD3_HYPER = dict(gamma=0.99, tau=0.005, lr=3e-4, smooth_std=0.2, smooth_clip=0.5)
SAC_STATE = ("w", "vec", "mw", "mvec", "vw", "vvec")
# Kernel vs plain version, float32 (the tolerances of tests/test_torch_fused_sac.py
# and tests/test_torch_fused_td3.py: float32 sums in another order, through
# Adam's division by sqrt(v)): (rtol, atol) by kind of tensor.
TOL_SAC = {"w": (2e-4, 2e-5), "vec": (2e-4, 2e-5), "mw": (2e-3, 2e-5), "mvec": (2e-3, 2e-5),
           "vw": (2e-3, 2e-5), "vvec": (2e-3, 2e-5), "closs": (1e-4, 1e-5),
           "aloss": (1e-3, 1e-5)}
# With bfloat16-rounded products the kernel rounds dq and the rank-one
# products where its plain version does not, and bf16 can flip the sign of a
# near-zero gradient: an element may move by 2.5 lr per update, while 99% of
# each tensor agree to 1e-4 and the losses to rtol 1e-3.
BF16_STEP, BF16_MOST, BF16_LOSS_RTOL = 2.5 * SAC_HYPER["lr"], 1e-4, 1e-3


def learner_data(dev, rng, K, B, lanes, rows, obs_dim):
    """A replay ring of `rows` x `lanes` from `rng`, K * B // lanes row indices
    with a repeated row, and the same minibatches gathered."""
    from space_gym_torch.models.replay import Transition, pack_slab, replay_cols, unpack_flat

    def f32(a):
        return torch.as_tensor(a.astype(np.float32), device=dev)

    slab = Transition(obs=f32(rng.standard_normal((rows, lanes, obs_dim))),
                      action=f32(rng.uniform(-1, 1, (rows, lanes, 2))),
                      reward=f32(rng.standard_normal((rows, lanes))),
                      next_obs=f32(rng.standard_normal((rows, lanes, obs_dim))),
                      discount=f32(rng.random((rows, lanes)) > 0.1))
    ring = pack_slab(slab, obs_dim, 2)
    idx = rng.integers(0, rows, K * (B // lanes))
    idx[-1] = idx[0]
    row_idx = torch.as_tensor(idx, device=dev)
    w = replay_cols(obs_dim, 2)[-1]
    batches = unpack_flat(ring[row_idx].transpose(1, 2).reshape(K, B, w), obs_dim, 2)
    return ring, row_idx, batches


def sac_inputs(dev, h, K, B, lanes, rows=64, seed=11, obs_dim=13):
    """A SAC learner state that has taken two updates (moments not zero), a
    replay ring from a seed, row indices, the same minibatches gathered, the
    normals, and the hyperparameters."""
    from space_gym_torch.models import fused_sac, networks
    from space_gym_torch.models.replay import Transition

    ns = fused_sac.build(h)
    rng = np.random.default_rng(seed)
    g = torch.Generator().manual_seed(seed)
    actor = networks.TanhGaussianActor(obs_dim, 2, (h, h), generator=g)
    critic = networks.DoubleCritic(obs_dim, 2, (h, h), generator=g)
    target = networks.DoubleCritic(obs_dim, 2, (h, h), generator=g)
    packed = ns.pack_params(actor, critic, target, torch.tensor(np.log(0.1)))
    packed = fused_sac.PackedParams(*[x.to(dev) for x in packed])
    ring, row_idx, batches = learner_data(dev, rng, K, B, lanes, rows, obs_dim)
    noises = torch.as_tensor(rng.standard_normal((K, B, 2, 2)).astype(np.float32), device=dev)
    hyper = dict(SAC_HYPER, obs_dim=obs_dim)
    warm = Transition(*[x[:2] for x in batches])
    packed, adam, _, _ = ns.update_k_reference(packed, ns.adam_init(packed), warm, noises[:2],
                                               **hyper)
    return ns, packed, adam, ring, row_idx, batches, noises, hyper


def td3_inputs(dev, h, K, B, lanes, delay=2, warm=3, rows=64, seed=12, obs_dim=13):
    """The same for TD3: the learner has taken `warm` updates, so the kernel
    starts from that count; targets drawn apart from the online networks."""
    from space_gym_torch.models import fused_td3, networks
    from space_gym_torch.models.replay import Transition

    ns = fused_td3.build(h)
    rng = np.random.default_rng(seed)
    g = torch.Generator().manual_seed(seed)
    actors = [networks.DeterministicActor(obs_dim, 2, (h, h), generator=g) for _ in range(2)]
    critics = [networks.DoubleCritic(obs_dim, 2, (h, h), generator=g) for _ in range(2)]
    packed = fused_td3.PackedParams(*[x.to(dev) for x in ns.pack_params(*actors, *critics)])
    ring, row_idx, batches = learner_data(dev, rng, K, B, lanes, rows, obs_dim)
    noises = torch.as_tensor(rng.standard_normal((K, B, 2)).astype(np.float32), device=dev)
    hyper = dict(TD3_HYPER, obs_dim=obs_dim, policy_delay=delay)
    reps = -(-warm // K)
    first = Transition(*[x.repeat(reps, *[1] * (x.dim() - 1))[:warm] for x in batches])
    packed, adam, _, _ = ns.update_k_reference(packed, ns.adam_init(packed), first,
                                               noises.repeat(reps, 1, 1)[:warm], **hyper)
    return ns, packed, adam, ring, row_idx, batches, noises, hyper


def sac_state_equal(a, b):
    """Equal bits and equal counts of two (FusedState, closs, aloss) results."""
    return (all(torch.equal(x, y) for x, y in zip(a[0][:6], b[0][:6])) and a[0][6:] == b[0][6:]
            and torch.equal(a[1], b[1]) and torch.equal(a[2], b[2]))


def check_learner_kernel(dev, name, inputs, K, B, lanes, modes, block=2048, **kw):
    """A learner kernel against its namespace's `update_k_reference` on the
    card, from gathered minibatches and from the ring; the same call twice;
    K updates in one launch against K launches of one update.  `inputs` is
    what sac_inputs or td3_inputs returned, `block` the JAX kernels' batch
    tile (it must divide the batch and the lanes, as there), `kw` the
    kernel's own options.
    Returns ({mm_bf16: max abs error over w and vec}, the results by
    (mm_bf16, data mode))."""
    from space_gym_torch.models.learner_kernels import KERNEL_TILE

    ns, packed, adam, ring, row_idx, batches, noises, hyper = inputs
    h = packed.a_w2.shape[0]
    # the ring's tiles are those of the gathered batch where the tile divides
    # the lanes; else each ring row ends in a partial tile of its own, and the
    # sums run in another order
    same_tiles = lanes % KERNEL_TILE[h] == 0
    tag = f"{name} H={h} K={K} B={B}" + (
        f" policy_delay={hyper['policy_delay']} from count {adam.count}"
        if "policy_delay" in hyper else "")
    errs, results = {}, {}
    for bf in modes:
        want_p, want_ad, want_cl, want_al = ns.update_k_reference(
            packed, adam, batches, noises, mm_bf16=bf, **hyper)
        want = ns.fused_init(want_p, want_ad)
        for mode in ("batches", "ring"):
            runs = []
            for _ in range(2):
                f0 = ns.fused_init(packed, adam)
                if mode == "ring":
                    out = ns.fused_update_k_wmat(f0, ring, row_idx, noises, block=block,
                                                 mm_bf16=bf, **kw, **hyper)
                else:
                    out = ns.fused_update_k_wmat_batches(f0, batches, noises, block=block,
                                                         mm_bf16=bf, **kw, **hyper)
                torch.cuda.synchronize()
                runs.append((out[0], out[1].clone(), out[2].clone()))
            if not sac_state_equal(runs[0], runs[1]):
                fail(f"{tag} {mode} mm_bf16={bf}: two calls on the same inputs differ")
            results[(bf, mode)] = runs[0]
            got, cl, al = runs[0]
            if got[6:] != want[6:]:
                fail(f"{tag}: counts {got[6:]} after {K} updates, the plain version's {want[6:]}")
            worst = 0.0
            for f in SAC_STATE:
                g_, w_ = getattr(got, f), getattr(want, f)
                d = (g_ - w_).abs()
                if not torch.isfinite(g_).all():
                    fail(f"{tag} {mode} mm_bf16={bf}: {f} not finite")
                if bf:
                    ok = (d.max().item() <= BF16_STEP * K
                          and (d <= BF16_MOST).float().mean().item() > 0.99)
                else:
                    rtol, atol = TOL_SAC[f]
                    ok = bool((d <= atol + rtol * w_.abs()).all())
                if not ok:
                    fail(f"{tag} {mode} mm_bf16={bf}: {f} differs from the plain version by "
                         f"{d.max().item():.3g}")
                if f in ("w", "vec"):
                    worst = max(worst, d.max().item())
            for lname, g_, w_ in (("closs", cl, want_cl), ("aloss", al, want_al)):
                rtol, atol = (BF16_LOSS_RTOL, 1e-5) if bf else TOL_SAC[lname]
                if not bool(((g_ - w_).abs() <= atol + rtol * w_.abs()).all()):
                    fail(f"{tag} {mode} mm_bf16={bf}: {lname} {g_.tolist()} vs {w_.tolist()}")
            errs[bf] = max(errs.get(bf, 0.0), worst)
            print(f"{tag} {mode} mm_bf16={bf}: max|err| of w, vec against the "
                  f"plain version {worst:.3g}; critic loss {cl[-1].item():.6g} (plain "
                  f"{want_cl[-1].item():.6g}), actor loss {al[-1].item():.6g} (plain "
                  f"{want_al[-1].item():.6g}); counts {got[6:]}; second call bit-identical",
                  flush=True)
        if same_tiles and not sac_state_equal(results[(bf, "batches")], results[(bf, "ring")]):
            fail(f"{tag} mm_bf16={bf}: the ring and the gathered minibatches give other bits")
        # K updates in one launch against K launches of one update: between
        # launches every write is visible to every block, so equal bits show
        # that the grid barriers inside a launch order memory as well
        rpb = B // lanes
        f0 = ns.fused_init(packed, adam)
        cls, als = [], []
        for k in range(K):
            f0, cl, al = ns.fused_update_k_wmat(
                f0, ring, row_idx[k * rpb:(k + 1) * rpb], noises[k:k + 1], block=block,
                mm_bf16=bf, **kw, **hyper)
            cls.append(cl.clone())
            als.append(al.clone())
        torch.cuda.synchronize()
        if not sac_state_equal((f0, torch.cat(cls), torch.cat(als)), results[(bf, "ring")]):
            fail(f"{tag} mm_bf16={bf}: {K} updates in one launch and {K} launches of one "
                 f"update give other bits or counts")
    print(f"{tag}: {K} updates in one launch equal {K} launches of one update"
          + (" and the ring equals the gathered minibatches" if same_tiles else "")
          + ", bit for bit", flush=True)
    return errs, results


def check_sac_kernel(dev, fold, h=SAC_H, K=4, B=SAC_B, lanes=SAC_LANES, modes=(False, True)):
    """K4 (fold False) or K5 (fold True) against the plain version."""
    return check_learner_kernel(dev, "K5" if fold else "K4", sac_inputs(dev, h, K, B, lanes),
                                K, B, lanes, modes, block=min(2048, lanes), fold=fold)


# A batch that no tile divides: gathered, B = 8192 - 36 ends in a tile of 28
# samples at H=256; as a ring, rows of 2039 lanes (odd, so no row is 16-byte
# aligned) end in a tile of 55.  The JAX kernels take it with a batch tile
# (`block`) of 2039, which divides both.
PARTIAL_B, PARTIAL_LANES = SAC_B - 36, (SAC_B - 36) // 4

# The extra cases of K4 and K5 beyond check_sac_kernel's defaults: (key, h, K,
# B, lanes).  H=512 with B=8192 has 256 tiles of 32 samples, more than the
# card's resident blocks, so K5 folds further tiles in each block.
SAC_EXTRA = (((512, 4096), 512, 2, 4096, SAC_LANES), ((512, 8192), 512, 2, SAC_B, SAC_LANES),
             (("partial",), SAC_H, 2, PARTIAL_B, PARTIAL_LANES))


def check_sac_cases(dev, fold):
    """K4 or K5 against the plain version at H=256 (K=4, B=8192), then on
    SAC_EXTRA, both modes.  Returns ({mm_bf16: max abs error}, the results
    keyed by case and (mm_bf16, data mode))."""
    errs, results = check_sac_kernel(dev, fold=fold)
    for key, h, K, B, lanes in SAC_EXTRA:
        e, r = check_sac_kernel(dev, fold=fold, h=h, K=K, B=B, lanes=lanes)
        for bf, v in e.items():
            errs[bf] = max(errs[bf], v)
        results.update({key + k: v for k, v in r.items()})
    return errs, results


def check_k4(dev):
    """K4 against the plain version (check_sac_cases)."""
    return check_sac_cases(dev, fold=False)


def check_k5(dev, k4_results):
    """K5 against the plain version, then against K4: equal bits."""
    errs, results = check_sac_cases(dev, fold=True)
    for key, res in results.items():
        if not sac_state_equal(res, k4_results[key]):
            fail(f"K5 and K4 differ in bits at {key}")
    print(f"K5 against K4 on {len(results)} cases (H=256; H=512 at B=4096 and at B=8192 with "
          f"more tiles than blocks; partial tiles; both data modes, float32 and bf16-rounded): "
          f"all outputs bit-identical", flush=True)
    return errs


def check_k6(dev):
    """K6 against the plain version at H=256 with policy_delay 2 and 3, each
    from an odd update count, at H=512, and on partial tiles, each in both
    modes.  Returns {mm_bf16: max abs error}."""
    errs = {}
    for h, K, B, lanes, delay, warm in ((SAC_H, 4, SAC_B, SAC_LANES, 2, 3),
                                        (SAC_H, 4, SAC_B, SAC_LANES, 3, 1),
                                        (512, 3, 4096, SAC_LANES, 2, 1),
                                        (SAC_H, 3, PARTIAL_B, PARTIAL_LANES, 2, 1)):
        inputs = td3_inputs(dev, h, K, B, lanes, delay=delay, warm=warm)
        e, _ = check_learner_kernel(dev, "K6", inputs, K, B, lanes, (False, True),
                                    block=min(2048, lanes))
        for bf, v in e.items():
            errs[bf] = max(errs.get(bf, 0.0), v)
    return errs


def work_bound(work):
    byts, ops = work
    return {"bytes": byts / HBM_BYTES_PER_S * 1e3,
            "operations": (ops["bf16"] / BF16_OPS_PER_S + ops["f32"] / F32_OPS_PER_S) * 1e3}


def restore_into(live, saved):
    """Copy the saved leaves' values into the live state's tensors (so that
    the tensors a captured rollout reads stay where they are); returns the
    live state with the saved Python numbers."""
    from space_gym_torch.utils import checkpoint

    mixed = []
    for a, b in zip(leaves(live), saved):
        if isinstance(a, torch.Tensor):
            a.copy_(b)
            mixed.append(a)
        else:
            mixed.append(b)
    return checkpoint._unflatten(live, iter(mixed))


def captured_vs_eager(tr, st, g, label, iters=3):
    """One train_iter on the captured rollout and one on the eager loop (the
    trainer's PolicyRollout with graph=False), from one state and generator
    state: every leaf of the state after must be equal, bit for bit.  Then
    ms per train_iter of each, `iters` of one and `iters` of the other, by
    CUDA events.  Returns (state, measurements)."""
    saved = [t.clone() if isinstance(t, torch.Tensor) else t for t in leaves(st)]
    g0 = g.get_state()
    out = {}
    for how in ("captured", "eager"):
        st = restore_into(st, saved)
        g.set_state(g0)
        tr.collect.graph = how == "captured"
        st, _ = tr.train_iter(st, g)
        torch.cuda.synchronize()
        out[how] = [t.clone() if isinstance(t, torch.Tensor) else t for t in leaves(st)]
    same = all(torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
               for a, b in zip(out["captured"], out["eager"]))
    dg = {k: digest(*[t for t in v if isinstance(t, torch.Tensor)]) for k, v in out.items()}
    print(f"  {label}: state after one train_iter from one state and generator state, "
          f"SHA-256 captured {dg['captured']}, eager {dg['eager']}", flush=True)
    if not same:
        fail(f"{label}: one train_iter on the captured rollout differs from the eager loop")
    ms = {"captured": [], "eager": []}
    for how in ("captured", "eager", "eager", "captured"):
        tr.collect.graph = how == "captured"
        for _ in range(iters):
            def one():
                nonlocal st
                st, _ = tr.train_iter(st, g)
            ms[how].append(cuda_ms(one, iters=1, warmup=0))
    med = {k: float(np.median(v)) for k, v in ms.items()}
    print(f"  {label}: train_iter median {med['captured']:.3f} ms on the captured rollout "
          f"({', '.join(f'{t:.3f}' for t in ms['captured'])}), {med['eager']:.3f} ms on the "
          f"eager loop ({', '.join(f'{t:.3f}' for t in ms['eager'])}), in turns", flush=True)
    return st, med


def train_path(dev, card, algo, fold=False, n_iters=9, kernel_ms=None):
    """The training path at full width: SACTrainer (algo "sac": fused updates
    through K4, or K5 with `fold`) or TD3Trainer (algo "td3": K6) over the
    engine's default tier.  Returns its measurements."""
    kernel_ms = kernel_ms or kernel_device_ms
    from space_gym_torch import get_config
    from space_gym_torch.engine import EnvEngine
    from space_gym_torch.models import SACConfig, SACTrainer, TD3Config, TD3Trainer, fused_td3
    from space_gym_torch.models.replay import unpack_flat

    shape = dict(lanes=SAC_LANES, rollout_len=SAC_ROLLOUT, updates_per_iter=SAC_K,
                 batch_size=SAC_B, replay_rows=SAC_ROWS, hidden=(SAC_H, SAC_H),
                 fused_updates=True, fused_block=2048)
    eng = EnvEngine(get_config(MAIN_ENV), device=dev)
    if algo == "sac":
        name, label = ("sac_update_fold" if fold else "sac_update"), f"SAC fused_fold={fold}"
        cfg = SACConfig(fused_fold=fold, **shape)
        tr = SACTrainer(eng, cfg)
        ns, kw, noise_shape = tr._fs, dict(fold=fold), (SAC_K, SAC_B, 2, 2)
        hyper = dict(SAC_HYPER, obs_dim=tr.obs_dim)
    else:
        name, label = "td3_update", "TD3"
        cfg = TD3Config(**shape)
        tr = TD3Trainer(eng, cfg)
        ns, kw, noise_shape = tr._ft, {}, (SAC_K, SAC_B, 2)
        hyper = dict(TD3_HYPER, obs_dim=tr.obs_dim, policy_delay=cfg.policy_delay)
    if torch.device(dev).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    st = tr.init(0)
    g = tr.generator(1)
    if tuple(st.replay.data.shape) != (SAC_ROWS, 40, SAC_LANES):
        fail(f"replay ring of shape {tuple(st.replay.data.shape)}")
    dead = -(-cfg.warmup_rows // cfg.rollout_len) - 1   # iterations before the gate opens
    live = n_iters - dead

    spans = {"rollout": [], "update": []}

    def timed(fn, bucket):
        def wrapper(*a, **k):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            out = fn(*a, **k)
            e.record()
            bucket.append((s, e))
            return out
        return wrapper

    tr._rollout = timed(tr._rollout, spans["rollout"])
    tr._update_fused = timed(tr._update_fused, spans["update"])

    w0, vec0 = st.fused.w.clone(), st.fused.vec.clone()
    reset_launches()
    iter_spans, metrics, moved_at = [], [], None
    for i in range(n_iters):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        st, m = tr.train_iter(st, g)
        e.record()
        iter_spans.append((s, e))
        metrics.append(m)
        changed = not torch.equal(st.fused.w, w0) or not torch.equal(st.fused.vec, vec0)
        if changed and moved_at is None:
            moved_at = i
    torch.cuda.synchronize()
    launches = read_launches()
    if moved_at != dead:
        fail(f"the learner state first changed in train_iter {moved_at}, the warm-up gate opens "
             f"in {dead}")
    # the first train_iter captures the rollout: its warm-up launches K3
    # rollout_len times eagerly, then every train_iter replays the graph
    want = {name: live, "full_step": (n_iters + 1) * cfg.rollout_len}
    if any(v != want.get(k, 0) for k, v in launches.items()):
        fail(f"train path {label}: launches {launches}, expected {want}")
    actor_moved = max((st.actor_params[k] - ns.unpack_actor(w0, st.fused.vec, tr.obs_dim)[k])
                      .abs().max().item() for k in ("mlp.layers.0.kernel", "mlp.layers.1.kernel"))
    last = {k: float(v) for k, v in metrics[-1].items()}
    if not all(np.isfinite(v) for v in last.values()) or actor_moved <= 0:
        fail(f"train path {label}: metrics {last}, actor moved by {actor_moved}")
    for m in metrics[:dead]:
        if not np.isnan(float(m["critic_loss"])):
            fail("a loss was reported before the warm-up gate opened")
    if not all(torch.isfinite(t).all().item() for t in st.fused[:6]):
        fail("fused state not finite")
    counts = (live * SAC_K,) if algo == "sac" else (
        live * SAC_K, fused_td3.applied_steps(0, live * SAC_K, cfg.policy_delay))
    if st.fused[6:] != counts or (st.replay.cursor, st.replay.filled) != (
            n_iters * SAC_ROLLOUT, min(n_iters * SAC_ROLLOUT, SAC_ROWS)):
        fail(f"counts {st.fused[6:]}, cursor {st.replay.cursor}, filled {st.replay.filled}")
    peak_mb = torch.cuda.max_memory_allocated() / 2**20

    ms = lambda pairs: [s.elapsed_time(e) for s, e in pairs]
    # steady state: the live iterations after the first (it builds and loads the library)
    it_ms = ms(iter_spans)[dead + 1:]
    roll_ms = ms(spans["rollout"])[dead + 1:]
    upd_ms = ms(spans["update"])[1:]
    it_mean, roll_mean, upd_mean = (sum(x) / len(x) for x in (it_ms, roll_ms, upd_ms))
    sps = SAC_LANES * SAC_ROLLOUT / (it_mean / 1e3)

    # device time per launch over three more live train_iters under the profiler
    def one_iter():
        nonlocal st
        st, _ = tr.train_iter(st, g)

    dev_ms = kernel_ms(one_iter, name.split("_")[0] + "_update_kernel", iters=3, warmup=0)
    st, vs_eager = captured_vs_eager(tr, st, g, f"train path {label}")

    # the plain version and the library yardstick at the launch's shapes
    row_idx = torch.randint(0, st.replay.filled, (SAC_K * SAC_B // SAC_LANES,), generator=g,
                            device=dev)
    noises = torch.randn(noise_shape, generator=g, device=dev)
    batches = unpack_flat(st.replay.data[row_idx].transpose(1, 2).reshape(SAC_K, SAC_B, -1),
                          tr.obs_dim, 2)
    packed, adam = ns.fused_unpack(st.fused)
    plain_ms = cuda_ms(lambda: ns.update_k_reference(packed, adam, batches, noises, mm_bf16=True,
                                                     **hyper), iters=1, warmup=1)
    a = torch.randn((SAC_B, SAC_H), device=dev)
    b = torch.randn((SAC_H, SAC_H), device=dev)
    # the same product on bf16 operands into float32 too, the mode of the
    # kernels' tensor-core products; each the median of 5 windows of 200 calls
    a16, b16 = a.bfloat16(), b.bfloat16()
    windows = {
        "float32": sorted(cuda_ms(lambda: torch.matmul(a, b), iters=200, warmup=20)
                          for _ in range(5)),
        "bf16": sorted(cuda_ms(lambda: torch.mm(a16, b16, out_dtype=torch.float32), iters=200,
                               warmup=20) for _ in range(5))}
    matmul_ms, matmul16_ms = windows["float32"][2], windows["bf16"][2]
    print(f"  library yardstick ({SAC_B}, {SAC_H}) x ({SAC_H}, {SAC_H}), ms per product over 5 "
          f"windows of 200: " + "; ".join(f"{k} median {v[2]:.5f}, spread {v[0]:.5f}-{v[-1]:.5f}"
                                          for k, v in windows.items()), flush=True)
    # both modes back to back on a copy of the state, by CUDA events
    call_ms = {}
    for bf in (True, False):
        f0 = type(st.fused)(*[t.clone() for t in st.fused[:6]], *st.fused[6:])
        call_ms[bf] = cuda_ms(lambda: ns.fused_update_k_wmat(
            f0, st.replay.data, row_idx, noises, block=2048, mm_bf16=bf, **kw, **hyper),
            iters=3, warmup=1)
    W = st.replay.data.shape[1]
    if algo == "sac":
        products = 16 * SAC_K
        work = lambda bf: sac_work(SAC_H, SAC_K, SAC_B, W, tr.obs_dim, bf, SAC_LANES)
    else:
        # every launch of this path starts from a count that is a multiple of
        # K, so it has K / policy_delay delayed updates
        n_act = fused_td3.applied_steps(0, SAC_K, cfg.policy_delay)
        products = td3_products(SAC_K, n_act)
        work = lambda bf: td3_work(SAC_H, SAC_K, SAC_B, W, tr.obs_dim, bf, n_act, SAC_LANES)
    bnd, bnd_f32 = work_bound(work(True)), work_bound(work(False))
    byts, ops = work(False)
    print(f"train path {label} {MAIN_ENV} lanes={SAC_LANES} rollout={SAC_ROLLOUT} K={SAC_K} "
          f"B={SAC_B} H={SAC_H} ring {tuple(st.replay.data.shape)} on {card}: "
          f"{n_iters} train_iters, {dead} before the warm-up gate, launches {launches}; "
          f"steady train_iter {it_mean:.3f} ms = rollout {roll_mean:.3f} ms + K-update "
          f"{upd_mean:.3f} ms + {it_mean - roll_mean - upd_mean:.3f} ms (replay insert, metrics); "
          f"{sps:.6g} env-steps/s; {name} {dev_ms:.3f} ms/launch on the device (profiler), "
          f"{call_ms[True]:.3f} ms per call back to back with bf16-rounded products, "
          f"{call_ms[False]:.3f} ms in float32; plain version {plain_ms:.1f} ms; "
          f"torch.matmul(({SAC_B}, {SAC_H}) x ({SAC_H}, {SAC_H})) {matmul_ms:.5f} ms x "
          f"{products} products = {matmul_ms * products:.3f} ms in float32, "
          f"{matmul16_ms:.5f} ms x {products} = {matmul16_ms * products:.3f} ms on bf16 "
          f"operands; peak device memory "
          f"{peak_mb:.0f} MiB; counts {st.fused[6:]}; last metrics {last}", flush=True)
    print(f"  {name} bound: {ops['f32'] / 1e9:.1f} G operations and {byts / 1e6:.1f} MB "
          f"per launch; bytes {bnd['bytes']:.4f} ms at {HBM_BYTES_PER_S / 1e12} TB/s; operations "
          f"{bnd_f32['operations']:.3f} ms all at {F32_OPS_PER_S / 1e12} TFLOP/s float32 (what "
          f"the kernel's CUDA-core products could reach), {bnd['operations']:.3f} ms with the "
          f"bf16-rounded products at {BF16_OPS_PER_S / 1e12} TFLOP/s (what the card could reach "
          f"for the main path's mm_bf16=True)", flush=True)
    return dict(launches=launches, ms=dev_ms, plain_ms=plain_ms, bound=bnd, bound_f32=bnd_f32,
                library_ms=matmul_ms * products, library16_ms=matmul16_ms * products,
                it_ms=it_mean, roll_ms=roll_mean,
                upd_ms=upd_mean, sps=sps, call_ms=call_ms, peak_mb=peak_mb, vs_eager=vs_eager)


def onpolicy_path(dev, card, algo, n_iters=3):
    """PPO (GoalContinuous2P-v0) or DQN (GoalDiscrete3-v0) at the JAX
    trainers' default configurations, over the captured rollout: the launch
    counts (set to 0 just before), finite metrics, parameters that moved, ms
    per train_iter split into rollout and update, and one train_iter against
    the eager loop bit for bit."""
    from space_gym_torch import get_config
    from space_gym_torch.engine import EnvEngine
    from space_gym_torch.models.dqn import DQNConfig, DQNTrainer
    from space_gym_torch.models.ppo import PPOConfig, PPOTrainer

    if algo == "ppo":
        tr = PPOTrainer(EnvEngine(get_config(MAIN_ENV), device=dev), PPOConfig())
        key = "torso.layers.0.kernel"
    else:
        tr = DQNTrainer(EnvEngine(get_config("GoalDiscrete3-v0"), device=dev), DQNConfig())
        key = "layers.0.kernel"
    c = tr.cfg
    torch.cuda.reset_peak_memory_stats()
    st = tr.init(0)
    g = tr.generator(1)
    p0 = st.params[key].clone()
    spans = []
    inner = tr._rollout

    def timed_rollout(*a, **k):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        out = inner(*a, **k)
        e.record()
        spans.append((s, e))
        return out

    tr._rollout = timed_rollout
    reset_launches()
    its, metrics = [], None
    try:
        for _ in range(n_iters):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            st, metrics = tr.train_iter(st, g)
            e.record()
            its.append((s, e))
        torch.cuda.synchronize()
    finally:
        del tr._rollout
    launches = read_launches()
    want = {"full_step": (n_iters + 1) * c.rollout_len}  # the first captures (eager warm-up)
    if any(v != want.get(k, 0) for k, v in launches.items()):
        fail(f"train path {algo}: launches {launches}, expected {want}")
    last = {k: float(v) for k, v in metrics.items()}
    if not all(np.isfinite(v) for v in last.values()) or torch.equal(p0, st.params[key]):
        fail(f"train path {algo}: metrics {last}, parameters moved "
             f"{not torch.equal(p0, st.params[key])}")
    it_ms = [a.elapsed_time(b) for a, b in its][1:]
    roll_ms = [a.elapsed_time(b) for a, b in spans][1:]
    it_mean, roll_mean = sum(it_ms) / len(it_ms), sum(roll_ms) / len(roll_ms)
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    shape = (f"lanes={c.lanes} rollout={c.rollout_len} epochs={c.epochs} "
             f"minibatches={c.minibatches} hidden={c.hidden}" if algo == "ppo" else
             f"lanes={c.lanes} rollout={c.rollout_len} K={c.updates_per_iter} "
             f"B={c.batch_size} hidden={c.hidden} ring {tuple(st.replay.data.shape)}")
    print(f"train path {algo.upper()} {tr.engine.config.env_id} {shape} on {card}: "
          f"{n_iters} train_iters, launches {launches}; steady train_iter {it_mean:.3f} ms = "
          f"rollout {roll_mean:.3f} ms + update {it_mean - roll_mean:.3f} ms; "
          f"{c.lanes * c.rollout_len / (it_mean / 1e3):.6g} env-steps/s; peak device memory "
          f"{peak_mb:.0f} MiB; last metrics {last}", flush=True)
    st, vs_eager = captured_vs_eager(tr, st, g, f"train path {algo.upper()}", iters=1)
    return dict(launches=launches, it_ms=it_mean, roll_ms=roll_mean, vs_eager=vs_eager)


def bench_run(card):
    """`python -m space_gym_torch.bench` as a user runs it; returns its line."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "space_gym_torch.bench"], cwd=HERE,
                         capture_output=True, text=True, timeout=600)
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
    if out.returncode != 0 or len(lines) != 1:
        fail(f"python -m space_gym_torch.bench: rc {out.returncode}, stdout {out.stdout[-2000:]}"
             f" stderr {out.stderr[-2000:]}")
    line = json.loads(lines[0])
    if not line["value"] > 0 or line["device_kind"] != card:
        fail(f"bench line {line}")
    print(f"bench ({time.perf_counter() - t0:.1f} s with the process start): {lines[0]}",
          flush=True)
    return line


def sac_bits(dev, card):
    """A SHA-256 of what K4, K5 and K6 write (w, vec, the moments, the losses)
    on the inputs of check_k4's and check_k6's first cases at H=256, in both
    modes and both data modes, and their ms per launch at the training path's
    shapes by CUDA events; each without thread block clusters (C=1) and with
    the clusters the plan takes (at most learner_kernels.CLUSTER_MAX blocks), C
    printed beside each line.  Uses the learner kernels alone: run it from
    two checkouts to see which bits a change of their code moved."""
    import hashlib

    from space_gym_torch.models import learner_kernels as lk

    cmax = lk.CLUSTER_MAX
    kernels = {"K4": lk.SAC, "K5": lk.SAC_FOLD, "K6": lk.TD3}

    def planned(name, mode, bf, B, ring, n):
        """The cluster size the plan gives this launch, in clusters of at most n."""
        lanes = ring.shape[2]
        tiles = lk.n_tiles(*((lanes, B // lanes) if mode == "ring" else (B, 0)),
                           lk.KERNEL_TILE[SAC_H])
        return lk.plan(kernels[name], SAC_H, ring.shape[1], 13, tiles, bf, n)[2]

    def digest(name, out, mode, bf, c):
        h = hashlib.sha256()
        for t in (*out[0][:6], out[1], out[2]):
            h.update(t.detach().cpu().numpy().tobytes())
        print(f"bits {name} H={SAC_H} K=4 B={SAC_B} {mode} mm_bf16={bf} C={c}: sha256 "
              f"{h.hexdigest()[:16]} sum(w) {out[0].w.double().sum().item():.12g} "
              f"sum(vec) {out[0].vec.double().sum().item():.12g} sum(mw) "
              f"{out[0].mw.double().sum().item():.12g}", flush=True)

    cases = [("K4", sac_inputs(dev, SAC_H, 4, SAC_B, SAC_LANES), dict(fold=False)),
             ("K5", None, dict(fold=True)),
             ("K6", td3_inputs(dev, SAC_H, 4, SAC_B, SAC_LANES, delay=2, warm=3), {})]
    cases[1] = ("K5", cases[0][1], cases[1][2])
    for n in (1, cmax):
        for name, inputs, kw in cases:
            ns, packed, adam, ring, row_idx, batches, noises, hyper = inputs
            for bf in (False, True):
                for mode in ("batches", "ring"):
                    f0 = ns.fused_init(packed, adam)
                    if mode == "ring":
                        out = ns.fused_update_k_wmat(f0, ring, row_idx, noises, block=2048,
                                                     mm_bf16=bf, cluster_max=n, **kw, **hyper)
                    else:
                        out = ns.fused_update_k_wmat_batches(f0, batches, noises, block=2048,
                                                             mm_bf16=bf, cluster_max=n, **kw,
                                                             **hyper)
                    torch.cuda.synchronize()
                    digest(name, out, mode, bf, planned(name, mode, bf, SAC_B, ring, n))
    timed = [("K4", sac_inputs(dev, SAC_H, SAC_K, SAC_B, SAC_LANES), dict(fold=False)),
             ("K6", td3_inputs(dev, SAC_H, SAC_K, SAC_B, SAC_LANES, delay=2, warm=2), {})]
    timed.insert(1, ("K5", timed[0][1], dict(fold=True)))
    # in turns: without clusters, with; then the other way round
    for name, inputs, kw, order in ([(*c, (1, cmax)) for c in timed]
                                    + [(*c, (cmax, 1)) for c in timed[::-1]]):
        ns, packed, adam, ring, row_idx, batches, noises, hyper = inputs
        for bf in (True, False):
            for n in order:
                f0 = ns.fused_init(packed, adam)
                ms = cuda_ms(lambda: ns.fused_update_k_wmat(
                    f0, ring, row_idx, noises, block=2048, mm_bf16=bf, cluster_max=n, **kw,
                    **hyper), iters=5, warmup=2)
                print(f"time {name} H={SAC_H} K={SAC_K} B={SAC_B} ring mm_bf16={bf} "
                      f"C={planned(name, 'ring', bf, SAC_B, ring, n)} on {card}: {ms:.4f} ms per "
                      f"call by CUDA events", flush=True)


ENV_IDS = (MAIN_ENV, "GoalContinuous3P-v0", "GoalContinuous4P-v0", "KeplerRandomOrbits-v0",
           "DoNotCrashContinuous-v0")
ENV_KERNELS = ("fused_step", "env_step", "full_step", "full_step_threefry", "full_step_philox")


def env_bits(dev, card, B=CHECK_B, n_steps=3):
    """A SHA-256 of everything K1, K2, K3, K3-tf and K3-hw write over
    `n_steps` steps from phase 3's seeded state, each kernel's outputs fed
    back as its next inputs (the state rows; the same actions, fresh uniforms
    or key words each step), for every env family and both tableaux; then
    each kernel's ms per launch on the device at the main path's shapes.
    Uses only the wrappers' step_rows and the engine, so a copy of this
    script runs in an older checkout too: run it from two checkouts, and
    equal digests mean equal bits."""
    import hashlib

    from space_gym_torch import get_config
    from space_gym_torch.ops.env_step import EnvStep
    from space_gym_torch.ops.full_step import FullStep
    from space_gym_torch.ops.physics_step import PhysicsStep
    from space_gym_torch.ops.rng_plain import key_words

    def digest(outs):
        h = hashlib.sha256()
        for t in outs:
            h.update(t.contiguous().cpu().numpy().tobytes())
        return h.hexdigest()[:16]

    for env_id in ENV_IDS:
        cfg = get_config(env_id)
        for tab, sub, ref in (("bs3", 1, 8), ("dp5", 2, 12)):
            rows0 = FullStep.to_rows(*scenario(cfg, B, seed=8, device=dev))
            tail = tail_rows(scenario(cfg, B, seed=8, device=dev, translated=True))
            k1, k2 = PhysicsStep(cfg, sub, ref, tab), EnvStep(cfg, sub, ref, tab)
            hashes = {}
            for name in ("K1", "K2"):
                y, outs = tail[0], []
                for _ in range(n_steps):
                    out = (k1.step_rows(y, *tail[1:3]) if name == "K1"
                           else k2.step_rows(y, *tail[1:5]))
                    outs += out
                    y = out[0]
                hashes[name] = digest(outs)
            for name, rng in (("K3", False), ("K3-tf", "threefry"), ("K3-hw", "philox")):
                full = FullStep(cfg, sub, ref, tab, in_kernel_rng=rng)
                g = torch.Generator(device=dev).manual_seed(9)
                y, a, p, gl, r, cs, _, ti = rows0
                outs = []
                for k in range(n_steps):
                    u = (key_words([0x0BADC0DE + k, 0x00FACADE], dev) if rng else
                         torch.rand((full.n_uniform_rows, B), generator=g, device=dev))
                    out = full.step_rows(y, a, p, gl, r, cs, u, ti)
                    outs += out
                    y, p, gl, r, cs, ti = out[0], out[1], out[2], out[3], out[4], out[8]
                hashes[name] = digest(outs)
            torch.cuda.synchronize()
            print(f"bits {env_id} {tab}x{sub} r{ref} B={B} {n_steps} steps: "
                  + ", ".join(f"{k} {v}" for k, v in hashes.items()), flush=True)
    for tab, sub, ref in (("bs3", 1, 8), ("dp5", 2, 12)):
        eng, g, policy, state, obs = warm_engine(dev, MAIN_B, tab, sub, ref)
        full = eng.full
        u = torch.rand((MAIN_B, full.n_uniform_rows), generator=g, device=dev)
        rows, tail = main_rows(eng, state, policy(g, obs), u)
        key = eng.draw_key(g)
        cfg = full.cfg
        calls = {"K1": ("fused_step_kernel", lambda k=PhysicsStep(cfg, sub, ref, tab):
                        k.step_rows(*tail[:3])),
                 "K2": ("env_step_kernel", lambda k=EnvStep(cfg, sub, ref, tab):
                        k.step_rows(*tail)),
                 "K3": ("full_step_kernel", lambda: full.step_rows(*rows))}
        for name, rng in (("K3-tf", "threefry"), ("K3-hw", "philox")):
            keyed = FullStep(cfg, sub, ref, tab, in_kernel_rng=rng)
            calls[name] = ("full_step_kernel",
                           lambda k=keyed: k.step_rows(*rows[:6], key, rows[7]))
        print(f"time {MAIN_ENV} B={MAIN_B} {tab}x{sub} r{ref} on {card}, ms per launch on the "
              f"device: " + ", ".join(f"{name} {kernel_device_ms(fn, kernel):.5f}"
                                      for name, (kernel, fn) in calls.items()), flush=True)


def rollout_bits(card, B=MAIN_B, calls=4, steps=256):
    """The `--rollout-bits` digests (module docstring)."""
    import hashlib

    from space_gym_torch import get_config
    from space_gym_torch.engine import EnvEngine

    for env_id, rng in ((MAIN_ENV, False), ("GoalContinuous4P-v0", False),
                        ("GoalDiscrete3-v0", False), (MAIN_ENV, "threefry"),
                        (MAIN_ENV, "philox")):
        eng = EnvEngine(get_config(env_id), in_kernel_rng=rng)
        g = eng.generator(0)
        state, obs = eng.init(B, g)
        run = eng.capture_rollout(eng.random_policy(), steps, g, trajectory=False)
        sums = []
        for _ in range(calls):
            state, obs, traj = run(state, obs)
            sums += [traj.reward_sum, traj.done_sum]
        h = hashlib.sha256()
        for t in (*eng.to_carry(state), obs, *sums):
            h.update(t.contiguous().cpu().numpy().tobytes())
        print(f"rollout bits {env_id} {RNG_NAMES[rng]} B={B} {calls} calls of {steps} steps: "
              f"{h.hexdigest()[:16]}; reward sums {[float(x) for x in sums[::2]]}, done sums "
              f"{[int(x) for x in sums[1::2]]} on {card}", flush=True)
        del run, state, obs, traj
        torch.cuda.empty_cache()


def clocked_builds(names):
    """nvcc of each csrc/<name>.cu with the phase clock (-DSG_PHASE_CLOCK)
    into build/phase_clock/, one process each, all started at once: {name:
    (library path, process)}."""
    from space_gym_torch.utils import cuda_build

    root = os.path.join(HERE, "build", "phase_clock")
    os.makedirs(root, exist_ok=True)
    procs = {}
    for name in names:
        lib = os.path.join(root, f"lib{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.nvcc_flags(name), "-DSG_PHASE_CLOCK", "-o", lib,
             os.path.join(cuda_build.CSRC, f"{name}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    return procs


def clocked_library(name, lib, proc):
    """The loaded clocked build of `name`, after its nvcc has ended; its
    ptxas report goes to CLOCKED_REPORTS[name]."""
    import ctypes

    out, _ = proc.communicate()
    if proc.returncode != 0:
        fail(f"the phase-clock build of {name} did not build:\n{out[-4000:]}")
    CLOCKED_REPORTS[name] = out
    return ctypes.CDLL(lib)


CLOCKED_REPORTS = {}
TAB_IDS = {"dp5": 0, "bs3": 1}


def ptxas_summary(text, kernel, targs):
    """Registers and spills ptxas reported for the instantiation of `kernel`
    whose mangled template arguments start with `targs` (e.g. "ILi2ELi1E")."""
    if not text:
        return "no ptxas report (library not rebuilt)"
    m = re.search(rf"Function properties for _Z\d+{kernel}{targs}\w*\n[^\n]*?(\d+) bytes stack "
                  rf"frame, (\d+) bytes spill stores, (\d+) bytes spill loads\n[^\n]*?Used (\d+) "
                  r"registers", text)
    if not m:
        return "not in the ptxas report"
    return (f"ptxas {m.group(4)} registers, {m.group(1)} B stack frame, spill stores "
            f"{m.group(2)} B, loads {m.group(3)} B")


# The env kernels the phase clock splits: label -> (library, uniforms of the
# main path's state, kernel name, template arguments of its Goal
# instantiation before the tableau's, env); K3 on 4 planets too, the
# goal4p-collect cell's env
ENV_CLOCKED = {"K1": ("fused_step", False, "fused_step_kernel", "ILi2E", MAIN_ENV),
               "K2": ("env_step", False, "env_step_kernel", "ILi0ELi2E", MAIN_ENV),
               "K3": ("full_step", False, "full_step_kernel", r"I\w+Li0ELi2ELi4ELi2E", MAIN_ENV),
               "K3-4P": ("full_step", False, "full_step_kernel", r"I\w+Li0ELi4ELi16ELi4E",
                         "GoalContinuous4P-v0"),
               "K3-hw": ("full_step_philox", "philox", "full_step_kernel",
                         r"I\w+Li0ELi2ELi4ELi2E", MAIN_ENV)}


def env_clock_targets(label, eng, sub, ref, tab, rows, tail):
    """(module whose _lib the clocked build replaces, its C entry points, a
    call of one launch, the wrapper that describes the launch) of an env
    kernel on the main path's operands `rows` and `tail` (`main_rows`)."""
    from space_gym_torch.ops import env_step, full_step, physics_step

    cfg = eng.full.cfg
    if label == "K1":
        k = physics_step.PhysicsStep(cfg, sub, ref, tab)
        return physics_step, ("sg_fused_step",), lambda: k.step_rows(*tail[:3]), k
    if label == "K2":
        k = env_step.EnvStep(cfg, sub, ref, tab)
        return env_step, ("sg_env_step",), lambda: k.step_rows(*tail), k
    full = eng.full
    return (full_step, (full_step.RNG_MODES[full.rng][1],), lambda: full.step_rows(*rows), full)


def env_phase_clock(dev, card, procs, reports, B=MAIN_B, cases=(("bs3", 1, 8), ("dp5", 2, 12))):
    """Where a launch of K1, K2, K3 (uniforms from memory) and K3-hw (in-kernel
    Philox) spends its cycles, on the main path's state after its warm-up:
    each built with the phase clock (csrc/step_clock.cuh) and launched once
    through its wrapper; every warp's cycles summed by phase, the counts (K1
    and K2: lanes whose events fire; K3: lanes that reached their goal or are
    done, and the lanes whose events fire: deferred to the block's list or
    refined in place) and of the warp tiles that hold one; registers, spills,
    residency and waves of the plain and the clocked build; then the two
    builds timed in turns (profiler).  K3's terminated lanes, which are its
    lanes whose events fire, are counted from its flags too, so a build
    without the clock's fire counts prints them.  `reports`: the plain
    builds' ptxas output."""
    import ctypes

    times, handles = {}, {}
    for label, (name, rng, kname, targs, env_id) in ENV_CLOCKED.items():
        if name not in handles:
            handles[name] = clocked_library(name, *procs[name])
        handle = handles[name]
        handle.sg_k3_phase_read.argtypes = [ctypes.c_void_p]
        handle.sg_k3_phase_name.argtypes = [ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
        names, buf = [], ctypes.create_string_buffer(96)
        while handle.sg_k3_phase_name(len(names), buf, len(buf)) > 0 and buf.value != b"?":
            names.append(buf.value.decode())
        n_marks = names.index("lanes")
        cyc = (ctypes.c_ulonglong * len(names))()
        for tab, sub, ref in cases:
            eng, g, policy, state, obs = warm_engine(dev, B, tab, sub, ref, rng, env_id=env_id)
            full = eng.full
            u = eng.draw_key(g) if rng else torch.rand((B, full.n_uniform_rows), generator=g,
                                                        device=dev)
            module, entries, call, wrapper = env_clock_targets(
                label, eng, sub, ref, tab, *main_rows(eng, state, policy(g, obs), u))
            real = module._lib
            built = real(rng) if label.startswith("K3") else real()
            for fn in entries + tuple(e + "_info" for e in entries):
                getattr(handle, fn).argtypes = getattr(built, fn).argtypes
                getattr(handle, fn).restype = ctypes.c_int
            try:
                module._lib = lambda *a, h=handle: h
                handle.sg_k3_phase_read(cyc)
                out = call()
                torch.cuda.synchronize()
                if handle.sg_k3_phase_read(cyc) != 0:
                    fail(f"{label}: the phase clock could not be read")
                clocked_text, _ = launch_line(wrapper, B)
                module._lib = real
                plain_text, _ = launch_line(wrapper, B)
                total = sum(cyc[:n_marks])
                c = dict(zip(names[n_marks:], cyc[n_marks:]))
                w = max(c["warp tiles"], 1)
                if label.startswith("K3"):
                    term = out[-1][0].reshape(-1, 32).bool()
                    what = (f"{c['lanes that reached their goal']} reached their goal, "
                            f"{c['lanes done']} done; "
                            f"{c['warp tiles with a lane that reached its goal or is done']} warp "
                            f"tiles hold such a lane; {int(term.sum())} terminated by their "
                            f"flags, in {int(term.any(1).sum())} warp tiles")
                    if "lanes whose events fire and refine in place" in c:
                        fired, inplace = c["lanes whose events fire"], c[
                            "lanes whose events fire and refine in place"]
                        what += (f"; the clock's lanes whose events fire {fired} in "
                                 f"{c['warp tiles with a lane whose events fire']} warp tiles: "
                                 f"{fired - inplace} deferred, {inplace} refined in place")
                else:
                    what = (f"{c['lanes whose events fire']} lanes whose events fire; "
                            f"{c['warp tiles with a lane whose events fire']} warp tiles hold "
                            f"such a lane")
                print(f"phase clock {label} {env_id} B={B} {tab}x{sub} r{ref} on {card}: "
                      f"{total} warp-cycles over {c['warp tiles']} warp tiles ({total / w:.0f} a "
                      f"warp tile); {c['lanes']} lanes, {what}", flush=True)
                for i in sorted(range(n_marks), key=lambda i: -cyc[i]):
                    if cyc[i]:
                        print(f"  {100 * cyc[i] / total:5.1f}% {cyc[i] / w:9.0f} cycles a warp "
                              f"tile  {names[i]}", flush=True)
                tid = f"{targs}Li{TAB_IDS[tab]}E"
                print(f"  launch, plain build: {plain_text} "
                      f"({ptxas_summary(reports.get(name), kname, tid)}); clocked build: "
                      f"{clocked_text} ({ptxas_summary(CLOCKED_REPORTS.get(name), kname, tid)})",
                      flush=True)
                for clock in (False, True, True, False):
                    module._lib = (lambda *a, h=handle: h) if clock else real
                    times.setdefault((label, tab, clock), []).append(
                        kernel_device_ms(call, kname))
                    module._lib = real
            finally:
                module._lib = real
    for (label, tab, clock), ms in times.items():
        print(f"time {label} {tab} {'with' if clock else 'without'} the phase clock B={B}: "
              + ", ".join(f"{t:.5f}" for t in ms) + f" ms per launch on the device on {card}",
              flush=True)


def phase_clock(dev, card):
    """Where a launch of K1, K2, K3 and K3-hw (env_phase_clock), then of K4, K5 and K6
    spends its time, for want of a profiler of a kernel's insides: each built
    with the phase clock (-DSG_PHASE_CLOCK) into build/phase_clock/, all five
    builds at once.  K4-K6 launched once at the training path's shapes (K=32,
    B=8192, H=256, ring, mm_bf16=True; K6 with policy_delay 2), block 0's
    cycles per update printed by stage under the names the library gives its
    marks (learner_tiles.cuh); then the clocked and the plain build timed in
    turns by CUDA events (the marks' barriers cost a little)."""
    import ctypes

    from space_gym_torch.models import fused_sac, fused_td3, learner_kernels
    from space_gym_torch.utils import cuda_build

    labels = {"sac_update": "K4", "sac_update_fold": "K5", "td3_update": "K6"}
    kernels = {"sac_update": learner_kernels.SAC, "sac_update_fold": learner_kernels.SAC_FOLD,
               "td3_update": learner_kernels.TD3}
    env_names = sorted({v[0] for v in ENV_CLOCKED.values()})
    procs = clocked_builds([*labels, *env_names])
    reports = {n: text for n, (_, text) in cuda_build.build_all([*labels, *env_names]).items()}
    for n in env_names:  # a library built earlier: the report print_build wrote then
        path = os.path.join(OUT_DIR, f"ptxas_{n}.txt")
        if n not in reports and os.path.exists(path):
            with open(path) as f:
                reports[n] = f.read()
    env_phase_clock(dev, card, procs, reports)
    sac_in = sac_inputs(dev, SAC_H, SAC_K, SAC_B, SAC_LANES)
    td3_in = td3_inputs(dev, SAC_H, SAC_K, SAC_B, SAC_LANES, delay=2, warm=2)
    # per kernel: the clocked build, and a launch from a library (None: the plain build)
    clocked, calls = {}, {}
    for name in labels:
        lib, proc = procs[name]
        clocked[name] = clocked_library(labels[name], lib, proc)
        clocked[name].sg_phase_name.argtypes = [ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
        ns, packed, adam, ring, row_idx, batches, noises, hyper = (
            td3_in if name == "td3_update" else sac_in)
        hp = {k: v for k, v in hyper.items() if k != "obs_dim"}

        def call(f, lib, kernel=kernels[name], ring=ring, row_idx=row_idx, noises=noises,
                 od=hyper["obs_dim"], hp=hp):
            if kernel is learner_kernels.TD3:
                scalars = fused_td3.kernel_scalars(f.count, f.count_a, **hp)
            else:
                scalars = fused_sac.kernel_scalars(f.count, **hp)
            learner_kernels.launch(kernel, f, ring, row_idx, noises, scalars, obs_dim=od,
                                   mm_bf16=True, lib=lib,
                                   stream=torch.cuda.current_stream().cuda_stream)

        # a fresh state, and a call that updates it in place
        calls[name] = (lambda ns=ns, packed=packed, adam=adam: ns.fused_init(packed, adam), call)

    times = {}
    for name in labels:
        handle = clocked[name]
        cyc = (ctypes.c_ulonglong * 256)()
        handle.sg_phase_read(cyc)
        fresh, call = calls[name]
        call(fresh(), handle)
        torch.cuda.synchronize()
        if handle.sg_phase_read(cyc) != 0:
            fail(f"{labels[name]}: the phase clock could not be read")
        total = sum(cyc)
        print(f"phase clock {labels[name]} H={SAC_H} K={SAC_K} B={SAC_B} ring mm_bf16=True, "
              f"block 0, {total / SAC_K:.0f} SM cycles per update:", flush=True)
        label = ctypes.create_string_buffer(96)
        for i in sorted(range(256), key=lambda i: -cyc[i]):
            if cyc[i]:
                handle.sg_phase_name(i, label, len(label))
                print(f"  {100 * cyc[i] / total:5.1f}% {cyc[i] / SAC_K:9.0f} cycles/update  "
                      f"[{i}] {label.value.decode()}")
    for clock in (False, True, True, False):
        for name in labels:
            fresh, call = calls[name]
            f0 = fresh()
            lib = clocked[name] if clock else None
            times.setdefault((name, clock), []).append(cuda_ms(lambda: call(f0, lib), iters=5,
                                                               warmup=2))
    for (name, clock), ms in times.items():
        print(f"time {labels[name]} {'with' if clock else 'without'} the phase clock "
              f"H={SAC_H} K={SAC_K} B={SAC_B} ring mm_bf16=True: "
              + ", ".join(f"{t:.4f}" for t in ms) + f" ms per call by CUDA events on {card}",
              flush=True)


# ------------------------------------------------------------------ scale path --
# The sharded fused trainers: the training path's shape (train_path), with
# warmup_rows = rollout_len so that all three train_iters update.
SCALE_ITERS = 3
SCALE_RUNS = (("sac", False), ("sac", True), ("td3", None))
SCALE_TOL = 1e-5  # a rank's lanes against the one-process run's (the CPU test's)
SCALE_DIR = os.path.join(HERE, "build", "scale")  # the workers' lanes; gitignored


def scale_label(algo, fold):
    return "TD3" if algo == "td3" else f"SAC fused_fold={fold}"


def scale_run(dev, algo, fold, mesh, lanes=None):
    """SACTrainer (K4, or K5 with `fold`) or TD3Trainer (K6) at the training
    path's shape, under `mesh` (None: unsharded), SCALE_ITERS train_iters
    from seed 0 and generator seed 1; the global state is made alike on
    every rank and placed.  Returns (trainer, state, ms of each train_iter,
    ms of each gather of the sampled ring rows)."""
    from space_gym_torch import get_config
    from space_gym_torch.engine import EnvEngine
    from space_gym_torch.models import SACConfig, SACTrainer, TD3Config, TD3Trainer
    from space_gym_torch.parallel import place, trainer_state_shardings

    shape = dict(lanes=lanes or SAC_LANES, rollout_len=SAC_ROLLOUT, updates_per_iter=SAC_K,
                 batch_size=SAC_B, replay_rows=SAC_ROWS, hidden=(SAC_H, SAC_H),
                 fused_updates=True, fused_block=2048, warmup_rows=SAC_ROLLOUT)
    eng = EnvEngine(get_config(MAIN_ENV), device=dev, mesh=mesh)
    tr = (SACTrainer(eng, SACConfig(fused_fold=fold, **shape)) if algo == "sac"
          else TD3Trainer(eng, TD3Config(**shape)))
    st = tr.init(0)
    if mesh is not None:
        st = place(st, trainer_state_shardings(st, mesh, mesh.model_size), mesh)
    g = tr.generator(1)
    gathers = []
    ring_rows = tr._ring_rows

    def timed_rows(*a):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        out = ring_rows(*a)
        e.record()
        gathers.append((s, e))
        return out

    tr._ring_rows = timed_rows
    its = []
    for _ in range(SCALE_ITERS):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        st, m = tr.train_iter(st, g)
        e.record()
        its.append((s, e))
    torch.cuda.synchronize()
    if not all(np.isfinite(float(v)) for v in m.values()):
        fail(f"scale path {scale_label(algo, fold)}: metrics {m}")
    return tr, st, [s.elapsed_time(e) for s, e in its], [s.elapsed_time(e) for s, e in gathers]


def scale_worker(rank: int, nproc: int, port: int):
    """One rank of the two-process run (`chip_smoke.py --scale-worker RANK N
    PORT`): gloo on the one card, the global lanes split along "data".  Per
    run it prints a SCALE_WORKER line of JSON (digest of the replicated
    learner state, ms per train_iter and per gather, launches) and saves its
    lanes and learner state for the parent to hold to the one-process run."""
    from space_gym_torch.parallel import init_distributed, make_mesh

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    init_distributed(f"127.0.0.1:{port}", num_processes=nproc, process_id=rank, backend="gloo")
    mesh = make_mesh()
    os.makedirs(SCALE_DIR, exist_ok=True)
    for algo, fold in SCALE_RUNS:
        reset_launches()
        tr, st, its, gathers = scale_run(dev, algo, fold, mesh)
        launches = read_launches()
        label = scale_label(algo, fold)
        torch.save({"y": st.env_state.y.cpu(), "obs": st.obs.cpu(),
                    "fused": [t.cpu() for t in st.fused[:6]]},
                   os.path.join(SCALE_DIR, f"{algo}_{fold}_rank{rank}.pt"))
        print("SCALE_WORKER " + json.dumps(dict(
            rank=rank, run=label, learner=digest(*st.fused[:6]), counts=list(st.fused[6:]),
            lanes=list(st.obs.shape), it_ms=its, gather_ms=gathers,
            launches={k: v for k, v in launches.items() if v})), flush=True)
        del tr, st
    torch.distributed.destroy_process_group()
    print("SCALE_WORKER_OK", flush=True)


def free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def scale_path(dev, card):
    """The sharded fused trainers.  World 1: `init_distributed` over NCCL,
    `make_mesh`, `place(..., trainer_state_shardings(...))`, then SCALE_ITERS
    train_iters of SAC (K4, then K5) and TD3 (K6) at the training path's
    shape, each against the unsharded trainer from the same seeds: every leaf
    equal bit for bit, the launch counts set to 0 before the sharded run and
    read after it.  Then two processes on the one card over gloo (NCCL takes
    one rank per card), 1024 lanes each: their replicated learner states
    equal bit for bit, each rank's lanes within SCALE_TOL of the one-process
    run's.  ms per train_iter of every run and of the gathers.  Returns its
    measurements."""
    from space_gym_torch.parallel import init_distributed, make_mesh

    init_distributed(f"127.0.0.1:{free_port()}", num_processes=1, process_id=0)
    if torch.distributed.get_backend() != "nccl":
        fail(f"world 1 on the card runs over {torch.distributed.get_backend()}, not nccl")
    mesh = make_mesh()
    out, one = {}, {}
    for algo, fold in SCALE_RUNS:
        label = scale_label(algo, fold)
        _, st0, its0, _ = scale_run(dev, algo, fold, None)
        reset_launches()
        _, st1, its1, gathers = scale_run(dev, algo, fold, mesh)
        launches = read_launches()
        kernel = "td3_update" if algo == "td3" else (
            "sac_update_fold" if fold else "sac_update")
        a, b = leaves(st0), leaves(st1)
        same = len(a) == len(b) and all(
            torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y for x, y in zip(a, b))
        print(f"scale path {label} world 1 (nccl) on {card}: {SCALE_ITERS} train_iters, state "
              f"SHA-256 unsharded {state_digest(st0)}, sharded {state_digest(st1)}, every leaf "
              f"equal: {same}; ms per train_iter unsharded {', '.join(f'{t:.3f}' for t in its0)},"
              f" sharded {', '.join(f'{t:.3f}' for t in its1)}; gather of the sampled rows "
              f"{', '.join(f'{t:.3f}' for t in gathers)} ms; launches {launches}", flush=True)
        if not same:
            fail(f"scale path {label}: the world-1 sharded trainer differs from the unsharded")
        if launches.get(kernel, 0) != SCALE_ITERS or launches.get("full_step", 0) <= 0:
            fail(f"scale path {label}: launches {launches}")
        one[algo, fold] = {"y": st0.env_state.y.cpu(), "obs": st0.obs.cpu(),
                           "fused": [t.cpu() for t in st0.fused[:6]]}
        out[label] = dict(world1_it_ms=its1, unsharded_it_ms=its0, world1_gather_ms=gathers,
                          launches=launches)
        del st0, st1
    torch.distributed.destroy_process_group()

    port = free_port()
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--scale-worker",
                               str(r), "2", str(port)], cwd=HERE, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(2)]
    results = []
    try:
        for p in procs:
            so, se = p.communicate(timeout=400)
            results.append((p.returncode, so, se))
    except subprocess.TimeoutExpired:
        fail("the two-process scale run did not end within 400 s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (rc, so, se) in enumerate(results):
        if rc != 0 or "SCALE_WORKER_OK" not in so:
            fail(f"scale worker {r}: rc {rc}\n{so[-3000:]}\n{se[-3000:]}")
    lines = [[json.loads(ln.split(" ", 1)[1]) for ln in so.splitlines()
              if ln.startswith("SCALE_WORKER ")] for _, so, _ in results]
    wall = time.perf_counter() - t0
    for k, (algo, fold) in enumerate(SCALE_RUNS):
        label = scale_label(algo, fold)
        r0, r1 = lines[0][k], lines[1][k]
        ref = one[algo, fold]
        lane_err, learner_err = 0.0, 0.0
        for rank in range(2):
            got = torch.load(os.path.join(SCALE_DIR, f"{algo}_{fold}_rank{rank}.pt"))
            blk = slice(rank * SAC_LANES // 2, (rank + 1) * SAC_LANES // 2)
            lane_err = max(lane_err, float((got["y"] - ref["y"][blk]).abs().max()),
                           float((got["obs"] - ref["obs"][blk]).abs().max()))
            learner_err = max(learner_err, max(float((a - b).abs().max())
                                               for a, b in zip(got["fused"], ref["fused"])))
        print(f"scale path {label} 2 processes x {SAC_LANES // 2} lanes (gloo, one card) on "
              f"{card}: learner SHA-256 rank 0 {r0['learner']}, rank 1 {r1['learner']}; counts "
              f"{r0['counts']} {r1['counts']}; ms per train_iter rank 0 "
              f"{', '.join(f'{t:.3f}' for t in r0['it_ms'])}, rank 1 "
              f"{', '.join(f'{t:.3f}' for t in r1['it_ms'])}; gather ms rank 0 "
              f"{', '.join(f'{t:.3f}' for t in r0['gather_ms'])}; max|lanes - one-process| "
              f"{lane_err:.3g} (tolerance {SCALE_TOL}), max|learner - one-process| "
              f"{learner_err:.3g}; launches {r0['launches']}", flush=True)
        if r0["learner"] != r1["learner"] or r0["counts"] != r1["counts"]:
            fail(f"scale path {label}: the ranks' replicated learner states differ")
        if not lane_err <= SCALE_TOL:
            fail(f"scale path {label}: a rank's lanes are {lane_err:.3g} from the one-process run")
        out[label].update(two_it_ms=[r0["it_ms"], r1["it_ms"]], two_gather_ms=r0["gather_ms"],
                          lane_err=lane_err, learner_err=learner_err)
    print(f"scale path: the two-process run took {wall:.1f} s with its process starts",
          flush=True)
    return out


# ----------------------------------------------------------------- native path --
NATIVE_IDS = ("GoalContinuous2P-v0", "GoalContinuous3P-v0", "GoalContinuous4P-v0",
              "KeplerCircleOrbit-v0", "KeplerEllipseEasy-v0")


def native_steps(env_id):
    """Every recorded step of the goldens of `env_id` (tests/goldens/):
    (pre-step state, translated action, planets)."""
    import space_gym_torch

    g = np.load(os.path.join(HERE, "tests", "goldens", f"{env_id}.npz"))
    env = space_gym_torch.make(env_id, physics="host")
    for ep in range(int(g["episodes"])):
        p = f"ep{ep}_"
        states = np.concatenate([g[p + "reset_state"][None], g[p + "post_states"]])
        for t, a in enumerate(g[p + "actions"]):
            yield states[t].copy(), np.array(env._translate_raw_action(a.astype(np.float32))), \
                g[p + "reset_planets"]


def native_path(dev, card):
    """physics="native" (the C++ runtime, built with g++ on first use) on
    every golden step of the five recorded envs against physics="host",
    bit for bit (numpy's OpenBLAS found: sgt_has_blas() 1; without it the
    bits would be the fallback kernels' and the check fails), then
    make(MAIN_ENV) over its golden steps in each mode, ms per step on the
    host clock."""
    import space_gym_torch
    from space_gym_torch.compat.gym_api import _host_physics_step
    from space_gym_torch.parity import native

    t0 = time.perf_counter()
    if not native.is_available():
        fail(f"the native runtime did not build: {native.build_error()}")
    blas = native.has_blas()
    print(f"native: built in {time.perf_counter() - t0:.1f} s; sgt_has_blas() "
          f"{int(blas)} ({native.openblas_path()})", flush=True)
    n = equal = 0
    solve_s = {"native": 0.0, "host": 0.0}
    for env_id in NATIVE_IDS:
        cfg = space_gym_torch.get_config(env_id)
        for y0, a, planets in native_steps(env_id):
            t0 = time.perf_counter()
            yh, dh = _host_physics_step(cfg, y0.copy(), a, planets)
            t1 = time.perf_counter()
            yn, dn = native.solve_step_native(cfg, y0, a, planets)
            solve_s["host"] += t1 - t0
            solve_s["native"] += time.perf_counter() - t1
            n += 1
            equal += int(dh == dn and np.array_equal(yh, yn))
    solve_ms = {k: v * 1e3 / n for k, v in solve_s.items()}
    print(f"native vs host: {equal} of {n} golden steps of {len(NATIVE_IDS)} envs bit for bit; "
          f"the solver alone, ms per step: native {solve_ms['native']:.4f}, host "
          f"{solve_ms['host']:.4f}", flush=True)
    if equal != n:
        fail(f"physics='native' differs from 'host' on {n - equal} of {n} golden steps"
             + ("" if blas else " (numpy's OpenBLAS was not found: the fallback kernels ran)"))
    ms = {}
    for mode in ("native", "host", "device"):
        env = space_gym_torch.make(MAIN_ENV, physics=mode, device=dev)
        worst, ms[mode], steps = golden_steps(env, MAIN_ENV)
        if not worst <= (TOL_GOLDEN if mode == "device" else 0.0):
            fail(f"make({MAIN_ENV!r}, physics={mode!r}): golden max|err| {worst:.3g}")
    print(f"make {MAIN_ENV} over {steps} golden steps on {card}, ms per step: "
          + ", ".join(f"{k} {v:.4f}" for k, v in ms.items()), flush=True)
    return dict(steps=n, bitwise=equal, has_blas=blas, ms_step=ms, solve_ms=solve_ms)


# ----------------------------------------------------------- parity path --
def parity_path(dev, card):
    """The device parity tier (parity/device_replay.py): the parity engine's
    tensors on `dev`, its numpy-exact ops through the host library (a round
    trip per op on the card).  The library's build, the tiling twin's
    sampler oracle on `dev` (bitwise), the 14 golden files replayed on `dev`
    (flags on every step, errors <= TOL_GOLDEN; bitwise is the aim and the
    counts say how far it got), then on the CPU, where every step must be
    bitwise: the tier's contract on this machine."""
    from space_gym_torch.ops import exact
    from space_gym_torch.parity import device_replay
    from space_gym_torch.utils.native_build import openblas_path

    t0 = time.perf_counter()
    exact.load()
    print(f"parity: sgt_exactmath built and loaded in {time.perf_counter() - t0:.1f} s; "
          f"OpenBLAS {openblas_path()}", flush=True)
    t0 = time.perf_counter()
    oracle = device_replay.sampler_oracle(device=dev)
    print(f"parity: sampler oracle on {dev}: {json.dumps(oracle)} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    if not oracle["ok"]:
        fail(f"the tiling twin differs from HostTiling on {dev}: {oracle}")
    out = {"sampler_oracle": oracle["sampler_oracle"]}
    for where in (dev, "cpu"):
        files, t0 = [], time.perf_counter()
        for env_id in device_replay.GOLDEN_IDS:
            for subset in device_replay.GOLDEN_SETS:
                st = device_replay.replay(env_id, subset, device=where)
                st["round_trips_per_step"] = st["host_round_trips"] / st["steps"]
                files.append(st)
                print(f"parity {where}: {env_id} {st['subset']}: {st['steps']} steps, bitwise "
                      f"state {st['state_bitwise']} obs {st['obs_bitwise']} reward "
                      f"{st['reward_bitwise']}, flags equal {st['flag_match']}; max|err| state "
                      f"{st['max_state_err']:.3g} obs {st['max_obs_err']:.3g} reward "
                      f"{st['max_reward_err']:.3g}; {st['ms_per_step']:.3f} ms/step, "
                      f"{st['round_trips_per_step']:.1f} host round trips/step"
                      + (f"; first mismatches {st['mismatches'][:3]}" if "mismatches" in st
                         else ""), flush=True)
                if st["flag_match"] != st["steps"] or not max(
                        st["max_state_err"], st["max_obs_err"], st["max_reward_err"]) <= TOL_GOLDEN:
                    fail(f"the parity replay on {where} left the golden: {st}")
                if where == "cpu" and not st["bitwise"]:
                    fail(f"the parity replay on the CPU is not bitwise: {st}")
        steps = sum(f["steps"] for f in files)
        summary = {k: sum(f[k] for f in files)
                   for k in ("steps", "state_bitwise", "obs_bitwise", "reward_bitwise",
                             "flag_match", "host_round_trips")}
        summary.update(seconds=time.perf_counter() - t0,
                       ms_per_step=sum(f["ms_per_step"] * f["steps"] for f in files) / steps,
                       bitwise_files=sum(f["bitwise"] for f in files),
                       max_state_err=max(f["max_state_err"] for f in files),
                       max_obs_err=max(f["max_obs_err"] for f in files),
                       max_reward_err=max(f["max_reward_err"] for f in files),
                       files={f"{f['env_id']} {f['subset']}": [
                           f["steps"], f["state_bitwise"], f["obs_bitwise"], f["reward_bitwise"],
                           f["ms_per_step"], f["round_trips_per_step"]] for f in files})
        print(f"parity {where} ({card}): {summary['bitwise_files']} of {len(files)} files "
              f"bitwise, {steps} steps in {summary['seconds']:.1f} s", flush=True)
        out["cpu" if where == "cpu" else "card"] = summary
    return out


# ---------------------------------------------------------- replay agent path --
REPLAY_CKPT = "docs/goal2p_sac_best.npz"
REPLAY_OUT = os.path.join("build", "replays")  # gitignored


def replay_agent_path(card):
    """`python -m space_gym_torch.run_agent` as a user runs it, the actor on
    the card: two episodes scored without GIFs, then one with GIFs into
    build/replays/."""
    out = {}
    for label, extra in (("no_gif", ["--no-gif", "--episodes", "2"]),
                         ("gif", ["--episodes", "1", "--every", "10", "--out", REPLAY_OUT])):
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, "-m", "space_gym_torch.run_agent", "--ckpt",
                              REPLAY_CKPT, *extra], cwd=HERE, capture_output=True, text=True,
                             timeout=600)
        text = run.stdout
        mean = re.search(r"^mean return: (\S+)", text, re.M)
        per = re.search(r"^ms per step: (\S+) .* on (\S+)\)", text, re.M)
        if run.returncode != 0 or not mean or not per or not np.isfinite(float(mean.group(1))):
            fail(f"run_agent {label}: rc {run.returncode}\n{text[-2000:]}\n{run.stderr[-2000:]}")
        if not per.group(2).startswith("cuda"):
            fail(f"run_agent {label}: the actor ran on {per.group(2)}")
        gif = os.path.join(HERE, REPLAY_OUT, f"{MAIN_ENV}_ep0.gif")
        if label == "gif" and not (os.path.exists(gif) and os.path.getsize(gif) > 0):
            fail(f"run_agent wrote no GIF at {gif}")
        print(f"run_agent {REPLAY_CKPT} ({label}) on {card}: "
              + "; ".join(ln for ln in text.splitlines() if ln.startswith(("episode", "mean",
                                                                          "ms per")))
              + f"; {time.perf_counter() - t0:.1f} s with the process start", flush=True)
        out[label] = dict(mean_return=float(mean.group(1)), ms_step=float(per.group(1)))
    return out


# ------------------------------------------------------------------ fuzz path --
FUZZ_B = 65536
FUZZ_ROLLOUT = ((False, 2000), (True, 64))  # (tail tier "fixed"?, steps) at 512 lanes


def adversarial_states(cfg, n, rng):
    """tests/test_fuzz.py's grazing states from a numpy generator: near the
    first planet's surface, random heading, speeds up to about 5, spin within
    the limit."""
    pr = cfg.planet_radii[0]
    ang = rng.uniform(0, 2 * np.pi, n)
    r = pr + rng.uniform(1e-4, 0.05, n)
    pos = np.stack([np.cos(ang), np.sin(ang)], -1) * r[:, None]
    vel = rng.normal(0, 1, (n, 2)) * 2.5
    w = rng.uniform(-cfg.max_abs_vel_angle * 0.999, cfg.max_abs_vel_angle * 0.999, n)
    return np.concatenate([pos, ang[:, None], vel, w[:, None]], -1).astype(np.float32)


def fuzz_path(dev, card):
    """Adversarial states (tests/test_fuzz.py) on the card: FUZZ_B grazing
    DoNotCrash lanes through K3 and through physics="fixed", each against the
    same on the CPU (the plain twin; the fixed tier), flags agreeing on
    >= MIN_FLAG_AGREEMENT of lanes and every output finite; then the
    bang-bang rollout at 512 lanes through K3 (FUZZ_ROLLOUT steps) and
    "fixed", finite and inside the world, episodes ending."""
    from space_gym_torch import get_config
    from space_gym_torch.engine import EnvEngine

    cfg = get_config("DoNotCrashContinuous-v0")
    rng = np.random.default_rng(17)
    ys = adversarial_states(cfg, FUZZ_B, rng)
    acts = rng.uniform(-1, 1, (FUZZ_B, 2)).astype(np.float32)
    u = rng.random((FUZZ_B, 64), dtype=np.float32)
    out = {}
    for physics in ("kernel", "fixed"):
        res = {}
        for d in (dev, "cpu"):
            eng = EnvEngine(cfg, physics=physics, device=d)
            y, a = torch.as_tensor(ys, device=d), torch.as_tensor(acts, device=d)
            planets = torch.tensor(cfg.fixed_planet_pos, dtype=torch.float32,
                                   device=d)[None].expand(FUZZ_B, -1, -1).contiguous()
            if physics == "kernel":
                full = eng.full
                z = lambda k: torch.zeros((FUZZ_B, k), device=d)  # noqa: E731
                outs = full.apply(y, a, planets, z(2), z(3),
                                  z(full.cs_rows),
                                  torch.zeros((FUZZ_B, full.n_int_rows), dtype=torch.int32,
                                              device=d),
                                  torch.as_tensor(u[:, :full.n_uniform_rows], device=d))
                res[str(d)] = (outs[9][0].cpu(), torch.cat([o.reshape(-1) for o in outs[:8]]))
            else:
                yo, term = eng._physics(y, eng._translate_action(a), planets)
                res[str(d)] = (term.cpu(), yo.reshape(-1))
        term_card, vals = res[str(dev)]
        agree = float((term_card == res["cpu"][0]).float().mean())
        finite = bool(torch.isfinite(vals).all())
        print(f"fuzz {physics} {FUZZ_B} grazing DoNotCrash lanes on {card}: terminated "
              f"{int(term_card.sum())}, flags agree with the CPU on {agree:.6f}, every output "
              f"finite: {finite}", flush=True)
        if agree < MIN_FLAG_AGREEMENT or not finite or term_card.float().mean() < 0.2:
            fail(f"fuzz {physics}: agreement {agree}, finite {finite}")
        out[physics] = dict(agree=agree, terminated=int(term_card.sum()))
    goal = get_config(MAIN_ENV)
    for tail, steps in FUZZ_ROLLOUT:
        physics = "fixed" if tail else "kernel"
        eng = EnvEngine(goal, physics=physics, device=dev)
        state, obs = eng.init(512, eng.generator(0))

        def bang_bang(g, o):
            return (torch.randint(0, 2, (o.shape[0], 2), generator=g, device=o.device) * 2
                    - 1).to(torch.float32)

        t0 = time.perf_counter()
        state, obs, traj = eng.rollout(state, obs, bang_bang, steps, eng.generator(1))
        ok = bool(torch.isfinite(traj.reward).all() and torch.isfinite(traj.obs).all()
                  and (obs[:, 0:2].abs() <= goal.world_size / 2 + 1e-3).all())
        n_term = int(traj.terminated.sum())
        print(f"fuzz bang-bang {physics} {MAIN_ENV} 512 lanes x {steps} steps on {card}: finite "
              f"and inside the world: {ok}, terminations {n_term}, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        if not ok or n_term == 0:
            fail(f"fuzz bang-bang {physics}: finite/inside {ok}, terminations {n_term}")
        out[f"bang_bang_{physics}"] = n_term
    return out


def kernel_entry(name, source, replaces, launches, err, ms, plain, bnd, library=None, **extra):
    by = max(bnd, key=bnd.get)
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bnd[by], "bound_by": by, "library_ms": library, **extra}


def tensor_core_counts():
    """HMMA instructions in the SASS of the three learner libraries: K4, K5
    and K6 run their bf16-mode products on the tensor cores."""
    from space_gym_torch.utils import cuda_build

    counts = {n: cuda_build.sass_count(n, "HMMA")
              for n in ("sac_update", "sac_update_fold", "td3_update")}
    print(f"HMMA instructions in the SASS: {counts}", flush=True)
    if not all(counts.values()):
        fail(f"a learner kernel holds no tensor-core instruction: {counts}")
    return counts


def main():
    # ---------------------------------------------------------- 1. card --
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script runs only on a CUDA card")
    import space_gym_torch

    if not os.path.abspath(space_gym_torch.__file__).startswith(HERE + os.sep):
        fail(f"space_gym_torch imported from {space_gym_torch.__file__}, not from this checkout")
    from space_gym_torch.utils import cuda_build

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}"
          f" device {kind} count {torch.cuda.device_count()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    os.makedirs(OUT_DIR, exist_ok=True)
    if sys.argv[1:] == ["--sac-bits"]:
        t0 = time.perf_counter()
        reports = cuda_build.build_all(["sac_update", "sac_update_fold", "td3_update"])
        print(f"build: {time.perf_counter() - t0:.1f} s wall for {sorted(reports)}", flush=True)
        sac_bits(dev, card)
        return
    if sys.argv[1:] == ["--phase-clock"]:
        phase_clock(dev, card)
        return
    if sys.argv[1:2] == ["--scale-worker"]:
        scale_worker(*[int(x) for x in sys.argv[2:5]])
        return
    if sys.argv[1:] == ["--env-bits"]:
        t0 = time.perf_counter()
        reports = cuda_build.build_all(list(ENV_KERNELS))
        print(f"build: {time.perf_counter() - t0:.1f} s wall for {sorted(reports)}", flush=True)
        env_bits(dev, card)
        return
    if sys.argv[1:] == ["--rollout-bits"]:
        rollout_bits(card)
        return
    if sys.argv[1:] == ["--parity"]:
        print(json.dumps({"parity": parity_path(dev, card)}), flush=True)
        return
    if sys.argv[1:]:
        fail(f"unknown arguments {sys.argv[1:]}")

    # --------------------------------------------------------- 2. build --
    t0 = time.perf_counter()
    reports = cuda_build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s wall for {sorted(reports)}", flush=True)
    print_build(reports)
    hmma = tensor_core_counts()

    # ---------------------------------------------- 3. kernels vs twins --
    k1_check_err = check_k1(dev, CHECK_B)
    k2_check_err = check_k2(dev, CHECK_B)
    k3_check_err = check_k3(dev, CHECK_B)
    check_rng(dev, CHECK_B)
    check_engine(dev)

    # ---------------------------------------- 4. the main path, full width --
    # three repeats of the bench configuration in one process: their spread
    # says how far apart two runs may fall; the median run is reported
    runs = sorted((main_path(dev, card, MAIN_B, "bs3", 1, 8, 256) for _ in range(3)),
                  key=lambda r: r["sps"])
    main = runs[1]
    print("main path repeats, env-steps/s: " + ", ".join(f"{r['sps']:.6g}" for r in runs)
          + "; K3 ms/launch: " + ", ".join(f"{r['k3_ms']:.5f}" for r in runs), flush=True)
    keyed = {rng: main_path(dev, card, MAIN_B, "bs3", 1, 8, 256, rng=rng)
             for rng in ("threefry", "philox")}
    runs.append(main_path(dev, card, MAIN_B, "dp5", 2, 12, 32))
    # max_abs_err of the kernels line: the largest kernel-vs-plain error on
    # the main path's own states (every run above); the B=65536 branch
    # checks of phase 3 are printed above it
    k3_err = max(r["k3_err"] for r in runs)
    k2_err = max(r["k2_err"] for r in runs)
    k1_err = max(r["k1_err"] for r in runs)
    print(f"max|err| on the main path's states: K3 {k3_err:.3g}, K2 {k2_err:.3g}, K1 {k1_err:.3g}, "
          f"K3-tf {keyed['threefry']['k3_err']:.3g}, K3-hw {keyed['philox']['k3_err']:.3g}; in "
          f"the B={CHECK_B} branch checks: K3 {k3_check_err:.3g}, K2 {k2_check_err:.3g}, "
          f"K1 {k1_check_err:.3g}", flush=True)
    print("main path by source of uniforms, env-steps/s: "
          + ", ".join(f"{RNG_NAMES[r['rng']]} {r['sps']:.6g}" for r in [main, *keyed.values()])
          + "; K3 ms/launch: "
          + ", ".join(f"{RNG_NAMES[r['rng']]} {r['k3_ms']:.5f}" for r in [main, *keyed.values()]),
          flush=True)
    profile_main_path(dev, MAIN_B, "bs3", 1, 8)
    profile_main_path(dev, MAIN_B, "bs3", 1, 8, rng="philox")

    # ------------------------- 4b. the captured rollout, the bench's main path --
    rollouts = {rng: rollout_path(dev, card, rng) for rng in (False, "threefry", "philox")}
    print("captured rollout by source of uniforms, env-steps/s captured / eager: "
          + ", ".join(f"{RNG_NAMES[r]} {v['sps']['captured']:.6g} / {v['sps']['eager']:.6g}"
                      for r, v in rollouts.items()), flush=True)

    # ----------------------------------------- 5. the other tiers' paths --
    tiers = {tier: tier_path(dev, card, MAIN_B, tier) for tier in ("env", "physics", "fixed")}

    # --------------------- 5b. the adaptive tier and the adapters on the card --
    adaptive = adaptive_path(dev, card)
    adapters = adapter_path(dev, card)

    # ------------------------------- 6. the learner kernels vs plain version --
    k4_errs, k4_results = check_k4(dev)
    k5_errs = check_k5(dev, k4_results)
    del k4_results
    k6_errs = check_k6(dev)

    # --------------------------------------------- 7. the training paths --
    train = {fold: train_path(dev, card, "sac", fold) for fold in (False, True)}
    train["td3"] = train_path(dev, card, "td3")
    print("train path by kernel: "
          + ", ".join(f"{'TD3' if f == 'td3' else f'SAC fused_fold={f}'} {r['sps']:.6g} "
                      f"env-steps/s, train_iter {r['it_ms']:.3f} ms (eager rollout "
                      f"{r['vs_eager']['eager']:.3f}), kernel {r['ms']:.3f} "
                      f"ms/launch" for f, r in train.items()), flush=True)
    onpolicy = {algo: onpolicy_path(dev, card, algo) for algo in ("ppo", "dqn")}

    # ------------------------------------------------ 7b. the bench entry --
    bench = bench_run(card)

    # ------------- 7c-7g. scale-out, native, replay, fuzzing and the parity tier --
    scale = scale_path(dev, card)
    natives = native_path(dev, card)
    replay = replay_agent_path(card)
    fuzz = fuzz_path(dev, card)
    parity = parity_path(dev, card)

    # ------------------------------------------------------ 8. the lines --
    # launches: K3, K3-tf and K3-hw from their captured main-path runs (a
    # graph's launches times its replays), K2 from the
    # fuse="env" path, K1 from the fuse="physics" path.  library_ms of the two
    # in-kernel variants is torch.rand of the (B, n_u) block: the one library
    # call for the random part alone, not for the step.  K4 and K5: launches,
    # device time and plain version from the training path (mm_bf16=True, one
    # launch per live train_iter); max_abs_err the largest error of w and vec
    # against the plain version in phase 6, either mode; library_ms is
    # torch.matmul of one (8192, 256) x (256, 256) product times the 512 such
    # products of a launch: a yardstick for the products alone, no single
    # PyTorch call computes the update; library16_ms the same products on
    # bf16 operands with float32 output, the precision of mm_bf16=True.  K6
    # the same from the TD3 training path, whose launches have 400 such
    # products (16 of 32 updates delayed).  hmma: the tensor-core
    # instructions in each learner library's SASS.
    csrc = "space_gym_torch/csrc/"
    tf, hw = keyed["threefry"], keyed["philox"]
    kernels = {"kernels": [
        kernel_entry("fused_step", csrc + "fused_step.cu",
                     "space_gym_tpu/ops/pallas_step.py:300",
                     tiers["physics"]["launches"]["fused_step"],
                     k1_err, main["k1_ms"], main["k1_plain_ms"], main["k1_bound"]),
        kernel_entry("env_step", csrc + "env_step.cu", "space_gym_tpu/ops/pallas_step.py:370",
                     tiers["env"]["launches"]["env_step"],
                     k2_err, main["k2_ms"], main["k2_plain_ms"], main["k2_bound"]),
        kernel_entry("full_step", csrc + "full_step.cu", "space_gym_tpu/ops/pallas_full.py:500",
                     rollouts[False]["launches"]["full_step"],
                     k3_err, main["k3_ms"], main["k3_plain_ms"], main["k3_bound"],
                     scale_launches=sum(r["launches"]["full_step"] for r in scale.values())),
        kernel_entry("full_step_threefry", csrc + "full_step_threefry.cu",
                     "space_gym_tpu/ops/pallas_full.py:529",
                     rollouts["threefry"]["launches"]["full_step_threefry"], tf["k3_err"],
                     tf["k3_ms"],
                     tf["k3_plain_ms"], tf["k3_bound"], tf["rand_ms"]),
        kernel_entry("full_step_philox", csrc + "full_step_philox.cu",
                     "space_gym_tpu/ops/pallas_full.py:518",
                     rollouts["philox"]["launches"]["full_step_philox"], hw["k3_err"],
                     hw["k3_ms"],
                     hw["k3_plain_ms"], hw["k3_bound"], hw["rand_ms"]),
        kernel_entry("sac_update", csrc + "sac_update.cu",
                     "space_gym_tpu/models/fused_sac.py:759",
                     train[False]["launches"]["sac_update"], max(k4_errs.values()),
                     train[False]["ms"], train[False]["plain_ms"], train[False]["bound"],
                     train[False]["library_ms"], library16_ms=train[False]["library16_ms"],
                     hmma=hmma["sac_update"],
                     scale_launches=scale["SAC fused_fold=False"]["launches"]["sac_update"]),
        kernel_entry("sac_update_fold", csrc + "sac_update_fold.cu",
                     "space_gym_tpu/models/fused_sac.py:866",
                     train[True]["launches"]["sac_update_fold"], max(k5_errs.values()),
                     train[True]["ms"], train[True]["plain_ms"], train[True]["bound"],
                     train[True]["library_ms"], library16_ms=train[True]["library16_ms"],
                     hmma=hmma["sac_update_fold"],
                     scale_launches=scale["SAC fused_fold=True"]["launches"]["sac_update_fold"]),
        kernel_entry("td3_update", csrc + "td3_update.cu",
                     "space_gym_tpu/models/fused_td3.py:421",
                     train["td3"]["launches"]["td3_update"], max(k6_errs.values()),
                     train["td3"]["ms"], train["td3"]["plain_ms"], train["td3"]["bound"],
                     train["td3"]["library_ms"], library16_ms=train["td3"]["library16_ms"],
                     hmma=hmma["td3_update"],
                     scale_launches=scale["TD3"]["launches"]["td3_update"]),
    ]}
    if any(k["launches"] <= 0 for k in kernels["kernels"]):
        fail(f"a kernel was launched no time on its path: {kernels}")
    # train_iter_ms: "whole" and "rollout" are the means of the steady
    # train_iters of the path's own run; "captured" and "eager" the medians
    # of captured_vs_eager's runs in turns after it, in the same process
    print(json.dumps({"bench": bench, "train_iter_ms": {
        ("sac_fold" if f is True else "sac" if f is False else f): dict(
            whole=r["it_ms"], rollout=r["roll_ms"], captured=r["vs_eager"]["captured"],
            eager=r["vs_eager"]["eager"])
        for f, r in {**train, **onpolicy}.items()}}), flush=True)
    print(json.dumps({"adaptive": adaptive, "adapters": adapters}), flush=True)
    print(json.dumps({"scale": scale, "native": natives, "replay_agent": replay, "fuzz": fuzz}),
          flush=True)
    print(json.dumps({"parity": parity}), flush=True)
    print(json.dumps(kernels), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
