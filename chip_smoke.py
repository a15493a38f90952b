"""Chip smoke run of space_gym_torch on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and swallowed):
  1. card: name and power limit (nvidia-smi), torch and CUDA versions;
  2. build: every kernel under space_gym_torch/csrc/ with nvcc for sm_90a,
     one nvcc per source, all at once; registers and spills per kernel;
  3. kernels against their plain PyTorch twins on the card, same inputs:
     K1 (csrc/fused_step.cu) and K3 (csrc/full_step.cu) at B=65536 on
     states with live, truncating, crashing and goal-reaching lanes (phase 4
     holds both against their twins again on the main path's own states);
  4. the main path at full width: EnvEngine("GoalContinuous2P-v0") on the
     card, B=262144 lanes, random policy, BS3 x 1 substep / refine 8 for 256
     steps (three repeats, the median reported) and DP5 x 2 / refine 12 for
     64, each after 32 warm-up steps, with the K3 launch count, env
     steps/s, kernel times and their bounds, and device time by kernel over
     a short profiled window; the engine on the card is also held against the
     engine on the CPU on a small input;
  5. a `kernels` JSON line, the card line again, and the final
     {"ok": true, "device": ...} line.

Everything is made from seeds; it needs no network and imports no JAX.
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

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "build", "reports")  # ptxas reports; gitignored

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and float32 (non-tensor)
# rate; the bound of a kernel is the larger of bytes/BW and ops/FLOPS.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

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
# Steps run before a timed window, so that clocks and caches settle.
WARMUP_STEPS = 32


def fail(msg: str):
    print(f"FAILED: {msg}", flush=True)
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


def kernel_device_ms(fn, kernel: str, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time per launch of the kernel whose name contains `kernel`
    over `iters` calls of fn (torch.profiler, the launches it recorded).  Unlike events around a loop of
    calls, this excludes the host's time to make each call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and kernel in e.key]
    n = sum(e.count for e in hits)
    # the profiler's buffer may drop an event at the window's edge
    if n < 0.9 * iters:
        fail(f"the profiler saw {n} launches of {kernel}, expected {iters}")
    return sum(e.self_device_time_total for e in hits) / n / 1e3


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
def scenario(cfg, B: int, seed: int, device):
    """(B, rows) operands of one full step with lanes in every branch:
    lane % 10 == 0 truncates, 1 crashes into planet 0, 2 reaches its goal
    (Goal) or flies out of the world, 3 carries a known goal tile; the rest
    are live lanes of a fresh episode."""
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
    return eng.kernel_operands(state, eng._translate_action(action), u)


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
    from space_gym_torch.ops.full_step import FullStep
    from space_gym_torch.ops.physics_step import PhysicsStep

    cfg = get_config(MAIN_ENV)
    worst = 0.0
    for tab, sub, ref in (("dp5", 2, 12), ("bs3", 1, 8)):
        k1 = PhysicsStep(cfg, sub, ref, tab)
        rows = FullStep.to_rows(*scenario(cfg, B, seed=1, device=dev))[:3]
        yo, term = k1.step_rows(*rows)
        yw, tw = k1.plain_rows(*rows)
        agree = (term == tw)[0]
        err = (yo[:, agree] - yw[:, agree]).abs().max().item()
        frac = agree.float().mean().item()
        print(f"K1 {MAIN_ENV} {tab}x{sub} r{ref} B={B}: flag agreement {frac:.6f} "
              f"({int((~agree).sum())} lanes), terminated {int(tw.sum())}, max|err| {err:.3g}",
              flush=True)
        if frac < MIN_FLAG_AGREEMENT or not err <= TOL_STATE or int(tw.sum()) == 0:
            fail("K1 disagrees with its plain twin, or no lane terminated")
        worst = max(worst, err)
    return worst


def check_k3(dev, B):
    """K3 against its plain twin on every task; returns the max float error."""
    from space_gym_torch import get_config
    from space_gym_torch.ops.full_step import FullStep

    worst = 0.0
    checks = [(MAIN_ENV, "bs3", 1, 8), (MAIN_ENV, "dp5", 2, 12),
              ("GoalContinuous4P-v0", "bs3", 1, 8), ("KeplerRandomOrbits-v0", "bs3", 1, 8),
              ("DoNotCrashContinuous-v0", "bs3", 1, 8)]
    for env_id, tab, sub, ref in checks:
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


def main_path(dev, card, B, tab, sub, ref, n_steps, time_ms=cuda_ms, plain_iters=3,
              kernel_ms=None):
    """The main path at full width; returns its measurements."""
    kernel_ms = kernel_ms or kernel_device_ms
    from space_gym_torch import get_config
    from space_gym_torch.engine import EnvEngine
    from space_gym_torch.ops.full_step import FullStep
    from space_gym_torch.ops.physics_step import PhysicsStep

    cfg = get_config(MAIN_ENV)
    eng = EnvEngine(cfg, tableau=tab, substeps=sub, refine_iters=ref, device=dev)
    g = eng.generator(0)
    policy = eng.random_policy()
    state, obs = eng.init(B, g)
    for _ in range(WARMUP_STEPS):
        state, ts = eng.step(state, policy(g, obs), g)
        obs = ts.obs
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

    FullStep.launches = 0
    PhysicsStep.launches = 0
    w0 = time.perf_counter()
    ms_total = time_ms(run, iters=1, warmup=0)
    wall = time.perf_counter() - w0
    clocks = gpu_clocks() if torch.device(dev).type == "cuda" else "n/a"
    launches = {"full_step": FullStep.launches, "fused_step": PhysicsStep.launches}
    if launches["full_step"] != n_steps:
        fail(f"K3 launched {launches['full_step']} times in {n_steps} steps")
    if not all(torch.isfinite(t).all().item() for t in
               (state.y, state.planets_pos, state.goal_pos, obs)):
        fail("main path state or observation not finite")
    if obs.shape != (B, cfg.obs_dim):
        fail(f"observation of shape {tuple(obs.shape)}")
    n_done = int(done_sum.item())
    if n_done == 0:
        fail("no lane reset in the main-path run")

    # K3 alone on this run's last state, held against its plain twin on the
    # same operands (the main path's own shape and state), then timed.
    full = eng.full
    u = torch.rand((B, full.n_uniform_rows), generator=g, device=dev)
    a = eng._translate_action(policy(g, obs))
    rows = full.to_rows(*eng.kernel_operands(state, a, u))
    out = full.step_rows(*rows)
    want = full.plain(*rows)
    frac, n_bad, errs, where = compare(out, want, [TOL_STATE] * 7 + [TOL_REWARD])
    k3_err = max(errs)
    print(f"K3 vs plain on the main path's state, {tab}x{sub} r{ref} B={B}: flag+int "
          f"agreement {frac:.6f} ({n_bad} lanes); terminated/truncated/done "
          f"{want[-1].sum(1).tolist()}; max|err| {k3_err:.3g}; largest: {where}", flush=True)
    if frac < MIN_FLAG_AGREEMENT:
        fail(f"K3 on the main path's state: flags/int rows agree on {frac:.6f} of lanes")
    k3_call_ms = time_ms(lambda: full.step_rows(*rows), iters=200, warmup=20)
    k3_ms = kernel_ms(lambda: full.step_rows(*rows), "full_step_kernel")
    k3_plain_ms = time_ms(lambda: full.plain(*rows), iters=plain_iters, warmup=1)
    flags = out[-1]
    n_term, n_done1 = int(flags[0].sum()), int(flags[2].sum())
    n_reached = int(((out[2] != rows[3]).any(0) & (flags[2] == 0)).sum())
    k3_ops = rhs_ops(cfg, tab, sub, B, n_term)
    # The kernel reads a lane's resample rows of u only where it reached its
    # goal and its reset rows only where it is done: count this data's reads.
    gp = 3 + 3 * cfg.tiling.n_tiles
    u_reads = n_reached * gp + n_done1 * (full.n_uniform_rows - gp)
    k3_bytes = 4 * ((full.bytes_per_lane() // 4 - full.n_uniform_rows) * B + u_reads)
    k3_bound = bound(k3_bytes, k3_ops)

    # K1 at the same shapes and configuration (not on the main path).
    k1 = PhysicsStep(cfg, sub, ref, tab)
    yo, term = k1.step_rows(*rows[:3])
    yw, tw = k1.plain_rows(*rows[:3])
    agree = (term == tw)[0]
    k1_err = (yo[:, agree] - yw[:, agree]).abs().max().item()
    print(f"K1 vs plain on the main path's state, {tab}x{sub} r{ref} B={B}: flag agreement "
          f"{agree.float().mean().item():.6f}, max|err| {k1_err:.3g}", flush=True)
    if agree.float().mean().item() < MIN_FLAG_AGREEMENT or not k1_err <= TOL_STATE:
        fail("K1 disagrees with its plain twin on the main path's state")
    k1_call_ms = time_ms(lambda: k1.step_rows(*rows[:3]), iters=200, warmup=20)
    k1_ms = kernel_ms(lambda: k1.step_rows(*rows[:3]), "fused_step_kernel")
    k1_plain_ms = time_ms(lambda: k1.plain_rows(*rows[:3]), iters=plain_iters, warmup=1)
    k1_bound = bound(4 * (6 + 2 + 2 * cfg.n_planets + 6 + 1) * B,
                     rhs_ops(cfg, tab, sub, B, int(tw.sum())))

    ms_step = ms_total / n_steps
    sps = B * n_steps / (ms_total / 1e3)
    print(f"main path {MAIN_ENV} B={B} {tab}x{sub} r{ref} {n_steps} steps on {card}: "
          f"{sps:.6g} env-steps/s, {ms_step:.5f} ms/step (host wall {wall:.3f} s), "
          f"K3 {k3_ms:.5f} ms/launch on the device ({100 * k3_ms / ms_step:.1f}% of the step; "
          f"{k3_call_ms:.5f} ms per wrapper call back to back), "
          f"plain twin {k3_plain_ms:.3f} ms/step; reward sum {rew_sum.item():.6g}, "
          f"dones {n_done}, terminated {int(term_sum.item())}; launches {launches}; "
          f"after the window sm clock, power: {clocks}", flush=True)
    print(f"  K3 bound: operand list {full.bytes_per_lane()} B/lane-step -> "
          f"{full.bytes_per_lane() * B / HBM_BYTES_PER_S * 1e3:.5f} ms at "
          f"{HBM_BYTES_PER_S / 1e12} TB/s; this data's reads {k3_bytes / B:.1f} B/lane -> "
          f"{k3_bound['bytes']:.5f} ms ({n_done1} lanes done, {n_reached} reached); "
          f"{k3_ops / B:.0f} ops/lane -> {k3_bound['operations']:.5f} ms at "
          f"{F32_OPS_PER_S / 1e12} TFLOP/s f32", flush=True)
    print(f"  K1: {k1_ms:.5f} ms/launch on the device ({k1_call_ms:.5f} ms per wrapper call), "
          f"plain {k1_plain_ms:.3f} ms, bound bytes {k1_bound['bytes']:.5f} ms, operations "
          f"{k1_bound['operations']:.5f} ms", flush=True)
    return dict(launches=launches, k3_err=k3_err, k1_err=k1_err, k3_ms=k3_ms, k3_plain_ms=k3_plain_ms, k3_bound=k3_bound,
                k1_ms=k1_ms, k1_plain_ms=k1_plain_ms, k1_bound=k1_bound, sps=sps,
                ms_step=ms_step, dones=n_done)


def profile_main_path(dev, B, tab, sub, ref, n_steps=8, top=10):
    """Device time by kernel over a short window of the main path
    (torch.profiler, CUDA activity); prints the largest entries."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from space_gym_torch import get_config
    from space_gym_torch.engine import EnvEngine

    eng = EnvEngine(get_config(MAIN_ENV), tableau=tab, substeps=sub, refine_iters=ref, device=dev)
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
    print(f"profile {MAIN_ENV} B={B} {tab}x{sub} r{ref}, {n_steps} steps: kernels busy "
          f"{busy / n_steps / 1e3:.4f} ms/step (profiler on)", flush=True)
    for key, us, count in rows[:top]:
        print(f"  {100 * us / busy:5.1f}%  {us / n_steps / 1e3:.4f} ms/step  "
              f"{count / n_steps:g}/step  {key[:100]}", flush=True)


def kernel_entry(name, source, replaces, launches, err, ms, plain, bnd):
    by = max(bnd, key=bnd.get)
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bnd[by], "bound_by": by, "library_ms": None}


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

    # --------------------------------------------------------- 2. build --
    t0 = time.perf_counter()
    reports = cuda_build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s wall for {sorted(reports)}", flush=True)
    print_build(reports)

    # ---------------------------------------------- 3. kernels vs twins --
    k1_check_err = check_k1(dev, CHECK_B)
    k3_check_err = check_k3(dev, CHECK_B)
    check_engine(dev)

    # ---------------------------------------- 4. the main path, full width --
    # three repeats of the bench configuration in one process: their spread
    # says how far apart two runs may fall; the median run is reported
    runs = sorted((main_path(dev, card, MAIN_B, "bs3", 1, 8, 256) for _ in range(3)),
                  key=lambda r: r["sps"])
    main = runs[1]
    print("main path repeats, env-steps/s: " + ", ".join(f"{r['sps']:.6g}" for r in runs)
          + f"; K3 ms/launch: " + ", ".join(f"{r['k3_ms']:.5f}" for r in runs), flush=True)
    runs.append(main_path(dev, card, MAIN_B, "dp5", 2, 12, 64))
    # max_abs_err of the kernels line: the largest kernel-vs-plain error on
    # the main path's own states (every run above); the B=65536 branch
    # checks of phase 3 are printed above it
    k3_err = max(r["k3_err"] for r in runs)
    k1_err = max(r["k1_err"] for r in runs)
    print(f"max|err| on the main path's states: K3 {k3_err:.3g}, K1 {k1_err:.3g}; in the "
          f"B={CHECK_B} branch checks: K3 {k3_check_err:.3g}, K1 {k1_check_err:.3g}", flush=True)
    profile_main_path(dev, MAIN_B, "bs3", 1, 8)

    # ------------------------------------------------------ 5. the lines --
    kernels = {"kernels": [
        kernel_entry("full_step", "space_gym_torch/csrc/full_step.cu",
                     "space_gym_tpu/ops/pallas_full.py:500", main["launches"]["full_step"],
                     k3_err, main["k3_ms"], main["k3_plain_ms"], main["k3_bound"]),
        kernel_entry("fused_step", "space_gym_torch/csrc/fused_step.cu",
                     "space_gym_tpu/ops/pallas_step.py:300", main["launches"]["fused_step"],
                     k1_err, main["k1_ms"], main["k1_plain_ms"], main["k1_bound"]),
    ]}
    print(json.dumps(kernels), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
