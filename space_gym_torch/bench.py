"""Headline benchmark of the port: vectorized env-steps/s on GoalContinuous2P-v0.

    python -m space_gym_torch.bench                   # on the card
    python -m space_gym_torch.bench --rng philox
    python -m space_gym_torch.bench --device cpu --smoke

The port's counterpart of bench.py: `EnvEngine(physics="kernel",
fuse="full")`, float32, a uniform random policy, B=262144 lanes and BS3 x 1
substep / refine 8 by default, with only the reward and done sums carried
out of the rollout (no trajectory).  On the card the rollout of `--steps`
steps is one captured CUDA graph (utils/graphs.py), timed with CUDA events
after a warm-up rollout that captures it; on the CPU (`--device cpu`) it is
a loop timed by the host clock.

Prints ONE JSON line in bench.py's shape: metric, value (the best repeat's
env-steps/s), unit, value_mean, value_std, repeat_values, batch, warmup_s;
and what ran: env, tableau, substeps, refine, rng (the source of K3's
uniforms), steps, device, and device_kind with the card's name and power
limit (`nvidia-smi`).  It carries no vs_baseline and no roofline: bench.py's
numbers are a TPU's.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

ENV_ID = "GoalContinuous2P-v0"
METRIC = "env_steps_per_s_goal2p"
RNG = {"bulk": False, "threefry": "threefry", "philox": "philox"}


def device_kind(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         f"--id={device.index or 0}"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def measure(args) -> dict:
    from . import get_config
    from .engine import EnvEngine

    eng = EnvEngine(get_config(ENV_ID), tableau=args.tableau, substeps=args.substeps,
                    refine_iters=args.refine, in_kernel_rng=RNG[args.rng], device=args.device)
    dev = eng.device
    g = eng.generator(0)
    policy = eng.random_policy()
    state, obs = eng.init(args.batch, g)

    if dev.type == "cuda":
        run = eng.capture_rollout(policy, args.steps, g, trajectory=False)
    else:
        def run(state, obs):
            return eng.rollout(state, obs, policy, args.steps, g, trajectory=False)

    def timed():
        if dev.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = run(state, obs)
            end.record()
            torch.cuda.synchronize(dev)
            return out, start.elapsed_time(end) / 1e3
        t0 = time.perf_counter()
        out = run(state, obs)
        float(out[2].reward_sum)
        return out, time.perf_counter() - t0

    t0 = time.perf_counter()
    _, _, traj = run(state, obs)  # builds the kernel and captures the graph
    float(traj.reward_sum)
    warmup_s = time.perf_counter() - t0
    vals = []
    for _ in range(args.repeats):
        (state, obs, traj), dt = timed()
        vals.append(args.batch * args.steps / dt)
        if not np.isfinite(float(traj.reward_sum)):
            raise RuntimeError("reward sum not finite")
    return {
        "metric": METRIC,
        "value": max(vals),
        "unit": "steps/s",
        "value_mean": float(np.mean(vals)),
        "value_std": float(np.std(vals)),
        "repeat_values": vals,
        "batch": args.batch,
        "warmup_s": warmup_s,
        "env": ENV_ID,
        "tableau": eng.tableau,
        "substeps": eng.substeps,
        "refine": eng.refine_iters,
        "rng": args.rng,
        "steps": args.steps,
        "device": str(dev),
        "device_kind": device_kind(dev),
    }


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="env-steps/s of the port's main path")
    ap.add_argument("--steps", type=int, default=256)
    ap.add_argument("--tableau", default="bs3", choices=["dp5", "bs3"])
    ap.add_argument("--substeps", type=int, default=1)
    ap.add_argument("--refine", type=int, default=8, help="event-refinement iterations")
    ap.add_argument("--rng", default="bulk", choices=sorted(RNG),
                    help="K3's uniforms: one bulk torch.rand draw a step, or in-kernel "
                         "threefry or Philox from two key words")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--device", default=None, help="torch device; default the card")
    ap.add_argument("--smoke", action="store_true", help="a small run (B=512, 16 steps, 1 repeat)")
    args = ap.parse_args(argv)
    args.batch = 512 if args.smoke else 262144
    if args.smoke:
        args.steps, args.repeats = 16, 1
    return args


def main(argv=None):
    print(json.dumps(measure(parse_args(argv))), flush=True)


if __name__ == "__main__":
    main()
