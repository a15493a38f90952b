"""Run cells in processes of their own, one after another, and report each
metric's median and spread, as a bound is set from them.

    python3 -m benchmark.spread --workload goal2p-collect --seeds 1 2 3 4 5 6 \\
        --sets 2 [--seconds 40] [--trace 0] [--tag name] [--out build/bench_runs]

Each set runs every seed once (the same seeds in every set).  The spread of a
metric in a set is the distance between its first and third quartile, as
`statistics.quantiles(values, n=4)` gives them, as a share of the median.
Every run's result line, exit code, wall time and the end of its standard
error, and the card's temperatures, clocks and power before it, in the
middle of its window and after it (nvidia-smi) go to <out>/<tag>.jsonl under the checkout; the summary is
printed.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import threading
import time

from .registry import HERE, Registry


def spread(values):
    q1, med, q3 = statistics.quantiles(values, n=4)
    return med, (q3 - q1) / abs(med) if med else float("nan")


GPU_QUERY = "temperature.gpu,temperature.memory,clocks.sm,clocks.mem,power.draw,power.limit"


def gpu_reading():
    """The card's temperatures (core, memory), clocks (SM, memory) and power
    now, as nvidia-smi reads them; None where it cannot."""
    try:
        p = subprocess.run(["nvidia-smi", f"--query-gpu={GPU_QUERY}", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=20)
        return p.stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", nargs="+", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--sets", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--tag", default="spread")
    ap.add_argument("--out", default=os.path.join("build", "bench_runs"))
    args = ap.parse_args(argv)
    seconds = args.seconds or Registry().settings()["run_seconds"]
    root = os.path.dirname(HERE)
    out_dir = os.path.join(root, args.out)
    os.makedirs(out_dir, exist_ok=True)
    runs = []
    with open(os.path.join(out_dir, f"{args.tag}.jsonl"), "a") as log:
        for w in args.workload:
            for s in range(args.sets):
                for seed in args.seeds:
                    cmd = [sys.executable, "-m", "benchmark.run", "--workload", w, "--seed",
                           str(seed), "--seconds", str(seconds), "--trace", str(args.trace)]
                    gpu = [gpu_reading()]
                    # one reading in the middle of the window: process start
                    # and set-up take some 17 s
                    mid = threading.Timer(17 + seconds / 2, lambda: gpu.append(gpu_reading()))
                    mid.start()
                    t0 = time.perf_counter()
                    p = subprocess.run(cmd, cwd=root, capture_output=True, text=True)
                    mid.cancel()
                    mid.join()
                    wall = time.perf_counter() - t0
                    lines = p.stdout.strip().splitlines()
                    try:
                        res = json.loads(lines[-1]) if lines else None
                    except json.JSONDecodeError:
                        res = None
                    rec = {"workload": w, "set": s, "seed": seed, "rc": p.returncode,
                           "wall_s": wall, "result": res, "stderr_tail": p.stderr[-3000:],
                           "gpu": gpu + [gpu_reading()]}
                    log.write(json.dumps(rec) + "\n")
                    log.flush()
                    runs.append(rec)
                    m = {k: v["value"] for k, v in (res or {}).get("metrics", {}).items()}
                    checks = {k: v["value"] for k, v in (res or {}).get("checks", {}).items()}
                    print(json.dumps({"workload": w, "set": s, "seed": seed, "rc": p.returncode,
                                      "wall_s": round(wall, 2),
                                      "correct": (res or {}).get("correct"), "metrics": m,
                                      "checks": checks,
                                      "peak": (res or {}).get("device", {}).get(
                                          "memory_peak_bytes"), "gpu": rec["gpu"]}), flush=True)
                    if p.returncode != 0:
                        print(p.stderr[-3000:], flush=True)
    for w in args.workload:
        for s in range(args.sets):
            got = [r["result"] for r in runs if r["workload"] == w and r["set"] == s
                   and r["result"]]
            names = sorted({k for r in got for k in r["metrics"]})
            for k in names:
                vals = [r["metrics"][k]["value"] for r in got if k in r["metrics"]]
                if len(vals) >= 2:
                    med, spr = spread(vals)
                    print(f"{w} set {s} {k}: n={len(vals)} median={med!r} spread={spr!r} "
                          f"min={min(vals)!r} max={max(vals)!r}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
