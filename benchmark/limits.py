"""The readings a cell's limits are set from: the program and its control
over many seeds in one process, at the cell's own size.

    python3 -m benchmark.limits --workload goal2p-collect --seeds 11 12 13 --calls 3

For each seed: the cell's set-up, `--calls` calls of its window, then the
check with the control (the reference in the program's place, one precision
below the configuration's).  One JSON line a seed: {"seed", "program": {...},
"control": {...}}; the lines also go to <out>/limits_<workload>.jsonl
(`--out`, build/bench_runs under the checkout by default).
With `--fault <name>` (benchmark/faults.py) the fault is planted under the
whole run and the line holds the program's numbers alone.  The benchmark's
own runs plant no fault and do not run the control.
"""
import argparse
import contextlib
import json
import os
import sys
import time

import torch

from . import faults
from .harness import load_mode
from .registry import Registry


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--calls", type=int, default=3)
    ap.add_argument("--fault", default=None)
    ap.add_argument("--out", default=os.path.join("build", "bench_runs"),
                    help="directory for the lines, relative to the checkout")
    args = ap.parse_args(argv)
    control = not args.fault
    if not torch.cuda.is_available():
        print("FAILED: CUDA is not available", file=sys.stderr)
        return 1
    reg = Registry()
    w = reg.workload(args.workload)
    config, traffic = reg.config(w["config"]), reg.traffic(w["traffic"])
    mode_cls = load_mode(reg, traffic["mode"]).Mode
    device = torch.device("cuda", 0)
    out_dir = os.path.join(os.path.dirname(reg.root), args.out)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"limits_{args.workload}.jsonl"), "a") as f:
        for seed in args.seeds:
            t0 = time.perf_counter()
            mode = mode_cls(config, traffic, seed, device)
            with faults.plant(args.fault) if args.fault else contextlib.nullcontext():
                mode.setup()
                for _ in range(args.calls):
                    mode.call()
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                got = mode.check(control=control)
            line = dict(seed=seed, fault=args.fault, setup_and_calls_s=t1 - t0,
                        check_s=time.perf_counter() - t1,
                        **(got if control else {"program": got}))
            print(json.dumps(line), flush=True)
            f.write(json.dumps(line) + "\n")
            del mode
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
