"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload goal2p-collect --seed 7 --seconds 40 --trace 0

`--trace 0` prints the cell's end-to-end metrics, `--trace 1` its per-layer
metrics from a profiled window; both compare the timed path's outputs with
the plain reference and say whether they are `correct` (benchmark/harness.py).
Exits with another code than 0, printing no result, without a card or with
fewer cards than the cell asks for, or if JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    # every cache of the program inside the checkout, at fixed paths
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(root, "build", "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(root, "build", "triton")
    os.environ["USE_FLAX"] = "0"
    from .harness import run
    return run(args, T_START)


if __name__ == "__main__":
    sys.exit(main())
