"""Time variants of the env kernels (K3, K3-hw, K3-tf, and K1 and K2 with
`--sources fused_step,env_step`) against each other in one process on one
card, and check that each writes the first one's bits.

    python3 k3_variants.py NAME=CSRC[:FLAG,FLAG...] ... [--sources full_step,...]
                           [--tableaux bs3,dp5]

Each variant is a csrc/ directory (this checkout's `space_gym_torch/csrc`, a
`git archive` of another commit's, or a copy with an edited body) and nvcc
flags added to the build's own (`-DNAME=VALUE` switches of a trial).  Every
variant's libraries build at once, one nvcc each, into build/k3_variants/;
the ptxas registers and spills of the main path's instantiation (Goal, 2
planets) print per variant.  Then, per tableau (BS3 x 1 / refine 8, DP5 x 2 /
refine 12) and source, on the main path's state at B=262144 after its warm-up
(chip_smoke.warm_engine), every variant runs once through its wrapper
(FullStep, PhysicsStep, EnvStep) with its library in place of the built one,
its outputs compared bit for bit with the first variant's, and is timed in
turns: the variants in order, then in reverse, twice (device ms a launch,
chip_smoke.kernel_device_ms).  The variants of one source must share its C
interface and the meaning of its operands: K3 builds of checkouts before
the raw action came into the kernel read a translated component-major
(2, B) action and write int32 flags, so their bits cannot be compared with
a later build's, nor they be timed on its operands.  Needs a card.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

import torch

import chip_smoke as cs
from space_gym_torch.ops import env_step, full_step, physics_step
from space_gym_torch.utils import cuda_build

CASES = {"bs3": ("bs3", 1, 8), "dp5": ("dp5", 2, 12)}
RNG_OF = {name: rng for rng, name in cs.K3_NAMES.items()}
# K1 and K2: source -> (label in chip_smoke.ENV_CLOCKED, module, C entry point)
TAIL = {"fused_step": ("K1", physics_step, "sg_fused_step"),
        "env_step": ("K2", env_step, "sg_env_step")}


def build(variants, names):
    """{(variant, name): loaded library}, all nvcc processes at once."""
    out_dir = os.path.join(cs.HERE, "build", "k3_variants")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for v, (csrc, flags) in variants.items():
        for name in names:
            lib = os.path.join(out_dir, f"{v}_{name}.so")
            procs[v, name] = (lib, subprocess.Popen(
                [cuda_build._nvcc(), *cuda_build.nvcc_flags(name), *flags, "-o", lib,
                 os.path.join(csrc, f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    cuda_build.build_all(names)  # this checkout's own, for the wrapper's argtypes
    libs = {}
    for (v, name), (lib, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            cs.fail(f"variant {v} of {name} did not build:\n{text[-4000:]}")
        label = TAIL[name][0] if name in TAIL else "K3"
        kernel, targs = cs.ENV_CLOCKED[label][2:4]
        for tab in ("bs3", "dp5"):
            tid = f"{targs}Li{cs.TAB_IDS[tab]}E"
            print(f"{v} {name} {tab}: {cs.ptxas_summary(text, kernel, tid)}", flush=True)
        libs[v, name] = ctypes.CDLL(lib)
    return libs


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="+", help="NAME=CSRC[:FLAG,FLAG...]")
    ap.add_argument("--sources", default=",".join(cs.K3_NAMES.values()))
    ap.add_argument("--tableaux", default="bs3,dp5")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    variants = {}
    for spec in args.variants:
        name, _, rest = spec.partition("=")
        csrc, _, flags = rest.partition(":")
        variants[name] = (os.path.abspath(csrc), [f for f in flags.split(",") if f])
    names = args.sources.split(",")
    libs = build(variants, names)
    dev, card = torch.device("cuda"), cs.card_line()
    times = {}
    for tab in args.tableaux.split(","):
        for name in names:
            rng = RNG_OF.get(name, False)
            eng, g, policy, state, obs = cs.warm_engine(dev, cs.MAIN_B, *CASES[tab], rng)
            full = eng.full
            u = eng.draw_key(g) if rng else torch.rand((cs.MAIN_B, full.n_uniform_rows),
                                                        generator=g, device=dev)
            rows, tail = cs.main_rows(eng, state, policy(g, obs), u)
            if name in TAIL:
                label, module, entry = TAIL[name]
                _, _, call, _ = cs.env_clock_targets(label, eng, *CASES[tab][1:], tab, rows, tail)
                built = module._lib()
            else:
                module, entry, call = full_step, full_step.RNG_MODES[rng][1], (
                    lambda: full.step_rows(*rows))
                built = module._lib(rng)
            kernel = cs.ENV_CLOCKED[TAIL[name][0] if name in TAIL else "K3"][2]
            for v in variants:
                fn = getattr(libs[v, name], entry)
                fn.argtypes, fn.restype = getattr(built, entry).argtypes, ctypes.c_int
            real = module._lib
            try:
                first = None
                for v in variants:
                    module._lib = lambda *a, h=libs[v, name]: h
                    out = [t.clone() for t in call()]
                    module._lib = real
                    first = first or (v, out)
                    if not all(torch.equal(a, b) for a, b in zip(out, first[1])):
                        cs.fail(f"{tab} {name}: variant {v} writes other bits than {first[0]}")
                order = list(variants) + list(variants)[::-1]
                for v in order + order:
                    module._lib = lambda *a, h=libs[v, name]: h
                    times.setdefault((tab, name, v), []).append(cs.kernel_device_ms(call, kernel))
                    module._lib = real
            finally:
                module._lib = real
            print(f"{tab} {name} B={cs.MAIN_B}, ms a launch on the device, in turns; equal "
                  f"bits: " + "; ".join(
                      f"{v} " + ", ".join(f"{t:.5f}" for t in times[tab, name, v])
                      for v in variants), flush=True)
    print(card, flush=True)


if __name__ == "__main__":
    sys.exit(main())
