"""Wrapper of the full env-step kernel (csrc/full_step.cu, kernel K3).

Replaces space_gym_tpu/ops/pallas_full.py::make_full_step (the Pallas kernel
at pallas_full.py:500, pallas_call at :663).  `FullStep.apply` takes the same
(B, rows) operands as the JAX `apply` and returns the same ten component-major
(rows, B) outputs.  On CUDA tensors it launches the kernel (float32 only) or
raises; on CPU tensors it runs the plain twin (ops/full_step_plain.py) in the
tensors' own dtype.  There is no fallback from one to the other.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..envs.config import TASK_GOAL
from ..utils import cuda_build
from .full_step_plain import count_uniform_rows, cs_rows, int_rows, make_full_step_plain
from .kernel_params import TABLEAU_IDS, TASK_IDS, full_params


@functools.cache
def _lib():
    lib = cuda_build.load("full_step")
    p = ctypes.c_void_p
    # params, task, planets, tiles, cols, tableau, 8 inputs, 10 outputs, B, stream
    lib.sg_full_step.argtypes = [p] + [ctypes.c_int] * 5 + [p] * 18 + [ctypes.c_int, p]
    lib.sg_full_step.restype = ctypes.c_int
    return lib


class FullStep:
    """The whole env step for one EnvConfig in one kernel launch.

    `launches` counts kernel launches (never plain-twin calls), over all
    instances; callers reset it to 0 to count one run.
    """

    launches = 0

    def __init__(self, cfg, n_substeps: int = 2, refine_iters: int = 12, tableau: str = "dp5"):
        if tableau not in TABLEAU_IDS:
            raise ValueError(f"unknown tableau {tableau!r}")
        self.cfg = cfg
        self.n_substeps = n_substeps
        self.refine_iters = refine_iters
        self.tableau = tableau
        self.plain = make_full_step_plain(cfg, n_substeps, refine_iters, tableau)
        self.params = full_params(cfg, n_substeps, refine_iters)
        self.n_uniform_rows = count_uniform_rows(cfg)
        self.n_int_rows = int_rows(cfg)
        self.cs_rows = cs_rows(cfg)
        self.n_tiles = cfg.tiling.n_tiles if cfg.task == TASK_GOAL else 0
        self.cols = cfg.tiling.cols if cfg.task == TASK_GOAL else 0

    def in_rows(self):
        """Rows of each component-major input: y, a, p, g, ref, cs, u, ti."""
        return (6, 2, 2 * self.cfg.n_planets, 2, 3, self.cs_rows, self.n_uniform_rows,
                self.n_int_rows)

    def out_rows(self):
        d = self.cfg.obs_dim
        return (6, 2 * self.cfg.n_planets, 2, 3, self.cs_rows, d, d, 1, self.n_int_rows, 3)

    def bytes_per_lane(self) -> int:
        """Device-memory bytes the kernel must move per lane-step: each input
        row read once, each output row written once, 4 bytes each."""
        return 4 * (sum(self.in_rows()) + sum(self.out_rows()))

    def apply(self, y, action, planets, goal, ref_orbit, col_shift, tili, u):
        """(B, rows) operands (planets (B, P, 2); tili int32; u (B, n_u)
        uniforms in [0, 1)) -> the ten component-major outputs."""
        return self.step_rows(*self.to_rows(y, action, planets, goal, ref_orbit, col_shift,
                                            tili, u))

    @staticmethod
    def to_rows(y, action, planets, goal, ref_orbit, col_shift, tili, u):
        """`apply`'s (B, rows) operands -> `step_rows`' contiguous (rows, B)
        operands, in the kernel's order (u before the integer rows)."""
        B = y.shape[0]
        ins = [y, action, planets.reshape(B, -1), goal, ref_orbit, col_shift, u, tili]
        return [t.t().contiguous() for t in ins]

    def step_rows(self, y, a, p, g, r, cs, u, ti):
        """Component-major (rows, B) operands -> outputs; the kernel's own API."""
        ins = (y, a, p, g, r, cs, u, ti)
        B = y.shape[1]
        for t, rows, name in zip(ins, self.in_rows(), ("y", "a", "p", "g", "ref", "cs", "u", "ti")):
            if t.dim() != 2 or tuple(t.shape) != (rows, B):
                raise ValueError(f"{name}: want shape ({rows}, {B}), got {tuple(t.shape)}")
            if t.device != y.device:
                raise ValueError(f"{name} is on {t.device}, y on {y.device}")
        if ti.dtype != torch.int32:
            raise TypeError(f"ti must be int32, got {ti.dtype}")
        for t in ins[:7]:
            if t.dtype != y.dtype:
                raise TypeError(f"float operands must share one dtype, got {t.dtype} and {y.dtype}")
        if y.device.type == "cpu":
            return self.plain(*ins)
        if y.device.type != "cuda":
            raise ValueError(f"unsupported device {y.device}")
        return self._launch(ins, B)

    def _launch(self, ins, B):
        if ins[0].dtype != torch.float32:
            raise TypeError(f"the CUDA kernel takes float32, got {ins[0].dtype}")
        for t in ins:
            if not t.is_contiguous():
                raise ValueError("the CUDA kernel takes contiguous (rows, B) operands")
        dev = ins[0].device
        outs = [torch.empty((rows, B), dtype=torch.float32, device=dev)
                for rows in self.out_rows()[:8]]
        outs += [torch.empty((rows, B), dtype=torch.int32, device=dev)
                 for rows in self.out_rows()[8:]]
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = _lib().sg_full_step(
                ctypes.addressof(self.params), TASK_IDS[self.cfg.task], self.cfg.n_planets,
                self.n_tiles, self.cols, TABLEAU_IDS[self.tableau],
                *[t.data_ptr() for t in ins], *[t.data_ptr() for t in outs], B, stream,
            )
        if err != 0:
            raise RuntimeError(f"full_step kernel launch failed: error {err}")
        FullStep.launches += 1
        return tuple(outs)
