"""Wrapper of the physics-only kernel (csrc/fused_step.cu, kernel K1).

Replaces space_gym_tpu/ops/pallas_step.py::make_fused_step (Pallas kernel at
pallas_step.py:300, launched through `_grid_call` at :315 -> :262).  It is not
on the engine's main path, but it runs the same physics device function as the
full-step kernel, so the physics can be checked on the card on its own.

`step(y (B,6), action (B,2), planets (B,P,2)) -> (y' (B,6), terminated (B,))`,
as the JAX step.  On CUDA tensors it launches the kernel (float32 only) or
raises; on CPU tensors it runs the plain twin (ops/physics.py).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..utils import cuda_build
from .full_step import FullStep
from .kernel_params import TABLEAU_IDS, phys_params
from .physics import physics_for_config


@functools.cache
def _lib():
    lib = cuda_build.load("fused_step")
    p = ctypes.c_void_p
    # params, planets, tableau, y, a, p, y', terminated, B, stream
    lib.sg_fused_step.argtypes = [p, ctypes.c_int, ctypes.c_int] + [p] * 5 + [ctypes.c_int, p]
    lib.sg_fused_step.restype = ctypes.c_int
    lib.sg_fused_step_info.argtypes = [ctypes.c_int] * 3 + [p]  # planets, tableau, B, out
    lib.sg_fused_step_info.restype = ctypes.c_int
    return lib


class PhysicsStep:
    """Physics of one control step for one EnvConfig.  `launches` counts kernel
    launches over all instances."""

    launches = 0

    def __init__(self, cfg, n_substeps: int = 2, refine_iters: int = 12, tableau: str = "dp5"):
        if tableau not in TABLEAU_IDS:
            raise ValueError(f"unknown tableau {tableau!r}")
        self.cfg = cfg
        self.tableau = tableau
        self.plain_body = physics_for_config(cfg, n_substeps, refine_iters, tableau)
        self.params = phys_params(cfg, n_substeps, refine_iters)

    def plain_rows(self, y, a, p):
        """Plain twin on component-major rows: (6,B), (2,B), (2P,B) ->
        (y' (6,B), terminated (1,B) int32)."""
        n = self.cfg.n_planets
        yf, term = self.plain_body(
            [y[c] for c in range(6)], [p[2 * i] for i in range(n)],
            [p[2 * i + 1] for i in range(n)], a[0], a[1],
        )
        return torch.stack(yf), term.to(torch.int32)[None]

    def step_rows(self, y, a, p):
        """Component-major operands -> (y' (6,B), terminated (1,B) int32)."""
        B = y.shape[1]
        for t, rows, name in ((y, 6, "y"), (a, 2, "a"), (p, 2 * self.cfg.n_planets, "p")):
            if t.dim() != 2 or tuple(t.shape) != (rows, B):
                raise ValueError(f"{name}: want shape ({rows}, {B}), got {tuple(t.shape)}")
            if t.dtype != y.dtype or t.device != y.device:
                raise TypeError(f"{name}: operands must share dtype and device")
        if y.device.type == "cpu":
            return self.plain_rows(y, a, p)
        if y.device.type != "cuda":
            raise ValueError(f"unsupported device {y.device}")
        if y.dtype != torch.float32:
            raise TypeError(f"the CUDA kernel takes float32, got {y.dtype}")
        if not (y.is_contiguous() and a.is_contiguous() and p.is_contiguous()):
            raise ValueError("the CUDA kernel takes contiguous (rows, B) operands")
        yo = torch.empty((6, B), dtype=torch.float32, device=y.device)
        term = torch.empty((1, B), dtype=torch.int32, device=y.device)
        with torch.cuda.device(y.device):
            stream = torch.cuda.current_stream(y.device).cuda_stream
            err = _lib().sg_fused_step(
                ctypes.addressof(self.params), self.cfg.n_planets, TABLEAU_IDS[self.tableau],
                y.data_ptr(), a.data_ptr(), p.data_ptr(), yo.data_ptr(), term.data_ptr(),
                B, stream,
            )
        if err != 0:
            raise RuntimeError(f"fused_step kernel launch failed: error {err}")
        PhysicsStep.launches += 1
        return yo, term

    def kernel_info(self, B):
        """How a launch of B lanes runs on the current CUDA device, as
        FullStep.kernel_info (FullStep.INFO_KEYS)."""
        out = (ctypes.c_int * len(FullStep.INFO_KEYS))()
        err = _lib().sg_fused_step_info(self.cfg.n_planets, TABLEAU_IDS[self.tableau], B, out)
        if err != 0:
            raise RuntimeError(f"fused_step kernel info failed: error {err}")
        return dict(zip(FullStep.INFO_KEYS, out))

    def __call__(self, y, action, planets):
        B = y.shape[0]
        yo, term = self.step_rows(y.t().contiguous(), action.t().contiguous(),
                                  planets.reshape(B, -1).t().contiguous())
        return yo.t(), term[0].bool()
