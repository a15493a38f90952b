"""Wrapper of the env-step kernel (csrc/env_step.cu, kernel K2): physics,
observation and reward in one launch, without resample or reset.

Replaces space_gym_tpu/ops/pallas_step.py::make_fused_env_step (Pallas kernel
at pallas_step.py:370, launched through `_grid_call` at :499 -> :262).  The
observation shows the pre-step goal; the Goal reward includes the sparse bonus
but the kernel returns no `reached`: the engine's tail recomputes it and draws
the new goal (engine/core.py).

`step(y (B,6), action (B,2), planets (B,P,2), goal (B,2), ref_orbit (B,3)) ->
(y' (B,6), terminated (B,), obs (B,D), reward (B,))`, as the JAX step.  On
CUDA tensors it launches the kernel (float32 only) or raises; on CPU tensors
it runs the plain twin, which composes ops/physics.py with the observation and
reward of ops/observe_reward.py.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..utils import cuda_build
from .full_step import FullStep
from .kernel_params import TABLEAU_IDS, TASK_IDS, full_params
from .observe_reward import make_observe_reward
from .physics import physics_for_config


@functools.cache
def _lib():
    lib = cuda_build.load("env_step")
    p = ctypes.c_void_p
    # params, task, planets, tableau, 5 inputs, 4 outputs, B, stream
    lib.sg_env_step.argtypes = [p] + [ctypes.c_int] * 3 + [p] * 9 + [ctypes.c_int, p]
    lib.sg_env_step.restype = ctypes.c_int
    lib.sg_env_step_info.argtypes = [ctypes.c_int] * 4 + [p]  # task, planets, tableau, B, out
    lib.sg_env_step_info.restype = ctypes.c_int
    return lib


class EnvStep:
    """Physics + observation + reward of one control step for one EnvConfig.
    `launches` counts kernel launches over all instances."""

    launches = 0

    def __init__(self, cfg, n_substeps: int = 2, refine_iters: int = 12, tableau: str = "dp5"):
        if tableau not in TABLEAU_IDS:
            raise ValueError(f"unknown tableau {tableau!r}")
        self.cfg = cfg
        self.tableau = tableau
        self.body = physics_for_config(cfg, n_substeps, refine_iters, tableau)
        self.observe, self.reward_fn = make_observe_reward(cfg)
        self.params = full_params(cfg, n_substeps, refine_iters)

    def in_rows(self):
        """Rows of each component-major input: y, a, p, g, ref."""
        return (6, 2, 2 * self.cfg.n_planets, 2, 3)

    def out_rows(self):
        """Rows of each output: y', terminated (int32), obs, reward."""
        return (6, 1, self.cfg.obs_dim, 1)

    def bytes_per_lane(self) -> int:
        """Device-memory bytes the kernel must move per lane-step."""
        return 4 * (sum(self.in_rows()) + sum(self.out_rows()))

    def plain_rows(self, y, a, p, g, r):
        """Plain twin on component-major rows -> (y' (6,B), terminated (1,B)
        int32, obs (D,B), reward (1,B))."""
        n = self.cfg.n_planets
        comp0 = [y[c] for c in range(6)]
        px = [p[2 * i] for i in range(n)]
        py = [p[2 * i + 1] for i in range(n)]
        ref_rows = [r[i] for i in range(3)]
        yf, term = self.body(comp0, px, py, a[0], a[1])
        obs = self.observe(yf, px, py, g[0], g[1], ref_rows)
        rew, _ = self.reward_fn(comp0, yf, px, py, g[0], g[1], ref_rows, a[0], a[1])
        return torch.stack(yf), term.to(torch.int32)[None], torch.stack(obs), rew[None]

    def step_rows(self, y, a, p, g, r):
        """Component-major (rows, B) operands -> outputs; the kernel's own API."""
        ins = (y, a, p, g, r)
        B = y.shape[1]
        for t, rows, name in zip(ins, self.in_rows(), ("y", "a", "p", "g", "ref")):
            if t.dim() != 2 or tuple(t.shape) != (rows, B):
                raise ValueError(f"{name}: want shape ({rows}, {B}), got {tuple(t.shape)}")
            if t.dtype != y.dtype or t.device != y.device:
                raise TypeError(f"{name}: operands must share dtype and device")
        if y.device.type == "cpu":
            return self.plain_rows(*ins)
        if y.device.type != "cuda":
            raise ValueError(f"unsupported device {y.device}")
        if y.dtype != torch.float32:
            raise TypeError(f"the CUDA kernel takes float32, got {y.dtype}")
        if not all(t.is_contiguous() for t in ins):
            raise ValueError("the CUDA kernel takes contiguous (rows, B) operands")
        dev = y.device
        rows = self.out_rows()
        outs = [torch.empty((rows[0], B), dtype=torch.float32, device=dev),
                torch.empty((rows[1], B), dtype=torch.int32, device=dev),
                torch.empty((rows[2], B), dtype=torch.float32, device=dev),
                torch.empty((rows[3], B), dtype=torch.float32, device=dev)]
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = _lib().sg_env_step(
                ctypes.addressof(self.params), TASK_IDS[self.cfg.task], self.cfg.n_planets,
                TABLEAU_IDS[self.tableau], *[t.data_ptr() for t in ins],
                *[t.data_ptr() for t in outs], B, stream,
            )
        if err != 0:
            raise RuntimeError(f"env_step kernel launch failed: error {err}")
        EnvStep.launches += 1
        return tuple(outs)

    def kernel_info(self, B):
        """How a launch of B lanes runs on the current CUDA device, as
        FullStep.kernel_info (FullStep.INFO_KEYS)."""
        out = (ctypes.c_int * len(FullStep.INFO_KEYS))()
        err = _lib().sg_env_step_info(TASK_IDS[self.cfg.task], self.cfg.n_planets,
                                      TABLEAU_IDS[self.tableau], B, out)
        if err != 0:
            raise RuntimeError(f"env_step kernel info failed: error {err}")
        return dict(zip(FullStep.INFO_KEYS, out))

    def __call__(self, y, action, planets, goal, ref_orbit):
        B = y.shape[0]
        ins = [y, action, planets.reshape(B, -1), goal, ref_orbit]
        yo, term, obs, rew = self.step_rows(*[t.t().contiguous() for t in ins])
        return yo.t(), term[0].bool(), obs.t(), rew[0]
