"""Wrapper of the full env-step kernel (csrc/full_step.cuh) in its three
modes: K3 with the uniforms read from memory (csrc/full_step.cu), K3-tf with
in-kernel threefry (csrc/full_step_threefry.cu) and K3-hw with in-kernel
Philox (csrc/full_step_philox.cu).

Replaces space_gym_tpu/ops/pallas_full.py::make_full_step (the Pallas kernel
at pallas_full.py:500, pallas_call at :663) with `in_kernel_rng` False,
"threefry" and "hw".  `FullStep.apply` takes the (B, rows) operands of the
JAX `apply` but the action and returns the same ten component-major (rows, B)
outputs, the flags as torch.bool where the JAX kernel has int32.  The action is the
policy's, lane-major (B, 2): for a continuous config the raw action, which
the kernel translates as the engine's `_translate_action` does (clamp to
[-1, 1], thrust (a0 + 1) / 2), for a discrete one the action table's rows.
So neither the action nor the flags pass through a conversion kernel.  With
an in-kernel source the `u` operand is the (2,) int32 tensor of the two key
words' bits (ops/rng_plain.py::key_words), on the operands' device, and
`lane0` is the global index of lane 0 where the lanes are split over ranks
(parallel/mesh.py): the generators draw for lanes lane0 .. lane0 + B - 1, so
a rank's block is its columns of the one-process block.  On CUDA
tensors it launches the kernel (float32 only) or raises; on CPU tensors it
runs the plain twin (ops/full_step_plain.py), on the block of uniforms that
ops/rng_plain.py makes from the key in the in-kernel modes.  There is no
fallback from one to the other.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..envs.config import TASK_GOAL
from ..utils import cuda_build, profiling
from . import rng_plain
from .full_step_plain import count_uniform_rows, cs_rows, int_rows, make_full_step_plain
from .kernel_params import TABLEAU_IDS, TASK_IDS, full_params


# in_kernel_rng -> (library, entry point, fill entry point, plain generator)
RNG_MODES = {
    False: ("full_step", "sg_full_step", None, None),
    "threefry": ("full_step_threefry", "sg_full_step_threefry", "sg_fill_uniforms_threefry",
                 rng_plain.threefry_uniform_matrix),
    "philox": ("full_step_philox", "sg_full_step_philox", "sg_fill_uniforms_philox",
               rng_plain.philox_uniform_matrix),
}


def normalize_rng_mode(in_kernel_rng):
    """`True` is an alias of "threefry", as in the JAX engine."""
    mode = "threefry" if in_kernel_rng is True else in_kernel_rng
    if mode not in RNG_MODES:
        raise ValueError(f"in_kernel_rng must be False, True, 'threefry' or 'philox', "
                         f"got {in_kernel_rng!r}")
    return mode


@functools.cache
def _lib(mode):
    name, entry, fill, _ = RNG_MODES[mode]
    lib = cuda_build.load(name)
    p, i = ctypes.c_void_p, ctypes.c_int
    # params, task, planets, tiles, cols, tableau, y a p g ref cs u, n_u, ti,
    # 10 outputs, B, stream
    fn = getattr(lib, entry)
    fn.argtypes = [p] + [i] * 5 + [p] * 7 + [i] + [p] * 11 + [i, p]
    fn.restype = i
    at = getattr(lib, entry + "_at")  # the same with lane0 before the stream
    at.argtypes = [p] + [i] * 5 + [p] * 7 + [i] + [p] * 11 + [i, i, p]
    at.restype = i
    info = getattr(lib, entry + "_info")
    info.argtypes = [i] * 6 + [p]  # task, planets, tiles, cols, tableau, B, out
    info.restype = i
    if fill:
        fl = getattr(lib, fill)
        fl.argtypes = [p, p, i, i, p]  # key, out, n_u, B, stream
        fl.restype = i
        fa = getattr(lib, fill + "_at")
        fa.argtypes = [p, p, i, i, i, p]  # key, out, n_u, B, lane0, stream
        fa.restype = i
    return lib


class FullStep:
    """The whole env step for one EnvConfig in one kernel launch.

    `in_kernel_rng`: False reads the (n_u, B) uniforms from memory;
    "threefry" (or True) and "philox" compute them in the kernel from two key
    words.  A launch (never a plain-twin call) is counted under its
    kernel's name (`RNG_MODES`: full_step, full_step_threefry,
    full_step_philox) in `utils/profiling.py`'s counts; one made while a CUDA
    graph is captured is counted by the graph, once a replay.
    """

    def __init__(self, cfg, n_substeps: int = 2, refine_iters: int = 12, tableau: str = "dp5",
                 in_kernel_rng=False):
        if tableau not in TABLEAU_IDS:
            raise ValueError(f"unknown tableau {tableau!r}")
        self.rng = normalize_rng_mode(in_kernel_rng)
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
        """Rows of each input: y, a, p, g, ref, cs, u, ti (the action's are its
        (B, 2) columns); no u rows where the kernel computes its uniforms
        (the key is 8 bytes a launch)."""
        return (6, 2, 2 * self.cfg.n_planets, 2, 3, self.cs_rows,
                0 if self.rng else self.n_uniform_rows, self.n_int_rows)

    def out_rows(self):
        d = self.cfg.obs_dim
        return (6, 2 * self.cfg.n_planets, 2, 3, self.cs_rows, d, d, 1, self.n_int_rows, 3)

    def bytes_per_lane(self) -> int:
        """Device-memory bytes the kernel must move per lane-step: each input
        row read once, each output row written once, 4 bytes each but the
        flags' one."""
        flags = self.out_rows()[-1]
        return 4 * (sum(self.in_rows()) + sum(self.out_rows()) - flags) + flags

    def apply(self, y, action, planets, goal, ref_orbit, col_shift, tili, u, lane0: int = 0):
        """(B, rows) operands (action (B, 2), see the module docstring;
        planets (B, P, 2); tili int32; u (B, n_u) uniforms in [0, 1), or the
        (2,) key words in an in-kernel mode) -> the ten component-major
        outputs."""
        return self.step_rows(*self.to_rows(y, action, planets, goal, ref_orbit, col_shift,
                                            tili, u), lane0=lane0)

    @staticmethod
    def to_rows(y, action, planets, goal, ref_orbit, col_shift, tili, u):
        """`apply`'s (B, rows) operands -> `step_rows`' contiguous operands,
        (rows, B) but the (B, 2) action, in the kernel's order (u before the
        integer rows); a (2,) key passes as it is."""
        B = y.shape[0]
        ins = [y, planets.reshape(B, -1), goal, ref_orbit, col_shift, u, tili]
        rows = [t if t.dim() == 1 else t.t().contiguous() for t in ins]
        return [rows[0], action.contiguous(), *rows[1:]]

    @staticmethod
    def lane_block(ins, start: int, stop: int | None = None):
        """`step_rows`' operands of lanes start .. stop - 1, contiguous; a
        (2,) key passes as it is."""
        return [t if t.dim() == 1 else (t[start:stop] if i == 1 else t[:, start:stop]).contiguous()
                for i, t in enumerate(ins)]

    def step_rows(self, y, a, p, g, r, cs, u, ti, lane0: int = 0):
        """Component-major (rows, B) operands but the lane-major (B, 2)
        action `a` -> outputs; the kernel's own API.  `lane0` (in-kernel
        modes only) is the global index of lane 0."""
        ins = (y, a, p, g, r, cs, u, ti)
        B = y.shape[1]
        if lane0 < 0 or (lane0 and not self.rng):
            raise ValueError(f"lane0={lane0}: a lane offset needs an in-kernel generator "
                             "(a bulk draw is the rank's own block)")
        for t, rows, name in zip(ins, self.in_rows(), ("y", "a", "p", "g", "ref", "cs", "u", "ti")):
            want = (B, rows) if name == "a" else (rows, B)
            if name == "u" and self.rng:
                if tuple(t.shape) != (2,) or t.dtype != torch.int32:
                    raise TypeError(f"in_kernel_rng={self.rng!r} takes the key as a (2,) int32 "
                                    f"tensor, got {tuple(t.shape)} {t.dtype}")
            elif tuple(t.shape) != want:
                raise ValueError(f"{name}: want shape {want}, got {tuple(t.shape)}")
            if t.device != y.device:
                raise ValueError(f"{name} is on {t.device}, y on {y.device}")
        if ti.dtype != torch.int32:
            raise TypeError(f"ti must be int32, got {ti.dtype}")
        for t in ins[:6] + (() if self.rng else (u,)):
            if t.dtype != y.dtype:
                raise TypeError(f"float operands must share one dtype, got {t.dtype} and {y.dtype}")
        if self.rng:
            if y.dtype != torch.float32:
                raise TypeError(f"in_kernel_rng={self.rng!r} draws float32, got {y.dtype} operands")
            if (lane0 + B) * self.n_uniform_rows >= 1 << 32:
                raise ValueError(f"(lane0 + B) * n_u = {(lane0 + B) * self.n_uniform_rows} "
                                 "does not fit the generators' 32-bit counter")
        if y.device.type == "cpu":
            if self.rng:
                ins = ins[:6] + (self.plain_uniforms(u, B, lane0), ti)
            return self.plain(*ins)
        if y.device.type != "cuda":
            raise ValueError(f"unsupported device {y.device}")
        return self._launch(ins, B, lane0)

    def plain_uniforms(self, key, B, lane0: int = 0):
        """The (n_u, B) block the kernel draws from `key` in this mode for
        the lanes from global lane `lane0` on, from the plain generator
        (ops/rng_plain.py)."""
        return RNG_MODES[self.rng][3](key, B, self.n_uniform_rows, lane0)

    def kernel_uniforms(self, key, B, lane0: int = 0):
        """The same block written by a kernel through the device function the
        full-step kernel draws with; `key` (2,) int32 on a CUDA device."""
        if not self.rng:
            raise ValueError("no generator runs in the kernel with in_kernel_rng=False")
        if key.device.type != "cuda" or tuple(key.shape) != (2,) or key.dtype != torch.int32:
            raise TypeError("the key must be a (2,) int32 tensor on a CUDA device")
        out = torch.empty((self.n_uniform_rows, B), dtype=torch.float32, device=key.device)
        with torch.cuda.device(key.device):
            stream = torch.cuda.current_stream(key.device).cuda_stream
            fill = getattr(_lib(self.rng), RNG_MODES[self.rng][2] + "_at")
            err = fill(key.data_ptr(), out.data_ptr(), self.n_uniform_rows, B, lane0, stream)
        if err != 0:
            raise RuntimeError(f"fill_uniforms kernel launch failed: error {err}")
        return out

    INFO_KEYS = ("registers", "local_bytes", "blocks_per_sm", "sms", "grid", "threads",
                 "smem_bytes", "tiles")

    def kernel_info(self, B):
        """How a launch of B lanes runs on the current CUDA device: the
        instantiation's registers and local memory (stack frame and spills)
        per thread, resident blocks per SM, SMs, grid, threads a block,
        dynamic shared memory and lane tiles (INFO_KEYS)."""
        out = (ctypes.c_int * len(self.INFO_KEYS))()
        err = getattr(_lib(self.rng), RNG_MODES[self.rng][1] + "_info")(
            TASK_IDS[self.cfg.task], self.cfg.n_planets, self.n_tiles, self.cols,
            TABLEAU_IDS[self.tableau], B, out)
        if err != 0:
            raise RuntimeError(f"full_step kernel info failed: error {err}")
        return dict(zip(self.INFO_KEYS, out))

    def _launch(self, ins, B, lane0=0):
        if ins[0].dtype != torch.float32:
            raise TypeError(f"the CUDA kernel takes float32, got {ins[0].dtype}")
        for t in ins:
            if not t.is_contiguous():
                raise ValueError("the CUDA kernel takes contiguous (rows, B) operands")
        dev = ins[0].device
        outs = [torch.empty((rows, B), dtype=torch.float32, device=dev)
                for rows in self.out_rows()[:8]]
        outs += [torch.empty((self.n_int_rows, B), dtype=torch.int32, device=dev),
                 torch.empty((3, B), dtype=torch.bool, device=dev)]
        if ins[1].data_ptr() % 8:  # the kernel reads a lane's action as one float2
            ins = (ins[0], ins[1].clone(), *ins[2:])
        ptrs = [t.data_ptr() for t in ins]
        # lane0 = 0 keeps the entry point without the offset, whose C interface
        # builds of earlier checkouts share (k3_variants.py)
        entry = RNG_MODES[self.rng][1] + ("_at" if lane0 else "")
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = getattr(_lib(self.rng), entry)(
                ctypes.addressof(self.params), TASK_IDS[self.cfg.task], self.cfg.n_planets,
                self.n_tiles, self.cols, TABLEAU_IDS[self.tableau],
                *ptrs[:7], self.n_uniform_rows, ptrs[7], *[t.data_ptr() for t in outs], B,
                *((lane0,) if lane0 else ()), stream,
            )
        if err != 0:
            raise RuntimeError(f"full_step kernel launch failed: error {err}")
        profiling.launch(RNG_MODES[self.rng][0])
        return tuple(outs)
