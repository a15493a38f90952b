"""The host side of the learner kernels K4, K5 and K6: what
csrc/learner_tiles.cuh is to their device code.

K4 and K5 (models/fused_sac.py, csrc/sac_update.cuh) and K6
(models/fused_td3.py, csrc/td3_update.cuh) share one launch: the checks of
the two data modes and of what a kernel takes, the plan of its grid and
thread block clusters, its scratch, the order of its C arguments and the
call.  A `Kernel` says what one C entry point takes beyond that.  `launch`
runs a kernel from the library it is given: the card's (utils/cuda_build),
or the host build of the same source that the CPU tests call
(tests/learner_host.py).  `dispatch` is the entry points' one device
dispatch: the plain version on the CPU, a launch on a CUDA device, an error
anywhere else.  There is no fallback.

A launch of `NAME` calls, in this order (csrc/*_update.cuh, the entry
macros): the six state tensors (w, vec, mw, vw, mvec, vvec), data, row_idx,
the noise (K, n, B), the scratch (`scratch`), then H, K, B, W, lanes, rpb,
obs_dim, grid, cluster, mm_bf16, the kernel's `ints`, its `floats` and the
CUDA stream.  `NAME_plan(H, W, obs_dim, n_tiles, mm_bf16, cmax, out)` gives
the grid, the shared-memory bytes and the cluster size.

Also what the two layouts share outside the kernels: the bf16-rounded
products, the Adam step, the padded first-layer input and the twin critic's
packing.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch
from torch import nn

from ..utils import cuda_build, profiling
from .replay import replay_cols, unpack_flat

IN1 = 128     # padded first-layer input width (obs | action | zeros)
B1, B2, EPS = 0.9, 0.999, 1e-8  # optax.adam defaults (eps_root=0)

# Samples per thread block of the CUDA kernels, by hidden width (TS in
# csrc/learner_tiles.cuh): a block's two (TS, H) float32 activation buffers
# must fit its shared memory.  These are the widths the kernels are built
# for: at H=640 two (32, 640) float32 buffers (160 KB), two bf16 weight
# stages (40 KB) and K5's tile buffers would pass the 227 KB a block may
# have, and a smaller tile is not built (the tensor-core pieces are 32
# samples).
KERNEL_TILE = {128: 128, 256: 64, 384: 32, 512: 32}

# The largest thread block cluster the kernels' plan considers: clusters of
# 8, 4 or 2 blocks sum their gradients on chip and write one slot a cluster
# (csrc/learner_tiles.cuh, plan_launch).  The launches' `cluster_max`
# defaults to it; 1 takes the instantiation without clusters, which checks of
# that path pass.
CLUSTER_MAX = 8

PLAN_ERRORS = {
    -1: "hidden width not built",
    -2: "the kernel's shared memory does not fit one SM",
    -4: "the grid or the cluster is not the planned one",
    -5: "no scratch for the products' weights of this mode",
}


def n_tiles(lanes: int, rpb: int, ts: int) -> int:
    """The kernels' tiles of one minibatch: each of its rpb ring rows (one
    gathered minibatch of lanes = B samples when rpb is 0) cut into
    ceil(lanes / ts) tiles, the last of a row partial when ts does not divide
    the lanes (csrc/learner_tiles.cuh, n_tiles)."""
    return max(rpb, 1) * -(-lanes // ts)


def check_kernel_width(h: int):
    """Raise ValueError unless the CUDA learner kernels are built for width h."""
    if h not in KERNEL_TILE:
        raise ValueError(
            f"the CUDA learner kernels are built for hidden widths {sorted(KERNEL_TILE)}, got "
            f"{h}: a wider layer does not fit a thread block's shared memory at the smallest "
            f"tile of 32 samples (two (32, H) float32 activation buffers and the weight stages "
            f"within 227 KB); run it on the CPU, or unfused")


class Kernel(NamedTuple):
    """A learner kernel's C entry point, and what its launch takes beyond
    what the three share."""

    name: str           # the C entry point; name + "_plan" plans its launch
    library: str        # the cuda_build library that holds it, and its launch count
    shadow_nets: int    # bf16 mode: the shadow `wb` of this many (IN1 + H) row blocks of `w`
    alp: bool           # a (K, grid) scratch of the actor losses' block sums
    ints: tuple         # the int arguments after mm_bf16, by name
    floats: tuple       # the float arguments, by name


SAC = Kernel("sg_sac_update", "sac_update", 5, False, ("has_floor",),
             ("gamma", "tau", "lr", "target_entropy", "count0", "log_floor"))
SAC_FOLD = SAC._replace(name="sg_sac_update_fold", library="sac_update_fold")
TD3 = Kernel("sg_td3_update", "td3_update", 6, True, ("count0", "count_a0", "policy_delay"),
             ("gamma", "tau", "lr", "smooth_std", "smooth_clip"))


def entry_points(lib, kernel: Kernel):
    """(launch, plan): the kernel's two C functions in the ctypes library
    `lib`, their argument types set on first use."""
    fn, plan_fn = getattr(lib, kernel.name), getattr(lib, kernel.name + "_plan")
    if fn.argtypes is None:
        p, i, fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        # the state, data, row_idx, noise and the scratch; H ... mm_bf16 and the ints;
        # the floats; the stream
        fn.argtypes = ([p] * (14 + kernel.alp) + [i] * (10 + len(kernel.ints))
                       + [fl] * len(kernel.floats) + [p])
        fn.restype = i
        # H, W, obs_dim, n_tiles, mm_bf16, largest cluster -> grid, smem, cluster
        plan_fn.argtypes = [i] * 6 + [ctypes.POINTER(ctypes.c_int)]
        plan_fn.restype = i
    return fn, plan_fn


def plan(kernel: Kernel, h: int, W: int, obs_dim: int, tiles: int, mm_bf16: bool,
         cluster_max: int = CLUSTER_MAX, lib=None):
    """(grid, shared-memory bytes, cluster size) of a launch of `kernel` on
    the current device of `lib` (None: the card's build): clusters of at most
    cluster_max blocks (csrc/learner_tiles.cuh, plan_launch).  Raises where
    it cannot launch."""
    lib = cuda_build.load(kernel.library) if lib is None else lib
    out = (ctypes.c_int * 3)()
    err = entry_points(lib, kernel)[1](h, W, obs_dim, tiles, int(bool(mm_bf16)), cluster_max,
                                       out)
    if err != 0:
        raise RuntimeError(f"{kernel.name}: {PLAN_ERRORS.get(err, 'CUDA error')} (code {err}) "
                           f"at H={h}, W={W}, {tiles} tiles of {KERNEL_TILE.get(h)} samples")
    return out[0], out[1], out[2]


def scratch(kernel: Kernel, h: int, K: int, tiles: int, obs_dim: int, grid: int, cluster: int,
            mm_bf16: bool):
    """A launch's scratch in the order of its C arguments: name -> (shape,
    dtype), None where the mode takes none."""
    f32 = torch.float32
    out = {"losses": ((K, 2), f32),
           # one gradient slot a cluster of `cluster` blocks
           "partials": ((grid // cluster, 2 * (obs_dim + 5 + h) + 1, h), f32),
           # float32 mode: the transposed W2 copies
           "wt": None if mm_bf16 else ((3, h, h), f32),
           "stash": ((tiles, 2, KERNEL_TILE[h], h), f32)}
    if kernel.alp:
        out["alp"] = ((K, grid), f32)
    out["wb"] = ((kernel.shadow_nets * (IN1 + h), h), torch.bfloat16) if mm_bf16 else None
    return out


def data_mode(f, data, row_idx, K, B, obs_dim, block, wrows, vrows):
    """Check the shapes of a launch, in either data mode.  row_idx None:
    `data` is the packed (K, W, B) minibatch tensor, lanes minor.  row_idx
    given: `data` is the whole (rows, W, lanes) replay ring and minibatch k
    is rows row_idx[k*rpb : (k+1)*rpb], every lane of each, rpb = B // lanes.
    `block` is the batch tile of the JAX kernels: it must divide the batch,
    or the lanes of a ring, as there."""
    W = data.shape[1]
    if W != replay_cols(obs_dim, 2)[-1]:
        raise ValueError(f"data has {W} rows, obs_dim {obs_dim} packs "
                         f"{replay_cols(obs_dim, 2)[-1]}")
    if row_idx is None:
        if tuple(data.shape) != (K, W, B):
            raise ValueError(f"batches must be (K, W, B) = ({K}, {W}, {B}), "
                             f"got {tuple(data.shape)}")
        if B % min(block, B):
            raise ValueError(f"batch {B} not divisible by block {min(block, B)}")
    else:
        lanes = data.shape[2]
        rpb, rem = divmod(B, lanes)
        if rem:
            raise ValueError(f"batch {B} must be a multiple of lanes {lanes}")
        if tuple(row_idx.shape) != (K * rpb,):
            raise ValueError(f"row_idx {tuple(row_idx.shape)} != ({K * rpb},)")
        if lanes % min(block, lanes):
            raise ValueError(f"lanes {lanes} not divisible by block {min(block, lanes)}")
    h = f.w.shape[1]
    for name, t, rows in (("w", f.w, wrows), ("mw", f.mw, wrows), ("vw", f.vw, wrows),
                          ("vec", f.vec, vrows)):
        if tuple(t.shape) != (rows, h):
            raise ValueError(f"{name} must be ({rows}, {h}), got {tuple(t.shape)}")


def gathered(data, row_idx, K, B, obs_dim):
    """The (K, B) Transition minibatches that `data` and `row_idx` name: what
    the plain version takes."""
    if row_idx is None:
        flat = data.transpose(1, 2)
    else:
        flat = data[row_idx.long()].transpose(1, 2).reshape(K, B, data.shape[1])
    return unpack_flat(flat.to(torch.float32), obs_dim, 2)


def kernel_operands(f, data, row_idx, noises):
    """Check what the CUDA kernels take; returns (the six state tensors in
    the kernels' order, row_idx as int32).  Any batch or number of lanes: the
    last tile of a row may be partial."""
    check_kernel_width(f.w.shape[1])
    dev = f.w.device
    state = (f.w, f.vec, f.mw, f.vw, f.mvec, f.vvec)
    for t in state + (data, noises):
        if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
            raise TypeError("the CUDA kernel takes contiguous float32 tensors on one device")
    if row_idx is not None:
        if row_idx.device != dev:
            raise TypeError("row_idx must be on the state's device")
        row_idx = row_idx.to(torch.int32).contiguous()
    return state, row_idx


def launch(kernel: Kernel, f, data, row_idx, noises, scalars: dict, *, obs_dim: int,
           mm_bf16: bool, cluster_max: int = CLUSTER_MAX, lib=None, empty=torch.empty,
           stream=None):
    """K updates of `kernel` on the state `f`, in place.  `data` and
    `row_idx` in either data mode (data_mode), `noises` the (K, B, ...)
    normals, `scalars` the kernel's ints and floats by name.  Plans the
    launch on the current device of `lib` (None: the card's build), takes the
    scratch from `empty(shape, dtype=, device=)` and calls the kernel on the
    CUDA stream handle `stream`.  Returns (losses (K, 2), grid, cluster
    size); raises where the plan or the launch fails."""
    state, row_idx = kernel_operands(f, data, row_idx, noises)
    lib = cuda_build.load(kernel.library) if lib is None else lib
    h, W = f.w.shape[1], data.shape[1]
    K, B = noises.shape[0], noises.shape[1]
    lanes, rpb = (B, 0) if row_idx is None else (data.shape[2], B // data.shape[2])
    tiles = n_tiles(lanes, rpb, KERNEL_TILE[h])
    grid, _, cluster = plan(kernel, h, W, obs_dim, tiles, mm_bf16, cluster_max, lib)
    # (K, n, B): the n normals of each sample, lanes minor
    noise = noises.reshape(K, B, -1).transpose(1, 2).contiguous()
    bufs = {name: None if s is None else empty(s[0], dtype=s[1], device=f.w.device)
            for name, s in scratch(kernel, h, K, tiles, obs_dim, grid, cluster, mm_bf16).items()}
    err = entry_points(lib, kernel)[0](
        *[None if t is None else t.data_ptr()
          for t in (*state, data, row_idx, noise, *bufs.values())],
        h, K, B, W, lanes, rpb, obs_dim, grid, cluster, int(bool(mm_bf16)),
        *[scalars[n] for n in kernel.ints + kernel.floats], stream)
    if err != 0:
        raise RuntimeError(f"{kernel.name} kernel launch failed: "
                           f"{PLAN_ERRORS.get(err, 'CUDA error')} (code {err})")
    return bufs["losses"], grid, cluster


def dispatch(kernel: Kernel, ns, f, data, row_idx, noises, scalars: dict, counts: dict, *,
             obs_dim: int, block: int, mm_bf16: bool, cluster_max: int, **hyper):
    """K updates from the entry points of the layout namespace `ns`
    (fused_sac.build, fused_td3.build), after data_mode's checks: on the CPU
    the plain version `ns.update_k_reference` on the gathered minibatches;
    on a CUDA device a launch of `kernel` with its `scalars`, which updates
    `f` in place and returns it with its Adam `counts` after; on any other
    device a ValueError.  Returns (state', critic_losses (K,), actor_losses
    (K,))."""
    K, B = noises.shape[0], noises.shape[1]
    data_mode(f, data, row_idx, K, B, obs_dim, block, ns.WROWS, ns.VROWS)
    dev = f.w.device
    if dev.type == "cpu":
        packed, adam = ns.fused_unpack(f)
        packed, adam, closs, aloss = ns.update_k_reference(
            packed, adam, gathered(data, row_idx, K, B, obs_dim), noises, obs_dim=obs_dim,
            mm_bf16=mm_bf16, **hyper)
        return ns.fused_init(packed, adam), closs, aloss
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    with torch.cuda.device(dev):
        losses, _, _ = launch(kernel, f, data, row_idx, noises, scalars, obs_dim=obs_dim,
                              mm_bf16=mm_bf16, cluster_max=cluster_max,
                              stream=torch.cuda.current_stream(dev).cuda_stream)
    profiling.launch(kernel.library)
    return f._replace(**counts), losses[:, 0], losses[:, 1]


# ------------------------------------------------- plain math of both layouts --
class BF16Dot(torch.autograd.Function):
    """a @ b with both operands rounded to bfloat16 and float32 accumulation,
    forward and backward: what the kernels' `mm_bf16` products compute."""

    @staticmethod
    def forward(ctx, a, b):
        a, b = bf16(a), bf16(b)
        ctx.save_for_backward(a, b)
        return a @ b

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = bf16(g)
        return g @ b.t(), a.t() @ g


class BF16Round(torch.autograd.Function):
    """Round to bfloat16 and back; the gradient passes unchanged."""

    @staticmethod
    def forward(ctx, x):
        return bf16(x)

    @staticmethod
    def backward(ctx, g):
        return g


def bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def adam_step(g, m, v, lr, t):
    """One Adam step with the bias corrections folded into two scalars
    (algebraically lr * (m / bc1) / (sqrt(v / bc2) + EPS)); b**t is
    exp(t * log b) in float32, as the kernels compute it.  `t` is a float32
    tensor.  Returns (update, m', v')."""
    m = B1 * m + (1 - B1) * g
    v = B2 * v + (1 - B2) * g * g
    bc1 = 1.0 - torch.exp(t * math.log(B1))
    sb2 = torch.sqrt(1.0 - torch.exp(t * math.log(B2)))
    return -(lr * sb2 / bc1) * m / (torch.sqrt(v) + EPS * sb2), m, v


def pad_x(obs, act, obs_dim):
    """(N, IN1) first-layer inputs: obs | act | zeros."""
    x = torch.zeros((obs.shape[0], IN1), dtype=torch.float32, device=obs.device)
    x[:, :obs_dim] = obs[:, :obs_dim]
    if act is not None:
        x[:, obs_dim:obs_dim + act.shape[1]] = act
    return x


def state_dict(x):
    """A module's parameters, or a mapping of the same names, as a dict."""
    return dict(x.state_dict()) if isinstance(x, nn.Module) else dict(x)


def pad_first_layer(w):
    """A first layer's (inputs, H) kernel, zero rows below to (IN1, H)."""
    out = torch.zeros((IN1, w.shape[1]), dtype=torch.float32, device=w.device)
    out[:w.shape[0]] = w
    return out


def pack_critic(critic):
    """A twin critic (a module, or a mapping named like its state dict) as
    its stacked leaves: w1 (2, IN1, H), b1, w2, b2, w3 (2, H), b3 (2,)."""
    sd = state_dict(critic)
    (w1a, b1a, w2a, b2a, w3a, b3a), (w1b, b1b, w2b, b2b, w3b, b3b) = [
        [sd[f"{q}.layers.{i}.{n}"] for i in range(3) for n in ("kernel", "bias")]
        for q in ("q1", "q2")]
    return (torch.stack([pad_first_layer(w1a), pad_first_layer(w1b)]), torch.stack([b1a, b1b]),
            torch.stack([w2a, w2b]), torch.stack([b2a, b2b]),
            torch.stack([w3a[:, 0], w3b[:, 0]]), torch.stack([b3a[0], b3b[0]]))


def unpack_critic(w1, b1, w2, b2, w3, b3, d_c):
    """The twin critic's state dict from its stacked leaves, the first
    layers' padding sliced to d_c inputs."""
    out = {}
    for i, q in enumerate(("q1", "q2")):
        out.update({
            f"{q}.layers.0.kernel": w1[i, :d_c], f"{q}.layers.0.bias": b1[i],
            f"{q}.layers.1.kernel": w2[i], f"{q}.layers.1.bias": b2[i],
            f"{q}.layers.2.kernel": w3[i][:, None], f"{q}.layers.2.bias": b3[i][None],
        })
    return out
