"""Fused SAC update: the K-minibatch learner phase as ONE CUDA kernel launch.

Port of space_gym_tpu/models/fused_sac.py.  K sequential SAC updates (twin
critic TD loss, Adam, polyak; then the tanh-Gaussian actor loss against the
UPDATED critics, Adam, temperature) run inside one launch of a hand-written
kernel that keeps the whole learner state (weights, targets, Adam moments) in
the card's L2 and streams only the minibatch tiles:

  * K4, `fold=False`: csrc/sac_update.cu, replaces the Pallas kernel
    fused_sac.py:759 (grid (K, 2, T)): each phase of an update reads its
    minibatch tiles from device memory;
  * K5, `fold=True`: csrc/sac_update_fold.cu, replaces fused_sac.py:852/:866
    (grid (K,)): a block fetches its samples once per update, keeps them in
    shared memory for both phases, and copies the next update's samples in
    (cp.async) while it computes this one.

Both share the device code of csrc/sac_update.cuh and give the same bits.
`update_k_reference` is their plain PyTorch version (torch.autograd on the
packed layout); the entry points take it for tensors on the CPU, and launch
the kernel or raise for tensors on a CUDA device.  There is no fallback.

Layout, as in the JAX package: first-layer inputs are padded to IN1=128 rows
(obs | action | 0); the actor's two heads are one (H, 4) matrix [mean(2) |
log_std(2)].  Padded weight rows start at zero and get zero gradients.  The
kernel-layout state is two matrices and their Adam moments:

  WMAT (WROWS, H): [actor w1 | actor w2 | c0 w1 | c0 w2 | c1 w1 | c1 w2 |
                    t0 w1 | t0 w2 | t1 w1 | t1 w2 | actor head^T (4) | pad]
  VEC  (16, H):    row 0 a_b1, 1 a_b2, 2-3 c_b1, 4-5 c_b2, 6-7 t_b1, 8-9 t_b2,
                   10-11 c_w3, 12-13 t_w3,
                   14 misc [a_bh(0:4) | c_b3(4:6) | t_b3(6:8) | log_alpha(8)]

On a CUDA device the kernels update `w`, `vec` and the moments IN PLACE: the
returned FusedState shares the tensors it was given.
"""
from __future__ import annotations

import ctypes
import functools
import math
from types import SimpleNamespace
from typing import NamedTuple

import torch
from torch import nn

from ..utils import cuda_build, profiling
from .replay import Transition, pack_slab, replay_cols, unpack_flat

IN1 = 128     # padded first-layer input width (obs | action | zeros)
NHEAD = 4     # actor head columns: [mean(2) | log_std(2)]
LOG_STD_MIN = -20.0
LOG_STD_MAX = 2.0
B1, B2, EPS = 0.9, 0.999, 1e-8  # optax.adam defaults (eps_root=0)
LOG2PI = 1.8378770664093453  # log(2*pi)
LOG2 = 0.6931471805599453

# Samples per thread block of the CUDA kernels, by hidden width (TS in
# csrc/sac_update.cuh): a block's two (TS, H) float32 activation buffers must
# fit its shared memory.  These are the widths the kernels are built for: at
# H=640 two (32, 640) float32 buffers (160 KB), two bf16 weight stages (40 KB)
# and K5's tile buffers would pass the 227 KB a block may have, and a smaller
# tile is not built (the tensor-core pieces are 32 samples).
KERNEL_TILE = {128: 128, 256: 64, 384: 32, 512: 32}


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


class PackedParams(NamedTuple):
    """SAC learner state in packed layout (all float32)."""

    a_w1: torch.Tensor   # (IN1, H)
    a_b1: torch.Tensor   # (H,)
    a_w2: torch.Tensor   # (H, H)
    a_b2: torch.Tensor   # (H,)
    a_wh: torch.Tensor   # (H, NHEAD)
    a_bh: torch.Tensor   # (NHEAD,)
    c_w1: torch.Tensor   # (2, IN1, H)
    c_b1: torch.Tensor   # (2, H)
    c_w2: torch.Tensor   # (2, H, H)
    c_b2: torch.Tensor   # (2, H)
    c_w3: torch.Tensor   # (2, H)
    c_b3: torch.Tensor   # (2,)
    t_w1: torch.Tensor
    t_b1: torch.Tensor
    t_w2: torch.Tensor
    t_b2: torch.Tensor
    t_w3: torch.Tensor
    t_b3: torch.Tensor
    log_alpha: torch.Tensor  # ()


ACTOR_FIELDS = ("a_w1", "a_b1", "a_w2", "a_b2", "a_wh", "a_bh")
CRITIC_FIELDS = ("c_w1", "c_b1", "c_w2", "c_b2", "c_w3", "c_b3")
TARGET_FIELDS = ("t_w1", "t_b1", "t_w2", "t_b2", "t_w3", "t_b3")


class PackedAdam(NamedTuple):
    """First and second moments for the actor group, the critic group and
    log_alpha (target slots unused, zero), and the shared step count."""

    m: PackedParams
    v: PackedParams
    count: int


class FusedState(NamedTuple):
    """Kernel-layout learner state, kept across train_iters so that nothing
    is packed or unpacked per iteration."""

    w: torch.Tensor      # (WROWS, H) weights (actor | critics | targets | head)
    vec: torch.Tensor    # (VROWS, H) biases / w3 rows / misc
    mw: torch.Tensor     # Adam first moments, same layouts
    mvec: torch.Tensor
    vw: torch.Tensor     # Adam second moments
    vvec: torch.Tensor
    count: int           # optax-equivalent step count


def _sd(x):
    """A module's parameters, or a mapping of the same names, as a dict."""
    return dict(x.state_dict()) if isinstance(x, nn.Module) else dict(x)


def _actor_leaves(actor):
    sd = _sd(actor)
    return (sd["mlp.layers.0.kernel"], sd["mlp.layers.0.bias"],
            sd["mlp.layers.1.kernel"], sd["mlp.layers.1.bias"],
            sd["mean_head.kernel"], sd["mean_head.bias"],
            sd["log_std_head.kernel"], sd["log_std_head.bias"])


def _critic_leaves(critic):
    sd = _sd(critic)
    return [tuple(sd[f"{q}.layers.{i}.{n}"] for i in range(3) for n in ("kernel", "bias"))
            for q in ("q1", "q2")]


class _BF16Dot(torch.autograd.Function):
    """a @ b with both operands rounded to bfloat16 and float32 accumulation,
    forward and backward: what the kernels' `mm_bf16` products compute."""

    @staticmethod
    def forward(ctx, a, b):
        a, b = _bf16(a), _bf16(b)
        ctx.save_for_backward(a, b)
        return a @ b

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = _bf16(g)
        return g @ b.t(), a.t() @ g


class _BF16Round(torch.autograd.Function):
    """Round to bfloat16 and back; the gradient passes unchanged."""

    @staticmethod
    def forward(ctx, x):
        return _bf16(x)

    @staticmethod
    def backward(ctx, g):
        return g


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def _data_mode(f, data, row_idx, K, B, obs_dim, block, wrows):
    """Check the shapes of a launch, in either data mode; returns (W, lanes,
    rpb).  row_idx None: `data` is the packed (K, W, B) minibatch tensor, lanes
    minor (rpb 0).  row_idx given: `data` is the whole (rows, W, lanes) replay
    ring and minibatch k is rows row_idx[k*rpb : (k+1)*rpb], every lane of
    each, rpb = B // lanes.  `block` is the batch tile of the JAX kernels: it
    must divide the batch, or the lanes of a ring, as there."""
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
        lanes, rpb = B, 0
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
    for name, t in (("w", f.w), ("mw", f.mw), ("vw", f.vw)):
        if tuple(t.shape) != (wrows, h):
            raise ValueError(f"{name} must be ({wrows}, {h}), got {tuple(t.shape)}")
    return W, lanes, rpb


def _gathered(data, row_idx, K, B, obs_dim):
    """The (K, B) Transition minibatches that `data` and `row_idx` name: what
    the plain version takes."""
    if row_idx is None:
        flat = data.transpose(1, 2)
    else:
        flat = data[row_idx.long()].transpose(1, 2).reshape(K, B, data.shape[1])
    return unpack_flat(flat.to(torch.float32), obs_dim, 2)


def _kernel_operands(f, data, row_idx, noises, vrows):
    """Check what the CUDA kernels take; returns (tile samples, the six state
    tensors in the kernels' order, row_idx as int32).  Any batch or number of
    lanes: the last tile of a row may be partial."""
    h = f.w.shape[1]
    check_kernel_width(h)
    ts = KERNEL_TILE[h]
    dev = f.w.device
    state = (f.w, f.vec, f.mw, f.vw, f.mvec, f.vvec)
    for t in state + (data, noises):
        if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
            raise TypeError("the CUDA kernel takes contiguous float32 tensors on one device")
    if tuple(f.vec.shape) != (vrows, h):
        raise ValueError(f"vec must be ({vrows}, {h})")
    if row_idx is not None:
        if row_idx.device != dev:
            raise TypeError("row_idx must be on the state's device")
        row_idx = row_idx.to(torch.int32).contiguous()
    return ts, state, row_idx


def _build_width(h: int):
    """All width-dependent layout constants and functions, closed over the
    hidden width `h`.  IN1 and NHEAD stay fixed (obs <= 126, action_dim 2).
    Returned as a namespace; `build(256)` is the flagship layout and is
    re-exported at module level."""
    H = h

    # -------------------------------------------------- modules <-> packed --
    def pack_params(actor, critic, target, log_alpha) -> PackedParams:
        """Modules (or mappings named like their state dicts) -> PackedParams."""
        aw1, ab1, aw2, ab2, awm, abm, aws, abs_ = _actor_leaves(actor)

        def pad1(w):
            out = torch.zeros((IN1, H), dtype=torch.float32, device=w.device)
            out[:w.shape[0]] = w
            return out

        def pack_critic(leaves):
            (w1a, b1a, w2a, b2a, w3a, b3a), (w1b, b1b, w2b, b2b, w3b, b3b) = leaves
            return (
                torch.stack([pad1(w1a), pad1(w1b)]),
                torch.stack([b1a, b1b]),
                torch.stack([w2a, w2b]),
                torch.stack([b2a, b2b]),
                torch.stack([w3a[:, 0], w3b[:, 0]]),
                torch.stack([b3a[0], b3b[0]]),
            )

        cw1, cb1, cw2, cb2, cw3, cb3 = pack_critic(_critic_leaves(critic))
        tw1, tb1, tw2, tb2, tw3, tb3 = pack_critic(_critic_leaves(target))
        packed = PackedParams(
            a_w1=pad1(aw1), a_b1=ab1, a_w2=aw2, a_b2=ab2,
            a_wh=torch.cat([awm, aws], dim=1), a_bh=torch.cat([abm, abs_]),
            c_w1=cw1, c_b1=cb1, c_w2=cw2, c_b2=cb2, c_w3=cw3, c_b3=cb3,
            t_w1=tw1, t_b1=tb1, t_w2=tw2, t_b2=tb2, t_w3=tw3, t_b3=tb3,
            log_alpha=torch.as_tensor(log_alpha, dtype=torch.float32, device=aw1.device),
        )
        return PackedParams(*[x.detach().to(torch.float32).clone() for x in packed])

    def unpack_params(packed: PackedParams, obs_dim: int, action_dim: int = 2):
        """Back to (actor, critic, target) state dicts, the padding sliced
        away, and log_alpha; `module.load_state_dict` takes each."""
        d_a, d_c = obs_dim, obs_dim + action_dim
        actor = {
            "mlp.layers.0.kernel": packed.a_w1[:d_a], "mlp.layers.0.bias": packed.a_b1,
            "mlp.layers.1.kernel": packed.a_w2, "mlp.layers.1.bias": packed.a_b2,
            "mean_head.kernel": packed.a_wh[:, :action_dim],
            "mean_head.bias": packed.a_bh[:action_dim],
            "log_std_head.kernel": packed.a_wh[:, action_dim:],
            "log_std_head.bias": packed.a_bh[action_dim:],
        }

        def unpack_critic(w1, b1, w2, b2, w3, b3):
            out = {}
            for i, q in enumerate(("q1", "q2")):
                out.update({
                    f"{q}.layers.0.kernel": w1[i, :d_c], f"{q}.layers.0.bias": b1[i],
                    f"{q}.layers.1.kernel": w2[i], f"{q}.layers.1.bias": b2[i],
                    f"{q}.layers.2.kernel": w3[i][:, None], f"{q}.layers.2.bias": b3[i][None],
                })
            return out

        critic = unpack_critic(packed.c_w1, packed.c_b1, packed.c_w2, packed.c_b2,
                               packed.c_w3, packed.c_b3)
        target = unpack_critic(packed.t_w1, packed.t_b1, packed.t_w2, packed.t_b2,
                               packed.t_w3, packed.t_b3)
        return actor, critic, target, packed.log_alpha

    # ------------------------------------------------ plain PyTorch version --
    def _pad_x(obs, act, obs_dim):
        x = torch.zeros((obs.shape[0], IN1), dtype=torch.float32, device=obs.device)
        x[:, :obs_dim] = obs[:, :obs_dim]
        if act is not None:
            x[:, obs_dim:obs_dim + act.shape[1]] = act
        return x

    def _sample(mean, log_std_raw, noise):
        log_std = torch.clamp(log_std_raw, LOG_STD_MIN, LOG_STD_MAX)
        pre = mean + torch.exp(log_std) * noise
        a = torch.tanh(pre)
        logp = -0.5 * (noise**2 + 2 * log_std + LOG2PI)
        logp = logp - 2 * (LOG2 - pre - nn.functional.softplus(-2 * pre))
        return a, logp.sum(-1)

    def _adam(g, m, v, lr, t):
        """One Adam step with the bias corrections folded into two scalars
        (algebraically lr * (m / bc1) / (sqrt(v / bc2) + EPS)); b**t is
        exp(t * log b) in float32, as the kernels compute it.  `t` is a
        float32 tensor."""
        m = B1 * m + (1 - B1) * g
        v = B2 * v + (1 - B2) * g * g
        bc1 = 1.0 - torch.exp(t * math.log(B1))
        sb2 = torch.sqrt(1.0 - torch.exp(t * math.log(B2)))
        return -(lr * sb2 / bc1) * m / (torch.sqrt(v) + EPS * sb2), m, v

    def update_k_reference(packed: PackedParams, adam: PackedAdam, batches, noises,
                           obs_dim: int, gamma: float, tau: float, lr: float,
                           target_entropy: float, alpha_floor: float = 0.0,
                           mm_bf16: bool = False):
        """K sequential SAC updates in plain PyTorch (torch.autograd) on the
        packed layout: the plain version of both kernels.  batches: Transition
        with leading (K, B); noises: (K, B, 2, 2) normals, [:, :, 0] for the
        critic's next action, [:, :, 1] for the actor's action.  `mm_bf16`
        rounds where the kernels round: the operands of the matrix products
        and the post-ReLU activations to bfloat16, accumulation in float32.
        Returns (packed', adam', critic_losses (K,), actor_losses (K,))."""
        dot = _BF16Dot.apply if mm_bf16 else torch.matmul
        rnd = _BF16Round.apply if mm_bf16 else (lambda x: x)

        def layer1(x, w1, b1):
            # the obs columns go through the rounded product, the action
            # columns and the bias stay float32 (fused_sac.py:550)
            return (dot(x[:, :obs_dim], w1[:obs_dim]) + x[:, obs_dim:obs_dim + 2] @
                    w1[obs_dim:obs_dim + 2] + b1)

        def actor_fwd(p, x):
            h1 = rnd(torch.relu(dot(x[:, :obs_dim], p.a_w1[:obs_dim]) + p.a_b1))
            h2 = rnd(torch.relu(dot(h1, p.a_w2) + p.a_b2))
            head = dot(h2, p.a_wh) + p.a_bh
            return head[:, :2], head[:, 2:]

        def critic_fwd(w1, b1, w2, b2, w3, b3, x):
            h1 = rnd(torch.relu(layer1(x, w1, b1)))
            h2 = rnd(torch.relu(dot(h1, w2) + b2))
            return dot(h2, w3[:, None])[:, 0] + b3

        def both(ws, x):
            w1, b1, w2, b2, w3, b3 = ws
            return [critic_fwd(w1[c], b1[c], w2[c], b2[c], w3[c], b3[c], x) for c in (0, 1)]

        p = PackedParams(*[x.detach() for x in packed])
        new_m, new_v = dict(adam.m._asdict()), dict(adam.v._asdict())
        count = int(adam.count)
        closses, alosses = [], []
        for k in range(noises.shape[0]):
            batch = Transition(*[x[k] for x in batches])
            noise = noises[k].to(torch.float32)
            t = torch.tensor(float(count + 1), dtype=torch.float32, device=noise.device)
            alpha = torch.exp(p.log_alpha)
            obs = _pad_x(batch.obs, batch.action, obs_dim)
            obs_only = _pad_x(batch.obs, None, obs_dim)

            # -- critic loss --
            with torch.no_grad():
                mean, lsr = actor_fwd(p, _pad_x(batch.next_obs, None, obs_dim))
                na, nlogp = _sample(mean, lsr, noise[:, 0])
                q1t, q2t = both([getattr(p, f) for f in TARGET_FIELDS],
                                _pad_x(batch.next_obs, na, obs_dim))
                tq = batch.reward + gamma * batch.discount * (
                    torch.minimum(q1t, q2t) - alpha * nlogp)

            cw = [getattr(p, f).clone().requires_grad_(True) for f in CRITIC_FIELDS]
            q1, q2 = both(cw, obs)
            closs = ((q1 - tq) ** 2 + (q2 - tq) ** 2).mean()
            cg = torch.autograd.grad(closs, cw)
            upd = {}
            for f, g in zip(CRITIC_FIELDS, cg):
                u, new_m[f], new_v[f] = _adam(g, new_m[f], new_v[f], lr, t)
                upd[f] = getattr(p, f) + u
            p = p._replace(**upd)

            # -- actor loss (against the updated critics) --
            aw = [getattr(p, f).clone().requires_grad_(True) for f in ACTOR_FIELDS]
            p2 = p._replace(**dict(zip(ACTOR_FIELDS, aw)))
            mean, lsr = actor_fwd(p2, obs_only)
            a, logp = _sample(mean, lsr, noise[:, 1])
            q1, q2 = both([getattr(p, f) for f in CRITIC_FIELDS], _pad_x(batch.obs, a, obs_dim))
            aloss = (alpha * logp - torch.minimum(q1, q2)).mean()
            ag = torch.autograd.grad(aloss, aw)
            upd = {}
            for f, g in zip(ACTOR_FIELDS, ag):
                u, new_m[f], new_v[f] = _adam(g, new_m[f], new_v[f], lr, t)
                upd[f] = getattr(p, f) + u
            p = p._replace(**upd)

            # -- temperature --
            g_la = -(logp.detach().mean() + target_entropy)
            u, new_m["log_alpha"], new_v["log_alpha"] = _adam(
                g_la, new_m["log_alpha"], new_v["log_alpha"], lr, t)
            la = p.log_alpha + u
            if alpha_floor > 0:
                la = torch.clamp(la, min=math.log(alpha_floor))

            # -- polyak (after the critic update) --
            new_t = {tf: getattr(p, tf) * (1 - tau) + getattr(p, cf) * tau
                     for tf, cf in zip(TARGET_FIELDS, CRITIC_FIELDS)}
            p = p._replace(log_alpha=la, **new_t)
            count += 1
            closses.append(closs.detach())
            alosses.append(aloss.detach())

        adam = PackedAdam(m=PackedParams(**new_m), v=PackedParams(**new_v), count=count)
        return p, adam, torch.stack(closses), torch.stack(alosses)

    def adam_init(packed: PackedParams) -> PackedAdam:
        zeros = PackedParams(*[torch.zeros_like(x) for x in packed])
        return PackedAdam(m=zeros, v=PackedParams(*[x.clone() for x in zeros]), count=0)

    # ------------------------------------------------------ kernel layout --
    R_AW1 = 0
    R_AW2 = R_AW1 + IN1
    R_CW1 = (R_AW2 + H, R_AW2 + H + IN1 + H)            # per critic
    R_TW1 = (R_CW1[1] + IN1 + H, R_CW1[1] + 2 * (IN1 + H))
    R_AWH = R_TW1[1] + IN1 + H                           # 4 rows of head^T
    WROWS = -(-(R_AWH + NHEAD) // 8) * 8                 # pad to 8 (1928 at H=256)
    V_AB1, V_AB2 = 0, 1
    V_CB1, V_CB2 = (2, 3), (4, 5)
    V_TB1, V_TB2 = (6, 7), (8, 9)
    V_CW3, V_TW3 = (10, 11), (12, 13)
    V_MISC = 14
    VROWS = 16
    # misc-row column spans
    M_ABH = (0, NHEAD)
    M_CB3 = (NHEAD, NHEAD + 2)
    M_TB3 = (NHEAD + 2, NHEAD + 4)
    M_LA = NHEAD + 4

    def pack_wmat(p: PackedParams):
        dev = p.a_w1.device
        w = torch.zeros((WROWS, H), dtype=torch.float32, device=dev)
        w[R_AW1:R_AW1 + IN1] = p.a_w1
        w[R_AW2:R_AW2 + H] = p.a_w2
        for c in (0, 1):
            w[R_CW1[c]:R_CW1[c] + IN1] = p.c_w1[c]
            w[R_CW1[c] + IN1:R_CW1[c] + IN1 + H] = p.c_w2[c]
            w[R_TW1[c]:R_TW1[c] + IN1] = p.t_w1[c]
            w[R_TW1[c] + IN1:R_TW1[c] + IN1 + H] = p.t_w2[c]
        w[R_AWH:R_AWH + NHEAD] = p.a_wh.t()
        v = torch.zeros((VROWS, H), dtype=torch.float32, device=dev)
        v[V_AB1], v[V_AB2] = p.a_b1, p.a_b2
        for c in (0, 1):
            v[V_CB1[c]], v[V_CB2[c]] = p.c_b1[c], p.c_b2[c]
            v[V_TB1[c]], v[V_TB2[c]] = p.t_b1[c], p.t_b2[c]
            v[V_CW3[c]], v[V_TW3[c]] = p.c_w3[c], p.t_w3[c]
        v[V_MISC, M_ABH[0]:M_ABH[1]] = p.a_bh
        v[V_MISC, M_CB3[0]:M_CB3[1]] = p.c_b3
        v[V_MISC, M_TB3[0]:M_TB3[1]] = p.t_b3
        v[V_MISC, M_LA] = p.log_alpha
        return w, v

    def unpack_wmat(w, v) -> PackedParams:
        misc = v[V_MISC]
        return PackedParams(
            a_w1=w[R_AW1:R_AW1 + IN1], a_b1=v[V_AB1],
            a_w2=w[R_AW2:R_AW2 + H], a_b2=v[V_AB2],
            a_wh=w[R_AWH:R_AWH + NHEAD].t(), a_bh=misc[M_ABH[0]:M_ABH[1]],
            c_w1=torch.stack([w[R_CW1[c]:R_CW1[c] + IN1] for c in (0, 1)]),
            c_b1=torch.stack([v[V_CB1[c]] for c in (0, 1)]),
            c_w2=torch.stack([w[R_CW1[c] + IN1:R_CW1[c] + IN1 + H] for c in (0, 1)]),
            c_b2=torch.stack([v[V_CB2[c]] for c in (0, 1)]),
            c_w3=torch.stack([v[V_CW3[c]] for c in (0, 1)]),
            c_b3=misc[M_CB3[0]:M_CB3[1]],
            t_w1=torch.stack([w[R_TW1[c]:R_TW1[c] + IN1] for c in (0, 1)]),
            t_b1=torch.stack([v[V_TB1[c]] for c in (0, 1)]),
            t_w2=torch.stack([w[R_TW1[c] + IN1:R_TW1[c] + IN1 + H] for c in (0, 1)]),
            t_b2=torch.stack([v[V_TB2[c]] for c in (0, 1)]),
            t_w3=torch.stack([v[V_TW3[c]] for c in (0, 1)]),
            t_b3=misc[M_TB3[0]:M_TB3[1]],
            log_alpha=misc[M_LA],
        )

    def fused_init(packed: PackedParams, adam: PackedAdam) -> FusedState:
        w, vec = pack_wmat(packed)
        mw, mvec = pack_wmat(adam.m)
        vw, vvec = pack_wmat(adam.v)
        return FusedState(w=w, vec=vec, mw=mw, mvec=mvec, vw=vw, vvec=vvec,
                          count=int(adam.count))

    def fused_unpack(f: FusedState) -> tuple[PackedParams, PackedAdam]:
        return unpack_wmat(f.w, f.vec), PackedAdam(
            m=unpack_wmat(f.mw, f.mvec), v=unpack_wmat(f.vw, f.vvec), count=int(f.count))

    def unpack_actor(w, vec, obs_dim: int, action_dim: int = 2):
        """The actor's state dict straight from the wmat rows: eight slices
        (views of `w` and `vec`), cheap enough to take every train_iter."""
        misc = vec[V_MISC]
        wh = w[R_AWH:R_AWH + NHEAD]          # (4, H) head^T
        return {
            "mlp.layers.0.kernel": w[R_AW1:R_AW1 + obs_dim], "mlp.layers.0.bias": vec[V_AB1],
            "mlp.layers.1.kernel": w[R_AW2:R_AW2 + H], "mlp.layers.1.bias": vec[V_AB2],
            "mean_head.kernel": wh[:action_dim].t(),
            "mean_head.bias": misc[M_ABH[0]:M_ABH[0] + action_dim],
            "log_std_head.kernel": wh[action_dim:NHEAD].t(),
            "log_std_head.bias": misc[M_ABH[0] + action_dim:M_ABH[1]],
        }

    # ------------------------------------------------------- entry points --
    def _kernel_call(f: FusedState, data, row_idx, noises, *, obs_dim, gamma, tau, lr,
                     target_entropy, alpha_floor=0.0, block=2048, mm_bf16=True, fold=False):
        """Shared launcher of both data modes (`_data_mode`) and both kernels.
        `block` is checked as the JAX kernels check it; the CUDA kernels tile
        the batch, or each ring row, by KERNEL_TILE[H] samples per thread
        block whatever it is, the last tile of a row partial where that does
        not divide it.
        Returns (FusedState', critic_losses (K,), actor_losses (K,))."""
        K, B = noises.shape[0], noises.shape[1]
        if tuple(noises.shape) != (K, B, 2, 2):
            raise ValueError(f"noises must be (K, B, 2, 2), got {tuple(noises.shape)}")
        W, lanes, rpb = _data_mode(f, data, row_idx, K, B, obs_dim, block, WROWS)
        hyper = dict(obs_dim=obs_dim, gamma=gamma, tau=tau, lr=lr,
                     target_entropy=target_entropy, alpha_floor=alpha_floor)

        if f.w.device.type == "cpu":
            packed, adam = fused_unpack(f)
            packed, adam, closs, aloss = update_k_reference(
                packed, adam, _gathered(data, row_idx, K, B, obs_dim), noises,
                mm_bf16=mm_bf16, **hyper)
            return fused_init(packed, adam), closs, aloss
        if f.w.device.type != "cuda":
            raise ValueError(f"unsupported device {f.w.device}")
        closs, aloss = _launch(f, data, row_idx, noises, K, B, W, lanes, rpb, mm_bf16, fold,
                               **hyper)
        return f._replace(count=int(f.count) + K), closs, aloss

    def _launch(f, data, row_idx, noises, K, B, W, lanes, rpb, mm_bf16, fold, *, obs_dim,
                gamma, tau, lr, target_entropy, alpha_floor):
        """Check what the kernel takes, allocate its scratch, launch it."""
        ts, state, row_idx = _kernel_operands(f, data, row_idx, noises, VROWS)
        dev = f.w.device
        tiles = n_tiles(lanes, rpb, ts)
        lib, name = _lib(fold)
        with torch.cuda.device(dev):
            plan = (ctypes.c_int * 2)()
            err = getattr(lib, name + "_plan")(H, W, tiles, int(bool(mm_bf16)), plan)
            if err != 0:
                raise RuntimeError(
                    f"{name}: {_PLAN_ERRORS.get(err, 'CUDA error')} (code {err}) at H={H}, "
                    f"W={W}, {tiles} tiles of {ts} samples")
            grid = plan[0]
            # (K, 4, B): rows 0:2 the critic's normals, 2:4 the actor's
            noise = noises.reshape(K, B, 4).transpose(1, 2).contiguous()
            n1 = obs_dim + 2
            prows = 2 * (n1 + 3 + H) + 1
            partials = torch.empty((grid, prows, H), dtype=torch.float32, device=dev)
            # the products' weights: in float32 mode the transposed W2 copies, in
            # bf16 mode the bf16 shadow of the first 5 (IN1 + H) rows of `w`
            wt = wb = None
            if mm_bf16:
                wb = torch.empty((5 * (IN1 + H), H), dtype=torch.bfloat16, device=dev)
            else:
                wt = torch.empty((3, H, H), dtype=torch.float32, device=dev)
            stash = torch.empty((tiles, 2, ts, H), dtype=torch.float32, device=dev)
            losses = torch.empty((K, 2), dtype=torch.float32, device=dev)
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = getattr(lib, name)(
                *[t.data_ptr() for t in state], data.data_ptr(),
                row_idx.data_ptr() if row_idx is not None else None, noise.data_ptr(),
                losses.data_ptr(), partials.data_ptr(), wt.data_ptr() if wt is not None else None,
                stash.data_ptr(), wb.data_ptr() if wb is not None else None,
                H, K, B, W, lanes, rpb, obs_dim, grid, int(bool(mm_bf16)),
                int(alpha_floor > 0),
                gamma, tau, lr, target_entropy, float(f.count),
                math.log(alpha_floor) if alpha_floor > 0 else 0.0, stream)
        if err != 0:
            raise RuntimeError(f"{name} kernel launch failed: "
                               f"{_PLAN_ERRORS.get(err, 'CUDA error')} (code {err})")
        profiling.launch("sac_update_fold" if fold else "sac_update")
        return losses[:, 0], losses[:, 1]

    def fused_update_k_wmat(f: FusedState, ring, row_idx, noises, **kw):
        """K SAC updates on the cached kernel-layout state, sampling the
        replay ring in the kernel: the trainer's path (models/sac.py)."""
        return _kernel_call(f, ring, row_idx, noises, **kw)

    def fused_update_k_wmat_batches(f: FusedState, batches, noises, **kw):
        """Same, on explicitly gathered (K, B) Transition minibatches."""
        data = pack_slab(batches, kw["obs_dim"], 2).to(torch.float32)  # (K, W, B)
        return _kernel_call(f, data, None, noises, **kw)

    def fused_update_k(packed: PackedParams, adam: PackedAdam, batches, noises,
                       obs_dim: int, gamma: float, tau: float, lr: float,
                       target_entropy: float, alpha_floor: float = 0.0,
                       block: int = 512, mm_bf16: bool = True, fold: bool = False):
        """K sequential SAC updates from the PackedParams boundary (tests and
        one-off callers; the trainer keeps a FusedState).  batches: Transition
        with leading (K, B); noises: (K, B, 2, 2).  Returns (packed', adam',
        critic_losses (K,), actor_losses (K,))."""
        f2, closs, aloss = fused_update_k_wmat_batches(
            fused_init(packed, adam), batches, noises, obs_dim=obs_dim, gamma=gamma, tau=tau,
            lr=lr, target_entropy=target_entropy, alpha_floor=alpha_floor, block=block,
            mm_bf16=mm_bf16, fold=fold)
        return (*fused_unpack(f2), closs, aloss)

    def fused_update_k_from_replay(packed: PackedParams, adam: PackedAdam, data, row_idx,
                                   noises, obs_dim: int, gamma: float, tau: float, lr: float,
                                   target_entropy: float, alpha_floor: float = 0.0,
                                   block: int = 512, mm_bf16: bool = True, fold: bool = False):
        """K sequential SAC updates sampling the replay ring in the kernel,
        from the PackedParams boundary.  data: the packed (rows, W, lanes)
        ring; row_idx: (K * B // lanes,) int32 rows (the caller bounds them by
        `filled`); noises: (K, B, 2, 2)."""
        f2, closs, aloss = fused_update_k_wmat(
            fused_init(packed, adam), data, row_idx, noises, obs_dim=obs_dim, gamma=gamma,
            tau=tau, lr=lr, target_entropy=target_entropy, alpha_floor=alpha_floor,
            block=block, mm_bf16=mm_bf16, fold=fold)
        return (*fused_unpack(f2), closs, aloss)

    ns = SimpleNamespace(**{k: v for k, v in list(locals().items()) if k not in ("ns", "h")})
    ns.PackedParams = PackedParams
    ns.PackedAdam = PackedAdam
    ns.FusedState = FusedState
    ns.IN1 = IN1
    ns.NHEAD = NHEAD
    return ns


_PLAN_ERRORS = {
    -1: "hidden width not built",
    -2: "the kernel's shared memory does not fit one SM",
    -4: "the grid is not the planned one",
    -5: "no scratch for the products' weights of this mode",
}


@functools.cache
def _lib(fold: bool):
    """(ctypes library, entry point name) of K4 (fold False) or K5."""
    name = "sac_update_fold" if fold else "sac_update"
    lib = cuda_build.load(name)
    p, i, fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = getattr(lib, "sg_" + name)
    # six state tensors, data, row_idx, noise, losses, partials, wt, stash, wb; H, K, B, W,
    # lanes, rpb, obs_dim, grid, mm_bf16, has_floor; gamma, tau, lr, target_entropy, count0,
    # log_floor; stream
    fn.argtypes = [p] * 14 + [i] * 10 + [fl] * 6 + [p]
    fn.restype = i
    plan = getattr(lib, "sg_" + name + "_plan")
    # H, W, n_tiles, mm_bf16 -> grid, smem
    plan.argtypes = [i, i, i, i, ctypes.POINTER(ctypes.c_int)]
    plan.restype = i
    return lib, "sg_" + name


@functools.lru_cache(maxsize=None)
def build(h: int = 256):
    """Width-h fused-SAC namespace (memoized; build(256) is module level)."""
    if h % 128:
        raise ValueError(f"fused hidden width must be a multiple of 128, got {h}")
    return _build_width(int(h))


_DEFAULT = build(256)
globals().update({k: v for k, v in vars(_DEFAULT).items() if k != "H"})
H = 256  # default hidden width (SB3-default 2x256 MLPs)
