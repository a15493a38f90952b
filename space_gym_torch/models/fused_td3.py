"""Fused TD3 update: the K-minibatch learner phase as ONE CUDA kernel launch.

Port of space_gym_tpu/models/fused_td3.py, the twin of models/fused_sac.py
for TD3.  K sequential TD3 updates run inside one launch of a hand-written
kernel, K6 (csrc/td3_update.cu, replaces the Pallas kernel fused_td3.py:421),
which keeps the whole learner state (actor, critics, BOTH target networks,
Adam moments) in the card's L2 and streams only the minibatch tiles.  It
shares its tile code with the SAC kernels (csrc/learner_tiles.cuh), and in
bf16 mode (`mm_bf16=True`, the trainer's) their tensor-core products
(csrc/learner_mma.cuh).

What an update is (models/td3.py::_update_once):
  * the critics' target uses the TARGET ACTOR and clipped Gaussian smoothing
    noise: next_a = clip(actor_t(x') + clip(eps * std, +-c), -1, 1);
  * the actor's loss is -q1 (critic 0 only) against the UPDATED critic, and
    is reported for every update;
  * the actor's Adam step and BOTH polyak steps happen only on every
    `policy_delay`-th update (when the updates so far are a multiple of it);
  * the actor's Adam count advances only on applied steps.

`update_k_reference` is the kernel's plain PyTorch version (torch.autograd on
the packed layout); the entry points take it for tensors on the CPU, and
launch the kernel or raise for tensors on a CUDA device.  There is no
fallback.

Kernel layout, as in the JAX package (IN1 = 128 padded first-layer rows):

  WMAT (WROWS, H): [actor w1 | actor w2 | target actor w1 | w2 | c0 w1 | c0 w2
                    | c1 w1 | c1 w2 | t0 | t1 | actor head^T (2) |
                    target actor head^T (2) | pad]     (2312 rows at H=256)
  VEC  (24, H):    row 0 a_b1, 1 a_b2, 2 ta_b1, 3 ta_b2, 4-5 c_b1, 6-7 c_b2,
                   8-9 t_b1, 10-11 t_b2, 12-13 c_w3, 14-15 t_w3,
                   16 misc [a_bh(0:2) | ta_bh(2:4) | c_b3(4:6) | t_b3(6:8)]

On a CUDA device the kernel updates `w`, `vec` and the moments IN PLACE: the
returned FusedState shares the tensors it was given.

Counts (utils/profiling.py): each call of the entry points, on either
device, adds its K updates to `td3.critic_updates` and its delayed ones
(`applied_steps`) to `td3.actor_updates`; a launch of K6 adds 1 to
`td3_update`.
"""
from __future__ import annotations

import ctypes
import functools
from types import SimpleNamespace
from typing import NamedTuple

import torch

from ..utils import cuda_build, profiling
from .fused_sac import (KERNEL_TILE, _BF16Dot, _BF16Round, _PLAN_ERRORS, _adam,  # noqa: F401
                        _critic_leaves, _data_mode, _gathered, _kernel_operands, _pad_x, _sd,
                        n_tiles)
from .replay import Transition, pack_slab

IN1 = 128     # padded first-layer input width (obs | action | zeros)
AH = 2        # actor head columns (deterministic: the action only)


class PackedParams(NamedTuple):
    """TD3 learner state in packed layout (all float32)."""

    a_w1: torch.Tensor    # (IN1, H)
    a_b1: torch.Tensor    # (H,)
    a_w2: torch.Tensor    # (H, H)
    a_b2: torch.Tensor    # (H,)
    a_wh: torch.Tensor    # (H, AH)
    a_bh: torch.Tensor    # (AH,)
    ta_w1: torch.Tensor   # the target actor, same shapes
    ta_b1: torch.Tensor
    ta_w2: torch.Tensor
    ta_b2: torch.Tensor
    ta_wh: torch.Tensor
    ta_bh: torch.Tensor
    c_w1: torch.Tensor    # (2, IN1, H)
    c_b1: torch.Tensor    # (2, H)
    c_w2: torch.Tensor    # (2, H, H)
    c_b2: torch.Tensor    # (2, H)
    c_w3: torch.Tensor    # (2, H)
    c_b3: torch.Tensor    # (2,)
    t_w1: torch.Tensor    # the target critics, same shapes
    t_b1: torch.Tensor
    t_w2: torch.Tensor
    t_b2: torch.Tensor
    t_w3: torch.Tensor
    t_b3: torch.Tensor


ACTOR_FIELDS = ("a_w1", "a_b1", "a_w2", "a_b2", "a_wh", "a_bh")
TACTOR_FIELDS = ("ta_w1", "ta_b1", "ta_w2", "ta_b2", "ta_wh", "ta_bh")
CRITIC_FIELDS = ("c_w1", "c_b1", "c_w2", "c_b2", "c_w3", "c_b3")
TARGET_FIELDS = ("t_w1", "t_b1", "t_w2", "t_b2", "t_w3", "t_b3")


class PackedAdam(NamedTuple):
    """First and second moments for the actor and critic groups (the targets'
    slots unused, zero), and the two step counts."""

    m: PackedParams
    v: PackedParams
    count: int      # the critics' Adam count == number of updates
    count_a: int    # the actor's Adam count (delayed steps only)


class FusedState(NamedTuple):
    """Kernel-layout TD3 learner state, kept across train_iters."""

    w: torch.Tensor      # (WROWS, H)
    vec: torch.Tensor    # (VROWS, H)
    mw: torch.Tensor     # Adam first moments, same layouts
    mvec: torch.Tensor
    vw: torch.Tensor     # Adam second moments
    vvec: torch.Tensor
    count: int           # the critics' Adam count == number of updates
    count_a: int         # the actor's Adam count


def _actor_leaves(actor):
    sd = _sd(actor)
    return (sd["mlp.layers.0.kernel"], sd["mlp.layers.0.bias"],
            sd["mlp.layers.1.kernel"], sd["mlp.layers.1.bias"],
            sd["head.kernel"], sd["head.bias"])


def applied_steps(count: int, k: int, policy_delay: int) -> int:
    """How many of the updates count .. count + k - 1 are delayed ones, i.e.
    multiples of `policy_delay` (fused_td3.py:783-785)."""
    first = (-count) % policy_delay
    return max(0, (k - first + policy_delay - 1) // policy_delay)


def _build_width(h: int):
    """All width-dependent layout constants and functions, closed over the
    hidden width `h` (see fused_sac._build_width).  `build(256)` is the
    flagship layout and is re-exported at module level."""
    H = h

    # -------------------------------------------------- modules <-> packed --
    def _pad1(w):
        out = torch.zeros((IN1, H), dtype=torch.float32, device=w.device)
        out[:w.shape[0]] = w
        return out

    def _pack_critic(leaves):
        (w1a, b1a, w2a, b2a, w3a, b3a), (w1b, b1b, w2b, b2b, w3b, b3b) = leaves
        return (
            torch.stack([_pad1(w1a), _pad1(w1b)]),
            torch.stack([b1a, b1b]),
            torch.stack([w2a, w2b]),
            torch.stack([b2a, b2b]),
            torch.stack([w3a[:, 0], w3b[:, 0]]),
            torch.stack([b3a[0], b3b[0]]),
        )

    def pack_params(actor, target_actor, critic, target_critic) -> PackedParams:
        """Modules (or mappings named like their state dicts) -> PackedParams."""
        def actor_group(net):
            w1, b1, w2, b2, wh, bh = _actor_leaves(net)
            return (_pad1(w1), b1, w2, b2, wh, bh)

        leaves = (actor_group(actor) + actor_group(target_actor)
                  + _pack_critic(_critic_leaves(critic))
                  + _pack_critic(_critic_leaves(target_critic)))
        return PackedParams(*[x.detach().to(torch.float32).clone() for x in leaves])

    def unpack_params(packed: PackedParams, obs_dim: int, action_dim: int = 2):
        """Back to (actor, target actor, critic, target critic) state dicts,
        the padding sliced away; `module.load_state_dict` takes each."""
        d_a, d_c = obs_dim, obs_dim + action_dim

        def actor_tree(w1, b1, w2, b2, wh, bh):
            return {"mlp.layers.0.kernel": w1[:d_a], "mlp.layers.0.bias": b1,
                    "mlp.layers.1.kernel": w2, "mlp.layers.1.bias": b2,
                    "head.kernel": wh[:, :action_dim], "head.bias": bh[:action_dim]}

        def critic_tree(w1, b1, w2, b2, w3, b3):
            out = {}
            for i, q in enumerate(("q1", "q2")):
                out.update({
                    f"{q}.layers.0.kernel": w1[i, :d_c], f"{q}.layers.0.bias": b1[i],
                    f"{q}.layers.1.kernel": w2[i], f"{q}.layers.1.bias": b2[i],
                    f"{q}.layers.2.kernel": w3[i][:, None], f"{q}.layers.2.bias": b3[i][None],
                })
            return out

        return (actor_tree(*(getattr(packed, f) for f in ACTOR_FIELDS)),
                actor_tree(*(getattr(packed, f) for f in TACTOR_FIELDS)),
                critic_tree(*(getattr(packed, f) for f in CRITIC_FIELDS)),
                critic_tree(*(getattr(packed, f) for f in TARGET_FIELDS)))

    def adam_init(packed: PackedParams) -> PackedAdam:
        return PackedAdam(m=PackedParams(*[torch.zeros_like(x) for x in packed]),
                          v=PackedParams(*[torch.zeros_like(x) for x in packed]),
                          count=0, count_a=0)

    # ------------------------------------------------ plain PyTorch version --
    def update_k_reference(packed: PackedParams, adam: PackedAdam, batches, noises,
                           obs_dim: int, gamma: float, tau: float, lr: float,
                           smooth_std: float = 0.2, smooth_clip: float = 0.5,
                           policy_delay: int = 2, mm_bf16: bool = False):
        """K sequential TD3 updates in plain PyTorch (torch.autograd) on the
        packed layout: the plain version of K6.  batches: Transition with
        leading (K, B); noises: (K, B, 2) target-smoothing normals.  `mm_bf16`
        rounds where the kernel rounds: the operands of the matrix products
        and the post-ReLU activations to bfloat16, accumulation in float32.
        Returns (packed', adam', critic_losses (K,), actor_losses (K,))."""
        dot = _BF16Dot.apply if mm_bf16 else torch.matmul
        rnd = _BF16Round.apply if mm_bf16 else (lambda x: x)

        def actor_fwd(w1, b1, w2, b2, wh, bh, x):
            h1 = rnd(torch.relu(dot(x[:, :obs_dim], w1[:obs_dim]) + b1))
            h2 = rnd(torch.relu(dot(h1, w2) + b2))
            return torch.tanh(dot(h2, wh) + bh)

        def critic_fwd(w1, b1, w2, b2, w3, b3, x):
            # the obs columns go through the rounded product, the action
            # columns and the bias stay float32 (fused_td3.py:502-503)
            z1 = (dot(x[:, :obs_dim], w1[:obs_dim])
                  + x[:, obs_dim:obs_dim + 2] @ w1[obs_dim:obs_dim + 2] + b1)
            h1 = rnd(torch.relu(z1))
            h2 = rnd(torch.relu(dot(h1, w2) + b2))
            return dot(h2, w3[:, None])[:, 0] + b3

        def critic(ws, c, x):
            return critic_fwd(*[w[c] for w in ws], x)

        p = PackedParams(*[x.detach() for x in packed])
        new_m, new_v = dict(adam.m._asdict()), dict(adam.v._asdict())
        count, count_a = int(adam.count), int(adam.count_a)
        closses, alosses = [], []
        for k in range(noises.shape[0]):
            batch = Transition(*[x[k] for x in batches])
            noise = noises[k].to(torch.float32)

            def step(n):
                return torch.tensor(float(n), dtype=torch.float32, device=noise.device)

            obs = _pad_x(batch.obs, batch.action, obs_dim)
            obs_only = _pad_x(batch.obs, None, obs_dim)

            # -- critic loss (target actor + smoothing) --
            with torch.no_grad():
                eps = torch.clamp(smooth_std * noise, -smooth_clip, smooth_clip)
                ta = actor_fwd(*[getattr(p, f) for f in TACTOR_FIELDS],
                               _pad_x(batch.next_obs, None, obs_dim))
                nx = _pad_x(batch.next_obs, torch.clamp(ta + eps, -1.0, 1.0), obs_dim)
                tw = [getattr(p, f) for f in TARGET_FIELDS]
                tq = batch.reward + gamma * batch.discount * torch.minimum(
                    critic(tw, 0, nx), critic(tw, 1, nx))

            cw = [getattr(p, f).clone().requires_grad_(True) for f in CRITIC_FIELDS]
            closs = ((critic(cw, 0, obs) - tq) ** 2 + (critic(cw, 1, obs) - tq) ** 2).mean()
            cg = torch.autograd.grad(closs, cw)
            upd = {}
            for f, g in zip(CRITIC_FIELDS, cg):
                u, new_m[f], new_v[f] = _adam(g, new_m[f], new_v[f], lr, step(count + 1))
                upd[f] = getattr(p, f) + u
            p = p._replace(**upd)

            # -- actor loss, always, against the updated critic 0 --
            do_actor = count % policy_delay == 0
            aw = [getattr(p, f).clone().requires_grad_(do_actor) for f in ACTOR_FIELDS]
            with torch.set_grad_enabled(do_actor):
                a = actor_fwd(*aw, obs_only)
                aloss = -critic([getattr(p, f) for f in CRITIC_FIELDS], 0,
                                _pad_x(batch.obs, a, obs_dim)).mean()
            if do_actor:
                # -- delayed: the actor's Adam step and both polyak steps --
                ag = torch.autograd.grad(aloss, aw)
                upd = {}
                for f, g in zip(ACTOR_FIELDS, ag):
                    u, new_m[f], new_v[f] = _adam(g, new_m[f], new_v[f], lr, step(count_a + 1))
                    upd[f] = getattr(p, f) + u
                p = p._replace(**upd)
                p = p._replace(**{
                    tf: getattr(p, tf) * (1 - tau) + getattr(p, sf) * tau
                    for tf, sf in list(zip(TACTOR_FIELDS, ACTOR_FIELDS))
                    + list(zip(TARGET_FIELDS, CRITIC_FIELDS))})
                count_a += 1
            count += 1
            closses.append(closs.detach())
            alosses.append(aloss.detach())

        adam = PackedAdam(m=PackedParams(**new_m), v=PackedParams(**new_v), count=count,
                          count_a=count_a)
        return p, adam, torch.stack(closses), torch.stack(alosses)

    # ------------------------------------------------------ kernel layout --
    R_AW1 = 0
    R_AW2 = IN1
    R_TAW1 = R_AW2 + H
    R_TAW2 = R_TAW1 + IN1
    R_CW1 = (R_TAW2 + H, R_TAW2 + H + IN1 + H)
    R_TW1 = (R_CW1[1] + IN1 + H, R_CW1[1] + 2 * (IN1 + H))
    R_AWH = R_TW1[1] + IN1 + H               # 2304 at H=256
    R_TAWH = R_AWH + AH
    WROWS = -(-(R_TAWH + AH) // 8) * 8       # pad to 8 (2312 at H=256)
    V_AB1, V_AB2, V_TAB1, V_TAB2 = 0, 1, 2, 3
    V_CB1, V_CB2 = (4, 5), (6, 7)
    V_TB1, V_TB2 = (8, 9), (10, 11)
    V_CW3, V_TW3 = (12, 13), (14, 15)
    V_MISC = 16
    VROWS = 24
    # misc-row column spans
    M_ABH = (0, AH)
    M_TABH = (AH, 2 * AH)
    M_CB3 = (2 * AH, 2 * AH + 2)
    M_TB3 = (2 * AH + 2, 2 * AH + 4)

    def pack_wmat(p: PackedParams):
        dev = p.a_w1.device
        w = torch.zeros((WROWS, H), dtype=torch.float32, device=dev)
        w[R_AW1:R_AW1 + IN1] = p.a_w1
        w[R_AW2:R_AW2 + H] = p.a_w2
        w[R_TAW1:R_TAW1 + IN1] = p.ta_w1
        w[R_TAW2:R_TAW2 + H] = p.ta_w2
        for c in (0, 1):
            w[R_CW1[c]:R_CW1[c] + IN1] = p.c_w1[c]
            w[R_CW1[c] + IN1:R_CW1[c] + IN1 + H] = p.c_w2[c]
            w[R_TW1[c]:R_TW1[c] + IN1] = p.t_w1[c]
            w[R_TW1[c] + IN1:R_TW1[c] + IN1 + H] = p.t_w2[c]
        w[R_AWH:R_AWH + AH] = p.a_wh.t()
        w[R_TAWH:R_TAWH + AH] = p.ta_wh.t()
        v = torch.zeros((VROWS, H), dtype=torch.float32, device=dev)
        v[V_AB1], v[V_AB2] = p.a_b1, p.a_b2
        v[V_TAB1], v[V_TAB2] = p.ta_b1, p.ta_b2
        for c in (0, 1):
            v[V_CB1[c]], v[V_CB2[c]] = p.c_b1[c], p.c_b2[c]
            v[V_TB1[c]], v[V_TB2[c]] = p.t_b1[c], p.t_b2[c]
            v[V_CW3[c]], v[V_TW3[c]] = p.c_w3[c], p.t_w3[c]
        v[V_MISC, M_ABH[0]:M_ABH[1]] = p.a_bh
        v[V_MISC, M_TABH[0]:M_TABH[1]] = p.ta_bh
        v[V_MISC, M_CB3[0]:M_CB3[1]] = p.c_b3
        v[V_MISC, M_TB3[0]:M_TB3[1]] = p.t_b3
        return w, v

    def unpack_wmat(w, v) -> PackedParams:
        misc = v[V_MISC]

        def pair(rows, off, n):
            return torch.stack([w[rows[c] + off:rows[c] + off + n] for c in (0, 1)])

        def vpair(rows):
            return torch.stack([v[rows[c]] for c in (0, 1)])

        return PackedParams(
            a_w1=w[R_AW1:R_AW1 + IN1], a_b1=v[V_AB1],
            a_w2=w[R_AW2:R_AW2 + H], a_b2=v[V_AB2],
            a_wh=w[R_AWH:R_AWH + AH].t(), a_bh=misc[M_ABH[0]:M_ABH[1]],
            ta_w1=w[R_TAW1:R_TAW1 + IN1], ta_b1=v[V_TAB1],
            ta_w2=w[R_TAW2:R_TAW2 + H], ta_b2=v[V_TAB2],
            ta_wh=w[R_TAWH:R_TAWH + AH].t(), ta_bh=misc[M_TABH[0]:M_TABH[1]],
            c_w1=pair(R_CW1, 0, IN1), c_b1=vpair(V_CB1),
            c_w2=pair(R_CW1, IN1, H), c_b2=vpair(V_CB2),
            c_w3=vpair(V_CW3), c_b3=misc[M_CB3[0]:M_CB3[1]],
            t_w1=pair(R_TW1, 0, IN1), t_b1=vpair(V_TB1),
            t_w2=pair(R_TW1, IN1, H), t_b2=vpair(V_TB2),
            t_w3=vpair(V_TW3), t_b3=misc[M_TB3[0]:M_TB3[1]],
        )

    def fused_init(packed: PackedParams, adam: PackedAdam) -> FusedState:
        w, vec = pack_wmat(packed)
        mw, mvec = pack_wmat(adam.m)
        vw, vvec = pack_wmat(adam.v)
        return FusedState(w=w, vec=vec, mw=mw, mvec=mvec, vw=vw, vvec=vvec,
                          count=int(adam.count), count_a=int(adam.count_a))

    def fused_unpack(f: FusedState) -> tuple[PackedParams, PackedAdam]:
        return unpack_wmat(f.w, f.vec), PackedAdam(
            m=unpack_wmat(f.mw, f.mvec), v=unpack_wmat(f.vw, f.vvec),
            count=int(f.count), count_a=int(f.count_a))

    def unpack_actor(w, vec, obs_dim: int, action_dim: int = 2):
        """The actor's state dict straight from the wmat rows: six slices
        (views of `w` and `vec`), always current after an in-place update."""
        return {
            "mlp.layers.0.kernel": w[R_AW1:R_AW1 + obs_dim], "mlp.layers.0.bias": vec[V_AB1],
            "mlp.layers.1.kernel": w[R_AW2:R_AW2 + H], "mlp.layers.1.bias": vec[V_AB2],
            "head.kernel": w[R_AWH:R_AWH + action_dim].t(),
            "head.bias": vec[V_MISC, M_ABH[0]:M_ABH[0] + action_dim],
        }

    # ------------------------------------------------------- entry points --
    def _kernel_call(f: FusedState, data, row_idx, noises, *, obs_dim, gamma, tau, lr,
                     smooth_std=0.2, smooth_clip=0.5, policy_delay=2, block=2048, mm_bf16=True):
        """Shared launcher of both data modes (fused_sac._data_mode).  `block`
        is checked as the JAX kernel checks it; K6 tiles the batch, or each
        ring row, by KERNEL_TILE[H] samples per thread block whatever it is,
        the last tile of a row partial where that does not divide it.  noises:
        (K, B, 2).  Adds the K critic updates and the delayed actor updates
        to the counts `td3.critic_updates` and `td3.actor_updates`.  Returns
        (FusedState', critic_losses (K,), actor_losses (K,))."""
        K, B = noises.shape[0], noises.shape[1]
        if tuple(noises.shape) != (K, B, AH):
            raise ValueError(f"noises must be (K, B, {AH}), got {tuple(noises.shape)}")
        if int(policy_delay) < 1:
            raise ValueError(f"policy_delay must be at least 1, got {policy_delay}")
        W, lanes, rpb = _data_mode(f, data, row_idx, K, B, obs_dim, block, WROWS)
        hyper = dict(obs_dim=obs_dim, gamma=gamma, tau=tau, lr=lr, smooth_std=smooth_std,
                     smooth_clip=smooth_clip, policy_delay=int(policy_delay))

        count = int(f.count)
        n_act = applied_steps(count, K, int(policy_delay))
        if f.w.device.type == "cpu":
            packed, adam = fused_unpack(f)
            packed, adam, closs, aloss = update_k_reference(
                packed, adam, _gathered(data, row_idx, K, B, obs_dim), noises,
                mm_bf16=mm_bf16, **hyper)
            out = fused_init(packed, adam)
        elif f.w.device.type == "cuda":
            closs, aloss = _launch(f, data, row_idx, noises, K, B, W, lanes, rpb, mm_bf16,
                                   **hyper)
            out = f._replace(count=count + K, count_a=int(f.count_a) + n_act)
        else:
            raise ValueError(f"unsupported device {f.w.device}")
        # the updates made, host integers: no sync (utils/profiling.py)
        profiling.add({"td3.critic_updates": K, "td3.actor_updates": n_act})
        return out, closs, aloss

    def _launch(f, data, row_idx, noises, K, B, W, lanes, rpb, mm_bf16, *, obs_dim, gamma, tau,
                lr, smooth_std, smooth_clip, policy_delay):
        """Check what the kernel takes, allocate its scratch, launch it."""
        ts, state, row_idx = _kernel_operands(f, data, row_idx, noises, VROWS)
        dev = f.w.device
        tiles = n_tiles(lanes, rpb, ts)
        lib = _lib()
        with torch.cuda.device(dev):
            plan = (ctypes.c_int * 2)()
            err = lib.sg_td3_update_plan(H, W, tiles, int(bool(mm_bf16)), plan)
            if err != 0:
                raise RuntimeError(
                    f"sg_td3_update: {_PLAN_ERRORS.get(err, 'CUDA error')} (code {err}) at "
                    f"H={H}, W={W}, {tiles} tiles of {ts} samples")
            grid = plan[0]
            noise = noises.transpose(1, 2).contiguous()          # (K, 2, B)
            prows = 2 * (obs_dim + 2 + 3 + H) + 1
            partials = torch.empty((grid, prows, H), dtype=torch.float32, device=dev)
            # the products' weights: in float32 mode the transposed W2 copies, in
            # bf16 mode the bf16 shadow of the first 6 (IN1 + H) rows of `w`
            wt = wb = None
            if mm_bf16:
                wb = torch.empty((6 * (IN1 + H), H), dtype=torch.bfloat16, device=dev)
            else:
                wt = torch.empty((3, H, H), dtype=torch.float32, device=dev)
            stash = torch.empty((tiles, 2, ts, H), dtype=torch.float32, device=dev)
            alp = torch.empty((K, grid), dtype=torch.float32, device=dev)
            losses = torch.empty((K, 2), dtype=torch.float32, device=dev)
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.sg_td3_update(
                *[t.data_ptr() for t in state], data.data_ptr(),
                row_idx.data_ptr() if row_idx is not None else None, noise.data_ptr(),
                losses.data_ptr(), partials.data_ptr(), wt.data_ptr() if wt is not None else None,
                stash.data_ptr(), alp.data_ptr(), wb.data_ptr() if wb is not None else None,
                H, K, B, W, lanes, rpb, obs_dim, grid, int(bool(mm_bf16)),
                int(f.count), int(f.count_a), policy_delay,
                gamma, tau, lr, smooth_std, smooth_clip, stream)
        if err != 0:
            raise RuntimeError(f"sg_td3_update kernel launch failed: "
                           f"{_PLAN_ERRORS.get(err, 'CUDA error')} (code {err})")
        profiling.launch("td3_update")
        return losses[:, 0], losses[:, 1]

    def fused_update_k_wmat(f: FusedState, ring, row_idx, noises, **kw):
        """K TD3 updates on the cached kernel-layout state, sampling the
        replay ring in the kernel: the trainer's path (models/td3.py)."""
        return _kernel_call(f, ring, row_idx, noises, **kw)

    def fused_update_k_wmat_batches(f: FusedState, batches, noises, **kw):
        """Same, on explicitly gathered (K, B) Transition minibatches."""
        data = pack_slab(batches, kw["obs_dim"], 2).to(torch.float32)  # (K, W, B)
        return _kernel_call(f, data, None, noises, **kw)

    def fused_update_k(packed: PackedParams, adam: PackedAdam, batches, noises,
                       obs_dim: int, gamma: float, tau: float, lr: float,
                       smooth_std: float = 0.2, smooth_clip: float = 0.5,
                       policy_delay: int = 2, block: int = 2048, mm_bf16: bool = True):
        """K sequential TD3 updates from the PackedParams boundary (tests and
        one-off callers; the trainer keeps a FusedState).  batches: Transition
        with leading (K, B); noises: (K, B, 2).  Returns (packed', adam',
        critic_losses (K,), actor_losses (K,))."""
        f2, closs, aloss = fused_update_k_wmat_batches(
            fused_init(packed, adam), batches, noises, obs_dim=obs_dim, gamma=gamma, tau=tau,
            lr=lr, smooth_std=smooth_std, smooth_clip=smooth_clip, policy_delay=policy_delay,
            block=block, mm_bf16=mm_bf16)
        return (*fused_unpack(f2), closs, aloss)

    def fused_update_k_from_replay(packed: PackedParams, adam: PackedAdam, data, row_idx,
                                   noises, obs_dim: int, gamma: float, tau: float, lr: float,
                                   smooth_std: float = 0.2, smooth_clip: float = 0.5,
                                   policy_delay: int = 2, block: int = 2048,
                                   mm_bf16: bool = True):
        """K sequential TD3 updates sampling the replay ring in the kernel,
        from the PackedParams boundary.  data: the packed (rows, W, lanes)
        ring; row_idx: (K * B // lanes,) int32 rows (the caller bounds them by
        `filled`); noises: (K, B, 2)."""
        f2, closs, aloss = fused_update_k_wmat(
            fused_init(packed, adam), data, row_idx, noises, obs_dim=obs_dim, gamma=gamma,
            tau=tau, lr=lr, smooth_std=smooth_std, smooth_clip=smooth_clip,
            policy_delay=policy_delay, block=block, mm_bf16=mm_bf16)
        return (*fused_unpack(f2), closs, aloss)

    ns = SimpleNamespace(**{k: v for k, v in list(locals().items()) if k not in ("ns", "h")})
    ns.PackedParams = PackedParams
    ns.PackedAdam = PackedAdam
    ns.FusedState = FusedState
    ns.IN1 = IN1
    ns.AH = AH
    return ns


@functools.cache
def _lib():
    """The ctypes library of K6 with its two entry points typed."""
    lib = cuda_build.load("td3_update")
    p, i, fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # six state tensors, data, row_idx, noise, losses, partials, wt, stash, alp, wb; H, K, B,
    # W, lanes, rpb, obs_dim, grid, mm_bf16, count0, count_a0, policy_delay; gamma, tau, lr,
    # smooth_std, smooth_clip; stream
    lib.sg_td3_update.argtypes = [p] * 15 + [i] * 12 + [fl] * 5 + [p]
    lib.sg_td3_update.restype = i
    # H, W, n_tiles, mm_bf16 -> grid, smem
    lib.sg_td3_update_plan.argtypes = [i, i, i, i, ctypes.POINTER(ctypes.c_int)]
    lib.sg_td3_update_plan.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def build(h: int = 256):
    """Width-h fused-TD3 namespace (memoized; build(256) is module level)."""
    if h % 128:
        raise ValueError(f"fused hidden width must be a multiple of 128, got {h}")
    return _build_width(int(h))


_DEFAULT = build(256)
globals().update({k: v for k, v in vars(_DEFAULT).items() if k != "H"})
H = 256  # default hidden width (SB3-default 2x256 MLPs)
