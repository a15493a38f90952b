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
the kernel or raise for tensors on a CUDA device (models/learner_kernels.py,
the launch that K4, K5 and K6 share).  There is no fallback.

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
returned FusedState shares the tensors it was given.  A launch adds 1 to
`sac_update` or `sac_update_fold` (utils/profiling.py).
"""
from __future__ import annotations

import functools
import math
from types import SimpleNamespace
from typing import NamedTuple

import torch
from torch import nn

from . import learner_kernels
from .learner_kernels import (CLUSTER_MAX, IN1, BF16Dot, BF16Round, adam_step, pack_critic,
                              pad_first_layer, pad_x, state_dict, unpack_critic)
from .replay import Transition, pack_slab

NHEAD = 4     # actor head columns: [mean(2) | log_std(2)]
LOG_STD_MIN = -20.0
LOG_STD_MAX = 2.0
LOG2PI = 1.8378770664093453  # log(2*pi)
LOG2 = 0.6931471805599453

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


def _actor_leaves(actor):
    sd = state_dict(actor)
    return (sd["mlp.layers.0.kernel"], sd["mlp.layers.0.bias"],
            sd["mlp.layers.1.kernel"], sd["mlp.layers.1.bias"],
            sd["mean_head.kernel"], sd["mean_head.bias"],
            sd["log_std_head.kernel"], sd["log_std_head.bias"])


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
        cw1, cb1, cw2, cb2, cw3, cb3 = pack_critic(critic)
        tw1, tb1, tw2, tb2, tw3, tb3 = pack_critic(target)
        packed = PackedParams(
            a_w1=pad_first_layer(aw1), a_b1=ab1, a_w2=aw2, a_b2=ab2,
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
        critic = unpack_critic(*(getattr(packed, f) for f in CRITIC_FIELDS), d_c)
        target = unpack_critic(*(getattr(packed, f) for f in TARGET_FIELDS), d_c)
        return actor, critic, target, packed.log_alpha

    # ------------------------------------------------ plain PyTorch version --
    def _sample(mean, log_std_raw, noise):
        log_std = torch.clamp(log_std_raw, LOG_STD_MIN, LOG_STD_MAX)
        pre = mean + torch.exp(log_std) * noise
        a = torch.tanh(pre)
        logp = -0.5 * (noise**2 + 2 * log_std + LOG2PI)
        logp = logp - 2 * (LOG2 - pre - nn.functional.softplus(-2 * pre))
        return a, logp.sum(-1)

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
        dot = BF16Dot.apply if mm_bf16 else torch.matmul
        rnd = BF16Round.apply if mm_bf16 else (lambda x: x)

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
            obs = pad_x(batch.obs, batch.action, obs_dim)
            obs_only = pad_x(batch.obs, None, obs_dim)

            # -- critic loss --
            with torch.no_grad():
                mean, lsr = actor_fwd(p, pad_x(batch.next_obs, None, obs_dim))
                na, nlogp = _sample(mean, lsr, noise[:, 0])
                q1t, q2t = both([getattr(p, f) for f in TARGET_FIELDS],
                                pad_x(batch.next_obs, na, obs_dim))
                tq = batch.reward + gamma * batch.discount * (
                    torch.minimum(q1t, q2t) - alpha * nlogp)

            cw = [getattr(p, f).clone().requires_grad_(True) for f in CRITIC_FIELDS]
            q1, q2 = both(cw, obs)
            closs = ((q1 - tq) ** 2 + (q2 - tq) ** 2).mean()
            cg = torch.autograd.grad(closs, cw)
            upd = {}
            for f, g in zip(CRITIC_FIELDS, cg):
                u, new_m[f], new_v[f] = adam_step(g, new_m[f], new_v[f], lr, t)
                upd[f] = getattr(p, f) + u
            p = p._replace(**upd)

            # -- actor loss (against the updated critics) --
            aw = [getattr(p, f).clone().requires_grad_(True) for f in ACTOR_FIELDS]
            p2 = p._replace(**dict(zip(ACTOR_FIELDS, aw)))
            mean, lsr = actor_fwd(p2, obs_only)
            a, logp = _sample(mean, lsr, noise[:, 1])
            q1, q2 = both([getattr(p, f) for f in CRITIC_FIELDS], pad_x(batch.obs, a, obs_dim))
            aloss = (alpha * logp - torch.minimum(q1, q2)).mean()
            ag = torch.autograd.grad(aloss, aw)
            upd = {}
            for f, g in zip(ACTOR_FIELDS, ag):
                u, new_m[f], new_v[f] = adam_step(g, new_m[f], new_v[f], lr, t)
                upd[f] = getattr(p, f) + u
            p = p._replace(**upd)

            # -- temperature --
            g_la = -(logp.detach().mean() + target_entropy)
            u, new_m["log_alpha"], new_v["log_alpha"] = adam_step(
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
                     target_entropy, alpha_floor=0.0, block=2048, mm_bf16=True, fold=False,
                     cluster_max=CLUSTER_MAX):
        """K4 (K5 with `fold`) in either data mode (learner_kernels.dispatch).
        `block` is checked as the JAX kernels check it; the CUDA kernels tile
        the batch, or each ring row, by KERNEL_TILE[H] samples per thread
        block whatever it is, the last tile of a row partial where that does
        not divide it.  On a card the launch takes thread block clusters of
        at most `cluster_max` blocks (learner_kernels.plan).
        Returns (FusedState', critic_losses (K,), actor_losses (K,))."""
        K, B = noises.shape[0], noises.shape[1]
        if tuple(noises.shape) != (K, B, 2, 2):
            raise ValueError(f"noises must be (K, B, 2, 2), got {tuple(noises.shape)}")
        hyper = dict(gamma=gamma, tau=tau, lr=lr, target_entropy=target_entropy,
                     alpha_floor=alpha_floor)
        return learner_kernels.dispatch(
            learner_kernels.SAC_FOLD if fold else learner_kernels.SAC, build(H), f, data,
            row_idx, noises, kernel_scalars(f.count, **hyper), dict(count=int(f.count) + K),
            obs_dim=obs_dim, block=block, mm_bf16=mm_bf16, cluster_max=cluster_max, **hyper)

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


def kernel_scalars(count, *, gamma, tau, lr, target_entropy, alpha_floor=0.0):
    """K4's and K5's scalars by name (learner_kernels.SAC): the hyper-
    parameters, the Adam count before the launch, and the temperature's floor
    (has_floor, log_floor)."""
    floor = alpha_floor > 0
    return dict(has_floor=int(floor), gamma=gamma, tau=tau, lr=lr, target_entropy=target_entropy,
                count0=float(count), log_floor=math.log(alpha_floor) if floor else 0.0)


@functools.lru_cache(maxsize=None)
def build(h: int = 256):
    """Width-h fused-SAC namespace (memoized; build(256) is module level)."""
    if h % 128:
        raise ValueError(f"fused hidden width must be a multiple of 128, got {h}")
    return _build_width(int(h))


_DEFAULT = build(256)
globals().update({k: v for k, v in vars(_DEFAULT).items() if k != "H"})
H = 256  # default hidden width (SB3-default 2x256 MLPs)
