"""Plain PyTorch reference of K sequential SAC updates, frozen for the benchmark.

A standalone copy of the port's plain version of its fused SAC kernels (the
twin critics' TD loss, Adam, polyak; then the tanh-Gaussian actor's loss
against the updated critics, Adam, and the temperature), on the same packed
layout: first-layer inputs padded to IN1 = 128 rows (obs | action | zeros),
the actor's heads one (H, 4) matrix [mean | log_std].  It imports nothing of
the program, of JAX or of the JAX package.

`products` is the precision of the matrix products: "float32"; "bf16", the
operands and the post-ReLU activations rounded to bfloat16 with float32
accumulation, as the configuration's kernels compute; "fp8", the same with
float8 (e4m3) rounding, the control one precision below.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import nn

IN1 = 128
LOG_STD_MIN, LOG_STD_MAX = -20.0, 2.0
B1, B2, EPS = 0.9, 0.999, 1e-8  # optax.adam's defaults
LOG2PI = 1.8378770664093453
LOG2 = 0.6931471805599453


class Params(NamedTuple):
    """The learner's leaves (float32).  Critic and target leaves stack the two
    critics on their first axis."""

    a_w1: torch.Tensor   # (IN1, H)
    a_b1: torch.Tensor   # (H,)
    a_w2: torch.Tensor   # (H, H)
    a_b2: torch.Tensor   # (H,)
    a_wh: torch.Tensor   # (H, 4)
    a_bh: torch.Tensor   # (4,)
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


ACTOR = ("a_w1", "a_b1", "a_w2", "a_b2", "a_wh", "a_bh")
CRITIC = ("c_w1", "c_b1", "c_w2", "c_b2", "c_w3", "c_b3")
TARGET = ("t_w1", "t_b1", "t_w2", "t_b2", "t_w3", "t_b3")


class Batch(NamedTuple):
    """K minibatches of B transitions: obs (K, B, od), action (K, B, 2),
    reward (K, B), next_obs (K, B, od), discount (K, B)."""

    obs: torch.Tensor
    action: torch.Tensor
    reward: torch.Tensor
    next_obs: torch.Tensor
    discount: torch.Tensor


def _rounder(products: str):
    """The rounding of a product's operands, or None for float32."""
    if products == "float32":
        return None
    dtype = {"bf16": torch.bfloat16, "fp8": torch.float8_e4m3fn}[products]

    def rnd(x):
        return x.to(dtype).to(torch.float32)
    return rnd


class _RoundDot(torch.autograd.Function):
    """a @ b with both operands rounded, float32 accumulation, forward and
    backward."""

    @staticmethod
    def forward(ctx, a, b, rnd):
        a, b = rnd(a), rnd(b)
        ctx.save_for_backward(a, b)
        ctx.rnd = rnd
        return a @ b

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = ctx.rnd(g)
        return g @ b.t(), a.t() @ g, None


class _Round(torch.autograd.Function):
    """A rounded activation; the gradient passes unchanged."""

    @staticmethod
    def forward(ctx, x, rnd):
        return rnd(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


def adam(g, m, v, lr, t):
    """One Adam step with the bias corrections folded into two scalars; b**t is
    exp(t * log b) in float32.  Returns (update, m, v)."""
    m = B1 * m + (1 - B1) * g
    v = B2 * v + (1 - B2) * g * g
    bc1 = 1.0 - torch.exp(t * math.log(B1))
    sb2 = torch.sqrt(1.0 - torch.exp(t * math.log(B2)))
    return -(lr * sb2 / bc1) * m / (torch.sqrt(v) + EPS * sb2), m, v


def sample(mean, log_std_raw, noise):
    """The tanh-Gaussian action and its log-probability."""
    log_std = torch.clamp(log_std_raw, LOG_STD_MIN, LOG_STD_MAX)
    pre = mean + torch.exp(log_std) * noise
    a = torch.tanh(pre)
    logp = -0.5 * (noise ** 2 + 2 * log_std + LOG2PI)
    logp = logp - 2 * (LOG2 - pre - nn.functional.softplus(-2 * pre))
    return a, logp.sum(-1)


def update_k(p: Params, m: Params, v: Params, count: int, batches: Batch, noises, *,
             obs_dim: int, gamma: float, tau: float, lr: float, target_entropy: float,
             products: str = "float32"):
    """K sequential updates; `noises` (K, B, 2, 2): [:, :, 0] the critic's
    next action, [:, :, 1] the actor's.  Returns (params, m, v, count,
    critic losses (K,), actor losses (K,))."""
    rnd = _rounder(products)
    if rnd is None:
        dot, rd = torch.matmul, (lambda x: x)
    else:
        def dot(a, b):
            return _RoundDot.apply(a, b, rnd)

        def rd(x):
            return _Round.apply(x, rnd)

    def pad(obs, act):
        x = torch.zeros((obs.shape[0], IN1), dtype=torch.float32, device=obs.device)
        x[:, :obs_dim] = obs[:, :obs_dim]
        if act is not None:
            x[:, obs_dim:obs_dim + act.shape[1]] = act
        return x

    def layer1(x, w1, b1):
        # the obs columns through the rounded product, the action columns and
        # the bias in float32
        return dot(x[:, :obs_dim], w1[:obs_dim]) + x[:, obs_dim:obs_dim + 2] @ \
            w1[obs_dim:obs_dim + 2] + b1

    def actor(q, x):
        h1 = rd(torch.relu(dot(x[:, :obs_dim], q.a_w1[:obs_dim]) + q.a_b1))
        h2 = rd(torch.relu(dot(h1, q.a_w2) + q.a_b2))
        head = dot(h2, q.a_wh) + q.a_bh
        return head[:, :2], head[:, 2:]

    def critics(ws, x):
        w1, b1, w2, b2, w3, b3 = ws
        out = []
        for c in (0, 1):
            h1 = rd(torch.relu(layer1(x, w1[c], b1[c])))
            h2 = rd(torch.relu(dot(h1, w2[c]) + b2[c]))
            out.append(dot(h2, w3[c][:, None])[:, 0] + b3[c])
        return out

    p = Params(*[x.detach() for x in p])
    m, v = m._asdict(), v._asdict()
    closses, alosses = [], []
    for k in range(noises.shape[0]):
        b = Batch(*[x[k] for x in batches])
        noise = noises[k].to(torch.float32)
        t = torch.tensor(float(count + 1), dtype=torch.float32, device=noise.device)
        alpha = torch.exp(p.log_alpha)
        x_sa = pad(b.obs, b.action)
        x_s = pad(b.obs, None)
        with torch.no_grad():
            mean, lsr = actor(p, pad(b.next_obs, None))
            na, nlogp = sample(mean, lsr, noise[:, 0])
            q1t, q2t = critics([getattr(p, f) for f in TARGET], pad(b.next_obs, na))
            tq = b.reward + gamma * b.discount * (torch.minimum(q1t, q2t) - alpha * nlogp)
        cw = [getattr(p, f).clone().requires_grad_(True) for f in CRITIC]
        q1, q2 = critics(cw, x_sa)
        closs = ((q1 - tq) ** 2 + (q2 - tq) ** 2).mean()
        upd = {}
        for f, g in zip(CRITIC, torch.autograd.grad(closs, cw)):
            u, m[f], v[f] = adam(g, m[f], v[f], lr, t)
            upd[f] = getattr(p, f) + u
        p = p._replace(**upd)

        aw = [getattr(p, f).clone().requires_grad_(True) for f in ACTOR]
        mean, lsr = actor(p._replace(**dict(zip(ACTOR, aw))), x_s)
        a, logp = sample(mean, lsr, noise[:, 1])
        q1, q2 = critics([getattr(p, f) for f in CRITIC], pad(b.obs, a))
        aloss = (alpha * logp - torch.minimum(q1, q2)).mean()
        upd = {}
        for f, g in zip(ACTOR, torch.autograd.grad(aloss, aw)):
            u, m[f], v[f] = adam(g, m[f], v[f], lr, t)
            upd[f] = getattr(p, f) + u
        p = p._replace(**upd)

        g_la = -(logp.detach().mean() + target_entropy)
        u, m["log_alpha"], v["log_alpha"] = adam(g_la, m["log_alpha"], v["log_alpha"], lr, t)
        new_t = {tf: getattr(p, tf) * (1 - tau) + getattr(p, cf) * tau
                 for tf, cf in zip(TARGET, CRITIC)}
        p = p._replace(log_alpha=p.log_alpha + u, **new_t)
        count += 1
        closses.append(closs.detach())
        alosses.append(aloss.detach())
    return p, Params(**m), Params(**v), count, torch.stack(closses), torch.stack(alosses)
