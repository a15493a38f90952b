"""Plain PyTorch reference of K sequential TD3 updates, frozen for the benchmark.

TD3 is Twin-Delayed DDPG (Fujimoto, van Hoof and Meger, "Addressing Function
Approximation Error in Actor-Critic Methods", ICML 2018, arXiv:1802.09477,
Algorithm 1).  An update here is the algorithm's learner step:

  * the clipped double-Q target from the TARGET actor with clipped smoothing
    noise, y = r + gamma d min(Q'1, Q'2)(s', clip(pi'(s') + clip(std eps,
    -c, c), -1, 1)), with d = 1 - terminated;
  * the summed mean-square loss of both critics against y, one Adam step;
  * on every `policy_delay`-th update, the actor's -Q1 loss against the
    updated critics, one Adam step, then polyak steps of the target actor and
    both target critics.

Where it departs from the paper, as the documented run trains (and the port's
plain version of its fused kernel computes):

  * K = 32 updates a call on minibatches of B = 8192 transitions sampled from
    a 2048 x 2048 ring, against one update of 256 a step;
  * 256-wide layers at learning rate 3e-4, as the authors' public code (the
    paper: 400 and 300 at 1e-3);
  * the delayed updates are those whose number of updates before them is a
    multiple of `policy_delay`, the first update included;
  * the actor's loss is computed and reported on every update; its Adam
    count advances on the delayed ones only, the critics' on every update;
  * Adam is optax.adam's with its bias corrections folded into two scalars,
    b**t as exp(t log b) in float32;
  * the learner's leaves are the packed layout: first-layer inputs padded to
    IN1 = 128 rows (obs | action | zeros), the action rows of the critics'
    first layer and their bias summed in float32 whatever `products` says.

`products` is the precision of the matrix products: "float32"; "bf16", the
operands and the post-ReLU activations rounded to bfloat16 with float32
accumulation, as the configuration's kernel computes; "fp8", the same with
float8 (e4m3) rounding, the control one precision below.  It imports nothing
of the program, of JAX or of the JAX package.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .sac_update import IN1, Batch, _Round, _RoundDot, _rounder, adam  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


class Params(NamedTuple):
    """The learner's leaves (float32).  Critic and target critic leaves stack
    the two critics on their first axis."""

    a_w1: torch.Tensor    # (IN1, H)
    a_b1: torch.Tensor    # (H,)
    a_w2: torch.Tensor    # (H, H)
    a_b2: torch.Tensor    # (H,)
    a_wh: torch.Tensor    # (H, 2)
    a_bh: torch.Tensor    # (2,)
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


ACTOR = ("a_w1", "a_b1", "a_w2", "a_b2", "a_wh", "a_bh")
TACTOR = ("ta_w1", "ta_b1", "ta_w2", "ta_b2", "ta_wh", "ta_bh")
CRITIC = ("c_w1", "c_b1", "c_w2", "c_b2", "c_w3", "c_b3")
TARGET = ("t_w1", "t_b1", "t_w2", "t_b2", "t_w3", "t_b3")


def update_k(p: Params, m: Params, v: Params, count: int, count_a: int, batches: Batch,
             noises, *, obs_dim: int, gamma: float, tau: float, lr: float, smooth_std: float,
             smooth_clip: float, policy_delay: int, products: str = "float32"):
    """K sequential updates; `noises` (K, B, 2) the smoothing normals;
    `count` the updates so far (the critics' Adam count), `count_a` the
    actor's Adam count.  Returns (params, m, v, count, count_a, critic losses
    (K,), actor losses (K,), the mean |Q1| of each actor loss's batch (K,):
    the size of the values whose mean, negated, is that loss)."""
    rnd = _rounder(products)
    if rnd is None:
        dot, rd = torch.matmul, (lambda x: x)
    else:
        def dot(a, b):
            return _RoundDot.apply(a, b, rnd)

        def rd(x):
            return _Round.apply(x, rnd)

    od = obs_dim

    def actor(ws, obs):
        w1, b1, w2, b2, wh, bh = ws
        h1 = rd(torch.relu(dot(obs, w1[:od]) + b1))
        h2 = rd(torch.relu(dot(h1, w2) + b2))
        return torch.tanh(dot(h2, wh) + bh)

    def critic(ws, c, obs, act):
        w1, b1, w2, b2, w3, b3 = [w[c] for w in ws]
        h1 = rd(torch.relu(dot(obs, w1[:od]) + act @ w1[od:od + 2] + b1))
        h2 = rd(torch.relu(dot(h1, w2) + b2))
        return dot(h2, w3[:, None])[:, 0] + b3

    def group(q, fields):
        return [getattr(q, f) for f in fields]

    def step(n, like):
        return torch.tensor(float(n), dtype=torch.float32, device=like.device)

    p = Params(*[x.detach() for x in p])
    m, v = m._asdict(), v._asdict()
    closses, alosses, q_abs = [], [], []
    for k in range(noises.shape[0]):
        b = Batch(*[x[k] for x in batches])
        with torch.no_grad():
            eps = torch.clamp(smooth_std * noises[k].to(torch.float32), -smooth_clip,
                              smooth_clip)
            na = torch.clamp(actor(group(p, TACTOR), b.next_obs) + eps, -1.0, 1.0)
            tw = group(p, TARGET)
            y = b.reward + gamma * b.discount * torch.minimum(critic(tw, 0, b.next_obs, na),
                                                              critic(tw, 1, b.next_obs, na))
        cw = [x.clone().requires_grad_(True) for x in group(p, CRITIC)]
        closs = ((critic(cw, 0, b.obs, b.action) - y) ** 2
                 + (critic(cw, 1, b.obs, b.action) - y) ** 2).mean()
        upd = {}
        for f, g in zip(CRITIC, torch.autograd.grad(closs, cw)):
            u, m[f], v[f] = adam(g, m[f], v[f], lr, step(count + 1, g))
            upd[f] = getattr(p, f) + u
        p = p._replace(**upd)

        aw = [x.clone().requires_grad_(True) for x in group(p, ACTOR)]
        q1 = critic(group(p, CRITIC), 0, b.obs, actor(aw, b.obs))
        aloss = -q1.mean()
        if count % policy_delay == 0:
            upd = {}
            for f, g in zip(ACTOR, torch.autograd.grad(aloss, aw)):
                u, m[f], v[f] = adam(g, m[f], v[f], lr, step(count_a + 1, g))
                upd[f] = getattr(p, f) + u
            p = p._replace(**upd)
            p = p._replace(**{tf: getattr(p, tf) * (1 - tau) + getattr(p, f) * tau
                              for tf, f in zip(TACTOR + TARGET, ACTOR + CRITIC)})
            count_a += 1
        count += 1
        closses.append(closs.detach())
        alosses.append(aloss.detach())
        q_abs.append(q1.detach().abs().mean())
    return (p, Params(**m), Params(**v), count, count_a, torch.stack(closses),
            torch.stack(alosses), torch.stack(q_abs))
