"""Actor and critic networks of the SAC and TD3 learners.

Port of space_gym_tpu/models/networks.py (MLP, TanhGaussianActor,
DeterministicActor, DoubleCritic, sample_tanh_gaussian, GaussianActorValue,
gaussian_logp).  The networks are the SB3 defaults: 2x256 MLPs, 2x64 for
PPO.  A `Dense` keeps its weight as `kernel` of shape (in, out), the flax
layout, so that parameters carry over between the packages without a
transpose (models/convert.py) and slice straight out of the fused learner's
weight matrix (fused_sac.unpack_actor, fused_td3.unpack_actor).
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

LOG_STD_MIN = -20.0
LOG_STD_MAX = 2.0
LOG2PI = math.log(2 * math.pi)
LOG2 = math.log(2.0)


class Dense(nn.Module):
    """y = x @ kernel + bias; kernel (in, out) drawn as flax draws it
    (LeCun normal: truncated normal at two sigma with variance 1 / in),
    bias zero."""

    def __init__(self, in_features: int, out_features: int, generator=None):
        super().__init__()
        w = torch.empty((in_features, out_features), dtype=torch.float32)
        std = math.sqrt(1.0 / in_features) / 0.87962566103423978
        nn.init.trunc_normal_(w, mean=0.0, std=std, a=-2 * std, b=2 * std, generator=generator)
        self.kernel = nn.Parameter(w)
        self.bias = nn.Parameter(torch.zeros(out_features, dtype=torch.float32))

    def forward(self, x):
        return x @ self.kernel + self.bias


class MLP(nn.Module):
    def __init__(self, in_features: int, features: Sequence[int], activate_final: bool = False,
                 generator=None):
        super().__init__()
        dims = [in_features, *features]
        self.layers = nn.ModuleList(
            Dense(a, b, generator) for a, b in zip(dims[:-1], dims[1:]))
        self.activate_final = activate_final

    def forward(self, x):
        last = len(self.layers) - 1
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < last or self.activate_final:
                x = torch.relu(x)
        return x


class TanhGaussianActor(nn.Module):
    """SAC actor: tanh-squashed diagonal Gaussian over [-1, 1]^action_dim.
    Returns (mean, log_std clipped to [LOG_STD_MIN, LOG_STD_MAX])."""

    def __init__(self, obs_dim: int, action_dim: int = 2, hidden: Sequence[int] = (256, 256),
                 generator=None):
        super().__init__()
        self.mlp = MLP(obs_dim, hidden, activate_final=True, generator=generator)
        self.mean_head = Dense(hidden[-1], action_dim, generator)
        self.log_std_head = Dense(hidden[-1], action_dim, generator)

    def forward(self, obs):
        h = self.mlp(obs)
        return self.mean_head(h), torch.clamp(self.log_std_head(h), LOG_STD_MIN, LOG_STD_MAX)


def sample_tanh_gaussian(mean, log_std, eps=None, generator=None):
    """Reparameterized sample and log-prob with the tanh change of variables;
    `eps` are the standard normals (drawn from `generator` when None)."""
    if eps is None:
        eps = torch.randn(mean.shape, generator=generator, device=mean.device, dtype=mean.dtype)
    pre = mean + torch.exp(log_std) * eps
    action = torch.tanh(pre)
    # N(pre; mean, std) log-density minus log|d tanh / d pre|, with
    # log(1 - tanh(x)^2) = 2 (log 2 - x - softplus(-2x)), numerically stable.
    logp = -0.5 * (eps**2 + 2 * log_std + LOG2PI)
    logp = logp - 2 * (LOG2 - pre - nn.functional.softplus(-2 * pre))
    return action, logp.sum(-1)


class DeterministicActor(nn.Module):
    """TD3 actor: tanh-bounded deterministic policy."""

    def __init__(self, obs_dim: int, action_dim: int = 2, hidden: Sequence[int] = (256, 256),
                 generator=None):
        super().__init__()
        self.mlp = MLP(obs_dim, hidden, activate_final=True, generator=generator)
        self.head = Dense(hidden[-1], action_dim, generator)

    def forward(self, obs):
        return torch.tanh(self.head(self.mlp(obs)))


class DoubleCritic(nn.Module):
    """Twin Q networks evaluated in one call (clipped double-Q trick)."""

    def __init__(self, obs_dim: int, action_dim: int = 2, hidden: Sequence[int] = (256, 256),
                 generator=None):
        super().__init__()
        self.q1 = MLP(obs_dim + action_dim, (*hidden, 1), generator=generator)
        self.q2 = MLP(obs_dim + action_dim, (*hidden, 1), generator=generator)

    def forward(self, obs, action):
        x = torch.cat([obs, action], dim=-1)
        return self.q1(x).squeeze(-1), self.q2(x).squeeze(-1)


class GaussianActorValue(nn.Module):
    """PPO actor-critic: a diagonal Gaussian policy with a state-independent
    `log_std` (SB3 MlpPolicy's default) and a separate value tower, named as
    the flax module's parameters are (MLP_0 -> torso, Dense_0 -> mean_head,
    log_std, vf, vhead).  Returns (mean, log_std broadcast to mean's shape,
    value)."""

    def __init__(self, obs_dim: int, action_dim: int = 2, hidden: Sequence[int] = (64, 64),
                 generator=None):
        super().__init__()
        self.torso = MLP(obs_dim, hidden, activate_final=True, generator=generator)
        self.mean_head = Dense(hidden[-1], action_dim, generator)
        self.log_std = nn.Parameter(torch.zeros(action_dim, dtype=torch.float32))
        self.vf = MLP(obs_dim, hidden, activate_final=True, generator=generator)
        self.vhead = Dense(hidden[-1], 1, generator)

    def forward(self, obs):
        mean = self.mean_head(self.torso(obs))
        return mean, self.log_std.expand(mean.shape), self.value(obs)

    def value(self, obs):
        """The value tower alone (the rollout's bootstrap of final_obs)."""
        return self.vhead(self.vf(obs))[..., 0]


def gaussian_logp(action, mean, log_std):
    """Diagonal Gaussian log-density, no squash (PPO clips at the env)."""
    z = (action - mean) * torch.exp(-log_std)
    return (-0.5 * z**2 - log_std - 0.5 * math.log(2 * math.pi)).sum(-1)
