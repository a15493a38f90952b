"""PPO on the batched env engine.

Port of space_gym_tpu/models/ppo.py: SB3 PPO's clipped surrogate, GAE,
advantages normalised per minibatch, no value clipping, the MlpPolicy
defaults (2x64, state-independent log_std).  As in the JAX trainer, a
minibatch is a set of permuted (timestep, lane tile) tiles of 128 lanes:
lanes are independent episodes, so a tile is 128 iid samples of one
timestep, and each sample is used once an epoch.

The rollout is the trainer's `PolicyRollout`: one captured CUDA graph on
the card, a loop on the CPU.  It keeps the UNCLIPPED Gaussian sample (SB3 buffers it
unclipped and clips at the env), its log-probability and the value; the
value of each step's final observation, from the value tower alone, is
taken after the rollout for all steps at once.  The optimiser is
`optax.chain(clip_by_global_norm(max_grad_norm), adam(lr))` in optax's
arithmetic, applied to the parameters IN PLACE: the captured rollout reads
them where they live.

Randomness comes from an explicit `torch.Generator` on the trainer's device
(`PPOTrainer.generator(seed)`); `_update_epoch` also takes an injected
permutation, so that a test can feed this package and the JAX package the
same draws.

Under a mesh (the engine's, parallel/mesh.py) a rank rolls out its lanes and
the rollout batch is gathered over the data axis before GAE, so every rank
shuffles and steps the same minibatches of the global batch and the
parameters stay equal on every rank.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch.func import functional_call

from ..engine.core import EnvEngine, PolicyRollout
from . import networks
from .offpolicy import (AdamState, adam_init, adam_update, lane_randn, note_layout,
                        with_whole_params)

LANE_TILE = 128  # minibatch granularity, as in the JAX trainer


class PPOConfig(NamedTuple):
    lanes: int = 4096
    rollout_len: int = 64        # on-policy horizon per iteration
    epochs: int = 10             # SB3 n_epochs
    minibatches: int = 32        # minibatches per epoch
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip: float = 0.2
    lr: float = 3e-4
    vf_coef: float = 0.5
    ent_coef: float = 0.0
    max_grad_norm: float = 0.5
    hidden: tuple = (64, 64)     # SB3 MlpPolicy default


class PPOState(NamedTuple):
    params: dict                 # GaussianActorValue's, updated in place
    opt: AdamState               # clip_by_global_norm keeps no state
    env_state: object
    obs: torch.Tensor
    step: int


def clip_by_global_norm(grads: dict, max_norm: float) -> dict:
    """optax.clip_by_global_norm: the gradients as they are when their global
    norm is below max_norm, else each divided by the norm and times max_norm
    (no host synchronisation)."""
    norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
    keep = norm < max_norm
    return {k: torch.where(keep, g, g / norm * max_norm) for k, g in grads.items()}


class PPOTrainer:
    """PPO over one continuous EnvEngine, on the engine's device: the card
    unless the engine was made with `device="cpu"`.

    >>> tr = PPOTrainer(EnvEngine(get_config("GoalContinuous2P-v0")))
    >>> st = tr.init(0)
    >>> st, metrics = tr.train_iter(st, tr.generator(1))
    """

    def __init__(self, engine: EnvEngine, config: PPOConfig = PPOConfig()):
        if not engine.config.continuous:
            raise ValueError("PPO requires a continuous-action env config")
        c = config
        if (c.lanes * c.rollout_len) % (c.minibatches * LANE_TILE):
            raise ValueError(
                f"lanes*rollout_len={c.lanes * c.rollout_len} must split into "
                f"minibatches={c.minibatches} of whole {LANE_TILE}-lane tiles")
        self.engine = engine
        self.device = engine.device
        self.cfg = config
        self.mesh = engine.mesh
        self.shardings = None
        self.obs_dim = engine.obs_dim
        self.action_dim = engine.config.action_dim
        self.net = networks.GaussianActorValue(self.obs_dim, self.action_dim, config.hidden)
        self.collect = PolicyRollout(engine, self._explore, config.rollout_len)

    def generator(self, seed: int) -> torch.Generator:
        """A seeded generator on the trainer's device."""
        return torch.Generator(device=self.device).manual_seed(seed)

    def init(self, seed: int = 0) -> PPOState:
        """Fresh network (drawn on the CPU from `seed`, then moved) and env
        lanes."""
        g = torch.Generator().manual_seed(seed)
        net = networks.GaussianActorValue(self.obs_dim, self.action_dim, self.cfg.hidden,
                                          generator=g)
        params = {k: v.detach().to(self.device) for k, v in net.state_dict().items()}
        env_state, obs = self.engine.reset(self.cfg.lanes, self.engine.generator(seed))
        return note_layout(self, PPOState(params=params, opt=adam_init(params),
                                          env_state=env_state, obs=obs, step=0))

    # -------------------------------------------------------------- acting --
    def act(self, params, obs, generator=None):
        """A sampled action, clipped to [-1, 1]."""
        with torch.no_grad():
            mean, log_std, _ = functional_call(self.net, params, (obs,))
            eps = lane_randn(self.engine, mean, generator)
            return torch.clamp(mean + torch.exp(log_std) * eps, -1.0, 1.0)

    def eval_act(self, params, obs):
        """The mean action, clipped."""
        with torch.no_grad():
            return torch.clamp(functional_call(self.net, params, (obs,))[0], -1.0, 1.0)

    def _explore(self, params, generator, obs):
        """The rollout's policy: the clipped sample for the env; the unclipped
        sample, its log-probability and the value kept."""
        mean, log_std, value = functional_call(self.net, params, (obs,))
        a = mean + torch.exp(log_std) * lane_randn(self.engine, mean, generator)
        logp = networks.gaussian_logp(a, mean, log_std)
        return torch.clamp(a, -1.0, 1.0), {"action": a, "logp": logp, "value": value}

    def _value(self, params, obs):
        """The value tower alone."""
        vf = {k[3:]: v for k, v in params.items() if k.startswith("vf.")}
        head = {k[6:]: v for k, v in params.items() if k.startswith("vhead.")}
        h = functional_call(self.net.vf, vf, (obs,))
        return functional_call(self.net.vhead, head, (h,))[..., 0]

    # ------------------------------------------------------------- training --
    def _rollout(self, state: PPOState, generator):
        """cfg.rollout_len on-policy steps; returns (env_state, obs, data)
        with (T, lanes, ...) leaves obs, action, logp, value, reward, nonterm,
        nondone, final_value, and the dones; under a mesh `data` and the
        dones are the global lanes', gathered over the data axis."""
        env_state, obs, traj = self.collect(state.params, state.env_state, state.obs, generator)
        t_len, lanes = traj.reward.shape
        fv = self._value(state.params, traj.final_obs.reshape(t_len * lanes, -1))
        one = torch.ones((), dtype=traj.reward.dtype, device=traj.reward.device)
        data = dict(obs=traj.obs, action=traj.kept["action"], logp=traj.kept["logp"],
                    value=traj.kept["value"], reward=traj.reward,
                    # GAE bootstraps through truncations, not terminations
                    nonterm=one - traj.terminated.to(one.dtype),
                    nondone=one - traj.done.to(one.dtype),
                    final_value=fv.reshape(t_len, lanes))
        done = traj.done
        if self.mesh is not None:
            data = {k: self.mesh.all_gather(v, "data", dim=1) for k, v in data.items()}
            done = self.mesh.all_gather(done, "data", dim=1)
        return env_state, obs, data, done

    def _gae(self, tr: dict):
        """Reverse GAE: the trace stops at every done (the next state is a new
        episode's); the bootstrap is the value of the true next observation
        (final_value) where the step did not terminate, so a truncation
        bootstraps and a termination does not."""
        c = self.cfg
        adv_next = torch.zeros_like(tr["value"][0])
        advs = []
        for t in reversed(range(tr["value"].shape[0])):
            delta = tr["reward"][t] + c.gamma * tr["nonterm"][t] * tr["final_value"][t] \
                - tr["value"][t]
            adv_next = delta + c.gamma * c.gae_lambda * tr["nondone"][t] * adv_next
            advs.append(adv_next)
        advs = torch.stack(advs[::-1])
        return advs, advs + tr["value"]

    def _loss(self, params, mb):
        """The minibatch loss; returns (loss, policy loss, value loss)."""
        c = self.cfg
        mean, log_std, value = functional_call(self.net, params, (mb["obs"],))
        logp = networks.gaussian_logp(mb["action"], mean, log_std)
        ratio = torch.exp(logp - mb["logp"])
        adv = mb["adv"]
        adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)  # SB3: per minibatch
        pg = -torch.minimum(ratio * adv, torch.clamp(ratio, 1 - c.clip, 1 + c.clip) * adv).mean()
        vf = ((value - mb["ret"]) ** 2).mean()
        ent = (log_std[0] + 0.5 * math.log(2 * math.pi * math.e)).sum()
        return pg + c.vf_coef * vf - c.ent_coef * ent, pg, vf

    def _update_epoch(self, params, opt: AdamState, data, generator=None, perm=None):
        """One epoch: permute the (T, lane tile) tiles (or take the injected
        `perm`), then one clipped Adam step a minibatch, written into
        `params` in place.  Returns (opt, last policy loss, last value
        loss)."""
        c = self.cfg
        n_tiles = data["obs"].shape[0]
        if perm is None:
            perm = torch.randperm(n_tiles, generator=generator, device=self.device)
        idxs = perm.reshape(c.minibatches, n_tiles // c.minibatches)
        pg = vf = None
        for idx in idxs:
            mb = {k: x[idx].reshape(-1, *x.shape[2:]) for k, x in data.items()}
            p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
            loss, pg, vf = self._loss(p, mb)
            grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
            upd, opt = adam_update(clip_by_global_norm(grads, c.max_grad_norm), opt, c.lr)
            with torch.no_grad():
                for k, v in params.items():
                    v.add_(upd[k])
        return opt, pg.detach(), vf.detach()

    def train_iter(self, state: PPOState, generator):
        """One rollout, GAE, `epochs` epochs of minibatch updates."""
        return with_whole_params(self, state, lambda s: self._train_iter(s, generator))

    def _train_iter(self, state: PPOState, generator):
        c = self.cfg
        with torch.no_grad():
            env_state, obs, tr, dones = self._rollout(state, generator)
            adv, ret = self._gae(tr)
        t_len, lanes = tr["reward"].shape

        def tiled(x):  # (T, L, ...) -> (T * L / 128, 128, ...) lane tiles
            return x.reshape(t_len * (lanes // LANE_TILE), LANE_TILE, *x.shape[2:])

        data = {"obs": tiled(tr["obs"]), "action": tiled(tr["action"]),
                "logp": tiled(tr["logp"]), "adv": tiled(adv), "ret": tiled(ret)}
        opt = state.opt
        pg = vf = torch.zeros((), device=self.device)
        for _ in range(c.epochs):
            opt, pg, vf = self._update_epoch(state.params, opt, data, generator)
        metrics = {"policy_loss": pg, "value_loss": vf, "mean_reward": tr["reward"].mean(),
                   "episodes_done": dones.sum()}
        return state._replace(opt=opt, env_state=env_state, obs=obs, step=state.step + 1), metrics

    def train_iters(self, state: PPOState, generator, n: int):
        """n train_iters; returns the last iteration's metrics."""
        metrics = {}
        for _ in range(n):
            state, metrics = self.train_iter(state, generator)
        return state, metrics
