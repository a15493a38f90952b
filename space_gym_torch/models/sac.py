"""Soft Actor-Critic on the batched env engine.

Port of space_gym_tpu/models/sac.py.  One `train_iter` is a rollout over
thousands of lanes on the engine's device, an insert into the replay ring,
and `updates_per_iter` gradient updates.  With `fused_updates=True` the
updates are one launch of a hand-written CUDA kernel (models/fused_sac.py: K4
with `fused_fold=False`, K5 with `fused_fold=True`) on the kernel-layout
learner state, sampling the replay ring inside the kernel; on `device="cpu"`
the same entry points run the plain PyTorch version.

Parameters are plain dicts of tensors, named like the networks' state dicts,
and the networks are applied to them functionally (`torch.func`), so that the
actor used for rollouts is eight views of the fused state's `w` and `vec`,
always current after the kernel's in-place update.

Randomness comes from an explicit `torch.Generator` on the trainer's device
(`SACTrainer.generator(seed)`); `_update_once` and `_update_fused` also take
injected batches or row indices and normals, so that a test can feed this
package and the JAX package the same draws.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch.func import functional_call

from ..engine.core import EnvEngine
from . import fused_sac, networks
from .offpolicy import (AdamState, OffPolicyTrainer, _add_, _tmap, adam_init, adam_update,
                        lane_randn, note_layout)
from .replay import ReplayState, Transition, nstep_slab, replay_init, replay_sample


class SACConfig(NamedTuple):
    lanes: int = 4096            # parallel env lanes
    rollout_len: int = 32        # env steps per train_iter
    replay_rows: int = 2048      # replay capacity = rows * lanes transitions
    batch_size: int = 4096       # minibatch per gradient update
    updates_per_iter: int = 4    # gradient updates per train_iter
    gamma: float = 0.99
    tau: float = 0.005           # target polyak rate
    lr: float = 3e-4
    init_alpha: float = 0.1
    hidden: tuple = (256, 256)
    warmup_rows: int = 32        # min filled rows before updates count
    n_step: int = 1              # n-step TD targets, computed inside the rollout slab
    alpha_floor: float = 0.0     # lower bound on the entropy temperature
    reward_scale: float = 1.0    # multiply rewards entering the replay buffer
    # Entropy target for the temperature loss; None = SB3 default -dim(A).
    target_entropy: float | None = None
    # Fused learner (models/fused_sac): all K updates in one kernel launch on
    # the card (the plain PyTorch version on the CPU).  Same losses, Adam and
    # polyak as the unfused path; the sampling noise is drawn up front.
    fused_updates: bool = False
    fused_block: int = 2048      # the JAX kernels' batch tile; checked, see fused_sac
    fused_fold: bool = False     # K5 instead of K4: the minibatch stays in shared memory


class SACState(NamedTuple):
    """Full training state.

    With cfg.fused_updates the CANONICAL learner state is `fused` (the
    kernel-layout FusedState).  `actor_params` and `log_alpha` are then views
    of it; `critic_params`, `target_critic_params` and the *_opt states stay
    at their init snapshot: read the critics through
    models.fused_sac.fused_unpack instead."""

    actor_params: dict
    critic_params: dict
    target_critic_params: dict
    log_alpha: torch.Tensor
    actor_opt: AdamState
    critic_opt: AdamState
    alpha_opt: AdamState
    env_state: object           # engine EnvState (batched)
    obs: torch.Tensor           # (lanes, obs_dim)
    replay: ReplayState
    step: int                   # train_iter counter
    fused: object = None        # FusedState when cfg.fused_updates else None


class SACTrainer(OffPolicyTrainer):
    """SAC over one EnvEngine, on the engine's device: the card unless the
    engine was made with `device="cpu"`.

    >>> tr = SACTrainer(EnvEngine(get_config("GoalContinuous2P-v0")))
    >>> st = tr.init(0)
    >>> st, metrics = tr.train_iter(st, tr.generator(1))
    """

    name = "SAC"

    def __init__(self, engine: EnvEngine, config: SACConfig = SACConfig(), device=None):
        super().__init__(engine, config, fused_sac, device)
        self._fs = self._layout
        self.reward_scale = config.reward_scale
        self.actor = networks.TanhGaussianActor(self.obs_dim, self.action_dim, config.hidden)
        self.critic = networks.DoubleCritic(self.obs_dim, self.action_dim, config.hidden)
        self.target_entropy = (-float(self.action_dim) if config.target_entropy is None
                               else float(config.target_entropy))

    # ----------------------------------------------------------------- init --
    def init(self, seed: int = 0) -> SACState:
        """Fresh networks (drawn on the CPU from `seed`, then moved), env
        lanes and an empty replay ring."""
        c = self.cfg
        g = torch.Generator().manual_seed(seed)
        dev = self.device

        def fresh(module):
            return {k: v.detach().to(dev) for k, v in module.state_dict().items()}

        actor_params = fresh(networks.TanhGaussianActor(
            self.obs_dim, self.action_dim, c.hidden, generator=g))
        critic_params = fresh(networks.DoubleCritic(
            self.obs_dim, self.action_dim, c.hidden, generator=g))
        target = {k: v.clone() for k, v in critic_params.items()}
        log_alpha = torch.tensor(math.log(c.init_alpha), dtype=torch.float32, device=dev)
        env_state, obs = self.engine.reset(c.lanes, self.engine.generator(seed))
        fused = None
        if c.fused_updates:
            packed = self._fs.pack_params(actor_params, critic_params, target, log_alpha)
            fused = self._fs.fused_init(packed, self._fs.adam_init(packed))
        state = SACState(
            fused=fused,
            actor_params=actor_params,
            critic_params=critic_params,
            target_critic_params=target,
            log_alpha=log_alpha,
            actor_opt=adam_init(actor_params),
            critic_opt=adam_init(critic_params),
            alpha_opt=adam_init(log_alpha),
            env_state=env_state,
            obs=obs,
            replay=replay_init(c.replay_rows, c.lanes, self.obs_dim, self.action_dim,
                               self.engine.dtype, dev),
            step=0,
        )
        return note_layout(self, self._refresh_from_fused(state) if c.fused_updates else state)

    # -------------------------------------------------------------- acting --
    def act(self, actor_params, obs, generator=None, eps=None):
        """A sampled action for every row of obs."""
        with torch.no_grad():
            mean, log_std = functional_call(self.actor, actor_params, (obs,))
            if eps is None:
                eps = lane_randn(self.engine, mean, generator)
            return networks.sample_tanh_gaussian(mean, log_std, eps)[0]

    def eval_act(self, actor_params, obs):
        """The deterministic action tanh(mean)."""
        with torch.no_grad():
            return torch.tanh(functional_call(self.actor, actor_params, (obs,))[0])

    # ------------------------------------------------------------- training --
    def _critic_loss(self, critic_params, state: SACState, batch: Transition, eps):
        c = self.cfg
        with torch.no_grad():
            alpha = torch.exp(state.log_alpha)
            mean, log_std = functional_call(self.actor, state.actor_params, (batch.next_obs,))
            next_a, next_logp = networks.sample_tanh_gaussian(mean, log_std, eps)
            q1t, q2t = functional_call(self.critic, state.target_critic_params,
                                       (batch.next_obs, next_a))
            target_q = batch.reward + c.gamma * batch.discount * (
                torch.minimum(q1t, q2t) - alpha * next_logp)
        q1, q2 = functional_call(self.critic, critic_params, (batch.obs, batch.action))
        return ((q1 - target_q) ** 2 + (q2 - target_q) ** 2).mean()

    def _actor_loss(self, actor_params, state: SACState, critic_params, batch, eps):
        alpha = torch.exp(state.log_alpha).detach()
        mean, log_std = functional_call(self.actor, actor_params, (batch.obs,))
        a, logp = networks.sample_tanh_gaussian(mean, log_std, eps)
        q1, q2 = functional_call(self.critic, critic_params, (batch.obs, a))
        return (alpha * logp - torch.minimum(q1, q2)).mean(), logp

    def _update_once(self, state: SACState, generator=None, batch=None, noise=None):
        """One unfused update: torch.autograd and `adam_update`, written into
        the parameter tensors and log_alpha in place (the rollout's captured
        graph reads the actor where it lives).  `batch` (Transition with
        (B, ...) leaves) and `noise` ((B, 2, A) normals, [:, 0] for the
        critic's next action, [:, 1] for the actor's) may be injected."""
        c = self.cfg
        if batch is None:
            batch = replay_sample(state.replay, generator, c.batch_size, mesh=self.mesh)
        if noise is None:
            noise = torch.randn((batch.reward.shape[0], 2, self.action_dim), generator=generator,
                                device=self.device)

        def with_grad(params):
            return {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}

        cp = with_grad(state.critic_params)
        critic_loss = self._critic_loss(cp, state, batch, noise[:, 0])
        grads = dict(zip(cp, torch.autograd.grad(critic_loss, list(cp.values()))))
        upd, critic_opt = adam_update(grads, state.critic_opt, c.lr)
        critic_params = _tmap(_add_, state.critic_params, upd)

        ap = with_grad(state.actor_params)
        actor_loss, logp = self._actor_loss(ap, state, critic_params, batch, noise[:, 1])
        grads = dict(zip(ap, torch.autograd.grad(actor_loss, list(ap.values()))))
        upd, actor_opt = adam_update(grads, state.actor_opt, c.lr)
        actor_params = _tmap(_add_, state.actor_params, upd)

        # temperature toward the target entropy: d/d log_alpha of
        # mean(-log_alpha * (logp + target_entropy))
        alpha_grad = -(logp.detach() + self.target_entropy).mean()
        upd, alpha_opt = adam_update(alpha_grad, state.alpha_opt, c.lr)
        log_alpha = state.log_alpha + upd
        if c.alpha_floor > 0:
            log_alpha = torch.clamp(log_alpha, min=math.log(c.alpha_floor))
        log_alpha = state.log_alpha.copy_(log_alpha)

        target = _tmap(lambda t, p: t.copy_(t * (1 - c.tau) + p * c.tau),
                       state.target_critic_params, critic_params)
        state = state._replace(
            actor_params=actor_params, critic_params=critic_params,
            target_critic_params=target, log_alpha=log_alpha,
            actor_opt=actor_opt, critic_opt=critic_opt, alpha_opt=alpha_opt,
        )
        return state, {"critic_loss": critic_loss.detach(), "actor_loss": actor_loss.detach()}

    def _update_fused(self, state: SACState, generator=None, row_idx=None, batches=None,
                      noises=None):
        """All K updates through models/fused_sac on the cached kernel-layout
        state: one kernel launch on the card, the plain PyTorch version on
        the CPU.  When minibatches are whole replay rows the ring itself goes
        to the kernel with the sampled `row_idx` ((K * batch // lanes,), may be
        injected); else, or when `batches` (Transition, (K, B, ...) leaves) is
        injected, gathered minibatches do.  `noises`: (K, B, 2, A) normals."""
        fs, c = self._fs, self.cfg
        if noises is None:
            noises = torch.randn((c.updates_per_iter, c.batch_size, 2, self.action_dim),
                                 generator=generator, device=self.device)
        args = dict(obs_dim=self.obs_dim, gamma=c.gamma, tau=c.tau, lr=c.lr,
                    target_entropy=self.target_entropy, alpha_floor=c.alpha_floor,
                    block=c.fused_block, fold=c.fused_fold,
                    # bfloat16-rounded products on the card, as the JAX trainer
                    # on a TPU; float32 on the CPU, as the JAX trainer off it
                    mm_bf16=self.device.type == "cuda")
        ring, row_idx, batches = self._fused_minibatches(state, generator, row_idx, batches)
        if batches is None:
            fstate, closs, aloss = fs.fused_update_k_wmat(
                state.fused, ring, row_idx, noises, **args)
        else:
            fstate, closs, aloss = fs.fused_update_k_wmat_batches(
                state.fused, batches, noises, **args)
        state = self._refresh_from_fused(state._replace(fused=fstate))
        return state, {"critic_loss": closs[-1], "actor_loss": aloss[-1]}

    def _refresh_from_fused(self, state: SACState) -> SACState:
        """`actor_params` and `log_alpha` as views of the fused state."""
        f = state.fused
        return state._replace(
            actor_params=self._fs.unpack_actor(f.w, f.vec, self.obs_dim, self.action_dim),
            log_alpha=f.vec[self._fs.V_MISC, self._fs.M_LA])

    def _slab_for_replay(self, slab, dones):
        return nstep_slab(slab, dones, self.cfg.gamma, self.cfg.n_step)

    def _iter_metrics(self, state: SACState) -> dict:
        return {"alpha": torch.exp(state.log_alpha.detach())}

    # ------------------------------------------------------ format bridges --
    def migrate_to_fused(self, state: SACState) -> SACState:
        """Rebuild the kernel-layout `fused` state from the parameter dicts
        and Adam states of an unfused run.  The target critics' moment slots
        are unused (targets move by polyak, not Adam)."""
        fs = self._need_layout()
        zeros_t = _tmap(torch.zeros_like, state.target_critic_params)
        packed = fs.pack_params(state.actor_params, state.critic_params,
                                state.target_critic_params, state.log_alpha)
        adam = fs.PackedAdam(
            m=fs.pack_params(state.actor_opt.mu, state.critic_opt.mu, zeros_t,
                             state.alpha_opt.mu),
            v=fs.pack_params(state.actor_opt.nu, state.critic_opt.nu, zeros_t,
                             state.alpha_opt.nu),
            count=state.critic_opt.count,
        )
        return state._replace(fused=fs.fused_init(packed, adam))

    def rehydrate_from_fused(self, state: SACState) -> SACState:
        """Inverse bridge: the parameter dicts AND Adam moments from a
        fused-mode state, so that an unfused run resumes the same trajectory
        (in fused mode the critic and opt fields freeze at their init
        snapshot)."""
        fs = self._need_layout()
        packed, adam = fs.fused_unpack(state.fused)

        def own(trees):
            return [_tmap(lambda x: x.clone(), t) for t in trees]

        actor, critic, target, log_alpha = own(
            fs.unpack_params(packed, self.obs_dim, self.action_dim))
        a_mu, c_mu, _, la_mu = own(fs.unpack_params(adam.m, self.obs_dim, self.action_dim))
        a_nu, c_nu, _, la_nu = own(fs.unpack_params(adam.v, self.obs_dim, self.action_dim))
        return state._replace(
            actor_params=actor, critic_params=critic, target_critic_params=target,
            log_alpha=log_alpha,
            actor_opt=AdamState(adam.count, a_mu, a_nu),
            critic_opt=AdamState(adam.count, c_mu, c_nu),
            alpha_opt=AdamState(adam.count, la_mu, la_nu),
            fused=None,
        )
