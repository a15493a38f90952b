"""Twin-Delayed DDPG (TD3) on the batched env engine.

Port of space_gym_tpu/models/td3.py, shaped like models/sac.py.  One
`train_iter` is a rollout over thousands of lanes on the engine's device, an
insert into the replay ring, and `updates_per_iter` clipped double-Q updates
with target policy smoothing and delayed actor and target updates.  With
`fused_updates=True` the updates are one launch of a hand-written CUDA kernel
(models/fused_td3.py: K6) on the kernel-layout learner state, sampling the
replay ring inside the kernel; on `device="cpu"` the same entry points run
the plain PyTorch version.

Parameters are plain dicts of tensors, named like the networks' state dicts,
and the networks are applied to them functionally (`torch.func`), so that the
actor used for rollouts is six views of the fused state's `w` and `vec`,
always current after the kernel's in-place update.

Randomness comes from an explicit `torch.Generator` on the trainer's device
(`TD3Trainer.generator(seed)`); `_update_once` and `_update_fused` also take
injected batches or row indices and normals, so that a test can feed this
package and the JAX package the same draws.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import functional_call

from ..engine.core import EnvEngine
from . import fused_td3, networks
from .offpolicy import (AdamState, OffPolicyTrainer, _add_, _tmap, adam_init, adam_update,
                        lane_randn, note_layout)
from .replay import ReplayState, Transition, replay_init, replay_sample


class TD3Config(NamedTuple):
    lanes: int = 4096
    rollout_len: int = 32
    replay_rows: int = 2048
    batch_size: int = 4096
    updates_per_iter: int = 4
    gamma: float = 0.99
    tau: float = 0.005
    lr: float = 3e-4
    explore_std: float = 0.1     # behavior-policy Gaussian noise
    smooth_std: float = 0.2      # target policy smoothing noise
    smooth_clip: float = 0.5
    policy_delay: int = 2        # actor/target update every k-th critic update
    hidden: tuple = (256, 256)
    warmup_rows: int = 32
    # Fused learner (models/fused_td3): all K updates in one kernel launch on
    # the card (the plain PyTorch version on the CPU), kernel-layout state
    # kept across iterations.
    fused_updates: bool = False
    fused_block: int = 2048      # the JAX kernel's batch tile; checked, see fused_td3


class TD3State(NamedTuple):
    """Full training state.

    With cfg.fused_updates the CANONICAL learner state is `fused`
    (models.fused_td3.FusedState).  `actor_params` are then views of it and
    `n_updates` its count; the other parameter and opt fields stay at their
    init snapshot: read them through models.fused_td3.fused_unpack."""

    actor_params: dict
    target_actor_params: dict
    critic_params: dict
    target_critic_params: dict
    actor_opt: AdamState
    critic_opt: AdamState
    env_state: object           # engine EnvState (batched)
    obs: torch.Tensor           # (lanes, obs_dim)
    replay: ReplayState
    n_updates: int              # critic updates so far (for the delay)
    step: int                   # train_iter counter
    fused: object = None        # FusedState when cfg.fused_updates else None


class TD3Trainer(OffPolicyTrainer):
    """TD3 over one EnvEngine, on the engine's device: the card unless the
    engine was made with `device="cpu"`.

    >>> tr = TD3Trainer(EnvEngine(get_config("GoalContinuous2P-v0")))
    >>> st = tr.init(0)
    >>> st, metrics = tr.train_iter(st, tr.generator(1))
    """

    name = "TD3"

    def __init__(self, engine: EnvEngine, config: TD3Config = TD3Config(), device=None):
        super().__init__(engine, config, fused_td3, device)
        self._ft = self._layout
        self.actor = networks.DeterministicActor(self.obs_dim, self.action_dim, config.hidden)
        self.critic = networks.DoubleCritic(self.obs_dim, self.action_dim, config.hidden)

    # ----------------------------------------------------------------- init --
    def init(self, seed: int = 0) -> TD3State:
        """Fresh networks (drawn on the CPU from `seed`, then moved; the
        targets start as copies), env lanes and an empty replay ring."""
        c = self.cfg
        g = torch.Generator().manual_seed(seed)
        dev = self.device

        def fresh(module):
            return {k: v.detach().to(dev) for k, v in module.state_dict().items()}

        def copy(params):
            return {k: v.clone() for k, v in params.items()}

        actor_params = fresh(networks.DeterministicActor(
            self.obs_dim, self.action_dim, c.hidden, generator=g))
        critic_params = fresh(networks.DoubleCritic(
            self.obs_dim, self.action_dim, c.hidden, generator=g))
        target_actor, target_critic = copy(actor_params), copy(critic_params)
        env_state, obs = self.engine.reset(c.lanes, self.engine.generator(seed))
        fused = None
        if c.fused_updates:
            packed = self._ft.pack_params(actor_params, target_actor, critic_params, target_critic)
            fused = self._ft.fused_init(packed, self._ft.adam_init(packed))
        state = TD3State(
            fused=fused,
            actor_params=actor_params,
            target_actor_params=target_actor,
            critic_params=critic_params,
            target_critic_params=target_critic,
            actor_opt=adam_init(actor_params),
            critic_opt=adam_init(critic_params),
            env_state=env_state,
            obs=obs,
            replay=replay_init(c.replay_rows, c.lanes, self.obs_dim, self.action_dim,
                               self.engine.dtype, dev),
            n_updates=0,
            step=0,
        )
        return note_layout(self, self._refresh_from_fused(state) if c.fused_updates else state)

    # -------------------------------------------------------------- acting --
    def act(self, actor_params, obs, generator=None, eps=None):
        """The behavior policy: the actor's action plus explore_std times a
        standard normal (`eps`, drawn from `generator` when None), clipped."""
        with torch.no_grad():
            a = functional_call(self.actor, actor_params, (obs,))
            if eps is None:
                eps = lane_randn(self.engine, a, generator)
            return torch.clamp(a + self.cfg.explore_std * eps, -1.0, 1.0)

    def eval_act(self, actor_params, obs):
        """The deterministic action."""
        with torch.no_grad():
            return functional_call(self.actor, actor_params, (obs,))

    # ------------------------------------------------------------- training --
    def _critic_loss(self, critic_params, state: TD3State, batch: Transition, eps):
        """`eps`: (B, A) standard normals of the target policy smoothing."""
        c = self.cfg
        with torch.no_grad():
            noise = torch.clamp(c.smooth_std * eps, -c.smooth_clip, c.smooth_clip)
            next_a = torch.clamp(
                functional_call(self.actor, state.target_actor_params, (batch.next_obs,)) + noise,
                -1.0, 1.0)
            q1t, q2t = functional_call(self.critic, state.target_critic_params,
                                       (batch.next_obs, next_a))
            target_q = batch.reward + c.gamma * batch.discount * torch.minimum(q1t, q2t)
        q1, q2 = functional_call(self.critic, critic_params, (batch.obs, batch.action))
        return ((q1 - target_q) ** 2 + (q2 - target_q) ** 2).mean()

    def _actor_loss(self, actor_params, critic_params, batch: Transition):
        a = functional_call(self.actor, actor_params, (batch.obs,))
        q1, _ = functional_call(self.critic, critic_params, (batch.obs, a))
        return -q1.mean()

    def _update_once(self, state: TD3State, generator=None, batch=None, noise=None):
        """One unfused update: torch.autograd and `adam_update`, written into
        the parameter tensors in place (the rollout's captured graph reads
        the actor where it lives).  `batch` (Transition with (B, ...) leaves)
        and `noise` ((B, A) smoothing normals) may be injected."""
        c = self.cfg
        if batch is None:
            batch = replay_sample(state.replay, generator, c.batch_size, mesh=self.mesh)
        if noise is None:
            noise = torch.randn((batch.reward.shape[0], self.action_dim), generator=generator,
                                device=self.device)

        def with_grad(params):
            return {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}

        cp = with_grad(state.critic_params)
        critic_loss = self._critic_loss(cp, state, batch, noise)
        grads = dict(zip(cp, torch.autograd.grad(critic_loss, list(cp.values()))))
        upd, critic_opt = adam_update(grads, state.critic_opt, c.lr)
        critic_params = _tmap(_add_, state.critic_params, upd)

        ap = with_grad(state.actor_params)
        actor_loss = self._actor_loss(ap, critic_params, batch)
        # Delayed actor and target updates: on the other updates the loss is
        # reported and nothing else of the actor's side moves, its Adam count
        # included.
        actor_params, actor_opt = state.actor_params, state.actor_opt
        target_actor, target_critic = state.target_actor_params, state.target_critic_params
        if state.n_updates % c.policy_delay == 0:
            grads = dict(zip(ap, torch.autograd.grad(actor_loss, list(ap.values()))))
            upd, actor_opt = adam_update(grads, state.actor_opt, c.lr)
            actor_params = _tmap(_add_, state.actor_params, upd)

            def polyak(t, p):
                return _tmap(lambda ti, pi: ti.copy_(ti * (1 - c.tau) + pi * c.tau), t, p)

            target_actor = polyak(target_actor, actor_params)
            target_critic = polyak(target_critic, critic_params)

        state = state._replace(
            actor_params=actor_params, target_actor_params=target_actor,
            critic_params=critic_params, target_critic_params=target_critic,
            actor_opt=actor_opt, critic_opt=critic_opt, n_updates=state.n_updates + 1,
        )
        return state, {"critic_loss": critic_loss.detach(), "actor_loss": actor_loss.detach()}

    def _update_fused(self, state: TD3State, generator=None, row_idx=None, batches=None,
                      noises=None):
        """All K updates through models/fused_td3 on the cached kernel-layout
        state: one kernel launch on the card, the plain PyTorch version on
        the CPU.  When minibatches are whole replay rows the ring itself goes
        to the kernel with the sampled `row_idx` ((K * batch // lanes,), may be
        injected); else, or when `batches` (Transition, (K, B, ...) leaves) is
        injected, gathered minibatches do.  `noises`: (K, B, A) normals."""
        ft, c = self._need_layout(), self.cfg
        if noises is None:
            noises = torch.randn((c.updates_per_iter, c.batch_size, self.action_dim),
                                 generator=generator, device=self.device)
        args = dict(obs_dim=self.obs_dim, gamma=c.gamma, tau=c.tau, lr=c.lr,
                    smooth_std=c.smooth_std, smooth_clip=c.smooth_clip,
                    policy_delay=c.policy_delay, block=c.fused_block,
                    # bfloat16-rounded products on the card, as the JAX trainer
                    # on a TPU; float32 on the CPU, as the JAX trainer off it
                    mm_bf16=self.device.type == "cuda")
        ring, row_idx, batches = self._fused_minibatches(state, generator, row_idx, batches)
        if batches is None:
            fstate, closs, aloss = ft.fused_update_k_wmat(
                state.fused, ring, row_idx, noises, **args)
        else:
            fstate, closs, aloss = ft.fused_update_k_wmat_batches(
                state.fused, batches, noises, **args)
        state = self._refresh_from_fused(state._replace(fused=fstate))
        return state, {"critic_loss": closs[-1], "actor_loss": aloss[-1]}

    def _refresh_from_fused(self, state: TD3State) -> TD3State:
        """`actor_params` as views of the fused state, `n_updates` its count."""
        f = state.fused
        return state._replace(
            actor_params=self._ft.unpack_actor(f.w, f.vec, self.obs_dim, self.action_dim),
            n_updates=f.count)

    # ------------------------------------------------------ format bridges --
    def migrate_to_fused(self, state: TD3State) -> TD3State:
        """Rebuild the kernel-layout `fused` state from the parameter dicts
        and Adam states of an unfused run.  TD3 keeps separate Adam counts for
        the critics (every update) and the delayed actor; the targets' moment
        slots are unused (targets move by polyak, not Adam)."""
        ft = self._need_layout()
        zeros_a = _tmap(torch.zeros_like, state.target_actor_params)
        zeros_c = _tmap(torch.zeros_like, state.target_critic_params)
        packed = ft.pack_params(state.actor_params, state.target_actor_params,
                                state.critic_params, state.target_critic_params)
        adam = ft.PackedAdam(
            m=ft.pack_params(state.actor_opt.mu, zeros_a, state.critic_opt.mu, zeros_c),
            v=ft.pack_params(state.actor_opt.nu, zeros_a, state.critic_opt.nu, zeros_c),
            count=state.critic_opt.count, count_a=state.actor_opt.count,
        )
        return state._replace(fused=ft.fused_init(packed, adam),
                              n_updates=state.critic_opt.count)

    def rehydrate_from_fused(self, state: TD3State) -> TD3State:
        """Inverse bridge: the parameter dicts AND Adam moments from a
        fused-mode state, so that an unfused run resumes the same trajectory
        (in fused mode the critic, target and opt fields freeze at their init
        snapshot)."""
        ft = self._need_layout()
        packed, adam = ft.fused_unpack(state.fused)

        def own(trees):
            return [_tmap(lambda x: x.clone(), t) for t in trees]

        actor, tactor, critic, target = own(
            ft.unpack_params(packed, self.obs_dim, self.action_dim))
        a_mu, _, c_mu, _ = own(ft.unpack_params(adam.m, self.obs_dim, self.action_dim))
        a_nu, _, c_nu, _ = own(ft.unpack_params(adam.v, self.obs_dim, self.action_dim))
        return state._replace(
            actor_params=actor, target_actor_params=tactor,
            critic_params=critic, target_critic_params=target,
            actor_opt=AdamState(adam.count_a, a_mu, a_nu),
            critic_opt=AdamState(adam.count, c_mu, c_nu),
            n_updates=adam.count,
            fused=None,
        )
