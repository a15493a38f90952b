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
from .replay import (ReplayState, Transition, nstep_slab, replay_add_slab, replay_init,
                     replay_sample, replay_sample_rows)

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


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


class AdamState(NamedTuple):
    """optax.adam's state: the step count and the two moments, shaped like
    the parameters (a dict of tensors, or one tensor)."""

    count: int
    mu: object
    nu: object


def _tmap(fn, *trees):
    """fn over the leaves of flat dicts of tensors (or over single tensors)."""
    if isinstance(trees[0], dict):
        return {k: fn(*[t[k] for t in trees]) for k in trees[0]}
    return fn(*trees)


def adam_init(params) -> AdamState:
    return AdamState(0, _tmap(torch.zeros_like, params), _tmap(torch.zeros_like, params))


def adam_update(grads, st: AdamState, lr: float):
    """(updates, new state) of optax.adam(lr) with its defaults (b1 0.9, b2
    0.999, eps 1e-8 outside the root, eps_root 0)."""
    count = st.count + 1
    mu = _tmap(lambda m, g: ADAM_B1 * m + (1 - ADAM_B1) * g, st.mu, grads)
    nu = _tmap(lambda v, g: ADAM_B2 * v + (1 - ADAM_B2) * g * g, st.nu, grads)
    bc1, bc2 = 1 - ADAM_B1**count, 1 - ADAM_B2**count
    upd = _tmap(lambda m, v: -lr * (m / bc1) / (torch.sqrt(v / bc2) + ADAM_EPS), mu, nu)
    return upd, AdamState(count, mu, nu)


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


class SACTrainer:
    """SAC over one EnvEngine, on the engine's device: the card unless the
    engine was made with `device="cpu"`.

    >>> tr = SACTrainer(EnvEngine(get_config("GoalContinuous2P-v0")))
    >>> st = tr.init(0)
    >>> st, metrics = tr.train_iter(st, tr.generator(1))
    """

    def __init__(self, engine: EnvEngine, config: SACConfig = SACConfig(), device=None):
        if not engine.config.continuous:
            raise ValueError("SAC requires a continuous-action env config")
        if device is not None and torch.device(device).type != engine.device.type:
            raise ValueError(f"the trainer runs on its engine's device {engine.device}, "
                             f"got device={device!r}")
        self.engine = engine
        self.device = engine.device
        self.cfg = config
        self.obs_dim = engine.obs_dim
        self.action_dim = engine.config.action_dim
        if config.fused_updates and self.action_dim != 2:
            # the packed replay layout and the kernels' head hard-code two actions
            raise ValueError(
                f"fused_updates requires action_dim == 2 (got {self.action_dim}); "
                "use the unfused path for other action dims")
        # Width-parameterized layout namespace, bound whenever the net shape
        # fits the packed layout: the format bridges (migrate/rehydrate) need
        # it on unfused trainers too.
        h = config.hidden
        self._fs = None
        if self.action_dim == 2 and len(h) == 2 and h[0] == h[1] and h[0] % 128 == 0:
            self._fs = fused_sac.build(h[0])
        if config.fused_updates and self._fs is None:
            raise ValueError(
                f"fused_updates requires hidden=(h, h) with h a multiple of 128, got {h}")
        self.actor = networks.TanhGaussianActor(self.obs_dim, self.action_dim, config.hidden)
        self.critic = networks.DoubleCritic(self.obs_dim, self.action_dim, config.hidden)
        self.target_entropy = (-float(self.action_dim) if config.target_entropy is None
                               else float(config.target_entropy))

    def generator(self, seed: int) -> torch.Generator:
        """A seeded generator on the trainer's device."""
        return torch.Generator(device=self.device).manual_seed(seed)

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
        return self._refresh_from_fused(state) if c.fused_updates else state

    # -------------------------------------------------------------- acting --
    def act(self, actor_params, obs, generator=None, eps=None):
        """A sampled action for every row of obs."""
        with torch.no_grad():
            mean, log_std = functional_call(self.actor, actor_params, (obs,))
            return networks.sample_tanh_gaussian(mean, log_std, eps, generator)[0]

    def eval_act(self, actor_params, obs):
        """The deterministic action tanh(mean)."""
        with torch.no_grad():
            return torch.tanh(functional_call(self.actor, actor_params, (obs,))[0])

    # ------------------------------------------------------------- training --
    def _rollout(self, state: SACState, generator):
        """Collect cfg.rollout_len steps with the stochastic policy; returns
        (env_state, obs, slab with (T, lanes, ...) leaves, rewards, dones)."""
        env_state, obs = state.env_state, state.obs
        trs, rewards, dones = [], [], []
        for _ in range(self.cfg.rollout_len):
            action = self.act(state.actor_params, obs, generator)
            env_state, ts = self.engine.step(env_state, action, generator)
            trs.append(Transition(
                obs=obs,
                action=action,
                reward=self.cfg.reward_scale * ts.reward,
                next_obs=ts.final_obs,
                discount=1.0 - ts.terminated.to(ts.reward.dtype),
            ))
            rewards.append(ts.reward)
            dones.append(ts.done)
            obs = ts.obs
        slab = Transition(*[torch.stack(leaf) for leaf in zip(*trs)])
        return env_state, obs, slab, torch.stack(rewards), torch.stack(dones)

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
        """One unfused update: torch.autograd and `adam_update`.  `batch`
        (Transition with (B, ...) leaves) and `noise` ((B, 2, A) normals, [:, 0]
        for the critic's next action, [:, 1] for the actor's) may be injected."""
        c = self.cfg
        if batch is None:
            batch = replay_sample(state.replay, generator, c.batch_size)
        if noise is None:
            noise = torch.randn((batch.reward.shape[0], 2, self.action_dim), generator=generator,
                                device=self.device)

        def with_grad(params):
            return {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}

        cp = with_grad(state.critic_params)
        critic_loss = self._critic_loss(cp, state, batch, noise[:, 0])
        grads = dict(zip(cp, torch.autograd.grad(critic_loss, list(cp.values()))))
        upd, critic_opt = adam_update(grads, state.critic_opt, c.lr)
        critic_params = _tmap(lambda p, u: p.detach() + u, state.critic_params, upd)

        ap = with_grad(state.actor_params)
        actor_loss, logp = self._actor_loss(ap, state, critic_params, batch, noise[:, 1])
        grads = dict(zip(ap, torch.autograd.grad(actor_loss, list(ap.values()))))
        upd, actor_opt = adam_update(grads, state.actor_opt, c.lr)
        actor_params = _tmap(lambda p, u: p.detach() + u, state.actor_params, upd)

        # temperature toward the target entropy: d/d log_alpha of
        # mean(-log_alpha * (logp + target_entropy))
        alpha_grad = -(logp.detach() + self.target_entropy).mean()
        upd, alpha_opt = adam_update(alpha_grad, state.alpha_opt, c.lr)
        log_alpha = state.log_alpha + upd
        if c.alpha_floor > 0:
            log_alpha = torch.clamp(log_alpha, min=math.log(c.alpha_floor))

        target = _tmap(lambda t, p: t * (1 - c.tau) + p * c.tau,
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
        K = c.updates_per_iter
        lanes_r = state.replay.data.shape[2]
        if noises is None:
            noises = torch.randn((K, c.batch_size, 2, self.action_dim), generator=generator,
                                 device=self.device)
        args = dict(obs_dim=self.obs_dim, gamma=c.gamma, tau=c.tau, lr=c.lr,
                    target_entropy=self.target_entropy, alpha_floor=c.alpha_floor,
                    block=c.fused_block, fold=c.fused_fold,
                    # bfloat16-rounded products on the card, as the JAX trainer
                    # on a TPU; float32 on the CPU, as the JAX trainer off it
                    mm_bf16=self.device.type == "cuda")
        bt = min(c.fused_block, lanes_r)
        tile = fused_sac.KERNEL_TILE.get(c.hidden[0], 1) if self.device.type == "cuda" else 1
        from_ring = batches is None and (row_idx is not None or (
            c.batch_size % lanes_r == 0 and lanes_r % bt == 0 and lanes_r % tile == 0))
        if from_ring:
            if row_idx is None:
                row_idx = torch.randint(0, max(state.replay.filled, 1),
                                        (K * (c.batch_size // lanes_r),), generator=generator,
                                        device=self.device)
            fstate, closs, aloss = fs.fused_update_k_wmat(
                state.fused, state.replay.data, row_idx, noises, **args)
        else:
            if batches is None:
                total = K * c.batch_size
                if total % c.lanes == 0 and c.batch_size >= c.lanes:
                    big = replay_sample_rows(state.replay, generator, total)
                else:
                    big = replay_sample(state.replay, generator, total)
                batches = Transition(*[x.reshape(K, c.batch_size, *x.shape[1:]) for x in big])
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

    def train_iter(self, state: SACState, generator):
        """One rollout, one replay insert, `updates_per_iter` updates."""
        c = self.cfg
        with torch.no_grad():
            env_state, obs, slab, rewards, dones = self._rollout(state, generator)
            slab = nstep_slab(slab, dones, c.gamma, c.n_step)
            replay = replay_add_slab(state.replay, slab)
        state = state._replace(env_state=env_state, obs=obs, replay=replay)

        # The warm-up gate: before the ring holds min(warmup_rows, replay_rows)
        # rows the learner state does not change.  The JAX trainer computes the
        # update and discards it to keep one compiled program; here the update
        # is skipped, since the kernels update the state in place and nothing
        # is compiled.
        nan = torch.full((), float("nan"), device=self.device)
        metrics = {"critic_loss": nan, "actor_loss": nan}
        if replay.filled >= min(c.warmup_rows, c.replay_rows):
            if c.fused_updates:
                state, metrics = self._update_fused(state, generator)
            else:
                for _ in range(c.updates_per_iter):
                    state, metrics = self._update_once(state, generator)
        metrics = dict(
            metrics,
            mean_reward=rewards.mean(),
            episodes_done=dones.sum(),
            alpha=torch.exp(state.log_alpha.detach()),
        )
        return state._replace(step=state.step + 1), metrics

    def train_iters(self, state: SACState, generator, n: int):
        """n train_iters; returns the last iteration's metrics."""
        metrics = {}
        for _ in range(n):
            state, metrics = self.train_iter(state, generator)
        return state, metrics

    # ------------------------------------------------------ format bridges --
    def _need_layout(self):
        if self._fs is None:
            raise ValueError("fused-format bridge requires hidden=(h, h), h % 128 == 0")
        return self._fs

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
