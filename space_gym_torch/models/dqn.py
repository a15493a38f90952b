"""Double DQN for the discrete-action envs on the batched env engine.

Port of space_gym_tpu/models/dqn.py: epsilon-greedy acting with a linear
schedule, a ring replay (models/replay.py), double-DQN targets (the online
network picks the next action, the target network evaluates it), a hard
target sync every `target_sync_every` updates, and the warm-up gate.

The rollout is the trainer's `PolicyRollout`, with the discrete actions
going through the engine's action table into K3: one captured CUDA graph on
the card, a loop on the CPU.  Its policy reads the Q network's parameters
where they live, and epsilon from a device scalar set before each rollout
(a graph replays what it captured, a Python number included), so the
parameters are updated IN PLACE.  Before the ring holds min(warmup_rows,
replay_rows) rows the updates are skipped (the JAX trainer computes and
discards them to keep one compiled program) and the loss reads NaN.

Randomness comes from an explicit `torch.Generator` on the trainer's device;
`_update_once` also takes an injected batch, so that a test can feed this
package and the JAX package the same draws.

Under a mesh (the engine's, parallel/mesh.py) it works as the unfused SAC
does (models/offpolicy.py): a rank rolls out its lanes, every rank samples
the same global minibatch and runs the same update.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import functional_call

from ..engine.core import EnvEngine, PolicyRollout
from . import networks
from .offpolicy import (AdamState, adam_init, adam_update, lane_mean, lane_sum, note_layout,
                        with_whole_params)
from .replay import ReplayState, Transition, replay_add_slab, replay_init, replay_sample


class DQNConfig(NamedTuple):
    lanes: int = 4096
    rollout_len: int = 32
    replay_rows: int = 2048
    batch_size: int = 4096
    updates_per_iter: int = 8
    gamma: float = 0.99
    lr: float = 3e-4
    eps_start: float = 1.0
    eps_end: float = 0.05
    eps_decay_iters: int = 200
    target_sync_every: int = 32  # updates between hard target syncs
    hidden: tuple = (256, 256)
    warmup_rows: int = 32


class DQNState(NamedTuple):
    params: dict                 # the Q network's, updated in place
    target_params: dict
    opt: AdamState
    env_state: object
    obs: torch.Tensor
    replay: ReplayState
    n_updates: int
    step: int


class DQNTrainer:
    """Double DQN over one discrete EnvEngine, on the engine's device: the
    card unless the engine was made with `device="cpu"`.

    >>> tr = DQNTrainer(EnvEngine(get_config("GoalDiscrete3-v0")))
    >>> st = tr.init(0)
    >>> st, metrics = tr.train_iter(st, tr.generator(1))
    """

    def __init__(self, engine: EnvEngine, config: DQNConfig = DQNConfig()):
        if engine.config.continuous:
            raise ValueError("DQN requires a discrete-action env config")
        self.engine = engine
        self.device = engine.device
        self.cfg = config
        self.mesh = engine.mesh
        self.shardings = None
        self.obs_dim = engine.obs_dim
        self.n_actions = engine.config.n_actions
        self.qnet = networks.MLP(self.obs_dim, (*config.hidden, self.n_actions))
        self.collect = PolicyRollout(engine, self._explore, config.rollout_len)
        self._eps = torch.zeros((), dtype=torch.float32, device=self.device)

    def generator(self, seed: int) -> torch.Generator:
        """A seeded generator on the trainer's device."""
        return torch.Generator(device=self.device).manual_seed(seed)

    def init(self, seed: int = 0) -> DQNState:
        """Fresh Q network (drawn on the CPU from `seed`, then moved), its
        target copy, env lanes and an empty replay ring."""
        c = self.cfg
        g = torch.Generator().manual_seed(seed)
        net = networks.MLP(self.obs_dim, (*c.hidden, self.n_actions), generator=g)
        params = {k: v.detach().to(self.device) for k, v in net.state_dict().items()}
        env_state, obs = self.engine.reset(c.lanes, self.engine.generator(seed))
        return note_layout(self, DQNState(
            params=params, target_params={k: v.clone() for k, v in params.items()},
            opt=adam_init(params), env_state=env_state, obs=obs,
            replay=replay_init(c.replay_rows, c.lanes, self.obs_dim, 1, self.engine.dtype,
                               self.device),
            n_updates=0, step=0))

    # -------------------------------------------------------------- acting --
    def _epsilon(self, step: int) -> torch.Tensor:
        """The exploration rate of train_iter `step`, linear from eps_start
        to eps_end over eps_decay_iters, in float32 as JAX computes it."""
        c = self.cfg
        frac = torch.clamp(torch.tensor(step, dtype=torch.float32) / c.eps_decay_iters, 0.0, 1.0)
        return c.eps_start + frac * (c.eps_end - c.eps_start)

    def eval_act(self, params, obs):
        """The greedy action, int32."""
        with torch.no_grad():
            return functional_call(self.qnet, params, (obs,)).argmax(-1).to(torch.int32)

    def _explore(self, params, generator, obs):
        """Epsilon-greedy: a uniform action where a uniform draw is below
        epsilon, the greedy one elsewhere."""
        greedy = functional_call(self.qnet, params, (obs,)).argmax(-1).to(torch.int32)
        draw = self.engine.draw_lanes
        u = draw(lambda s: torch.rand(s, generator=generator, device=greedy.device),
                 greedy.shape)
        rand = draw(lambda s: torch.randint(0, self.n_actions, s, generator=generator,
                                            device=greedy.device, dtype=torch.int32),
                    greedy.shape)
        return torch.where(u < self._eps, rand, greedy)

    # ------------------------------------------------------------- training --
    def _td_target(self, params, target_params, batch: Transition):
        """Double DQN: the online network picks the next action, the target
        network evaluates it; no gradient."""
        with torch.no_grad():
            next_a = functional_call(self.qnet, params, (batch.next_obs,)).argmax(-1)
            next_q = functional_call(self.qnet, target_params, (batch.next_obs,)).gather(
                -1, next_a[:, None])[:, 0]
            return batch.reward + self.cfg.gamma * batch.discount * next_q

    def _loss(self, params, target_params, batch: Transition):
        a = batch.action[:, 0].to(torch.int64)
        q_sa = functional_call(self.qnet, params, (batch.obs,)).gather(-1, a[:, None])[:, 0]
        return ((q_sa - self._td_target(params, target_params, batch)) ** 2).mean()

    def _update_once(self, state: DQNState, generator=None, batch=None):
        """One update from a replay sample (or the injected `batch`), written
        into the parameters in place; the target takes a copy of them every
        target_sync_every updates."""
        c = self.cfg
        if batch is None:
            batch = replay_sample(state.replay, generator, c.batch_size, mesh=self.mesh)
        p = {k: v.detach().requires_grad_(True) for k, v in state.params.items()}
        loss = self._loss(p, state.target_params, batch)
        grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
        upd, opt = adam_update(grads, state.opt, c.lr)
        n_updates = state.n_updates + 1
        with torch.no_grad():
            for k, v in state.params.items():
                v.add_(upd[k])
            if n_updates % c.target_sync_every == 0:
                for k, v in state.target_params.items():
                    v.copy_(state.params[k])
        return state._replace(opt=opt, n_updates=n_updates), {"loss": loss.detach()}

    def _rollout(self, state: DQNState, generator):
        """cfg.rollout_len epsilon-greedy steps at the exploration rate of
        `state.step`; returns (env_state, obs, Trajectory)."""
        self._eps.copy_(self._epsilon(state.step))
        return self.collect(state.params, state.env_state, state.obs, generator)

    def train_iter(self, state: DQNState, generator):
        """One rollout, one replay insert, `updates_per_iter` updates once the
        ring is past the warm-up."""
        return with_whole_params(self, state, lambda s: self._train_iter(s, generator))

    def _train_iter(self, state: DQNState, generator):
        c = self.cfg
        with torch.no_grad():
            env_state, obs, traj = self._rollout(state, generator)
            slab = Transition(
                obs=traj.obs, action=traj.kept["action"][..., None].to(self.engine.dtype),
                reward=traj.reward, next_obs=traj.final_obs,
                discount=1.0 - traj.terminated.to(traj.reward.dtype))
            replay = replay_add_slab(state.replay, slab)
        state = state._replace(env_state=env_state, obs=obs, replay=replay)
        metrics = {"loss": torch.full((), float("nan"), device=self.device)}
        if replay.filled >= min(c.warmup_rows, c.replay_rows):
            for _ in range(c.updates_per_iter):
                state, metrics = self._update_once(state, generator)
        metrics = dict(metrics, mean_reward=lane_mean(self.mesh, traj.reward),
                       episodes_done=lane_sum(self.mesh, traj.done),
                       epsilon=self._epsilon(state.step))
        return state._replace(step=state.step + 1), metrics

    def train_iters(self, state: DQNState, generator, n: int):
        """n train_iters; returns the last iteration's metrics."""
        metrics = {}
        for _ in range(n):
            state, metrics = self.train_iter(state, generator)
        return state, metrics
