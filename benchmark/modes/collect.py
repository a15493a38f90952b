"""Collection: a captured rollout of `EnvEngine` replayed back to back.

The engine is built as the configuration states, its lanes are reset from
uniforms the benchmark draws, and `EnvEngine.capture_rollout` of a uniform
random policy over `steps_per_call` steps, with no trajectory, is one call of
the window: the state and the observation carry from call to call.  The
policy is the benchmark's own: one `(lanes, 2)` draw from the run's generator
a step, mapped to [-1, 1].

The check follows the window's last call on every lane: the reference
(benchmark/reference/goal_env.py, float64, one CUDA graph a step) steps each
lane from the program's state at the call's start through the same actions
and uniforms, which it draws again from the generator's state at the call's
start; the program's state and observation at the call's end are compared
lane by lane, and its reward sum over the call with the reference's.
"""
from __future__ import annotations

import torch

from ..envcheck import GraphStep, lanes_of, lanes_off, program_config
from ..reference.goal_env import GoalEnv

def uniform_policy(generator, obs):
    """Raw actions uniform in [-1, 1]: the traffic's policy."""
    return torch.rand((obs.shape[0], 2), generator=generator, device=obs.device) * 2.0 - 1.0


class Mode:
    """One collection cell: `setup`, then `call` in the window, then `check`."""

    KERNEL = "full_step_kernel"  # K3, the full-step kernel
    CALL_RANGE = "bench.replay"

    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device):
        self.config = config
        self.traffic = traffic
        self.seed = seed
        self.device = device
        self.lanes = traffic["lanes"]
        self.steps = traffic["steps_per_call"]
        self.KERNEL_PER_CALL = self.steps
        self.done_sums = []
        self.last = None

    # ------------------------------------------------------------- program --
    def setup(self):
        from space_gym_torch.engine import EnvEngine

        env, eng = self.config["env"], self.config["engine"]
        if eng["dtype"] != "float32" or eng["uniforms"] != "bulk":
            raise ValueError("the collect mode runs float32 with bulk uniforms")
        self.engine = EnvEngine(program_config(env), dtype=torch.float32,
                                substeps=eng["substeps"], refine_iters=eng["refine_iters"],
                                tableau=eng["tableau"], in_kernel_rng=False, device=self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(self.seed)
        u = torch.rand((self.lanes, self.engine.n_reset_rand), generator=self.generator,
                       device=self.device)
        self.state, self.obs = self.engine.reset(self.lanes, u=u)
        if self.device.type == "cuda":
            self.run = self.engine.capture_rollout(uniform_policy, self.steps, self.generator,
                                                   trajectory=False)
        else:  # the CPU tests: the same steps as a loop
            def run(state, obs):
                return self.engine.rollout(state, obs, uniform_policy, self.steps,
                                           self.generator, trajectory=False)
            self.run = run
        for _ in range(self.traffic["warmup_calls"]):
            self.call()
        self.done_sums.clear()

    def call(self) -> int:
        """One rollout of every lane; returns its env-steps.  No host sync."""
        self.last = (self.state, self.obs, self.generator.get_state())
        self.state, self.obs, traj = self.run(self.state, self.obs)
        self.reward_sum = traj.reward_sum
        self.done_sums.append(traj.done_sum)
        return self.lanes * self.steps

    # ---------------------------------------------------------- yardstick --
    def least_seconds(self, calls: int, ended: int) -> float:
        """The least time of `calls` calls in which `ended` episodes ended."""
        from ..roofline import env_steps_least_seconds

        return env_steps_least_seconds(self.config["env"], self.config["engine"], self.lanes,
                                       self.steps * calls, ended)

    def check(self, control: bool = False) -> dict:
        """{name: value} of the numbers compared, after the window (see the
        module docstring).  With `control`, {"program": those, "control":
        the same numbers for the reference computed in bfloat16 in the
        program's place}."""
        state0, _, gstate = self.last
        idx = torch.arange(self.lanes, device=self.device)
        start = lanes_of(state0, idx, torch.float64)
        got = lanes_of(self.state, idx, torch.float64)
        got_obs = [r.double() for r in self.obs.t()]
        reward_all = float(self.reward_sum)
        self.release()

        envs = [GoalEnv(self.config, torch.float64)]
        if control:
            envs.append(GoalEnv(self.config, torch.bfloat16))
        gen = torch.Generator(device=self.device)
        gen.set_state(gstate)
        lanes = [start] * len(envs)
        obs = [None] * len(envs)
        rewards = [torch.zeros(self.lanes, dtype=torch.float64, device=self.device)
                   for _ in envs]
        steppers = [env.step for env in envs]
        for t in range(self.steps):
            action = uniform_policy(gen, start.y[0])  # it reads the lanes' count and device
            u = torch.rand((envs[0].n_uniforms, self.lanes), generator=gen, device=self.device)
            if t == 0 and self.device.type == "cuda":
                steppers = [GraphStep(env, start, action, u) for env in envs]
            for i, step in enumerate(steppers):
                st = step(lanes[i], action, u)
                lanes[i], obs[i] = st.lanes, st.obs
                rewards[i] += st.reward.double()
        want = float(rewards[0].sum())

        def numbers(got, got_obs, reward):
            off = lanes_off(got, got_obs, lanes[0], obs[0])
            return {"lanes_off_pct": 100.0 * float(off.sum()) / self.lanes,
                    "reward_sum_gap_pct": 100.0 * abs(reward - want) / abs(want)}

        program = numbers(got, got_obs, reward_all)
        if not control:
            return program
        low = numbers(lanes[1], obs[1], float(rewards[1].sum()))
        finite = torch.isfinite(rewards[1])
        # the control's reward sum over its lanes whose rewards stayed finite:
        # a reading of the gap where the whole sum is not a number
        low["reward_sum_gap_pct_finite"] = 100.0 * abs(float(rewards[1][finite].sum()) - want) \
            / abs(want)
        low["nonfinite_lanes"] = int((~finite).sum())
        return {"program": program, "control": low}

    def release(self):
        """Drop the program's state and its captured graph."""
        self.state = self.obs = self.last = self.run = self.engine = None
        self.done_sums = []
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
