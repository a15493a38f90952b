"""space_gym_torch — PyTorch/CUDA port of space_gym_tpu for NVIDIA Hopper.

The JAX package `space_gym_tpu` stays the reference; this package imports
nothing of it (nor of jax).  Public surface of this slice:

  * env_ids() / get_config      — the same typed-config registry
  * make(env_id)                — old-Gym-API single-env adapter (drop-in)
  * make_gymnasium(env_id)      — its new-API (Gymnasium-style) facade
  * VectorEnv(env_id, num_envs) — SB3-style VecEnv, NumPy at the boundary
  * space_gym_torch.engine      — batched env engine in five step tiers; the
                                  default steps through one hand-written CUDA
                                  kernel (csrc/full_step.cu), the others
                                  through csrc/env_step.cu, csrc/fused_step.cu
                                  or plain PyTorch (fixed-substep or the
                                  scipy-faithful adaptive RK45)
  * space_gym_torch.ops         — the env kernels' wrappers and plain twins
  * space_gym_torch.models      — the learners: replay ring, networks,
                                  SACTrainer and TD3Trainer with their fused
                                  K-updates (csrc/sac_update.cu,
                                  csrc/sac_update_fold.cu, csrc/td3_update.cu;
                                  plain versions `update_k_reference`),
                                  PPOTrainer and DQNTrainer, all collecting
                                  through the engine's captured rollout;
                                  models/convert.py carries parameters and
                                  learner state to and from the JAX package
  * space_gym_torch.parallel    — scale-out on torch.distributed:
                                  init_distributed, make_mesh, the split
                                  tables, place
  * space_gym_torch.utils       — the CUDA graph of a rollout (graphs),
                                  checkpoints, profiling, Gym seeding
  * space_gym_torch.compat      — the adapters, the scipy-exact numpy
                                  integrator (physics="host") and the JAX
                                  package's option names (compat/options.py)
  * space_gym_torch.parity      — the native C++ host runtime
                                  (physics="native", built with g++) and
                                  the device parity tier: the goldens
                                  replayed bit for bit through the engine
                                  (parity/device_replay.py, on ops/exact.py
                                  and tiling/device_exact.py)
  * space_gym_torch.render      — the adapter's renderer (PIL, lazily)
  * python -m space_gym_torch.train / .bench — the training CLI and the
                                  headline benchmark
  * python -m space_gym_torch.run_agent / .restore_learner — replaying a
                                  trained learner; a learner file as a
                                  resumable checkpoint

Entry points run on the card (`device="cuda"`) unless the caller asks for
`device="cpu"`, where every kernel wrapper takes its plain PyTorch twin.
"""
from .registry import env_ids, get_config, make, register  # noqa: F401

__version__ = "0.1.0"


def __getattr__(name):
    """Lazy exports: the engine and the adapters load on use."""
    if name == "EnvEngine":
        from .engine import EnvEngine

        return EnvEngine
    if name == "VectorEnv":
        from .compat.vector_env import VectorEnv

        return VectorEnv
    if name == "make_gymnasium":
        from .compat.gymnasium_api import make_gymnasium

        return make_gymnasium
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
