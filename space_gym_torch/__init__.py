"""space_gym_torch — PyTorch/CUDA port of space_gym_tpu for NVIDIA Hopper.

The JAX package `space_gym_tpu` stays the reference; this package imports
nothing of it (nor of jax).  Public surface of this slice:

  * env_ids() / get_config      — the same typed-config registry
  * space_gym_torch.engine      — batched env engine in four step tiers; the
                                  default steps through one hand-written CUDA
                                  kernel (csrc/full_step.cu), the others
                                  through csrc/env_step.cu, csrc/fused_step.cu
                                  or plain PyTorch
  * space_gym_torch.ops         — the env kernels' wrappers and plain twins
  * space_gym_torch.models      — the SAC learner: replay ring, networks,
                                  SACTrainer, and the fused K-update whose
                                  kernels are csrc/sac_update.cu and
                                  csrc/sac_update_fold.cu (models/fused_sac.py,
                                  plain version `update_k_reference`);
                                  models/convert.py carries parameters and
                                  learner state to and from the JAX package

Entry points run on the card (`device="cuda"`) unless the caller asks for
`device="cpu"`, where every kernel wrapper takes its plain PyTorch twin.
"""
from .registry import env_ids, get_config  # noqa: F401

__version__ = "0.1.0"


def __getattr__(name):
    if name == "EnvEngine":
        from .engine import EnvEngine

        return EnvEngine
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
