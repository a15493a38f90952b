"""space_gym_torch — PyTorch/CUDA port of space_gym_tpu for NVIDIA Hopper.

The JAX package `space_gym_tpu` stays the reference; this package imports
nothing of it (nor of jax).  Public surface of this slice:

  * env_ids() / get_config      — the same typed-config registry
  * space_gym_torch.engine      — batched env engine whose step is one
                                  hand-written CUDA kernel (csrc/full_step.cu)
  * space_gym_torch.ops         — the kernel wrappers and their plain twins

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
