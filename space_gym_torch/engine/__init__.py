"""Batched env engine on PyTorch (the CUDA main path)."""
from .core import EnvEngine, EnvState, PolicyRollout, TimeStep  # noqa: F401
from .convert import state_from_numpy, state_to_numpy  # noqa: F401
