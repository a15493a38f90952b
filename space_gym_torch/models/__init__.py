"""On-device learners and their building blocks: SAC, unfused and fused."""
from .networks import MLP, DoubleCritic, TanhGaussianActor  # noqa: F401
from .replay import (ReplayState, Transition, replay_add, replay_add_slab,  # noqa: F401
                     replay_init, replay_sample)
from .sac import SACConfig, SACState, SACTrainer  # noqa: F401
