"""On-device learners and their building blocks: SAC and TD3, unfused and
fused; PPO and DQN."""
from .dqn import DQNConfig, DQNState, DQNTrainer  # noqa: F401
from .networks import (MLP, DeterministicActor, DoubleCritic, GaussianActorValue,  # noqa: F401
                       TanhGaussianActor)
from .ppo import PPOConfig, PPOState, PPOTrainer  # noqa: F401
from .replay import (ReplayState, Transition, replay_add, replay_add_slab,  # noqa: F401
                     replay_init, replay_sample)
from .sac import SACConfig, SACState, SACTrainer  # noqa: F401
from .td3 import TD3Config, TD3State, TD3Trainer  # noqa: F401
