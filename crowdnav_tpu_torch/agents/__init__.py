"""Agents: TD3 / DDPG / SAC / DQN / tabular Q-Learning & SARSA, and the
replay ring."""

from crowdnav_tpu_torch.agents.replay import (  # noqa: F401
    ReplayBuffer,
    ReplayState,
    Transition,
)
from crowdnav_tpu_torch.agents.td3 import TD3, TD3Config  # noqa: F401
from crowdnav_tpu_torch.agents.ddpg import DDPG, DDPGConfig  # noqa: F401
from crowdnav_tpu_torch.agents.sac import SAC, SACConfig  # noqa: F401
from crowdnav_tpu_torch.agents.dqn import DQN, DQNConfig  # noqa: F401
from crowdnav_tpu_torch.agents.tabular import (  # noqa: F401
    QLearning,
    Sarsa,
    TabularConfig,
    discretize_state,
)
