"""Batched environment engine: world model, crowd dynamics, MDP layers."""

from crowdnav_tpu_torch.envs.config import (  # noqa: F401
    CrowdBehavior,
    EnvConfig,
    ROBOT_PRESETS,
    WORLD_PRESETS,
    make_config,
)
from crowdnav_tpu_torch.envs.world import (  # noqa: F401
    EnvState,
    init_state,
    world_step,
)
from crowdnav_tpu_torch.envs.crowd_env import CrowdEnv  # noqa: F401
from crowdnav_tpu_torch.envs.simple_env import SimpleEnv  # noqa: F401
