"""TD3 agent, evaluation half (port of ``crowdnav_tpu/agents/td3.py``):
the config and the greedy policy. The update, the critics and the
optimizers come with the training slice."""
from __future__ import annotations

import dataclasses

import torch

from crowdnav_tpu_torch.models.networks import DeterministicActor
from crowdnav_tpu_torch.utils.device import resolve


@dataclasses.dataclass(frozen=True)
class TD3Config:
    """The fields of the JAX ``TD3Config`` that the greedy policy and the
    greedy-cohort statistics read; the learner's fields come with the
    update."""

    hidden: int = 256
    max_lin_vel: float = 0.22
    max_ang_vel: float = 2.0
    explore_uniform_eps: float = 0.0
    explore_uniform_eps_min: float | None = None
    explore_eps_spectrum: bool = False
    compute_dtype: str = "float32"


class TD3:
    """The actor of a TD3 agent on ``device``."""

    def __init__(self, cfg: TD3Config, obs_dim: int, action_dim: int = 2,
                 device="cuda"):
        if cfg.compute_dtype != "float32":
            raise ValueError("the port's actor computes in float32")
        self.cfg = cfg
        self.obs_dim = obs_dim
        self.action_dim = action_dim
        self.device = resolve(device)
        self.actor = DeterministicActor(obs_dim, action_dim, cfg.hidden,
                                        cfg.max_lin_vel,
                                        cfg.max_ang_vel).to(self.device)
        self.actor.eval()

    def init(self, seed: int = 0):
        """Fresh actor parameters with flax's initializers."""
        gen = torch.Generator().manual_seed(seed)
        self.actor.cpu().reset_parameters(gen)
        self.actor.to(self.device)
        return self

    def load_actor(self, state_dict: dict):
        self.actor.load_state_dict(
            {k: torch.as_tensor(v) for k, v in state_dict.items()})
        return self

    @torch.no_grad()
    def act(self, obs: torch.Tensor, explore: bool = False) -> torch.Tensor:
        """The greedy policy, clipped to the action box."""
        if explore:
            raise NotImplementedError("exploration comes with training")
        action = self.actor(obs)
        lo = torch.tensor([0.0, -self.cfg.max_ang_vel], device=obs.device)
        hi = torch.tensor([self.cfg.max_lin_vel, self.cfg.max_ang_vel],
                          device=obs.device)
        return torch.clamp(action, lo, hi)
