"""The TD3 actor (port of ``DeterministicActor`` in
``crowdnav_tpu/models/networks.py``): a 2-hidden-layer ReLU MLP whose two
outputs are squashed to the action box, sigmoid -> [0, v_max] linear
velocity and tanh -> [-w_max, w_max] angular velocity. float32."""
from __future__ import annotations

import math

import torch
from torch import nn


def lecun_normal_(weight: torch.Tensor, gen: torch.Generator | None = None):
    """flax's default kernel init: truncated normal (+-2 std) with variance
    1 / fan_in. ``weight`` is torch's (out, in)."""
    fan_in = weight.shape[1]
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        t = torch.empty_like(weight)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
        weight.copy_(t * std)
    return weight


class DeterministicActor(nn.Module):
    def __init__(self, obs_dim: int, action_dim: int = 2, hidden: int = 256,
                 max_lin_vel: float = 0.22, max_ang_vel: float = 2.0):
        super().__init__()
        if action_dim != 2:
            raise ValueError("the actor's heads are (linear, angular)")
        self.dense0 = nn.Linear(obs_dim, hidden)
        self.dense1 = nn.Linear(hidden, hidden)
        self.dense2 = nn.Linear(hidden, action_dim)
        self.max_lin_vel = max_lin_vel
        self.max_ang_vel = max_ang_vel

    def reset_parameters(self, gen: torch.Generator | None = None):
        """flax's init: lecun-normal kernels, zero biases."""
        for layer in (self.dense0, self.dense1, self.dense2):
            lecun_normal_(layer.weight, gen)
            nn.init.zeros_(layer.bias)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.dense0(obs))
        x = torch.relu(self.dense1(x))
        raw = self.dense2(x)
        lin = torch.sigmoid(raw[..., :1]) * self.max_lin_vel
        ang = torch.tanh(raw[..., 1:2]) * self.max_ang_vel
        return torch.cat([lin, ang], dim=-1)
