"""The TD3 networks (port of ``DeterministicActor``, ``QCritic`` and
``DoubleCritic`` in ``crowdnav_tpu/models/networks.py``), float32.

The actor is a 2-hidden-layer ReLU MLP whose two outputs are squashed to
the action box: sigmoid -> [0, v_max] linear velocity and tanh ->
[-w_max, w_max] angular velocity. A critic maps concat(obs, action) through
256 -> 256 -> 1; the twin critics ``q1`` and ``q2`` share the input. An
observation stored in bfloat16 is promoted to float32 before the first
product, as flax's ``Dense(dtype=float32)`` does.

The learner keeps each network's parameters in one flat float32 vector
(:func:`flatten`, :func:`unflatten`), so that its optimizer and its soft
target updates are a few whole-vector operations; the modules and the
functional forms (:func:`actor_apply`, :func:`critic_apply`) compute the
same thing from the same parameters.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
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


def _mlp(p: dict, prefix: str, x: torch.Tensor) -> torch.Tensor:
    x = torch.relu(F.linear(x, p[f"{prefix}dense0.weight"],
                            p[f"{prefix}dense0.bias"]))
    x = torch.relu(F.linear(x, p[f"{prefix}dense1.weight"],
                            p[f"{prefix}dense1.bias"]))
    return F.linear(x, p[f"{prefix}dense2.weight"], p[f"{prefix}dense2.bias"])


def actor_heads(p: dict, obs: torch.Tensor):
    """The actor's squashed outputs before their scales: ``(sigmoid(raw0),
    tanh(raw1))``, each (B, 1), from a ``{name: tensor}`` of its
    parameters."""
    raw = _mlp(p, "", obs.float())
    return torch.sigmoid(raw[..., :1]), torch.tanh(raw[..., 1:2])


def actor_apply(p: dict, obs: torch.Tensor, max_lin_vel: float,
                max_ang_vel: float) -> torch.Tensor:
    """The actor from a ``{name: tensor}`` of its parameters."""
    sig, th = actor_heads(p, obs)
    return torch.cat([sig * max_lin_vel, th * max_ang_vel], dim=-1)


def critic_apply(p: dict, obs: torch.Tensor, action: torch.Tensor,
                 heads=("q1", "q2")):
    """The critics named in ``heads`` from a ``{name: tensor}`` of the twin
    critic's parameters: a tuple of (B, 1) values."""
    x = torch.cat([obs.float(), action.float()], dim=-1)
    return tuple(_mlp(p, f"{h}.", x) for h in heads)


class _MLP(nn.Module):
    def __init__(self, d_in: int, hidden: int, d_out: int):
        super().__init__()
        self.dense0 = nn.Linear(d_in, hidden)
        self.dense1 = nn.Linear(hidden, hidden)
        self.dense2 = nn.Linear(hidden, d_out)

    def reset_parameters(self, gen: torch.Generator | None = None):
        """flax's init: lecun-normal kernels, zero biases."""
        for layer in (self.dense0, self.dense1, self.dense2):
            lecun_normal_(layer.weight, gen)
            nn.init.zeros_(layer.bias)


class DeterministicActor(_MLP):
    def __init__(self, obs_dim: int, action_dim: int = 2, hidden: int = 256,
                 max_lin_vel: float = 0.22, max_ang_vel: float = 2.0):
        if action_dim != 2:
            raise ValueError("the actor's heads are (linear, angular)")
        super().__init__(obs_dim, hidden, action_dim)
        self.max_lin_vel = max_lin_vel
        self.max_ang_vel = max_ang_vel

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        return actor_apply(dict(self.named_parameters()), obs,
                           self.max_lin_vel, self.max_ang_vel)


class QCritic(_MLP):
    """State-action critic: concat(obs, action) -> 256 -> 256 -> 1 (the
    parameters of one head of :class:`DoubleCritic`)."""

    def __init__(self, obs_dim: int, action_dim: int = 2, hidden: int = 256):
        super().__init__(obs_dim + action_dim, hidden, 1)


class DoubleCritic(nn.Module):
    """TD3's twin critics ``q1`` and ``q2`` on one input."""

    def __init__(self, obs_dim: int, action_dim: int = 2, hidden: int = 256):
        super().__init__()
        self.q1 = QCritic(obs_dim, action_dim, hidden)
        self.q2 = QCritic(obs_dim, action_dim, hidden)

    def reset_parameters(self, gen: torch.Generator | None = None):
        """flax's init of ``q1`` then ``q2``."""
        self.q1.reset_parameters(gen)
        self.q2.reset_parameters(gen)

    def forward(self, obs, action):
        return critic_apply(dict(self.named_parameters()), obs, action)


def layout(module: nn.Module):
    """``[(name, shape)]`` of the module's parameters, in its order."""
    return [(name, tuple(p.shape)) for name, p in module.named_parameters()]


def flatten(module: nn.Module) -> torch.Tensor:
    """The module's parameters concatenated into one float32 vector."""
    return torch.cat([p.detach().reshape(-1).float()
                      for p in module.parameters()])


def unflatten(flat: torch.Tensor, lay) -> dict:
    """``{name: view of flat}`` for a layout from :func:`layout`."""
    out, off = {}, 0
    for name, shape in lay:
        n = math.prod(shape)
        out[name] = flat[off:off + n].view(shape)
        off += n
    if off != flat.numel():
        raise ValueError(f"flat vector of {flat.numel()} for a layout of "
                         f"{off} parameters")
    return out


def load_flat(module: nn.Module, flat: torch.Tensor):
    """Copy a flat vector into the module's parameters."""
    with torch.no_grad():
        for (_, p), v in zip(module.named_parameters(),
                             unflatten(flat, layout(module)).values()):
            p.copy_(v)
    return module
