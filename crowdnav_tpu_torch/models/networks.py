"""The learners' networks (port of ``crowdnav_tpu/models/networks.py``),
float32: TD3's and DDPG's ``DeterministicActor``, ``QCritic`` and
``DoubleCritic``; SAC's ``GaussianActor`` and ``ValueNetwork``; DQN's
``QNetwork``.

The actor is a 2-hidden-layer ReLU MLP whose two outputs are squashed to
the action box: sigmoid -> [0, v_max] linear velocity and tanh ->
[-w_max, w_max] angular velocity. A critic maps concat(obs, action) through
256 -> 256 -> 1; the twin critics ``q1`` and ``q2`` share the input. An
observation stored in bfloat16 is promoted to float32 before the first
product, as flax's ``Dense(dtype=float32)`` does.

TD3's ``compute_dtype="bfloat16"`` (flax's ``Dense(dtype=bfloat16)``):
every dense layer casts its input, kernel and bias to bfloat16 and puts
out bfloat16 (the products summed in float32 on both frameworks' CPU and
on the card), and the network's output is cast back to float32; the
parameters stay float32.

The learner keeps each network's parameters in one flat float32 vector
(:func:`flatten`, :func:`unflatten`), so that its optimizer and its soft
target updates are a few whole-vector operations; the modules and the
functional forms (:func:`actor_apply`, :func:`critic_apply`,
:func:`gaussian_apply`, :func:`mlp_apply`) compute the same thing from the
same parameters. Every layer is ``dense{i}``, flax's ``Dense_{i}`` (the
Gaussian actor's mean head is ``dense2``, its log-std head ``dense3``).
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


def lecun_uniform_(weight: torch.Tensor,
                   gen: torch.Generator | None = None):
    """flax's ``lecun_uniform``: U(-sqrt(3 / fan_in), sqrt(3 / fan_in))."""
    bound = math.sqrt(3.0 / weight.shape[1])
    with torch.no_grad():
        weight.uniform_(-bound, bound, generator=gen)
    return weight


def scaled_uniform_(t: torch.Tensor, scale: float,
                    gen: torch.Generator | None = None):
    """flax's ``uniform(scale)``: U[0, scale)."""
    with torch.no_grad():
        t.uniform_(0.0, scale, generator=gen)
    return t


def mlp_apply(p: dict, x: torch.Tensor, n_layers: int = 3,
              prefix: str = "", dtype: torch.dtype = torch.float32
              ) -> torch.Tensor:
    """A ReLU MLP of ``n_layers`` dense layers, linear output, computed in
    ``dtype`` (input, kernels and biases cast to it); the output is
    float32."""
    x = x.to(dtype)
    for i in range(n_layers):
        x = F.linear(x, p[f"{prefix}dense{i}.weight"].to(dtype),
                     p[f"{prefix}dense{i}.bias"].to(dtype))
        if i < n_layers - 1:
            x = torch.relu(x)
    return x.float()


def _mlp(p: dict, prefix: str, x: torch.Tensor,
         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return mlp_apply(p, x, 3, prefix, dtype)


def actor_heads(p: dict, obs: torch.Tensor,
                dtype: torch.dtype = torch.float32):
    """The actor's squashed outputs before their scales: ``(sigmoid(raw0),
    tanh(raw1))``, each (B, 1), from a ``{name: tensor}`` of its
    parameters, the MLP computed in ``dtype``."""
    raw = _mlp(p, "", obs.float(), dtype)
    return torch.sigmoid(raw[..., :1]), torch.tanh(raw[..., 1:2])


def actor_apply(p: dict, obs: torch.Tensor, max_lin_vel: float,
                max_ang_vel: float, dtype: torch.dtype = torch.float32
                ) -> torch.Tensor:
    """The actor from a ``{name: tensor}`` of its parameters."""
    sig, th = actor_heads(p, obs, dtype)
    return torch.cat([sig * max_lin_vel, th * max_ang_vel], dim=-1)


def critic_apply(p: dict, obs: torch.Tensor, action: torch.Tensor,
                 heads=("q1", "q2"), dtype: torch.dtype = torch.float32):
    """The critics named in ``heads`` from a ``{name: tensor}`` of the twin
    critic's parameters: a tuple of (B, 1) float32 values, the MLPs
    computed in ``dtype``."""
    x = torch.cat([obs.float(), action.float()], dim=-1)
    return tuple(_mlp(p, f"{h}.", x, dtype) for h in heads)


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
                 max_lin_vel: float = 0.22, max_ang_vel: float = 2.0,
                 dtype: torch.dtype = torch.float32):
        if action_dim != 2:
            raise ValueError("the actor's heads are (linear, angular)")
        super().__init__(obs_dim, hidden, action_dim)
        self.max_lin_vel = max_lin_vel
        self.max_ang_vel = max_ang_vel
        self.compute_dtype = dtype

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        return actor_apply(dict(self.named_parameters()), obs,
                           self.max_lin_vel, self.max_ang_vel,
                           self.compute_dtype)


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


def gaussian_apply(p: dict, obs: torch.Tensor, log_std_min: float = -20.0,
                   log_std_max: float = 2.0):
    """SAC's Gaussian actor: ``(mean, log_std)``, each (B, A), the log-std
    clipped to [``log_std_min``, ``log_std_max``]."""
    x = torch.relu(F.linear(obs.float(), p["dense0.weight"],
                            p["dense0.bias"]))
    x = torch.relu(F.linear(x, p["dense1.weight"], p["dense1.bias"]))
    mean = F.linear(x, p["dense2.weight"], p["dense2.bias"])
    log_std = F.linear(x, p["dense3.weight"], p["dense3.bias"])
    return mean, torch.clamp(log_std, log_std_min, log_std_max)


def squash(z: torch.Tensor, max_lin_vel: float,
           max_ang_vel: float) -> torch.Tensor:
    """SAC's action heads on ``tanh(z)``: sigmoid -> [0, v_max], tanh ->
    [-w_max, w_max]."""
    a = torch.tanh(z)
    return torch.cat([torch.sigmoid(a[..., :1]) * max_lin_vel,
                      torch.tanh(a[..., 1:2]) * max_ang_vel], dim=-1)


class GaussianActor(nn.Module):
    """SAC's actor: two ReLU layers, then the mean head ``dense2`` and the
    log-std head ``dense3``, both initialised U[0, 3e-3) as flax's
    ``uniform(3e-3)``."""

    def __init__(self, obs_dim: int, action_dim: int = 2, hidden: int = 256,
                 log_std_min: float = -20.0, log_std_max: float = 2.0,
                 max_lin_vel: float = 0.22, max_ang_vel: float = 2.0):
        super().__init__()
        self.dense0 = nn.Linear(obs_dim, hidden)
        self.dense1 = nn.Linear(hidden, hidden)
        self.dense2 = nn.Linear(hidden, action_dim)
        self.dense3 = nn.Linear(hidden, action_dim)
        self.log_std_min, self.log_std_max = log_std_min, log_std_max
        self.max_lin_vel, self.max_ang_vel = max_lin_vel, max_ang_vel

    def reset_parameters(self, gen: torch.Generator | None = None):
        for layer in (self.dense0, self.dense1):
            lecun_normal_(layer.weight, gen)
            nn.init.zeros_(layer.bias)
        for layer in (self.dense2, self.dense3):
            scaled_uniform_(layer.weight, 3e-3, gen)
            scaled_uniform_(layer.bias, 3e-3, gen)

    def forward(self, obs: torch.Tensor):
        return gaussian_apply(dict(self.named_parameters()), obs,
                              self.log_std_min, self.log_std_max)

    def greedy(self, obs: torch.Tensor) -> torch.Tensor:
        """``squash(mean)``, unclipped."""
        return squash(self(obs)[0], self.max_lin_vel, self.max_ang_vel)


class ValueNetwork(_MLP):
    """SAC's state-value net: obs -> hidden -> hidden -> 1, the last layer
    U[0, 3e-3) (``hidden=2`` is the reference's quirk, see the JAX
    package's docstring)."""

    def __init__(self, obs_dim: int, hidden: int = 256):
        super().__init__(obs_dim, hidden, 1)

    def reset_parameters(self, gen: torch.Generator | None = None):
        for layer in (self.dense0, self.dense1):
            lecun_normal_(layer.weight, gen)
            nn.init.zeros_(layer.bias)
        scaled_uniform_(self.dense2.weight, 3e-3, gen)
        scaled_uniform_(self.dense2.bias, 3e-3, gen)

    def forward(self, obs):
        return mlp_apply(dict(self.named_parameters()), obs.float())


class QNetwork(nn.Module):
    """DQN's value head: ReLU layers of the widths ``hidden``, then
    ``n_actions`` linear outputs; lecun-uniform kernels, zero biases."""

    def __init__(self, obs_dim: int, n_actions: int = 3,
                 hidden=(300, 300)):
        super().__init__()
        widths = [obs_dim, *hidden, n_actions]
        self.n_layers = len(widths) - 1
        for i in range(self.n_layers):
            setattr(self, f"dense{i}", nn.Linear(widths[i], widths[i + 1]))

    def reset_parameters(self, gen: torch.Generator | None = None):
        for i in range(self.n_layers):
            layer = getattr(self, f"dense{i}")
            lecun_uniform_(layer.weight, gen)
            nn.init.zeros_(layer.bias)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        return mlp_apply(dict(self.named_parameters()), obs.float(),
                         self.n_layers)


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
