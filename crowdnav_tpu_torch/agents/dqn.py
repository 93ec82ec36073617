"""DQN over the 3 discrete actions of ``SimpleEnv`` (port of
``crowdnav_tpu/agents/dqn.py``): a [300, 300] ReLU Q-network, RMSprop in
optax's order (``agents/optim.py``), the MSE of the taken action's Q to
``r + gamma * max Q_target(s')`` (terminal: ``r``), a hard copy of the
target network when the update count reaches a multiple of
``target_update_period``, and epsilon-greedy acting with a multiplicative
epsilon decay that the training driver applies once per chunk.

The greedy action is the first index of the largest Q (``torch.argmax``
and ``jnp.argmax`` agree on ties). The target copy is a select on the
device-side count, not a host branch.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from crowdnav_tpu_torch.agents.optim import RMSprop, RMSpropState
from crowdnav_tpu_torch.agents.replay import Transition
from crowdnav_tpu_torch.agents.td3 import reduce_metrics, value_and_grad
from crowdnav_tpu_torch.models.networks import (QNetwork, flatten, layout,
                                                load_flat, mlp_apply,
                                                unflatten)
from crowdnav_tpu_torch.utils import numerics as nm
from crowdnav_tpu_torch.utils.device import resolve


@dataclasses.dataclass(frozen=True)
class DQNConfig:
    """The JAX ``DQNConfig``, field for field (see its comments)."""

    hidden: tuple = (300, 300)
    lr: float = 0.00025
    gamma: float = 0.99
    batch_size: int = 64
    buffer_size: int = 1_000_000
    n_actions: int = 3
    target_update_period: int = 10_000
    epsilon_start: float = 1.0
    epsilon_min: float = 0.05
    epsilon_decay: float = 0.995
    learn_start: int = 64


@dataclasses.dataclass
class DQNState:
    params: torch.Tensor          # flat float32
    target_params: torch.Tensor
    opt: RMSpropState
    step: torch.Tensor            # () int32, updates taken
    epsilon: torch.Tensor         # () float32


class DQN:
    """A DQN agent on ``device``, with the greedy Q-network module
    ``self.net``."""

    METRICS = ("loss",)
    UPDATE_DRAW = None
    STATE_FIELDS = (
        ("params", "net", "q"), ("target_params", "net", "q"),
        ("opt", "rmsprop", "q"), ("step", "int32", None),
        ("epsilon", "float32", None))

    def __init__(self, cfg: DQNConfig, obs_dim: int, device="cuda"):
        self.cfg = cfg
        self.obs_dim = obs_dim
        self.device = resolve(device)
        self.net = QNetwork(obs_dim, cfg.n_actions, tuple(cfg.hidden)).to(
            self.device)
        self.net.eval()
        self.n_layers = self.net.n_layers
        self.layouts = {"q": layout(self.net)}
        self.state_cls = DQNState
        self.tx = RMSprop(cfg.lr, decay=0.9, eps=1e-6)

    # ---- parameters ----
    def init(self, seed: int = 0):
        gen = torch.Generator().manual_seed(seed)
        self.net.cpu().reset_parameters(gen)
        self.net.to(self.device)
        return self

    def init_state(self, seed: int = 0) -> DQNState:
        gen = torch.Generator().manual_seed(seed)
        net = QNetwork(self.obs_dim, self.cfg.n_actions,
                       tuple(self.cfg.hidden))
        net.reset_parameters(gen)
        p = flatten(net).to(self.device)
        return DQNState(
            params=p, target_params=p.clone(), opt=RMSprop.init(p),
            step=torch.zeros((), dtype=torch.int32, device=self.device),
            epsilon=torch.tensor(nm.f32(self.cfg.epsilon_start),
                                 device=self.device))

    def load_actor(self, state_dict: dict):
        """Load the greedy Q-network (the evaluate driver's name)."""
        self.net.load_state_dict(
            {k: torch.as_tensor(v) for k, v in state_dict.items()})
        return self

    def sync_actor(self, state: DQNState):
        load_flat(self.net, state.params)
        return self

    def q_params(self, flat: torch.Tensor) -> dict:
        return unflatten(flat, self.layouts["q"])

    def q_apply(self, params: dict, obs) -> torch.Tensor:
        return mlp_apply(params, obs.float(), self.n_layers)

    # ---- acting ----
    def exploration_draws(self, n: int, gen: torch.Generator):
        """``(rand, u)``: uniform action indices (n,) int32 and the
        epsilon pick's uniform [0, 1) (n,)."""
        rand = torch.randint(0, self.cfg.n_actions, (n,), generator=gen,
                             device=self.device, dtype=torch.int32)
        u = torch.rand((n,), generator=gen, device=self.device)
        return rand, u

    @torch.no_grad()
    def act(self, obs: torch.Tensor, explore: bool = False,
            state: DQNState | None = None,
            gen: torch.Generator | None = None, draws=None):
        """(N,) int32 action indices: the first argmax of Q (the state's
        network, or the module ``self.net``), with probability epsilon a
        uniform index when exploring."""
        if state is None:
            if explore:
                raise ValueError("exploration needs a DQNState")
            q = self.net(obs)
        else:
            q = self.q_apply(self.q_params(state.params), obs)
        greedy = torch.argmax(q, dim=-1).to(torch.int32)
        if not explore:
            return greedy
        if draws is None:
            draws = self.exploration_draws(obs.shape[0], gen)
        rand, u = draws
        return torch.where(u < state.epsilon, rand.to(torch.int32), greedy)

    def decay_epsilon(self, state: DQNState) -> DQNState:
        """``max(epsilon * decay, epsilon_min)`` in float32."""
        f = np.float32
        eps = max(f(state.epsilon.item()) * f(self.cfg.epsilon_decay),
                  f(self.cfg.epsilon_min))
        return dataclasses.replace(state, epsilon=torch.tensor(
            f(eps), device=state.epsilon.device))

    # ---- learning ----
    @torch.no_grad()
    def td_target(self, state: DQNState, batch: Transition) -> torch.Tensor:
        """(B,) ``r + (1 - done) gamma max_a Q_target(s', a)``."""
        next_q = self.q_apply(self.q_params(state.target_params),
                              batch.next_obs)
        return batch.reward + (1.0 - batch.done) * nm.f32(self.cfg.gamma) \
            * next_q.amax(dim=-1)

    def q_grad(self, flat, obs, action, target):
        idx = action.long()[:, None]

        def loss(p):
            q = self.q_apply(p, obs)
            return ((q.gather(1, idx)[:, 0] - target) ** 2).mean()
        return value_and_grad(loss, self.q_params(flat))

    @torch.no_grad()
    def update(self, state: DQNState, batch: Transition,
               gen: torch.Generator | None = None, grad_reduce=None):
        """One DQN step: ``(new state, {"loss"})``. ``grad_reduce``: the
        data-parallel learner, as ``TD3.update``'s."""
        target = self.td_target(state, batch)
        loss, grad = self.q_grad(state.params, batch.obs.float(),
                                 batch.action, target)
        if grad_reduce is not None:
            grad = grad_reduce(grad)
        params, opt = self.tx.update(grad, state.opt, state.params)
        step = state.step + 1
        copy = torch.remainder(step, self.cfg.target_update_period) == 0
        return DQNState(params=params,
                        target_params=torch.where(copy, params,
                                                  state.target_params),
                        opt=opt, step=step, epsilon=state.epsilon), \
            reduce_metrics(grad_reduce, {"loss": loss})
