"""DDPG (port of ``crowdnav_tpu/agents/ddpg.py``): one critic, the TD3
actor, soft target updates every step, two Adam optimizers in optax's
order, and Ornstein-Uhlenbeck exploration carried per env in the state.

The OU step is ``ou + theta * (0 - ou) + sigma * u`` with ``u`` uniform
in [0, 1), as the reference draws it (not Gaussian). With
``explore_uniform_eps`` the action is then replaced, with probability eps
(one constant or the per-env spectrum ``eps * (eps_min / eps)^(i/(N-1))``
with ``eps_min or 0.01``), by a uniform action from the box; then clipped.
As in TD3, each drawing function also takes the draws, so that a test can
feed the JAX package's, and the state's networks are flat float32 vectors.
"""
from __future__ import annotations

import dataclasses

import torch

from crowdnav_tpu_torch.agents.optim import Adam, AdamState
from crowdnav_tpu_torch.agents.replay import Transition
from crowdnav_tpu_torch.agents.td3 import (reduce_metrics, spectrum_rows,
                                           value_and_grad)
from crowdnav_tpu_torch.models.networks import (DeterministicActor, QCritic,
                                                actor_apply, actor_heads,
                                                flatten, layout, load_flat,
                                                mlp_apply, unflatten)
from crowdnav_tpu_torch.utils import numerics as nm
from crowdnav_tpu_torch.utils.device import resolve


@dataclasses.dataclass(frozen=True)
class DDPGConfig:
    """The JAX ``DDPGConfig``, field for field (see its comments)."""

    hidden: int = 256
    actor_lr: float = 3e-4
    critic_lr: float = 3e-4
    gamma: float = 0.99
    tau: float = 0.005
    batch_size: int = 64
    buffer_size: int = 1_000_000
    max_lin_vel: float = 0.22
    max_ang_vel: float = 2.0
    ou_theta: float = 0.15
    ou_sigma: float = 0.2
    explore_uniform_eps: float = 0.0
    explore_uniform_eps_min: float = 0.01
    explore_eps_spectrum: bool = False


@dataclasses.dataclass
class DDPGState:
    actor_params: torch.Tensor    # (A,) flat float32
    actor_target: torch.Tensor
    critic_params: torch.Tensor   # (C,) flat float32
    critic_target: torch.Tensor
    actor_opt: AdamState
    critic_opt: AdamState
    ou_state: torch.Tensor        # (n_envs, action_dim) float32


class DDPG:
    """A DDPG agent on ``device`` for ``n_envs`` exploring envs, with the
    greedy actor module ``self.actor``."""

    METRICS = ("critic_loss", "actor_loss")
    UPDATE_DRAW = None
    STATE_FIELDS = (
        ("actor_params", "net", "actor"), ("actor_target", "net", "actor"),
        ("critic_params", "net", "critic"),
        ("critic_target", "net", "critic"), ("actor_opt", "adam", "actor"),
        ("critic_opt", "adam", "critic"), ("ou_state", "per_env", None))

    def __init__(self, cfg: DDPGConfig, obs_dim: int, action_dim: int = 2,
                 n_envs: int = 1, device="cuda"):
        self.cfg = cfg
        self.obs_dim = obs_dim
        self.action_dim = action_dim
        self.n_envs = n_envs
        self.device = resolve(device)
        self.actor = DeterministicActor(obs_dim, action_dim, cfg.hidden,
                                        cfg.max_lin_vel,
                                        cfg.max_ang_vel).to(self.device)
        self.actor.eval()
        self.layouts = {"actor": layout(self.actor),
                        "critic": layout(QCritic(obs_dim, action_dim,
                                                 cfg.hidden))}
        self.state_cls = DDPGState
        self.actor_tx = Adam(cfg.actor_lr)
        self.critic_tx = Adam(cfg.critic_lr)
        self.lo = torch.tensor([0.0, -cfg.max_ang_vel], device=self.device)
        self.hi = torch.tensor([cfg.max_lin_vel, cfg.max_ang_vel],
                               device=self.device)
        self.env_rows = None        # as TD3's: a sharded batch's rows

    # ---- parameters ----
    def init(self, seed: int = 0):
        """Fresh actor module parameters with flax's initializers."""
        gen = torch.Generator().manual_seed(seed)
        self.actor.cpu().reset_parameters(gen)
        self.actor.to(self.device)
        return self

    def init_state(self, seed: int = 0) -> DDPGState:
        """flax's initializers for the actor and the critic, targets equal
        to them, zero Adam moments, zero OU carry."""
        gen = torch.Generator().manual_seed(seed)
        actor = DeterministicActor(self.obs_dim, self.action_dim,
                                   self.cfg.hidden)
        actor.reset_parameters(gen)
        critic = QCritic(self.obs_dim, self.action_dim, self.cfg.hidden)
        critic.reset_parameters(gen)
        dev = self.device
        a, c = flatten(actor).to(dev), flatten(critic).to(dev)
        return DDPGState(
            actor_params=a, actor_target=a.clone(), critic_params=c,
            critic_target=c.clone(), actor_opt=Adam.init(a),
            critic_opt=Adam.init(c),
            ou_state=torch.zeros((self.n_envs, self.action_dim),
                                 device=dev))

    def load_actor(self, state_dict: dict):
        self.actor.load_state_dict(
            {k: torch.as_tensor(v) for k, v in state_dict.items()})
        return self

    def sync_actor(self, state: DDPGState):
        load_flat(self.actor, state.actor_params)
        return self

    def actor_params(self, flat: torch.Tensor) -> dict:
        return unflatten(flat, self.layouts["actor"])

    def critic_params(self, flat: torch.Tensor) -> dict:
        return unflatten(flat, self.layouts["critic"])

    def _actor(self, params: dict, obs):
        return actor_apply(params, obs, self.cfg.max_lin_vel,
                           self.cfg.max_ang_vel)

    def critic_apply(self, params: dict, obs, action) -> torch.Tensor:
        return mlp_apply(params, torch.cat([obs.float(), action.float()],
                                           dim=-1))

    # ---- acting ----
    def exploration_draws(self, n: int, gen: torch.Generator):
        """``(u, unif, pick)`` for :meth:`explore`: the OU step's uniform
        [0, 1) (n, 2), a uniform action from the box (n, 2), the epsilon
        pick's uniform [0, 1) (n, 1)."""
        dev = self.device
        u = torch.rand((n, self.action_dim), generator=gen, device=dev)
        r = torch.rand((n, self.action_dim), generator=gen, device=dev)
        unif = torch.maximum(nm.fma(r, self.hi - self.lo, self.lo), self.lo)
        pick = torch.rand((n, 1), generator=gen, device=dev)
        return u, unif, pick

    def explore(self, heads, state: DDPGState, u, unif, pick):
        """``(behavior action before the clip, new OU carry)`` from the
        actor's :func:`actor_heads`: the OU step, the action plus the new
        carry, then the epsilon-uniform mix. XLA's CPU program of the
        jitted JAX act was seen to fuse the OU step as
        ``fma(sigma, u, fma(theta, 0 - ou, ou))`` and each head's scale
        with the carry, ``fma(head, v_max, ou)``."""
        cfg = self.cfg
        ou = state.ou_state
        ou = nm.fma(nm.f32(cfg.ou_sigma), u,
                    nm.fma(nm.f32(cfg.ou_theta), 0.0 - ou, ou))
        action = torch.cat([
            nm.fma(heads[0], nm.f32(cfg.max_lin_vel), ou[:, :1]),
            nm.fma(heads[1], nm.f32(cfg.max_ang_vel), ou[:, 1:])], dim=-1)
        if cfg.explore_uniform_eps > 0.0:
            if cfg.explore_eps_spectrum:
                eps = spectrum_rows(cfg, self.env_rows, action.shape[0],
                                    action.device)
            else:
                eps = nm.f32(cfg.explore_uniform_eps)
            action = torch.where(pick < eps, unif, action)
        return action, ou

    @torch.no_grad()
    def act(self, obs: torch.Tensor, explore: bool = False,
            state: DDPGState | None = None,
            gen: torch.Generator | None = None, draws=None):
        """The clipped action; with a ``state``, ``(action, new state)``
        (the OU carry moves only when exploring), as the JAX ``act``."""
        if state is None:
            if explore:
                raise ValueError("exploration needs a DDPGState")
            return torch.clamp(self.actor(obs), self.lo, self.hi)
        if not explore:
            action = self._actor(self.actor_params(state.actor_params), obs)
            return torch.clamp(action, self.lo, self.hi), state
        if draws is None:
            draws = self.exploration_draws(obs.shape[0], gen)
        heads = actor_heads(self.actor_params(state.actor_params), obs)
        action, ou = self.explore(heads, state, *draws)
        return (torch.clamp(action, self.lo, self.hi),
                dataclasses.replace(state, ou_state=ou))

    # ---- learning ----
    @torch.no_grad()
    def td_target(self, state: DDPGState, batch: Transition):
        """(B, 1) bootstrap ``r + (1 - done) gamma Q'(s', mu'(s'))``."""
        next_obs = batch.next_obs.float()
        next_action = self._actor(self.actor_params(state.actor_target),
                                  next_obs)
        tq = self.critic_apply(self.critic_params(state.critic_target),
                               next_obs, next_action)
        return batch.reward[:, None] + (1.0 - batch.done[:, None]) \
            * nm.f32(self.cfg.gamma) * tq

    def critic_grad(self, critic_flat, obs, action, y):
        def loss(p):
            return ((self.critic_apply(p, obs, action) - y) ** 2).mean()
        return value_and_grad(loss, self.critic_params(critic_flat))

    def actor_grad(self, actor_flat, critic_flat, obs):
        critic = self.critic_params(critic_flat)

        def loss(p):
            return -self.critic_apply(critic, obs, self._actor(p, obs)).mean()
        return value_and_grad(loss, self.actor_params(actor_flat))

    @torch.no_grad()
    def update(self, state: DDPGState, batch: Transition,
               gen: torch.Generator | None = None, grad_reduce=None):
        """One DDPG step: the critic's TD step, the actor's step under the
        updated critic, soft target updates; ``(new state, metrics)``.
        ``grad_reduce``: the data-parallel learner, as ``TD3.update``'s."""
        cfg = self.cfg
        obs = batch.obs.float()
        y = self.td_target(state, batch)
        c_loss, c_grad = self.critic_grad(state.critic_params, obs,
                                          batch.action, y)
        if grad_reduce is not None:
            c_grad = grad_reduce(c_grad)
        critic, critic_opt = self.critic_tx.update(
            c_grad, state.critic_opt, state.critic_params)
        a_loss, a_grad = self.actor_grad(state.actor_params, critic, obs)
        if grad_reduce is not None:
            a_grad = grad_reduce(a_grad)
        actor, actor_opt = self.actor_tx.update(a_grad, state.actor_opt,
                                                state.actor_params)
        keep, tau = nm.f32(1.0 - cfg.tau), nm.f32(cfg.tau)
        new = dataclasses.replace(
            state, actor_params=actor,
            actor_target=state.actor_target * keep + actor * tau,
            critic_params=critic,
            critic_target=state.critic_target * keep + critic * tau,
            actor_opt=actor_opt, critic_opt=critic_opt)
        return new, reduce_metrics(grad_reduce, {"critic_loss": c_loss,
                                                 "actor_loss": a_loss})
