"""SAC, the 2018 value-network variant (port of
``crowdnav_tpu/agents/sac.py``): a Gaussian actor with tanh squashing and
the reference's action heads, one soft-Q network, a state-value network
with a soft-updated target, the mean/std/z regularizers, and the
reference's score-function policy loss
``mean(log_prob * stop_gradient(log_prob - (Q - V)))``; three Adam
optimizers in optax's order.

One standard-normal draw of shape (B, action_dim) serves the whole update:
the new action and its log-prob, and again the policy loss's resample, as
in the JAX package, where both ``_sample`` calls take the update's key.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from crowdnav_tpu_torch.agents.optim import Adam, AdamState
from crowdnav_tpu_torch.agents.replay import Transition
from crowdnav_tpu_torch.agents.td3 import reduce_metrics, value_and_grad
from crowdnav_tpu_torch.models.networks import (GaussianActor, QCritic,
                                                ValueNetwork, flatten,
                                                gaussian_apply, layout,
                                                load_flat, mlp_apply, squash,
                                                unflatten)
from crowdnav_tpu_torch.utils import numerics as nm
from crowdnav_tpu_torch.utils.device import resolve

LOG_2PI_HALF = nm.f32(0.5 * math.log(2 * math.pi))


@dataclasses.dataclass(frozen=True)
class SACConfig:
    """The JAX ``SACConfig``, field for field (see its comments)."""

    hidden: int = 256
    value_hidden: int = 256
    actor_lr: float = 3e-4
    value_lr: float = 3e-4
    soft_q_lr: float = 3e-4
    gamma: float = 0.99
    tau: float = 5e-3
    batch_size: int = 64
    buffer_size: int = 1_000_000
    max_lin_vel: float = 0.22
    max_ang_vel: float = 2.0
    mean_lambda: float = 1e-3
    std_lambda: float = 1e-3
    z_lambda: float = 0.0


@dataclasses.dataclass
class SACState:
    actor_params: torch.Tensor    # flat float32
    value_params: torch.Tensor
    value_target: torch.Tensor
    soft_q_params: torch.Tensor
    actor_opt: AdamState
    value_opt: AdamState
    soft_q_opt: AdamState


class SAC:
    """A SAC agent on ``device``, with the greedy actor module
    ``self.actor`` (``GaussianActor.greedy``)."""

    METRICS = ("q_loss", "value_loss", "policy_loss")
    UPDATE_DRAW = ("sac_noise", "noise")
    STATE_FIELDS = (
        ("actor_params", "net", "actor"), ("value_params", "net", "value"),
        ("value_target", "net", "value"),
        ("soft_q_params", "net", "soft_q"), ("actor_opt", "adam", "actor"),
        ("value_opt", "adam", "value"), ("soft_q_opt", "adam", "soft_q"))

    def __init__(self, cfg: SACConfig, obs_dim: int, action_dim: int = 2,
                 device="cuda"):
        self.cfg = cfg
        self.obs_dim = obs_dim
        self.action_dim = action_dim
        self.device = resolve(device)
        self.actor = GaussianActor(obs_dim, action_dim, cfg.hidden,
                                   max_lin_vel=cfg.max_lin_vel,
                                   max_ang_vel=cfg.max_ang_vel).to(
                                       self.device)
        self.actor.eval()
        self.layouts = {
            "actor": layout(self.actor),
            "value": layout(ValueNetwork(obs_dim, cfg.value_hidden)),
            "soft_q": layout(QCritic(obs_dim, action_dim, cfg.hidden))}
        self.state_cls = SACState
        self.actor_tx = Adam(cfg.actor_lr)
        self.value_tx = Adam(cfg.value_lr)
        self.soft_q_tx = Adam(cfg.soft_q_lr)
        self.lo = torch.tensor([0.0, -cfg.max_ang_vel], device=self.device)
        self.hi = torch.tensor([cfg.max_lin_vel, cfg.max_ang_vel],
                               device=self.device)

    # ---- parameters ----
    def init(self, seed: int = 0):
        gen = torch.Generator().manual_seed(seed)
        self.actor.cpu().reset_parameters(gen)
        self.actor.to(self.device)
        return self

    def init_state(self, seed: int = 0) -> SACState:
        """flax's initializers (the heads and the value net's last layer
        U[0, 3e-3)), the value target equal to the value net, zero Adam
        moments."""
        gen = torch.Generator().manual_seed(seed)
        actor = GaussianActor(self.obs_dim, self.action_dim, self.cfg.hidden)
        actor.reset_parameters(gen)
        value = ValueNetwork(self.obs_dim, self.cfg.value_hidden)
        value.reset_parameters(gen)
        soft_q = QCritic(self.obs_dim, self.action_dim, self.cfg.hidden)
        soft_q.reset_parameters(gen)
        a, v, q = (flatten(m).to(self.device) for m in (actor, value,
                                                         soft_q))
        return SACState(actor_params=a, value_params=v, value_target=v.clone(),
                        soft_q_params=q, actor_opt=Adam.init(a),
                        value_opt=Adam.init(v), soft_q_opt=Adam.init(q))

    def load_actor(self, state_dict: dict):
        self.actor.load_state_dict(
            {k: torch.as_tensor(v) for k, v in state_dict.items()})
        return self

    def sync_actor(self, state: SACState):
        load_flat(self.actor, state.actor_params)
        return self

    def params(self, net: str, flat: torch.Tensor) -> dict:
        return unflatten(flat, self.layouts[net])

    def value_apply(self, params: dict, obs) -> torch.Tensor:
        return mlp_apply(params, obs.float())

    def q_apply(self, params: dict, obs, action) -> torch.Tensor:
        return mlp_apply(params, torch.cat([obs.float(), action.float()],
                                           dim=-1))

    def sample(self, params: dict, obs, noise):
        """``(action, log_prob, z, mean, log_std)`` of the JAX ``_sample``
        for the standard-normal ``noise`` (B, action_dim): z = mean + std
        noise, the log-density of the tanh-squashed Gaussian summed over
        the action (B, 1), the action ``squash(z)``."""
        mean, log_std = gaussian_apply(params, obs.float())
        std = torch.exp(log_std)
        z = mean + std * noise
        a_tanh = torch.tanh(z)
        log_prob = (-0.5 * ((z - mean) / std) ** 2 - torch.log(std)
                    - LOG_2PI_HALF - torch.log(1 - a_tanh ** 2 + 1e-6))
        log_prob = log_prob.sum(dim=-1, keepdim=True)
        action = squash(z, self.cfg.max_lin_vel, self.cfg.max_ang_vel)
        return action, log_prob, z, mean, log_std

    # ---- acting ----
    def exploration_draws(self, n: int, gen: torch.Generator):
        """The policy sample's standard normal, (n, action_dim)."""
        return torch.randn((n, self.action_dim), generator=gen,
                           device=self.device)

    @torch.no_grad()
    def act(self, obs: torch.Tensor, explore: bool = False,
            state: SACState | None = None,
            gen: torch.Generator | None = None, draws=None):
        """The clipped action: ``squash(z)`` of a policy sample when
        exploring (``draws``: its normal, else drawn from ``gen``), else
        ``squash(mean)``; the state's actor, or the module ``self.actor``
        without a state."""
        if state is None:
            if explore:
                raise ValueError("exploration needs a SACState")
            return torch.clamp(self.actor.greedy(obs), self.lo, self.hi)
        params = self.params("actor", state.actor_params)
        if explore:
            if draws is None:
                draws = self.exploration_draws(obs.shape[0], gen)
            action = self.sample(params, obs, draws)[0]
        else:
            mean, _ = gaussian_apply(params, obs.float())
            action = squash(mean, self.cfg.max_lin_vel, self.cfg.max_ang_vel)
        return torch.clamp(action, self.lo, self.hi)

    # ---- learning ----
    def q_grad(self, q_flat, obs, action, next_q):
        def loss(p):
            return ((self.q_apply(p, obs, action) - next_q) ** 2).mean()
        return value_and_grad(loss, self.params("soft_q", q_flat))

    def value_grad(self, v_flat, obs, next_value):
        def loss(p):
            return ((self.value_apply(p, obs) - next_value) ** 2).mean()
        return value_and_grad(loss, self.params("value", v_flat))

    def policy_grad(self, a_flat, obs, noise, log_prob_target):
        cfg = self.cfg

        def loss(p):
            _, lp, zz, mu, ls = self.sample(p, obs, noise)
            adv = (lp - log_prob_target).detach()
            out = (lp * adv).mean()
            out = out + nm.f32(cfg.mean_lambda) * (mu ** 2).mean()
            out = out + nm.f32(cfg.std_lambda) * (ls ** 2).mean()
            out = out + nm.f32(cfg.z_lambda) * (zz ** 2).sum(-1).mean()
            return out
        return value_and_grad(loss, self.params("actor", a_flat))

    @torch.no_grad()
    def update(self, state: SACState, batch: Transition,
               gen: torch.Generator | None = None,
               noise: torch.Tensor | None = None, grad_reduce=None):
        """One SAC step on ``batch``: ``(new state, metrics)`` with 0-dim
        ``q_loss``, ``value_loss`` and ``policy_loss``. ``noise``: the
        update's standard normal (B, action_dim), else drawn from
        ``gen``. ``grad_reduce``: the data-parallel learner, as
        ``TD3.update``'s."""
        reduce = grad_reduce or (lambda g: g)
        cfg = self.cfg
        obs = batch.obs.float()
        if noise is None:
            noise = torch.randn((obs.shape[0], self.action_dim),
                                generator=gen, device=obs.device)
        gamma = nm.f32(cfg.gamma)
        tv = self.value_apply(self.params("value", state.value_target),
                              batch.next_obs)
        next_q = batch.reward[:, None] + (1.0 - batch.done[:, None]) \
            * gamma * tv
        ql, q_grad = self.q_grad(state.soft_q_params, obs, batch.action,
                                 next_q)
        q_grad = reduce(q_grad)
        soft_q, soft_q_opt = self.soft_q_tx.update(
            q_grad, state.soft_q_opt, state.soft_q_params)

        new_action, log_prob, _, _, _ = self.sample(
            self.params("actor", state.actor_params), obs, noise)
        expected_new_q = self.q_apply(self.params("soft_q", soft_q), obs,
                                      new_action)
        next_value = expected_new_q - log_prob
        vl, v_grad = self.value_grad(state.value_params, obs, next_value)
        v_grad = reduce(v_grad)
        value, value_opt = self.value_tx.update(v_grad, state.value_opt,
                                                state.value_params)

        expected_value = self.value_apply(self.params("value", value), obs)
        log_prob_target = expected_new_q - expected_value
        pl, p_grad = self.policy_grad(state.actor_params, obs, noise,
                                      log_prob_target)
        p_grad = reduce(p_grad)
        actor, actor_opt = self.actor_tx.update(p_grad, state.actor_opt,
                                                state.actor_params)
        keep, tau = nm.f32(1.0 - cfg.tau), nm.f32(cfg.tau)
        new = SACState(
            actor_params=actor, value_params=value,
            value_target=state.value_target * keep + value * tau,
            soft_q_params=soft_q, actor_opt=actor_opt, value_opt=value_opt,
            soft_q_opt=soft_q_opt)
        return new, reduce_metrics(
            grad_reduce, {"q_loss": ql, "value_loss": vl, "policy_loss": pl})
