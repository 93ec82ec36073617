"""TD3 (port of ``crowdnav_tpu/agents/td3.py``): twin critics with
clipped double-Q targets, target-policy smoothing noise, delayed policy
and target updates, Gaussian and epsilon-uniform exploration, soft target
updates, two Adam optimizers in optax's order (``agents/optim.py``).

The learner's state is a :class:`TD3State` of flat float32 parameter
vectors (``models/networks.flatten``), so that Adam and the soft updates
are whole-vector operations. As in the JAX package, every update has the
same work: the actor's step on a non-policy update is a zero gradient
(its Adam still decays the moments, counts and moves the parameters), and
the soft target updates are a select on ``update_count``, not a host
branch. Random draws come from a ``torch.Generator``; each drawing
function also takes the draws, so that a test can feed the JAX package's.

``self.actor`` (a :class:`DeterministicActor`) is the greedy policy of the
evaluation path; :meth:`TD3.act` with a ``state`` runs the state's actor.
``compute_dtype="bfloat16"`` runs every network's matmuls in bfloat16
(``models/networks.py``), as the JAX package's flax modules do.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import dataclasses
import functools

import numpy as np
import torch

from crowdnav_tpu_torch.agents.optim import Adam, AdamState
from crowdnav_tpu_torch.agents.replay import Transition
from crowdnav_tpu_torch.models.networks import (DeterministicActor,
                                                DoubleCritic, actor_apply,
                                                actor_heads, critic_apply,
                                                flatten, layout, load_flat,
                                                unflatten)
from crowdnav_tpu_torch.utils import numerics as nm
from crowdnav_tpu_torch.utils.device import resolve

# TD3Config.compute_dtype -> the MLPs' torch dtype
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class TD3Config:
    """The JAX ``TD3Config``, field for field (see its comments)."""

    hidden: int = 256
    actor_lr: float = 3e-4
    critic_lr: float = 3e-4
    gamma: float = 0.99
    tau: float = 0.005
    batch_size: int = 128
    buffer_size: int = 1_000_000
    max_lin_vel: float = 0.22
    max_ang_vel: float = 2.0
    policy_noise: float = 0.2
    noise_clip: float = 0.5
    policy_update: int = 2
    explore_sigma: float = 1.0
    explore_sigma_min: float = 1.0
    explore_decay_steps: int = 1_000_000
    explore_uniform_eps: float = 0.0
    explore_uniform_eps_min: float | None = None
    explore_eps_spectrum: bool = False
    compute_dtype: str = "float32"


@dataclasses.dataclass
class TD3State:
    actor_params: torch.Tensor    # (A,) flat float32
    actor_target: torch.Tensor
    critic_params: torch.Tensor   # (C,) flat float32, q1 then q2
    critic_target: torch.Tensor
    actor_opt: AdamState
    critic_opt: AdamState
    update_count: torch.Tensor    # () int32
    explore_sigma: torch.Tensor   # () float32
    explore_eps: torch.Tensor     # () float32


@functools.lru_cache(maxsize=16)
def _eps_spectrum(hi: float, lo: float, n: int, folded: bool, device):
    lib = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
    lib.powf.restype = ctypes.c_float
    lib.powf.argtypes = [ctypes.c_float, ctypes.c_float]
    f = np.float32
    idx = np.arange(n, dtype=f)
    den = f(max(n - 1, 1))
    frac = idx * (f(1.0) / den) if folded else idx / den
    base = f(lo / hi)
    return torch.from_numpy(f(hi) * np.array(
        [lib.powf(base, float(v)) for v in frac], f)).to(device)


def value_and_grad(loss_fn, params: dict) -> tuple:
    """``(loss, flat gradient)`` of ``loss_fn`` over a dict of parameter
    views, the gradient in the dict's order."""
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    with torch.enable_grad():
        loss = loss_fn(leaves)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), torch.cat([g.reshape(-1) for g in grads])


def reduce_metrics(grad_reduce, metrics: dict) -> dict:
    """The update's 0-dim metrics averaged over the ranks as the JAX
    package's ``pmean`` averages them: stacked into one vector and passed
    through the update's ``grad_reduce`` (None: as they are)."""
    if grad_reduce is None:
        return metrics
    mean = grad_reduce(torch.stack(list(metrics.values())))
    return dict(zip(metrics, mean.unbind()))


def spectrum_rows(cfg, rows, n: int, device) -> torch.Tensor:
    """(n, 1) per-env epsilons of the exploring rows: the spectrum of the
    whole batch (``rows`` = (envs in all, first row), the sharded
    trainer's) cut to this batch's rows, or of these ``n`` rows."""
    total, first = rows or (n, 0)
    return eps_spectrum(cfg, total, device=device)[first:first + n, None]


def eps_spectrum(cfg: TD3Config, n: int, folded: bool = True,
                 device="cpu") -> torch.Tensor:
    """(n,) float32 per-env epsilons ``eps * (eps_min / eps)^(i / (n-1))``
    with the C library's ``powf``. ``folded``: ``i / (n-1)`` as the jitted
    act computes it (times the float32 reciprocal); else a true division,
    as the JAX package's eager ``greedy_env_mask``."""
    hi = cfg.explore_uniform_eps
    lo = cfg.explore_uniform_eps_min or 0.01
    return _eps_spectrum(hi, lo, n, folded, torch.device(device))


class TD3:
    """A TD3 agent on ``device``: its networks' shapes, its optimizers and
    the greedy actor module ``self.actor``."""

    METRICS = ("critic_loss", "actor_loss", "q_target_mean")
    # the StepDraws field and the update's keyword of each update's draws
    UPDATE_DRAW = ("smoothing", "smoothing_noise")
    # the state's fields for utils/convert.py: (field, kind, network)
    STATE_FIELDS = (
        ("actor_params", "net", "actor"), ("actor_target", "net", "actor"),
        ("critic_params", "net", "critic"),
        ("critic_target", "net", "critic"), ("actor_opt", "adam", "actor"),
        ("critic_opt", "adam", "critic"), ("update_count", "int32", None),
        ("explore_sigma", "float32", None), ("explore_eps", "float32", None))

    def __init__(self, cfg: TD3Config, obs_dim: int, action_dim: int = 2,
                 device="cuda"):
        if cfg.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype must be one of "
                             f"{tuple(COMPUTE_DTYPES)}, got "
                             f"{cfg.compute_dtype!r}")
        # the MLPs' matmuls in bfloat16 with float32 sums; parameters,
        # Adam, TD targets and losses stay float32
        self.dtype = COMPUTE_DTYPES[cfg.compute_dtype]
        if self.dtype == torch.bfloat16:
            torch.backends.cuda.matmul.\
                allow_bf16_reduced_precision_reduction = False
        self.cfg = cfg
        self.obs_dim = obs_dim
        self.action_dim = action_dim
        self.device = resolve(device)
        self.actor = DeterministicActor(obs_dim, action_dim, cfg.hidden,
                                        cfg.max_lin_vel, cfg.max_ang_vel,
                                        self.dtype).to(self.device)
        self.actor.eval()
        self.actor_layout = layout(self.actor)
        self.critic_layout = layout(DoubleCritic(obs_dim, action_dim,
                                                 cfg.hidden))
        self.layouts = {"actor": self.actor_layout,
                        "critic": self.critic_layout}
        self.state_cls = TD3State
        self.actor_tx = Adam(cfg.actor_lr)
        self.critic_tx = Adam(cfg.critic_lr)
        self.lo = torch.tensor([0.0, -cfg.max_ang_vel], device=self.device)
        self.hi = torch.tensor([cfg.max_lin_vel, cfg.max_ang_vel],
                               device=self.device)
        # (envs in all, first row) of the exploring batch when it is one
        # rank's rows of a sharded batch (parallel/mesh.py), else None
        self.env_rows = None

    # ---- parameters ----
    def init(self, seed: int = 0):
        """Fresh actor module parameters with flax's initializers."""
        gen = torch.Generator().manual_seed(seed)
        self.actor.cpu().reset_parameters(gen)
        self.actor.to(self.device)
        return self

    def init_state(self, seed: int = 0) -> TD3State:
        """A fresh learner state: flax's initializers for the actor and
        the twin critics, targets equal to them, zero Adam moments."""
        gen = torch.Generator().manual_seed(seed)
        actor = DeterministicActor(self.obs_dim, self.action_dim,
                                   self.cfg.hidden)
        actor.reset_parameters(gen)
        critic = DoubleCritic(self.obs_dim, self.action_dim, self.cfg.hidden)
        critic.reset_parameters(gen)
        return self.state_from_flat(flatten(actor), flatten(critic))

    def state_from_flat(self, actor_flat, critic_flat) -> TD3State:
        dev = self.device
        a = actor_flat.to(dev, torch.float32)
        c = critic_flat.to(dev, torch.float32)
        return TD3State(
            actor_params=a, actor_target=a.clone(), critic_params=c,
            critic_target=c.clone(), actor_opt=Adam.init(a),
            critic_opt=Adam.init(c),
            update_count=torch.zeros((), dtype=torch.int32, device=dev),
            explore_sigma=torch.tensor(nm.f32(self.cfg.explore_sigma),
                                       device=dev),
            explore_eps=torch.tensor(nm.f32(self.cfg.explore_uniform_eps),
                                     device=dev))

    def load_actor(self, state_dict: dict):
        self.actor.load_state_dict(
            {k: torch.as_tensor(v) for k, v in state_dict.items()})
        return self

    def sync_actor(self, state: TD3State):
        """Copy the state's actor into the greedy module ``self.actor``."""
        load_flat(self.actor, state.actor_params)
        return self

    def actor_params(self, flat: torch.Tensor) -> dict:
        return unflatten(flat, self.actor_layout)

    def critic_params(self, flat: torch.Tensor) -> dict:
        return unflatten(flat, self.critic_layout)

    def _actor(self, params: dict, obs):
        return actor_apply(params, obs, self.cfg.max_lin_vel,
                           self.cfg.max_ang_vel, self.dtype)

    # ---- acting ----
    def exploration_draws(self, n: int, gen: torch.Generator):
        """``(noise, unif, u)`` for :meth:`explore`: standard normal
        (n, 2), uniform in the action box (n, 2), uniform [0, 1) (n, 1)."""
        dev = self.device
        noise = torch.randn((n, self.action_dim), generator=gen, device=dev)
        r = torch.rand((n, self.action_dim), generator=gen, device=dev)
        unif = torch.maximum(nm.fma(r, self.hi - self.lo, self.lo), self.lo)
        u = torch.rand((n, 1), generator=gen, device=dev)
        return noise, unif, u

    def explore(self, heads, state: TD3State, noise, unif, u):
        """The behavior action before the clip, from the actor's
        :func:`actor_heads`: the action plus Gaussian ``explore_sigma``
        noise, then with probability eps (the per-env spectrum, or the
        state's annealed scalar) a uniform action from the box. Each
        head's scale and the noise are summed as one fused multiply-add,
        ``fma(head, v_max, noise * sigma)``, as XLA's CPU program of the
        jitted JAX act was seen to (256-wide actor, sigma 1)."""
        scaled = noise * state.explore_sigma
        action = torch.cat([
            nm.fma(heads[0], nm.f32(self.cfg.max_lin_vel), scaled[:, :1]),
            nm.fma(heads[1], nm.f32(self.cfg.max_ang_vel), scaled[:, 1:])],
            dim=-1)
        if self.cfg.explore_uniform_eps > 0.0:
            if self.cfg.explore_eps_spectrum:
                eps = spectrum_rows(self.cfg, self.env_rows,
                                    action.shape[0], action.device)
            else:
                eps = torch.clamp(state.explore_eps, 0.0, 1.0)
            action = torch.where(u < eps, unif, action)
        return action

    @torch.no_grad()
    def act(self, obs: torch.Tensor, explore: bool = False,
            state: TD3State | None = None, gen: torch.Generator | None = None,
            draws=None) -> torch.Tensor:
        """The policy's action clipped to the box: ``state``'s actor (the
        module ``self.actor`` without a state), with exploration when
        ``explore``, from ``draws`` or drawn from ``gen``."""
        if explore:
            if state is None:
                raise ValueError("exploration needs a TD3State")
            if draws is None:
                draws = self.exploration_draws(obs.shape[0], gen)
            heads = actor_heads(self.actor_params(state.actor_params), obs,
                                self.dtype)
            action = self.explore(heads, state, *draws)
        elif state is None:
            action = self.actor(obs)
        else:
            action = self._actor(self.actor_params(state.actor_params), obs)
        return torch.clamp(action, self.lo, self.hi)

    def decay_sigma(self, state: TD3State, env_steps: int) -> TD3State:
        """Linear anneal of the Gaussian sigma and, with
        ``explore_uniform_eps_min``, of the epsilon, over
        ``explore_decay_steps`` env-steps (float32, as the JAX package's
        eager ``decay_sigma``)."""
        cfg, f = self.cfg, np.float32
        frac = f(min(1.0, env_steps / cfg.explore_decay_steps))
        sigma = f(cfg.explore_sigma) - f(cfg.explore_sigma
                                         - cfg.explore_sigma_min) * frac
        state = dataclasses.replace(state, explore_sigma=torch.tensor(
            sigma, device=state.explore_sigma.device))
        if cfg.explore_uniform_eps_min is not None:
            eps = f(cfg.explore_uniform_eps) - f(
                cfg.explore_uniform_eps - cfg.explore_uniform_eps_min) * frac
            state = dataclasses.replace(state, explore_eps=torch.tensor(
                eps, device=state.explore_eps.device))
        return state

    # ---- learning ----
    @torch.no_grad()
    def td_target(self, state: TD3State, batch: Transition,
                  smoothing_noise: torch.Tensor) -> torch.Tensor:
        """(B, 1) clipped double-Q target from the target networks, with
        the smoothing noise (standard normal, (B, 2)) scaled and clipped;
        the smoothed action is not re-clipped to the box, as in the
        reference."""
        cfg = self.cfg
        next_obs = batch.next_obs.float()
        next_action = self._actor(self.actor_params(state.actor_target),
                                  next_obs)
        clip = nm.f32(cfg.noise_clip)
        noise = torch.clamp(smoothing_noise * nm.f32(cfg.policy_noise),
                            -clip, clip)
        tq1, tq2 = critic_apply(self.critic_params(state.critic_target),
                                next_obs, next_action + noise,
                                dtype=self.dtype)
        return batch.reward[:, None] + (1.0 - batch.done[:, None]) \
            * nm.f32(cfg.gamma) * torch.minimum(tq1, tq2)

    def critic_grad(self, critic_flat: torch.Tensor, obs, action, y):
        """``(loss, flat gradient)`` of the twin critics' TD loss."""
        def critic_loss(p):
            q1, q2 = critic_apply(p, obs, action, dtype=self.dtype)
            return ((q1 - y) ** 2).mean() + ((q2 - y) ** 2).mean()

        return value_and_grad(critic_loss, self.critic_params(critic_flat))

    def actor_grad(self, actor_flat: torch.Tensor,
                   critic_flat: torch.Tensor, obs):
        """``(loss, flat gradient)`` of the actor's loss ``-mean q1``
        under the critic ``critic_flat``."""
        critic = self.critic_params(critic_flat)

        def actor_loss(p):
            q1, = critic_apply(critic, obs, self._actor(p, obs),
                               heads=("q1",), dtype=self.dtype)
            return -q1.mean()

        return value_and_grad(actor_loss, self.actor_params(actor_flat))

    @torch.no_grad()
    def update(self, state: TD3State, batch: Transition,
               gen: torch.Generator | None = None,
               smoothing_noise: torch.Tensor | None = None,
               grad_reduce=None):
        """One TD3 gradient step on ``batch``: ``(new state, metrics)``
        with 0-dim tensors ``critic_loss``, ``actor_loss`` and
        ``q_target_mean``. ``smoothing_noise``: pre-drawn standard normal
        target-smoothing noise (B, 2), else drawn from ``gen``.

        ``grad_reduce`` (the JAX ``axis_name``): the data-parallel learner,
        ``batch`` being this rank's share of the global batch. It maps a
        flat gradient to the ranks' mean, the sum of the per-rank local
        mean gradients divided by the rank count, and is applied to each
        network's gradient where the JAX update applies ``gnorm``; every
        rank then takes the same optimizer step. The metrics are averaged
        through it (the JAX ``pmean``)."""
        cfg = self.cfg
        obs = batch.obs.float()
        if smoothing_noise is None:
            smoothing_noise = torch.randn(
                (obs.shape[0], self.action_dim), generator=gen,
                device=obs.device)
        y = self.td_target(state, batch, smoothing_noise)
        c_loss, c_grad = self.critic_grad(state.critic_params, obs,
                                          batch.action, y)
        if grad_reduce is not None:
            c_grad = grad_reduce(c_grad)
        critic_params, critic_opt = self.critic_tx.update(
            c_grad, state.critic_opt, state.critic_params)

        # the delayed actor step: a zero gradient on non-policy updates
        do_policy = torch.remainder(state.update_count,
                                    cfg.policy_update) == 0
        a_loss, a_grad = self.actor_grad(state.actor_params, critic_params,
                                         obs)
        if grad_reduce is not None:
            a_grad = grad_reduce(a_grad)
        a_grad = a_grad * do_policy.to(torch.float32)
        actor_params, actor_opt = self.actor_tx.update(
            a_grad, state.actor_opt, state.actor_params)

        tau = nm.f32(cfg.tau)

        def soft(target, online):
            return torch.where(do_policy, target * nm.f32(1.0 - cfg.tau)
                               + online * tau, target)

        new = dataclasses.replace(
            state, actor_params=actor_params,
            actor_target=soft(state.actor_target, actor_params),
            critic_params=critic_params,
            critic_target=soft(state.critic_target, critic_params),
            actor_opt=actor_opt, critic_opt=critic_opt,
            update_count=state.update_count + 1)
        metrics = {"critic_loss": c_loss, "actor_loss": a_loss,
                   "q_target_mean": y.mean()}
        return new, reduce_metrics(grad_reduce, metrics)
