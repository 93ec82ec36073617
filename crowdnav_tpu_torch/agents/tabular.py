"""Tabular Q-learning and SARSA over the digitized (distance, heading)
grid (port of ``crowdnav_tpu/agents/tabular.py``).

The reference digitizes the distance to the goal into 31 buckets of 0.1 m
and the heading into 33 buckets of 0.19625 rad (``np.digitize`` on its
rounded bin edges), keys a dict with the pair, and learns with
epsilon-greedy exploration whose random tie-break adds magnitude-scaled
noise to the row before the argmax (``qlearn.py:47-72``). Here the table
is a dense ``(n_states, 3)`` device tensor with a ``visited`` mask in the
role of dict membership (an unvisited entry reads 0.0, and its first
update stores the raw reward, ``qlearn.py:34-45``).

Every random draw comes from an explicit ``torch.Generator``, or is
passed in (:func:`act_draws`), so that a test can feed the JAX package's.
Updates of a batch run one env after another, as the JAX driver's scan
over envs does, so that two envs writing one entry see each other's
writes.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from crowdnav_tpu_torch.utils import numerics as nm
from crowdnav_tpu_torch.utils.device import resolve

N_DIST_BINS = 30   # np.arange(0, 3, 0.1): 30 edges, 31 buckets
N_RAD_BINS = 32    # np.arange(-3.14, 3.14, 0.19625): 32 edges, 33 buckets
N_STATES = (N_DIST_BINS + 1) * (N_RAD_BINS + 1)
# the edges in float64 (as the reference's np.arange), rounded, then float32
_DIST_EDGES = np.round(np.arange(0.0, 3.0, 0.1), 2).astype(np.float32)
_RAD_EDGES = np.round(np.arange(-3.14, 3.14, 0.19625), 2).astype(np.float32)


def discretize_state(dtg, htg):
    """(dtg, htg) -> flat table index (int64), ``np.digitize`` on the
    reference's rounded edges: the bucket is the number of edges <= x."""
    d_edges = torch.from_numpy(_DIST_EDGES).to(dtg.device)
    r_edges = torch.from_numpy(_RAD_EDGES).to(htg.device)
    di = torch.searchsorted(d_edges, dtg.contiguous(), right=True)
    hi = torch.searchsorted(r_edges, htg.contiguous(), right=True)
    return di * (N_RAD_BINS + 1) + hi


@dataclasses.dataclass(frozen=True)
class TabularConfig:
    """The JAX ``TabularConfig`` (``configs/qlearn.yaml``)."""

    alpha: float = 0.2
    gamma: float = 0.9
    epsilon_start: float = 0.9
    epsilon_min: float = 0.05
    epsilon_decay: float = 0.9986
    n_actions: int = 3


@dataclasses.dataclass
class TabularState:
    q: torch.Tensor        # (n_states, n_actions) float32
    epsilon: torch.Tensor  # () float32
    visited: torch.Tensor  # (n_states, n_actions) bool


def save_table(path: str, state: TabularState) -> None:
    """The table as ``.npz`` (``q``, ``epsilon``, ``visited``), the JAX
    package's format."""
    np.savez(path, q=state.q.cpu().numpy(),
             epsilon=state.epsilon.cpu().numpy(),
             visited=state.visited.cpu().numpy())


def load_table(path: str, device="cuda") -> TabularState:
    """A table written by :func:`save_table` or by the JAX package, on
    ``device``."""
    device = resolve(device)
    if not path.endswith(".npz"):
        path += ".npz"
    d = np.load(path)
    return TabularState(
        q=torch.from_numpy(d["q"].astype(np.float32)).to(device),
        epsilon=torch.tensor(np.float32(d["epsilon"]), device=device),
        visited=torch.from_numpy(d["visited"].astype(bool)).to(device))


def act_draws(n: int, n_actions: int, gen: torch.Generator, device):
    """``(u_noise (n, A), u_jitter (n,))``: the uniform [0, 1) draws of
    :meth:`act`'s exploration, the JAX package's ``k1``/``k2``."""
    return (torch.rand((n, n_actions), generator=gen, device=device),
            torch.rand((n,), generator=gen, device=device))


class _TabularBase:
    def __init__(self, cfg: TabularConfig, device="cuda"):
        self.cfg = cfg
        self.device = resolve(device)

    def init(self) -> TabularState:
        shape = (N_STATES, self.cfg.n_actions)
        return TabularState(
            q=torch.zeros(shape, dtype=torch.float32, device=self.device),
            epsilon=torch.tensor(nm.f32(self.cfg.epsilon_start),
                                 device=self.device),
            visited=torch.zeros(shape, dtype=torch.bool,
                                device=self.device))

    def act(self, state: TabularState, s_idx, explore: bool = True,
            gen: torch.Generator | None = None, draws=None):
        """Epsilon-greedy with the reference's tie-break: with probability
        epsilon, ``(u - 0.5) * max|Q(s)|`` is added to the row before the
        first-index argmax. ``draws`` from :func:`act_draws`, else drawn
        from ``gen``. Returns (n,) int32 actions."""
        q = state.q[s_idx]
        if explore:
            if draws is None:
                draws = act_draws(q.shape[0], q.shape[1], gen, q.device)
            u_noise, u_jitter = draws
            mag = q.abs().amax(dim=-1, keepdim=True)
            noise = (u_noise - 0.5) * mag
            jitter = (u_jitter < state.epsilon)[:, None]
            q = torch.where(jitter, q + noise, q)
        return q.argmax(dim=-1).to(torch.int32)

    def decay_epsilon(self, state: TabularState) -> TabularState:
        eps = torch.clamp_min(state.epsilon * nm.f32(self.cfg.epsilon_decay),
                              nm.f32(self.cfg.epsilon_min))
        return dataclasses.replace(state, epsilon=eps)

    def _learn_q(self, state: TabularState, s, a, reward, value):
        """``learnQ`` (``qlearn.py:34-45``) of one entry, in place: a first
        visit stores the raw reward, later visits move toward ``value`` by
        alpha."""
        old = state.q[s, a]
        new = torch.where(state.visited[s, a],
                          nm.fma(nm.f32(self.cfg.alpha), value - old, old),
                          reward)
        state.q[s, a] = new
        state.visited[s, a] = True
        return state

    def _target(self, reward, next_value):
        return nm.fma(nm.f32(self.cfg.gamma), next_value, reward)

    def update_batch(self, state: TabularState, s, a, reward, s2, a2, live):
        """The updates of a batch of envs, one after another in env order
        (the JAX driver's scan), where ``live``; the table in place."""
        for i in torch.nonzero(live).flatten().tolist():
            state = self.update_one(state, s[i], a[i], reward[i], s2[i],
                                    a2[i])
        return state


class QLearning(_TabularBase):
    def update(self, state: TabularState, s, a, reward, s2):
        """Off-policy target ``r + gamma * max_a' Q(s', a')``
        (``qlearn.py:74-76``)."""
        return self._learn_q(state, s, a, reward,
                             self._target(reward, state.q[s2].amax()))

    def update_one(self, state, s, a, reward, s2, a2):
        return self.update(state, s, a, reward, s2)


class Sarsa(_TabularBase):
    def update(self, state: TabularState, s, a, reward, s2, a2):
        """On-policy target with the next action actually chosen
        (``sarsa.py:57-59``)."""
        return self._learn_q(state, s, a, reward,
                             self._target(reward, state.q[s2, a2]))

    def update_one(self, state, s, a, reward, s2, a2):
        return self.update(state, s, a, reward, s2, a2)
