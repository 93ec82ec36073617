"""The sharded actor-learner over ``torch.distributed`` (port of
``crowdnav_tpu/parallel/mesh.py``).

The env batch is the scaling axis, laid out over the ranks of a 1-D
``env`` mesh, one device a rank. Every rank builds the whole initial batch
and the reset bank from the seed and keeps its rows (rank r the rows
``[r n / world, (r + 1) n / world)``, so that each row starts as it does
in the unsharded run), steps its own envs and owns the replay ring of
their transitions: as many blocks as the unsharded ring, each of the local
env count, so that the ranks' rings together hold the unsharded ring's
rows, as the JAX package's ring sharded over its block axis. The learner
is data parallel, as the JAX package's ``shard_map`` learner: each update
samples ``batch_size / world`` rows of the rank's own ring, computes the
local mean gradients, and the agent's ``grad_reduce`` sums them over the ranks
(``all_reduce``) and divides by the rank count, so that every rank takes
the identical optimizer step and the agent state stays replicated. The
replay gate reads the ranks' summed row count and the episode statistics
are summed over the ranks, so that every rank opens the gate and renders
the collapse verdict at the same step.

Random draws: the initial batch and the bank come from the seed's stream
on every rank; after it, rank 0 keeps that stream and every other rank
draws from a stream of its own (the JAX package folds the device index
into each update's key). A caller can pass each step's draws
(``runtime.StepDraws``) instead, as the tests do.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from crowdnav_tpu_torch.parallel.distributed import (distribute,
                                                     shard_rows, world)
from crowdnav_tpu_torch.parallel.runtime import (Trainer, TrainerConfig,
                                                 greedy_env_mask)

_GOLDEN = 0x9E3779B97F4A7C15


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank ``rank``'s own stream (rank 0: ``seed``)."""
    return (seed + rank * _GOLDEN) & 0xFFFF_FFFF_FFFF_FFFF


@dataclasses.dataclass
class Mesh:
    """The ``env`` axis: this process's ``rank`` of ``size`` ranks of the
    default process group (one rank and no group outside a group)."""

    size: int
    rank: int

    @property
    def joined(self) -> bool:
        return dist.is_initialized()

    def sum_(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the ranks, in place."""
        if self.joined:
            dist.all_reduce(t, op=dist.ReduceOp.SUM)
        return t

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' mean of ``t`` (a fresh tensor, summed in place):
        the sum over the ranks divided by their count, as the JAX
        learner's ``gnorm`` and ``pmean``."""
        if not self.joined:
            return t
        return self.sum_(t) / self.size


def make_mesh(n_devices: int | None = None) -> Mesh:
    """The 1-D ``env`` mesh of the process group's ranks (one device a
    rank); outside a group, the one-rank mesh. ``n_devices``, when given,
    must be the rank count."""
    rank, size = world()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"make_mesh({n_devices}): the process group has "
                         f"{size} ranks (one device a rank; start one "
                         f"process per device)")
    return Mesh(size=size, rank=rank)


class ShardedTrainer(Trainer):
    """Trainer of this rank's rows of a batch of ``tcfg.n_envs`` envs,
    with the data-parallel learner (module docstring)."""

    def __init__(self, env, agent, tcfg: TrainerConfig, mesh: Mesh,
                 discrete: bool = False):
        ndev = mesh.size
        if tcfg.n_envs % ndev != 0:
            raise ValueError(f"n_envs={tcfg.n_envs} must divide the env "
                             f"mesh axis ({ndev})")
        if tcfg.learning and agent.cfg.batch_size % ndev != 0:
            raise ValueError(f"batch_size={agent.cfg.batch_size} must "
                             f"divide the env mesh axis ({ndev}) for the "
                             f"DP-sharded learner")
        self.mesh = mesh
        self.n_global = tcfg.n_envs
        super().__init__(env, agent, dataclasses.replace(
            tcfg, n_envs=tcfg.n_envs // ndev), discrete=discrete)
        self.rows = shard_rows(tcfg.n_envs, mesh.rank, ndev)
        self.greedy_mask = greedy_env_mask(
            agent, tcfg.n_envs, device=self.device)[self.rows]
        if hasattr(agent, "env_rows"):
            agent.env_rows = (tcfg.n_envs, self.rows.start)
        if tcfg.learning:
            self.batch_size = agent.cfg.batch_size // ndev
            self.update_kw = {"grad_reduce": mesh.mean}

    def _replay_capacity(self) -> int:
        # the unsharded ring's block count, each block this rank's envs:
        # the ranks' rings together hold the unsharded ring's rows (the
        # JAX package shards its one ring over the block axis)
        n_blocks = max(1, -(-self.agent.cfg.buffer_size // self.n_global))
        return n_blocks * self.tcfg.n_envs

    def _reset_envs(self, gen):
        state = self.env.reset(self.n_global, gen)
        return distribute(state, self.n_global, self.mesh.rank,
                          self.mesh.size)

    def init(self, seed: int):
        state = super().init(seed)
        per_env = [f for f, kind, _ in getattr(self.agent, "STATE_FIELDS",
                                               ()) if kind == "per_env"]
        if state.agent_state is not None and per_env:
            # DDPG's OU carry: this rank's envs' rows
            state = dataclasses.replace(
                state, agent_state=dataclasses.replace(
                    state.agent_state,
                    **{f: getattr(state.agent_state, f)[self.rows].clone()
                       for f in per_env}))
        if self.mesh.rank:
            state.gen.manual_seed(rank_seed(seed, self.mesh.rank))
        return state

    def make_jitted(self):
        """Not ported yet: the ranks all-reduce through
        ``torch.distributed`` on the host (gloo), which a CUDA graph cannot
        capture; the sharded chunk's capture over NCCL is the next slice of
        its kind (``ROADMAP.md`` item 9b). ``rollout_chunk`` runs it."""
        raise NotImplementedError(
            "ShardedTrainer.make_jitted: the sharded learner's all-reduce "
            "is not capturable yet (capture over NCCL is queued); use "
            "rollout_chunk")

    def _rows_written(self, replay) -> int:
        return int(self.mesh.sum_(replay.size.clone()).item())

    def _host_stats(self, values: list) -> list:
        packed = torch.stack([v.to(torch.float64) for v in values])
        return self.mesh.sum_(packed).tolist()
