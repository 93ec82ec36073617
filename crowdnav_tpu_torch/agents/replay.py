"""Device-resident experience replay with block-aligned ring writes (port
of ``crowdnav_tpu/agents/replay.py``).

The ring holds ``n_blocks`` blocks of ``block`` rows, ``block`` being the
env batch N, and every ``add_batch`` writes one whole block at the head.
Masked rows (the terminal -> reset transitions of auto-resetting envs) are
replaced inside the block by duplicates of kept rows, through a stable
partition: kept rows first, then row ``pos`` takes kept row
``pos % n_kept``. A batch with no kept row changes nothing: it is written
to one spare block past the ring, which ``sample`` never reads, and
``head`` and ``size`` stay; the choice is a device-side select, so the
host never waits for the mask.

Observations are stored in ``obs_dtype`` (bfloat16 halves the ring);
actions, rewards and dones are exact float32 (discrete actions, for
``act_dim=None``, int32), each field in its own tensor. (The JAX
package packs every field into one record by bitcasts, a fix for the
TPU's per-row gather cost; nothing here needs it.) ``sample`` draws
uniformly, with replacement, over the whole blocks written.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch


class Transition(NamedTuple):
    obs: torch.Tensor       # (B, obs_dim), storage dtype after sampling
    action: torch.Tensor    # (B, act_dim) float32, or (B,) int32
    reward: torch.Tensor    # (B,) float32
    next_obs: torch.Tensor  # (B, obs_dim)
    done: torch.Tensor      # (B,) float32


@dataclasses.dataclass
class ReplayState:
    """The ring's fields carry ``n_blocks + 1`` blocks: the last is the
    spare block that an all-masked batch goes to."""

    obs: torch.Tensor       # (n_blocks + 1, block, obs_dim) storage dtype
    next_obs: torch.Tensor  # (n_blocks + 1, block, obs_dim)
    action: torch.Tensor    # (n_blocks + 1, block, act_dim) float32,
                            # or (n_blocks + 1, block) int32
    reward: torch.Tensor    # (n_blocks + 1, block) float32
    done: torch.Tensor      # (n_blocks + 1, block) float32
    head: torch.Tensor      # () int64, next block to write
    size: torch.Tensor      # () int64, valid rows

    def fields(self):
        return (self.obs, self.next_obs, self.action, self.reward,
                self.done)


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class ReplayBuffer:
    """Fixed-capacity uniform replay; block size = env batch size."""

    def __init__(self, capacity: int, obs_dim: int, act_dim: int | None,
                 block: int = 1, obs_dtype="float32", device="cuda"):
        self.block = block
        self.n_blocks = max(1, -(-capacity // block))
        self.capacity = self.n_blocks * block
        self.obs_dim = obs_dim
        self.act_dim = act_dim
        self.obs_dtype = _DTYPES[obs_dtype] if isinstance(obs_dtype, str) \
            else obs_dtype
        self.device = torch.device(device)

    def row_bytes(self) -> int:
        """Bytes of one stored transition."""
        return (2 * self.obs_dim * self.obs_dtype.itemsize
                + 4 * ((self.act_dim or 1) + 2))

    def init(self) -> ReplayState:
        nb, b, dev = self.n_blocks + 1, self.block, self.device

        def z(*shape, dtype=torch.float32):
            return torch.zeros((nb, b) + shape, dtype=dtype, device=dev)

        zero = torch.zeros((), dtype=torch.int64, device=dev)
        action = z(dtype=torch.int32) if self.act_dim is None \
            else z(self.act_dim)
        return ReplayState(obs=z(self.obs_dim, dtype=self.obs_dtype),
                           next_obs=z(self.obs_dim, dtype=self.obs_dtype),
                           action=action, reward=z(), done=z(),
                           head=zero, size=zero.clone())

    def add_batch(self, state: ReplayState, tr: Transition,
                  mask: torch.Tensor | None = None) -> ReplayState:
        """Write one block of N transitions at the ring head. The ring's
        tensors are written in place; ``head`` and ``size`` are new."""
        n = tr.reward.shape[0]
        if n != self.block:
            raise ValueError(f"add_batch block size {n} != buffer block "
                             f"{self.block}")
        action = tr.action.to(torch.int32) if self.act_dim is None \
            else tr.action.float()
        rows = (tr.obs.to(self.obs_dtype), tr.next_obs.to(self.obs_dtype),
                action, tr.reward.float(), tr.done.float())
        if mask is not None:
            n_kept = mask.sum(dtype=torch.int64)
            order = torch.argsort((~mask).to(torch.int8), stable=True)
            pos = torch.arange(n, device=mask.device)
            src = torch.where(pos < n_kept, pos,
                              pos % torch.clamp(n_kept, min=1))
            perm = order[src]
            rows = tuple(r[perm] for r in rows)
            write = n_kept > 0
        else:
            write = torch.ones((), dtype=torch.bool, device=self.device)
        dest = torch.where(write, state.head, self.n_blocks).reshape(1)
        for f, r in zip(state.fields(), rows):
            f.index_copy_(0, dest, r.unsqueeze(0))
        return dataclasses.replace(
            state,
            head=torch.where(write, (state.head + 1) % self.n_blocks,
                             state.head),
            size=torch.where(write,
                             torch.clamp(state.size + n, max=self.capacity),
                             state.size))

    def sample_indices(self, state: ReplayState, batch_size: int,
                       gen: torch.Generator) -> torch.Tensor:
        """``batch_size`` uniform row indices in [0, rows written)."""
        rows = torch.clamp((state.size // self.block) * self.block, min=1)
        u = torch.rand((batch_size,), generator=gen, device=rows.device,
                       dtype=torch.float64)
        return torch.clamp((u * rows).long(), max=rows - 1)

    def sample(self, state: ReplayState, batch_size: int | None = None,
               gen: torch.Generator | None = None,
               idx: torch.Tensor | None = None) -> Transition:
        """A uniform with-replacement sample, from ``gen`` or at the
        pre-drawn flat row indices ``idx`` (the JAX package's draws in the
        tests). Observations stay in the storage dtype."""
        if idx is None:
            idx = self.sample_indices(state, batch_size, gen)
        else:
            idx = idx.to(state.reward.device).long()
        bi, ri = idx // self.block, idx % self.block
        return Transition(obs=state.obs[bi, ri], action=state.action[bi, ri],
                          reward=state.reward[bi, ri],
                          next_obs=state.next_obs[bi, ri],
                          done=state.done[bi, ri])

    def read_block(self, state: ReplayState, block_index: int) -> Transition:
        """One block of the ring (tests and checks)."""
        return Transition(*(f[block_index] for f in (
            state.obs, state.action, state.reward, state.next_obs,
            state.done)))
