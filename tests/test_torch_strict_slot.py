"""The strict top-K slot of the tracker kernel (``kernels/csrc/
track_cp_topk.cu``, phase 4) in closed form, written out here in PyTorch
as the kernel computes it, against the port's plain strict form
(``ops/risk.select_top_k(..., form="strict")`` and the whole chain
``ops/risk.track_cp_topk(..., form="strict")``) and the JAX package's
``select_top_k`` under ``strict_quirks``.

A track's score is its CP (``-CP`` when more than K tracks are valid,
``-inf`` when invalid); its rank is the number of higher scores plus the
lower-slot equal ones, its tie group the tracks of an equal score (``-0``
equal to ``+0``). With at most K valid tracks the slot is the rank; with
more, the K picked are in ascending CP order and the slot is their place
in descending CP order, ties in rank order:
``(K - r0 - min(g, K - r0)) + (rank - r0)``, ``r0`` the first rank of the
group and ``g`` its size."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crowdnav_tpu.envs.config import make_config as jax_config
from crowdnav_tpu.envs.world import TrackState as JTrackState
from crowdnav_tpu.ops import risk as jrisk
from crowdnav_tpu_torch.envs.config import make_config
from crowdnav_tpu_torch.envs.world import TrackState
from crowdnav_tpu_torch.ops import risk
from torch_parity import edge_population, population_torch, \
    random_population

torch.set_num_threads(1)
INF = float("inf")
SHAPES = {"t24_k8": {}, "t24_k1": dict(k_obstacles=1),
          "t20_k5": dict(max_tracks=20, k_obstacles=5)}


def _strict(overrides, jax_side=False):
    if jax_side:
        return dataclasses.replace(jax_config("crowd_dense", "crowd"),
                                   strict_quirks=True, **overrides)
    return dataclasses.replace(make_config("crowd_dense", "crowd"),
                               strict_quirks=True, **overrides)


def closed_form_slots(valid, cp, K):
    """``(rank, slot)`` (N, T) of every track, by the kernel's operations:
    the rank from the score comparisons and the tie group (equal bits of
    ``score + 0``), the slot in closed form."""
    T = valid.shape[1]
    over = valid.sum(dim=1, keepdim=True) > K
    score = torch.where(valid, torch.where(over, -cp, cp), -INF)
    bits = (score + 0.0).view(torch.int32)
    ties = bits[:, :, None] == bits[:, None, :]          # [env, lane, u]
    lower = torch.arange(T)[None, :] < torch.arange(T)[:, None]
    before = (ties & lower).sum(dim=2)
    rank = (score[:, None, :] > score[:, :, None]).sum(dim=2) + before
    left = K - (rank - before)
    slot = left - torch.minimum(ties.sum(dim=2), left) + before
    return rank, torch.where(over, slot, rank)


def closed_form_top_k(K, tracks, cp, live, robot_pos):
    """``(top_cp, top_pose_vel)`` as the kernel stores them: each track
    of rank < K writes its slot."""
    n, T = cp.shape
    rank, slot = closed_form_slots(tracks.valid, cp, K)
    top_cp = torch.full((n, K), float("nan"))
    top_pv = torch.full((n, K, 4), float("nan"))
    for e in range(n):
        for t in range(T):
            if rank[e, t] >= K:
                continue
            s = int(slot[e, t])
            assert torch.isnan(top_cp[e, s]), "two tracks in one slot"
            picked = bool(live[e] & tracks.valid[e, t])
            top_cp[e, s] = cp[e, t] if picked else 0.0
            top_pv[e, s] = torch.cat([tracks.pos[e, t], tracks.vel[e, t]]) \
                if picked else torch.cat([robot_pos[e], torch.zeros(2)])
    assert not torch.isnan(top_cp).any(), "a slot left empty"
    return top_cp, top_pv


def _tie_population(T, K, seed, n=256):
    """Valid masks with fewer, exactly and more than K tracks, CPs from a
    few values (ties, groups across rank K, all equal, +0 and -0), a
    few envs not live; distinct track poses so that any misplaced slot
    shows."""
    rng = np.random.default_rng(seed)
    n_valid = rng.integers(0, T + 1, n)
    n_valid[:4] = (K, K + 1, T, min(K + 3, T))
    valid = np.zeros((n, T), bool)
    for e, k in enumerate(n_valid):
        valid[e, rng.permutation(T)[:k]] = True
    levels = np.array([0.0, -0.0, 0.125, 0.25, 0.5, 1.0], np.float32)
    cp = levels[rng.integers(0, len(levels), (n, T))]
    cp[4] = 0.25                                  # all equal
    cp[5] = -0.0
    cp[6, ::2] = 0.0                              # +0 and -0 mixed
    cp[7] = np.where(np.arange(T) < K + 2, 0.25, 0.5)   # a group across K
    pos = rng.normal(size=(n, T, 2)).astype(np.float32)
    vel = rng.normal(size=(n, T, 2)).astype(np.float32)
    zeros = np.zeros((n, T), np.float32)
    tracks = dict(valid=valid, pos=pos, prev_pos=pos, has_prev=valid,
                  dist=zeros, speed=zeros, vel=vel)
    live = np.arange(n) % 9 != 3
    robot = rng.normal(size=(n, 2)).astype(np.float32)
    return tracks, cp, live, robot


def _signed_zeros_mixed(valid, cp):
    """Envs whose valid CPs hold both +0 and -0."""
    zero = valid & (cp == 0)
    neg = np.signbit(cp)
    return (zero & neg).any(axis=1) & (zero & ~neg).any(axis=1)


@pytest.mark.parametrize("shape", SHAPES)
def test_closed_form_is_the_plain_strict_order(shape):
    cfg = _strict(SHAPES[shape])
    T, K = cfg.max_tracks, cfg.k_obstacles
    tracks, cp, live, robot = _tie_population(T, K, seed=T * 10 + K)
    tt = TrackState(**{k: torch.from_numpy(v) for k, v in tracks.items()})
    args = (tt, torch.from_numpy(cp), torch.from_numpy(live),
            torch.from_numpy(robot))
    ref = risk.select_top_k(cfg, *args, form="strict")
    got = closed_form_top_k(K, *args)
    for g, r in zip(got, ref):
        assert torch.equal(g.view(torch.int32), r.view(torch.int32))
    n_valid = tracks["valid"].sum(axis=1)
    assert (n_valid <= K).any() and (n_valid > K).any()


@pytest.mark.parametrize("shape", SHAPES)
def test_closed_form_is_the_jax_strict_order(shape):
    """The same populations against the JAX package's ``select_top_k``,
    envs with +0 and -0 among their valid CPs left out: ``lax.top_k``
    orders +0 above -0 where the port (``torch.sort``, the kernel's bit
    match of ``score + 0``) takes them as equal. The chain never makes a
    -0 CP (each CP is a multiply-add onto +0 or a select of +0)."""
    cfg, jcfg = _strict(SHAPES[shape]), _strict(SHAPES[shape], True)
    T, K = cfg.max_tracks, cfg.k_obstacles
    tracks, cp, live, robot = _tie_population(T, K, seed=T * 10 + K + 1)
    keep = ~_signed_zeros_mixed(tracks["valid"], cp)
    tracks = {k: v[keep] for k, v in tracks.items()}
    cp, live, robot = cp[keep], live[keep], robot[keep]
    ref = jax.jit(jax.vmap(lambda tr, c, lv, p: jrisk.select_top_k(
        jcfg, tr, c, lv, p)))(
            JTrackState(**{k: jnp.asarray(v) for k, v in tracks.items()}),
            jnp.asarray(cp), jnp.asarray(live), jnp.asarray(robot))
    tt = TrackState(**{k: torch.from_numpy(v) for k, v in tracks.items()})
    got = closed_form_top_k(K, tt, torch.from_numpy(cp),
                            torch.from_numpy(live), torch.from_numpy(robot))
    # JAX's one-hot selection returns +0 for a -0 CP
    np.testing.assert_array_equal(got[0].numpy() + 0.0, np.asarray(ref[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("population", ["random", "edges"])
def test_closed_form_is_the_strict_chain_order(population, shape):
    """Through the whole plain strict chain: the closed form on the
    chain's own updated tracks and CPs gives its ``top_cp`` and
    ``top_pose_vel``."""
    cfg = _strict(SHAPES[shape])
    pop = random_population(cfg, 7, 300) if population == "random" \
        else edge_population(cfg)
    segs, tracks, pos, prev, cc = population_torch(*pop)
    new = risk.update_tracks(cfg, tracks, segs, "strict")
    cp, _ = risk.collision_probabilities(cfg, new, pos, prev, "strict")
    live = cc & new.valid.any(dim=1)
    _, top_cp, top_pv, _, _ = risk.track_cp_topk(cfg, segs, tracks, pos,
                                                 prev, cc, form="strict")
    got = closed_form_top_k(cfg.k_obstacles, new, cp, live, pos)
    assert torch.equal(got[0].view(torch.int32), top_cp.view(torch.int32))
    assert torch.equal(got[1].view(torch.int32), top_pv.view(torch.int32))
