"""The port's perceived-risk pipeline (``crowdnav_tpu_torch/ops/risk.py``)
against ``crowdnav_tpu/ops/risk.py``:

- ``segment_scans`` on scans from real rollouts and on crafted scenes (a
  run across beam 0 that the wrap merge joins, an empty ring), bit-equal
  to the JAX segmentation as the env step runs it: fused with the sensing
  in one jitted program, where XLA computes the differences of rounded
  points with a fused multiply-add;
- the plain tracker -> CP -> top-K chain (the plain version of the CUDA
  kernel) against the XLA chain and against the Pallas kernel in interpret
  mode, on random and edge-case populations from numpy seeds: bool
  outputs exact, floats within 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crowdnav_tpu.envs import CrowdEnv, make_config
from crowdnav_tpu.envs import crowd_env as jce
from crowdnav_tpu.envs import world as jworld
from crowdnav_tpu.ops import risk as jrisk
from crowdnav_tpu.ops.risk_pallas import track_cp_topk_batch as pallas_chain
from crowdnav_tpu_torch.envs import config as tcfg
from crowdnav_tpu_torch.envs import crowd_env as tce
from crowdnav_tpu_torch.ops import risk as trisk
from crowdnav_tpu_torch.ops.risk_kernel import track_cp_topk_batch
from torch_parity import (CHAIN_FIELDS, assert_chain_match, chain_leaves,
                          chain_xla, edge_population, env_state_to_torch,
                          population_jax, population_torch,
                          random_population)

torch.set_num_threads(1)
JC = make_config("crowd_dense", "crowd", jitter=1.0)
TC = tcfg.make_config("crowd_dense", "crowd", jitter=1.0)


def _segments_jax(states):
    f = jax.jit(jax.vmap(
        lambda st: jrisk.segment_scans(JC, *jce._sense(JC, st))))
    return f(states)


def _assert_segments_equal(ts, jstates, msg=""):
    ref = _segments_jax(jstates)
    scans, points = tce._sense(TC, env_state_to_torch(jstates))
    got = trisk.segment_scans(TC, scans, points)
    for name in ref._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=f"{msg} {name}")
    return got


def test_segment_scans_matches_jax_on_rollouts():
    env = CrowdEnv(JC)
    n = 32
    js, _ = jax.jit(jax.vmap(env.reset))(
        jax.random.split(jax.random.PRNGKey(2), n))
    step = jax.jit(jax.vmap(env.step))
    rng = np.random.default_rng(3)
    seen = 0
    for t in range(8):
        act = rng.uniform([0.0, -2.0], [0.22, 2.0], (n, 2)).astype(
            np.float32)
        js = step(js, jnp.asarray(act)).state
        got = _assert_segments_equal(None, js, f"step {t}")
        seen += int(got.is_obstacle.sum())
    assert seen > 0


def test_segment_scans_wrap_merge_and_empty():
    """Env 0: a pedestrian straight ahead, so its run crosses beam 0 and the
    wrap merge joins the first and last runs; env 1: nothing in range;
    env 2: a wall straight ahead; env 3: the spawn."""
    keys = jax.random.split(jax.random.PRNGKey(0), 4)
    js = jax.vmap(lambda k: jworld.init_state(JC, k))(keys)
    far = jnp.full((JC.n_peds, 2), 1e3, jnp.float32)
    ped_ahead = far.at[0].set(jnp.array([0.3, 0.0]))
    js = js.replace(
        pos=js.pos.at[0].set(0.0).at[1].set(0.0).at[2].set(
            jnp.array([1.2, 0.0])),
        yaw=js.yaw.at[0].set(0.0).at[1].set(0.0).at[2].set(0.0),
        ped_pos=js.ped_pos.at[0].set(ped_ahead).at[1].set(far).at[2].set(
            far))
    got = _assert_segments_equal(None, js)
    valid = got.valid.numpy()
    assert valid[0].sum() == 1 and got.count.numpy()[0, 0] > 0
    assert valid[1].sum() == 0
    assert valid[2].any()


def _run_chains(pop):
    jargs = population_jax(*pop)
    targs = population_torch(*pop)
    ref_xla = chain_xla(JC, *jargs)
    ref_pallas = pallas_chain(JC, *jargs, interpret=True)
    got = track_cp_topk_batch(TC, *targs)
    return got, ref_xla, ref_pallas


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chain_matches_xla_and_pallas_randomized(seed):
    got, ref_xla, ref_pallas = _run_chains(random_population(JC, seed, 96))
    assert_chain_match(got, ref_xla, f"xla seed={seed}")
    assert_chain_match(got, ref_pallas, f"pallas seed={seed}")


def test_chain_matches_xla_and_pallas_edge_cases():
    got, ref_xla, ref_pallas = _run_chains(edge_population(JC))
    assert_chain_match(got, ref_xla, "xla edges")
    assert_chain_match(got, ref_pallas, "pallas edges")
    trk, top_cp, top_pv, cp_max, _ = got
    assert trk.valid[5].all()                 # full table
    assert trk.valid[2].sum() == 10           # mass insertion
    assert (top_cp[4] == top_cp[4, 0]).all()  # CP ties


def test_wrapper_runs_the_plain_chain_on_cpu_and_rejects_strict_quirks():
    """On CPU tensors the wrapper runs the plain chain of the config's
    form and launches nothing; the Pallas form implements the default
    quirks only, so ``strict_quirks`` with ``risk_backend="pallas"`` is
    refused, as in the JAX package."""
    args = population_torch(*random_population(JC, 4, 8))
    before = track_cp_topk_batch.launches
    got = track_cp_topk_batch(TC, *args)
    ref = trisk.track_cp_topk(TC, *args)
    assert track_cp_topk_batch.launches == before
    for g, r in zip(got[1:], ref[1:]):
        assert torch.equal(g, r)
    with pytest.raises(ValueError):
        track_cp_topk_batch(dataclasses.replace(
            TC, strict_quirks=True, risk_backend="pallas"), *args)


# the Pallas form and the strict form, bit for bit on every output

JC_STRICT = dataclasses.replace(JC, strict_quirks=True)
TC_STRICT = dataclasses.replace(TC, strict_quirks=True)
TC_PALLAS = dataclasses.replace(TC, risk_backend="pallas")


def moving_population(seed, n):
    """Random populations (``random_population``) with segment centres
    off the 1/8 grid and every track near a segment, so that most tracks
    match and move by a non-trivial distance."""
    rng = np.random.default_rng(1000 + seed)
    segs, tracks, pos, prev, cc = random_population(JC, seed, n)
    S, T = JC.max_segments, JC.max_tracks
    segs["center_pos"] = rng.uniform(-1.2, 1.2, (n, S, 2)).astype(np.float32)
    near = np.take_along_axis(segs["center_pos"],
                              rng.integers(0, S, (n, T))[..., None], 1)
    tpos = (near + rng.normal(size=(n, T, 2)) * 0.02).astype(np.float32)
    tracks["pos"] = tpos
    tracks["prev_pos"] = (tpos + rng.normal(size=(n, T, 2)) * 0.03).astype(
        np.float32)
    return segs, tracks, pos, prev, cc


def _assert_chain_equal(got, ref, msg):
    for name, g, r in zip(CHAIN_FIELDS, chain_leaves(got), chain_leaves(ref)):
        np.testing.assert_array_equal(g, r, err_msg=f"{msg} {name}")


POPULATIONS = [("random", lambda: random_population(JC, 5, 128)),
               ("moving0", lambda: moving_population(0, 256)),
               ("moving1", lambda: moving_population(1, 256)),
               ("edges", lambda: edge_population(JC))]


@pytest.mark.parametrize("name,make", POPULATIONS,
                         ids=[p[0] for p in POPULATIONS])
def test_pallas_form_matches_pallas_kernel(name, make):
    """The kernel's Pallas form (its plain version, which the wrapper runs
    on CPU tensors) against ``risk_pallas.track_cp_topk_batch`` as the
    JAX package's CPU tests run it (interpret mode, jitted)."""
    pop = make()
    ref = pallas_chain(JC, *population_jax(*pop), interpret=None)
    got = track_cp_topk_batch(TC_PALLAS, *population_torch(*pop))
    _assert_chain_equal(got, ref, f"pallas {name}")


@pytest.mark.parametrize("name,make", POPULATIONS,
                         ids=[p[0] for p in POPULATIONS])
def test_strict_form_matches_xla_chain_strict(name, make):
    """The kernel's strict form against the jitted, vmapped XLA chain under
    ``strict_quirks=True``: the first track's closing speed and the
    reference's ``sorted(desc)[-K:]``; the populations hold more than K
    valid tracks, so the lowest-K selection is exercised. Tracks, the
    selection and the top-K poses (rounded into the observation) bit for
    bit; the CPs (``top_cp``, ``cp_max``, ``ego_cp``) within 1e-6: the
    chain jitted alone computes the robot's speed without the fused
    multiply-add that the jitted step uses (and the port follows), which
    ``test_torch_env.py`` holds bit for bit in the step."""
    pop = make()
    ref = chain_xla(JC_STRICT, *population_jax(*pop))
    got = track_cp_topk_batch(TC_STRICT, *population_torch(*pop))
    for f, g, r in zip(CHAIN_FIELDS, chain_leaves(got), chain_leaves(ref)):
        if f in ("top_cp", "cp_max", "ego_cp"):
            np.testing.assert_allclose(g, r, rtol=1e-6, atol=1e-6,
                                       err_msg=f"strict {name} {f}")
        else:
            np.testing.assert_array_equal(g, r, err_msg=f"strict {name} {f}")
    assert (got[0].valid.sum(dim=1) > JC.k_obstacles).any()


def test_strict_and_pallas_forms_differ_from_the_default():
    """Each form computes something of its own on these inputs (a form
    silently running another's arithmetic would pass the tests above only
    where they agree)."""
    pop = moving_population(2, 256)
    base = chain_leaves(track_cp_topk_batch(TC, *population_torch(*pop)))
    for cfg in (TC_STRICT, TC_PALLAS):
        other = chain_leaves(track_cp_topk_batch(cfg, *population_torch(*pop)))
        assert any((a != b).any() for a, b in zip(base, other))


def test_segment_scans_strict_matches_jax_on_rollouts():
    """``segment_scans`` under ``strict_quirks`` (the rounded-IOU
    association and wrap merge) against the JAX segmentation as the
    strict step runs it, on the scans of a strict rollout."""
    env = CrowdEnv(JC_STRICT)
    n = 32
    js, _ = jax.jit(jax.vmap(env.reset))(
        jax.random.split(jax.random.PRNGKey(12), n))
    step = jax.jit(jax.vmap(env.step))
    seg = jax.jit(jax.vmap(
        lambda st: jrisk.segment_scans(JC_STRICT, *jce._sense(JC_STRICT, st))))
    rng = np.random.default_rng(13)
    seen = 0
    for t in range(8):
        act = rng.uniform([0.0, -2.0], [0.22, 2.0], (n, 2)).astype(
            np.float32)
        js = step(js, jnp.asarray(act)).state
        ref = seg(js)
        scans, points = tce._sense(TC_STRICT, env_state_to_torch(js))
        got = trisk.segment_scans(TC_STRICT, scans, points)
        for f in ref._fields:
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(ref, f)),
                                          err_msg=f"step {t} {f}")
        seen += int(got.is_obstacle.sum())
    assert seen > 0


def test_rounded_association_is_the_jax_predicate():
    """``geom.boxes_associated(rounded=True)`` against the JAX predicate
    on offsets around the sliver-overlap threshold."""
    from crowdnav_tpu.ops import geom as jgeom
    from crowdnav_tpu_torch.ops import geom as tgeom
    rng = np.random.default_rng(4)
    half = 0.0105
    a = rng.uniform(-1, 1, (4096, 2)).astype(np.float32)
    b = (a + rng.uniform(-4 * half, 4 * half, (4096, 2))).astype(np.float32)
    ref = jax.jit(lambda x, y: jgeom.boxes_associated(x, y, half,
                                                      rounded=True))(a, b)
    got = tgeom.boxes_associated(torch.from_numpy(a), torch.from_numpy(b),
                                 half, rounded=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert 0 < int(got.sum()) < 4096


# social regions and the whole perceive pipeline

def test_social_region_matches_jax():
    """``geom.social_region`` against the JAX function, per point, on
    points around the robot (both parallelograms, both range bands)."""
    from crowdnav_tpu.ops import geom as jgeom
    from crowdnav_tpu_torch.ops import geom as tgeom
    rng = np.random.default_rng(8)
    n, m = 64, 32
    robot = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    yaw = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    pts = (robot[:, None, :] + rng.uniform(-0.7, 0.7, (n, m, 2))).astype(
        np.float32)
    scans = rng.uniform(0.05, 0.65, (n, m)).astype(np.float32)
    ref = jax.jit(jax.vmap(jgeom.social_region))(robot, yaw, pts, scans)
    got = tgeom.social_region(torch.from_numpy(robot)[:, None, :],
                              torch.from_numpy(yaw)[:, None],
                              torch.from_numpy(pts), torch.from_numpy(scans))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert len(np.unique(got.numpy())) == 5


@pytest.mark.parametrize("compute_cp", [True, False])
def test_perceive_matches_jax_with_regions(compute_cp):
    """``risk.perceive`` with the robot's yaw (``compute_regions``)
    against the JAX ``risk.perceive`` vmapped over the scans of a rollout:
    segments, tracks, top-K, flags and each segment's region code."""
    cfg_j = dataclasses.replace(JC, compute_regions=True)
    cfg_t = dataclasses.replace(TC, compute_regions=True)
    env = CrowdEnv(cfg_j)
    n = 24
    js, _ = jax.jit(jax.vmap(env.reset))(
        jax.random.split(jax.random.PRNGKey(21), n))
    step = jax.jit(jax.vmap(env.step))
    rng = np.random.default_rng(22)
    for _ in range(4):
        act = rng.uniform([0.0, -2.0], [0.22, 2.0], (n, 2)).astype(
            np.float32)
        js = step(js, jnp.asarray(act)).state
    cc = jnp.asarray(np.full(n, compute_cp))

    def one(st, c):
        scans, points = jce._sense(cfg_j, st)
        return jrisk.perceive(cfg_j, scans, points, st.tracks, st.pos,
                              st.prev_pos, compute_cp=c, yaw=st.yaw)
    ref = jax.jit(jax.vmap(one))(js, cc)
    ts = env_state_to_torch(js)
    scans, points = tce._sense(cfg_t, ts)
    got = trisk.perceive(cfg_t, scans, points, ts.tracks, ts.pos,
                         ts.prev_pos, torch.from_numpy(np.asarray(cc)),
                         yaw=ts.yaw)
    for f in ("top_k_pose_vel", "top_k_cp", "cp_max", "ego_cp",
              "obstacle_seen", "ego_violation", "segment_regions"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)),
                                      err_msg=f)
    for f in ref.segments._fields:
        np.testing.assert_array_equal(getattr(got.segments, f).numpy(),
                                      np.asarray(getattr(ref.segments, f)),
                                      err_msg=f)
    for f in ("valid", "pos", "prev_pos", "has_prev", "dist", "speed",
              "vel"):
        np.testing.assert_array_equal(getattr(got.tracks, f).numpy(),
                                      np.asarray(getattr(ref.tracks, f)),
                                      err_msg=f)
    assert (got.segment_regions.numpy() > 0).any()
