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
from torch_parity import (assert_chain_match, chain_xla, edge_population,
                          env_state_to_torch, population_jax,
                          population_torch, random_population)

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
    args = population_torch(*random_population(JC, 4, 8))
    before = track_cp_topk_batch.launches
    got = track_cp_topk_batch(TC, *args)
    ref = trisk.track_cp_topk(TC, *args)
    assert track_cp_topk_batch.launches == before
    for g, r in zip(got[1:], ref[1:]):
        assert torch.equal(g, r)
    with pytest.raises(ValueError):
        track_cp_topk_batch(dataclasses.replace(TC, strict_quirks=True),
                            *args)
