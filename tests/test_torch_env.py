"""The port's batched env step (``crowdnav_tpu_torch/envs/crowd_env.py``)
against ``CrowdEnv.step_batch`` of the JAX package with the Pallas risk
kernel (interpret mode on CPU), in the ``crowd_dense`` geometry with K=8,
over a multi-step rollout from the same states: observations bit-equal,
rewards and dones equal, tracks equal (bool exact, floats within 1e-6:
the Pallas kernel rounds the track speed and the CP its own way). The
RANDOM crowd's velocity draws and the reset template come from JAX."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crowdnav_tpu.envs import CrowdEnv, make_config
from crowdnav_tpu_torch.envs import config as tcfg
from crowdnav_tpu_torch.envs.crowd_env import CrowdEnv as TCrowdEnv
from test_torch_world import jax_crowd_draws, jax_reset_draws
from torch_parity import (assert_env_state_equal, env_state_to_torch,
                          jax_noise_draws)

torch.set_num_threads(1)
N, STEPS = 16, 12


def _port_env(jenv, tc):
    env = TCrowdEnv(tc, device="cpu")
    st, obs = jenv._template
    env.template = (env_state_to_torch(jax.tree.map(lambda a: a[None], st)),
                    torch.from_numpy(np.array(obs))[None])
    return env


@pytest.fixture(scope="module")
def envs():
    kw = dict(jitter=1.0, max_steps=8)
    jc = make_config("crowd_dense", "crowd", risk_backend="pallas", **kw)
    tc = tcfg.make_config("crowd_dense", "crowd", **kw)
    jenv = CrowdEnv(jc)
    return jc, jenv, _port_env(jenv, tc)


def test_reset_matches_jax(envs):
    jc, jenv, tenv = envs
    keys = jax.random.split(jax.random.PRNGKey(11), N)
    js, jobs = jax.jit(jax.vmap(jenv.reset))(keys)
    ts, tobs = tenv.reset(N, draws=jax_reset_draws(jc, keys))
    np.testing.assert_array_equal(tobs.numpy(), np.asarray(jobs))
    assert_env_state_equal(ts, js)


def test_step_batch_matches_jax_rollout(envs):
    jc, jenv, tenv = envs
    keys = jax.random.split(jax.random.PRNGKey(0), N)
    js, _ = jax.jit(jax.vmap(jenv.reset))(keys)
    step = jax.jit(jenv.step_batch)
    rng = np.random.default_rng(1)
    resets = 0
    for t in range(STEPS):
        act = rng.uniform([0.0, -2.0], [0.22, 2.0], (N, 2)).astype(
            np.float32)
        got = tenv.step_batch(env_state_to_torch(js), torch.from_numpy(act),
                              vel_draw=jax_crowd_draws(jc, js))
        resets += int(np.asarray(js.done).sum())
        out = step(js, jnp.asarray(act))
        msg = f"step {t}"
        np.testing.assert_array_equal(got.obs.numpy(), np.asarray(out.obs),
                                      err_msg=f"{msg} obs")
        np.testing.assert_array_equal(got.reward.numpy(),
                                      np.asarray(out.reward),
                                      err_msg=f"{msg} reward")
        np.testing.assert_array_equal(got.done.numpy(), np.asarray(out.done),
                                      err_msg=f"{msg} done")
        for f in ("valid", "pos", "prev_pos", "has_prev", "dist", "speed",
                  "vel"):
            g = getattr(got.state.tracks, f).numpy()
            r = np.asarray(getattr(out.state.tracks, f))
            if r.dtype == bool:
                np.testing.assert_array_equal(g, r, err_msg=f"{msg} {f}")
            else:
                np.testing.assert_allclose(g, r, rtol=1e-6, atol=1e-6,
                                           err_msg=f"{msg} {f}")
        for f in ("pos", "yaw", "waypoint", "prev_distance", "prev_heading",
                  "step", "done", "episode_success", "obstacle_present_steps",
                  "ego_violations", "wp_bonus_count"):
            np.testing.assert_array_equal(
                getattr(got.state, f).numpy(),
                np.asarray(getattr(out.state, f)), err_msg=f"{msg} {f}")
        js = out.state
    assert resets > 0, "the rollout never exercised the auto-reset"


@pytest.mark.parametrize("ablation", ["no_cp", "basic", "basic_grp"])
def test_state_variants_match_jax(ablation):
    """The ablation arms' observations (the ``_finish_observe`` variants)
    over a short rollout of the JAX package's vmapped step."""
    kw = dict(jitter=1.0, max_steps=6, ablation=ablation)
    jc = make_config("crowd_dense", "crowd", **kw)
    tc = tcfg.make_config("crowd_dense", "crowd", **kw)
    jenv = CrowdEnv(jc)
    tenv = _port_env(jenv, tc)
    n = 8
    js, _ = jax.jit(jax.vmap(jenv.reset))(
        jax.random.split(jax.random.PRNGKey(4), n))
    step = jax.jit(jax.vmap(jenv.step))
    rng = np.random.default_rng(2)
    for t in range(8):
        act = rng.uniform([0.0, -2.0], [0.22, 2.0], (n, 2)).astype(
            np.float32)
        got = tenv.step_batch(env_state_to_torch(js), torch.from_numpy(act),
                              vel_draw=jax_crowd_draws(jc, js))
        out = step(js, jnp.asarray(act))
        assert got.obs.shape == (n, jc.state_dim_risk)
        np.testing.assert_array_equal(got.obs.numpy(), np.asarray(out.obs),
                                      err_msg=f"step {t} obs")
        np.testing.assert_array_equal(got.reward.numpy(),
                                      np.asarray(out.reward))
        js = out.state


@pytest.mark.parametrize("overrides", [
    dict(risk_backend="pallas"), dict(lidar_backend="pallas"),
    dict(risk_backend="pallas", lidar_backend="pallas"),
    dict(strict_quirks=True), dict(actuation_noise=0.05),
    dict(dt_jitter=0.15), dict(lidar_noise=0.005),
    dict(actuation_noise=0.05, dt_jitter=0.15, lidar_noise=0.005,
         risk_backend="pallas", lidar_backend="pallas")],
    ids=["risk_pallas", "lidar_pallas", "both_pallas", "strict",
         "actuation_noise", "dt_jitter", "lidar_noise", "all_knobs"])
def test_step_batch_matches_jax_under_backends_and_knobs(overrides):
    """``CrowdEnv.step_batch`` under each backend, the strict quirks and
    each noise knob, against the jitted JAX ``step_batch`` of the same
    config over a rollout with resets: observations, rewards, dones and
    every state field bit-equal (the noise knobs' draws passed in from
    JAX's keys)."""
    kw = dict(jitter=1.0, max_steps=8, **overrides)
    jc = make_config("crowd_dense", "crowd", **kw)
    tc = tcfg.make_config("crowd_dense", "crowd", **kw)
    jenv = CrowdEnv(jc)
    tenv = _port_env(jenv, tc)
    n = 12
    js, _ = jax.jit(jax.vmap(jenv.reset))(
        jax.random.split(jax.random.PRNGKey(7), n))
    step = jax.jit(jenv.step_batch)
    rng = np.random.default_rng(3)
    resets = 0
    for t in range(11):
        act = rng.uniform([0.0, -2.0], [0.22, 2.0], (n, 2)).astype(
            np.float32)
        got = tenv.step_batch(env_state_to_torch(js), torch.from_numpy(act),
                              vel_draw=jax_crowd_draws(jc, js),
                              noise=jax_noise_draws(jc, js))
        resets += int(np.asarray(js.done).sum())
        out = step(js, jnp.asarray(act))
        msg = f"step {t}"
        np.testing.assert_array_equal(got.obs.numpy(), np.asarray(out.obs),
                                      err_msg=f"{msg} obs")
        np.testing.assert_array_equal(got.reward.numpy(),
                                      np.asarray(out.reward),
                                      err_msg=f"{msg} reward")
        np.testing.assert_array_equal(got.done.numpy(), np.asarray(out.done),
                                      err_msg=f"{msg} done")
        assert_env_state_equal(got.state, out.state, msg)
        js = out.state
    assert resets > 0, "the rollout never exercised the auto-reset"


def test_reset_with_lidar_noise_matches_jax():
    """``CrowdEnv.reset`` under ``lidar_noise``: the reset observation's
    scans carry the noise drawn from the fresh state's key (JAX's draws
    passed in), bit for bit."""
    from test_torch_simple_env import jax_reset_lidar_noise
    kw = dict(jitter=1.0, max_steps=8, lidar_noise=0.005,
              risk_backend="pallas")
    jc = make_config("crowd_dense", "crowd", **kw)
    jenv = CrowdEnv(jc)
    tenv = _port_env(jenv, tcfg.make_config("crowd_dense", "crowd", **kw))
    keys = jax.random.split(jax.random.PRNGKey(13), N)
    js, jobs = jax.jit(jax.vmap(jenv.reset))(keys)
    ts, tobs = tenv.reset(N, draws=jax_reset_draws(jc, keys),
                          lidar_noise=jax_reset_lidar_noise(jc, keys))
    np.testing.assert_array_equal(tobs.numpy(), np.asarray(jobs))
    assert_env_state_equal(ts, js)
    clean = make_config("crowd_dense", "crowd", jitter=1.0, max_steps=8)
    _, jobs0 = jax.jit(jax.vmap(CrowdEnv(clean).reset))(keys)
    assert (np.asarray(jobs0) != np.asarray(jobs)).any()
