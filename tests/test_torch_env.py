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
from torch_presets import check_preset

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


# every ablation arm and every robot on the training world, and the
# waffle's 3.5 m lidar range in the 5 m room under a CP-weight arm
VARIANTS = [("crowd_dense", "crowd", dict(ablation=a)) for a in
            ("no_cp", "basic", "basic_grp", "basic_grp_cp",
             "basic_grp_cp_gcp", "no_cpdto")]
VARIANTS += [("crowd_dense", "crowd", dict(robot=r)) for r in
             ("burger", "burger2", "waffle", "waffle_naked")]
VARIANTS += [("test_12", "random", dict(robot="waffle",
                                        ablation="basic_grp_cp"))]


def _variant_cases():
    """Each variant under the Pallas tracker, and under the XLA tracker
    once for each distinct configuration (``burger``, ``burger2`` and
    ``basic_grp_cp_gcp`` are the default config, ``no_cpdto`` is
    ``basic_grp_cp``'s, ``waffle_naked`` the ``waffle``'s)."""
    cases, ids, seen = [], [], []
    for world, behavior, kw in VARIANTS:
        name = "-".join(kw[k] for k in ("robot", "ablation") if k in kw)
        if world != "crowd_dense":
            name = f"{world}-{behavior}-{name}"
        cases.append((world, behavior, kw, "pallas"))
        ids.append(name)
        cfg = tcfg.make_config(world, behavior, **kw)
        if cfg not in seen:
            seen.append(cfg)
            cases.append((world, behavior, kw, "xla"))
            ids.append(f"{name}-xla")
    return cases, ids


VARIANT_CASES, VARIANT_IDS = _variant_cases()


@pytest.mark.parametrize("world,behavior,kw,backend", VARIANT_CASES,
                         ids=VARIANT_IDS)
def test_state_variants_match_jax(world, behavior, kw, backend):
    """Every ``ABLATION_PRESETS`` arm (the ``_finish_observe`` state
    variants and the CP weights) and every ``ROBOT_PRESETS`` robot, and
    the waffle with the TTC-only CP on ``test_12``/``random``, under the
    tracker's Pallas form (the JAX kernel in interpret mode) and, once a
    distinct config, its XLA form: the port's ``step_batch`` against the
    jitted JAX ``step_batch`` of the same config, 16 envs x 12 steps with
    ``max_steps`` 8, every env auto-reset; observations, rewards, dones
    and every state field bit-equal (``tests/torch_presets.py``)."""
    check_preset(world, behavior, backend, **kw)


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
