"""The port's ``SimpleEnv`` (``crowdnav_tpu_torch/envs/simple_env.py``)
against the JAX package's jitted, vmapped ``SimpleEnv`` step, and the env
step on the evaluation worlds of suites ``20`` and ``hard`` against the
JAX ``CrowdEnv.step_batch``: observations, rewards, dones and every state
field bit-equal over multi-step rollouts from the same states, with the
RANDOM crowd's velocity draws and the reset template taken from JAX.

Both sides run the step as the JAX package's runtime does: jitted over the
whole batch, where XLA's CPU backend fuses the step's arithmetic (the
rules of ``crowdnav_tpu_torch/utils/numerics.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crowdnav_tpu.envs import CrowdEnv, SimpleEnv, make_config
from crowdnav_tpu_torch.envs import config as tcfg
from crowdnav_tpu_torch.envs.crowd_env import CrowdEnv as TCrowdEnv
from crowdnav_tpu_torch.envs.simple_env import DISCRETE_ACTIONS_TABLE
from crowdnav_tpu_torch.envs.simple_env import SimpleEnv as TSimpleEnv
from test_torch_world import jax_crowd_draws, jax_reset_draws
from torch_parity import (assert_env_state_equal, env_state_to_torch,
                          jax_noise_draws)

torch.set_num_threads(1)
N, STEPS = 16, 14


def port_env(cls, jenv, tc):
    """The port's env on the CPU with the JAX env's reset template."""
    env = cls(tc, device="cpu")
    st, obs = jenv._template
    env.template = (env_state_to_torch(jax.tree.map(lambda a: a[None], st)),
                    torch.from_numpy(np.array(obs))[None])
    return env


def jax_reset_lidar_noise(cfg, keys):
    """The reset observation's lidar noise of the JAX reset from ``keys``
    (drawn from the fresh state's key), or None without the knob."""
    if cfg.lidar_noise <= 0.0:
        return None
    from crowdnav_tpu.envs import world as jworld

    def one(key):
        st = jworld.init_state(cfg, key)
        return jax.random.normal(jax.random.fold_in(st.key, 7),
                                 (cfg.n_scans,)) * cfg.lidar_noise
    return torch.from_numpy(np.array(jax.jit(jax.vmap(one))(keys)))


def _rollout(jc, jenv, tenv, jstep, tstep, actions, seed):
    """``STEPS`` steps from JAX's reset states, each side from JAX's state;
    every output bit-equal. Returns the number of auto-resets."""
    keys = jax.random.split(jax.random.PRNGKey(seed), N)
    js, jobs = jax.jit(jax.vmap(jenv.reset))(keys)
    draws = jax_reset_draws(jc, keys) if jc.start_pos_jitter else None
    ts, tobs = tenv.reset(N, torch.Generator().manual_seed(0), draws=draws,
                          lidar_noise=jax_reset_lidar_noise(jc, keys))
    np.testing.assert_array_equal(tobs.numpy(), np.asarray(jobs))
    assert_env_state_equal(ts, js, "reset")
    resets = 0
    rng = np.random.default_rng(seed)
    for t in range(STEPS):
        act = actions(rng)
        got = tstep(env_state_to_torch(js), torch.from_numpy(act),
                    vel_draw=jax_crowd_draws(jc, js),
                    noise=jax_noise_draws(jc, js))
        resets += int(np.asarray(js.done).sum())
        out = jstep(js, jnp.asarray(act))
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
    return resets


def _continuous(rng):
    return rng.uniform([0.0, -2.0], [0.22, 2.0], (N, 2)).astype(np.float32)


def _discrete(rng):
    return rng.integers(0, len(DISCRETE_ACTIONS_TABLE), N).astype(np.int32)


@pytest.mark.parametrize("world,behavior", [("crowd_sparse", "random"),
                                            ("crowd_none", None)])
@pytest.mark.parametrize("discrete", [False, True])
@pytest.mark.parametrize("jitter", [0.0, 1.0])
def test_simple_env_step_matches_jax(world, behavior, discrete, jitter):
    """``SimpleEnv`` continuous and discrete, with and without reset
    jitter (the jittered spawns of a reset bank), against the jitted,
    vmapped JAX step: bit-equal, auto-resets included."""
    kw = dict(jitter=jitter, max_steps=6)
    jc = make_config(world, behavior, **kw)
    jenv = SimpleEnv(jc)
    tenv = port_env(TSimpleEnv, jenv, tcfg.make_config(world, behavior,
                                                        **kw))
    assert tenv.obs_dim == jenv.obs_dim == 363
    if discrete:
        jstep = jax.jit(jax.vmap(jenv.step_discrete))
        tstep, actions = tenv.step_discrete, _discrete
    else:
        jstep = jax.jit(jax.vmap(jenv.step))
        tstep, actions = tenv.step_batch, _continuous
    assert _rollout(jc, jenv, tenv, jstep, tstep, actions, 3) > 0


@pytest.mark.parametrize("world,behavior,target", [
    ("crowd_none", None, "goal"), ("crowd_sparse", "static", "pedestrian")])
def test_simple_env_terminal_rewards(world, behavior, target):
    """The terminal rewards, bit-equal to JAX: a robot steered onto the
    goal ends with +200 plus its shaping, one steered into a standing
    pedestrian with -200 plus its shaping; then the template reset."""
    kw = dict(max_steps=400)
    jc = make_config(world, behavior, **kw)
    jenv = SimpleEnv(jc)
    tenv = port_env(TSimpleEnv, jenv, tcfg.make_config(world, behavior,
                                                        **kw))
    js, _ = jax.jit(jax.vmap(jenv.reset))(jax.random.PRNGKey(0)[None])
    jstep = jax.jit(jax.vmap(jenv.step))
    ends = []
    for t in range(120):
        s = jax.tree.map(lambda a: a[0], js)
        aim = jnp.asarray(jc.goal) if target == "goal" else s.ped_pos[0]
        err = np.arctan2(*np.asarray(aim - s.pos)[::-1]) - float(s.yaw)
        err = (err + np.pi) % (2 * np.pi) - np.pi
        # slowly into the pedestrian, so that the collision cut's step shows
        speed = 0.22 if target == "goal" else 0.05
        act = np.array([[speed, np.clip(2 * err, -2, 2)]], np.float32)
        out = jstep(js, jnp.asarray(act))
        got = tenv.step_batch(env_state_to_torch(js), torch.from_numpy(act))
        np.testing.assert_array_equal(got.reward.numpy(),
                                      np.asarray(out.reward))
        np.testing.assert_array_equal(got.obs.numpy(), np.asarray(out.obs))
        assert_env_state_equal(got.state, out.state, f"step {t}")
        if bool(out.done[0]):
            ends.append((float(out.reward[0]),
                         bool(out.state.episode_success[0])))
        js = out.state
    assert ends, "no episode ended"
    for reward, success in ends:
        if target == "goal":
            assert success and reward >= 200.0, ends
        else:
            assert not success and reward <= -198.0, ends


@pytest.mark.parametrize("world,behavior", [
    ("test_20", "crossing_20"), ("test_20", "random_20"),
    ("crowd_20", "crowd"), ("crowd_dense", "crowd_highspeed")])
def test_eval_world_step_matches_jax(world, behavior):
    """The env step on the worlds of suites ``20`` and ``hard`` (room 5 m
    with 20 pedestrians and ``min_scan_range`` 0; 20 pedestrians in the
    3 m room; the 0.5 m/s crowd), jitter 1.0 as the evaluation driver
    runs them, against the jitted JAX ``CrowdEnv.step_batch``."""
    kw = dict(jitter=1.0, max_steps=10)
    jc = make_config(world, behavior, **kw)
    jenv = CrowdEnv(jc)
    tenv = port_env(TCrowdEnv, jenv, tcfg.make_config(world, behavior,
                                                       **kw))
    _rollout(jc, jenv, tenv, jax.jit(jenv.step_batch), tenv.step_batch,
             _continuous, 5)


@pytest.mark.parametrize("overrides", [
    dict(strict_quirks=True), dict(lidar_backend="pallas"),
    dict(actuation_noise=0.05, dt_jitter=0.15, lidar_noise=0.005)],
    ids=["strict", "lidar_pallas", "noise_knobs"])
@pytest.mark.parametrize("discrete", [False, True])
def test_simple_env_knobs_match_jax(overrides, discrete):
    """``SimpleEnv`` under ``strict_quirks`` and the noise knobs (their
    draws passed in from JAX's keys) against the jitted JAX step, bit for
    bit. The JAX ``SimpleEnv`` runs the XLA raycast whatever the
    ``lidar_backend``; under ``"pallas"`` the port runs the raycast's
    Pallas form, so that case holds the port's step against the JAX step
    with its observation's scans taken from ``scan_batch_pallas``."""
    kw = dict(jitter=1.0, max_steps=6, **overrides)
    jc = make_config("crowd_sparse", "random", **kw)
    jenv = SimpleEnv(jc)
    tenv = port_env(TSimpleEnv, jenv, tcfg.make_config(
        "crowd_sparse", "random", **kw))
    if discrete:
        jstep = jax.jit(jax.vmap(jenv.step_discrete))
        tstep, actions = tenv.step_discrete, _discrete
    else:
        jstep = jax.jit(jax.vmap(jenv.step))
        tstep, actions = tenv.step_batch, _continuous
    if overrides.get("lidar_backend") == "pallas":
        from crowdnav_tpu.ops.lidar_pallas import scan_batch_pallas
        c = jc
        xla_step = jstep

        def jstep(js, act):   # the JAX step with the Pallas form's scans
            out = xla_step(js, act)
            st = out.state
            scans = jnp.round(scan_batch_pallas(
                st.pos, st.yaw, st.ped_pos, c.ped_radius, c.room_half_inner,
                c.max_scan_range, c.lidar_min_range, c.n_scans), 3)
            done_before = js.done[:, None]
            obs = out.obs.at[:, :c.n_scans].set(
                jnp.where(done_before, out.obs[:, :c.n_scans], scans))
            return out._replace(obs=obs)
    assert _rollout(jc, jenv, tenv, jstep, tstep, actions, 5) > 0
