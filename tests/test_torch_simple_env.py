"""The port's ``SimpleEnv`` (``crowdnav_tpu_torch/envs/simple_env.py``)
against the JAX package's jitted, vmapped ``SimpleEnv`` step:
observations, rewards, dones and every state field bit-equal over
multi-step rollouts from the same states, with the RANDOM crowd's velocity
draws and the reset template taken from JAX. (The env step on the
evaluation worlds is held in ``tests/test_torch_presets_scenarios*.py``.)

Both sides run the step as the JAX package's runtime does: jitted over the
whole batch, where XLA's CPU backend fuses the step's arithmetic (the
rules of ``crowdnav_tpu_torch/utils/numerics.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crowdnav_tpu.envs import SimpleEnv, make_config
from crowdnav_tpu_torch.envs import config as tcfg
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


@pytest.mark.parametrize("overrides", [
    dict(strict_quirks=True), dict(lidar_backend="pallas"),
    dict(actuation_noise=0.05, dt_jitter=0.15, lidar_noise=0.005)],
    ids=["strict", "lidar_pallas", "noise_knobs"])
@pytest.mark.parametrize("discrete", [False, True])
def test_simple_env_knobs_match_jax(overrides, discrete):
    """``SimpleEnv`` under ``strict_quirks``, the noise knobs (their draws
    passed in from JAX's keys) and ``lidar_backend="pallas"`` against the
    jitted JAX step of the same config, bit for bit. Both ``SimpleEnv``s
    run the raycast's XLA form whatever the ``lidar_backend``."""
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
    assert _rollout(jc, jenv, tenv, jstep, tstep, actions, 5) > 0


def test_simple_env_runs_the_xla_raycast_whatever_the_backend(monkeypatch):
    """The JAX ``SimpleEnv`` runs ``lidar.scan`` whatever the config's
    ``lidar_backend`` (``crowdnav_tpu/envs/simple_env.py:58``): the port's
    never reaches the raycast's Pallas form, and its reset and step under
    ``lidar_backend="pallas"`` equal those under ``"xla"`` bit for bit.
    (The two forms differ in a few 3-decimal scans a million, too rarely
    for the rollouts above to show.)"""
    from crowdnav_tpu_torch.ops import lidar

    def refuse(*args, **kw):
        raise AssertionError("SimpleEnv ran the raycast's Pallas form")
    monkeypatch.setattr(lidar, "scan_batch_pallas", refuse)
    outs = []
    for backend in ("xla", "pallas"):
        env = TSimpleEnv(tcfg.make_config("crowd_sparse", "random",
                                          jitter=1.0, lidar_backend=backend),
                         device="cpu")
        gen = torch.Generator().manual_seed(0)
        state, obs = env.reset(64, gen)
        act = torch.rand((64, 2), generator=gen) \
            * torch.tensor([0.22, 4.0]) - torch.tensor([0.0, 2.0])
        outs.append((obs, env.step_batch(state, act, gen=gen)))
    (obs_x, out_x), (obs_p, out_p) = outs
    np.testing.assert_array_equal(obs_p.numpy(), obs_x.numpy())
    for got, ref in zip(out_p, out_x):
        if isinstance(got, torch.Tensor):
            np.testing.assert_array_equal(got.numpy(), ref.numpy())
    assert_env_state_equal(out_p.state, out_x.state)
