"""The port's deployment path and baselines against the JAX package's:
the ``realworld`` world's step (K = 1, no waypoints, 370-dim) and
``CrowdEnv.observe_external`` bit-equal to the jitted JAX functions over
multi-step rollouts from the same states; the FSM obstacle avoider and
the goal seeker (``crowdnav_tpu_torch/baselines.py``) bit-equal to
``crowdnav_tpu/baselines.py`` over rollouts that cross every FSM mode;
and ``drivers/deploy_realworld.run_deployment`` in loopback on the CPU,
its history equal to the JAX loop's under a policy both frameworks compute
exactly (an actor of zero weights: the action is (0.5 * 0.22, 0))."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crowdnav_tpu import baselines as jbase
from crowdnav_tpu.agents import TD3 as JTD3
from crowdnav_tpu.agents import TD3Config as JTD3Config
from crowdnav_tpu.drivers import deploy_realworld as jdeploy
from crowdnav_tpu.envs import CrowdEnv, make_config
from crowdnav_tpu_torch import baselines as tbase
from crowdnav_tpu_torch.drivers import deploy_realworld as tdeploy
from crowdnav_tpu_torch.envs import config as tcfg
from crowdnav_tpu_torch.envs.crowd_env import CrowdEnv as TCrowdEnv
from crowdnav_tpu_torch.utils.convert import flax_actor_to_state_dict
from test_torch_world import jax_crowd_draws, jax_reset_draws
from torch_parity import assert_env_state_equal, env_state_to_torch

torch.set_num_threads(1)
N = 16


def _envs(**kw):
    jc = make_config("realworld", "crowd", **kw)
    tc = tcfg.make_config("realworld", "crowd", **kw)
    jenv = CrowdEnv(jc)
    tenv = TCrowdEnv(tc, device="cpu")
    st, obs = jenv._template
    tenv.template = (env_state_to_torch(jax.tree.map(lambda a: a[None], st)),
                     torch.from_numpy(np.array(obs))[None])
    return jc, jenv, tenv


def _reset(jc, jenv, tenv, seed):
    keys = jax.random.split(jax.random.PRNGKey(seed), N)
    js, jobs = jax.jit(jax.vmap(jenv.reset))(keys)
    ts, tobs = tenv.reset(N, draws=jax_reset_draws(jc, keys))
    np.testing.assert_array_equal(tobs.numpy(), np.asarray(jobs))
    return js, ts


def test_realworld_step_matches_jax():
    """The 370-dim world over 20 steps of random actions (the random
    crowd's velocities drawn by JAX): observations, rewards, dones and
    every state field bit-equal, the auto-reset included."""
    jc, jenv, tenv = _envs(jitter=1.0, max_steps=10)
    assert tenv.obs_dim == jc.state_dim_risk == 370
    assert tenv.cfg.k_obstacles == 1 and not tenv.cfg.use_waypoints
    js, ts = _reset(jc, jenv, tenv, 3)
    step = jax.jit(jax.vmap(jenv.step))
    rng = np.random.default_rng(5)
    resets = 0
    for t in range(20):
        act = rng.uniform([0.0, -2.0], [0.22, 2.0], (N, 2)).astype(
            np.float32)
        got = tenv.step_batch(ts, torch.from_numpy(act),
                              vel_draw=jax_crowd_draws(jc, js))
        resets += int(np.asarray(js.done).sum())
        out = step(js, jnp.asarray(act))
        np.testing.assert_array_equal(got.obs.numpy(), np.asarray(out.obs),
                                      err_msg=f"step {t} obs")
        np.testing.assert_array_equal(got.reward.numpy(),
                                      np.asarray(out.reward))
        np.testing.assert_array_equal(got.done.numpy(), np.asarray(out.done))
        assert_env_state_equal(got.state, out.state, f"step {t}")
        js, ts = out.state, got.state
    assert resets > 0


def _scans(rng, n, t, n_scans=359):
    """Lidar scans of a few moving blobs (arcs of 8-30 beams at 0.15-0.55
    m) over free space, on 1 mm steps, plus stray hits."""
    s = np.full((n, n_scans), 0.6, np.float32)
    for i in range(n):
        for b in range(rng.integers(1, 4)):
            c = (int(rng.integers(0, n_scans)) + 7 * t) % n_scans
            w = int(rng.integers(8, 31))
            idx = (c + np.arange(w)) % n_scans
            s[i, idx] = np.round(rng.uniform(0.15, 0.55), 3)
        stray = rng.integers(0, n_scans, 3)
        s[i, stray] = np.round(rng.uniform(0.1, 0.6, 3), 3)
    return s


def test_observe_external_matches_jax():
    """Eight ticks of external scans and odometry from states that have
    stepped: the observation and the state bit-equal after each tick, the
    tracks carried from tick to tick on both sides."""
    jc, jenv, tenv = _envs(jitter=1.0, max_steps=50)
    js, ts = _reset(jc, jenv, tenv, 7)
    step = jax.jit(jax.vmap(jenv.step))
    rng = np.random.default_rng(9)
    for _ in range(3):
        act = rng.uniform([0.0, -2.0], [0.22, 2.0], (N, 2)).astype(
            np.float32)
        js = step(js, jnp.asarray(act)).state
    ts = env_state_to_torch(js)
    observe = jax.jit(jax.vmap(jenv.observe_external))
    pos = np.asarray(js.pos)
    yaw = np.asarray(js.yaw)
    seen = 0
    for t in range(8):
        pos = (pos + rng.uniform(-0.02, 0.02, pos.shape)).astype(np.float32)
        yaw = (yaw + rng.uniform(-0.1, 0.1, yaw.shape)).astype(np.float32)
        scans = _scans(rng, N, t)
        ts, tobs = tenv.observe_external(ts, torch.from_numpy(scans),
                                         torch.from_numpy(pos),
                                         torch.from_numpy(yaw))
        js, jobs = observe(js, jnp.asarray(scans), jnp.asarray(pos),
                           jnp.asarray(yaw))
        np.testing.assert_array_equal(tobs.numpy(), np.asarray(jobs),
                                      err_msg=f"tick {t} obs")
        assert_env_state_equal(ts, js, f"tick {t}")
        seen += int(np.asarray(js.tracks.valid).sum())
    assert tobs.shape == (N, 370)
    assert seen > 0, "no track was ever confirmed"


def _fsm_obs(rng, n):
    """Observations whose three FSM beams take values on both sides of
    the front and side limits."""
    obs = rng.uniform(0.0, 0.6, (n, 370)).astype(np.float32)
    vals = np.array([0.1, 0.2, 0.25, 0.3, 0.45, 0.5, 0.6], np.float32)
    for beam, p in ((0, [.1, .1, .05, .1, .05, .2, .4]),
                    (329, [.05, .05, .05, .15, .1, .2, .4]),
                    (30, [.05, .1, .05, .2, .1, .1, .4])):
        obs[:, beam] = rng.choice(vals, n, p=p)
    return obs


def test_fsm_avoider_matches_jax_over_every_mode():
    """64 robots over 40 ticks of observations around the limits: every
    action and FSM state bit-equal, every mode and a finished turn
    seen."""
    rng = np.random.default_rng(11)
    n = 64
    jst = jbase.fsm_init((n,))
    tst = tbase.fsm_init((n,), device="cpu")
    step = jax.jit(jbase.fsm_obstacle_avoider)
    modes = set()
    for t in range(40):
        obs = _fsm_obs(rng, n)
        ja, jst = step(jnp.asarray(obs), jst)
        ta, tst = tbase.fsm_obstacle_avoider(torch.from_numpy(obs), tst)
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja),
                                      err_msg=f"tick {t}")
        for f in ("mode", "turn_left"):
            got, want = getattr(tst, f), np.asarray(getattr(jst, f))
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want,
                                          err_msg=f"tick {t} {f}")
        modes |= set(np.asarray(jst.mode).tolist())
    assert modes == {jbase.GET_DIRECTION, jbase.DRIVE_FORWARD,
                     jbase.RIGHT_TURN, jbase.LEFT_TURN}, modes


def test_fsm_avoider_drives_the_env_as_jax():
    """The avoider in closed loop with the ``crowd_dense`` step, 16 envs
    x 30 ticks: actions, states and observations bit-equal."""
    kw = dict(jitter=1.0, max_steps=30)
    jc = make_config("crowd_dense", "crowd", **kw)
    tc = tcfg.make_config("crowd_dense", "crowd", **kw)
    jenv = CrowdEnv(jc)
    tenv = TCrowdEnv(tc, device="cpu")
    st, o = jenv._template
    tenv.template = (env_state_to_torch(jax.tree.map(lambda a: a[None], st)),
                     torch.from_numpy(np.array(o))[None])
    keys = jax.random.split(jax.random.PRNGKey(2), N)
    js, jobs = jax.jit(jax.vmap(jenv.reset))(keys)
    ts, tobs = tenv.reset(N, draws=jax_reset_draws(jc, keys))
    jf, tf = jbase.fsm_init((N,)), tbase.fsm_init((N,), device="cpu")
    step = jax.jit(jax.vmap(jenv.step))
    policy = jax.jit(jbase.fsm_obstacle_avoider)
    modes = set()
    for t in range(30):
        ja, jf = policy(jobs, jf)
        ta, tf = tbase.fsm_obstacle_avoider(tobs, tf)
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja),
                                      err_msg=f"tick {t} action")
        out = step(js, ja)
        got = tenv.step_batch(ts, ta, vel_draw=jax_crowd_draws(jc, js))
        np.testing.assert_array_equal(got.obs.numpy(), np.asarray(out.obs),
                                      err_msg=f"tick {t} obs")
        js, jobs, ts, tobs = out.state, out.obs, got.state, got.obs
        modes |= set(tf.mode.tolist())
    assert len(modes) >= 2, modes


def test_goal_seeker_matches_jax():
    """Heading errors across the clip and the speed switch (exactly +-1,
    the float32 neighbours, far beyond), batched and for one env."""
    rng = np.random.default_rng(13)
    obs = rng.uniform(-0.6, 0.6, (256, 398)).astype(np.float32)
    edges = np.array([1.0, -1.0, np.nextafter(np.float32(1), 0),
                      -np.nextafter(np.float32(1), 0), 0.0, 5.0, -5.0, 1.25],
                     np.float32)
    obs[:, 359] = np.concatenate([edges, rng.uniform(
        -3.5, 3.5, 256 - edges.size).astype(np.float32)])
    want = np.asarray(jax.jit(jbase.goal_seeker)(jnp.asarray(obs)))
    got = tbase.goal_seeker(torch.from_numpy(obs))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tbase.goal_seeker(torch.from_numpy(obs[3])).numpy(),
        np.asarray(jbase.goal_seeker(jnp.asarray(obs[3]))))


def _zero_actor():
    """The JAX TD3 actor with every weight zero, and the port's state
    dict of it."""
    agent = JTD3(JTD3Config(), 370)
    params = agent.init(jax.random.PRNGKey(0)).actor_params
    params = jax.tree.map(jnp.zeros_like, params)
    sd = flax_actor_to_state_dict(jax.tree.map(np.asarray, params))
    return params, sd


def test_run_deployment_loopback_matches_jax():
    """The loopback loop on the CPU, 12 ticks: each tick's action and
    distance to goal equal to the JAX loop's; the source and the sink see
    the scans, pose and actions; the ticks are timed."""
    jparams, sd = _zero_actor()
    jhist = jdeploy.run_deployment(actor_params=jparams, n_ticks=12,
                                   tick_period=0.0)
    seen, sent, lat = [], [], []
    loop = None

    def source(state):
        out = loop(state)
        seen.append(out)
        return out

    loop = tdeploy.loopback_source(tcfg.make_config("realworld"))
    thist = tdeploy.run_deployment(actor=sd, n_ticks=12, source=source,
                                   sink=sent.append, tick_period=0.0,
                                   device="cpu", latencies=lat)
    assert len(thist) == len(jhist) == 12
    for (ta, td), (ja, jd) in zip(thist, jhist):
        np.testing.assert_array_equal(ta, np.asarray(ja))
        assert td == jd
    np.testing.assert_array_equal(thist[0][0], np.float32([0.11, 0.0]))
    assert len(seen) == len(sent) == len(lat) == 12
    assert seen[0][0].shape == (1, 359)


def test_run_deployment_takes_a_real_sensor_feed():
    """A source of host arrays, as a robot's topics give them (one scan,
    a pose), through the whole loop: 370-dim observations, the episode
    ends at the goal box."""
    cfg = tcfg.make_config("realworld")
    obs_seen = []
    hist = tdeploy.run_deployment(
        n_ticks=5, tick_period=0.0, device="cpu",
        source=lambda st: (np.full(359, 0.6, np.float32),
                           np.float32(cfg.goal), np.float32(0.0)),
        on_tick=lambda st, obs, a: obs_seen.append(obs))
    assert len(hist) == 1 and obs_seen[0].shape == (1, 370)
    assert hist[0][1] == 0.0


def test_deploy_main_refuses_cuda_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal of --device cuda without a card")
    with pytest.raises(SystemExit):
        tdeploy.main(["--ticks", "2"])
    hist = tdeploy.main(["--ticks", "3", "--device", "cpu"])
    assert len(hist) == 3
    assert "ran 3 ticks" in capsys.readouterr().out
