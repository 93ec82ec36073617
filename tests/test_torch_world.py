"""The port's world model (``crowdnav_tpu_torch/envs/world.py``) against
``crowdnav_tpu/envs/world.py``: ``init_state`` with reset jitter and
``world_step`` with the RANDOM crowd's velocity redraw, the JAX package's
draws fed in; bit-equal.

``world_step`` is held against the physics half of the jitted env step
(``CrowdEnv.step``, the program the JAX package runs), not against a jitted
``world_step`` alone: XLA fuses the kinematics differently in the two
programs, and they disagree in the last bit of some robot positions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crowdnav_tpu.envs import CrowdEnv
from crowdnav_tpu.envs import config as jcfg
from crowdnav_tpu.envs import world as jworld
from crowdnav_tpu_torch.envs import config as tcfg
from crowdnav_tpu_torch.envs import world as tworld
from crowdnav_tpu_torch.envs.crowd_env import CrowdEnv as TCrowdEnv
from torch_parity import (assert_env_state_equal, check_template,
                          env_state_to_torch, jax_state, jax_state_keys,
                          template_keys, to_torch)

torch.set_num_threads(1)
N = 32


def jax_reset_draws(cfg, keys):
    """The draws ``world.init_state`` makes from each key, jitted as the
    JAX package's resets are (one compilation, not one a primitive)."""
    P = max(cfg.n_peds, 1)
    f32 = jnp.float32

    def one(key):
        k_pos, k_yaw, k_ped, k_perm, k_phase, _ = jax.random.split(key, 6)
        return dict(
            pos=jax.random.uniform(k_pos, (2,), f32, -cfg.start_pos_jitter,
                                   cfg.start_pos_jitter),
            yaw=jax.random.uniform(k_yaw, (), f32, -cfg.start_yaw_jitter,
                                   cfg.start_yaw_jitter),
            ped=jax.random.uniform(k_ped, (P, 2), f32, -cfg.ped_pos_jitter,
                                   cfg.ped_pos_jitter),
            perm=jax.random.permutation(k_perm, P),
            phase=jax.random.randint(k_phase, (), 0,
                                     max(cfg.redraw_window_steps, 1),
                                     jnp.int32))
    return {k: to_torch(v) for k, v in jax.jit(jax.vmap(one))(keys).items()}


def jax_crowd_draws(cfg, states):
    """The RANDOM crowd's fresh velocities ``world_step`` draws."""
    def one(key, ped_pos):
        _, k_crowd, _, _ = jax.random.split(key, 4)
        return jax.random.uniform(k_crowd, ped_pos.shape,
                                  minval=-cfg.crowd_speed,
                                  maxval=cfg.crowd_speed,
                                  dtype=ped_pos.dtype)
    return to_torch(jax.vmap(one)(states.key, states.ped_pos))


@pytest.mark.parametrize("world,behavior,jitter", [
    ("crowd_dense", "crowd", 1.0), ("crowd_dense", "crossing", 0.0),
    ("crowd_none", None, 1.0), ("test_20", "towards_20", 1.0)])
def test_init_state_matches_jax(world, behavior, jitter):
    jc = jcfg.make_config(world, behavior, jitter=jitter)
    tc = tcfg.make_config(world, behavior, jitter=jitter)
    keys = jax.random.split(jax.random.PRNGKey(3), N)
    ref = jax.jit(jax.vmap(lambda k: jworld.init_state(jc, k)))(keys)
    draws = jax_reset_draws(jc, keys) if jitter else None
    got = tworld.init_state(tc, N, "cpu", draws=draws)
    assert_env_state_equal(got, ref)


PHYSICS_FIELDS = ("pos", "yaw", "lin_vel", "ang_vel", "prev_pos", "ped_pos",
                  "ped_vel", "step", "last_action_type")


# every behavior preset: each CrowdBehavior (STATIC, RANDOM, CROSSING,
# TOWARDS, AHEAD) at each of its speeds, the direction tables of 4, 8, 12
# and 20 pedestrians and the 20-table cycled over the 14 of crowd_dense
WORLD_CASES = [("crowd_dense", b) for b in ("crowd", "crossing", "static")]
WORLD_CASES += [
    ("crowd_20", "crowd_highspeed"), ("test_4", "random"),
    ("test_20", "random_fast"), ("test_20", "random_20"),
    ("test_12", "crossing_fast"), ("test_20", "crossing_20"),
    ("test_8", "towards"), ("crowd_dense", "towards_fast"),
    ("test_20", "towards_20"), ("test_12", "ahead"),
    ("test_4", "ahead_fast"), ("test_20", "ahead_20")]


@pytest.mark.parametrize(
    "world,behavior", WORLD_CASES,
    ids=[b if w == "crowd_dense" and b in ("crowd", "crossing", "static")
         else f"{w}-{b}" for w, b in WORLD_CASES])
def test_world_step_matches_jax(world, behavior):
    """``world_step`` under every behavior preset against the physics half
    of the jitted, vmapped JAX env step, 32 envs x 8 steps (every fifth
    env takes the STOP action) from the port's reset with the JAX
    package's draws (its reset of the template's key held to the JAX
    template first): the physics fields bit-equal on the rows that did
    not auto-reset."""
    jc = jcfg.make_config(world, behavior, jitter=1.0)
    tc = tcfg.make_config(world, behavior, jitter=1.0)
    env = CrowdEnv(jc)
    tenv = TCrowdEnv(tc, device="cpu")
    keys = template_keys(5, N)
    draws = jax_reset_draws(jc, keys)
    check_template(env, tenv, draws)
    ts, _ = tenv.reset(N, draws={k: v[1:] for k, v in draws.items()})
    js = jax_state(ts, jax_state_keys(keys[1:]))
    step = jax.jit(jax.vmap(env.step))
    rng = np.random.default_rng(0)
    for t in range(8):
        act = rng.uniform([0.0, -2.0], [0.22, 2.0], (N, 2)).astype(
            np.float32)
        act[::5] = 0.0                     # STOP actions too
        draw = jax_crowd_draws(jc, js) \
            if jc.behavior == jcfg.CrowdBehavior.RANDOM else None
        got = tworld.world_step(tc, env_state_to_torch(js),
                                torch.from_numpy(act), vel_draw=draw)
        live = ~np.asarray(js.done)        # rows not auto-reset this step
        js = step(js, jnp.asarray(act)).state
        for f in PHYSICS_FIELDS:
            np.testing.assert_array_equal(
                getattr(got, f).numpy()[live], np.asarray(getattr(js, f))[live],
                err_msg=f"step {t} {f}")
