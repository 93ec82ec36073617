"""The port's ``SimpleEnv`` (the 363-dim state of SAC and DQN) on the
worlds of their evaluation suites, ``test_20``/``random_20`` (suite
``20``) and ``crowd_sparse``/``crowd`` (suite ``train_sparse``), and with
the ``waffle`` robot's 3.5 m lidar in the 5 m room, in both action modes,
against the jitted, vmapped JAX ``SimpleEnv`` step of the same config:
16 envs x 14 steps with ``max_steps`` 8 and reset jitter 1.0, every env
auto-reset; the reset, observations, rewards, dones and every state field
bit-equal (``test_torch_simple_env._rollout``)."""
import functools

import jax
import pytest
import torch

from crowdnav_tpu.envs import SimpleEnv, make_config
from crowdnav_tpu_torch.envs import config as tcfg
from crowdnav_tpu_torch.envs.simple_env import SimpleEnv as TSimpleEnv
from test_torch_simple_env import (N, _continuous, _discrete, _rollout,
                                   port_env)

torch.set_num_threads(1)
CONFIGS = [("test_20", "random_20", None), ("crowd_sparse", "crowd", None),
           ("test_20", "random_20", "waffle")]


@functools.lru_cache(maxsize=1)
def _envs(world, behavior, robot):
    kw = dict(jitter=1.0, max_steps=8, robot=robot)
    jc = make_config(world, behavior, **kw)
    jenv = SimpleEnv(jc)
    return jc, jenv, port_env(TSimpleEnv, jenv,
                              tcfg.make_config(world, behavior, **kw))


@pytest.mark.parametrize(
    "world,behavior,robot,discrete",
    [(*c, d) for c in CONFIGS for d in (False, True)],
    ids=[f"{w}-{b}-{r or 'burger'}-{'discrete' if d else 'continuous'}"
         for w, b, r in CONFIGS for d in (False, True)])
def test_simple_env_preset_matches_jax(world, behavior, robot, discrete):
    jc, jenv, tenv = _envs(world, behavior, robot)
    if discrete:
        jstep = jax.jit(jax.vmap(jenv.step_discrete))
        tstep, actions = tenv.step_discrete, _discrete
    else:
        jstep = jax.jit(jax.vmap(jenv.step))
        tstep, actions = tenv.step_batch, _continuous
    assert _rollout(jc, jenv, tenv, jstep, tstep, actions, 7) >= N
