"""Cases and rollouts of the preset parity tests
(``tests/test_torch_presets_*.py`` and
``test_torch_env.py::test_state_variants_match_jax``): the port's
``CrowdEnv.step_batch`` against the jitted JAX ``CrowdEnv.step_batch`` of
the same preset configuration, under the tracker's Pallas form (the JAX
kernel in interpret mode) and its XLA form.

A case builds the JAX env once (its reset template) and checks the port's
reset of the template's key against it. The rollout's first states are
the port's reset of ``N`` keys with the JAX package's draws of those keys
(``world.init_state``'s uniforms, permutation and phase), moved into a JAX
state that carries the key ``init_state`` leaves; from there every step
is taken by both packages from the JAX state, with the RANDOM crowd's
velocity draws taken from JAX, for ``STEPS`` steps with ``max_steps``
``MAX_STEPS`` so that every env auto-resets. Observations, rewards, dones
and every state field, the tracks included, must be bit-equal: both
packages run the same form of the tracker, so no tolerance is needed."""
from __future__ import annotations

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from crowdnav_tpu.envs import CrowdEnv, make_config
from crowdnav_tpu_torch.envs import config as tcfg
from crowdnav_tpu_torch.envs.crowd_env import CrowdEnv as TCrowdEnv
from test_torch_world import jax_crowd_draws, jax_reset_draws
from torch_parity import (assert_env_state_equal, check_template,
                          env_state_to_torch, jax_state, jax_state_keys,
                          template_keys, to_torch)

N, STEPS, MAX_STEPS, JITTER = 16, 12, 8, 1.0
BACKENDS = ("pallas", "xla")


def eval_scenarios():
    """The distinct (world, behavior) pairs of the port's evaluation suites
    other than ``train``, in suite order, then the pillars world with its
    preset behavior."""
    from crowdnav_tpu_torch.drivers.evaluate import SUITES
    out = []
    for name, pairs in SUITES.items():
        out += [p for p in pairs if name != "train" and p not in out]
    return out + [("turtlebot3_world_pillars", None)]


GROUP = 2          # scenarios a test file (twelve files)


def scenario_group(i: int):
    """The ``i``-th group of ``GROUP`` scenarios: one test file each, so
    that a file's JAX compilations (about 25 s a scenario on one core,
    with a cold compilation cache) stay near a minute."""
    return eval_scenarios()[GROUP * i:GROUP * i + GROUP]


def scenario_cases(i: int):
    """``(world, behavior, backend)`` of group ``i``, both backends of one
    scenario next to each other (they share the case's set-up)."""
    return [(w, b, k) for w, b in scenario_group(i) for k in BACKENDS]


def case_id(world, behavior, backend):
    return f"{world}-{behavior}-{backend}"


# the last few cases, by configuration: presets whose configs are equal
# (``burger``, ``burger2`` and ``basic_grp_cp_gcp`` are the default config)
# share one case and its JAX compilations
_CASES: dict = {}
_KEEP = 4


def crowd_case(world, behavior, seed=0, **overrides):
    """``(js0, forms)`` of one preset: the rollout's first JAX state, and
    ``forms["pallas"]``, the JAX env, the port's env on the CPU with the
    JAX reset template and the jitted JAX step under the Pallas tracker
    (:func:`case_form` adds the XLA tracker's). The port's reset of the
    template's key is checked against the template first."""
    kw = dict(jitter=JITTER, max_steps=MAX_STEPS, risk_backend="pallas",
              **overrides)
    jc = make_config(world, behavior, **kw)
    if (jc, seed) in _CASES:
        return _CASES[jc, seed]
    jenv = CrowdEnv(jc)
    tenv = TCrowdEnv(tcfg.make_config(world, behavior, **kw), device="cpu")
    # the template's key, then the rollout's, drawn in one call
    keys = template_keys(seed, N)
    draws = jax_reset_draws(jc, keys)
    tenv.template = check_template(jenv, tenv, draws)
    ts0, _ = tenv.reset(N, draws={k: v[1:] for k, v in draws.items()})
    case = (jax_state(ts0, jax_state_keys(keys[1:])),
            {"pallas": (jc, jenv, tenv, jax.jit(jenv.step_batch))})
    while len(_CASES) >= _KEEP:
        del _CASES[next(iter(_CASES))]
    _CASES[jc, seed] = case
    return case


def case_form(forms, backend):
    """``(jc, jenv, tenv, step)`` of a case under the tracker's
    ``backend``; the reset template, which no backend touches, is
    shared."""
    if backend not in forms:
        jc, jenv, tenv, _ = forms["pallas"]
        jc = dataclasses.replace(jc, risk_backend=backend)
        jenv, tenv = copy.copy(jenv), copy.copy(tenv)
        jenv.cfg = jc
        tenv.cfg = dataclasses.replace(tenv.cfg, risk_backend=backend)
        forms[backend] = (jc, jenv, tenv, jax.jit(jenv.step_batch))
    return forms[backend]


def uniform_actions(rng, n=N):
    """Seeded uniform (lin, ang) actions over the robot's box."""
    return rng.uniform([0.0, -2.0], [0.22, 2.0], (n, 2)).astype(np.float32)


def crowd_rollout(jc, step, tenv, js, seed=1):
    """``STEPS`` steps of seeded uniform actions, each taken by the port's
    env and the jitted JAX ``step`` from the JAX state; every output
    bit-equal. Returns the number of auto-resets."""
    rng = np.random.default_rng(seed)
    resets = 0
    for t in range(STEPS):
        act = uniform_actions(rng)
        got = tenv.step_batch(env_state_to_torch(js), to_torch(act),
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
        assert_env_state_equal(got.state, out.state, msg)
        js = out.state
    return resets


def check_preset(world, behavior, backend, **overrides):
    """One preset under one tracker backend: the rollout, bit-equal, with
    every env auto-reset at least once."""
    js0, forms = crowd_case(world, behavior, **overrides)
    jc, jenv, tenv, step = case_form(forms, backend)
    assert tenv.obs_dim == jenv.obs_dim
    assert crowd_rollout(jc, step, tenv, js0) >= N
