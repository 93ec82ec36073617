"""The port's TD3 learner (``crowdnav_tpu_torch/agents/td3.py``,
``agents/optim.py``, ``models/networks.py``, ``utils/convert.py``) against
the JAX package's ``TD3``, ``DoubleCritic`` and optax's Adam, on the same
parameters, optimizer states, batches and noise.

What is held bit for bit: Adam (against optax's un-jitted ``adam().update``
on identical gradients, zero gradients included), ``decay_sigma``, the
exploring act (given the JAX actor's heads and the JAX draws), the
epsilon spectrum, and the state conversion.

What is held to a derived bound (the update): the two frameworks sum their
matrix products in other, host-dependent orders, so no constant tuned on
one host holds on another. The gradients of the critic and actor losses
are held within a float32 forward-error bound of a float64 evaluation of
the same formulas, carried operation by operation
(``crowdnav_tpu_torch/utils/error_bounds.py``:
gamma(k + 1) = (k + 1) u / (1 - (k + 1) u) of sum |terms| for each k-term
product or sum, 3u per elementwise operation, 2^-20 relative for the
library's sigmoid/tanh, the full gradient where a ReLU may switch, the
float64 evaluation's own error; u = 2^-24). Each update starts from the
JAX state of the previous one (so differences do not compound) and the
rest of its outputs are held to what those gradient bounds imply through
Adam's arithmetic: a moment moves by (1 - b) times its gradient term
(plus the products' roundings); the parameters lie within lr times the
float64 difference of the two sides' steps m_hat / (sqrt(v_hat) + eps),
recomputed from their own moments, plus 8u of each step; a target within
tau times the parameters' actual difference. Counts, ``update_count`` and
non-policy targets are exact."""
import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from crowdnav_tpu.agents.td3 import TD3 as JTD3
from crowdnav_tpu.agents.td3 import TD3Config as JTD3Config
from crowdnav_tpu.parallel.runtime import greedy_env_mask as jgreedy_mask
from crowdnav_tpu_torch.agents.optim import Adam
from crowdnav_tpu_torch.agents.replay import Transition
from crowdnav_tpu_torch.agents.td3 import TD3, TD3Config, eps_spectrum
from crowdnav_tpu_torch.models.networks import DoubleCritic
from crowdnav_tpu_torch.parallel.runtime import greedy_env_mask
from crowdnav_tpu_torch.utils import convert
from crowdnav_tpu_torch.utils.error_bounds import check_update

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OBS_DIM = 398
HIDDEN = 64
BATCH = 64
SPECTRUM = dict(explore_uniform_eps=1.0, explore_uniform_eps_min=0.05,
                explore_eps_spectrum=True)


def export_module():
    spec = importlib.util.spec_from_file_location(
        "export_torch_agent",
        os.path.join(ROOT, "scripts", "export_torch_agent.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _agents(**kw):
    jagent = JTD3(JTD3Config(hidden=HIDDEN, batch_size=BATCH, **kw), OBS_DIM)
    tagent = TD3(TD3Config(hidden=HIDDEN, batch_size=BATCH, **kw), OBS_DIM,
                 device="cpu")
    return jagent, tagent


def to_port(tagent, jstate):
    arrays = export_module().state_arrays(jax.tree.map(np.asarray, jstate))
    return convert.state_from_arrays(tagent, arrays)


def to_jax(tagent, tstate, jtemplate):
    """The port's ``TD3State`` as a JAX ``TD3State`` of ``jtemplate``'s
    structure and dtypes (the inverse of :func:`to_port`)."""
    arrays = convert.state_to_arrays(tagent, tstate)

    def tree(t, prefix):
        return {k: tree(v, f"{prefix}/{k}") if isinstance(v, dict)
                else jnp.asarray(arrays[f"{prefix}/{k}"], v.dtype)
                for k, v in t.items()}

    kw = {f: {"params": tree(getattr(jtemplate, f)["params"], f)}
          for f in ("actor_params", "actor_target", "critic_params",
                    "critic_target")}
    for f in ("actor_opt", "critic_opt"):
        opt = getattr(jtemplate, f)
        adam = opt[0]._replace(
            count=jnp.asarray(arrays[f"{f}/count"], opt[0].count.dtype),
            mu={"params": tree(opt[0].mu["params"], f"{f}/mu")},
            nu={"params": tree(opt[0].nu["params"], f"{f}/nu")})
        kw[f] = (adam,) + tuple(opt[1:])
    for f in ("update_count", "explore_sigma", "explore_eps"):
        kw[f] = jnp.asarray(arrays[f], getattr(jtemplate, f).dtype)
    return jtemplate.replace(**kw)


def _batch(rng, n=BATCH):
    """A replay sample: bfloat16 observations, float32 the rest."""
    def bf16(a):
        return np.asarray(jnp.asarray(a, jnp.bfloat16))

    obs = bf16(rng.uniform(-1.5, 1.5, (n, OBS_DIM)))
    nxt = bf16(rng.uniform(-1.5, 1.5, (n, OBS_DIM)))
    act = np.stack([rng.uniform(0, 0.22, n), rng.uniform(-2, 2, n)],
                   -1).astype(np.float32)
    rew = rng.normal(0, 5, n).astype(np.float32)
    done = (rng.uniform(size=n) < 0.1).astype(np.float32)
    return obs, act, rew, nxt, done


def _jbatch(b):
    from crowdnav_tpu.agents.replay import Transition as JTransition
    return JTransition(*(jnp.asarray(x) for x in b))


def _tbatch(b):
    obs, act, rew, nxt, done = (torch.from_numpy(np.asarray(x).astype(
        np.float32)) for x in b)
    return Transition(obs.to(torch.bfloat16), act, rew,
                      nxt.to(torch.bfloat16), done)


# ---- Adam ----

def test_adam_is_bit_equal_to_optax():
    rng = np.random.default_rng(0)
    p = rng.standard_normal(4096).astype(np.float32)
    tx = optax.adam(3e-4)
    jstate, jp = tx.init(jnp.asarray(p)), jnp.asarray(p)
    adam = Adam(3e-4)
    tstate, tp = adam.init(torch.from_numpy(p)), torch.from_numpy(p.copy())
    for step in range(7):
        g = (rng.standard_normal(p.size)
             * 10.0 ** rng.integers(-6, 2, p.size)).astype(np.float32)
        if step == 3:
            g[:] = 0.0
        u, jstate = tx.update(jnp.asarray(g), jstate, jp)
        jp = optax.apply_updates(jp, u)
        tp, tstate = adam.update(torch.from_numpy(g), tstate, tp)
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(tstate.mu.numpy(),
                                      np.asarray(jstate[0].mu))
        np.testing.assert_array_equal(tstate.nu.numpy(),
                                      np.asarray(jstate[0].nu))
        assert int(tstate.count) == int(jstate[0].count) == step + 1


@pytest.mark.parametrize("count", [1, 2958, 3606, 17320, 17321, 10 ** 6])
def test_adam_bias_corrections_follow_powf(count):
    """``1 - b^count`` as the jitted JAX update computes it (the C
    library's ``powf``), at counts where powf and a float64 power round
    differently, and past the tables' ends. (Eager JAX on a concrete
    scalar count multiplies by squaring instead, which differs at some of
    these counts; the training step is jitted.)"""
    from crowdnav_tpu_torch.agents.optim import bias_correction
    c = torch.tensor(count, dtype=torch.int32)
    for b in (0.9, 0.999):
        want = np.asarray(jax.jit(lambda n: 1 - b ** n)(
            jnp.asarray(count, jnp.int32)))
        assert bias_correction(b, c).numpy() == want


# ---- init, exploration, decay ----

def test_critic_init_statistics_match_flax():
    jagent, tagent = _agents()
    jparams = jax.jit(jagent.init)(jax.random.PRNGKey(0)).critic_params
    tstate = tagent.init_state(0)
    tp = tagent.critic_params(tstate.critic_params)
    for head in ("q1", "q2"):
        for i in range(3):
            jk = np.asarray(jparams["params"][head][f"Dense_{i}"]["kernel"])
            tw = tp[f"{head}.dense{i}.weight"].numpy()
            assert tw.shape == jk.T.shape
            fan_in = jk.shape[0]
            std = 1.0 / np.sqrt(fan_in)
            for w in (jk, tw):
                assert abs(w.std() - std) < 0.12 * std
                assert np.abs(w).max() <= 2.0 * std / 0.87962566 * 1.0001
            assert float(tp[f"{head}.dense{i}.bias"].abs().max()) == 0.0
    np.testing.assert_array_equal(tstate.critic_target.numpy(),
                                  tstate.critic_params.numpy())
    assert int(tstate.update_count) == 0


@pytest.mark.parametrize("kw", [SPECTRUM, dict(explore_uniform_eps=0.3),
                                dict()])
@pytest.mark.parametrize("raw", [(0.0, 0.0), (40.0, -40.0), (40.0, 40.0)])
def test_explore_act_is_bit_equal(kw, raw):
    """The port's exploring act against the JAX package's ``TD3.act``
    arithmetic (``crowdnav_tpu/agents/td3.py:143-166``, jitted) fed the same
    pre-drawn noise, uniform action and epsilon draws: bit-equal. JAX's
    act draws inside its own program, where XLA fuses the draws' arithmetic
    with the noise's, so the draws are passed in on both sides. The
    actor's last layer is set to put out ``raw`` exactly, so that its heads
    (sigmoid 0.5 or 1, tanh 0 or +-1) are exact in both frameworks and the
    comparison holds the exploration itself: Gaussian noise times sigma,
    the epsilon pick (per-env spectrum or annealed scalar), the uniform
    action and the clip. (The actor's own last-ulp rounding is held to its
    bound in ``test_torch_agent.py``.)"""
    n = 256
    jagent, tagent = _agents(**kw)
    cfg = jagent.cfg
    jstate = jax.jit(jagent.init)(jax.random.PRNGKey(3))
    params = jax.tree.map(np.asarray, jstate.actor_params)
    params["params"]["Dense_2"]["kernel"] = np.zeros_like(
        params["params"]["Dense_2"]["kernel"])
    params["params"]["Dense_2"]["bias"] = np.asarray(raw, np.float32)
    jstate = jstate.replace(actor_params=jax.tree.map(jnp.asarray, params),
                            explore_sigma=jnp.float32(0.7),
                            explore_eps=jnp.float32(0.6))

    @jax.jit
    def jax_act(state, obs, noise, unif, u):
        action = jagent.actor.apply(state.actor_params, obs)
        action = action + noise * state.explore_sigma
        if cfg.explore_uniform_eps > 0.0:
            if cfg.explore_eps_spectrum:
                frac = jnp.arange(n, dtype=jnp.float32) / max(n - 1, 1)
                lo_e = cfg.explore_uniform_eps_min or 0.01
                eps = cfg.explore_uniform_eps * (
                    lo_e / cfg.explore_uniform_eps) ** frac
                eps = eps.reshape((n, 1))
            else:
                eps = jnp.clip(state.explore_eps, 0.0, 1.0)
            action = jnp.where(u < eps, unif, action)
        return jnp.clip(action, jnp.array([0.0, -cfg.max_ang_vel]),
                        jnp.array([cfg.max_lin_vel, cfg.max_ang_vel]))

    rng = np.random.default_rng(1)
    obs = rng.uniform(-1, 1, (n, OBS_DIM)).astype(np.float32)
    noise = rng.standard_normal((n, 2)).astype(np.float32)
    unif = np.stack([rng.uniform(0, 0.22, n), rng.uniform(-2, 2, n)],
                    -1).astype(np.float32)
    u = rng.uniform(size=(n, 1)).astype(np.float32)
    want = np.asarray(jax_act(jstate, obs, noise, unif, u))
    got = tagent.act(torch.from_numpy(obs), explore=True,
                     state=to_port(tagent, jstate),
                     draws=[torch.from_numpy(d) for d in (noise, unif, u)])
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [2, 256, 1000, 16384])
def test_eps_spectrum_matches_jax(n):
    """The act's spectrum equals the jitted JAX expression (i / (n-1) as
    a product with the float32 reciprocal), and the greedy cohort mask the
    eager JAX ``greedy_env_mask``; the cohort read off the act's spectrum
    is the same mask."""
    cfg = TD3Config(**SPECTRUM)

    def jspec():
        frac = jnp.arange(n, dtype=jnp.float32) / max(n - 1, 1)
        return 1.0 * (0.05 / 1.0) ** frac

    np.testing.assert_array_equal(eps_spectrum(cfg, n).numpy(),
                                  np.asarray(jax.jit(jspec)()))
    jagent = JTD3(JTD3Config(**SPECTRUM), OBS_DIM)
    tagent = TD3(cfg, OBS_DIM, device="cpu")
    mask = greedy_env_mask(tagent, n)
    np.testing.assert_array_equal(mask.numpy(),
                                  np.asarray(jgreedy_mask(jagent, n)))
    np.testing.assert_array_equal(mask.numpy(),
                                  (eps_spectrum(cfg, n) <= 0.1).numpy())


@pytest.mark.parametrize("steps", [0, 12345, 524288, 999999, 10 ** 6,
                                   3 * 10 ** 7])
def test_decay_sigma_is_bit_equal(steps):
    kw = dict(explore_sigma_min=0.1, explore_decay_steps=1_000_000,
              explore_uniform_eps=1.0, explore_uniform_eps_min=0.05)
    jagent, tagent = _agents(**kw)
    jstate = jagent.decay_sigma(jax.jit(jagent.init)(jax.random.PRNGKey(0)),
                                steps)
    tstate = tagent.decay_sigma(tagent.init_state(0), steps)
    assert tstate.explore_sigma.numpy() == np.asarray(jstate.explore_sigma)
    assert tstate.explore_eps.numpy() == np.asarray(jstate.explore_eps)
    assert tstate.explore_sigma.dtype == torch.float32


def test_td3_state_conversion_round_trips():
    jagent, tagent = _agents()
    jstate = jax.jit(jagent.init)(jax.random.PRNGKey(2))
    # one update so that moments and counts are not zero
    b = _batch(np.random.default_rng(4))
    jstate, _ = jax.jit(jagent.update)(jstate, _jbatch(b),
                                      jax.random.PRNGKey(1))
    arrays = export_module().state_arrays(jax.tree.map(np.asarray, jstate))
    tstate = convert.state_from_arrays(tagent, arrays)
    back = convert.state_to_arrays(tagent, tstate)
    assert set(back) == set(arrays)
    for k, v in arrays.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    assert int(tstate.update_count) == 1
    assert int(tstate.actor_opt.count) == int(tstate.critic_opt.count) == 1
    jback = to_jax(tagent, tstate, jstate)
    assert jax.tree.structure(jback) == jax.tree.structure(jstate)
    for a, b in zip(jax.tree.leaves(jback), jax.tree.leaves(jstate)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ---- the update, within the derived bound ----

def test_update_is_within_the_derived_bound():
    """Five updates (update_count 0..4: policy, non-policy, policy, ...),
    each from the JAX state of the one before, with the JAX-drawn
    smoothing noise: the port's against the JAX package's, through
    ``utils/error_bounds.check_update``; the port's own gradients within
    their bounds, and far inside them."""
    jagent, tagent = _agents()
    jupdate = jax.jit(lambda s, b, n: jagent.update(
        s, b, jax.random.PRNGKey(0), smoothing_noise=n))
    jstate = jax.jit(jagent.init)(jax.random.PRNGKey(7))
    # scale the critics' action inputs up, so that Q depends on the action
    # as much as on the observation (the smoothing and its missing clip,
    # and the actor's gradient, then show)
    def louder(params):
        params = jax.tree.map(np.array, params)
        for head in ("q1", "q2"):
            params["params"][head]["Dense_0"]["kernel"][OBS_DIM:] *= 30.0
        return jax.tree.map(jnp.asarray, params)

    jstate = jstate.replace(critic_params=louder(jstate.critic_params),
                            critic_target=louder(jstate.critic_target))
    rng = np.random.default_rng(11)
    shares = []
    for step in range(5):
        b = _batch(rng)
        noise = np.array(jax.random.normal(jax.random.PRNGKey(100 + step),
                                           (BATCH, 2)))
        tstate = to_port(tagent, jstate)
        new_j, mj = jupdate(jstate, _jbatch(b), jnp.asarray(noise))
        tb = _tbatch(b)
        tn = torch.from_numpy(noise)
        new_t, mt = tagent.update(tstate, tb, smoothing_noise=tn)
        jmetrics = {k: torch.from_numpy(np.array(v)) for k, v in mj.items()}
        shares.append(check_update(tagent, tstate, tb, tn, new_t,
                                   to_port(tagent, new_j), jmetrics))
        assert int(new_t.update_count) == step + 1
        jstate = new_j
    grads = [s[k] for s in shares for k in ("critic_grad", "actor_grad")]
    assert max(grads) < 0.5, shares


def test_update_is_its_documented_composition():
    """``update`` is, bit for bit: the TD target from the target networks,
    the critics' gradient and Adam step, the actor's gradient under the
    updated critic (zero on a non-policy update), the actor's Adam step,
    and the soft target updates on policy updates only."""
    from crowdnav_tpu_torch.utils import numerics as nm
    _, tagent = _agents()
    state = tagent.init_state(3)
    rng = np.random.default_rng(8)
    gen = torch.Generator().manual_seed(2)
    for step in range(3):
        tb = _tbatch(_batch(rng))
        noise = torch.randn((BATCH, 2), generator=gen)
        new, metrics = tagent.update(state, tb, smoothing_noise=noise)
        obs = tb.obs.float()
        y = tagent.td_target(state, tb, noise)
        c_loss, c_grad = tagent.critic_grad(state.critic_params, obs,
                                            tb.action, y)
        critic, c_opt = tagent.critic_tx.update(c_grad, state.critic_opt,
                                                state.critic_params)
        a_loss, a_grad = tagent.actor_grad(state.actor_params, critic, obs)
        policy = step % tagent.cfg.policy_update == 0
        actor, a_opt = tagent.actor_tx.update(
            a_grad * (1.0 if policy else 0.0), state.actor_opt,
            state.actor_params)
        keep, tau = nm.f32(1.0 - tagent.cfg.tau), nm.f32(tagent.cfg.tau)
        want = {"actor_params": actor, "critic_params": critic,
                "actor_target": state.actor_target * keep + actor * tau
                if policy else state.actor_target,
                "critic_target": state.critic_target * keep + critic * tau
                if policy else state.critic_target,
                "actor_opt.mu": a_opt.mu, "actor_opt.nu": a_opt.nu,
                "critic_opt.mu": c_opt.mu, "critic_opt.nu": c_opt.nu}
        for name, w in want.items():
            obj = new
            for part in name.split("."):
                obj = getattr(obj, part)
            assert torch.equal(obj, w), (step, name)
        assert torch.equal(metrics["critic_loss"], c_loss)
        assert torch.equal(metrics["actor_loss"], a_loss)
        assert torch.equal(metrics["q_target_mean"], y.mean())
        assert int(new.update_count) == step + 1
        state = new


def test_update_draws_its_smoothing_noise_from_the_generator():
    _, tagent = _agents()
    state = tagent.init_state(1)
    b = _tbatch(_batch(np.random.default_rng(2)))
    outs = [tagent.update(state, b, gen=torch.Generator().manual_seed(9))
            for _ in range(2)]
    np.testing.assert_array_equal(outs[0][0].critic_params.numpy(),
                                  outs[1][0].critic_params.numpy())
    assert all(np.isfinite(float(v)) for v in outs[0][1].values())
    moved = outs[0][0].actor_params - state.actor_params
    assert float(moved.abs().max()) > 0.0


def test_double_critic_module_equals_functional_form():
    _, tagent = _agents()
    crit = DoubleCritic(OBS_DIM, 2, HIDDEN)
    crit.reset_parameters(torch.Generator().manual_seed(0))
    from crowdnav_tpu_torch.models.networks import critic_apply, flatten
    flat = flatten(crit)
    b = _tbatch(_batch(np.random.default_rng(5), 8))
    q1, q2 = crit(b.obs, b.action)
    f1, f2 = critic_apply(tagent.critic_params(flat), b.obs, b.action)
    assert torch.equal(q1, f1) and torch.equal(q2, f2)
    assert dataclasses.is_dataclass(tagent.init_state(0))


# ---- bfloat16 learner (compute_dtype="bfloat16") ----

@pytest.mark.parametrize("louder", [False, True],
                         ids=["init", "loud_actions"])
def test_bfloat16_update_is_within_the_derived_bound(louder):
    """``compute_dtype="bfloat16"``, as ``tests/test_agents.py``'s
    ``test_td3_bfloat16_compute_dtype`` builds it: parameters and Adam
    float32, actions and Q values float32; four updates, each from the
    JAX state of the one before, held to the JAX package's bfloat16 update
    through ``check_update``, which bounds the networks with every
    bfloat16 rounding of the forward and the backward
    (``error_bounds.lowp``, u = 2^-8) and the rest in float32."""
    jagent, tagent = _agents(compute_dtype="bfloat16")
    jupdate = jax.jit(lambda s, b, n: jagent.update(
        s, b, jax.random.PRNGKey(0), smoothing_noise=n))
    jstate = jax.jit(jagent.init)(jax.random.PRNGKey(9))
    if louder:
        def scale(params):
            params = jax.tree.map(np.array, params)
            for head in ("q1", "q2"):
                params["params"][head]["Dense_0"]["kernel"][OBS_DIM:] *= 30.0
            return jax.tree.map(jnp.asarray, params)
        jstate = jstate.replace(critic_params=scale(jstate.critic_params),
                                critic_target=scale(jstate.critic_target))
    assert all(p.dtype == jnp.float32
               for p in jax.tree.leaves(jstate.actor_params))
    rng = np.random.default_rng(21)
    shares = []
    for step in range(4):
        b = _batch(rng)
        noise = np.array(jax.random.normal(jax.random.PRNGKey(200 + step),
                                           (BATCH, 2)))
        tstate = to_port(tagent, jstate)
        new_j, mj = jupdate(jstate, _jbatch(b), jnp.asarray(noise))
        tb, tn = _tbatch(b), torch.from_numpy(noise)
        new_t, mt = tagent.update(tstate, tb, smoothing_noise=tn)
        assert new_t.actor_params.dtype == torch.float32
        assert all(torch.isfinite(v) for v in mt.values())
        jmetrics = {k: torch.from_numpy(np.array(v)) for k, v in mj.items()}
        shares.append(check_update(tagent, tstate, tb, tn, new_t,
                                   to_port(tagent, new_j), jmetrics))
        jstate = new_j
    grads = [s[k] for s in shares for k in ("critic_grad", "actor_grad")]
    assert max(grads) < 1.0, shares


def test_bfloat16_networks_round_as_flax():
    """The bfloat16 actor and critics against flax's ``Dense(dtype=
    bfloat16)`` modules of the JAX TD3 on the same parameters: within the
    derived bound of the bfloat16 forward (``error_bounds.lowp``), and
    not equal to the float32 networks (the compute dtype is used)."""
    from crowdnav_tpu_torch.utils import error_bounds as eb
    jagent, tagent = _agents(compute_dtype="bfloat16")
    jstate = jax.jit(jagent.init)(jax.random.PRNGKey(3))
    tstate = to_port(tagent, jstate)
    rng = np.random.default_rng(2)
    obs = _batch(rng)[0].astype(np.float32)
    jact = np.asarray(jagent.actor.apply(jstate.actor_params, obs))
    tact = tagent.act(torch.from_numpy(obs), state=tstate).numpy()
    p = {k: v.double().numpy() for k, v in
         tagent.actor_params(tstate.actor_params).items()}
    with eb.lowp(eb.U_BF16):
        sig, th, _ = eb._actor_heads_bnd(p, obs.astype(np.float64))
        bnd = eb._scaled(tagent.cfg, sig, th)
    eb.within("port bf16 actor", tact, bnd)
    eb.within("flax bf16 actor", jact, bnd)
    f32 = TD3(TD3Config(hidden=HIDDEN, batch_size=BATCH), OBS_DIM,
              device="cpu")
    assert not np.array_equal(
        tact, f32.act(torch.from_numpy(obs), state=tstate).numpy())
