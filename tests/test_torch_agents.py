"""The port's DDPG, SAC and DQN (``crowdnav_tpu_torch/agents/ddpg.py``,
``sac.py``, ``dqn.py``) against the JAX package's, on the same
parameters, optimizer states, batches and draws.

What is held bit for bit: the state conversion both ways; DDPG's exploring
act (the OU step, the epsilon mix, the clip; with the actor's heads exact,
as in ``test_torch_td3.py``) and its OU carry; DQN's exploring act where
its greedy part is decided; DQN's ``decay_epsilon``; the target-network
copy at the period boundary.

What is held to a derived bound (``crowdnav_tpu_torch/utils/error_bounds
.py``): the greedy actions, SAC's exploring act, and every update. The two
frameworks sum their matrix products in other orders and evaluate exp,
log, tanh and sigmoid with other library code, so each output is held to
a float32 forward-error bound carried operation by operation; DQN's
greedy action must equal JAX's wherever the top two Q values differ by
more than twice their bound. Each update starts from the JAX state of the
previous one (so differences do not compound) and
``error_bounds.check_update`` holds the port's new state to the JAX
package's: gradients within their bounds, the optimizers' moments within
what those bounds imply, the parameters within what the two sides' own
moments imply, targets and counts."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crowdnav_tpu.agents.ddpg import DDPG as JDDPG
from crowdnav_tpu.agents.ddpg import DDPGConfig as JDDPGConfig
from crowdnav_tpu.agents.dqn import DQN as JDQN
from crowdnav_tpu.agents.dqn import DQNConfig as JDQNConfig
from crowdnav_tpu.agents.replay import Transition as JTransition
from crowdnav_tpu.agents.sac import SAC as JSAC
from crowdnav_tpu.agents.sac import SACConfig as JSACConfig
from crowdnav_tpu_torch.agents.ddpg import DDPG, DDPGConfig
from crowdnav_tpu_torch.agents.dqn import DQN, DQNConfig
from crowdnav_tpu_torch.agents.replay import Transition
from crowdnav_tpu_torch.agents.sac import SAC, SACConfig
from crowdnav_tpu_torch.utils import convert
from crowdnav_tpu_torch.utils import error_bounds as eb
from torch_parity import export_module, state_to_jax, state_to_port

torch.set_num_threads(1)
RISK_DIM, SIMPLE_DIM = 398, 363
HIDDEN, BATCH, N = 64, 64, 256
SPECTRUM = dict(explore_uniform_eps=1.0, explore_uniform_eps_min=0.05,
                explore_eps_spectrum=True)
LO, HI = jnp.array([0.0, -2.0]), jnp.array([0.22, 2.0])


def _t(a):
    return torch.from_numpy(np.array(a))


def _agents(algo, **kw):
    if algo == "ddpg":
        cfg = dict(hidden=HIDDEN, batch_size=BATCH, **kw)
        return (JDDPG(JDDPGConfig(**cfg), RISK_DIM, n_envs=N),
                DDPG(DDPGConfig(**cfg), RISK_DIM, n_envs=N, device="cpu"))
    if algo == "sac":
        cfg = dict(hidden=HIDDEN, value_hidden=HIDDEN, batch_size=BATCH,
                   **kw)
        return (JSAC(JSACConfig(**cfg), SIMPLE_DIM),
                SAC(SACConfig(**cfg), SIMPLE_DIM, device="cpu"))
    cfg = dict(hidden=(HIDDEN, HIDDEN), batch_size=BATCH, **kw)
    return (JDQN(JDQNConfig(**cfg), SIMPLE_DIM),
            DQN(DQNConfig(**cfg), SIMPLE_DIM, device="cpu"))


def _batch(rng, obs_dim, discrete=False, n=BATCH):
    """A replay sample: bfloat16-valued observations, float32 the rest."""
    def bf16(a):
        return np.asarray(jnp.asarray(a, jnp.bfloat16)).astype(np.float32)

    obs = bf16(rng.uniform(-1.5, 1.5, (n, obs_dim)))
    nxt = bf16(rng.uniform(-1.5, 1.5, (n, obs_dim)))
    if discrete:
        act = rng.integers(0, 3, n).astype(np.int32)
    else:
        act = np.stack([rng.uniform(0, 0.22, n), rng.uniform(-2, 2, n)],
                       -1).astype(np.float32)
    rew = rng.normal(0, 5, n).astype(np.float32)
    done = (rng.uniform(size=n) < 0.1).astype(np.float32)
    return obs, act, rew, nxt, done


def _jbatch(b):
    return JTransition(*(jnp.asarray(x) for x in b))


def _tbatch(b):
    return Transition(*(torch.from_numpy(np.asarray(x)) for x in b))


def _metrics(m):
    return {k: torch.from_numpy(np.array(v)) for k, v in m.items()}


def _louder(params, keys, scale):
    """Scale the kernels of ``keys`` (flax layer names)."""
    params = jax.tree.map(np.array, params)
    for k in keys:
        params["params"][k]["kernel"] *= scale
    return jax.tree.map(jnp.asarray, params)


# ---- conversion ----

@pytest.mark.parametrize("algo", ["ddpg", "sac", "dqn"])
def test_state_conversion_round_trips(algo):
    """A JAX state after two updates (moments, counts and the carries
    non-zero) through the exported arrays into the port and back:
    every array bit-equal, the JAX tree rebuilt with its dtypes."""
    jagent, tagent = _agents(algo)
    jstate = jax.jit(jagent.init)(jax.random.PRNGKey(2))
    if algo == "ddpg":
        jstate = jstate.replace(ou_state=jnp.ones((N, 2)) * 0.25)
    rng = np.random.default_rng(4)
    for i in range(2):
        b = _jbatch(_batch(rng, tagent.obs_dim, algo == "dqn"))
        jstate, _ = jax.jit(jagent.update)(jstate, b,
                                           jax.random.PRNGKey(i))
    arrays = export_module().state_arrays(jax.tree.map(np.asarray, jstate))
    tstate = convert.state_from_arrays(tagent, arrays)
    back = convert.state_to_arrays(tagent, tstate)
    assert set(back) == set(arrays)
    for k, v in arrays.items():
        assert back[k].dtype == v.dtype, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    jback = state_to_jax(tagent, tstate, jstate)
    assert jax.tree.structure(jback) == jax.tree.structure(jstate)
    for a, b in zip(jax.tree.leaves(jback), jax.tree.leaves(jstate)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_ddpg_ou_carry_of_another_env_count_starts_at_zero():
    """As the JAX package's ``restore_agent_state``: a training run's OU
    carry (another env count) is dropped for zeros of the agent's."""
    jagent, _ = _agents("ddpg")
    jstate = jax.jit(jagent.init)(jax.random.PRNGKey(0))
    arrays = export_module().state_arrays(jax.tree.map(np.asarray, jstate))
    arrays["ou_state"] = np.ones((2048, 2), np.float32)
    tagent = DDPG(DDPGConfig(hidden=HIDDEN), RISK_DIM, n_envs=8,
                  device="cpu")
    st = convert.state_from_arrays(tagent, arrays)
    assert st.ou_state.shape == (8, 2) and not st.ou_state.any()


# ---- acting ----

@pytest.mark.parametrize("kw", [SPECTRUM, dict(explore_uniform_eps=0.3),
                                dict()])
@pytest.mark.parametrize("raw", [(0.0, 0.0), (40.0, -40.0)])
def test_ddpg_explore_act_is_bit_equal(kw, raw):
    """The port's exploring act against the jitted JAX ``DDPG.act`` with
    its own draws (recomputed from its key and fed to the port): action
    and new OU carry bit-equal. The actor's last layer puts out ``raw``
    exactly, so that its heads are exact in both frameworks."""
    jagent, tagent = _agents("ddpg", **kw)
    jstate = jax.jit(jagent.init)(jax.random.PRNGKey(3))
    params = jax.tree.map(np.array, jstate.actor_params)
    params["params"]["Dense_2"]["kernel"][:] = 0.0
    params["params"]["Dense_2"]["bias"][:] = raw
    rng = np.random.default_rng(1)
    ou = rng.normal(0, 0.5, (N, 2)).astype(np.float32)
    jstate = jstate.replace(actor_params=jax.tree.map(jnp.asarray, params),
                            ou_state=jnp.asarray(ou))
    obs = rng.uniform(-1, 1, (N, RISK_DIM)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    want, jnew = jax.jit(lambda s, o, k: jagent.act(s, o, k, explore=True))(
        jstate, obs, key)
    k_ou, k_eps, k_unif = jax.random.split(key, 3)
    draws = (jax.random.uniform(k_ou, (N, 2)),
             jax.jit(lambda k: jax.random.uniform(
                 k, (N, 2), minval=LO, maxval=HI))(k_unif),
             jax.random.uniform(k_eps, (N, 1)))
    got, tnew = tagent.act(torch.from_numpy(obs), explore=True,
                           state=state_to_port(tagent, jstate),
                           draws=[_t(d) for d in draws])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tnew.ou_state.numpy(),
                                  np.asarray(jnew.ou_state))


def _obs(rng, dim, n=N):
    return rng.uniform(-1.5, 1.5, (n, dim)).astype(np.float32)


@pytest.mark.parametrize("algo", ["ddpg", "sac"])
def test_greedy_act_is_within_the_derived_bound(algo):
    """Greedy actions of both frameworks within the float32 forward-error
    bound of the float64 policy (the actor with its heads scaled up, so
    that they leave their saturated ends), clipped to the box."""
    jagent, tagent = _agents(algo)
    jstate = jax.jit(jagent.init)(jax.random.PRNGKey(2))
    heads = ["Dense_2"] if algo == "ddpg" else ["Dense_2", "Dense_3"]
    jstate = jstate.replace(actor_params=_louder(jstate.actor_params,
                                                 heads, 300.0))
    obs = _obs(np.random.default_rng(0), tagent.obs_dim)
    act = jax.jit(lambda s, o: jagent.act(s, o, jax.random.PRNGKey(0),
                                          explore=False))(jstate, obs)
    want = np.asarray(act[0] if algo == "ddpg" else act)
    tstate = state_to_port(tagent, jstate)
    got = tagent.act(torch.from_numpy(obs), explore=False, state=tstate)
    got = (got[0] if algo == "ddpg" else got).numpy()
    ap = eb._bparams(tagent, "actor", tstate.actor_params)
    if algo == "ddpg":
        sig, th, _ = eb._actor_heads_bnd(ap, obs)
        out = eb._scaled(tagent.cfg, sig, th)
    else:
        fw = eb.sac_sample_bound(tagent, ap, obs, np.zeros((N, 2)))
        a = eb.btanh(fw["mean"])
        out = eb.bconcat([eb.bmul(eb.bsigmoid(a[:, 0:1]), eb._f(0.22)),
                          eb.bmul(eb.btanh(a[:, 1:2]), eb._f(2.0))])
    out = eb.bclip(out, np.array([0.0, -2.0]), np.array([0.22, 2.0]))
    for side in (got, want):
        eb.within(f"{algo} greedy", side, out)
    assert (np.abs(out.v[:, 0] - 0.11) > 0.05).any()   # heads unsaturated
    # the module the evaluate driver loads equals the state's actor
    tagent.sync_actor(tstate)
    module = tagent.act(torch.from_numpy(obs))
    np.testing.assert_array_equal(module.numpy(), got)


def test_sac_explore_act_is_within_the_derived_bound():
    """SAC's exploring act (``squash(mean + std * normal)``, clipped) with
    JAX's normal draw, both frameworks within the bound of the float64
    sample."""
    jagent, tagent = _agents("sac")
    jstate = jax.jit(jagent.init)(jax.random.PRNGKey(4))
    jstate = jstate.replace(actor_params=_louder(
        jstate.actor_params, ["Dense_2", "Dense_3"], 200.0))
    obs = _obs(np.random.default_rng(3), SIMPLE_DIM)
    key = jax.random.PRNGKey(9)
    want = np.asarray(jax.jit(lambda s, o, k: jagent.act(
        s, o, k, explore=True))(jstate, obs, key))
    noise = np.array(jax.random.normal(key, (N, 2)))
    tstate = state_to_port(tagent, jstate)
    got = tagent.act(torch.from_numpy(obs), explore=True, state=tstate,
                     draws=torch.from_numpy(noise)).numpy()
    fw = eb.sac_sample_bound(tagent, eb._bparams(tagent, "actor",
                                                 tstate.actor_params),
                             obs, noise)
    out = eb.bclip(fw["action"], np.array([0.0, -2.0]),
                   np.array([0.22, 2.0]))
    for side in (got, want):
        eb.within("sac explore", side, out)


def test_dqn_act_matches_jax():
    """Greedy: the first argmax equals JAX's wherever the top two Q values
    differ by more than twice their bound (the inputs hold such rows, and
    rows with exact ties, where both take the first index). Exploring:
    JAX's draws from its key, the same action on every decided row."""
    jagent, tagent = _agents("dqn")
    jstate = jax.jit(jagent.init)(jax.random.PRNGKey(1))
    jstate = jstate.replace(epsilon=jnp.float32(0.4))
    rng = np.random.default_rng(2)
    obs = _obs(rng, SIMPLE_DIM)
    obs[:8] = 0.0           # Q = the last bias for every action: a tie
    params = jax.tree.map(np.array, jstate.params)
    params["params"]["Dense_2"]["bias"][:] = 0.5
    jstate = jstate.replace(params=jax.tree.map(jnp.asarray, params))
    tstate = state_to_port(tagent, jstate)
    q, _ = eb.bmlp(eb._bparams(tagent, "q", tstate.params), "", obs,
                   tagent.n_layers)
    top = np.sort(q.v, -1)
    decided = top[:, -1] - top[:, -2] > 2 * q.e.max(-1)
    assert decided.sum() >= N // 2 and (~decided).any()
    greedy_j = np.asarray(jax.jit(lambda s, o: jagent.act(
        s, o, None, explore=False))(jstate, obs))
    greedy_t = tagent.act(torch.from_numpy(obs), state=tstate).numpy()
    np.testing.assert_array_equal(greedy_t[decided], greedy_j[decided])
    np.testing.assert_array_equal(greedy_t[:8], 0)
    np.testing.assert_array_equal(greedy_j[:8], 0)
    key = jax.random.PRNGKey(6)
    want = np.asarray(jax.jit(lambda s, o, k: jagent.act(
        s, o, k, explore=True))(jstate, obs, key))
    k1, k2 = jax.random.split(key)
    draws = (_t(jax.random.randint(k1, (N,), 0, 3)),
             _t(jax.random.uniform(k2, (N,))))
    got = tagent.act(torch.from_numpy(obs), explore=True, state=tstate,
                     draws=draws).numpy()
    assert got.dtype == np.int32
    rand = draws[1].numpy() < np.float32(0.4)
    assert 0 < rand.sum() < N
    np.testing.assert_array_equal(got[decided | rand], want[decided | rand])


@pytest.mark.parametrize("eps", [1.0, 0.3, 0.05])
def test_dqn_decay_epsilon_is_bit_equal(eps):
    jagent, tagent = _agents("dqn")
    jstate = jax.jit(jagent.init)(jax.random.PRNGKey(0)).replace(
        epsilon=jnp.float32(eps))
    tstate = state_to_port(tagent, jstate)
    for _ in range(40):
        jstate = jagent.decay_epsilon(jstate)
        tstate = tagent.decay_epsilon(tstate)
        assert tstate.epsilon.numpy() == np.asarray(jstate.epsilon)
    assert tstate.epsilon.dtype == torch.float32


# ---- the update, within the derived bound ----

def _updates(algo, jagent, tagent, jstate, steps, seed, draw_noise):
    """``steps`` updates, each from the JAX state of the one before: the
    port's against the JAX package's through ``check_update``."""
    jupdate = jax.jit(jagent.update)
    rng = np.random.default_rng(seed)
    shares = []
    for step in range(steps):
        b = _batch(rng, tagent.obs_dim, algo == "dqn")
        key = jax.random.PRNGKey(100 + step)
        tstate = state_to_port(tagent, jstate)
        new_j, mj = jupdate(jstate, _jbatch(b), key)
        kw, noise = {}, None
        if draw_noise:
            noise = _t(jax.random.normal(key, (BATCH, 2)))
            kw = {"noise": noise}
        new_t, _ = tagent.update(tstate, _tbatch(b), **kw)
        shares.append(eb.check_update(tagent, tstate, _tbatch(b), noise,
                                      new_t, state_to_port(tagent, new_j),
                                      _metrics(mj)))
        jstate = new_j
    return jstate, shares


def _other(params, seed, scale=0.05):
    """``params`` moved by a relative ``scale`` of noise: a target network
    that is not the online one."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: jnp.asarray(
        a * (1 + scale * rng.standard_normal(a.shape)).astype(np.float32)),
        params)


def _constant(params, value):
    """A network that puts out ``value`` exactly in both frameworks: zero
    kernels, zero hidden biases, the output bias ``value``."""
    params = jax.tree.map(np.array, params)
    layers = sorted(params["params"])
    for k in layers:
        params["params"][k]["kernel"][:] = 0.0
        params["params"][k]["bias"][:] = 0.0
    params["params"][layers[-1]]["bias"][:] = value
    return jax.tree.map(jnp.asarray, params)


@pytest.mark.parametrize("case", ["loud", "bootstrap"])
def test_ddpg_update_is_within_the_derived_bound(case):
    """Four updates. ``loud``: the targets differ from the online networks,
    the critic puts out Q values of the rewards' size and takes steps of
    3e-2, so that the critic the actor's step uses shows. ``bootstrap``:
    the target critic puts out 50 exactly, so that the bootstrap and its
    discount are held to the rounding of a few operations."""
    jagent, tagent = _agents("ddpg", critic_lr=3e-2)
    jstate = jax.jit(jagent.init)(jax.random.PRNGKey(7))
    # the critic's action inputs louder, so that Q depends on the action
    # and the actor's gradient shows
    crit = jax.tree.map(np.array, jstate.critic_params)
    crit["params"]["Dense_0"]["kernel"][RISK_DIM:] *= 30.0
    if case == "loud":
        crit["params"]["Dense_2"]["kernel"] *= 100.0
    crit = jax.tree.map(jnp.asarray, crit)
    target = _other(crit, 1) if case == "loud" else _constant(crit, 50.0)
    jstate = jstate.replace(
        critic_params=crit, critic_target=target,
        actor_target=_other(jstate.actor_params, 2),
        ou_state=jnp.full((N, 2), 0.3))
    jstate, shares = _updates("ddpg", jagent, tagent, jstate, 4, 11, False)
    assert int(jstate.actor_opt[0].count) == 4
    grads = [s[k] for s in shares for k in ("critic_grad", "actor_grad")]
    assert max(grads) < 0.5, shares


@pytest.mark.parametrize("case", ["loud", "regularized"])
def test_sac_update_is_within_the_derived_bound(case):
    """Four updates with JAX's normal draw of each update's key, reused
    for the new action and the policy loss's resample (the JAX package's
    single key). ``loud``: the value target differs from the value
    network, and the soft-Q network puts out values of the rewards' size.
    ``regularized``: the mean, log-std and z weights at 1 (their terms
    then show), and a value target that puts out 10 exactly."""
    kw = {} if case == "loud" else dict(mean_lambda=1.0, std_lambda=1.0,
                                        z_lambda=1.0)
    jagent, tagent = _agents("sac", **kw)
    jstate = jax.jit(jagent.init)(jax.random.PRNGKey(8))
    value = _louder(jstate.value_params, ["Dense_2"], 30.0)
    jstate = jstate.replace(actor_params=_louder(
        jstate.actor_params, ["Dense_2", "Dense_3"], 30.0),
        value_params=value)
    if case == "loud":
        jstate = jstate.replace(
            soft_q_params=_louder(jstate.soft_q_params, ["Dense_2"], 100.0),
            value_target=_other(value, 3, 0.3))
    else:
        jstate = jstate.replace(value_target=_constant(value, 10.0))
    jstate, shares = _updates("sac", jagent, tagent, jstate, 4, 12, True)
    assert int(jstate.actor_opt[0].count) == 4
    grads = [s[k] for s in shares
             for k in ("q_grad", "value_grad", "policy_grad")]
    assert max(grads) < 0.5, shares


@pytest.mark.parametrize("period", [2, 10_000])
def test_dqn_update_is_within_the_derived_bound(period):
    """Five updates; with a period of 2 the target network is copied at
    steps 2 and 4 (exactly, on both sides), with the default never."""
    jagent, tagent = _agents("dqn", target_update_period=period)
    jstate = jax.jit(jagent.init)(jax.random.PRNGKey(9))
    start = np.asarray(jax.tree.leaves(jstate.target_params)[0])
    jstate, shares = _updates("dqn", jagent, tagent, jstate, 5, 13, False)
    assert int(jstate.step) == 5
    moved = not np.array_equal(
        np.asarray(jax.tree.leaves(jstate.target_params)[0]), start)
    assert moved == (period == 2)
    assert max(s["grad"] for s in shares) < 0.5, shares


@pytest.mark.parametrize("algo", ["ddpg", "sac", "dqn"])
def test_update_draws_from_the_generator_and_moves(algo):
    """Without given draws, SAC draws its normal from ``gen``; every
    agent's update moves its parameters and gives finite metrics."""
    _, tagent = _agents(algo)
    state = tagent.init_state(1)
    b = _tbatch(_batch(np.random.default_rng(2), tagent.obs_dim,
                       algo == "dqn"))
    outs = [tagent.update(state, b, gen=torch.Generator().manual_seed(9))
            for _ in range(2)]
    field = "params" if algo == "dqn" else "actor_params"
    np.testing.assert_array_equal(getattr(outs[0][0], field).numpy(),
                                  getattr(outs[1][0], field).numpy())
    assert set(outs[0][1]) == set(tagent.METRICS)
    assert all(np.isfinite(float(v)) for v in outs[0][1].values())
    moved = getattr(outs[0][0], field) - getattr(state, field)
    assert float(moved.abs().max()) > 0.0
