"""The port's tabular learners (``crowdnav_tpu_torch/agents/tabular.py``)
and their driver (``drivers/train_tabular.py``) against the JAX package's
``QLearning``, ``Sarsa``, ``discretize_state`` and ``make_rollout``, on
the same tables, indices and draws: bit for bit. The JAX learners run
jitted, their batch updates inside a ``lax.scan`` over envs as the JAX
driver runs them, where XLA fuses ``r + gamma * q`` and
``old + alpha * (value - old)`` into multiply-adds."""
import csv
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crowdnav_tpu.agents import tabular as jtab
from crowdnav_tpu.drivers import train_tabular as jdrv
from crowdnav_tpu.envs import SimpleEnv, make_config
from crowdnav_tpu_torch.agents import tabular as ttab
from crowdnav_tpu_torch.drivers import train_tabular as tdrv
from crowdnav_tpu_torch.envs import config as tcfg
from crowdnav_tpu_torch.envs.simple_env import SimpleEnv as TSimpleEnv
from test_torch_simple_env import port_env
from torch_parity import env_state_to_torch

torch.set_num_threads(1)
ALGOS = {"qlearn": (jtab.QLearning, ttab.QLearning),
         "sarsa": (jtab.Sarsa, ttab.Sarsa)}


def test_discretize_state_matches_jax():
    rng = np.random.default_rng(0)
    dtg = np.concatenate([rng.uniform(-0.5, 3.5, 4096),
                          jtab._DIST_EDGES]).astype(np.float32)
    htg = np.concatenate([rng.uniform(-3.5, 3.5, 4096),
                          jtab._RAD_EDGES[:30].repeat(1),
                          np.zeros(0)]).astype(np.float32)
    htg = np.resize(htg, dtg.shape).astype(np.float32)
    ref = np.asarray(jax.jit(jtab.discretize_state)(dtg, htg))
    got = ttab.discretize_state(torch.from_numpy(dtg), torch.from_numpy(htg))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert got.min() >= 0 and got.max() < ttab.N_STATES


def _table(rng, visited_share=0.6):
    q = rng.normal(0, 50, (ttab.N_STATES, 3)).astype(np.float32)
    visited = rng.uniform(size=q.shape) < visited_share
    q = np.where(visited, q, 0.0).astype(np.float32)
    return q, visited


def _jstate(q, visited, eps):
    return jtab.TabularState(q=jnp.asarray(q), epsilon=jnp.float32(eps),
                             visited=jnp.asarray(visited))


def _tstate(q, visited, eps):
    return ttab.TabularState(q=torch.from_numpy(q.copy()),
                             epsilon=torch.tensor(np.float32(eps)),
                             visited=torch.from_numpy(visited.copy()))


@pytest.mark.parametrize("explore", [False, True])
def test_act_matches_jax(explore):
    """Epsilon-greedy with the magnitude-noise tie-break, JAX's draws
    (``k1``, ``k2`` of each env's key) passed in."""
    rng = np.random.default_rng(1)
    q, visited = _table(rng)
    # rows with ties: all-zero rows and a repeated maximum
    q[:40] = 0.0
    q[40:80, 1] = q[40:80, 0]
    algo_j = jtab.QLearning(jtab.TabularConfig())
    algo_t = ttab.QLearning(ttab.TabularConfig(), device="cpu")
    n = 512
    s = rng.integers(0, ttab.N_STATES, n)
    s[:64] = np.arange(64) + 10
    keys = jax.random.split(jax.random.PRNGKey(5), n)
    js = _jstate(q, visited, 0.5)
    ref = jax.jit(jax.vmap(lambda si, k: algo_j.act(js, si, k,
                                                    explore=explore)))(
        jnp.asarray(s), keys)

    def draws(k):
        k1, k2 = jax.random.split(k)
        return jax.random.uniform(k1, (3,)), jax.random.uniform(k2, ())
    u1, u2 = jax.jit(jax.vmap(draws))(keys)
    got = algo_t.act(_tstate(q, visited, 0.5), torch.from_numpy(s),
                     explore=explore,
                     draws=(torch.from_numpy(np.array(u1)),
                            torch.from_numpy(np.array(u2))))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("algo", ["qlearn", "sarsa"])
def test_batch_updates_match_jax_scan(algo):
    """A batch of updates with repeated entries and chained reads (an
    env's next state is another's state), applied in env order as the JAX
    driver's ``lax.scan`` over envs, where ``live``; first visits store
    the reward."""
    jcls, tcls = ALGOS[algo]
    algo_j = jcls(jtab.TabularConfig())
    algo_t = tcls(ttab.TabularConfig(), device="cpu")
    rng = np.random.default_rng(2)
    q, visited = _table(rng, 0.3)
    n = 256
    s = rng.integers(0, 60, n)
    a = rng.integers(0, 3, n).astype(np.int32)
    s2 = np.roll(s, 1)
    a2 = rng.integers(0, 3, n).astype(np.int32)
    r = rng.normal(0, 3, n).astype(np.float32)
    r[::7] = 200.0
    live = rng.uniform(size=n) < 0.8

    def scan(tab, rows):
        def upd(tab, row):
            si, ai, ri, s2i, a2i, li = row

            def do(t):
                if algo == "sarsa":
                    return algo_j.update(t, si, ai, ri, s2i, a2i)
                return algo_j.update(t, si, ai, ri, s2i)
            return jax.lax.cond(li, do, lambda t: t, tab), None
        return jax.lax.scan(upd, tab, rows)[0]

    ref = jax.jit(scan)(_jstate(q, visited, 0.9),
                        tuple(jnp.asarray(x) for x in (s, a, r, s2, a2,
                                                       live)))
    got = algo_t.update_batch(_tstate(q, visited, 0.9),
                              *(torch.from_numpy(x) for x in
                                (s, a.astype(np.int64), r, s2,
                                 a2.astype(np.int64), live)))
    np.testing.assert_array_equal(got.visited.numpy(),
                                  np.asarray(ref.visited))
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(ref.q))
    assert (got.q.numpy() != q).sum() > 100


def test_decay_epsilon_matches_jax():
    algo_j = jtab.QLearning(jtab.TabularConfig())
    algo_t = ttab.QLearning(ttab.TabularConfig(), device="cpu")
    js, ts = algo_j.init(), algo_t.init()
    for _ in range(3000):
        js, ts = algo_j.decay_epsilon(js), algo_t.decay_epsilon(ts)
        assert np.float32(js.epsilon) == np.float32(ts.epsilon.item())
    assert ts.epsilon.item() == np.float32(0.05)


def _jax_step_draws(key, n, bank_size):
    """The draws of one step of the JAX driver's ``one_step`` from its
    carry key: ``(next key, port draws)``."""
    key, k_act, k_bank = jax.random.split(key, 3)

    def env(k):
        k1, k2 = jax.random.split(k)
        return jax.random.uniform(k1, (3,)), jax.random.uniform(k2, ())
    u1, u2 = jax.vmap(env)(jax.random.split(k_act, n))
    d = {"act": (torch.from_numpy(np.array(u1)),
                 torch.from_numpy(np.array(u2)))}
    if bank_size:
        k_idx, _ = jax.random.split(k_bank)
        d["bank_idx"] = torch.from_numpy(np.array(
            jax.random.randint(k_idx, (n,), 0, bank_size)))
    return key, d


@pytest.mark.parametrize("algo,jitter,learning", [
    ("qlearn", 0.0, True), ("sarsa", 1.0, True), ("qlearn", 1.0, False)])
def test_rollout_chunk_matches_jax(algo, jitter, learning):
    """A chunk of the driver's rollout (the discrete simple env, the reset
    bank, epsilon-greedy acts and the online updates) against the JAX
    driver's jitted ``make_rollout`` from the same carry, with JAX's
    draws: table, visits, observations and actions bit for bit, the same
    episode counts."""
    n, chunk, bank_size = 16, 40, 32
    jc = make_config("crowd_none", "static", max_steps=12, jitter=jitter)
    tc = tcfg.make_config("crowd_none", "static", max_steps=12,
                          jitter=jitter)
    jenv = SimpleEnv(jc)
    tenv = port_env(TSimpleEnv, jenv, tc)
    jcls, tcls = ALGOS[algo]
    algo_j = jcls(jtab.TabularConfig())
    algo_t = tcls(ttab.TabularConfig(), device="cpu")
    key = jax.random.PRNGKey(3)
    key, k_env, k_bank = jax.random.split(key, 3)
    reset = jax.jit(jax.vmap(jenv.reset))
    js, jobs = reset(jax.random.split(k_env, n))
    bank = reset(jax.random.split(k_bank, bank_size)) if jitter else None
    rng = np.random.default_rng(4)
    q, visited = _table(rng, 0.2)
    tab = _jstate(q, visited, 0.9)
    actions = jnp.asarray(rng.integers(0, 3, n).astype(np.int32))
    stats = (jnp.zeros(n), jnp.zeros(n, jnp.int32), jnp.zeros((), jnp.int32),
             jnp.zeros((), jnp.int32), jnp.zeros(()),
             jnp.zeros((), jnp.int32))
    rollout = jdrv.make_rollout(jenv, algo_j, chunk, learning=learning,
                                bank=bank)
    out = rollout((js, jobs, actions, tab, key, stats))
    tbank = None
    if bank is not None:
        tbank = (env_state_to_torch(bank[0]),
                 torch.from_numpy(np.array(bank[1])))
    carry = tdrv.Carry(env_state_to_torch(js),
                       torch.from_numpy(np.array(jobs)),
                       torch.from_numpy(np.array(actions)),
                       _tstate(q, visited, 0.9), torch.zeros(n),
                       torch.zeros(n, dtype=torch.int64))
    for _ in range(chunk):
        key, d = _jax_step_draws(key, n, bank_size if jitter else 0)
        carry = tdrv.rollout_step(tenv, algo_t, carry, learning, None,
                                  tbank, d)
    j_states, j_obs, j_act, j_tab, _, j_stats = out
    np.testing.assert_array_equal(carry.obs.numpy(), np.asarray(j_obs))
    np.testing.assert_array_equal(carry.actions.numpy(), np.asarray(j_act))
    np.testing.assert_array_equal(carry.table.visited.numpy(),
                                  np.asarray(j_tab.visited))
    np.testing.assert_array_equal(carry.table.q.numpy(),
                                  np.asarray(j_tab.q))
    assert carry.done == int(j_stats[2]) > 0
    assert carry.successes == int(j_stats[3])
    assert carry.step_sum == int(j_stats[5])
    if learning:
        assert (carry.table.q.numpy() != q).any()


@pytest.mark.parametrize("algo", ["qlearn", "sarsa"])
def test_train_tabular_driver_runs_on_cpu(algo, tmp_path, capsys):
    """The driver's tiny CPU run: one JSON line a chunk, the CSV in the
    reference's schema, the table (readable by the JAX package's
    ``load_table``) and ``run_config.json``; then a greedy evaluation
    from that table."""
    out = str(tmp_path)
    tdrv.main(["--algo", algo, "--n-envs", "8", "--chunk", "20",
               "--env-steps", "480", "--max-steps", "30", "--jitter", "1.0",
               "--outdir", out, "--device", "cpu"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    assert len(lines) == 3 and lines[-1]["epsilon"] < 0.9
    with open(os.path.join(out, f"{algo}_training.csv")) as fp:
        rows = list(csv.reader(fp))
    assert len(rows) == 1 + 3
    tab = jtab.load_table(os.path.join(out, f"{algo}_qtable"))
    assert np.asarray(tab.visited).any()
    with open(os.path.join(out, "run_config.json")) as fp:
        assert json.load(fp)["algo"] == algo
    tdrv.main(["--algo", algo, "--n-envs", "8", "--chunk", "20",
               "--env-steps", "160", "--max-steps", "30", "--no-learning",
               "--load", os.path.join(out, f"{algo}_qtable"),
               "--outdir", out, "--device", "cpu"])
    assert os.path.isfile(os.path.join(out, f"{algo}_training_test.csv"))


def test_tables_cross_between_the_packages(tmp_path):
    """A table the JAX package saved loads into the port unchanged, and
    the port's saved table into the JAX package."""
    rng = np.random.default_rng(6)
    q, visited = _table(rng)
    jtab.save_table(str(tmp_path / "j"), _jstate(q, visited, 0.3))
    got = ttab.load_table(str(tmp_path / "j"), device="cpu")
    np.testing.assert_array_equal(got.q.numpy(), q)
    np.testing.assert_array_equal(got.visited.numpy(), visited)
    assert got.epsilon.item() == np.float32(0.3)
    ttab.save_table(str(tmp_path / "t"), got)
    back = jtab.load_table(str(tmp_path / "t"))
    np.testing.assert_array_equal(np.asarray(back.q), q)
    np.testing.assert_array_equal(np.asarray(back.visited), visited)
