"""The port's sharded learner (``crowdnav_tpu_torch/parallel/mesh.py``,
``distributed.py``, the learners' ``grad_reduce``) on two gloo ranks on
the CPU, two worker processes that write their states back to this one.

- Each learner's 2-rank update against the JAX package's ``shard_map``
  update on ``make_mesh(2)`` (the recipe of ``test_sharded_learner.py``:
  two single-device warm-up updates, then one compared update of the same
  global batch and per-shard draws): the port's state within
  ``error_bounds.check_update``'s derived bound of JAX's (the gradients
  are the sum of the per-shard local-mean gradients over the shard count
  on both sides, in other summation orders), and the two ranks' states
  bit-equal.
- A 2-rank ``ShardedTrainer`` chunk under injected draws (every action
  the epsilon-uniform draw, so that no learner output moves the rollout):
  each rank's rows bit-equal to the 1-rank rollout's, its replay ring
  filled with its own envs' rows, the drained statistics the 1-rank
  run's.
- The same chunk into a ring that it wraps: each rank's ring has the
  1-rank ring's (and JAX's) block count, holds its rows of the 1-rank
  ring's last blocks, and samples over all of them, as a shard of JAX's
  sharded ring does.
- A 2-rank learning chunk drawing from the ranks' own streams: every
  update bit-equal on the two ranks and within ``check_update`` of the
  1-rank update of the concatenated global batch.
- ``drivers/train --multihost --device cpu`` as two processes, then
  ``--resume`` through ``--n-devices 2``.

Every multi-process run has its own time limit (``communicate(timeout)``)
and kills all its workers when it is reached."""
import json
import os
import socket
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from crowdnav_tpu.agents.ddpg import DDPG as JDDPG
from crowdnav_tpu.agents.ddpg import DDPGConfig as JDDPGConfig
from crowdnav_tpu.agents.dqn import DQN as JDQN
from crowdnav_tpu.agents.dqn import DQNConfig as JDQNConfig
from crowdnav_tpu.agents.replay import ReplayBuffer as JReplayBuffer
from crowdnav_tpu.agents.replay import Transition as JTransition
from crowdnav_tpu.agents.sac import SAC as JSAC
from crowdnav_tpu.agents.sac import SACConfig as JSACConfig
from crowdnav_tpu.agents.td3 import TD3 as JTD3
from crowdnav_tpu.agents.td3 import TD3Config as JTD3Config
from crowdnav_tpu.parallel import make_mesh as jmake_mesh
from crowdnav_tpu_torch.agents.replay import Transition
from crowdnav_tpu_torch.drivers.train import CONFIG_CLS, make_agent
from crowdnav_tpu_torch.envs import world
from crowdnav_tpu_torch.envs.config import make_config
from crowdnav_tpu_torch.envs.crowd_env import CrowdEnv
from crowdnav_tpu_torch.parallel import distributed, mesh
from crowdnav_tpu_torch.parallel.runtime import (StepDraws, Trainer,
                                                 TrainerConfig)
from crowdnav_tpu_torch.utils import checkpoint as tckpt
from crowdnav_tpu_torch.utils.error_bounds import check_update
from crowdnav_tpu_torch.utils.tree import tree_leaves
from torch_parity import state_to_port

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALGOS = ("td3", "ddpg", "sac", "dqn")
OBS, HIDDEN, BATCH, OU_ENVS = 24, 32, 64, 8
TIMEOUT = 300
# the trainer cases: 8 envs, 4 a rank
N = 8
ROLL = dict(world="crowd_dense", behavior="crowd", jitter=1.0, max_steps=5)
ROLL_AGENT = dict(hidden=HIDDEN, batch_size=16, buffer_size=256,
                  explore_uniform_eps=1.0)
ROLL_TCFG = dict(n_envs=N, rollout_chunk=9, learn_start=10 ** 9,
                 reset_bank=N)
# the rollout into a ring of ceil(20 / 8) = 3 blocks, which it wraps
WRAP_AGENT = dict(ROLL_AGENT, buffer_size=20)
SAMPLES = 4096
LEARN_AGENT = dict(hidden=HIDDEN, batch_size=16, buffer_size=256,
                   explore_uniform_eps=1.0, explore_uniform_eps_min=0.05,
                   explore_eps_spectrum=True)
LEARN_TCFG = dict(n_envs=N, rollout_chunk=4, learn_start=16,
                  updates_per_step=2, reset_bank=N)

WORKER = textwrap.dedent("""
    import dataclasses, sys
    import torch
    torch.set_num_threads(1)
    rank, port, job_path, out_path = (int(sys.argv[1]), sys.argv[2],
                                      sys.argv[3], sys.argv[4])
    from crowdnav_tpu_torch.drivers.train import CONFIG_CLS, make_agent
    from crowdnav_tpu_torch.envs.config import make_config
    from crowdnav_tpu_torch.envs.crowd_env import CrowdEnv
    from crowdnav_tpu_torch.parallel import distributed
    from crowdnav_tpu_torch.parallel.mesh import ShardedTrainer, make_mesh
    from crowdnav_tpu_torch.parallel.runtime import TrainerConfig

    distributed.init_multihost("localhost:" + port, 2, rank, device="cpu")
    job = torch.load(job_path, weights_only=False)
    m = make_mesh(2)
    out = {"summary": distributed.process_summary(), "updates": {}}

    def agent_of(algo, cfg, obs_dim, n_envs):
        return make_agent(algo, CONFIG_CLS[algo](**cfg), obs_dim, n_envs,
                          "cpu")[0]

    for algo, case in job["updates"].items():
        agent = agent_of(algo, case["cfg"], case["obs_dim"], case["n_envs"])
        rows = slice(rank * case["local"], (rank + 1) * case["local"])
        batch = type(case["batch"])(*(x[rows] for x in case["batch"]))
        kw = {}
        if case["draw"] is not None:
            kw[case["draw"]] = case["noise"][rank]
        out["updates"][algo] = agent.update(case["state"], batch,
                                            grad_reduce=m.mean, **kw)

    def trainer_of(algo, env_kw, agent_kw, tcfg_kw):
        env_kw = dict(env_kw)
        cfg = make_config(env_kw.pop("world"), env_kw.pop("behavior"),
                          **env_kw)
        env = CrowdEnv(cfg, device="cpu")
        agent = agent_of(algo, agent_kw, env.obs_dim, tcfg_kw["n_envs"])
        return ShardedTrainer(env, agent, TrainerConfig(**tcfg_kw), m)

    roll = job["rollout"]
    tr = trainer_of("td3", roll["env"], roll["agent"], roll["tcfg"])
    st = tr.init(0)
    st = tr.rollout_chunk(st, [d[rank] for d in roll["draws"]])
    summary, st = tr.drain_stats(st)
    out["rollout"] = {"obs": st.obs, "env_states": st.env_states,
                      "replay": st.replay, "summary": summary,
                      "rows": tr.rows, "learning_open": st.learning_open}

    tr = trainer_of("td3", roll["env"], job["wrap_agent"], roll["tcfg"])
    st = tr.rollout_chunk(tr.init(0), [d[rank] for d in roll["draws"]])
    out["wrap"] = {"replay": st.replay, "n_blocks": tr.buffer.n_blocks,
                   "capacity": tr.buffer.capacity,
                   "sample_idx": tr.buffer.sample_indices(
                       st.replay, job["samples"],
                       torch.Generator().manual_seed(rank))}

    learn = job["learning"]
    for algo in ("td3", "ddpg"):
        agent_kw = dict(learn["agent"])
        if algo == "ddpg":
            agent_kw.pop("explore_uniform_eps_min")
        tr = trainer_of(algo, learn["env"], agent_kw, learn["tcfg"])
        calls = []
        update = tr.agent.update

        def recorded(state, batch, **kw):
            if algo == "td3" and kw.get("smoothing_noise") is None:
                # the draw TD3.update makes from the stream, made here
                kw["smoothing_noise"] = torch.randn(
                    (batch.obs.shape[0], 2), generator=kw["gen"])
            new, metrics = update(state, batch, **kw)
            calls.append((state, batch, kw.get("smoothing_noise"), new,
                          metrics))
            return new, metrics

        tr.agent.update = recorded
        st = tr.init(0)
        start = st.agent_state
        st = tr.rollout_chunk(st)
        summary, st = tr.drain_stats(st)
        out["learning_" + algo] = {
            "calls": calls, "start": start, "final": st.agent_state,
            "summary": summary, "env_rows": tr.agent.env_rows,
            "greedy_mask": tr.greedy_mask, "gen_state": st.gen.get_state()}
    torch.save(out, out_path)
    distributed.shutdown()
    print("WORKER_OK", rank, flush=True)
""")


def _free_port() -> str:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return str(s.getsockname()[1])


def _env():
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (ROOT, env.get("PYTHONPATH")) if p)
    env["OMP_NUM_THREADS"] = "1"
    return env


def _run_ranks(argvs, timeout=TIMEOUT):
    """Start one process per argv, wait for all with one time limit;
    kill every one of them if it is reached. ``[(code, output)]``."""
    procs = [subprocess.Popen(a, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              env=_env(), cwd=ROOT) for a in argvs]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [(p.returncode, o) for p, o in zip(procs, outs)]


# ---- the updates: JAX's shard_map against the port's two ranks ----

def _cfg(algo):
    if algo == "sac":
        return dict(hidden=HIDDEN, value_hidden=HIDDEN, batch_size=BATCH)
    if algo == "dqn":
        return dict(hidden=(HIDDEN, HIDDEN), batch_size=BATCH)
    return dict(hidden=HIDDEN, batch_size=BATCH)


def _jax_agent(algo):
    cfg = _cfg(algo)
    if algo == "td3":
        return JTD3(JTD3Config(**cfg), OBS)
    if algo == "ddpg":
        return JDDPG(JDDPGConfig(**cfg), OBS, n_envs=OU_ENVS)
    if algo == "sac":
        return JSAC(JSACConfig(**cfg), OBS)
    return JDQN(JDQNConfig(**cfg), OBS)


def _batch(rng, algo):
    f32 = np.float32
    obs = rng.normal(size=(BATCH, OBS)).astype(f32)
    nxt = rng.normal(size=(BATCH, OBS)).astype(f32)
    if algo == "dqn":
        act = rng.integers(0, JDQNConfig().n_actions, BATCH).astype(np.int32)
    else:
        act = np.stack([rng.uniform(0, 0.22, BATCH),
                        rng.uniform(-2, 2, BATCH)], -1).astype(f32)
    rew = rng.normal(0, 3, BATCH).astype(f32)
    done = (rng.uniform(size=BATCH) < 0.1).astype(f32)
    return obs, act, rew, nxt, done


def _jax_update(agent, algo, sharded):
    """The jitted update ``(state, batch, key, noise)``: single-device,
    or ``shard_map`` over ``make_mesh(2)`` with the batch (and TD3's
    smoothing noise) split over the shards and the key replicated."""
    kw = {"axis_name": "env"} if sharded else {}

    def upd(s, b, k, n):
        if algo == "td3":
            return agent.update(s, b, k, smoothing_noise=n, **kw)
        if algo == "sac":
            return agent.update(s, b, k, **kw)
        return agent.update(s, b, None, **kw)

    if not sharded:
        return jax.jit(upd)
    return jax.jit(jax.shard_map(
        upd, mesh=jmake_mesh(2),
        in_specs=(P(), P("env"), P(), P("env")), out_specs=(P(), P())))


def _update_case(algo):
    """The warmed JAX state, the compared batch and draws, JAX's sharded
    update, and the worker's inputs."""
    jagent = _jax_agent(algo)
    rng = np.random.default_rng(ALGOS.index(algo) + 1)
    jstate = jax.jit(jagent.init)(jax.random.PRNGKey(0))
    single = _jax_update(jagent, algo, False)
    for i in (10, 11):      # warm Adam's moments (test_sharded_learner.py)
        jstate, _ = single(jstate, JTransition(*_batch(rng, algo)),
                           jax.random.PRNGKey(i),
                           jax.random.normal(jax.random.PRNGKey(100 + i),
                                             (BATCH, 2)))
    b = _batch(rng, algo)
    key = jax.random.PRNGKey(3)
    noise = jax.random.normal(jax.random.PRNGKey(2), (BATCH, 2))
    new_j, m_j = _jax_update(jagent, algo, True)(
        jstate, JTransition(*map(jnp.asarray, b)), key, noise)
    half = BATCH // 2
    tnoise, draw = None, None
    if algo == "td3":
        tnoise, draw = torch.from_numpy(np.array(noise)), "smoothing_noise"
        rank_noise = [tnoise[:half], tnoise[half:]]
    elif algo == "sac":
        # every shard draws from the replicated key at its local shape
        n = torch.from_numpy(np.array(jax.random.normal(key, (half, 2))))
        tnoise, draw = torch.cat([n, n]), "noise"
        rank_noise = [n, n]
    tagent = make_agent(algo, CONFIG_CLS[algo](**_cfg(algo)), OBS, OU_ENVS,
                        "cpu")[0]
    tstate = state_to_port(tagent, jstate)
    batch = Transition(*(torch.from_numpy(np.array(x)) for x in b))
    job = {"cfg": _cfg(algo), "obs_dim": OBS, "n_envs": OU_ENVS,
           "local": half, "state": tstate, "batch": batch, "draw": draw,
           "noise": None if draw is None else rank_noise}
    return dict(tagent=tagent, tstate=tstate, batch=batch, noise=tnoise,
                new_j=state_to_port(tagent, new_j),
                m_j={k: torch.from_numpy(np.array(v))
                     for k, v in m_j.items()}, job=job)


# ---- the trainer cases, and the 1-rank runs they are held to ----

def _trainer(agent_kw, tcfg_kw, env_kw=ROLL, algo="td3"):
    env_kw = dict(env_kw)
    cfg = make_config(env_kw.pop("world"), env_kw.pop("behavior"), **env_kw)
    env = CrowdEnv(cfg, device="cpu")
    agent = make_agent(algo, CONFIG_CLS[algo](**agent_kw), env.obs_dim,
                       tcfg_kw["n_envs"], "cpu")[0]
    return Trainer(env, agent, TrainerConfig(**tcfg_kw))


def _rollout_draws(trainer, steps):
    """Global draws of every step, and each rank's rows of them."""
    gen = torch.Generator().manual_seed(21)
    cfg, agent = trainer.env.cfg, trainer.agent
    out = []
    for _ in range(steps):
        d = StepDraws(act=agent.exploration_draws(N, gen),
                      bank_idx=torch.randint(0, N, (N,), generator=gen),
                      vel=world.random_velocities(cfg, (N, cfg.n_peds, 2),
                                                  gen, "cpu"))
        ranks = []
        for r in range(2):
            rows = slice(r * N // 2, (r + 1) * N // 2)
            ranks.append(StepDraws(act=tuple(a[rows] for a in d.act),
                                   bank_idx=d.bank_idx[rows],
                                   vel=d.vel[rows]))
        out.append((d, ranks))
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """One run of the two workers over every case; the cases' inputs and
    the workers' outputs."""
    tmp = tmp_path_factory.mktemp("sharded")
    cases = {algo: _update_case(algo) for algo in ALGOS}
    one = _trainer(ROLL_AGENT, ROLL_TCFG)
    draws = _rollout_draws(one, ROLL_TCFG["rollout_chunk"])
    job = {"updates": {a: c["job"] for a, c in cases.items()},
           "rollout": {"env": ROLL, "agent": ROLL_AGENT, "tcfg": ROLL_TCFG,
                       "draws": [r for _, r in draws]},
           "learning": {"env": ROLL, "agent": LEARN_AGENT,
                        "tcfg": LEARN_TCFG},
           "wrap_agent": WRAP_AGENT, "samples": SAMPLES}
    job_path = str(tmp / "job.pt")
    torch.save(job, job_path)
    port = _free_port()
    res = _run_ranks([[sys.executable, "-c", WORKER, str(r), port, job_path,
                       str(tmp / f"rank{r}.pt")] for r in range(2)])
    for r, (code, out) in enumerate(res):
        assert code == 0 and f"WORKER_OK {r}" in out, out[-4000:]
    outs = [torch.load(str(tmp / f"rank{r}.pt"), weights_only=False)
            for r in range(2)]
    return cases, one, draws, outs


def _assert_bit_equal(a, b, what, skip=()):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (k, x), (_, y) in zip(la, lb):
        if k not in skip:
            assert torch.equal(x, y), f"{what}: {k}"


@pytest.mark.parametrize("algo", ALGOS)
def test_two_rank_update_matches_jax_shard_map(ranks, algo):
    cases, _, _, outs = ranks
    c = cases[algo]
    (new0, m0), (new1, m1) = (o["updates"][algo] for o in outs)
    _assert_bit_equal(new0, new1, f"{algo}: rank 0 vs rank 1")
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    assert set(m0) == set(c["m_j"])
    shares = check_update(c["tagent"], c["tstate"], c["batch"], c["noise"],
                          new0, c["new_j"], c["m_j"])
    check_update(c["tagent"], c["tstate"], c["batch"], c["noise"],
                 c["new_j"], new0, m0)
    grads = [v for k, v in shares.items() if k.endswith("grad")]
    assert grads and max(grads) < 0.5, shares
    assert [o["summary"]["process_count"] for o in outs] == [2, 2]


def test_two_rank_rollout_rows_match_one_rank(ranks):
    """Each rank's envs, observations and replay ring against the 1-rank
    trainer's rollout under the same draws; the drained statistics summed
    over the ranks equal the 1-rank run's."""
    _, one, draws, outs = ranks
    state = one.init(0)
    rows_kept = []
    for d, _ in draws:
        rows_kept.append(~state.env_states.done)
        state = one._train_step(state, d)
    want, state = one.drain_stats(state)
    assert want["episodes"] > 0, "no episode ended in the chunk"
    full_obs = {bytes(r.numpy().tobytes()) for r in
                state.replay.obs[:int(state.replay.size) // N].reshape(
                    -1, one.env.obs_dim)}
    for r, o in enumerate(outs):
        ro = o["rollout"]
        rows = ro["rows"]
        assert rows == slice(r * N // 2, (r + 1) * N // 2)
        assert torch.equal(ro["obs"], state.obs[rows])
        _assert_bit_equal(ro["env_states"],
                          state.env_states.map(lambda a: a[rows]),
                          f"rank {r} env states")
        blocks = sum(int(k[rows].any()) for k in rows_kept)
        size = int(ro["replay"].size)
        assert size == blocks * N // 2 > 0
        assert not ro["learning_open"]
        local = ro["replay"].obs[:blocks].reshape(-1, one.env.obs_dim)
        assert all(bytes(x.numpy().tobytes()) in full_obs for x in local)
        got = ro["summary"]
        for k, v in want.items():
            if isinstance(v, int):
                assert got[k] == v, k
            else:
                assert got[k] == pytest.approx(v, rel=1e-6, abs=1e-6), k


def _jax_shard_cells(n_blocks):
    """The (ring block, row within the shard) cells that each shard of
    JAX's ring, sharded over ``make_mesh(2)``, samples from once the ring
    has wrapped: every stored row's first observation is its write order
    (block written t, env column c -> t N + c)."""
    buf = JReplayBuffer(WRAP_AGENT["buffer_size"], 3, 2, block=N)
    assert buf.n_blocks == n_blocks
    state = buf.init()
    for t in range(n_blocks + 1):
        obs = jnp.zeros((N, 3)).at[:, 0].set(
            jnp.arange(t * N, (t + 1) * N, dtype=jnp.float32))
        state = buf.add_batch(state, JTransition(
            obs, jnp.zeros((N, 2)), jnp.zeros(N), obs, jnp.zeros(N)))

    def draw(s, key):
        key = jax.random.fold_in(key, jax.lax.axis_index("env"))
        return buf.sample(s, key, SAMPLES).obs[:, 0]

    got = np.asarray(jax.jit(jax.shard_map(
        draw, mesh=jmake_mesh(2), in_specs=(buf.pspecs("env"), P()),
        out_specs=P("env")))(state, jax.random.PRNGKey(0)))
    ids = got.astype(np.int64).reshape(2, SAMPLES)
    cells = []
    for r in range(2):
        t, col = ids[r] // N, ids[r] % N
        assert np.all(col // (N // 2) == r), "a shard sampled another's rows"
        cells.append({(int(b), int(c)) for b, c in
                      zip(t % n_blocks, col - r * N // 2)})
    return cells


def test_two_rank_replay_ring_wraps_as_one_rank(ranks):
    """The rollout into a ring of 3 blocks that it wraps: each rank's ring
    has the 1-rank ring's block count (JAX's too), each block of its own 4
    envs, so that the ranks together hold the 1-rank ring's rows; it holds
    bit for bit its envs' rows of the 1-rank ring's last blocks (a rank's
    masked rows are duplicates of its own kept rows, as ``add_batch``
    partitions its block); and it samples over all of its rows and no
    others, the cells a shard of JAX's sharded ring samples over."""
    _, _, draws, outs = ranks
    one = _trainer(WRAP_AGENT, ROLL_TCFG)
    nb, half = one.buffer.n_blocks, N // 2
    state = one.init(0)
    writes = []     # (kept rows, the 1-rank block) of each written step
    for d, _ in draws:
        kept = ~state.env_states.done
        head = int(state.replay.head)
        state = one._train_step(state, d)
        if kept.any():
            writes.append((kept, one.buffer.read_block(state.replay, head)))
    assert len(writes) > nb, "the chunk did not wrap the ring"
    jax_cells = _jax_shard_cells(nb)
    for r, o in enumerate(outs):
        w, rows = o["wrap"], range(r * half, (r + 1) * half)
        assert w["n_blocks"] == nb == 3 and w["capacity"] == nb * half
        want = []       # this rank's blocks, in the order written
        for kept, block in writes:
            envs = torch.nonzero(kept).flatten().tolist()
            own = [i for i, e in enumerate(envs) if e in rows]
            if own:
                src = [own[p % len(own)] for p in range(half)]
                want.append([f[src] for f in block])
        assert len(want) > nb
        ring = w["replay"]
        assert int(ring.size) == nb * half
        assert int(ring.head) == len(want) % nb
        for k in range(len(want) - nb, len(want)):
            got = one.buffer.read_block(ring, k % nb)
            for name, x, y in zip(Transition._fields, want[k], got):
                assert torch.equal(x, y), (r, k, name)
        idx = w["sample_idx"]
        assert int(idx.min()) >= 0 and int(idx.max()) < nb * half
        cells = {(int(i) // half, int(i) % half) for i in idx}
        assert cells == jax_cells[r] == {(b, c) for b in range(nb)
                                        for c in range(half)}


@pytest.mark.parametrize("algo", ["td3", "ddpg"])
def test_two_rank_learning_chunk(ranks, algo):
    """A learning chunk on the ranks' own streams: every update starts
    from the same state on both ranks, ends in the same state, and is
    within ``check_update`` of the 1-rank update of the two ranks'
    batches (and smoothing noise) concatenated; the epsilon spectrum and
    the greedy cohort are the global batch's rows."""
    _, _, _, outs = ranks
    agent_kw = dict(LEARN_AGENT)
    if algo == "ddpg":
        agent_kw.pop("explore_uniform_eps_min")
    one = _trainer(agent_kw, LEARN_TCFG, algo=algo)
    agent = one.agent
    l0, l1 = (o[f"learning_{algo}"] for o in outs)
    assert l0["env_rows"] == (N, 0) and l1["env_rows"] == (N, N // 2)
    assert torch.equal(torch.cat([l0["greedy_mask"], l1["greedy_mask"]]),
                       one.greedy_mask)
    assert not torch.equal(l0["gen_state"], l1["gen_state"])
    assert len(l0["calls"]) == len(l1["calls"]) >= 2
    # DDPG's OU carry is per env: each rank holds its own envs' rows
    own = ("ou_state",)
    _assert_bit_equal(l0["final"], l1["final"], "final agent state", own)
    for u, (c0, c1) in enumerate(zip(l0["calls"], l1["calls"])):
        s_in, b0, n0, new0, m0 = c0
        _, b1, n1, new1, _ = c1
        _assert_bit_equal(s_in, c1[0], f"update {u} start", own)
        _assert_bit_equal(new0, new1, f"update {u} result", own)
        assert not torch.equal(b0.obs, b1.obs)
        batch = Transition(*(torch.cat([x, y]) for x, y in zip(b0, b1)))
        noise = None if n0 is None else torch.cat([n0, n1])
        kw = {} if noise is None else {"smoothing_noise": noise}
        new_1, m_1 = agent.update(s_in, batch, **kw)
        check_update(agent, s_in, batch, noise, new0, new_1, m_1)
        assert set(m0) == set(m_1)
    if algo == "ddpg":
        assert l0["final"].ou_state.shape == (N // 2, 2)
    moved = (l0["final"].actor_params - l0["start"].actor_params).abs()
    assert float(moved.max()) > 0.0
    assert l0["summary"] == l1["summary"]


# ---- without a process group ----

def test_one_rank_mesh_trainer_is_the_trainer():
    """Outside a process group the mesh has one rank, its reduction is
    the identity, and the sharded trainer is the trainer bit for bit."""
    m = mesh.make_mesh()
    assert (m.size, m.rank, m.joined) == (1, 0, False)
    with pytest.raises(ValueError, match="2 ranks|1 ranks"):
        mesh.make_mesh(2)
    t = torch.arange(4.0)
    assert m.mean(t) is t
    kw = dict(LEARN_TCFG, rollout_chunk=3)
    plain = _trainer(LEARN_AGENT, kw)
    sharded = _trainer(LEARN_AGENT, kw)
    sharded = mesh.ShardedTrainer(sharded.env, sharded.agent,
                                  TrainerConfig(**kw), m)
    a = plain.rollout_chunk(plain.init(5))
    b = sharded.rollout_chunk(sharded.init(5))
    _assert_bit_equal(a.env_states, b.env_states, "env states")
    _assert_bit_equal(a.agent_state, b.agent_state, "agent state")
    assert plain.drain_stats(a)[0] == sharded.drain_stats(b)[0]


def test_sharded_trainer_checks_the_split():
    one = _trainer(LEARN_AGENT, LEARN_TCFG)
    m = mesh.Mesh(size=3, rank=0)
    with pytest.raises(ValueError, match="n_envs=8"):
        mesh.ShardedTrainer(one.env, one.agent, TrainerConfig(**LEARN_TCFG),
                            m)
    with pytest.raises(ValueError, match="batch_size=16"):
        mesh.ShardedTrainer(one.env, one.agent, TrainerConfig(
            **dict(LEARN_TCFG, n_envs=32)), mesh.Mesh(size=32, rank=1))
    tr = mesh.ShardedTrainer(one.env, one.agent,
                             TrainerConfig(**LEARN_TCFG),
                             mesh.Mesh(size=8, rank=1))
    assert tr.tcfg.n_envs == 1 and tr.rows == slice(1, 2)
    assert tr.batch_size == 2 and tr.buffer.block == 1
    assert tr.buffer.n_blocks == one.buffer.n_blocks


def test_distribute_keeps_the_rows_of_the_batch():
    tree = {"a": torch.arange(12).reshape(6, 2), "b": torch.arange(5),
            "c": (torch.zeros(6), None)}
    out = distributed.distribute(tree, 6, rank=2, world_size=3)
    assert torch.equal(out["a"], tree["a"][4:6])
    assert out["b"] is tree["b"] and out["c"][1] is None
    assert out["c"][0].shape == (2,)
    with pytest.raises(ValueError):
        distributed.shard_rows(7, 0, 2)


def test_init_multihost_reads_the_environment(monkeypatch):
    """The JAX names of the launch variables, then the torch ones; a
    missing one raises; a one-process gloo group on the CPU."""
    for name in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
                 "JAX_PROCESS_ID", "MASTER_ADDR", "MASTER_PORT",
                 "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(ValueError, match="coordinator"):
        distributed.init_multihost(device="cpu")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", _free_port())
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    dev = distributed.init_multihost(device="cpu")
    try:
        assert dev == torch.device("cpu")
        assert distributed.process_summary() == {
            "process_index": 0, "process_count": 1, "local_devices": 1,
            "global_devices": 1, "backend": "gloo"}
        assert distributed.all_min(7) == 7
        m = mesh.make_mesh(1)
        assert torch.equal(m.mean(torch.ones(3) * 3), torch.ones(3) * 3)
    finally:
        distributed.shutdown()
    assert distributed.world() == (0, 1)


# ---- the driver ----

TINY = ["--algo", "td3", "--device", "cpu", "--n-envs", "8", "--chunk", "4",
        "--updates-per-step", "2", "--batch-size", "16", "--learn-start",
        "16", "--max-steps", "16", "--jitter", "1.0", "--buffer-size", "64",
        "--ckpt-every-chunks", "1"]


def _events(out):
    return [json.loads(x) for x in out.splitlines() if x.startswith("{")]


def test_driver_writes_each_line_at_once(monkeypatch):
    """The ranks that ``--n-devices`` starts share one stdout: each JSON
    line goes out in one write, so that no other rank's line can land
    between its text and its newline."""
    from crowdnav_tpu_torch.drivers import train as dtrain

    class Out:
        writes = []

        def write(self, s):
            self.writes.append(s)

        def flush(self):
            pass

    monkeypatch.setattr(sys, "stdout", Out())
    dtrain._emit({"process_index": 1})
    dtrain._emit({"event": "done"})
    assert Out.writes == ['{"process_index": 1}\n', '{"event": "done"}\n']


def test_train_driver_multihost_and_resume(tmp_path):
    """Two ``--multihost`` processes train 2 chunks: rank 0 prints the
    chunks, writes the CSV and the agent checkpoint, each rank its own
    rows of the trainer state; ``--n-devices 2`` (which starts the two
    ranks itself) resumes them to 4 chunks."""
    out = str(tmp_path)
    port = _free_port()
    argv = [sys.executable, "-m", "crowdnav_tpu_torch.drivers.train",
            *TINY, "--outdir", out, "--env-steps", "64", "--multihost",
            "--coordinator", f"localhost:{port}", "--num-processes", "2"]
    res = _run_ranks([argv + ["--process-id", str(r)] for r in range(2)])
    for code, text in res:
        assert code == 0, text[-4000:]
    ev0, ev1 = _events(res[0][1]), _events(res[1][1])
    assert [e["chunk"] for e in ev0 if "chunk" in e] == [0, 1]
    assert ev0[-1]["event"] == "done" and ev0[-1]["env_steps"] == 64
    assert [e.get("process_index") for e in ev1] == [1]
    for r in range(2):
        assert tckpt.latest_step(f"{out}/ckpt_td3/rank{r}") == 64
    assert tckpt.latest_step(f"{out}/agent_ckpt_td3", "agent",
                             ".npz") == 64
    saved = [torch.load(f"{out}/ckpt_td3/rank{r}/state_64.pt",
                        weights_only=False) for r in range(2)]
    assert saved[0]["obs"].shape == (4, 398)
    assert not torch.equal(saved[0]["obs"], saved[1]["obs"])
    assert torch.equal(saved[0]["agent_state"].actor_params,
                       saved[1]["agent_state"].actor_params)
    res = _run_ranks([[sys.executable, "-m",
                       "crowdnav_tpu_torch.drivers.train", *TINY,
                       "--outdir", out, "--env-steps", "128", "--resume",
                       "--n-devices", "2"]])
    code, text = res[0]
    assert code == 0, text[-4000:]
    ev = _events(text)
    assert [e["step"] for e in ev if e.get("event") == "resumed"] == [64]
    assert [e["env_steps"] for e in ev if "chunk" in e] == [96, 128]
    with open(f"{out}/td3_training.csv") as fp:
        assert len(fp.read().splitlines()) == 1 + 4
    for r in range(2):
        assert tckpt.latest_step(f"{out}/ckpt_td3/rank{r}") == 128
