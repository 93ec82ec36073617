"""The training slice for DDPG, SAC and DQN: a learning chunk of the port's
``Trainer`` against the JAX package's, step by step, with every draw
injected from JAX (as ``test_torch_train.py`` does for TD3); the agent
checkpoints and ``--checkpoint-step``; the drivers on the CPU.

In each chunk the env states, observations and the replay ring are held
bit-equal at every step, so the actions must be too. DDPG explores with
epsilon 1 (each action is JAX's uniform draw; the OU carry is held
bit-equal), DQN with its starting epsilon 1 (each action is JAX's random
index). SAC's exploring action passes through its networks, exp and tanh,
which the two frameworks round differently: the port's act is held within
its derived bound of JAX's action, and the step then takes JAX's action.
Before each step the port's learner state is set to the JAX trainer's,
and every update the port's trainer makes is held, through
``utils/error_bounds.check_update``, to the JAX package's update of the
same state on JAX's own sample of its ring (and, for SAC, JAX's normal
draw of the update's key)."""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crowdnav_tpu.agents import DDPG as JDDPG
from crowdnav_tpu.agents import DDPGConfig as JDDPGConfig
from crowdnav_tpu.agents import DQN as JDQN
from crowdnav_tpu.agents import DQNConfig as JDQNConfig
from crowdnav_tpu.agents import SAC as JSAC
from crowdnav_tpu.agents import SACConfig as JSACConfig
from crowdnav_tpu.envs import CrowdEnv, SimpleEnv, make_config
from crowdnav_tpu.parallel import Trainer as JTrainer
from crowdnav_tpu.parallel import TrainerConfig as JTrainerConfig
from crowdnav_tpu_torch.agents.ddpg import DDPG, DDPGConfig
from crowdnav_tpu_torch.agents.dqn import DQN, DQNConfig
from crowdnav_tpu_torch.agents.replay import Transition
from crowdnav_tpu_torch.agents.sac import SAC, SACConfig
from crowdnav_tpu_torch.drivers import evaluate as tevaluate
from crowdnav_tpu_torch.drivers import train as ttrain
from crowdnav_tpu_torch.envs import config as tcfg
from crowdnav_tpu_torch.envs.crowd_env import CrowdEnv as TCrowdEnv
from crowdnav_tpu_torch.envs.simple_env import SimpleEnv as TSimpleEnv
from crowdnav_tpu_torch.parallel.runtime import (StepDraws, Trainer,
                                                 TrainerConfig)
from crowdnav_tpu_torch.utils import checkpoint as tckpt
from crowdnav_tpu_torch.utils import convert
from crowdnav_tpu_torch.utils import error_bounds as eb
from test_torch_replay import _bits, _tbits
from test_torch_world import jax_crowd_draws
from torch_parity import (assert_env_state_equal, env_state_to_torch,
                          state_to_jax, state_to_port)

torch.set_num_threads(1)
N, CHUNK, BATCH = 16, 8, 32
LO, HI = jnp.array([0.0, -2.0]), jnp.array([0.22, 2.0])


def _t(a):
    return torch.from_numpy(np.array(a))


def _setup(algo):
    """(JAX env and agent, port env and agent, env config) of the chunk:
    DDPG on ``crowd_dense``/``crossing``, SAC and DQN on the simple env in
    ``crowd_sparse``/``random``."""
    kw = dict(jitter=1.0, max_steps=6)
    if algo == "ddpg":
        world = ("crowd_dense", "crossing")
        jenv, tenv_cls = CrowdEnv(make_config(*world, **kw)), TCrowdEnv
        cfg = dict(hidden=32, batch_size=BATCH, buffer_size=4 * N,
                   explore_uniform_eps=1.0)
        jagent = JDDPG(JDDPGConfig(**cfg), jenv.obs_dim, n_envs=N)
        tagent = DDPG(DDPGConfig(**cfg), jenv.obs_dim, n_envs=N,
                      device="cpu")
    else:
        world = ("crowd_sparse", "random")
        jenv, tenv_cls = SimpleEnv(make_config(*world, **kw)), TSimpleEnv
        if algo == "sac":
            cfg = dict(hidden=32, value_hidden=32, batch_size=BATCH,
                       buffer_size=4 * N)
            jagent = JSAC(JSACConfig(**cfg), jenv.obs_dim)
            tagent = SAC(SACConfig(**cfg), jenv.obs_dim, device="cpu")
        else:
            cfg = dict(hidden=(32, 32), batch_size=BATCH, buffer_size=4 * N,
                       target_update_period=3)
            jagent = JDQN(JDQNConfig(**cfg), jenv.obs_dim)
            tagent = DQN(DQNConfig(**cfg), jenv.obs_dim, device="cpu")
    tenv = tenv_cls(tcfg.make_config(*world, **kw), device="cpu")
    st, obs = jenv._template
    tenv.template = (env_state_to_torch(jax.tree.map(lambda a: a[None], st)),
                     torch.from_numpy(np.array(obs))[None])
    return jenv, jagent, tenv, tagent


def _act_draws(algo, k_act):
    """The draws of the JAX agent's exploring ``act`` from its key."""
    if algo == "ddpg":
        k_ou, k_eps, k_unif = jax.random.split(k_act, 3)
        unif = jax.jit(lambda k: jax.random.uniform(
            k, (N, 2), minval=LO, maxval=HI))(k_unif)
        return [_t(jax.random.uniform(k_ou, (N, 2))), _t(unif),
                _t(jax.random.uniform(k_eps, (N, 1)))]
    if algo == "sac":
        return _t(jax.random.normal(k_act, (N, 2)))
    k1, k2 = jax.random.split(k_act)
    return [_t(jax.random.randint(k1, (N,), 0, 3)),
            _t(jax.random.uniform(k2, (N,)))]


def _jax_draws(algo, key, n_updates, rows, js, jc):
    """The draws of one JAX ``Trainer._train_step`` from its loop key, each
    update's (sample key, update key), the act's key, and the next loop
    key."""
    key, k_act, _, k_update, k_bank = jax.random.split(key, 5)
    k_idx, _ = jax.random.split(k_bank)
    samples, noise, keys = [], [], []
    for k in jax.random.split(k_update, n_updates):
        ks, ku = jax.random.split(k)
        keys.append((ks, ku))
        samples.append(_t(jax.random.randint(ks, (BATCH,), 0,
                                             max(rows, 1))))
        noise.append(_t(jax.random.normal(ku, (BATCH, 2))))
    vel = jax_crowd_draws(jc, js.env_states) if jc.n_peds else None
    draws = StepDraws(act=_act_draws(algo, k_act),
                      bank_idx=_t(jax.random.randint(k_idx, (N,), 0, N)),
                      vel=vel, sample_idx=samples,
                      sac_noise=noise if algo == "sac" else None)
    return key, draws, keys, k_act


def _f32(a):
    return np.asarray(a, np.float32) if np.asarray(a).dtype != np.int32 \
        else np.asarray(a)


@pytest.mark.parametrize("updates", [1, 2])
@pytest.mark.parametrize("algo", ["ddpg", "sac", "dqn"])
def test_learning_chunk_matches_jax(algo, updates):
    jenv, jagent, tenv, tagent = _setup(algo)
    discrete = algo == "dqn"
    jcfg = dict(n_envs=N, rollout_chunk=1, updates_per_step=updates,
                learn_start=2 * N, reset_bank=N,
                replay_obs_dtype="bfloat16")
    jt = JTrainer(jenv, jagent, JTrainerConfig(**jcfg), discrete=discrete)
    jstep = jax.jit(jt.rollout_chunk)
    jsample = jax.jit(lambda r, k: jt.buffer.sample(r, k, BATCH))
    jupdate = jax.jit(jagent.update)
    jact = jax.jit(lambda s, o, k: jagent.act(s, o, k, explore=True))
    js = jt.init(jax.random.PRNGKey(0))
    if algo == "sac":
        # an actor whose exploring actions vary with the observation
        p = jax.tree.map(np.array, js.agent_state.actor_params)
        p["params"]["Dense_2"]["kernel"] *= 30.0
        js = js.replace(agent_state=js.agent_state.replace(
            actor_params=jax.tree.map(jnp.asarray, p)))
    tt = Trainer(tenv, tagent, TrainerConfig(**jcfg), discrete=discrete)
    bank_states, bank_obs = js.reset_bank
    ts = dataclasses.replace(
        tt.init(0), env_states=env_state_to_torch(js.env_states),
        obs=torch.from_numpy(np.array(js.obs)),
        reset_bank=(env_state_to_torch(bank_states),
                    torch.from_numpy(np.array(bank_obs))))
    start = state_to_port(tagent, js.agent_state)

    calls, acts = [], []
    update, act = tagent.update, tagent.act

    def recorded(state, batch, gen=None, **kw):
        new, m = update(state, batch, gen=gen, **kw)
        calls.append((state, batch, kw.get("noise"), new, m))
        return new, m

    def sac_act(obs, explore=False, state=None, gen=None, draws=None):
        """The port's act, within its bound of JAX's; JAX's action on."""
        got = act(obs, explore, state, gen, draws)
        fw = eb.sac_sample_bound(tagent, eb._bparams(
            tagent, "actor", state.actor_params), obs.numpy(),
            draws.numpy())
        out = eb.bclip(fw["action"], np.array([0.0, -2.0]),
                       np.array([0.22, 2.0]))
        want = acts[-1]
        eb.within("sac act (port)", got.numpy(), out)
        eb.within("sac act (jax)", want, out)
        return torch.from_numpy(want)

    tagent.update = recorded
    if algo == "sac":
        tagent.act = sac_act
    key = js.key
    n_updates, shares, copies = 0, [], 0
    for step in range(CHUNK):
        rows_after = min(int(js.replay.size) + N, jt.buffer.capacity)
        key, draws, skeys, k_act = _jax_draws(
            algo, key, updates, rows_after // N * N, js, jenv.cfg)
        pre = state_to_port(tagent, js.agent_state)
        if algo == "sac":
            acts[:] = [np.array(jact(js.agent_state, js.obs, k_act))]
        ts = dataclasses.replace(ts, agent_state=pre)
        calls.clear()
        js = jstep(js)
        ts = tt.rollout_chunk(ts, [draws])
        assert_env_state_equal(ts.env_states, js.env_states, f"step {step}")
        np.testing.assert_array_equal(ts.obs.numpy(), np.asarray(js.obs))
        assert int(ts.replay.size) == int(js.replay.size)
        assert int(ts.replay.head) == int(js.replay.head)
        for b in range(jt.buffer.n_blocks):
            j = jt.buffer.read_block(js.replay, b)
            t = tt.buffer.read_block(ts.replay, b)
            for name in Transition._fields:
                np.testing.assert_array_equal(
                    _tbits(getattr(t, name)) if getattr(t, name).dtype
                    != torch.int32 else getattr(t, name).numpy(),
                    _bits(getattr(j, name)),
                    err_msg=f"step {step} block {b} {name}")
        if algo == "ddpg":
            np.testing.assert_array_equal(
                ts.agent_state.ou_state.numpy(),
                np.asarray(js.agent_state.ou_state))
        if not calls:
            # the learn gate is still shut on both sides
            assert int(ts.replay.size) < 2 * N, step
            continue
        assert len(calls) == updates, step
        for u, (s_in, batch, noise, s_out, m) in enumerate(calls):
            if u:
                assert s_in is calls[u - 1][3], (step, u)
            jb = jsample(js.replay, skeys[u][0])
            for name, got, want in zip(Transition._fields, batch, jb):
                np.testing.assert_array_equal(
                    _f32(got.float() if got.dtype != torch.int32 else got),
                    _f32(want), err_msg=f"step {step} update {u} {name}")
            if algo == "sac":
                np.testing.assert_array_equal(noise.numpy(),
                                              draws.sac_noise[u].numpy())
            ref, mj = jupdate(state_to_jax(tagent, s_in, js.agent_state), jb,
                              skeys[u][1])
            shares.append(eb.check_update(
                tagent, s_in, batch, noise, s_out,
                state_to_port(tagent, ref),
                {k: _t(v) for k, v in mj.items()}))
            if algo == "dqn" and int(s_out.step) % 3 == 0:
                copies += 1
        assert ts.agent_state is calls[-1][3]
        for k, v in calls[-1][4].items():
            assert torch.equal(ts.learn_metrics[k], v), k
        n_updates += updates
    assert int(js.replay.size) == jt.buffer.capacity   # the ring wrapped
    assert n_updates >= 4
    if algo == "dqn":
        assert copies >= 1 and int(ts.agent_state.step) == n_updates
    field = "params" if algo == "dqn" else "actor_params"
    moved = (getattr(ts.agent_state, field) - getattr(start, field))
    assert float(moved.abs().max()) > 0.0
    grads = [v for s in shares for k, v in s.items() if k.endswith("grad")]
    assert max(grads) < 0.5, shares
    summary, _ = tt.drain_stats(ts)
    jsummary, _ = jt.drain_stats(js)
    for k in ("episodes", "successes", "failures", "greedy_episodes"):
        assert summary[k] == jsummary[k], k
    for k in tagent.METRICS:
        assert k in summary and np.isfinite(summary[k]) and k in jsummary


ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "crowdnav_tpu_torch", "assets")
RESULTS = os.path.join(os.path.dirname(ASSETS), os.pardir, "results")
# algo -> (committed JAX checkpoint, its step, exported policy, suite)
RECORDS = {
    "ddpg": ("r3/ddpg_spectrum/agent_peak_ddpg", 1572864, "ddpg_peak",
             "train"),
    "sac": ("r2/sac/agent_ckpt_sac", 3997696, "sac_actor.npz",
            "train_sparse"),
    "dqn": ("r2/dqn/agent_ckpt_dqn", 3997696, "dqn_qnet.npz",
            "train_sparse")}
TINY = ["--device", "cpu", "--n-envs", "8", "--chunk", "4", "--env-steps",
        "64", "--updates-per-step", "2", "--batch-size", "16",
        "--learn-start", "16", "--max-steps", "16", "--jitter", "1.0",
        "--buffer-size", "64", "--ckpt-every-chunks", "0",
        "--snapshot-every-chunks", "1"]
WORLD = {"ddpg": ["--world", "crowd_dense", "--behavior", "crowd",
                  "--explore-eps", "1.0", "--explore-eps-min", "0.05",
                  "--explore-spectrum", "--actor-lr", "1e-4"],
         "sac": ["--world", "crowd_sparse", "--behavior", "random"],
         "dqn": ["--world", "crowd_sparse", "--behavior", "random"]}


@pytest.mark.parametrize("algo", ["ddpg", "sac", "dqn"])
def test_train_driver_on_cpu_and_checkpoint_step(algo, tmp_path, capsys):
    """``drivers/train --algo`` on the CPU: chunk lines with the agent's
    own metrics, ``run_config.json`` with the JAX driver's keys and the
    agent config's fields, an agent snapshot per chunk; ``evaluate
    --checkpoint-step`` reads the snapshot of that step (not the newest)."""
    from crowdnav_tpu.drivers.train import _CONFIG_CLS as JCONFIG
    from crowdnav_tpu.drivers.train import run_metadata as jmeta
    argv = ["--algo", algo] + TINY + WORLD[algo] + ["--outdir",
                                                     str(tmp_path)]
    ttrain.main(argv)
    ev = [json.loads(line) for line in capsys.readouterr().out.splitlines()
          if line.startswith("{")]
    chunks = [e for e in ev if "sps" in e]
    assert [c["env_steps"] for c in chunks] == [32, 64]
    agent_cls = type(ttrain.build(ttrain.parser().parse_args(argv)).agent)
    for k in agent_cls.METRICS:
        assert np.isfinite(chunks[-1][k]), k
    snap = tmp_path / f"agent_snapshots_{algo}"
    assert tckpt.latest_step(str(snap), "agent", ".npz") == 64
    meta = tckpt.load_run_metadata(str(snap))
    args = ttrain.parser().parse_args(argv)
    trainer = ttrain.build(args)
    assert meta == json.loads(json.dumps(jmeta(args, trainer)))
    assert set(meta["agent_config"]) == {
        f.name for f in dataclasses.fields(JCONFIG[algo])}
    if algo == "ddpg":
        assert meta["agent_config"]["actor_lr"] == 1e-4
    # --checkpoint-step picks the first chunk's snapshot
    first, _ = tckpt.load_agent(str(snap), trainer.agent, step=32)
    newest, _ = tckpt.load_agent(str(snap), trainer.agent)
    field = "params" if algo == "dqn" else "actor_params"
    assert not torch.equal(getattr(first, field), getattr(newest, field))
    params, _ = tevaluate.load_actor_file(str(snap), 32, algo)
    sd = convert.flax_actor_to_state_dict(params)
    module = trainer.agent.net if algo == "dqn" else trainer.agent.actor
    from crowdnav_tpu_torch.models.networks import flatten, load_flat
    load_flat(module, getattr(first, field))
    for k, v in module.state_dict().items():
        assert torch.equal(sd[k], v), k
    suite = "train" if algo == "ddpg" else "train_sparse"
    results = tevaluate.main(["--algo", algo, "--device", "cpu", "--suite",
                              suite, "--checkpoint", str(snap),
                              "--checkpoint-step", "32", "--n-envs", "2",
                              "--max-steps", "4", "--outdir",
                              str(tmp_path)])
    assert results[0]["episodes"] == 2
    assert flatten(module).numel() == getattr(first, field).numel()


@pytest.mark.parametrize("algo", ["ddpg", "sac", "dqn"])
def test_exported_policy_equals_the_jax_checkpoint(algo):
    """The committed policy file equals the greedy policy of the JAX
    checkpoint it was exported from (``restore_agent_state`` against the
    algorithm's default config, as the JAX evaluate driver restores it),
    array for array; and on a shared batch of observations the port's
    greedy actions from it agree with the JAX agent's: within the derived
    bound (DDPG, SAC), the same index wherever the top two Q values differ
    by more than twice their bound (DQN: the trained network's Q values
    run to hundreds and its a-priori bound to ~2.5, so a few percent of
    the rows are decided; the test needs 8)."""
    ckpt, step, asset, _ = RECORDS[algo]
    state, meta = export_module_restore(os.path.join(RESULTS, ckpt), algo,
                                        step)
    path = os.path.join(ASSETS, asset)
    params, fmeta = tevaluate.load_actor_file(path, step, algo)
    assert fmeta["algo"] == algo and fmeta["step"] == step
    field = "params" if algo == "dqn" else "actor_params"
    want = getattr(state, field)["params"]
    assert set(params["params"]) == set(want)
    for layer, kb in want.items():
        for name, v in kb.items():
            np.testing.assert_array_equal(params["params"][layer][name],
                                          np.asarray(v), err_msg=layer)
    from crowdnav_tpu.drivers.train import _build_agent
    obs_dim = 398 if algo == "ddpg" else 363
    n = 1024 if algo == "dqn" else 256
    jagent, _ = _build_agent(algo, obs_dim, n)
    tagent = tevaluate.build_agent(None, obs_dim, "cpu", algo, n)
    tagent.load_actor(convert.flax_actor_to_state_dict(params))
    obs = _observations(algo, tagent, n)
    jgreedy = jax.jit(lambda s, o: jagent.act(s, o, jax.random.PRNGKey(0),
                                              explore=False))
    jout = jgreedy(state, obs)
    jout = np.asarray(jout[0] if algo == "ddpg" else jout)
    got = tagent.act(torch.from_numpy(obs)).numpy()
    if algo == "dqn":
        p = {k: eb.Bnd(v.double().numpy())
             for k, v in tagent.net.state_dict().items()}
        q, _ = eb.bmlp(p, "", obs, tagent.n_layers)
        top = np.sort(q.v, -1)
        decided = top[:, -1] - top[:, -2] > 2 * q.e.max(-1)
        assert decided.sum() >= 8
        np.testing.assert_array_equal(got[decided], jout[decided])
        return
    ap = {k: eb.Bnd(v.double().numpy())
          for k, v in tagent.actor.state_dict().items()}
    if algo == "ddpg":
        sig, th, _ = eb._actor_heads_bnd(ap, obs)
        out = eb._scaled(tagent.cfg, sig, th)
    else:
        fw = eb.sac_sample_bound(tagent, ap, obs, np.zeros((n, 2)))
        a = eb.btanh(fw["mean"])
        out = eb.bconcat([eb.bmul(eb.bsigmoid(a[:, 0:1]), eb._f(0.22)),
                          eb.bmul(eb.btanh(a[:, 1:2]), eb._f(2.0))])
    out = eb.bclip(out, np.array([0.0, -2.0]), np.array([0.22, 2.0]))
    eb.within(f"{algo} port", got, out)
    eb.within(f"{algo} jax", jout, out)


def _observations(algo, agent, n):
    """Observations of ``n`` envs of the record's world after 20 greedy
    steps of ``agent`` (jittered spawns), on the CPU."""
    env_cls = TCrowdEnv if algo == "ddpg" else TSimpleEnv
    world = "crowd_dense" if algo == "ddpg" else "crowd_sparse"
    env = env_cls(tcfg.make_config(world, "crowd", jitter=1.0), "cpu")
    state, obs = env.reset(n, torch.Generator().manual_seed(0))
    step = env.step_discrete if algo == "dqn" else env.step_batch
    for _ in range(20):
        out = step(state, agent.act(obs),
                   gen=torch.Generator().manual_seed(1))
        state, obs = out.state, out.obs
    return obs.numpy()


def export_module_restore(path, algo, step):
    from torch_parity import export_module
    return export_module().restore(path, algo, step)


@pytest.mark.parametrize("algo", ["ddpg", "sac", "dqn"])
def test_evaluate_driver_runs_each_exported_policy(algo, tmp_path, capsys):
    """``drivers/evaluate --algo`` with each committed policy on its
    record's suite, a few envs on the CPU: the reference's CSV row and a
    summary per scenario; a conflicting ``--algo`` is refused."""
    _, step, asset, suite = RECORDS[algo]
    argv = ["--algo", algo, "--device", "cpu", "--suite", suite,
            "--checkpoint", os.path.join(ASSETS, asset), "--n-envs", "4",
            "--max-steps", "60", "--outdir", str(tmp_path)]
    if algo == "ddpg":
        argv += ["--checkpoint-step", str(step)]
    results = tevaluate.main(argv)
    assert results[0]["episodes"] >= 4
    assert os.path.isfile(tmp_path / f"{algo}_training_test.csv")
    other = "sac" if algo != "sac" else "dqn"
    with pytest.raises(SystemExit, match="conflicts"):
        tevaluate.main([a if a != algo else other for a in argv])


@pytest.mark.parametrize("algo", ["ddpg", "sac", "dqn"])
def test_drivers_default_to_the_card(algo, tmp_path):
    """Without ``--device cpu`` both drivers ask for the card, and refuse
    to run without one: no fallback to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(SystemExit, match="CUDA is not available"):
        ttrain.main(["--algo", algo, "--outdir", str(tmp_path)])
    with pytest.raises(SystemExit, match="CUDA is not available"):
        tevaluate.main(["--algo", algo, "--outdir", str(tmp_path)])


@pytest.mark.parametrize("algo", ["ddpg", "dqn"])
def test_full_checkpoint_round_trips(algo, tmp_path):
    """``--resume``'s full checkpoint of a DDPG (its OU carry) and a DQN
    (RMSprop's moment, the step count, epsilon, int32 replay actions)
    trainer: the restored state continues exactly as the saved one."""
    argv = ["--algo", algo] + TINY + WORLD[algo] + ["--outdir",
                                                     str(tmp_path)]
    trainer = ttrain.build(ttrain.parser().parse_args(argv))
    state = trainer.rollout_chunk(trainer.init(3))
    tckpt.save_checkpoint(str(tmp_path / "ck"), state, 32)
    back, step, _ = tckpt.restore_checkpoint(str(tmp_path / "ck"),
                                             trainer.init(4))
    assert step == 32
    if algo == "dqn":
        assert back.replay.action.dtype == torch.int32
        assert torch.equal(back.agent_state.opt.nu, state.agent_state.opt.nu)
    else:
        assert torch.equal(back.agent_state.ou_state,
                           state.agent_state.ou_state)
    a = trainer.rollout_chunk(state)
    b = trainer.rollout_chunk(back)
    assert torch.equal(a.obs, b.obs)
    field = "params" if algo == "dqn" else "actor_params"
    assert torch.equal(getattr(a.agent_state, field),
                       getattr(b.agent_state, field))
