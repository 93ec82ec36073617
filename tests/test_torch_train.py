"""The training slice as a whole: a learning chunk of the port's
``Trainer`` against the JAX package's, step by step, with every draw
injected from JAX; the agent checkpoint against ``restore_agent_state`` on
the committed ``final_full`` checkpoint; the training driver on the CPU
(CSV, ``run_config.json``, collapse restart, resume); ``collapse_verdict``
and the CSV logger against the JAX package's.

In the chunk, every env explores with epsilon 1 (each action is JAX's
uniform draw), so that the actions do not pass through the two
frameworks' differently rounded matrix products: env states, observations
and the replay ring are then bit-equal at every step. Before each step the
port's learner state is set to the JAX trainer's (as ``chip_smoke.py``'s
``step_parity`` does for the env), so that the learners' differences do
not compound; every update the port's trainer makes is then held, through
``utils/error_bounds.check_update``, to the JAX package's update of the
same state on JAX's own sample of its ring and JAX's smoothing noise: the
Adam moments within (1 - b) times the derived float32 bound of the
gradients, the parameters within what the two sides' moments imply. With
one update a step the port's step is also held so to the JAX trainer's
own step."""
import argparse
import csv
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crowdnav_tpu.agents.td3 import TD3 as JTD3
from crowdnav_tpu.agents.td3 import TD3Config as JTD3Config
from crowdnav_tpu.envs import CrowdEnv, make_config
from crowdnav_tpu.parallel import Trainer as JTrainer
from crowdnav_tpu.parallel import TrainerConfig as JTrainerConfig
from crowdnav_tpu_torch.agents.replay import Transition
from crowdnav_tpu_torch.agents.td3 import TD3, TD3Config
from crowdnav_tpu_torch.drivers import evaluate as tevaluate
from crowdnav_tpu_torch.drivers import train as ttrain
from crowdnav_tpu_torch.envs import config as tcfg
from crowdnav_tpu_torch.envs.crowd_env import CrowdEnv as TCrowdEnv
from crowdnav_tpu_torch.parallel.runtime import (StepDraws, Trainer,
                                                 TrainerConfig)
from crowdnav_tpu_torch.utils import checkpoint as tckpt
from crowdnav_tpu_torch.utils.convert import state_to_arrays
from crowdnav_tpu_torch.utils.error_bounds import check_update
from crowdnav_tpu_torch.utils.logging import EpisodeLogger
from test_torch_replay import _bits, _tbits
from test_torch_td3 import export_module, to_jax, to_port
from torch_parity import assert_env_state_equal, env_state_to_torch

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "results", "r5", "final_full", "agent_ckpt_td3")
N, CHUNK, BATCH = 16, 8, 32
AGENT_KW = dict(hidden=32, batch_size=BATCH, buffer_size=4 * N,
                explore_uniform_eps=1.0)


def _jax_draws(key, n_updates, rows, lo, hi):
    """The draws of one JAX ``Trainer._train_step`` from its loop key
    (act, bank, samples, smoothing noise), each update's (sample key,
    update key), and the next loop key."""
    key, k_act, k_sample, k_update, k_bank = jax.random.split(key, 5)
    k_noise, k_eps, k_unif = jax.random.split(k_act, 3)
    unif = jax.jit(lambda k: jax.random.uniform(
        k, (N, 2), minval=lo, maxval=hi))(k_unif)
    act = (jax.random.normal(k_noise, (N, 2)), unif,
           jax.random.uniform(k_eps, (N, 1)))
    k_idx, _ = jax.random.split(k_bank)
    bank_idx = jax.random.randint(k_idx, (N,), 0, N)
    samples, smooth, keys = [], [], []
    for k in jax.random.split(k_update, n_updates):
        ks, ku = jax.random.split(k)
        keys.append(ks)
        samples.append(jax.random.randint(ks, (BATCH,), 0, max(rows, 1)))
        smooth.append(jax.random.normal(ku, (BATCH, 2)))

    def t(a):
        return torch.from_numpy(np.array(a))

    return key, StepDraws(act=[t(a) for a in act], bank_idx=t(bank_idx),
                          sample_idx=[t(s) for s in samples],
                          smoothing=[t(s) for s in smooth]), keys


def _f32(a):
    return np.asarray(a, np.float32)


def _metrics(m):
    return {k: torch.from_numpy(np.array(v)) for k, v in m.items()}


@pytest.mark.parametrize("updates", [1, 2])
def test_learning_chunk_matches_jax(updates):
    kw = dict(jitter=1.0, max_steps=6)
    jenv = CrowdEnv(make_config("crowd_dense", "crossing", **kw))
    jagent = JTD3(JTD3Config(**AGENT_KW), jenv.obs_dim)
    jcfg = dict(n_envs=N, rollout_chunk=1, updates_per_step=updates,
                learn_start=2 * N, reset_bank=N,
                replay_obs_dtype="bfloat16")
    jt = JTrainer(jenv, jagent, JTrainerConfig(**jcfg))
    jstep = jax.jit(jt.rollout_chunk)
    jsample = jax.jit(lambda r, k: jt.buffer.sample(r, k, BATCH))
    jupdate = jax.jit(lambda s, b, n: jagent.update(
        s, b, jax.random.PRNGKey(0), smoothing_noise=n))
    js = jt.init(jax.random.PRNGKey(0))

    tenv = TCrowdEnv(tcfg.make_config("crowd_dense", "crossing", **kw),
                     device="cpu")
    st, obs = jenv._template
    tenv.template = (env_state_to_torch(jax.tree.map(lambda a: a[None], st)),
                     torch.from_numpy(np.array(obs))[None])
    tagent = TD3(TD3Config(**AGENT_KW), tenv.obs_dim, device="cpu")
    tt = Trainer(tenv, tagent, TrainerConfig(**jcfg))
    bank_states, bank_obs = js.reset_bank
    ts = dataclasses.replace(
        tt.init(0), env_states=env_state_to_torch(js.env_states),
        obs=torch.from_numpy(np.array(js.obs)),
        reset_bank=(env_state_to_torch(bank_states),
                    torch.from_numpy(np.array(bank_obs))))
    start = to_port(tagent, js.agent_state)

    # every update the trainer makes: (state in, batch, noise, state out,
    # metrics)
    calls = []
    update = tagent.update

    def recorded(state, batch, gen=None, smoothing_noise=None):
        new, m = update(state, batch, gen=gen,
                        smoothing_noise=smoothing_noise)
        calls.append((state, batch, smoothing_noise, new, m))
        return new, m

    tagent.update = recorded
    key = js.key
    lo, hi = jnp.array([0.0, -2.0]), jnp.array([0.22, 2.0])
    n_updates, shares = 0, []
    for step in range(CHUNK):
        # JAX samples after this step's add: the rows it will hold
        rows_after = min(int(js.replay.size) + N, jt.buffer.capacity)
        key, draws, skeys = _jax_draws(key, updates, rows_after // N * N,
                                       lo, hi)
        pre = to_port(tagent, js.agent_state)
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
            for name in ("obs", "action", "reward", "next_obs", "done"):
                np.testing.assert_array_equal(
                    _tbits(getattr(t, name)), _bits(getattr(j, name)),
                    err_msg=f"step {step} block {b} {name}")
        if int(js.agent_state.update_count) == int(pre.update_count):
            # the learn gate is still shut on both sides
            assert not calls and ts.agent_state is pre, step
            continue
        assert len(calls) == updates, step
        assert calls[0][0] is pre
        for u, (s_in, batch, noise, s_out, m) in enumerate(calls):
            if u:
                assert s_in is calls[u - 1][3], (step, u)
            # JAX's sample of its own ring and JAX's smoothing noise
            jb = jsample(js.replay, skeys[u])
            for name, got, want in zip(Transition._fields, batch, jb):
                np.testing.assert_array_equal(
                    _f32(got.float()), _f32(want),
                    err_msg=f"step {step} update {u} batch {name}")
            np.testing.assert_array_equal(
                noise.numpy(), _f32(draws.smoothing[u]))
            ref, mj = jupdate(to_jax(tagent, s_in, js.agent_state), jb,
                              jnp.asarray(noise.numpy()))
            shares.append(check_update(tagent, s_in, batch, noise, s_out,
                                       to_port(tagent, ref), _metrics(mj)))
        assert ts.agent_state is calls[-1][3]
        for k, v in calls[-1][4].items():
            assert torch.equal(ts.learn_metrics[k], v), k
        if updates == 1:
            # the port's step against the JAX trainer's own step
            s_in, batch, noise, _, _ = calls[0]
            shares.append(check_update(
                tagent, pre, batch, noise, ts.agent_state,
                to_port(tagent, js.agent_state),
                _metrics(js.learn_metrics)))
        n_updates += updates
    assert int(js.replay.size) == jt.buffer.capacity   # the ring wrapped
    assert n_updates >= 4
    assert int(ts.agent_state.update_count) == n_updates
    grads = [s[k] for s in shares for k in ("critic_grad", "actor_grad")]
    assert max(grads) < 0.5, shares
    for name in ("actor_params", "critic_params"):
        moved = (getattr(ts.agent_state, name)
                 - getattr(start, name)).abs().max()
        assert float(moved) > 0.0, name
    summary, _ = tt.drain_stats(ts)
    jsummary, _ = jt.drain_stats(js)
    for k in ("episodes", "successes", "failures", "greedy_episodes"):
        assert summary[k] == jsummary[k], k
    for k in ("critic_loss", "actor_loss", "q_target_mean"):
        assert k in summary and np.isfinite(summary[k]) and k in jsummary


def test_agent_checkpoint_equals_restore_agent_state(tmp_path):
    """The committed JAX agent checkpoint, exported to the port's agent
    file and read by the port, equals the JAX package's
    ``restore_agent_state`` of it, array for array; the port's own agent
    file round-trips."""
    from crowdnav_tpu.drivers.train import build_agent_from_metadata
    from crowdnav_tpu.utils.checkpoint import (load_run_metadata,
                                               restore_agent_state)
    out = str(tmp_path / "final_full_agent.npz")
    export_module().export(CKPT, out)
    meta = load_run_metadata(CKPT)
    jagent, _ = build_agent_from_metadata("td3", meta["agent_config"],
                                          meta["obs_dim"], 1)
    jstate = restore_agent_state(CKPT, jax.jit(jagent.init)(
        jax.random.PRNGKey(0)))
    want = export_module().state_arrays(jax.tree.map(np.asarray, jstate))
    tagent = TD3(TD3Config(**{k: v for k, v in meta["agent_config"].items()
                              if k in {f.name for f in dataclasses.fields(
                                  TD3Config)}}), meta["obs_dim"],
                 device="cpu")
    tstate, tmeta = tckpt.load_agent(out, tagent)
    assert tmeta == meta
    assert int(tstate.update_count) == int(jstate.update_count) > 0
    got = state_to_arrays(tagent, tstate)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    path = tckpt.save_agent(str(tmp_path / "agent"), tagent, tstate, 7, meta)
    back, _ = tckpt.load_agent(str(tmp_path / "agent"), tagent)
    assert path.endswith("agent_7.npz")
    for k, v in state_to_arrays(tagent, back).items():
        np.testing.assert_array_equal(v, got[k], err_msg=k)


@pytest.mark.parametrize("chunk,detect", [(0, 1), (0, 24), (22, 24),
                                          (23, 24), (40, 24)])
def test_collapse_verdict_matches_jax(chunk, detect):
    from crowdnav_tpu.drivers.train import collapse_verdict as jverdict
    args = argparse.Namespace(collapse_detect_chunk=detect,
                              collapse_reward_threshold=-100.0)
    for summary in ({"episodes": 0, "mean_reward": -400.0},
                    {"episodes": 12, "mean_reward": -400.0},
                    {"episodes": 12, "mean_reward": -100.0},
                    {"episodes": 3, "mean_reward": 450.0}):
        assert ttrain.collapse_verdict(summary, chunk, args) == \
            jverdict(summary, chunk, args)


TINY = ["--algo", "td3", "--device", "cpu", "--n-envs", "8", "--chunk",
        "4", "--env-steps", "64", "--updates-per-step", "2",
        "--batch-size", "16", "--learn-start", "16", "--max-steps", "16",
        "--jitter", "1.0", "--explore-eps", "1.0", "--explore-eps-min",
        "0.05", "--explore-spectrum", "--replay-obs-dtype", "bfloat16",
        "--ckpt-every-chunks", "1", "--buffer-size", "64"]


def _events(out):
    return [json.loads(line) for line in out.splitlines()
            if line.startswith("{")]


def test_train_driver_on_cpu_writes_csv_and_run_config(tmp_path, capsys):
    from crowdnav_tpu.drivers.train import run_metadata as jmeta
    ttrain.main(TINY + ["--outdir", str(tmp_path)])
    ev = _events(capsys.readouterr().out)
    chunks = [e for e in ev if "sps" in e]
    assert [c["env_steps"] for c in chunks] == [32, 64]
    assert all(np.isfinite(c["critic_loss"]) for c in chunks)
    assert ev[-1]["event"] == "done" and ev[-1]["env_steps"] == 64
    with open(tmp_path / "td3_training.csv") as fp:
        rows = list(csv.reader(fp))
    assert rows[0][-2:] == ["greedy_episodes", "greedy_success_rate"]
    assert len(rows) == 3 and all(len(r) == 10 for r in rows)
    meta = tckpt.load_run_metadata(str(tmp_path / "agent_ckpt_td3"))
    args = ttrain.parser().parse_args(TINY + ["--outdir", str(tmp_path)])
    trainer = ttrain.build(args)
    want = jmeta(args, trainer)
    assert set(meta) == set(want)
    assert meta == json.loads(json.dumps(want))
    jfields = {f.name for f in dataclasses.fields(JTD3Config)}
    assert set(meta["agent_config"]) == jfields
    # the port's evaluate reads the agent checkpoint drivers/train wrote
    from crowdnav_tpu_torch.drivers import evaluate
    results = evaluate.main(["--device", "cpu", "--suite", "train",
                             "--checkpoint", str(tmp_path / "agent_ckpt_td3"),
                             "--n-envs", "2", "--max-steps", "4",
                             "--outdir", str(tmp_path)])
    assert results[0]["episodes"] == 2


def test_train_driver_restart_and_resume_keep_the_wasted_steps(tmp_path,
                                                                 capsys):
    """A verdict that is always 'collapsed' restarts once; the final
    attempt's verdict is printed too; the printed env-steps count the
    restarted attempt's; a resume keeps that count."""
    out = ["--outdir", str(tmp_path), "--restart-on-collapse", "1",
           "--collapse-detect-chunk", "1",
           "--collapse-reward-threshold", "1e9", "--max-steps", "3"]
    ttrain.main(TINY + out)
    ev = _events(capsys.readouterr().out)
    checks = [e for e in ev if e.get("event") == "collapse_check"]
    assert [c["restart"] for c in checks] == [True, False]
    assert [c["verdict"] for c in checks] == ["collapsed", "collapsed"]
    assert [e["env_steps"] for e in ev if "sps" in e] == [32, 64, 96]
    assert ev[-1]["env_steps"] == 32 + 64
    ttrain.main([a if a != "64" else "128" for a in TINY] + out
                + ["--resume"])
    ev = _events(capsys.readouterr().out)
    assert [e["env_steps"] for e in ev if "sps" in e] == [128, 160]
    assert ev[-1]["env_steps"] == 32 + 128


def test_full_checkpoint_round_trips(tmp_path):
    args = ttrain.parser().parse_args(TINY + ["--outdir", str(tmp_path)])
    trainer = ttrain.build(args)
    state = trainer.rollout_chunk(trainer.init(3))
    tckpt.save_checkpoint(str(tmp_path / "ck"), state, 32,
                          {"wasted_steps": 5})
    back, step, counters = tckpt.restore_checkpoint(str(tmp_path / "ck"),
                                                    trainer.init(4))
    assert step == 32 and counters == {"wasted_steps": 5}
    assert back.learning_open == state.learning_open
    for f in dataclasses.fields(state.replay):
        assert torch.equal(getattr(back.replay, f.name),
                           getattr(state.replay, f.name)), f.name
    assert torch.equal(back.agent_state.critic_opt.nu,
                       state.agent_state.critic_opt.nu)
    a = trainer.rollout_chunk(state)
    b = trainer.rollout_chunk(back)
    assert torch.equal(a.obs, b.obs)
    assert torch.equal(a.agent_state.actor_params,
                       b.agent_state.actor_params)


@pytest.mark.parametrize("flags", [
    ["--algo", "ddpg", "--learner-dtype", "bfloat16"],
    ["--n-devices", "2", "--n-envs", "3"],
    ["--multihost"], ["--profile-dir", "x", "--env-steps", "2048"]])
def test_train_driver_refuses_unported_options(flags, tmp_path,
                                               monkeypatch):
    """The option the port leaves out (DDPG's bfloat16 learner) raises;
    the options of several devices and the profiler trace, ported since,
    refuse what they cannot run: an env batch that does not split over
    the ranks, a multi-host launch without a coordinator, a trace of a
    chunk the run never reaches."""
    for name in ("JAX_COORDINATOR_ADDRESS", "MASTER_ADDR", "MASTER_PORT",
                 "JAX_NUM_PROCESSES", "WORLD_SIZE", "JAX_PROCESS_ID",
                 "RANK"):
        monkeypatch.delenv(name, raising=False)
    argv = ["--algo", "td3", "--device", "cpu", "--outdir", str(tmp_path)]
    match = {"--learner-dtype": "not ported", "--n-devices": "does not "
             "split", "--multihost": "no coordinator",
             "--profile-dir": "traces chunk 2"}[flags[2 if flags[0] ==
                                                     "--algo" else 0]]
    with pytest.raises(SystemExit, match=match):
        ttrain.main(argv + flags)


@pytest.mark.parametrize("flags", [
    ["--actuation-noise", "0.05"], ["--dt-jitter", "0.15"],
    ["--lidar-noise", "0.005"], ["--learner-dtype", "bfloat16"],
    ["--risk-backend", "pallas"],
    ["--risk-backend", "pallas", "--actuation-noise", "0.05", "--dt-jitter",
     "0.15", "--lidar-noise", "0.005", "--learner-dtype", "bfloat16"]],
    ids=["actuation_noise", "dt_jitter", "lidar_noise", "bf16_learner",
         "risk_pallas", "all_together"])
def test_train_driver_runs_the_noise_backend_and_dtype_options(flags,
                                                              tmp_path,
                                                              capsys):
    """The noise knobs, the Pallas risk backend and TD3's bfloat16 learner
    run a tiny CPU training to its end and reach the env's config and the
    agent's; ``evaluate`` reads the agent checkpoint back with its
    config."""
    out = str(tmp_path)
    argv = ["--algo", "td3", "--device", "cpu", "--n-envs", "8", "--chunk",
            "4", "--env-steps", "64", "--updates-per-step", "2",
            "--batch-size", "16", "--learn-start", "16", "--max-steps", "16",
            "--jitter", "1.0", "--buffer-size", "64", "--outdir", out]
    args = ttrain.parser().parse_args(argv + flags)
    trainer = ttrain.build(args)
    cfg = trainer.env.cfg
    want = {"--actuation-noise": ("actuation_noise", 0.05),
            "--dt-jitter": ("dt_jitter", 0.15),
            "--lidar-noise": ("lidar_noise", 0.005),
            "--risk-backend": ("risk_backend", "pallas")}
    for flag in flags:
        if flag in want:
            field, value = want[flag]
            assert getattr(cfg, field) == value
    if "--learner-dtype" in flags:
        assert trainer.agent.dtype == torch.bfloat16
    ttrain.main(argv + flags)
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    assert lines[-1]["event"] == "done"
    meta = tckpt.load_run_metadata(os.path.join(out, "agent_ckpt_td3"))
    dtype = "bfloat16" if "--learner-dtype" in flags else "float32"
    assert meta["agent_config"]["compute_dtype"] == dtype
    res = tevaluate.main(["--suite", "train", "--checkpoint",
                          os.path.join(out, "agent_ckpt_td3"), "--n-envs",
                          "4", "--max-steps", "8", "--outdir", out,
                          "--device", "cpu"])
    assert res and res[0]["episodes"] >= 0


def test_episode_logger_extra_headers_match_jax(tmp_path):
    from crowdnav_tpu.utils.logging import EpisodeLogger as JLogger
    summary = {"episodes": 5, "successes": 3, "failures": 2,
               "mean_reward": 12.34567, "mean_steps": 40.123,
               "mean_ego_safety": 0.98765, "mean_social_safety": 0.9,
               "greedy_episodes": 4, "greedy_success_rate": 0.666666}
    extra = ["greedy_episodes", "greedy_success_rate"]
    for d, cls in (("j", JLogger), ("t", EpisodeLogger)):
        cls(str(tmp_path / d), "x", extra_headers=extra).record_summary(
            summary, 10, 1.23456)
    # reopening with other columns rewrites the header, pads old rows
    for d, cls in (("j", JLogger), ("t", EpisodeLogger)):
        cls(str(tmp_path / d), "x", extra_headers=extra + ["more"])
    assert (tmp_path / "j" / "x.csv").read_text() == \
        (tmp_path / "t" / "x.csv").read_text()


def test_build_takes_config_overrides():
    """``build``'s overrides reach the env's config (the fields the JAX
    driver's command line does not expose: the lidar backend, the strict
    quirks), and the config refuses the Pallas tracker with strict
    quirks, as the JAX package does."""
    args = ttrain.parser().parse_args(
        ["--algo", "td3", "--device", "cpu", "--n-envs", "4",
         "--buffer-size", "16"])
    trainer = ttrain.build(args, lidar_backend="pallas", strict_quirks=True)
    assert trainer.env.cfg.lidar_backend == "pallas"
    assert trainer.env.cfg.strict_quirks
    args = ttrain.parser().parse_args(
        ["--algo", "td3", "--device", "cpu", "--n-envs", "4",
         "--buffer-size", "16", "--risk-backend", "pallas"])
    with pytest.raises(ValueError, match="strict_quirks"):
        ttrain.build(args, strict_quirks=True)
