"""Training driver of the port (``crowdnav_tpu/drivers/train.py``): TD3
and DDPG on the perceived-risk env, SAC and DQN on the simple env (as the
reference's drivers pair them); chunked batched training, one aggregate
CSV row per chunk in the reference's schema plus the greedy cohort's
columns, periodic and final checkpoints, and the collapse restart of the
flagship recipe.

    python -m crowdnav_tpu_torch.drivers.train --algo td3 \\
        --world crowd_dense --behavior crowd --n-envs 16384 --chunk 64 \\
        --env-steps 64e6 --updates-per-step 32 --batch-size 4096 \\
        --learn-start 32768 --replay-obs-dtype bfloat16 --jitter 1.0 \\
        --explore-eps 1.0 --explore-eps-min 0.05 --explore-spectrum \\
        --restart-on-collapse 3 --outdir results/torch_full
    python -m crowdnav_tpu_torch.drivers.train --algo dqn \\
        --world crowd_sparse --behavior random --n-envs 512 --chunk 64 \\
        --updates-per-step 32 --jitter 1.0 --outdir results/torch_dqn

Several devices: ``--n-devices N`` starts N ranks on this host, one card
each (``--device cpu``: N CPU ranks over gloo); ``--multihost`` with
``--coordinator host:port --num-processes P --process-id i`` (or the
environment, ``parallel/distributed.init_multihost``) runs this process as
rank i of P, started the same way on every host. Either trains the sharded
learner (``parallel/mesh.ShardedTrainer``): ``--n-envs`` and
``--batch-size`` are global, only rank 0 logs, writes the CSV and the
agent checkpoint, and each rank writes its own rows of the full trainer
state (``ckpt_<algo>/rank<i>``) for ``--resume``. ``--profile-dir``
writes a Chrome trace of chunk 2 (``utils/profiling.trace``).
``--risk-backend pallas`` runs the tracker kernel's Pallas form,
``--learner-dtype bfloat16`` TD3's bfloat16 matmuls; the port adds
``--buffer-size``. The chunks run through ``Trainer.make_jitted`` (on the
card one captured CUDA graph of the step), as the JAX driver's jitted
chunk; the sharded learner's through ``rollout_chunk``. Config fields the JAX
driver does not expose (``lidar_backend``, ``strict_quirks``) reach the
env through :func:`build`'s overrides. Three faults of the JAX driver
are not carried over: the final attempt's
collapse verdict is printed, the printed ``env_steps`` count the steps of
collapse-restarted attempts, and ``--resume`` keeps that count.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import socket
import subprocess
import sys
import time

import torch

from crowdnav_tpu_torch.agents.ddpg import DDPG, DDPGConfig
from crowdnav_tpu_torch.agents.dqn import DQN, DQNConfig
from crowdnav_tpu_torch.agents.sac import SAC, SACConfig
from crowdnav_tpu_torch.agents.td3 import TD3, TD3Config
from crowdnav_tpu_torch.envs.config import (ABLATION_PRESETS, ROBOT_PRESETS,
                                            make_config)
from crowdnav_tpu_torch.envs.crowd_env import CrowdEnv
from crowdnav_tpu_torch.envs.simple_env import SimpleEnv
from crowdnav_tpu_torch.parallel import distributed
from crowdnav_tpu_torch.parallel.mesh import ShardedTrainer, make_mesh
from crowdnav_tpu_torch.parallel.runtime import Trainer, TrainerConfig
from crowdnav_tpu_torch.utils.checkpoint import (latest_step,
                                                 restore_checkpoint,
                                                 save_agent, save_checkpoint,
                                                 save_run_metadata)
from crowdnav_tpu_torch.utils.device import resolve
from crowdnav_tpu_torch.utils.logging import EpisodeLogger
from crowdnav_tpu_torch.utils.profiling import StepThroughput, trace_if


# the reference's pairing: TD3 and DDPG on the perceived-risk env, SAC and
# DQN on the simple env (the JAX driver's RISK_ENV_ALGOS)
RISK_ENV_ALGOS = {"td3", "ddpg"}
DISCRETE_ALGOS = {"dqn"}          # index actions, SimpleEnv.step_discrete
CONFIG_CLS = {"td3": TD3Config, "ddpg": DDPGConfig, "sac": SACConfig,
              "dqn": DQNConfig}


def make_agent(algo: str, cfg, obs_dim: int, n_envs: int, device):
    """``(agent, discrete)`` for a config of ``CONFIG_CLS[algo]``."""
    if algo == "td3":
        agent = TD3(cfg, obs_dim, device=device)
    elif algo == "ddpg":
        agent = DDPG(cfg, obs_dim, n_envs=n_envs, device=device)
    elif algo == "sac":
        agent = SAC(cfg, obs_dim, device=device)
    else:
        agent = DQN(cfg, obs_dim, device=device)
    return agent, algo in DISCRETE_ALGOS


def build_agent_from_metadata(algo: str, cfg_dict: dict | None,
                              obs_dim: int, n_envs: int, device):
    """``(agent, discrete)`` with a checkpoint's ``agent_config``; unknown
    keys are dropped and a missing config (checkpoints written before
    ``run_config.json`` existed) gives the defaults, as the JAX driver
    restores against a default template."""
    cls = CONFIG_CLS[algo]
    fields = {f.name for f in dataclasses.fields(cls)}
    kw = {k: v for k, v in (cfg_dict or {}).items() if k in fields}
    if "hidden" in kw and isinstance(kw["hidden"], list):
        kw["hidden"] = tuple(kw["hidden"])        # DQN's, through JSON
    return make_agent(algo, cls(**kw), obs_dim, n_envs, device)


def build_agent(args, obs_dim: int, device):
    """``(agent, discrete)`` of the command line (``_build_agent`` of the
    JAX driver): TD3 takes the learning rates, the sigma anneal and the
    exploration flags; DDPG the actor's rate and the exploration flags;
    SAC and DQN the batch size only; ``--learner-dtype`` is TD3's.
    ``--buffer-size`` (the port's option) applies to all."""
    kw = {}
    if args.batch_size:
        kw.update(batch_size=args.batch_size)
    if args.buffer_size:
        kw.update(buffer_size=args.buffer_size)
    if args.algo in ("td3", "ddpg"):
        if args.actor_lr:
            kw.update(actor_lr=args.actor_lr)
        if args.explore_eps:
            kw.update(explore_uniform_eps=args.explore_eps)
            if args.explore_eps_min is not None:
                kw.update(explore_uniform_eps_min=args.explore_eps_min)
            if args.explore_spectrum:
                kw.update(explore_eps_spectrum=True)
    if args.algo == "td3":
        if args.learner_dtype:
            kw.update(compute_dtype=args.learner_dtype)
        if args.critic_lr:
            kw.update(critic_lr=args.critic_lr)
        if args.sigma_min is not None:
            kw.update(explore_sigma_min=args.sigma_min,
                      explore_decay_steps=int(args.sigma_decay_steps))
    return make_agent(args.algo, CONFIG_CLS[args.algo](**kw), obs_dim,
                      args.n_envs, device)


def run_metadata(args, trainer) -> dict:
    """Everything evaluate and resume need to rebuild the agent and env;
    the keys of the JAX driver's ``run_metadata``."""
    return {
        "algo": args.algo,
        "agent_config": dataclasses.asdict(trainer.agent.cfg),
        "obs_dim": trainer.env.obs_dim,
        "world": args.world,
        "behavior": args.behavior,
        "ablation": args.ablation,
        "robot": args.robot,
        "jitter": args.jitter,
        "actuation_noise": args.actuation_noise,
        "dt_jitter": args.dt_jitter,
        "lidar_noise": args.lidar_noise,
        "n_envs": args.n_envs,
        "updates_per_step": args.updates_per_step,
        "replay_obs_dtype": args.replay_obs_dtype or "float32",
        "seed": args.seed,
    }


def collapse_verdict(summary: dict, chunk: int, args):
    """Early-collapse gate of ``--restart-on-collapse`` (the JAX driver's,
    calibrated on the round-5 corpus): None while deferred (before the
    detection chunk, or no episode in this chunk's window), else True
    (collapsed: mean episode reward below the threshold) or False."""
    if chunk + 1 < args.collapse_detect_chunk:
        return None
    if summary["episodes"] == 0:
        return None
    return summary["mean_reward"] < args.collapse_reward_threshold


def _check_flags(args):
    if args.learner_dtype == "bfloat16" and args.algo != "td3":
        raise SystemExit(f"--learner-dtype bfloat16 is not ported for "
                         f"{args.algo} (the JAX driver applies it to TD3 "
                         f"only)")
    ranks = args.num_processes if args.multihost else args.n_devices
    if ranks and ranks > 1 and args.n_envs % ranks:
        raise SystemExit(f"--n-envs {args.n_envs} does not split over "
                         f"{ranks} ranks")
    chunks = int(args.env_steps // (args.n_envs * args.chunk))
    if args.profile_dir and chunks < 3:
        raise SystemExit(f"--profile-dir traces chunk 2; the run has "
                         f"{chunks} chunks")


def build(args, device=None, learning: bool = True,
          **overrides) -> Trainer:
    """The trainer of the command line on ``device`` (default
    ``--device``): the sharded trainer over the process group's ranks
    under ``--multihost``; ``learning`` False gives the rollout without
    replay or updates; ``overrides``: further env config fields."""
    device = resolve(args.device if device is None else device)
    knobs = {k: v for k, v in (
        ("actuation_noise", args.actuation_noise),
        ("dt_jitter", args.dt_jitter), ("lidar_noise", args.lidar_noise),
        ("risk_backend", args.risk_backend)) if v}
    cfg = make_config(args.world, args.behavior, ablation=args.ablation,
                      jitter=args.jitter, robot=args.robot,
                      max_steps=args.max_steps, **knobs, **overrides)
    env_cls = CrowdEnv if args.algo in RISK_ENV_ALGOS else SimpleEnv
    env = env_cls(cfg, device=device, seed=args.seed)
    agent, discrete = build_agent(args, env.obs_dim, device)
    reset_bank = args.reset_bank
    if args.jitter and not reset_bank:
        # jittered resets need distinct spawns at every auto-reset
        reset_bank = max(256, args.n_envs)
    tcfg = TrainerConfig(n_envs=args.n_envs, rollout_chunk=args.chunk,
                         updates_per_step=args.updates_per_step,
                         learn_start=args.learn_start, reset_bank=reset_bank,
                         replay_obs_dtype=args.replay_obs_dtype or "float32",
                         learning=learning)
    if args.multihost:
        return ShardedTrainer(env, agent, tcfg, make_mesh(None),
                              discrete=discrete)
    return Trainer(env, agent, tcfg, discrete=discrete)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--algo", required=True,
                   choices=["td3", "ddpg", "sac", "dqn"])
    p.add_argument("--world", default="crowd_dense")
    p.add_argument("--behavior", default="crowd")
    p.add_argument("--ablation", default=None, choices=list(ABLATION_PRESETS))
    p.add_argument("--robot", default=None, choices=list(ROBOT_PRESETS))
    p.add_argument("--n-envs", type=int, default=1024)
    p.add_argument("--n-devices", type=int, default=1)
    p.add_argument("--env-steps", type=float, default=2e6)
    p.add_argument("--chunk", type=int, default=128)
    p.add_argument("--max-steps", type=int, default=500)
    p.add_argument("--updates-per-step", type=int, default=1)
    p.add_argument("--learn-start", type=int, default=1024)
    p.add_argument("--learner-dtype", default=None,
                   choices=["float32", "bfloat16"])
    p.add_argument("--replay-obs-dtype", default=None,
                   choices=["float32", "bfloat16"])
    p.add_argument("--actor-lr", type=float, default=None)
    p.add_argument("--critic-lr", type=float, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--buffer-size", type=int, default=None,
                   help="replay rows (the port's option; default the agent "
                        "config's 1,000,000, rounded up to whole blocks of "
                        "--n-envs)")
    p.add_argument("--jitter", type=float, default=0.0)
    p.add_argument("--actuation-noise", type=float, default=0.0)
    p.add_argument("--dt-jitter", type=float, default=0.0)
    p.add_argument("--risk-backend", default=None, choices=["xla", "pallas"],
                   help="tracker -> CP -> top-K form (default: the "
                        "config's 'xla')")
    p.add_argument("--lidar-noise", type=float, default=0.0)
    p.add_argument("--reset-bank", type=int, default=0)
    p.add_argument("--sigma-min", type=float, default=None)
    p.add_argument("--sigma-decay-steps", type=float, default=1e6)
    p.add_argument("--explore-eps", type=float, default=0.0)
    p.add_argument("--explore-eps-min", type=float, default=None)
    p.add_argument("--explore-spectrum", action="store_true")
    p.add_argument("--outdir", default="results")
    p.add_argument("--ckpt-every-chunks", type=int, default=50)
    p.add_argument("--snapshot-every-chunks", type=int, default=0)
    p.add_argument("--restart-on-collapse", type=int, default=0,
                   metavar="N")
    p.add_argument("--collapse-detect-chunk", type=int, default=24)
    p.add_argument("--collapse-reward-threshold", type=float,
                   default=-100.0)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--profile-dir", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--multihost", action="store_true")
    p.add_argument("--coordinator", default=None)
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device, 'cuda' (default) or 'cpu'")
    return p


def _emit(obj):
    # one write a line: the ranks of --n-devices share one stdout, and a
    # line written in two parts (unbuffered, print's text then its
    # newline) can interleave with another rank's
    sys.stdout.write(json.dumps(obj) + "\n")
    sys.stdout.flush()


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def spawn_ranks(args, argv) -> int:
    """``--n-devices N``: this command as N ``--multihost`` ranks on this
    host, rank i on card i (or all on the CPU); returns the exit code,
    non-zero if a rank failed (the others are then stopped)."""
    n = args.n_devices
    try:
        device = resolve(args.device)
    except RuntimeError as e:       # --device cuda, no card
        raise SystemExit(str(e))
    if device.type == "cuda" and n > torch.cuda.device_count():
        raise SystemExit(f"--n-devices {n}: this host has "
                         f"{torch.cuda.device_count()} CUDA devices (one "
                         f"rank a card)")
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))
    coordinator = f"localhost:{_free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "crowdnav_tpu_torch.drivers.train", *argv,
         "--multihost", "--coordinator", coordinator,
         "--num-processes", str(n), "--process-id", str(i)], env=env)
        for i in range(n)]
    try:
        while True:
            codes = [proc.poll() for proc in procs]
            failed = [c for c in codes if c]
            if failed or all(c == 0 for c in codes):
                return failed[0] if failed else 0
            time.sleep(0.2)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parser().parse_args(argv)
    _check_flags(args)
    if args.n_devices > 1 and not args.multihost:
        code = spawn_ranks(args, argv)
        if code:
            raise SystemExit(f"a rank exited with code {code}")
        return None
    device = None
    try:
        if args.multihost:
            try:
                device = distributed.init_multihost(
                    args.coordinator, args.num_processes, args.process_id,
                    device=args.device)
            except ValueError as e:     # no coordinator, count or id
                raise SystemExit(str(e))
        return _train(args, device)
    except RuntimeError as e:
        if "CUDA is not available" in str(e):   # --device cuda, no card
            raise SystemExit(str(e))
        raise
    finally:
        if args.multihost:
            distributed.shutdown()


def _train(args, device):
    """The training loop of one process (every rank under
    ``--multihost``; rank 0 logs and writes the agent's files)."""
    rank, world = distributed.world()
    if args.multihost:
        _emit(distributed.process_summary())
    trainer = build(args, device)
    main_rank = rank == 0
    emit = _emit if main_rank else (lambda obj: None)
    agent = trainer.agent
    t_init = time.time()
    state = trainer.init(args.seed)
    emit({"event": "initialized", "secs": round(time.time() - t_init, 1)})
    ckpt_dir = f"{args.outdir}/ckpt_{args.algo}"
    own_dir = ckpt_dir if world == 1 else f"{ckpt_dir}/rank{rank}"
    agent_dir = f"{args.outdir}/agent_ckpt_{args.algo}"
    snap_dir = f"{args.outdir}/agent_snapshots_{args.algo}"
    steps_done, wasted_steps, attempt = 0, 0, 0
    if args.resume:
        # every rank restores the newest step that all ranks wrote
        step = latest_step(own_dir)
        step = distributed.all_min(-1 if step is None else step,
                                   trainer.device)
        state, steps_done, counters = restore_checkpoint(
            own_dir, state, None if step < 0 else step)
        wasted_steps = counters.get("wasted_steps", 0)
        attempt = counters.get("attempt", 0)
        emit({"event": "resumed", "step": steps_done,
              "wasted_steps": wasted_steps})
    meta = run_metadata(args, trainer)
    logger = None
    if main_rank:
        for d in [ckpt_dir, agent_dir] + (
                [snap_dir] if args.snapshot_every_chunks else []):
            save_run_metadata(d, meta)
        logger = EpisodeLogger(args.outdir, f"{args.algo}_training",
                               extra_headers=["greedy_episodes",
                                              "greedy_success_rate"])

    def chunk_runner():
        # the chunk over the state's fixed buffers, on the card one
        # captured CUDA graph of the step (the JAX driver's jitted, donated
        # chunk); the sharded learner all-reduces through the host, which
        # a graph cannot capture (NCCL capture is queued), so it steps
        # eagerly
        return trainer.rollout_chunk if isinstance(trainer, ShardedTrainer) \
            else trainer.make_jitted()

    run = chunk_runner()
    spc = args.n_envs * args.chunk
    n_chunks = max(1, int((args.env_steps - steps_done) // spc))
    throughput = StepThroughput(spc, device=trainer.device)
    episode_base = 0
    t_start = time.time()
    verdict_done = False
    chunk = 0

    def counters():
        return {"wasted_steps": wasted_steps, "attempt": attempt}

    while chunk < n_chunks:
        t0 = time.time()
        # a trace of chunk 2 (past the first chunks' warm-up), as the JAX
        # driver
        with trace_if(args.profile_dir, chunk == 2, f"chunk2_rank{rank}"):
            state = run(state)
            tput = throughput.tick()
        summary, state = trainer.drain_stats(state)
        if main_rank:
            logger.record_summary(summary, episode_base, time.time() - t0)
        episode_base += summary["episodes"]
        emit({"chunk": chunk,
              "env_steps": steps_done + wasted_steps + (chunk + 1) * spc,
              "sps": round(tput["sps"], 1),
              "sps_ema": round(tput["sps_ema"], 1),
              **{k: (round(v, 4) if isinstance(v, float) else v)
                 for k, v in summary.items()}})
        if args.restart_on_collapse and not verdict_done:
            # the summary is summed over the ranks: the same verdict on
            # every rank
            verdict = collapse_verdict(summary, chunk, args)
            if verdict is not None:
                verdict_done = True
                restart = verdict and attempt < args.restart_on_collapse
                emit({"event": "collapse_check",
                      "verdict": "collapsed" if verdict else "healthy",
                      "attempt": attempt, "chunk": chunk,
                      "mean_reward": round(summary["mean_reward"], 2),
                      "restart": restart})
                if restart:
                    attempt += 1
                    emit({"event": "collapse_restart", "attempt": attempt,
                          "mean_reward": round(summary["mean_reward"], 2),
                          "threshold": args.collapse_reward_threshold,
                          "new_seed": args.seed + 1009 * attempt})
                    wasted_steps += steps_done + (chunk + 1) * spc
                    steps_done = 0
                    # free the ring and the chunk's buffers before the
                    # next ones; the new chunk captures its own graph
                    state = run = None
                    state = trainer.init(args.seed + 1009 * attempt)
                    run = chunk_runner()
                    n_chunks = max(1, int(args.env_steps // spc))
                    chunk = 0
                    verdict_done = False
                    continue
        chunk += 1
        if hasattr(agent, "decay_epsilon"):
            # the reference decays epsilon once per episode; here once per
            # chunk, as the JAX driver
            state = dataclasses.replace(
                state, agent_state=agent.decay_epsilon(state.agent_state))
        if hasattr(agent, "decay_sigma"):
            # each attempt anneals from its own start
            state = dataclasses.replace(state, agent_state=agent.decay_sigma(
                state.agent_state, steps_done + chunk * spc))
        key = steps_done + wasted_steps + chunk * spc
        if args.ckpt_every_chunks and chunk % args.ckpt_every_chunks == 0:
            save_checkpoint(own_dir, state, steps_done + chunk * spc,
                            counters())
        if main_rank and args.snapshot_every_chunks \
                and chunk % args.snapshot_every_chunks == 0:
            save_agent(snap_dir, agent, state.agent_state, key, meta)
    final = steps_done + n_chunks * spc
    save_checkpoint(own_dir, state, final, counters())
    if main_rank:
        save_agent(agent_dir, agent, state.agent_state,
                   final + wasted_steps, meta)
    agent.sync_actor(state.agent_state)
    emit({"event": "done", "env_steps": wasted_steps + final,
          "attempt_env_steps": final, "collapse_restarts": attempt,
          "seconds": round(time.time() - t_start, 1),
          "device_memory": throughput.device_memory()})
    return state


if __name__ == "__main__":
    main()
