"""Evaluation driver of the port (``crowdnav_tpu/drivers/evaluate.py``):
greedy rollouts of N envs per scenario (TD3 and DDPG on the perceived-risk
env, SAC and DQN on the simple env), reporting success rate, mean reward
and steps, and ego/social safety in the reference's CSV schema.

    python -m crowdnav_tpu_torch.drivers.evaluate --suite train \
        --checkpoint crowdnav_tpu_torch/assets/final_full_actor.npz
    python -m crowdnav_tpu_torch.drivers.evaluate --algo ddpg --suite train \
        --checkpoint crowdnav_tpu_torch/assets/ddpg_peak \
        --checkpoint-step 1572864
    python -m crowdnav_tpu_torch.drivers.evaluate --algo dqn \
        --suite train_sparse \
        --checkpoint crowdnav_tpu_torch/assets/dqn_qnet.npz

``--checkpoint`` takes a policy exported by ``scripts/export_torch_actor.py``
or ``scripts/export_torch_agent.py --policy`` (the flax arrays of the
actor, or of DQN's Q-network, and the run's metadata), or an agent
checkpoint of the port's ``drivers/train`` (a directory of
``agent_<step>.npz`` files, where ``--checkpoint-step`` picks one, or one
of them; ``scripts/export_torch_agent.py`` writes the same format from a
JAX checkpoint). Without an ``agent_config`` in the metadata (checkpoints
written before ``run_config.json`` existed) the agent takes its config's
defaults. ``--trajectory`` adds, per scenario, one env's greedy rollout:
the reference's trajectory CSV, a path plot and the last frame
(:func:`trace_scenario`; the plots need matplotlib, and without it the
flag raises after the CSV is written). Each scenario's chunk runs through
``Trainer.make_jitted`` (on the card one captured CUDA graph of the step),
as the JAX driver runs its jitted chunk.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from crowdnav_tpu_torch.drivers.train import (DISCRETE_ALGOS,
                                              RISK_ENV_ALGOS,
                                              build_agent_from_metadata)
from crowdnav_tpu_torch.envs.config import ROBOT_PRESETS, make_config
from crowdnav_tpu_torch.envs.crowd_env import CrowdEnv
from crowdnav_tpu_torch.envs.simple_env import SimpleEnv
from crowdnav_tpu_torch.parallel.runtime import Trainer, TrainerConfig
from crowdnav_tpu_torch.utils.checkpoint import (agent_file,
                                                 load_run_metadata,
                                                 read_arrays)
from crowdnav_tpu_torch.utils.convert import (flax_actor_to_state_dict,
                                              npz_to_flax_actor)
from crowdnav_tpu_torch.utils.device import resolve
from crowdnav_tpu_torch.utils.logging import EpisodeLogger

SUITES = {
    "4": [("test_4", b) for b in ("crossing", "towards", "ahead", "random")],
    "8": [("test_8", b) for b in ("crossing", "towards", "ahead", "random")],
    "12": [("test_12", b)
           for b in ("crossing", "towards", "ahead", "random")],
    "20": [("test_20", b)
           for b in ("crossing_20", "towards_20", "ahead_20", "random_20")],
    "train": [("crowd_dense", "crowd")],
    "train_sparse": [("crowd_sparse", "crowd")],
    "hard": [("crowd_dense", "crowd_highspeed"), ("crowd_20", "crowd"),
             ("crowd_20", "crowd_highspeed"), ("test_20", "crossing_fast"),
             ("test_20", "towards_fast"), ("test_20", "random_fast")],
}


def load_actor_file(path: str, step: int | None = None,
                    algo: str = "td3"):
    """(flax params of the greedy policy, run metadata or None) from an
    exported policy file or an agent checkpoint (file, or directory with
    ``step`` or the newest); the policy is DQN's Q-network for ``dqn``,
    else the actor."""
    arrays, meta = read_arrays(agent_file(path, step))
    prefix = "params/" if algo == "dqn" else "actor_params/"
    if f"{prefix}Dense_0/kernel" in arrays:     # an agent checkpoint
        arrays = {k[len(prefix):]: v for k, v in arrays.items()
                  if k.startswith(prefix)}
        if meta is None and os.path.isdir(path):
            meta = load_run_metadata(path)
    return npz_to_flax_actor(arrays), meta


def build_agent(agent_cfg: dict | None, obs_dim: int, device,
                algo: str = "td3", n_envs: int = 1):
    """An agent of ``algo`` with the training run's config (unknown keys
    dropped; the defaults without one)."""
    return build_agent_from_metadata(algo, agent_cfg, obs_dim, n_envs,
                                     device)[0]


def scenario_trainer(agent, world: str, behavior: str, n_envs: int,
                     max_steps: int, seed: int, jitter: float = 0.0,
                     ablation: str | None = None, robot: str | None = None,
                     device="cuda", algo: str = "td3") -> Trainer:
    """The no-learn trainer of one scenario: ``n_envs`` greedy envs, one
    chunk of ``max_steps``; with ``jitter`` every env and every
    auto-reset (through a reset bank of ``n_envs`` entries) starts from a
    distinct randomized spawn."""
    cfg = make_config(world, behavior, max_steps=max_steps, jitter=jitter,
                      ablation=ablation, robot=robot)
    env_cls = CrowdEnv if algo in RISK_ENV_ALGOS else SimpleEnv
    env = env_cls(cfg, device=device, seed=seed)
    if env.obs_dim != agent.obs_dim:
        raise ValueError(f"agent obs_dim {agent.obs_dim} != env obs_dim "
                         f"{env.obs_dim}")
    tcfg = TrainerConfig(n_envs=n_envs, rollout_chunk=max_steps,
                         learning=False, reset_bank=n_envs if jitter else 0)
    return Trainer(env, agent, tcfg, discrete=algo in DISCRETE_ALGOS)


def evaluate_scenario(agent, world: str, behavior: str, n_envs: int,
                      max_steps: int, seed: int, jitter: float = 0.0,
                      ablation: str | None = None, robot: str | None = None,
                      device="cuda", algo: str = "td3"):
    """One scenario (:func:`scenario_trainer`) through the jitted chunk;
    only episodes that complete inside the chunk count."""
    trainer = scenario_trainer(agent, world, behavior, n_envs, max_steps,
                               seed, jitter, ablation, robot, device, algo)
    state = trainer.init(seed)
    if trainer.device.type == "cuda":
        torch.cuda.synchronize(trainer.device)
    t0 = time.perf_counter()
    state = trainer.make_jitted()(state)
    summary, state = trainer.drain_stats(state)
    summary["timelapse"] = round(time.perf_counter() - t0, 2)
    summary["scenario"] = f"{world}/{behavior}"
    return summary


def trace_scenario(agent, world: str, behavior: str, max_steps: int,
                   seed: int, outdir: str, algo: str = "td3",
                   ablation: str | None = None, robot: str | None = None,
                   device="cuda"):
    """One env's greedy rollout with every state recorded: the
    reference's per-step trajectory CSV
    (``<algo>_<world>_<behavior>_trajectory.csv``), a path plot and the
    last frame (the JAX ``trace_scenario``; the plots need matplotlib).
    Unlike the JAX driver's, the rollout's env takes the ablation and the
    robot of the evaluated agent."""
    from crowdnav_tpu_torch import viz

    cfg = make_config(world, behavior, max_steps=max_steps,
                      ablation=ablation, robot=robot)
    env_cls = CrowdEnv if algo in RISK_ENV_ALGOS else SimpleEnv
    env = env_cls(cfg, device=device, seed=seed)
    states, scans, traj, _, _ = viz.trace_rollout(
        env, lambda obs: agent.act(obs), seed, max_steps,
        discrete=algo in DISCRETE_ALGOS)
    tag = f"{algo}_{world}_{behavior}"
    viz.TrajectoryWriter(outdir, f"{tag}_trajectory").record_rollout(traj)
    ax = viz.render_trajectory(cfg, traj, title=f"{world}/{behavior}",
                               label=algo)
    viz.save_figure(ax, f"{outdir}/{tag}_trajectory.png")
    ax = viz.render_frame(cfg, viz.state_at(states, -1), scans=scans[-1])
    viz.save_figure(ax, f"{outdir}/{tag}_final_frame.png")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--algo", default="td3",
                   choices=["td3", "ddpg", "sac", "dqn"])
    p.add_argument("--checkpoint", default=None,
                   help="policy file written by scripts/export_torch_actor.py"
                        " or export_torch_agent.py --policy, or an agent "
                        "checkpoint of drivers/train")
    p.add_argument("--checkpoint-step", type=int, default=None,
                   help="the step of a checkpoint directory "
                        "(agent_<step>.npz); default the newest")
    p.add_argument("--suite", default="20", choices=list(SUITES))
    p.add_argument("--ablation", default=None)
    p.add_argument("--robot", default=None, choices=list(ROBOT_PRESETS))
    p.add_argument("--n-envs", type=int, default=256)
    p.add_argument("--max-steps", type=int, default=500)
    p.add_argument("--outdir", default="results")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--jitter", type=float, default=1.0)
    p.add_argument("--device", default="cuda",
                   help="torch device, 'cuda' (default) or 'cpu'")
    p.add_argument("--trajectory", action="store_true",
                   help="also one env's greedy rollout per scenario: the "
                        "trajectory CSV and the path and frame renders")
    args = p.parse_args(argv)
    try:
        device = resolve(args.device)
    except RuntimeError as e:
        raise SystemExit(str(e))

    params, meta, agent_cfg = None, None, None
    if args.checkpoint:
        params, meta = load_actor_file(args.checkpoint, args.checkpoint_step,
                                       args.algo)
    if meta is not None:
        if meta["algo"] != args.algo:
            raise SystemExit(f"--algo {args.algo} conflicts with checkpoint "
                             f"metadata (trained as {meta['algo']!r})")
        ckpt_abl = meta.get("ablation")
        if args.ablation is None:
            args.ablation = ckpt_abl
        elif args.ablation != ckpt_abl:
            raise SystemExit(f"--ablation {args.ablation} conflicts with "
                             f"checkpoint metadata (trained with "
                             f"ablation={ckpt_abl!r})")
        ckpt_robot = meta.get("robot")
        if args.robot is None:
            args.robot = ckpt_robot
        elif ckpt_robot is not None and args.robot != ckpt_robot:
            raise SystemExit(f"--robot {args.robot} conflicts with "
                             f"checkpoint metadata (trained with "
                             f"robot={ckpt_robot!r})")
        agent_cfg = meta.get("agent_config")
    world, behavior = SUITES[args.suite][0]
    cfg = make_config(world, behavior, ablation=args.ablation,
                      robot=args.robot)
    obs_dim = cfg.state_dim_risk if args.algo in RISK_ENV_ALGOS \
        else cfg.state_dim_simple
    if meta is not None and meta.get("obs_dim") not in (None, obs_dim):
        raise SystemExit(f"checkpoint obs_dim {meta['obs_dim']} != eval env "
                         f"obs_dim {obs_dim} (world/ablation mismatch)")
    agent = build_agent(agent_cfg, obs_dim, device, args.algo, args.n_envs)
    if params is not None:
        agent.load_actor(flax_actor_to_state_dict(params))
    else:
        agent.init(args.seed)

    logger = EpisodeLogger(args.outdir, f"{args.algo}_training_test")
    results = []
    for i, (world, behavior) in enumerate(SUITES[args.suite]):
        summary = evaluate_scenario(
            agent, world, behavior, args.n_envs, args.max_steps,
            args.seed + i, jitter=args.jitter, ablation=args.ablation,
            robot=args.robot, device=device, algo=args.algo)
        logger.record_summary(summary, 0, summary["timelapse"])
        print(json.dumps({k: (round(v, 4) if isinstance(v, float) else v)
                          for k, v in summary.items()}), flush=True)
        results.append(summary)
        if args.trajectory:
            trace_scenario(agent, world, behavior, args.max_steps,
                           args.seed + i, args.outdir, algo=args.algo,
                           ablation=args.ablation, robot=args.robot,
                           device=device)
    overall = sum(r["success_rate"] for r in results) / len(results)
    print(json.dumps({"suite": args.suite,
                      "overall_success_rate": round(overall, 4)}),
          flush=True)
    return results


if __name__ == "__main__":
    main()
