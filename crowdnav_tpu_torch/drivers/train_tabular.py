"""Tabular Q-learning / SARSA training driver of the port
(``crowdnav_tpu/drivers/train_tabular.py``): the state is the digitized
(distance, heading) to the goal read from the simple env's observation
(indices 359 and 360; the reference's drivers read the agent's x/y there,
a quirk the JAX driver fixes and the port keeps fixed), the actions the
three discrete motions, and the updates online, env after env within a
step, as the JAX driver's scan does.

    python -m crowdnav_tpu_torch.drivers.train_tabular --algo qlearn \\
        --world crowd_none --behavior static --n-envs 64 --env-steps 2e5 \\
        --outdir results/torch_qlearn

The same options and output files as the JAX driver: one CSV row per
chunk (``<algo>_training.csv``, ``<algo>_training_test.csv`` with
``--no-learning``), the table (``<algo>_qtable.npz``) and
``run_config.json``; ``--device`` (default ``cuda``) is the port's.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from crowdnav_tpu_torch.agents.tabular import (QLearning, Sarsa,
                                               TabularConfig, act_draws,
                                               discretize_state, load_table,
                                               save_table)
from crowdnav_tpu_torch.envs.config import make_config
from crowdnav_tpu_torch.envs.crowd_env import select_rows
from crowdnav_tpu_torch.envs.simple_env import SimpleEnv
from crowdnav_tpu_torch.utils.checkpoint import save_run_metadata
from crowdnav_tpu_torch.utils.device import resolve
from crowdnav_tpu_torch.utils.logging import EpisodeLogger


def state_index(obs):
    htg, dtg = obs[..., 359], obs[..., 360]
    return discretize_state(dtg, htg)


@dataclasses.dataclass
class Carry:
    """The rollout's carry: env states and observations, the next
    actions, the table, and the episode statistics (per env: return and
    length so far; per chunk: episodes done, successes, return and step
    sums of the finished ones)."""

    states: object
    obs: torch.Tensor
    actions: torch.Tensor
    table: object
    ep_reward: torch.Tensor
    ep_steps: torch.Tensor
    done: int = 0
    successes: int = 0
    reward_sum: float = 0.0
    step_sum: int = 0


def step_draws(n: int, n_actions: int, bank_size: int, gen, device):
    """One step's draws: ``act`` (:func:`act_draws`) and, with a reset
    bank, ``bank_idx`` (n,) in [0, bank_size)."""
    d = {"act": act_draws(n, n_actions, gen, device)}
    if bank_size:
        d["bank_idx"] = torch.randint(0, bank_size, (n,), generator=gen,
                                      device=device)
    return d


def rollout_step(env: SimpleEnv, algo, carry: Carry, learning: bool, gen,
                 bank=None, draws=None) -> Carry:
    """One step of every env (the JAX driver's ``one_step``): the discrete
    env step, the auto-reset from the reset ``bank`` (states, obs), the
    next actions, the online updates of the live envs, the statistics."""
    n = carry.obs.shape[0]
    if draws is None:
        draws = step_draws(n, algo.cfg.n_actions,
                           0 if bank is None else bank[1].shape[0], gen,
                           carry.obs.device)
    was_done = carry.states.done
    out = env.step_discrete(carry.states, carry.actions, gen=gen)
    new_states, new_obs = out.state, out.obs
    if bank is not None:
        idx = draws["bank_idx"].long()
        new_states = select_rows(was_done, bank[0].map(lambda a: a[idx]),
                                 new_states)
        new_obs = torch.where(was_done[:, None], bank[1][idx], new_obs)
    s, s2 = state_index(carry.obs), state_index(new_obs)
    next_actions = algo.act(carry.table, s2, explore=learning,
                            draws=draws["act"])
    table = carry.table
    if learning:
        table = algo.update_batch(table, s, carry.actions.long(),
                                  out.reward, s2, next_actions.long(),
                                  ~was_done)
    ep_r = carry.ep_reward + torch.where(was_done, 0.0, out.reward)
    ep_n = carry.ep_steps + torch.where(was_done, 0, 1)
    d = out.done
    return Carry(
        new_states, new_obs, next_actions, table,
        torch.where(d, 0.0, ep_r), torch.where(d, 0, ep_n),
        carry.done + int(d.sum()),
        carry.successes + int((d & new_states.episode_success).sum()),
        carry.reward_sum + float(torch.where(d, ep_r, 0.0).sum()),
        carry.step_sum + int(torch.where(d, ep_n, 0).sum()))


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--algo", default="qlearn", choices=["qlearn", "sarsa"])
    p.add_argument("--world", default="crowd_none")
    p.add_argument("--behavior", default="static")
    p.add_argument("--n-envs", type=int, default=64)
    p.add_argument("--env-steps", type=float, default=2e5)
    p.add_argument("--chunk", type=int, default=100)
    p.add_argument("--max-steps", type=int, default=200)
    p.add_argument("--outdir", default="results")
    p.add_argument("--load", default=None,
                   help="resume from a saved Q-table .npz")
    p.add_argument("--no-learning", action="store_true",
                   help="greedy evaluation only (<algo>_training_test.csv)")
    p.add_argument("--jitter", type=float, default=0.0,
                   help="reset randomization (a reset bank of "
                        "max(256, n_envs) spawns)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device, 'cuda' (default) or 'cpu'")
    return p


def main(argv=None):
    args = parser().parse_args(argv)
    try:
        device = resolve(args.device)
    except RuntimeError as e:       # no card for --device cuda
        raise SystemExit(str(e))
    cfg = make_config(args.world, args.behavior, max_steps=args.max_steps,
                      jitter=args.jitter)
    env = SimpleEnv(cfg, device=device, seed=args.seed)
    algo = (QLearning if args.algo == "qlearn" else Sarsa)(
        TabularConfig(), device)
    table = load_table(args.load, device) if args.load else algo.init()
    gen = torch.Generator(device=device).manual_seed(args.seed)
    states, obs = env.reset(args.n_envs, gen)
    bank = env.reset(max(256, args.n_envs), gen) if args.jitter else None
    n = args.n_envs
    carry = Carry(states, obs, torch.zeros(n, dtype=torch.int32,
                                           device=device), table,
                  torch.zeros(n, device=device),
                  torch.zeros(n, dtype=torch.int64, device=device))
    learning = not args.no_learning
    logger = EpisodeLogger(
        args.outdir, f"{args.algo}_training" + ("" if learning else "_test"))
    steps_per_chunk = n * args.chunk
    n_chunks = max(1, int(args.env_steps // steps_per_chunk))
    ep_base = 0
    for chunk in range(n_chunks):
        t0 = time.time()
        for _ in range(args.chunk):
            carry = rollout_step(env, algo, carry, learning, gen, bank)
        carry.table = algo.decay_epsilon(carry.table)
        eps, succ = carry.done, carry.successes
        mean_r = carry.reward_sum / max(eps, 1)
        mean_s = carry.step_sum / max(eps, 1)
        logger.record(ep_base + eps, succ, eps - succ, round(mean_r, 3),
                      round(mean_s, 2))
        ep_base += eps
        carry = dataclasses.replace(carry, done=0, successes=0,
                                    reward_sum=0.0, step_sum=0)
        print(json.dumps({"chunk": chunk, "episodes": eps, "successes": succ,
                          "mean_reward": round(mean_r, 2),
                          "mean_steps": round(mean_s, 1),
                          "epsilon": round(float(carry.table.epsilon), 4),
                          "sps": round(steps_per_chunk / (time.time() - t0),
                                       1)}), flush=True)
    save_table(f"{args.outdir}/{args.algo}_qtable", carry.table)
    save_run_metadata(args.outdir, {
        "algo": args.algo, "agent_config": dataclasses.asdict(algo.cfg),
        "world": args.world, "behavior": args.behavior,
        "n_envs": args.n_envs, "seed": args.seed})
    return carry


if __name__ == "__main__":
    main()
