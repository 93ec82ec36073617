"""Rollout runtime (port of ``crowdnav_tpu/parallel/runtime.py``), for
evaluation: ``learning=False``.

N lockstep envs act with the greedy policy, step together, auto-reset from
the reset bank, and accumulate the episode statistics of the reference's
CSV schema on the device; ``drain_stats`` reads them out. No replay is
allocated: the learning half comes with the training slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from crowdnav_tpu_torch.envs.crowd_env import select_rows
from crowdnav_tpu_torch.envs.world import EnvState


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    """The evaluation fields of the JAX ``TrainerConfig``; the learner's
    fields come with the training slice."""

    n_envs: int = 1024
    rollout_chunk: int = 64       # env-steps per ``rollout_chunk`` call
    learning: bool = True         # False = pure evaluation rollouts
    reset_bank: int = 0           # >0: auto-resets draw from this many
                                  # pre-randomized reset states


@dataclasses.dataclass
class EpisodeStats:
    """Device-side accumulators, drained per chunk."""

    ep_reward: torch.Tensor       # (N,) running episode reward
    ep_steps: torch.Tensor        # (N,) int32 running episode length
    episodes: torch.Tensor        # () int32
    successes: torch.Tensor       # () int32
    failures: torch.Tensor        # () int32
    total_reward: torch.Tensor    # () sums over completed episodes
    total_steps: torch.Tensor
    ego_sum: torch.Tensor
    social_sum: torch.Tensor
    dtg_sum: torch.Tensor
    htg_sum: torch.Tensor
    wp_sum: torch.Tensor
    greedy_episodes: torch.Tensor   # () int32
    greedy_successes: torch.Tensor  # () int32


def init_stats(n_envs: int, device="cuda") -> EpisodeStats:
    def zf():
        return torch.zeros((), dtype=torch.float32, device=device)

    def zi():
        return torch.zeros((), dtype=torch.int32, device=device)

    return EpisodeStats(
        ep_reward=torch.zeros(n_envs, dtype=torch.float32, device=device),
        ep_steps=torch.zeros(n_envs, dtype=torch.int32, device=device),
        episodes=zi(), successes=zi(), failures=zi(), total_reward=zf(),
        total_steps=zf(), ego_sum=zf(), social_sum=zf(), dtg_sum=zf(),
        htg_sum=zf(), wp_sum=zf(), greedy_episodes=zi(),
        greedy_successes=zi())


def greedy_env_mask(agent, n_envs: int, eps_cutoff: float = 0.1,
                    device="cpu") -> torch.Tensor:
    """(n_envs,) bool: envs whose behavior policy is (near-)greedy under
    the agent's per-env epsilon spectrum; all envs without one."""
    cfg = agent.cfg
    if getattr(cfg, "explore_eps_spectrum", False) \
            and getattr(cfg, "explore_uniform_eps", 0.0) > 0.0:
        hi = cfg.explore_uniform_eps
        lo = getattr(cfg, "explore_uniform_eps_min", None) or 0.01
        frac = (torch.arange(n_envs, dtype=torch.float32)
                / max(n_envs - 1, 1))
        eps = hi * (lo / hi) ** frac
        return (eps <= eps_cutoff).to(device)
    return torch.ones((n_envs,), dtype=torch.bool, device=device)


@dataclasses.dataclass
class TrainerState:
    env_states: EnvState
    obs: torch.Tensor               # (N, obs_dim)
    stats: EpisodeStats
    gen: torch.Generator            # every draw of the rollout
    reset_bank: Optional[Any] = None  # (bank_states, bank_obs) or None


class Trainer:
    """Binds an env and an agent into batched rollouts (evaluation only)."""

    def __init__(self, env, agent, tcfg: TrainerConfig):
        if tcfg.learning:
            raise NotImplementedError(
                "learning=True comes with the training slice")
        self.env = env
        self.agent = agent
        self.tcfg = tcfg
        self.device = env.device
        self.greedy_mask = greedy_env_mask(agent, tcfg.n_envs,
                                           device=self.device)

    def init(self, seed: int) -> TrainerState:
        gen = torch.Generator(device=self.device).manual_seed(seed)
        env_states, obs = self.env.reset(self.tcfg.n_envs, gen)
        bank = None
        if self.tcfg.reset_bank:
            bank = self.env.reset(self.tcfg.reset_bank, gen)
        return TrainerState(env_states=env_states, obs=obs,
                            stats=init_stats(self.tcfg.n_envs, self.device),
                            gen=gen, reset_bank=bank)

    @torch.no_grad()
    def _train_step(self, state: TrainerState) -> TrainerState:
        tcfg = self.tcfg
        actions = self.agent.act(state.obs, explore=False)
        was_done = state.env_states.done
        out = self.env.step_batch(state.env_states, actions, gen=state.gen)

        new_states, new_obs = out.state, out.obs
        if state.reset_bank is not None:
            # diverse auto-reset: rows the env reset to its template take
            # a randomly drawn bank entry instead
            bank_states, bank_obs = state.reset_bank
            idx = torch.randint(0, tcfg.reset_bank, (tcfg.n_envs,),
                                generator=state.gen, device=self.device)
            new_states = select_rows(
                was_done, bank_states.map(lambda a: a[idx]), new_states)
            new_obs = torch.where(was_done[:, None], bank_obs[idx], new_obs)

        st = state.stats
        i32 = torch.int32
        ep_reward = st.ep_reward + torch.where(was_done, 0.0, out.reward)
        ep_steps = st.ep_steps + torch.where(was_done, 0, 1).to(i32)
        done_now = out.done
        n_done = done_now.sum(dtype=i32)
        succ = out.state.episode_success & done_now
        n_succ = succ.sum(dtype=i32)
        ego, social = self.env.safety_scores(out.state)
        s = out.state

        def fsum(v):
            return torch.where(done_now, v, 0).sum().to(torch.float32)

        stats = EpisodeStats(
            ep_reward=torch.where(done_now, 0.0, ep_reward),
            ep_steps=torch.where(done_now, 0, ep_steps).to(i32),
            episodes=st.episodes + n_done,
            successes=st.successes + n_succ,
            failures=st.failures + n_done - n_succ,
            total_reward=st.total_reward + torch.where(
                done_now, ep_reward, 0.0).sum(),
            total_steps=st.total_steps + fsum(ep_steps),
            ego_sum=st.ego_sum + torch.where(done_now, ego, 0.0).sum(),
            social_sum=st.social_sum + torch.where(
                done_now, social, 0.0).sum(),
            dtg_sum=st.dtg_sum + fsum(s.dtg_reward_count),
            htg_sum=st.htg_sum + fsum(s.htg_reward_count),
            wp_sum=st.wp_sum + fsum(s.wp_bonus_count),
            greedy_episodes=st.greedy_episodes
            + (done_now & self.greedy_mask).sum(dtype=i32),
            greedy_successes=st.greedy_successes
            + (succ & self.greedy_mask).sum(dtype=i32))
        return dataclasses.replace(state, env_states=new_states,
                                   obs=new_obs, stats=stats)

    def rollout_chunk(self, state: TrainerState) -> TrainerState:
        for _ in range(self.tcfg.rollout_chunk):
            state = self._train_step(state)
        return state

    def drain_stats(self, state: TrainerState):
        """Host-side episode summary; zero the completed-episode counters."""
        s = state.stats
        host = [v.item() for v in (
            s.episodes, s.successes, s.failures, s.total_reward,
            s.total_steps, s.ego_sum, s.social_sum, s.dtg_sum, s.htg_sum,
            s.wp_sum, s.greedy_episodes, s.greedy_successes)]
        episodes = int(host[0])
        per = max(episodes, 1)
        summary = {
            "episodes": episodes,
            "successes": int(host[1]),
            "failures": int(host[2]),
            "success_rate": float(host[1]) / per,
            "mean_reward": float(host[3]) / per,
            "mean_steps": float(host[4]) / per,
            "mean_ego_safety": float(host[5]) / per,
            "mean_social_safety": float(host[6]) / per,
            "mean_dtg_rewards": float(host[7]) / per,
            "mean_htg_rewards": float(host[8]) / per,
            "mean_wp_bonuses": float(host[9]) / per,
            "greedy_episodes": int(host[10]),
            "greedy_success_rate": float(host[11]) / max(int(host[10]), 1),
        }
        fresh = dataclasses.replace(
            init_stats(self.tcfg.n_envs, self.device),
            ep_reward=s.ep_reward, ep_steps=s.ep_steps)
        return summary, dataclasses.replace(state, stats=fresh)
