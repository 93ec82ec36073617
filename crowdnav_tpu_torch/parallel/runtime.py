"""Actor-learner runtime (port of ``crowdnav_tpu/parallel/runtime.py``).

N lockstep envs act, step together, auto-reset from the reset bank, and
accumulate the episode statistics of the reference's CSV schema on the
device; ``drain_stats`` reads them out. With ``learning=True`` the actions
explore, every step's transitions go into the replay ring (the terminal ->
reset rows masked out), and once the ring holds ``learn_start`` rows every
step takes ``updates_per_step`` updates of the agent (TD3, DDPG, SAC or
DQN), each on a fresh uniform sample. With ``discrete=True`` the actions
are indices and the env steps through ``step_discrete`` (DQN on
``SimpleEnv``); an ``act`` that returns ``(action, state)`` (DDPG's OU
carry) carries the new agent state. The ring's size is read on the host
only until that gate has opened once (it only grows); after that a step
makes no device-to-host read. Every draw comes from the state's
generator, or from ``draws`` (:class:`StepDraws`, one per step), through
which a test feeds the JAX package's draws.

``Trainer.make_jitted`` is the JAX package's ``jax.jit(rollout_chunk,
donate_argnums=(0,))``: a :class:`JittedChunk` that runs the chunk over a
state at fixed addresses, updated in place, and on a card replays one
captured CUDA graph of the step per step. Its chunk equals
``rollout_chunk``'s bit for bit.

Setting ``Trainer.spans`` to a list turns on timing of the eager loop
(``rollout_chunk``): each step then appends five recorded CUDA events,
``(start, acted, stepped, added, learned)``, read by ``span_ms``; off
(None), nothing is recorded.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, NamedTuple, Optional

import torch

from crowdnav_tpu_torch.agents.replay import ReplayBuffer, Transition
from crowdnav_tpu_torch.agents.td3 import eps_spectrum
from crowdnav_tpu_torch.envs.crowd_env import select_rows
from crowdnav_tpu_torch.envs.world import EnvState
from crowdnav_tpu_torch.utils.tree import map_tensors, named_tensors

# eager steps with the learn gate open before the capture, on the capture
# stream: every first use (the kernel library's load and each kernel's
# first launch, cuBLAS's workspace of that stream, the cached constant
# tables) happens in them, outside the capture
WARMUP_STEPS = 2


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    """The JAX ``TrainerConfig``, field for field."""

    n_envs: int = 1024
    updates_per_step: int = 1     # gradient updates per batched env step
    rollout_chunk: int = 64       # env-steps per ``rollout_chunk`` call
    learn_start: int = 256        # min replay rows before learning
    learning: bool = True         # False = pure evaluation rollouts
    reset_bank: int = 0           # >0: auto-resets draw from this many
                                  # pre-randomized reset states
    replay_obs_dtype: str = "float32"   # or "bfloat16"


class StepDraws(NamedTuple):
    """Pre-drawn randomness of one step (tests); a None field is drawn
    from the state's generator."""

    act: Any = None               # the agent's exploration draws
                                  # (``exploration_draws``)
    bank_idx: Any = None          # (N,) reset-bank entries
    vel: Any = None               # (N, P, 2) random-crowd velocities
    sample_idx: Any = None        # [updates_per_step] x (batch,) rows
    smoothing: Any = None         # TD3: [updates_per_step] x (batch, 2)
    sac_noise: Any = None         # SAC: [updates_per_step] x (batch, 2)


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
        eps = eps_spectrum(cfg, n_envs, folded=False)
        return (eps <= eps_cutoff).to(device)
    return torch.ones((n_envs,), dtype=torch.bool, device=device)


@dataclasses.dataclass
class TrainerState:
    env_states: EnvState
    obs: torch.Tensor               # (N, obs_dim)
    stats: EpisodeStats
    gen: torch.Generator            # every draw of the rollout
    reset_bank: Optional[Any] = None  # (bank_states, bank_obs) or None
    agent_state: Optional[Any] = None   # the learner state
    replay: Optional[Any] = None        # ReplayState when learning
    learn_metrics: Optional[dict] = None  # the last update's, on device
    learning_open: bool = False     # host: the learn gate has opened


class Trainer:
    """Binds an env and an agent into batched rollouts, and with
    ``learning`` into training: exploring acts, the replay ring and the
    agent's updates."""

    def __init__(self, env, agent, tcfg: TrainerConfig,
                 discrete: bool = False):
        self.env = env
        self.agent = agent
        self.tcfg = tcfg
        self.discrete = discrete
        self.device = env.device
        self.greedy_mask = greedy_env_mask(agent, tcfg.n_envs,
                                           device=self.device)
        self.spans = None
        self.buffer = None
        # the learner's rows per update and the update's extra keywords
        # (the sharded trainer's share of the batch and its grad_reduce)
        self.batch_size = getattr(agent.cfg, "batch_size", None)
        self.update_kw = {}
        if tcfg.learning:
            act_dim = None if discrete else env.action_dim
            self.buffer = ReplayBuffer(self._replay_capacity(),
                                       env.obs_dim, act_dim,
                                       block=tcfg.n_envs,
                                       obs_dtype=tcfg.replay_obs_dtype,
                                       device=self.device)

    def init(self, seed: int) -> TrainerState:
        gen = torch.Generator(device=self.device).manual_seed(seed)
        env_states, obs = self._reset_envs(gen)
        bank = None
        if self.tcfg.reset_bank:
            bank = self.env.reset(self.tcfg.reset_bank, gen)
        state = TrainerState(env_states=env_states, obs=obs,
                             stats=init_stats(self.tcfg.n_envs, self.device),
                             gen=gen, reset_bank=bank)
        if self.tcfg.learning:
            zero = torch.zeros((), dtype=torch.float32, device=self.device)
            state = dataclasses.replace(
                state, agent_state=self.agent.init_state(seed),
                replay=self.buffer.init(),
                learn_metrics={k: zero.clone()
                               for k in self.agent.METRICS})
        return state

    def _replay_capacity(self) -> int:
        """Rows of this trainer's replay ring."""
        return self.agent.cfg.buffer_size

    def _reset_envs(self, gen):
        """The first episodes of this trainer's envs."""
        return self.env.reset(self.tcfg.n_envs, gen)

    @torch.no_grad()
    def _train_step(self, state: TrainerState,
                    draws: StepDraws | None = None) -> TrainerState:
        tcfg = self.tcfg
        draws = draws or StepDraws()
        marks = [self._mark()]
        if tcfg.learning:
            actions = self.agent.act(state.obs, explore=True,
                                     state=state.agent_state, gen=state.gen,
                                     draws=draws.act)
            if isinstance(actions, tuple):    # DDPG: (action, state)
                actions, agent_state = actions
                state = dataclasses.replace(state, agent_state=agent_state)
        else:
            actions = self.agent.act(state.obs, explore=False)
        marks.append(self._mark())
        was_done = state.env_states.done
        state_obs = state.obs
        step = self.env.step_discrete if self.discrete \
            else self.env.step_batch
        out = step(state.env_states, actions, gen=state.gen,
                   vel_draw=draws.vel)

        new_states, new_obs = out.state, out.obs
        if state.reset_bank is not None:
            # diverse auto-reset: rows the env reset to its template take
            # a randomly drawn bank entry instead
            bank_states, bank_obs = state.reset_bank
            idx = draws.bank_idx
            if idx is None:
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
        ego, social = self._safety(out.state)
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
        state = dataclasses.replace(state, env_states=new_states,
                                    obs=new_obs, stats=stats)
        marks.append(self._mark())
        if tcfg.learning:
            # replay: drop the terminal -> reset rows
            tr = Transition(obs=state_obs, action=actions, reward=out.reward,
                            next_obs=out.obs, done=out.done.float())
            state = self._learn_step(state, tr, ~was_done, draws, marks)
        if self.spans is not None:
            self.spans.append(marks + [marks[-1]] * (5 - len(marks)))
        return state

    def _learn_step(self, state: TrainerState, tr: Transition, mask,
                    draws: StepDraws, marks: list) -> TrainerState:
        replay = self.buffer.add_batch(state.replay, tr, mask=mask)
        state = dataclasses.replace(state, replay=replay)
        marks.append(self._mark())
        if not state.learning_open:
            if self._rows_written(replay) < self.tcfg.learn_start:
                return state
            state = dataclasses.replace(state, learning_open=True)
        agent_state, metrics = self._learn(state.agent_state, replay,
                                           state.gen, draws)
        marks.append(self._mark())
        return dataclasses.replace(state, agent_state=agent_state,
                                   learn_metrics=metrics)

    def _rows_written(self, replay) -> int:
        """Rows in the replay ring, read on the host (the learn gate)."""
        return int(replay.size)

    def _mark(self):
        """A recorded CUDA event while timing is on, else None."""
        if self.spans is None:
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def span_ms(self) -> dict:
        """Mean device-clock ms per step of ``act``, ``env`` (step, reset
        bank, statistics), ``replay_add`` and ``learn`` over the recorded
        steps (after a synchronisation)."""
        torch.cuda.synchronize(self.device)
        names = ("act", "env", "replay_add", "learn")
        tot = dict.fromkeys(names, 0.0)
        for m in self.spans:
            for i, name in enumerate(names):
                tot[name] += m[i].elapsed_time(m[i + 1])
        n = max(len(self.spans), 1)
        return {k: v / n for k, v in tot.items()}

    def _safety(self, env_states):
        """Per-env ego and social safety scores; zeros for an env without
        ``safety_scores`` (``SimpleEnv``)."""
        if hasattr(self.env, "safety_scores"):
            return self.env.safety_scores(env_states)
        z = torch.zeros(env_states.done.shape, dtype=torch.float32,
                        device=env_states.done.device)
        return z, z

    def _learn(self, agent_state, replay, gen, draws: StepDraws):
        """``updates_per_step`` updates, each on a fresh uniform sample and
        with its own draws (``agent.UPDATE_DRAW``: the StepDraws field and
        the update's keyword; TD3's smoothing noise, SAC's normal); the
        last update's metrics."""
        metrics = None
        bsz = self.batch_size
        own = self.agent.UPDATE_DRAW
        for i in range(self.tcfg.updates_per_step):
            idx = None if draws.sample_idx is None else draws.sample_idx[i]
            batch = self.buffer.sample(replay, bsz, gen, idx=idx)
            kw = {}
            if own is not None:
                given = getattr(draws, own[0])
                kw[own[1]] = None if given is None else given[i]
            agent_state, metrics = self.agent.update(
                agent_state, batch, gen=gen, **kw, **self.update_kw)
        return agent_state, metrics

    def rollout_chunk(self, state: TrainerState,
                      draws: list | None = None) -> TrainerState:
        """``rollout_chunk`` steps; ``draws``: one :class:`StepDraws` per
        step, or None."""
        for t in range(self.tcfg.rollout_chunk):
            state = self._train_step(state, None if draws is None
                                     else draws[t])
        return state

    def make_jitted(self) -> "JittedChunk":
        """The chunk as one compiled program over a donated state, the
        JAX package's ``jax.jit(rollout_chunk, donate_argnums=(0,))``: a
        :class:`JittedChunk`, ``run(state) -> state``. ``spans`` times the
        eager loop only (``rollout_chunk``)."""
        if self.spans is not None:
            raise ValueError("make_jitted: Trainer.spans records events "
                             "per eager step; time rollout_chunk instead")
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("make_jitted: a CUDA trainer, but CUDA is "
                               "not available")
        return JittedChunk(self)

    def _host_stats(self, values: list) -> list:
        """The completed-episode counters and sums, on the host."""
        return [v.item() for v in values]

    def drain_stats(self, state: TrainerState):
        """Host-side episode summary; zero the completed-episode counters."""
        s = state.stats
        host = self._host_stats([
            s.episodes, s.successes, s.failures, s.total_reward,
            s.total_steps, s.ego_sum, s.social_sum, s.dtg_sum, s.htg_sum,
            s.wp_sum, s.greedy_episodes, s.greedy_successes])
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
        if state.learn_metrics is not None:
            summary.update({k: float(v)
                            for k, v in state.learn_metrics.items()})
        fresh = dataclasses.replace(
            init_stats(self.tcfg.n_envs, self.device),
            ep_reward=s.ep_reward, ep_steps=s.ep_steps)
        return summary, dataclasses.replace(state, stats=fresh)


def _own(state: TrainerState) -> TrainerState:
    """``state`` with each tensor its own buffer: a tensor that shares
    memory with an earlier one (a reset's ``done`` and
    ``episode_success`` are one tensor) is cloned; every other tensor is
    adopted as it is."""
    seen = set()

    def own(t):
        if t.numel() and t.untyped_storage().data_ptr() in seen:
            t = t.clone()
        if t.numel():
            seen.add(t.untyped_storage().data_ptr())
        return t

    return map_tensors(own, state)


class JittedChunk:
    """``run(state) -> state``: ``tcfg.rollout_chunk`` steps of the
    trainer over a state at fixed addresses (:meth:`Trainer.make_jitted`).

    The first call adopts the state's tensors as the buffers of every
    later step: each step computes the new state from them and copies it
    back into them (``copy_``), the counterpart of JAX's donation. A later
    call with tensors at other addresses (the fresh statistics of
    ``drain_stats``, a restarted or restored state, a new learner scalar)
    first copies them in, and another generator's state into the
    buffers' generator. The caller's state is consumed: the state
    returned is the buffers.

    On a CUDA trainer the step is captured once as a CUDA graph and
    replayed once a step. The learn gate reads the ring's size on the host
    until it opens, so the steps before it run eagerly; then
    ``WARMUP_STEPS`` eager steps run on the capture stream, and the step
    is captured with the gate open (an evaluation trainer, which has no
    gate, after the warm-up). These are steps of the chunk. The trainer's
    generator is registered with the graph, so that a replayed step draws
    what an eager step would. No step of the capture may read the device
    from the host (``torch.cuda.set_sync_debug_mode("error")`` around
    it). A failed capture or replay raises; nothing falls back to the
    eager loop. On a CPU trainer the same steps run eagerly.

    The kernel wrappers count their calls, the capture's among them, and
    no replay: the kernels a replay runs show in a profiler's trace.
    ``replays`` counts the replayed steps, ``capture_s`` the capture's
    seconds.
    """

    def __init__(self, trainer: Trainer):
        self.trainer = trainer
        self.state: Optional[TrainerState] = None
        self.graph = None
        self.warm = 0
        self.replays = 0
        self.capture_s: Optional[float] = None
        self._stream = torch.cuda.Stream(trainer.device) \
            if trainer.device.type == "cuda" else None

    def __call__(self, state: TrainerState) -> TrainerState:
        tr = self.trainer
        if tr.spans is not None:
            raise ValueError("JittedChunk: Trainer.spans is set; time "
                             "rollout_chunk instead")
        if self.state is None:
            self.state = _own(state)
        else:
            self._store(state)
        left = tr.tcfg.rollout_chunk
        while left and tr.tcfg.learning and not self.state.learning_open:
            self._step()
            left -= 1
        if tr.device.type != "cuda":
            for _ in range(left):
                self._step()
            return self.state
        if left and self.warm < WARMUP_STEPS:
            left -= self._warm_up(min(left, WARMUP_STEPS - self.warm))
        if left and self.graph is None:
            self._capture()
        for _ in range(left):
            self.graph.replay()
        self.replays += left
        return self.state

    def _step(self):
        self._store(self.trainer._train_step(self.state))

    def _store(self, new: TrainerState):
        """Copy ``new``'s tensors into the buffers where they are other
        tensors; a tensor that reads a buffer's memory is cloned first, so
        that no copy overwrites what a later copy reads."""
        dst = named_tensors(self.state)
        src = dict(named_tensors(new))
        if {name for name, _ in dst} != set(src):
            raise ValueError(
                f"JittedChunk: the state's tensors changed: "
                f"{sorted(set(src) ^ {name for name, _ in dst})}")
        owned = {t.untyped_storage().data_ptr() for _, t in dst
                 if t.numel()}
        pairs = []
        for name, d in dst:
            s = src[name]
            if s is d:
                continue
            if (s.shape, s.dtype, s.device) != (d.shape, d.dtype, d.device):
                raise ValueError(
                    f"JittedChunk: {name} is {tuple(s.shape)} {s.dtype} on "
                    f"{s.device}, its buffer {tuple(d.shape)} {d.dtype} on "
                    f"{d.device}")
            if s.numel() and s.untyped_storage().data_ptr() in owned:
                s = s.clone()
            pairs.append((d, s))
        for d, s in pairs:
            d.copy_(s)
        if new.gen is not self.state.gen:
            self.state.gen.set_state(new.gen.get_state())
        self.state.learning_open = new.learning_open

    def _warm_up(self, n: int) -> int:
        """``n`` eager steps on the capture stream."""
        dev = self.trainer.device
        self._stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(self._stream):
            for _ in range(n):
                self._step()
        torch.cuda.current_stream(dev).wait_stream(self._stream)
        self.warm += n
        return n

    def _capture(self):
        dev = self.trainer.device
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.state.gen)
        t0 = time.perf_counter()
        with torch.cuda.graph(graph, stream=self._stream):
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                self._step()
            finally:
                torch.cuda.set_sync_debug_mode(mode)
        torch.cuda.synchronize(dev)
        self.capture_s = time.perf_counter() - t0
        self.graph = graph
