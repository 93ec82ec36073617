"""Simple (non-risk) environment, batched (port of
``crowdnav_tpu/envs/simple_env.py``): the 363-dim state of the reference's
``environment_stage_1_original.py`` that SAC and DQN train on.

The state is the 359 lidar ranges (rounded to 3 decimals), the heading and
distance to the goal (rounded to 2), and the robot's position (rounded to
3). The reward is +1 for progress in distance and +1 for a heading that
moved toward the goal, with +200 at the goal and -200 on a collision
(``min(scans) < 0.105``) or a timeout; there are no waypoints and no
tracker. An env whose episode ended on the previous step restores the
deterministic reset template. The raycast is its XLA form
(``ops.lidar.scan_batch``, which launches the CUDA raycast on CUDA
tensors) whatever the config's ``lidar_backend``, as the JAX package's
``SimpleEnv`` runs ``lidar.scan``. The per-step noise knobs and
``strict_quirks`` (the reference's shaping, which reads the agent's y and
x as the distance and heading) act as in the JAX package, with draws as
in ``CrowdEnv``.

Both action modes of the reference: continuous (lin, ang)
(:meth:`SimpleEnv.step_batch`) and the discrete FORWARD / LEFT / RIGHT
table (:meth:`SimpleEnv.step_discrete`).
"""
from __future__ import annotations

import torch

from crowdnav_tpu_torch.envs.config import EnvConfig
from crowdnav_tpu_torch.envs.crowd_env import (StepOutput, _goal, _goal_box,
                                               _htg_reward, noisy_scans,
                                               select_rows)
from crowdnav_tpu_torch.envs.world import EnvState, init_state, world_step
from crowdnav_tpu_torch.ops import geom, lidar
from crowdnav_tpu_torch.utils import numerics as nm
from crowdnav_tpu_torch.utils.device import resolve

# (lin, ang) of the discrete actions FORWARD, TURN_LEFT, TURN_RIGHT
DISCRETE_ACTIONS_TABLE = ((0.22, 0.0), (0.22, 2.0), (0.22, -2.0))

SIMPLE_MIN_RANGE = 0.105


class SimpleEnv:
    """363-dim environment bound to a config and a device; ``template`` is
    the (state, obs) of one fresh episode drawn from ``seed``, which the
    auto-reset restores."""

    def __init__(self, cfg: EnvConfig, device="cuda", seed: int = 0):
        self.cfg = cfg
        self.device = resolve(device)
        self.obs_dim = cfg.state_dim_simple
        self.action_dim = 2
        self.actions_table = torch.tensor(DISCRETE_ACTIONS_TABLE,
                                          dtype=torch.float32,
                                          device=self.device)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.template = self.reset(1, gen)

    def _observe(self, state: EnvState, noise=None, gen=None):
        cfg = self.cfg
        scans = lidar.scan_batch(
            state.pos, state.yaw, state.ped_pos, cfg.ped_radius,
            cfg.room_half_inner, cfg.max_scan_range, cfg.lidar_min_range,
            cfg.n_scans)
        if cfg.lidar_noise > 0.0:
            scans = noisy_scans(cfg, scans, noise, gen)
        scans = nm.round3(scans)
        goal = _goal(cfg, state.pos)
        target = goal.expand_as(state.pos)
        dtg = nm.round_dec(geom.vec_norm(target - state.pos), 2)
        htg = nm.round_dec(geom.heading_to(target, state.pos, state.yaw), 2)
        collided = scans.amin(dim=1) < nm.f32(SIMPLE_MIN_RANGE)
        at_goal = _goal_box(state.pos, goal, cfg.goal_eps)
        timeout = state.step >= cfg.max_steps
        done = state.done | collided | at_goal | timeout
        obs = torch.cat([scans, torch.stack([htg, dtg], -1),
                         nm.round3(state.pos)], -1)
        return obs, dtg, htg, done, at_goal

    def reset(self, n: int, gen: torch.Generator | None = None,
              draws: dict | None = None, lidar_noise=None):
        """``n`` fresh episodes: (state, obs)."""
        state = init_state(self.cfg, n, self.device, gen=gen, draws=draws)
        obs, dtg, htg, _, _ = self._observe(state, lidar_noise, gen)
        return state.replace(prev_distance=dtg, prev_heading=htg), obs

    def step_batch(self, states: EnvState, actions: torch.Tensor,
                   gen: torch.Generator | None = None,
                   vel_draw: torch.Tensor | None = None,
                   noise: dict | None = None) -> StepOutput:
        """One continuous-mode transition of every env, (N, 2) actions;
        ``vel_draw`` and ``noise`` as in ``CrowdEnv.step_batch``."""
        cfg = self.cfg
        n = actions.shape[0]
        noise = noise or {}
        was_done = states.done
        s = world_step(cfg, states, actions, vel_draw=vel_draw, gen=gen,
                       noise=noise)
        obs, dtg, htg, done, at_goal = self._observe(s, noise.get("lidar"),
                                                     gen)
        if cfg.strict_quirks:
            # the reference's shaping reads the agent's y and x (:325)
            dtg, htg = obs[:, -1], obs[:, -2]
        dtg_r = torch.where(dtg - s.prev_distance < 0, 1.0, 0.0)
        non_term = dtg_r + _htg_reward(htg, s.prev_heading)
        terminal = torch.where(at_goal, nm.f32(cfg.goal_reward),
                               nm.f32(cfg.collision_reward))
        reward = non_term + torch.where(done, terminal, 0.0)
        s = s.replace(prev_distance=dtg, prev_heading=htg, done=done,
                      episode_success=at_goal,
                      episode_failure=done & ~at_goal)
        tmpl_state, tmpl_obs = self.template
        reset_state = tmpl_state.map(lambda a: a.expand(n, *a.shape[1:]))
        return StepOutput(select_rows(was_done, reset_state, s),
                          torch.where(was_done[:, None], tmpl_obs, obs),
                          torch.where(was_done, 0.0, reward),
                          torch.where(was_done, False, done))

    def step_discrete(self, states: EnvState, action_idx: torch.Tensor,
                      gen: torch.Generator | None = None,
                      vel_draw: torch.Tensor | None = None,
                      noise: dict | None = None) -> StepOutput:
        """One transition with (N,) int action indices into
        ``DISCRETE_ACTIONS_TABLE``."""
        return self.step_batch(states, self.actions_table[action_idx.long()],
                               gen=gen, vel_draw=vel_draw, noise=noise)
