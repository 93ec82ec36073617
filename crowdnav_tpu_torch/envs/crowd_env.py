"""Perceived-risk crowd-navigation environment, batched (port of
``crowdnav_tpu/envs/crowd_env.py``).

Every function works on a batch of N envs. The step always goes through
the two kernel wrappers: the raycast of the config's ``lidar_backend``
(``ops.lidar.scan_batch``, or ``scan_batch_pallas`` for ``"pallas"``) and
``ops.risk_kernel.track_cp_topk_batch`` (tracker -> CP -> top-K, in the
form of ``risk_backend`` and ``strict_quirks``), which launch their CUDA
kernels on CUDA tensors and run the plain PyTorch versions on CPU
tensors. The JAX package's two risk backends share every step function
but the chain; its Pallas backend's batched path (``_observe_batch`` then
the vmapped ``_reward``) is the port's only path.

The per-step noise knobs (``actuation_noise``, ``dt_jitter``,
``lidar_noise``) draw from the step's generator, or from ``noise`` (keys
``"act"``, ``"dt"``: ``world.noise_draws``; ``"lidar"``:
:func:`lidar_noise_draw`), which take the roles of the JAX package's
``k_act``, ``k_dt`` and ``fold_in(key, 7)`` draws.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import torch

from crowdnav_tpu_torch.envs.config import EnvConfig
from crowdnav_tpu_torch.envs.world import EnvState, init_state, world_step
from crowdnav_tpu_torch.ops import geom, lidar, risk
from crowdnav_tpu_torch.utils import numerics as nm
from crowdnav_tpu_torch.utils.device import resolve

F32 = torch.float32


class StepOutput(NamedTuple):
    state: EnvState
    obs: torch.Tensor     # (N, obs_dim)
    reward: torch.Tensor  # (N,)
    done: torch.Tensor    # (N,) bool


@functools.lru_cache(maxsize=None)
def _goal_tensor(goal: tuple, device: torch.device) -> torch.Tensor:
    return torch.tensor(goal, dtype=F32, device=device)


def _goal(cfg: EnvConfig, like: torch.Tensor) -> torch.Tensor:
    """The goal (2,), made once per goal and device: a step copies nothing
    from the host (a captured step may not). Read only."""
    return _goal_tensor(tuple(cfg.goal), like.device)


def _goal_box(pos, center, eps):
    """Closed axis-aligned box test ``|pos - center| <= eps``."""
    return (torch.abs(pos - center) <= nm.f32(eps)).all(dim=-1)


def _htg_reward(curr, prev):
    """+1 when the heading error moved toward zero or crossed sign, 0 when
    it drifted further on the same side (``compute_reward:1080-1106``)."""
    hd = curr - prev
    cp, cn, pp, pn = curr > 0, curr < 0, prev > 0, prev < 0
    pos_case = torch.where(cp & pp, 0.0, torch.where(
        (cp & pn) | (cn & pn) | (cn & pp), 1.0, 0.0))
    neg_case = torch.where(cn & pn, 0.0, torch.where(
        (cn & pp) | (cp & pp) | (cp & pn), 1.0, 0.0))
    return torch.where(hd > 0, pos_case, torch.where(hd < 0, neg_case, 0.0))


def lidar_noise_draw(cfg: EnvConfig, n: int, gen, device) -> torch.Tensor:
    """(N, n_scans) Gaussian range noise, the standard normal times
    ``lidar_noise``."""
    return torch.randn((n, cfg.n_scans), generator=gen, device=device) \
        * nm.f32(cfg.lidar_noise)


def noisy_scans(cfg: EnvConfig, scans, noise, gen=None):
    """The lidar plugin's noise on hit beams only, re-clipped to the
    sensor band: ``noise`` (N, n_scans) from :func:`lidar_noise_draw`, or
    drawn from ``gen`` when None."""
    if noise is None:
        noise = lidar_noise_draw(cfg, scans.shape[0], gen, scans.device)
    hit = scans < nm.f32(cfg.max_scan_range)
    noisy = torch.clamp(scans + noise, nm.f32(cfg.lidar_min_range),
                        nm.f32(cfg.max_scan_range))
    return torch.where(hit, noisy, scans)


def _sense(cfg: EnvConfig, state: EnvState, noise=None, gen=None,
           scans=None):
    """Raycast (the kernel wrapper of the config's lidar backend) or the
    external ``scans`` of a real sensor, the optional hit-beam noise,
    3-decimal rounding, world-frame points."""
    if scans is None:
        scans = lidar.scan_fn(cfg.lidar_backend)(
            state.pos, state.yaw, state.ped_pos, cfg.ped_radius,
            cfg.room_half_inner, cfg.max_scan_range, cfg.lidar_min_range,
            cfg.n_scans)
    if cfg.lidar_noise > 0.0:
        scans = noisy_scans(cfg, scans, noise, gen)
    scans = nm.round3(scans)
    return scans, lidar.scan_points(state.pos, state.yaw, scans, cfg.n_scans)


def _goal_features(cfg: EnvConfig, state: EnvState):
    """Waypoint refresh and the distance/heading-to-waypoint features."""
    goal = _goal(cfg, state.pos).expand_as(state.pos)
    if cfg.use_waypoints:
        wp_first = geom.waypoint_on_circle(state.pos, goal,
                                           cfg.waypoint_radius)
        waypoint = torch.where((state.step == 1)[:, None], wp_first,
                               state.waypoint)
        dtg = nm.round_dec(geom.vec_norm(waypoint - state.pos), 2)
        htg = nm.round_dec(geom.heading_to(waypoint, state.pos, state.yaw), 2)
        refresh = (torch.remainder(state.step, 5) == 0) \
            | (dtg < state.prev_distance)
        waypoint = torch.where(refresh[:, None], wp_first, waypoint)
    else:
        waypoint = goal.clone()
        dtg = nm.round_dec(geom.vec_norm(goal - state.pos), 2)
        htg = nm.round_dec(geom.heading_to(goal, state.pos, state.yaw), 2)
    return waypoint, dtg, htg


def _finish_observe(cfg: EnvConfig, state: EnvState, scans,
                    out: risk.RiskOutput, waypoint, dtg, htg, compute_cp):
    """Termination flags, observation assembly, state bookkeeping."""
    goal = _goal(cfg, state.pos)
    collided = (scans.amin(dim=1) < nm.f32(cfg.min_scan_range)) \
        if cfg.min_scan_range > 0 else torch.zeros_like(state.done)
    at_goal = _goal_box(state.pos, goal, cfg.goal_eps)
    timeout = state.step >= cfg.max_steps
    done = state.done | collided | at_goal | timeout

    head = [scans, torch.stack([htg, dtg], -1), nm.round3(state.pos)]
    if cfg.state_variant == "basic":
        obs = torch.cat(head, -1)
    elif cfg.state_variant == "basic_grp":
        # goal-reaching probability: collision-cone TTC of the motion line
        # against an r = 0.2 circle at the goal
        motion = state.pos - state.prev_pos
        speed_raw = geom.vec_norm(motion)
        agent_speed = nm.div_const(speed_raw, cfg.dt)
        u = motion / torch.clamp_min(speed_raw, nm.f32(1e-9))[:, None]
        d_goal = geom.line_circle_min_distance(state.prev_pos, u, goal, 0.2)
        moving = agent_speed != 0.0
        ttg = d_goal / torch.where(moving, agent_speed, 1.0)
        grp = geom.collision_prob_ttc(
            ttg, torch.isfinite(d_goal) & moving & compute_cp)
        obs = torch.cat(head + [grp[:, None]], -1)
    else:
        # the reference's velocity features use the angular rate as the
        # angle; kept verbatim
        vx = -state.lin_vel * nm.cos(state.ang_vel)
        vy = state.lin_vel * nm.sin(state.ang_vel)
        topk = out.top_k_pose_vel
        if cfg.state_variant == "no_cp":
            pad = torch.cat([state.pos, torch.zeros_like(state.pos)], -1)
            topk = pad[:, None, :].expand_as(topk)
        obs = torch.cat(head + [nm.round3(state.yaw)[:, None],
                                nm.round3(torch.stack([vx, vy], -1)),
                                topk.reshape(topk.shape[0], -1)], -1)
    obs = nm.round3(obs)

    i32 = torch.int32
    new_state = state.replace(
        waypoint=waypoint, tracks=out.tracks, done=done,
        episode_success=at_goal, episode_failure=done & ~at_goal,
        ego_cp=out.ego_cp,
        obstacle_present_steps=state.obstacle_present_steps
        + out.obstacle_seen.to(i32),
        ego_violations=state.ego_violations + out.ego_violation.to(i32),
        social_violations=state.social_violations
        + (out.ego_cp > nm.f32(cfg.social_cp_threshold)).to(i32))
    return new_state, obs, (dtg, htg), done, at_goal


def _observe_batch(cfg: EnvConfig, state: EnvState, compute_cp,
                   noise=None, gen=None, scans=None):
    """Sensor and perception half of the step for the batch: raycast
    kernel (or the external ``scans``), then ``risk.perceive``
    (segmentation in plain PyTorch, the tracker -> CP -> top-K kernel, and
    the social regions of the segments under ``compute_regions``).
    ``compute_cp`` is (N,) bool."""
    scans, points = _sense(cfg, state, noise, gen, scans)
    waypoint, dtg, htg = _goal_features(cfg, state)
    out = risk.perceive(cfg, scans, points, state.tracks, state.pos,
                        state.prev_pos, compute_cp,
                        yaw=state.yaw if cfg.compute_regions else None)
    return _finish_observe(cfg, state, scans, out, waypoint, dtg, htg,
                           compute_cp)


def _reward(cfg: EnvConfig, state: EnvState, dtg, htg, done, at_goal):
    """``compute_reward:1046-1162`` with the milestone waypoint bonus (the
    JAX package's default semantics), or under ``strict_quirks`` the
    reference's literal box test against the current waypoint."""
    goal = _goal(cfg, state.pos)
    dd = dtg - state.prev_distance
    dtg_r = torch.where(dd < 0, nm.f32(cfg.dtg_reward), 0.0)
    htg_r = _htg_reward(htg, state.prev_heading) * nm.f32(cfg.htg_reward)
    best = state.best_goal_dist
    if cfg.use_waypoints:
        new_wp = geom.waypoint_on_circle(state.pos, goal.expand_as(state.pos),
                                         cfg.waypoint_radius)
        new_wp = torch.where(_goal_box(new_wp, goal, cfg.goal_eps)[:, None],
                             goal, new_wp)
        if cfg.strict_quirks:
            at_waypoint = _goal_box(state.pos, state.waypoint, cfg.goal_eps)
        else:
            goal_dist = geom.norm(state.pos - goal)
            at_waypoint = goal_dist <= best - nm.f32(cfg.waypoint_radius)
            best = torch.where(at_waypoint, goal_dist, best)
        wp_r = torch.where(at_waypoint, nm.f32(cfg.waypoint_reward), 0.0)
        waypoint = torch.where(at_waypoint[:, None], new_wp, state.waypoint)
    else:
        wp_r = torch.zeros_like(dtg)
        at_waypoint = torch.zeros_like(state.done)
        waypoint = state.waypoint
    non_term = ((nm.f32(cfg.step_penalty) + dtg_r) + htg_r) + wp_r
    terminal = torch.where(at_goal, nm.f32(cfg.goal_reward),
                           nm.f32(cfg.collision_reward))
    reward = non_term + torch.where(done, terminal, 0.0)
    i32 = torch.int32
    return reward, state.replace(
        waypoint=waypoint, prev_distance=dtg, prev_heading=htg,
        best_goal_dist=best,
        dtg_reward_count=state.dtg_reward_count + (dd < 0).to(i32),
        htg_reward_count=state.htg_reward_count + (htg_r > 0).to(i32),
        wp_bonus_count=state.wp_bonus_count + at_waypoint.to(i32))


class CrowdEnv:
    """Perceived-risk environment bound to a config and a device.

    ``template`` is the (state, obs) of one fresh episode, drawn from
    ``seed`` when the config has reset jitter: the batched auto-reset
    restores it, as the JAX package's template reset does."""

    def __init__(self, cfg: EnvConfig, device="cuda", seed: int = 0):
        risk.chain_form(cfg)        # refuses pallas with strict_quirks
        lidar.scan_fn(cfg.lidar_backend)
        self.cfg = cfg
        self.device = resolve(device)
        self.obs_dim = cfg.state_dim_risk
        self.action_dim = 2
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.template = self.reset(1, gen)

    def reset(self, n: int, gen: torch.Generator | None = None,
              draws: dict | None = None, lidar_noise=None):
        """``n`` fresh episodes: (state, obs). The CP block is skipped on
        the reset observation, so the top-K slots hold the robot-pose
        padding. ``lidar_noise``: the observation's range noise under
        ``lidar_noise`` (else drawn from ``gen``)."""
        state = init_state(self.cfg, n, self.device, gen=gen, draws=draws)
        no_cp = torch.zeros((n,), dtype=torch.bool, device=self.device)
        state, obs, (dtg, htg), _, _ = _observe_batch(
            self.cfg, state, no_cp, lidar_noise, gen)
        false = torch.zeros_like(state.done)
        state = state.replace(prev_distance=dtg, prev_heading=htg,
                              done=false, episode_success=false,
                              episode_failure=false.clone())
        return state, obs

    def step_batch(self, states: EnvState, actions: torch.Tensor,
                   gen: torch.Generator | None = None,
                   vel_draw: torch.Tensor | None = None,
                   noise: dict | None = None) -> StepOutput:
        """One transition of every env: physics, perception, reward, and
        the template auto-reset of envs whose episode ended on the previous
        step. ``vel_draw`` (N, P, 2) feeds the RANDOM crowd's velocity
        draw and ``noise`` the per-step noise knobs' draws (module
        docstring); what is not given is drawn from ``gen``."""
        cfg = self.cfg
        n = actions.shape[0]
        noise = noise or {}
        was_done = states.done
        s = world_step(cfg, states, actions, vel_draw=vel_draw, gen=gen,
                       noise=noise)
        s, obs, (dtg, htg), done, at_goal = _observe_batch(
            cfg, s, torch.ones((n,), dtype=torch.bool, device=self.device),
            noise.get("lidar"), gen)
        reward, s = _reward(cfg, s, dtg, htg, done, at_goal)

        tmpl_state, tmpl_obs = self.template
        reset_state = tmpl_state.map(lambda a: a.expand(n, *a.shape[1:]))
        if cfg.persist_tracks_across_reset:
            reset_state = reset_state.replace(tracks=states.tracks,
                                              waypoint=states.waypoint)
        new_state = select_rows(was_done, reset_state, s)
        obs = torch.where(was_done[:, None], tmpl_obs, obs)
        return StepOutput(new_state, obs,
                          torch.where(was_done, 0.0, reward),
                          torch.where(was_done, False, done))

    def observe_external(self, states: EnvState, scans: torch.Tensor,
                         pos: torch.Tensor, yaw: torch.Tensor,
                         noise=None, gen: torch.Generator | None = None):
        """The deployment observation (the JAX ``observe_external``,
        batched): the perception path on real lidar ``scans`` (N,
        n_scans) and odometry ``pos`` (N, 2), ``yaw`` (N,) instead of the
        simulated world, the raycast bypassed; ``(states, obs)``. The
        robot's previous position is the state's, the step count moves on,
        and the observation's distance and heading become the state's
        previous ones. ``noise``: the range noise under ``lidar_noise``
        (else drawn from ``gen``). As in the JAX package, the tracker chain
        is the XLA chain's whatever ``risk_backend`` says."""
        cfg = self.cfg if self.cfg.risk_backend == "xla" \
            else dataclasses.replace(self.cfg, risk_backend="xla")
        states = states.replace(prev_pos=states.pos, pos=pos, yaw=yaw,
                                step=states.step + 1)
        n = pos.shape[0]
        states, obs, (dtg, htg), _, _ = _observe_batch(
            cfg, states,
            torch.ones((n,), dtype=torch.bool, device=pos.device), noise,
            gen, scans)
        return states.replace(prev_distance=dtg, prev_heading=htg), obs

    def safety_scores(self, state: EnvState):
        """Per-episode ego and social safety scores, (N,) each."""
        denom = torch.clamp_min(state.obstacle_present_steps, 1).to(F32)
        ego = 1.0 - state.ego_violations.to(F32) / denom
        social = 1.0 - state.social_violations.to(F32) / denom
        return ego, social


def select_rows(mask: torch.Tensor, a: EnvState, b: EnvState) -> EnvState:
    """Row-wise ``where(mask, a, b)`` over every field."""
    def sel(x, y):
        return torch.where(mask.reshape(mask.shape + (1,) * (x.dim() - 1)),
                           x, y)
    return a.map(sel, b)
