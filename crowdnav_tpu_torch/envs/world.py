"""World model: batched env state, robot kinematics, crowd dynamics.

Port of ``crowdnav_tpu/envs/world.py``. Every field of :class:`EnvState`
carries a leading env axis N where the JAX package vmaps. Random draws come
from an explicit ``torch.Generator``; each drawing function also takes the
draws as an argument, so a test can feed the JAX package's.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from crowdnav_tpu_torch.envs.config import CrowdBehavior, EnvConfig
from crowdnav_tpu_torch.utils import numerics as nm
from crowdnav_tpu_torch.utils.device import resolve
from crowdnav_tpu_torch.utils.tree import tree_map

F32 = torch.float32
PI = nm.f32(math.pi)
TWO_PI = nm.f32(2 * math.pi)


class _Tree:
    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    def map(self, fn, *others):
        return tree_map(fn, self, *others)


@dataclasses.dataclass
class TrackState(_Tree):
    """Fixed-slot obstacle tracker, (N, T) slots."""

    valid: torch.Tensor      # (N, T) bool
    pos: torch.Tensor        # (N, T, 2)
    prev_pos: torch.Tensor   # (N, T, 2)
    has_prev: torch.Tensor   # (N, T) bool
    dist: torch.Tensor       # (N, T)
    speed: torch.Tensor      # (N, T)
    vel: torch.Tensor        # (N, T, 2) (prev - curr) / dt


@dataclasses.dataclass
class EnvState(_Tree):
    """Per-env MDP state with a leading env axis N (see the JAX
    ``EnvState`` for each field's meaning). There is no PRNG key: draws
    come from a generator passed to the functions that draw."""

    pos: torch.Tensor            # (N, 2)
    yaw: torch.Tensor            # (N,)
    lin_vel: torch.Tensor        # (N,)
    ang_vel: torch.Tensor        # (N,)
    prev_pos: torch.Tensor       # (N, 2)
    ped_pos: torch.Tensor        # (N, P, 2)
    ped_vel: torch.Tensor        # (N, P, 2)
    ped_dirs: torch.Tensor       # (N, P, 2)
    ped_phase: torch.Tensor      # (N,) int32
    waypoint: torch.Tensor       # (N, 2)
    prev_distance: torch.Tensor  # (N,)
    prev_heading: torch.Tensor   # (N,)
    best_goal_dist: torch.Tensor  # (N,)
    tracks: TrackState
    step: torch.Tensor           # (N,) int32
    done: torch.Tensor           # (N,) bool
    episode_success: torch.Tensor
    episode_failure: torch.Tensor
    ego_cp: torch.Tensor         # (N,)
    social_violations: torch.Tensor  # (N,) int32
    ego_violations: torch.Tensor
    obstacle_present_steps: torch.Tensor
    last_action_type: torch.Tensor
    dtg_reward_count: torch.Tensor
    htg_reward_count: torch.Tensor
    wp_bonus_count: torch.Tensor


def wrap_pi(theta: torch.Tensor) -> torch.Tensor:
    """``(theta + pi) % (2 pi) - pi`` (floor modulo, as ``jnp``'s ``%``)."""
    return torch.remainder(theta + PI, TWO_PI) - PI


def _uniform(gen, shape, lo, hi, device):
    """``jax.random.uniform``'s affine map of [0, 1) draws to [lo, hi)."""
    u = torch.rand(shape, generator=gen, device=device, dtype=F32)
    return torch.maximum(nm.fma(u, nm.f32(hi - lo), nm.f32(lo)),
                         torch.full((), nm.f32(lo), device=device))


def reset_draws(cfg: EnvConfig, n: int, gen: torch.Generator,
                device) -> dict:
    """The random spawn of ``n`` fresh episodes (see :func:`init_state`)."""
    p = max(cfg.n_peds, 1)
    d = {}
    if cfg.start_pos_jitter > 0:
        d["pos"] = _uniform(gen, (n, 2), -cfg.start_pos_jitter,
                            cfg.start_pos_jitter, device)
    if cfg.start_yaw_jitter > 0:
        d["yaw"] = _uniform(gen, (n,), -cfg.start_yaw_jitter,
                            cfg.start_yaw_jitter, device)
    if cfg.ped_pos_jitter > 0 and cfg.n_peds:
        d["ped"] = _uniform(gen, (n, p, 2), -cfg.ped_pos_jitter,
                            cfg.ped_pos_jitter, device)
    if cfg.ped_shuffle and cfg.n_peds:
        d["perm"] = torch.argsort(
            torch.rand((n, p), generator=gen, device=device), dim=1)
    if cfg.ped_phase_jitter:
        d["phase"] = torch.randint(0, max(cfg.redraw_window_steps, 1), (n,),
                                   generator=gen, device=device,
                                   dtype=torch.int32)
    return d


def init_state(cfg: EnvConfig, n: int, device="cuda",
               gen: torch.Generator | None = None,
               draws: dict | None = None) -> EnvState:
    """``n`` fresh episodes (``world.init_state`` of the JAX package).

    With reset jitter on, the spawn comes from ``draws`` (keys ``pos``,
    ``yaw``, ``ped``, ``perm``, ``phase`` as :func:`reset_draws` makes
    them), drawn from ``gen`` when ``draws`` is None."""
    device = resolve(device)
    p = max(cfg.n_peds, 1)
    if cfg.n_peds:
        ped_init = torch.tensor(cfg.ped_init, dtype=F32).reshape(-1, 2)
        dirs = torch.tensor(cfg.direction_table(), dtype=F32).reshape(-1, 2)
    else:
        # the placeholder pedestrian sits far outside lidar range
        ped_init = torch.full((1, 2), 1e3, dtype=F32)
        dirs = torch.zeros((1, 2), dtype=F32)
    ped_init = ped_init.to(device).expand(n, p, 2).clone()
    dirs = dirs.to(device).expand(n, p, 2).clone()
    pos0 = torch.tensor(cfg.start_pose[:2], dtype=F32,
                        device=device).expand(n, 2).clone()
    yaw0 = torch.full((n,), nm.f32(cfg.start_pose[2]), dtype=F32,
                      device=device)
    phase = torch.zeros((n,), dtype=torch.int32, device=device)
    randomized = (cfg.start_pos_jitter > 0 or cfg.start_yaw_jitter > 0
                  or cfg.ped_pos_jitter > 0 or cfg.ped_shuffle
                  or cfg.ped_phase_jitter)
    if randomized:
        if draws is None:
            if gen is None:
                raise ValueError("init_state with reset jitter needs a "
                                 "generator or draws")
            draws = reset_draws(cfg, n, gen, device)
        if cfg.start_pos_jitter > 0:
            lim = nm.f32(cfg.room_half_inner - cfg.robot_radius)
            pos0 = torch.clamp(pos0 + draws["pos"], -lim, lim)
        if cfg.start_yaw_jitter > 0:
            # jitted XLA folds the constants of (yaw0 + u) + pi into
            # u + f32(yaw0 + pi) before the modulo
            c = nm.f32(nm.f32(cfg.start_pose[2]) + PI)
            yaw0 = torch.remainder(draws["yaw"] + c, TWO_PI) - PI
        if cfg.ped_pos_jitter > 0 and cfg.n_peds:
            lim = nm.f32(cfg.room_half_inner - cfg.ped_radius)
            ped_init = torch.clamp(ped_init + draws["ped"], -lim, lim)
        if cfg.ped_shuffle and cfg.n_peds:
            perm = draws["perm"].long()
            dirs = torch.gather(dirs, 1, perm[..., None].expand(n, p, 2))
        if cfg.ped_phase_jitter:
            phase = draws["phase"].to(torch.int32)
    T = cfg.max_tracks
    zf = lambda *s: torch.zeros(s, dtype=F32, device=device)
    zi = lambda: torch.zeros((n,), dtype=torch.int32, device=device)
    zb = lambda *s: torch.zeros(s, dtype=torch.bool, device=device)
    tracks = TrackState(
        valid=zb(n, T), pos=zf(n, T, 2), prev_pos=zf(n, T, 2),
        has_prev=zb(n, T),
        dist=torch.full((n, T), nm.f32(cfg.max_scan_range), dtype=F32,
                        device=device),
        speed=zf(n, T), vel=zf(n, T, 2))
    goal = torch.tensor(cfg.goal, dtype=F32, device=device).expand(n, 2)
    gx, gy = goal[:, 0] - pos0[:, 0], goal[:, 1] - pos0[:, 1]
    d0 = nm.norm2(gx, gy)
    h0 = wrap_pi(nm.atan2(gy, gx) - yaw0)
    return EnvState(
        pos=pos0, yaw=yaw0, lin_vel=zf(n), ang_vel=zf(n),
        prev_pos=pos0.clone(), ped_pos=ped_init, ped_vel=zf(n, p, 2),
        ped_dirs=dirs, ped_phase=phase, waypoint=goal.clone(),
        prev_distance=d0, prev_heading=h0, best_goal_dist=d0.clone(),
        tracks=tracks, step=zi(), done=zb(n), episode_success=zb(n),
        episode_failure=zb(n), ego_cp=zf(n), social_violations=zi(),
        ego_violations=zi(), obstacle_present_steps=zi(),
        last_action_type=zi(), dtg_reward_count=zi(),
        htg_reward_count=zi(), wp_bonus_count=zi())


def integrate_robot(pos, yaw, lin_vel, ang_vel, dt, wheel_separation,
                    wheel_radius):
    """Differential-drive step of ``turtlebot3_fake.cpp`` (midpoint
    heading); ``pos`` (N, 2), the rest (N,), ``dt`` a Python float or,
    under ``dt_jitter``, an (N,) tensor.

    Written as the JAX package's jitted step computes it: XLA folds the
    constant factors of ``(v / R) * dt``, ``R * (wr + wl) / 2`` and
    ``R * (wr - wl) / sep`` into one float32 constant each, and fuses the
    multiply-adds whose product has no other use. With a jittered ``dt``
    the wheel angles are ``(v * f32(1/R)) * dt``."""
    f = np.float32
    r, sep = f(wheel_radius), f(wheel_separation)
    c_turn = float(sep * f(0.5))
    c_ds = float(r * f(0.5))
    c_yaw = f(r * (f(1.0) / sep))
    c_mid = float(c_yaw * f(0.5))
    turn = ang_vel * c_turn
    v_l, v_r = lin_vel - turn, lin_vel + turn
    if isinstance(dt, torch.Tensor):
        inv_r = float(f(1.0) / r)
        wheel_l = (v_l * inv_r) * dt
        rate_r, step = v_r * inv_r, dt
    else:
        c_wheel = float(f(f(1.0) / r) * f(dt))
        wheel_l = v_l * c_wheel
        rate_r, step = v_r, c_wheel
    delta_s = nm.fma(rate_r, step, wheel_l) * c_ds
    diff = nm.fma(rate_r, step, -wheel_l)
    mid = nm.fma(diff, c_mid, yaw)
    new_pos = torch.stack([nm.fma(delta_s, nm.cos(mid), pos[:, 0]),
                           nm.fma(delta_s, nm.sin(mid), pos[:, 1])], -1)
    return new_pos, nm.fma(diff, float(c_yaw), yaw)


def random_velocities(cfg: EnvConfig, shape, gen, device) -> torch.Tensor:
    """The RANDOM behavior's fresh uniform pedestrian velocities."""
    return _uniform(gen, shape, -cfg.crowd_speed, cfg.crowd_speed, device)


def crowd_step(cfg: EnvConfig, step, ped_pos, ped_vel, ped_dirs, ped_phase,
               vel_draw=None, gen=None, dt=None):
    """Advance pedestrians one dt (``cfg.dt``, or the (N,) jittered
    ``dt``). ``vel_draw`` (N, P, 2) is the RANDOM behavior's fresh uniform
    velocity, drawn from ``gen`` when None."""
    if cfg.n_peds == 0:
        return ped_pos, ped_vel
    redraw = torch.remainder(step + ped_phase, cfg.redraw_window_steps) == 0
    if cfg.behavior == CrowdBehavior.RANDOM:
        if vel_draw is None:
            vel_draw = random_velocities(cfg, ped_pos.shape, gen,
                                         ped_pos.device)
        new_vel = vel_draw
    elif cfg.behavior == CrowdBehavior.STATIC:
        new_vel = torch.zeros_like(ped_vel)
    else:
        new_vel = ped_dirs * nm.f32(cfg.crowd_speed)
    vel = torch.where(redraw[:, None, None], new_vel, ped_vel)
    step_dt = nm.f32(cfg.dt) if dt is None else dt[:, None, None]
    pos = nm.fma(vel, step_dt, ped_pos)
    lim = nm.f32(cfg.room_half_inner - cfg.ped_radius)
    return torch.clamp(pos, -lim, lim), vel


def classify_action(lin_vel, ang_vel, mode_discrete: bool = False):
    """0 = FORWARD (|w| <= 2/16), 1 = LEFT, 2 = RIGHT, 3 = STOP; the same
    codes in both action modes (``mode_discrete`` is accepted, and unused,
    as in the JAX package)."""
    fwd = (ang_vel >= -0.125) & (ang_vel <= 0.125)
    code = torch.where(fwd, 0, torch.where(ang_vel > 0, 1, 2))
    stop = (lin_vel == 0.0) & (ang_vel == 0.0)
    return torch.where(stop, 3, code).to(torch.int32)


def noise_draws(cfg: EnvConfig, n: int, gen, device) -> dict:
    """The per-step noise :func:`world_step` takes, drawn from ``gen``:
    ``"act"`` (N, 2), the standard normal times ``actuation_noise``, and
    ``"dt"`` (N,), uniform in [-dt_jitter, dt_jitter). The JAX package
    draws them from the step's ``k_act`` and ``k_dt`` keys."""
    d = {}
    if cfg.actuation_noise > 0.0:
        d["act"] = torch.randn((n, 2), generator=gen, device=device) \
            * nm.f32(cfg.actuation_noise)
    if cfg.dt_jitter > 0.0:
        d["dt"] = _uniform(gen, (n,), -cfg.dt_jitter, cfg.dt_jitter, device)
    return d


def world_step(cfg: EnvConfig, state: EnvState, action: torch.Tensor,
               vel_draw=None, gen=None, noise: dict | None = None
               ) -> EnvState:
    """Physics half of the step: apply ``action`` (N, 2) = (lin, ang),
    integrate the robot and the crowd. With ``actuation_noise`` or
    ``dt_jitter`` the robot executes a noisy command over a jittered dt
    (the crowd moves over the same dt), from ``noise`` (as
    :func:`noise_draws` makes it; other keys are ignored) or drawn from
    ``gen``; the recorded velocities and action type stay the commanded
    ones."""
    lin_vel, ang_vel = action[:, 0], action[:, 1]
    exec_lin, exec_ang, dt = lin_vel, ang_vel, cfg.dt
    if (cfg.actuation_noise > 0.0 or cfg.dt_jitter > 0.0) and not (
            noise and noise.keys() & {"act", "dt"}):
        noise = noise_draws(cfg, action.shape[0], gen, action.device)
    if cfg.actuation_noise > 0.0:
        z = noise["act"]
        exec_lin = nm.fma(z[:, 0], nm.f32(cfg.max_lin_vel), lin_vel)
        exec_ang = nm.fma(z[:, 1], nm.f32(cfg.max_ang_vel), ang_vel)
    if cfg.dt_jitter > 0.0:
        dt = (1.0 + noise["dt"]) * nm.f32(cfg.dt)
    pos, yaw = integrate_robot(state.pos, state.yaw, exec_lin, exec_ang, dt,
                               cfg.wheel_separation, cfg.wheel_radius)
    lim = nm.f32(cfg.room_half_inner - cfg.robot_radius)
    pos = torch.clamp(pos, -lim, lim)
    yaw = wrap_pi(yaw)
    ped_pos, ped_vel = crowd_step(
        cfg, state.step, state.ped_pos, state.ped_vel, state.ped_dirs,
        state.ped_phase, vel_draw, gen,
        dt if isinstance(dt, torch.Tensor) else None)
    return state.replace(
        pos=pos, yaw=yaw, lin_vel=lin_vel, ang_vel=ang_vel,
        prev_pos=state.pos, ped_pos=ped_pos, ped_vel=ped_vel,
        step=state.step + 1,
        last_action_type=classify_action(lin_vel, ang_vel))
