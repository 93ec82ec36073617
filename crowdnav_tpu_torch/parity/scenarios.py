"""Fixed-seed trajectory parity: the port's env against the NumPy oracle.

The ten scenarios of the JAX package's ``tests/test_parity.py``, run by the
port: its batched ``CrowdEnv`` (one env, on any device) and its
:class:`NumpyCrowdEnv` are driven with identical actions and crowd
velocities, and states, rewards and termination must agree step by step
within that file's tolerances (SURVEY.md §7.10: behavior-equivalence is
the test target, not line-equivalence). :func:`run` raises
``AssertionError`` on the first violation and returns the largest
differences it saw; ``tests/test_torch_parity.py`` runs every scenario on
the CPU and ``chip_smoke.py`` on the card.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from crowdnav_tpu_torch.envs import crowd_env
from crowdnav_tpu_torch.envs.config import make_config
from crowdnav_tpu_torch.ops import risk
from crowdnav_tpu_torch.parity.reference_env import NumpyCrowdEnv

# the tolerances of tests/test_parity.py's _check
SCAN_ATOL = 2.5e-3
GOAL_ATOL = 0.011      # htg/dtg rounded to 2 decimals in both: one ulp
POSE_ATOL = 2e-3
REWARD_ATOL = 1e-3
N_SCANS = 359


def _arcs(cfg):
    rng = np.random.default_rng(3)
    return [(float(rng.uniform(0, 0.22)), float(rng.uniform(-2, 2)))
            for _ in range(60)]


def steering_actions(cfg, n):
    """Open-loop goal-steering action sequence from a dead-reckoned rollout
    of the same diff-drive integrator (no env involved): heading-P control
    at full speed — the profile under which the reference's literal
    waypoint box demonstrably fires (see crowd_env._reward docstring)."""
    x, y, yaw = cfg.start_pose
    gx, gy = cfg.goal
    acts = []
    for _ in range(n):
        hd = (math.atan2(gy - y, gx - x) - yaw + math.pi) % (2 * math.pi) \
            - math.pi
        v, w = 0.22, float(np.clip(2.0 * hd, -2.0, 2.0))
        acts.append((v, w))
        vl = v - w * cfg.wheel_separation / 2.0
        vr = v + w * cfg.wheel_separation / 2.0
        wl = vl / cfg.wheel_radius * cfg.dt
        wr = vr / cfg.wheel_radius * cfg.dt
        ds = cfg.wheel_radius * (wr + wl) / 2.0
        dth = cfg.wheel_radius * (wr - wl) / cfg.wheel_separation
        x += ds * math.cos(yaw + dth / 2.0)
        y += ds * math.sin(yaw + dth / 2.0)
        yaw = (yaw + dth + math.pi) % (2 * math.pi) - math.pi
    return acts


@dataclasses.dataclass(frozen=True)
class Spec:
    """A scenario's world, behavior, config overrides and actions;
    ``moving``: the crowd moves at its direction table's velocities (the
    oracle gets them as a constant schedule, the env derives the same
    ones from its behavior table), else it stands still."""

    world: str
    behavior: str
    overrides: dict
    actions: Callable
    moving: bool = False


_COURSE = ((0.3, -0.75), (0.0, -0.3), (-0.5, 0.2))
SPECS = {
    "empty_room_straight": Spec(
        "crowd_none", "static", dict(max_steps=60),
        lambda cfg: [(0.22, 0.0)] * 40),
    "empty_room_arcs": Spec(
        "crowd_none", "static", dict(max_steps=80), _arcs),
    "static_obstacle_course": Spec(
        "crowd_none", "static",
        dict(n_peds=3, ped_init=_COURSE, max_steps=80),
        lambda cfg: [(0.15, 0.3)] * 30 + [(0.22, -0.5)] * 20),
    "topk_positions_static_scene": Spec(
        "crowd_none", "static",
        dict(n_peds=1, ped_init=((0.30, -0.75),), max_steps=40),
        lambda cfg: [(0.05, 0.0)] * 6),
    "moving_crowd_scans": Spec(
        "crowd_none", "crossing",
        dict(n_peds=4, ped_init=((0.30, -0.75), (0.35, -0.40),
                                 (-0.20, -0.90), (0.10, -1.10)),
             max_steps=60),
        lambda cfg: [(0.05, 0.0)] * 25, moving=True),
    "moving_crowd_velocity_estimation": Spec(
        "crowd_none", "crossing",
        dict(n_peds=1, ped_init=((0.30, -0.60),), max_steps=60),
        lambda cfg: [(0.03, 0.0)] * 14, moving=True),
    "moving_crowd_nonzero_cp": Spec(
        "crowd_none", "towards",
        dict(n_peds=1, ped_init=((-0.20, -0.75),), max_steps=60),
        lambda cfg: [(0.10, 0.0)] * 20, moving=True),
    "collision_termination": Spec(
        "crowd_none", "static", dict(max_steps=200),
        lambda cfg: [(0.22, 0.0)] * 200),
    "strict_quirks_trajectory": Spec(
        "crowd_none", "crossing",
        dict(n_peds=3, ped_init=((0.45, 0.10), (-0.10, 0.50), (0.10, -0.60)),
             crowd_speed=0.04, k_obstacles=2, strict_quirks=True,
             max_steps=120),
        lambda cfg: steering_actions(cfg, 40), moving=True),
    "segment_regions_static_scene": Spec(
        "crowd_none", "static",
        dict(n_peds=3, ped_init=_COURSE, max_steps=80),
        lambda cfg: [(0.15, 0.3)] * 12 + [(0.22, -0.5)] * 8),
}


def inputs(name: str, make=make_config):
    """``(cfg, actions, ped_vel)`` of scenario ``name``, the config built by
    ``make`` (this package's ``make_config``, or the JAX package's in a
    test that drives both oracles). ``ped_vel`` (P, 2) float64: the crowd's
    constant velocity (zeros for a standing crowd)."""
    spec = SPECS[name]
    cfg = make(spec.world, spec.behavior, **spec.overrides)
    if spec.moving:
        vel = np.array(cfg.direction_table(), float) * cfg.crowd_speed
    else:
        vel = np.zeros((cfg.n_peds, 2))
    return cfg, spec.actions(cfg), vel


@dataclasses.dataclass
class Step:
    env_obs: np.ndarray
    oracle_obs: np.ndarray
    env_reward: float
    oracle_reward: float
    env_done: bool
    oracle_done: bool
    env_ego_cp: float
    oracle_ego_cp: float


def _env_and_oracle(cfg, device):
    env = crowd_env.CrowdEnv(cfg, device=device)
    nenv = NumpyCrowdEnv(cfg)
    state, obs = env.reset(1)
    return env, nenv, state, obs, nenv.reset()


def _action(env, a):
    return torch.tensor([a], dtype=torch.float32, device=env.device)


def run_pair(cfg, actions, ped_vel, device="cuda") -> list[Step]:
    """Drive the port's env (one env on ``device``) and the oracle with
    identical actions until either ends; the first row is the reset."""
    env, nenv, state, obs, nobs = _env_and_oracle(cfg, device)
    traj = [Step(obs[0].cpu().numpy(), nobs, 0.0, 0.0, False, False, 0.0,
                 0.0)]
    for a in actions:
        out = env.step_batch(state, _action(env, a))
        state = out.state
        nobs, nrew, ndone = nenv.step(a, ped_vel=ped_vel)
        traj.append(Step(out.obs[0].cpu().numpy(), nobs,
                         float(out.reward[0]), nrew, bool(out.done[0]),
                         ndone, float(state.ego_cp[0]), float(nenv.ego_cp)))
        if traj[-1].env_done or ndone:
            break
    return traj


def check(traj: list[Step]) -> dict:
    """``tests/test_parity.py``'s ``_check`` over every step; returns the
    largest differences."""
    n = N_SCANS
    worst = dict.fromkeys(("scans", "goal_features", "pose", "yaw",
                           "reward"), 0.0)

    def within(key, a, b, atol, t):
        d = float(np.max(np.abs(np.asarray(a, float) - np.asarray(b, float)),
                         initial=0.0))
        worst[key] = max(worst[key], d)
        if not d <= atol:
            raise AssertionError(f"{key} differ at step {t}: {d} > {atol}")

    for t, s in enumerate(traj):
        jo, no = s.env_obs, s.oracle_obs
        within("scans", jo[:n], no[:n], SCAN_ATOL, t)
        within("goal_features", jo[n:n + 2], no[n:n + 2], GOAL_ATOL, t)
        within("pose", jo[n + 2:n + 4], no[n + 2:n + 4], POSE_ATOL, t)
        dyaw = abs(float(jo[n + 4]) - float(no[n + 4]))
        dyaw = min(dyaw, 2 * np.pi - dyaw)  # +pi == -pi
        worst["yaw"] = max(worst["yaw"], dyaw)
        if not dyaw < POSE_ATOL + 1e-3:
            raise AssertionError(f"yaw differs at step {t}: {dyaw}")
        if s.env_done != s.oracle_done:
            raise AssertionError(f"done mismatch at step {t}")
        if t > 0:
            within("reward", s.env_reward, s.oracle_reward, REWARD_ATOL, t)
    return worst


def _top_k(obs, k):
    return obs[-4 * k:].reshape(k, 4)


def _topk_positions(cfg, traj, vel):
    """With an obstacle in view, both pipelines report it in the top-K
    block at matching positions."""
    k = cfg.k_obstacles
    target = np.array([0.30, -0.75])
    for name, obs in (("env", traj[-1].env_obs),
                      ("oracle", traj[-1].oracle_obs)):
        d = np.linalg.norm(_top_k(obs, k)[:, :2] - target, axis=-1).min()
        if not d < 0.1:
            raise AssertionError(f"{name}: no top-K slot near the obstacle "
                                 f"({d})")


def _moving_scans(cfg, traj, vel):
    if not len(traj) > 10:
        raise AssertionError(f"only {len(traj)} steps")


def _velocity_estimation(cfg, traj, vel):
    """Track-velocity cross-check under motion: both engines estimate the
    moving obstacle's velocity in the top-K block (reference velocity
    estimation `:745-761`, stored as (prev-curr)/dt `:806-810`)."""
    if not np.linalg.norm(vel[0]) > 0:
        raise AssertionError("the crossing table's slot 0 does not move")
    k = cfg.k_obstacles
    jtail, ntail = _top_k(traj[-1].env_obs, k), _top_k(traj[-1].oracle_obs,
                                                        k)
    # the tracked obstacle slot: nearest to the true ped end position
    end = np.array([0.30, -0.60]) + vel[0] * cfg.dt * (len(traj) - 1)
    ji = np.linalg.norm(jtail[:, :2] - end, axis=-1).argmin()
    ni = np.linalg.norm(ntail[:, :2] - end, axis=-1).argmin()
    speed = np.linalg.norm(jtail[ji, 2:])
    # the sign convention is (prev-curr)/dt; what matters is that both
    # engines agree, in the ballpark of the true 0.1*sqrt(2) speed
    if not (np.linalg.norm(jtail[ji, :2] - end) < 0.12 and speed > 0.02
            and 0.04 < speed < 0.35
            and np.abs(jtail[ji, 2:] - ntail[ni, 2:]).max() <= 0.06):
        raise AssertionError(f"velocity estimate: env {jtail[ji]}, oracle "
                             f"{ntail[ni]}, true end {end}")


def _nonzero_cp(cfg, traj, vel):
    """An obstacle crossing the robot's motion line produces a nonzero ego
    collision probability (TTC term with nonzero closing speed,
    `utils.compute_collision_prob:317-323`)."""
    if not max(s.env_ego_cp for s in traj) > 0.0:
        raise AssertionError("ego CP never fired in a head-on moving scene")


def _collision(cfg, traj, vel):
    """Driving straight at a wall terminates both at the same step, as a
    failure."""
    last = traj[-1]
    if not (last.env_done and last.oracle_done and last.env_reward < -100
            and last.oracle_reward < -100):
        raise AssertionError(f"no wall collision: {last.env_reward}, "
                             f"{last.oracle_reward}")


def _strict(cfg, traj, vel):
    """``strict_quirks``: the top-K block (where the lowest-K slice and the
    first-track speed are observable) agrees at several steps, and the
    literal waypoint box fires (+200 on top of the shaping terms)."""
    if not len(traj) > 10:
        raise AssertionError(f"only {len(traj)} steps")
    k = cfg.k_obstacles
    for t in (8, 12, len(traj) - 1):
        d = np.abs(_top_k(traj[t].env_obs, k)
                   - _top_k(traj[t].oracle_obs, k)).max()
        if not d <= 0.08:
            raise AssertionError(f"strict top-K block step {t}: {d}")
    rewards = [s.env_reward for s in traj[1:]]
    if not max(rewards) > 150:
        raise AssertionError(f"the strict waypoint box never fired: "
                             f"{rewards}")


CHECKS = {
    "topk_positions_static_scene": _topk_positions,
    "moving_crowd_scans": _moving_scans,
    "moving_crowd_velocity_estimation": _velocity_estimation,
    "moving_crowd_nonzero_cp": _nonzero_cp,
    "collision_termination": _collision,
    "strict_quirks_trajectory": _strict,
}


def segment_regions(cfg, actions, vel, device="cuda") -> dict:
    """Social-region codes (FRF/FLF/FRC/FLC, the rectangle geometry of
    `utils.get_obstacle_region:146-215`) agree env <-> oracle per confirmed
    segment along the trajectory. The oracle classifies with the crossing
    number over the reference's literal degree-based polygons; the port
    uses the closed-form parallelogram cross products
    (``geom.social_region``) through ``risk.perceive(..., yaw)``."""
    env, nenv, state, _, _ = _env_and_oracle(cfg, device)
    compared = nonzero = steps = 0
    worst = 0.0
    for a in actions:
        prev_tracks = state.tracks
        out = env.step_batch(state, _action(env, a))
        state = out.state
        _, _, ndone = nenv.step(a, ped_vel=vel)
        if bool(out.done[0]) or ndone:
            break
        steps += 1
        # recompute this transition's perception from the post-step pose +
        # pre-step tracks (exactly what the step consumed)
        st = state.replace(tracks=prev_tracks)
        scans, points = crowd_env._sense(cfg, st)
        pout = risk.perceive(cfg, scans, points, prev_tracks, st.pos,
                             st.prev_pos, torch.ones_like(st.done),
                             yaw=st.yaw)
        segs = pout.segments
        mask = (segs.valid & segs.confirmed)[0].cpu().numpy()
        jrows = [(float(x), float(y), bool(o), int(r))
                 for (x, y), o, r, m in zip(
                     segs.center_pos[0].cpu().numpy(),
                     segs.is_obstacle[0].cpu().numpy(),
                     pout.segment_regions[0].cpu().numpy(), mask) if m]
        nrows = [(float(p[0]), float(p[1]), bool(o), int(r))
                 for o, p, r in nenv.last_regions]
        if len(jrows) != len(nrows):
            raise AssertionError(f"segments differ: {jrows} {nrows}")
        # match rows by nearest segment center (scan f32<->f64 tolerance,
        # as _check's), then flags + region must agree exactly
        for jx, jy, jo, jr in jrows:
            d = [abs(jx - nx) + abs(jy - ny) for nx, ny, _, _ in nrows]
            i = int(np.argmin(d))
            worst = max(worst, d[i])
            if not (d[i] < 0.02 and (jo, jr) == nrows[i][2:]):
                raise AssertionError(f"segment rows differ: {jrows} {nrows}")
        compared += len(jrows)
        nonzero += sum(1 for r in jrows if r[3] != 0)
    if not (compared > 10 and nonzero > 0):
        raise AssertionError(f"{compared} segments compared, {nonzero} in "
                             f"the front regions")
    return {"steps": steps, "segments": compared,
            "segments_in_regions": nonzero, "max_center_diff": worst}


def run(name: str, device="cuda") -> dict:
    """Scenario ``name`` on ``device``: raises on any violation; returns
    the steps checked and the largest differences."""
    cfg, actions, vel = inputs(name)
    if name == "segment_regions_static_scene":
        return segment_regions(cfg, actions, vel, device)
    traj = run_pair(cfg, actions, vel, device)
    worst = check(traj)
    if name in CHECKS:
        CHECKS[name](cfg, traj, vel)
    return {"steps": len(traj) - 1, "max_abs": worst,
            "max_ego_cp": max(s.env_ego_cp for s in traj),
            "max_ego_cp_oracle": max(s.oracle_ego_cp for s in traj)}
