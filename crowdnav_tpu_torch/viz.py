"""Rendering and the trajectory audit (port of ``crowdnav_tpu/viz.py``).

Host-side views of the env state: ``render_frame`` draws one env (room,
robot, pedestrians, lidar returns, tracks colored by collision
probability with their social-region tags, goal, waypoint),
``render_trajectory`` a path, ``save_gif`` a rollout; ``TrajectoryWriter``
writes the reference's per-step trajectory CSV ``[step, x, y, yaw_deg]``
(``environment_stage_1_original.py:284-286``), and ``trace_rollout``
records one env's rollout for them. Matplotlib is imported lazily, with
the Agg backend, by the functions that draw; the rollout and the CSV need
none of it.

A one-env state is an ``EnvState`` whose fields have no env axis:
``state_at(states, i)`` takes env (or time step) ``i`` of a batch.
"""
from __future__ import annotations

import csv
import math
import os

import numpy as np
import torch

from crowdnav_tpu_torch.ops import geom, lidar


def _mpl():
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    return plt


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def state_at(states, i: int):
    """Row ``i`` of a batched (or time-stacked) ``EnvState``."""
    return states.map(lambda a: a[i])


def cp_color(cp: float):
    """Collision-probability color: green (0) to red (1), the reference's
    HSV ramp (``utils.py:496-500``)."""
    import colorsys
    cp = float(min(max(cp, 0.0), 1.0))
    return colorsys.hsv_to_rgb((1.0 - cp) * (1.0 / 3.0), 0.9, 0.9)


def render_frame(cfg, state, scans=None, cp=None, ax=None, title=None):
    """Draw a one-env state; returns the matplotlib Axes. ``scans``:
    (n_scans,) ranges whose hit returns are drawn; ``cp``: (max_tracks,)
    collision probabilities for the tracks' colors (gray without)."""
    plt = _mpl()
    state = state.map(lambda a: torch.as_tensor(a).detach().cpu())
    if ax is None:
        _, ax = plt.subplots(figsize=(6, 6))
    half = cfg.room_half_inner
    ax.add_patch(plt.Rectangle((-half, -half), 2 * half, 2 * half,
                               fill=False, edgecolor="black", linewidth=2))
    gx, gy = cfg.goal
    e = cfg.goal_eps
    ax.add_patch(plt.Rectangle((gx - e, gy - e), 2 * e, 2 * e,
                               facecolor="#2ca02c", alpha=0.35,
                               edgecolor="#2ca02c", label="goal"))
    wx, wy = _np(state.waypoint)
    ax.plot([wx], [wy], marker="x", color="#1f77b4", markersize=10,
            markeredgewidth=2.5, linestyle="none", label="waypoint")
    for px, py in np.atleast_2d(_np(state.ped_pos))[: cfg.n_peds]:
        ax.add_patch(plt.Circle((px, py), cfg.ped_radius,
                                facecolor="#bbbbbb", edgecolor="#777777"))
    if scans is not None:
        sc = torch.as_tensor(_np(scans), dtype=torch.float32)
        pts = _np(lidar.scan_points(state.pos[None], state.yaw[None],
                                    sc[None], cfg.n_scans)[0])
        hit = _np(sc) < cfg.max_scan_range
        ax.plot(pts[hit, 0], pts[hit, 1], ".", color="#ff7f0e",
                markersize=2, linestyle="none", label="lidar")
    valid = _np(state.tracks.valid)
    tpos = _np(state.tracks.pos)
    tvel = _np(state.tracks.vel)
    for i in range(valid.shape[0]):
        if not valid[i]:
            continue
        c = cp_color(cp[i]) if cp is not None else (0.5, 0.5, 0.5)
        ax.add_patch(plt.Circle(tuple(tpos[i]), 0.0505, fill=False,
                                edgecolor=c, linewidth=2))
        # the stored track velocity is (prev - curr) / dt
        vx, vy = -tvel[i]
        if abs(vx) + abs(vy) > 1e-6:
            ax.arrow(tpos[i, 0], tpos[i, 1], vx * 0.3, vy * 0.3,
                     head_width=0.03, color=c, length_includes_head=True)
        if cp is not None:
            ax.text(tpos[i, 0] + 0.06, tpos[i, 1] + 0.06,
                    f"CP={float(cp[i]):.2f}", fontsize=7, color=c)
        rel = tpos[i] - _np(state.pos)
        region = int(geom.social_region(
            state.pos, state.yaw, torch.as_tensor(tpos[i]),
            torch.tensor(np.linalg.norm(rel), dtype=torch.float32)))
        tag = ("", "FRF", "FLF", "FRC", "FLC")[region]
        if tag:
            ax.text(tpos[i, 0] + 0.06, tpos[i, 1] - 0.06, tag,
                    fontsize=6, color="#555555")
    x, y = _np(state.pos)
    yaw = float(state.yaw)
    ax.add_patch(plt.Circle((x, y), cfg.robot_radius, facecolor="#1f77b4",
                            alpha=0.8, edgecolor="black", label="robot"))
    ax.arrow(x, y, 0.18 * math.cos(yaw), 0.18 * math.sin(yaw),
             head_width=0.05, color="black", length_includes_head=True)
    m = half + 0.2
    ax.set_xlim(-m, m)
    ax.set_ylim(-m, m)
    ax.set_aspect("equal")
    ax.set_title(title or f"step {int(state.step)}")
    return ax


def render_trajectory(cfg, traj, ax=None, title=None, label=None):
    """Path plot of a (T, >= 2) array of ``[x, y(, yaw...)]`` rows."""
    plt = _mpl()
    traj = _np(traj)
    if ax is None:
        _, ax = plt.subplots(figsize=(6, 6))
        half = cfg.room_half_inner
        ax.add_patch(plt.Rectangle((-half, -half), 2 * half, 2 * half,
                                   fill=False, edgecolor="black",
                                   linewidth=2))
        gx, gy = cfg.goal
        e = cfg.goal_eps
        ax.add_patch(plt.Rectangle((gx - e, gy - e), 2 * e, 2 * e,
                                   facecolor="#2ca02c", alpha=0.35))
        m = half + 0.2
        ax.set_xlim(-m, m)
        ax.set_ylim(-m, m)
        ax.set_aspect("equal")
    ax.plot(traj[:, 0], traj[:, 1], "-", linewidth=1.5, label=label)
    ax.plot(traj[0, 0], traj[0, 1], "o", color="black", markersize=5)
    if title:
        ax.set_title(title)
    if label:
        ax.legend(loc="upper right", fontsize=8)
    return ax


def save_figure(ax, path: str):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    ax.figure.savefig(path, dpi=110, bbox_inches="tight")
    _mpl().close(ax.figure)


def save_gif(cfg, states, scans_seq, path: str, every: int = 1,
             fps: int = 8):
    """Animate a rollout: ``states`` an ``EnvState`` stacked over time
    (leading axis T), ``scans_seq`` (T, n_scans); a GIF through
    Pillow."""
    from matplotlib.animation import PillowWriter

    plt = _mpl()
    fig, ax = plt.subplots(figsize=(6, 6))
    writer = PillowWriter(fps=fps)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    scans_seq = _np(scans_seq)
    with writer.saving(fig, path, dpi=80):
        for t in range(0, scans_seq.shape[0], every):
            ax.clear()
            render_frame(cfg, state_at(states, t), scans=scans_seq[t],
                         ax=ax)
            writer.grab_frame()
    plt.close(fig)


class TrajectoryWriter:
    """Per-step trajectory CSV in the reference's schema ``[step, x, y,
    yaw_degrees]`` (``utils.record_data:53-64``: no header row)."""

    def __init__(self, outdir: str, filename: str):
        os.makedirs(outdir, exist_ok=True)
        self.path = os.path.join(outdir, filename + ".csv")

    def record(self, step: int, x: float, y: float, yaw_rad: float):
        with open(self.path, "a", newline="") as fp:
            csv.writer(fp).writerow(
                [step, round(float(x), 4), round(float(y), 4),
                 round(math.degrees(float(yaw_rad)), 3)])

    def record_rollout(self, traj):
        """``traj``: (T, 3) ``[x, y, yaw]``; the steps are the rows'
        indices."""
        traj = _np(traj)
        with open(self.path, "a", newline="") as fp:
            w = csv.writer(fp)
            for t, row in enumerate(traj):
                w.writerow([t, round(float(row[0]), 4),
                            round(float(row[1]), 4),
                            round(math.degrees(float(row[2])), 3)])


def trace_rollout(env, policy_fn, seed, n_steps: int,
                  discrete: bool = False):
    """One env's rollout of ``n_steps`` with every state recorded, a
    Python loop over the env's batched step at a batch of one: returns
    ``(states (T, ...), scans (T, n_scans), traj (T, 3) of [x, y, yaw],
    rewards (T,), dones (T,))``, each row the state after that step (the
    JAX ``trace_rollout``). ``policy_fn(obs (1, obs_dim)) -> actions``;
    ``seed``: an int or the ``torch.Generator`` of the env's draws;
    ``discrete``: index actions through ``step_discrete``."""
    gen = seed if isinstance(seed, torch.Generator) else \
        torch.Generator(device=env.device).manual_seed(seed)
    state, obs = env.reset(1, gen)
    step = env.step_discrete if discrete else env.step_batch
    n_scans = env.cfg.n_scans
    states, scans, traj, rewards, dones = [], [], [], [], []
    for _ in range(n_steps):
        out = step(state, policy_fn(obs), gen=gen)
        state, obs = out.state, out.obs
        states.append(state)
        scans.append(obs[:, :n_scans])
        traj.append(torch.cat([state.pos, state.yaw[:, None]], -1))
        rewards.append(out.reward)
        dones.append(out.done)
    stacked = states[0].map(lambda *xs: torch.cat(xs), *states[1:])
    return (stacked, torch.cat(scans), torch.cat(traj), torch.cat(rewards),
            torch.cat(dones))
