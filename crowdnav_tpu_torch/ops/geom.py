"""Closed-form 2D geometry (port of ``crowdnav_tpu/ops/geom.py``).

Elementwise on broadcastable float32 tensors. The arithmetic follows
``utils/numerics.py`` so that results equal the jitted JAX functions.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from crowdnav_tpu_torch.utils import numerics as nm

TWO_PI = 2.0 * math.pi
INF = float("inf")


def wrap_angle(theta):
    """Wrap angle(s) to (-pi, pi]: ``theta - 2pi * round(theta / 2pi)``."""
    r = torch.round(nm.div_const(theta, TWO_PI))
    return nm.fma(-nm.f32(TWO_PI), r, theta)


def heading_to(target_xy, pos_xy, yaw):
    """Heading error from ``yaw`` to the bearing of ``target_xy``."""
    bearing = nm.atan2(target_xy[..., 1] - pos_xy[..., 1],
                       target_xy[..., 0] - pos_xy[..., 0])
    return wrap_angle(bearing - yaw)


def norm(v):
    """Euclidean norm along the last axis, of size 2."""
    return nm.norm2(v[..., 0], v[..., 1])


def vec_norm(v):
    """Norm of each env's whole 2-vector ``v`` (N, 2), as ``jnp.linalg.norm``
    without an axis computes it under vmap."""
    return nm.vec_norm2(v[..., 0], v[..., 1])


def line_circle_min_distance(origin, direction, center, radius):
    """Unsigned distance from ``origin`` to the nearest intersection of the
    unoriented line (``origin``, unit ``direction``) with a circle; +inf on
    a miss. Arguments broadcast over leading axes, last axis of size 2."""
    rx = center[..., 0] - origin[..., 0]
    ry = center[..., 1] - origin[..., 1]
    b = nm.fma(ry, direction[..., 1], rx * direction[..., 0])
    d2 = nm.fma(-b, b, nm.fma(ry, ry, rx * rx))
    disc = nm.f32(radius * radius) - d2
    hit = disc >= 0.0
    sq = nm.sqrt(torch.clamp_min(disc, 0.0))
    dist = torch.minimum(torch.abs(b - sq), torch.abs(b + sq))
    return torch.where(hit, dist, INF)


def waypoint_on_circle(agent_xy, goal_xy, radius):
    """Intersection of the segment agent->goal with the circle of ``radius``
    around the agent; the goal itself once inside the circle."""
    rel = goal_xy - agent_xy
    d = norm(rel)[..., None]
    unit = rel / torch.clamp_min(d, nm.f32(1e-9))
    on_circle = nm.fma(unit, nm.f32(radius), agent_xy)
    return torch.where(d <= nm.f32(radius), goal_xy, on_circle)


def collision_prob_ttc(time_to_collision, valid):
    """``min(1, 0.15 / ttc)``, 0 where ``ttc == 0`` or not ``valid``."""
    ttc = torch.where(time_to_collision == 0.0, INF, time_to_collision)
    cp = torch.clamp_max(nm.rdiv(0.15, ttc), 1.0)
    return torch.where(valid, cp, 0.0)


def collision_prob_distance(dist, max_range, min_range):
    """``(max - d) / (max - min)``, 0 beyond ``max_range`` (not clamped)."""
    gcp = nm.div_const(nm.f32(max_range) - dist,
                       max(nm.f32(max_range - min_range), nm.f32(1e-9)))
    return torch.where(dist > nm.f32(max_range), 0.0, gcp)


def box_iou(a_xy, b_xy, half_size):
    """3-decimal IOU of two axis-aligned squares of half-side
    ``half_size`` centred on ``a_xy`` and ``b_xy``."""
    side = 2.0 * half_size
    dx = torch.abs(a_xy[..., 0] - b_xy[..., 0])
    dy = torch.abs(a_xy[..., 1] - b_xy[..., 1])
    inter = (torch.clamp_min(nm.f32(side) - dx, 0.0)
             * torch.clamp_min(nm.f32(side) - dy, 0.0))
    union = nm.f32(2.0 * side * side) - inter
    return nm.round3(inter / union)


def boxes_associated(a_xy, b_xy, half_size):
    """Box-association predicate, the JAX package's default form: the two
    squares of half-side ``half_size`` overlap."""
    side = nm.f32(2.0 * half_size)
    dx = torch.abs(a_xy[..., 0] - b_xy[..., 0])
    dy = torch.abs(a_xy[..., 1] - b_xy[..., 1])
    return (dx < side) & (dy < side)


def estimate_num_obs_scans(dist, max_range, min_range):
    """Expected lidar returns on a cylinder at ``dist``: 32 at max range
    down to 3 at min range, linear."""
    # jitted XLA folds 29 * (x * (1 / range)) into x * f32(29 / range)
    scale = nm.f32(np.float32(29.0) * np.float32(nm.recip_f32(
        max(nm.f32(max_range - min_range), nm.f32(1e-9)))))
    return 3.0 + torch.floor((nm.f32(max_range) - dist) * scale)
