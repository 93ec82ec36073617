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


def rounded_overlap(dx, dy, side):
    """``round(IOU, 3) > 0`` of two squares of side ``side`` whose centres
    are ``(dx, dy)`` apart, in the division-free form
    ``inter * 1.0005 > 1e-3 * side^2`` (the reference's literal
    association, ``strict_quirks``)."""
    s = nm.f32(side)
    inter = (torch.clamp_min(s - torch.abs(dx), 0.0)
             * torch.clamp_min(s - torch.abs(dy), 0.0))
    return inter * nm.f32(1.0005) > nm.f32(1e-3 * side * side)


def boxes_associated(a_xy, b_xy, half_size, rounded: bool = False):
    """Box-association predicate: the two squares of half-side
    ``half_size`` overlap (the JAX package's default form), or with
    ``rounded`` their 3-decimal IOU is positive (:func:`rounded_overlap`)."""
    dx = a_xy[..., 0] - b_xy[..., 0]
    dy = a_xy[..., 1] - b_xy[..., 1]
    if rounded:
        return rounded_overlap(dx, dy, 2.0 * half_size)
    side = nm.f32(2.0 * half_size)
    return (torch.abs(dx) < side) & (torch.abs(dy) < side)


def _in_parallelogram(px, py, quad):
    """Strict point-in-convex-quad: every edge cross product has one sign
    (the boundary excluded, shapely's ``Polygon.contains``)."""
    def cross(a, b):
        (x1, y1), (x2, y2) = a, b
        return nm.fma(x2 - x1, py - y1, -((y2 - y1) * (px - x1)))

    cs = [cross(quad[i], quad[(i + 1) % 4]) for i in range(4)]
    pos = (cs[0] > 0) & (cs[1] > 0) & (cs[2] > 0) & (cs[3] > 0)
    neg = (cs[0] < 0) & (cs[1] < 0) & (cs[2] < 0) & (cs[3] < 0)
    return pos | neg


def social_region(robot_xy, yaw, pts_xy, scans):
    """Social-region code of each point (``geom.social_region`` of the JAX
    package, the rectangle geometry of ``utils.get_obstacle_region``):
    0 other, 1 front-right far, 2 front-left far, 3 front-right close,
    4 front-left close. ``robot_xy`` (..., 2) and ``yaw`` (...) broadcast
    against ``pts_xy`` (..., 2) and ``scans`` (...)."""
    heading = torch.abs(yaw * nm.f32(180.0 / math.pi) - 180.0)
    hr = heading * nm.f32(math.pi / 180.0)
    rx, ry = robot_xy[..., 0], robot_xy[..., 1]
    fx = nm.fma(nm.f32(-0.6), nm.cos(hr), rx)
    fy = nm.fma(nm.f32(0.6), nm.sin(hr), ry)
    q = hr + nm.f32(math.pi / 2.0)
    ox = nm.f32(-0.16) * nm.cos(q)
    oy = nm.f32(0.16) * nm.sin(q)
    px, py = pts_xy[..., 0], pts_xy[..., 1]
    in_fr = _in_parallelogram(px, py, ((rx + ox, ry + oy),
                                       (fx + ox, fy + oy), (fx, fy),
                                       (rx, ry)))
    in_fl = _in_parallelogram(px, py, ((rx, ry), (fx, fy),
                                       (fx - ox, fy - oy),
                                       (rx - ox, ry - oy)))
    far = (scans > nm.f32(0.3)) & (scans < nm.f32(0.6))
    close = scans < nm.f32(0.3)
    code = torch.zeros(px.shape, dtype=torch.int32, device=px.device)
    code = torch.where(far & in_fr, 1, code)
    code = torch.where(far & in_fl, 2, code)
    code = torch.where(close & in_fr, 3, code)
    code = torch.where(close & in_fl, 4, code)
    return code.to(torch.int32)


def estimate_num_obs_scans(dist, max_range, min_range):
    """Expected lidar returns on a cylinder at ``dist``: 32 at max range
    down to 3 at min range, linear."""
    # jitted XLA folds 29 * (x * (1 / range)) into x * f32(29 / range)
    scale = nm.f32(np.float32(29.0) * np.float32(nm.recip_f32(
        max(nm.f32(max_range - min_range), nm.f32(1e-9)))))
    return 3.0 + torch.floor((nm.f32(max_range) - dist) * scale)
