"""Batched 359-beam lidar raycast (port of ``crowdnav_tpu/ops/lidar.py``
and of the Pallas raycast ``crowdnav_tpu/ops/lidar_pallas.py``).

Beam ``i`` of the observation points at world angle ``yaw - i deg``. The
kernel (``kernels/csrc/raycast.cu``) has the two forms of the JAX package:

- :func:`scan_batch`, the XLA form (``lidar_backend="xla"``): the direction
  of each beam comes from the angle-addition identity against the per-beam
  tables ``cos(i deg)``, ``sin(i deg)``, as ``lidar._beam_trig`` does; its
  plain version is :func:`raycast_plain`;
- :func:`scan_batch_pallas`, the form of the Pallas kernel
  ``lidar_pallas._raycast_kernel`` (``lidar_backend="pallas"``): the C
  library's ``cos``/``sin`` of each beam's angle ``fma(-i, deg, yaw)``; its
  plain version is :func:`raycast_pallas_plain`.

Each wrapper launches the kernel on CUDA tensors and runs its plain
version, the same arithmetic in PyTorch, on CPU tensors.
"""
from __future__ import annotations

import functools
import math

import torch

from crowdnav_tpu_torch.utils import numerics as nm

INF = float("inf")
EPS = nm.f32(1e-12)
DEG = nm.f32(math.pi / 180.0)


@functools.lru_cache(maxsize=8)
def _tables_cpu(n_scans: int):
    a = torch.arange(n_scans, dtype=torch.float32) * nm.f32(math.pi / 180.0)
    return nm.cos(a), nm.sin(a)


@functools.lru_cache(maxsize=None)
def beam_tables(n_scans: int, device="cpu"):
    """``(cos(i deg), sin(i deg))`` for i < ``n_scans``, float32, as the
    JAX package's compiler folds them (the C library's ``cosf``/``sinf``
    of ``f32(i) * f32(pi/180)``); made once per device, so that a step
    copies nothing from the host (a captured step may not). Read only."""
    ca, sa = _tables_cpu(n_scans)
    return ca.to(device), sa.to(device)


def beam_trig(yaw, n_scans: int):
    """Per-beam world-frame direction components ``(dx, dy)``, each
    (N, n_scans), for ``yaw`` (N,)."""
    ca, sa = beam_tables(n_scans, yaw.device)
    cy, sy = nm.cos(yaw)[:, None], nm.sin(yaw)[:, None]
    return nm.fma(cy, ca, sy * sa), nm.fma(sy, ca, -(cy * sa))


def box_inside(px, py, dx, dy, half):
    """Exit distance of each ray from inside the room [-half, half]^2."""
    small_x, small_y = torch.abs(dx) < EPS, torch.abs(dy) < EPS
    fx = torch.where(small_x, EPS, dx)
    fy = torch.where(small_y, EPS, dy)
    h = nm.f32(half)
    tx = (torch.sign(fx) * h - px) / fx
    ty = (torch.sign(fy) * h - py) / fy
    tx = torch.where(small_x, INF, tx)
    ty = torch.where(small_y, INF, ty)
    return torch.minimum(tx, ty)


def circle_hit(px, py, dx, dy, cx, cy, r2):
    """Forward hit distance of each ray on one circle per env (+inf on a
    miss); ``cx``/``cy`` broadcast against the beams, ``r2`` the float32
    squared radius."""
    relx, rely = cx - px, cy - py
    b = nm.fma(relx, dx, rely * dy)
    rel2 = nm.fma(relx, relx, rely * rely)
    disc = r2 - nm.fma(-b, b, rel2)
    t = b - nm.sqrt(torch.clamp_min(disc, 0.0))
    return torch.where((disc >= 0.0) & (t >= 0.0), t, INF)


def _raycast_dirs(pos, dx, dy, peds, half, r2, min_range, max_range):
    px, py = pos[:, 0:1], pos[:, 1:2]
    t = box_inside(px, py, dx, dy, half)
    for p in range(peds.shape[1]):
        t = torch.minimum(t, circle_hit(px, py, dx, dy, peds[:, p, 0:1],
                                        peds[:, p, 1:2], r2))
    return torch.clamp(t, min_range, max_range)


def raycast_plain(pos, cy, sy, ca, sa, peds, half, r2, min_range,
                  max_range):
    """Plain version of the raycast kernel's XLA form: (N, B) clipped
    ranges from ``pos`` (N, 2), ``cos(yaw)``/``sin(yaw)`` (N,), the beam
    tables (B,) and ``peds`` (N, P, 2)."""
    cy, sy = cy[:, None], sy[:, None]
    dx, dy = nm.fma(cy, ca, sy * sa), nm.fma(sy, ca, -(cy * sa))
    return _raycast_dirs(pos, dx, dy, peds, half, r2, min_range, max_range)


def beam_angles(yaw, n_scans: int):
    """(N, n_scans) world angle of each beam, ``yaw - i deg`` as the jitted
    Pallas kernel computes it: ``fma(-i, f32(pi/180), yaw)``."""
    beam = torch.arange(n_scans, dtype=torch.float32, device=yaw.device)
    return nm.fma(-beam[None, :], DEG, yaw[:, None])


def raycast_pallas_plain(pos, yaw, peds, n_beams, half, r2, min_range,
                         max_range):
    """Plain version of the raycast kernel's Pallas form: the C library's
    ``cos``/``sin`` of :func:`beam_angles`, then the walls (the same
    exit distances as ``_raycast_kernel``'s ``1e-12`` guard and ``inf``
    for an axis-parallel ray), the pedestrians in order, the clip."""
    ang = beam_angles(yaw, n_beams)
    return _raycast_dirs(pos, nm.cos(ang), nm.sin(ang), peds, half, r2,
                         min_range, max_range)


def _consts(ped_radius, room_half, max_range, min_range):
    return (nm.f32(room_half), nm.f32(ped_radius * ped_radius),
            nm.f32(min_range), nm.f32(max_range))


def scan_batch(pos, yaw, ped_pos, ped_radius, room_half, max_range,
               min_range, n_scans: int = 359):
    """(N, 2), (N,), (N, P, 2) -> (N, n_scans) observation-order ranges,
    the vmapped ``lidar.scan`` of the JAX package."""
    ca, sa = beam_tables(n_scans, pos.device)
    cy, sy = nm.cos(yaw), nm.sin(yaw)
    args = (pos, cy, sy, ca, sa, ped_pos,
            *_consts(ped_radius, room_half, max_range, min_range))
    if pos.device.type == "cpu":
        return raycast_plain(*args)
    from crowdnav_tpu_torch.kernels import build
    out = build.raycast(*args)
    scan_batch.launches += 1
    return out


scan_batch.launches = 0


def scan_batch_pallas(pos, yaw, ped_pos, ped_radius, room_half, max_range,
                      min_range, n_scans: int = 359):
    """(N, 2), (N,), (N, P, 2) -> (N, n_scans) observation-order ranges,
    ``lidar_pallas.scan_batch_pallas`` of the JAX package."""
    consts = _consts(ped_radius, room_half, max_range, min_range)
    if pos.device.type == "cpu":
        return raycast_pallas_plain(pos, yaw, ped_pos, n_scans, *consts)
    from crowdnav_tpu_torch.kernels import build
    out = build.raycast_pallas(pos, yaw, ped_pos, n_scans, *consts)
    scan_batch_pallas.launches += 1
    return out


scan_batch_pallas.launches = 0


def scan_fn(backend: str):
    """The wrapper of the config's ``lidar_backend``."""
    if backend == "pallas":
        return scan_batch_pallas
    if backend != "xla":
        raise ValueError(f"unknown lidar_backend {backend!r}")
    return scan_batch


def scan_points(pos, yaw, scans, n_scans: int = 359):
    """World-frame endpoint of every beam, rounded to 3 decimals:
    (N, n_scans, 2)."""
    dx, dy = beam_trig(yaw, n_scans)
    return nm.round3(torch.stack([nm.fma(scans, dx, pos[:, 0:1]),
                                  nm.fma(scans, dy, pos[:, 1:2])], -1))
