"""The work of each kernel call, and the least time an H100 could take
for it.

``*_work`` return ``(bytes, ops)``: the bytes the function must move (each
input read once, each output written once) and the float32 operations it
does on these inputs (a multiply-add counts two). The bound is the larger
of bytes over the card's memory rate and operations over its float32 peak
outside the tensor cores (NVIDIA's H100 SXM data sheet, at 700 W).
"""
from __future__ import annotations

import torch

from crowdnav_tpu_torch.utils import numerics as nm

H100_BYTES_PER_S = 3.35e12
H100_F32_FLOPS = 67e12
H100_F64_FLOPS = 34e12   # float64 outside the tensor cores

# the C library's sinf/cosf in double (``csrc/libm_f32.cuh``): the
# fast reduction (3), the polynomial (8) and the conversions (2);
# atan2f in float: the reduction's division and the 11-term polynomial
# in two halves (about 30)
LIBM_SINCOS_F64_OPS = 13
LIBM_ATAN2_F32_OPS = 30
# sinf and cosf of one argument together (``libmf_sinf_cosf``): one
# reduction and argument conversion (4) for both polynomials
LIBM_SINCOS_PAIR_F64_OPS = 2 * LIBM_SINCOS_F64_OPS - 4

# raycast operations: per beam, the direction (two products, two
# multiply-adds: 6), the walls (two differences, two divisions, the
# minimum: 5), the two epsilon selects (2) and the range clip (2); per
# beam and pedestrian, b = relx*dx + rely*dy (3) and b*b subtracted from
# rel2 (2); per hit (disc >= 0), disc, its square root and b - root; per
# env and pedestrian, relx, rely (2) and rel2 (3), and since the cull by
# reach (``csrc/raycast.cu``) the test of rel2 against the reach (1), the
# pair and hit terms then taken over the pedestrians in reach only
RAYCAST_OPS_PER_BEAM = 15
RAYCAST_OPS_PER_PAIR = 5
RAYCAST_OPS_PER_HIT = 3
RAYCAST_OPS_PER_ENV_PED = 5
RAYCAST_OPS_PER_REACH_TEST = 1


def bound_ms(nbytes: float, ops: float, flops: float = H100_F32_FLOPS):
    """``(ms, "bytes" or "operations")``: the least time and what sets
    it, for ``ops`` at the rate ``flops``."""
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = ops / flops
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _raycast_ped_ops(n: int, b: int, p: int, hits: int, in_reach):
    """The operations per pedestrian: every pair test when ``in_reach`` is
    None (the count before the cull), else the reach test of every (env,
    pedestrian) and the pair tests of the ``in_reach`` pedestrians."""
    pairs, tests = (n * p, 0) if in_reach is None else (in_reach, n * p)
    return (b * pairs * RAYCAST_OPS_PER_PAIR + RAYCAST_OPS_PER_HIT * hits
            + RAYCAST_OPS_PER_ENV_PED * n * p
            + RAYCAST_OPS_PER_REACH_TEST * tests)


def raycast_work(n: int, b: int, p: int, hits: int, in_reach=None):
    """Raycast of ``n`` envs x ``b`` beams against ``p`` pedestrians, of
    which ``hits`` (beam, pedestrian) pairs meet the circle's line; with
    ``in_reach`` (:func:`raycast_in_reach`), the work of the cull by
    reach: the pair tests of those (env, pedestrian) pairs only, and
    ``hits`` counted over them (``reach2`` of :func:`raycast_hits`)."""
    nbytes = 4 * (2 * n + 2 * n + 2 * b + 2 * n * p + n * b)
    ops = (n * b * RAYCAST_OPS_PER_BEAM
           + _raycast_ped_ops(n, b, p, hits, in_reach))
    return nbytes, ops


def raycast_pallas_work(n: int, b: int, p: int, hits: int, in_reach=None):
    """The raycast's Pallas form: ``(bytes, float32 ops, float64 ops)``.
    It reads the yaw in place of its trig and the beam tables, and per
    beam computes the angle (a multiply-add) and the C library's cos and
    sin of it (float64) in place of the angle addition; ``hits`` and
    ``in_reach`` as :func:`raycast_work`."""
    nbytes = 4 * (2 * n + n + 2 * n * p + n * b)
    ops = (n * b * (RAYCAST_OPS_PER_BEAM - 6 + 2)
           + _raycast_ped_ops(n, b, p, hits, in_reach))
    return nbytes, ops, n * b * LIBM_SINCOS_PAIR_F64_OPS


def mixed_bound_ms(nbytes: float, ops32: float, ops64: float):
    """:func:`bound_ms` of work with float32 and float64 operations,
    which run on separate pipes: the largest of the three times."""
    t = {"bytes": nbytes / H100_BYTES_PER_S,
         "operations": max(ops32 / H100_F32_FLOPS, ops64 / H100_F64_FLOPS)}
    by = max(t, key=t.get)
    return t[by] * 1e3, by


def _rel(pos, peds):
    """relx, rely (N, P) and rel2 as the kernel computes them."""
    relx = peds[..., 0] - pos[:, 0:1]
    rely = peds[..., 1] - pos[:, 1:2]
    return relx, rely, nm.fma(relx, relx, rely * rely)


def raycast_in_reach(pos, peds, reach2) -> int:
    """The (env, pedestrian) pairs the cull by reach keeps: rel2 not above
    ``reach2`` (``kernels.launch.raycast_reach2``; a NaN is kept)."""
    return int(torch.count_nonzero(~(_rel(pos, peds)[2] > reach2)))


def raycast_dir_hits(pos, dx, dy, peds, r2, reach2=None) -> int:
    """The (beam, pedestrian) pairs whose discriminant is >= 0 for the
    beam directions ``dx``, ``dy`` (N, B), computed as the kernel computes
    it (``ops.lidar.circle_hit``); with ``reach2``, those of the
    pedestrians in reach only (:func:`raycast_in_reach`)."""
    relx, rely, rel2 = _rel(pos, peds)
    hits = 0
    for k in range(peds.shape[1]):
        bb = nm.fma(relx[:, k:k + 1], dx, rely[:, k:k + 1] * dy)
        disc = r2 - nm.fma(-bb, bb, rel2[:, k:k + 1])
        if reach2 is not None:
            disc = torch.where(rel2[:, k:k + 1] > reach2, -1.0, disc)
        hits += int(torch.count_nonzero(disc >= 0.0))
    return hits


def raycast_hits(pos, cy, sy, ca, sa, peds, r2, reach2=None) -> int:
    """:func:`raycast_dir_hits` of the XLA form; arguments as
    ``ops.lidar.raycast_plain``."""
    dx = nm.fma(cy[:, None], ca, sy[:, None] * sa)
    dy = nm.fma(sy[:, None], ca, -(cy[:, None] * sa))
    return raycast_dir_hits(pos, dx, dy, peds, r2, reach2)


def raycast_pallas_hits(pos, yaw, peds, n_beams, r2, reach2=None) -> int:
    """:func:`raycast_dir_hits` of the Pallas form; arguments as
    ``ops.lidar.raycast_pallas_plain``."""
    from crowdnav_tpu_torch.ops.lidar import beam_angles
    ang = beam_angles(yaw, n_beams)
    return raycast_dir_hits(pos, nm.cos(ang), nm.sin(ang), peds, r2, reach2)


def track_cp_topk_fields(S: int, T: int, K: int):
    """``(inputs, outputs)``: (name, bytes per env) of the tracker kernel's
    13 input and 11 output tensors, in the order of its arguments."""
    inputs = (("confirmed", S), ("is_obstacle", S), ("center_pos", 8 * S),
              ("center_dist", 4 * S), ("tracks.valid", T),
              ("tracks.pos", 8 * T), ("tracks.prev_pos", 8 * T),
              ("tracks.dist", 4 * T), ("tracks.speed", 4 * T),
              ("tracks.vel", 8 * T), ("robot_pos", 8),
              ("robot_prev_pos", 8), ("compute_cp", 1))
    outputs = (("valid", T), ("pos", 8 * T), ("prev_pos", 8 * T),
               ("has_prev", T), ("dist", 4 * T), ("speed", 4 * T),
               ("vel", 8 * T), ("top_cp", 4 * K), ("top_pose_vel", 16 * K),
               ("cp_max", 4), ("ego_cp", 4))
    return inputs, outputs


def track_cp_topk_work(n: int, S: int, T: int, K: int, form: str = "xla"):
    """Tracker -> CP -> top-K of ``n`` envs with ``S`` segments, ``T``
    tracks and top ``K``: per env the T x S box IOUs (12 operations each),
    the track update and CP (60 per track) and the top-K rank (3 per pair
    of tracks; the strict form's reorder 3 more). The forms move the same
    bytes."""
    inputs, outputs = track_cp_topk_fields(S, T, K)
    nbytes = n * sum(row for _, row in inputs + outputs)
    ops = n * (T * S * 12 + T * 60 + T * T * (6 if form == "strict" else 3))
    return nbytes, ops


def libm_work(n: int, n_inputs: int):
    """``(bytes, ops, rate)`` of the C-library trig kernel on ``n``
    floats: ``cos``/``sin`` (one input, float64 arithmetic) or ``atan2``
    (two inputs, float32)."""
    nbytes = 4 * n * (n_inputs + 1)
    if n_inputs == 1:
        return nbytes, n * LIBM_SINCOS_F64_OPS, H100_F64_FLOPS
    return nbytes, n * LIBM_ATAN2_F32_OPS, H100_F32_FLOPS
