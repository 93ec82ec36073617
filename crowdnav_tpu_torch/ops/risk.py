"""Perceived-risk pipeline, batched (port of ``crowdnav_tpu/ops/risk.py``).

Segmentation of the beam ring, the slot tracker, collision-cone CP and the
top-K selection, on tensors with a leading env axis N. The JAX package
uses one-hot reductions and matmuls in place of gathers (a TPU
workaround); here they are plain gathers, which pick the same values.
The tracker -> CP -> top-K chain of this module is the plain version of the
CUDA kernel wrapped by ``ops/risk_kernel.py``, in each of the kernel's
three forms (:data:`FORMS`): ``"xla"``, the JAX package's XLA chain
``update_tracks -> collision_probabilities -> select_top_k`` under the
default quirks; ``"strict"``, the same chain under ``strict_quirks`` (the
first track's closing speed for every track, and the reference's
``sorted(desc)[-K:]`` top-K); ``"pallas"``, the arithmetic of the Pallas
kernel ``crowdnav_tpu/ops/risk_pallas._kernel`` as the JAX package's CPU
reference runs it (interpret mode, jitted), which sums and fuses some
products in another order than the XLA chain.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from crowdnav_tpu_torch.envs.config import EnvConfig
from crowdnav_tpu_torch.envs.world import TrackState
from crowdnav_tpu_torch.ops import geom
from crowdnav_tpu_torch.utils import numerics as nm

INF = float("inf")
FORMS = ("xla", "strict", "pallas")


def chain_form(cfg: EnvConfig) -> str:
    """The form of the tracker -> CP -> top-K chain that ``cfg`` runs:
    ``"pallas"`` under ``risk_backend="pallas"``, ``"strict"`` under
    ``strict_quirks``, else ``"xla"``. The Pallas form implements the
    default quirks only, as in the JAX package."""
    if cfg.risk_backend == "pallas":
        if cfg.strict_quirks:
            raise ValueError("risk_backend='pallas' implements the default "
                             "quirks policy only; strict_quirks requires "
                             "the xla backend")
        return "pallas"
    if cfg.risk_backend != "xla":
        raise ValueError(f"unknown risk_backend {cfg.risk_backend!r}")
    return "strict" if cfg.strict_quirks else "xla"


class Segments(NamedTuple):
    """Per-segment aggregates, (N, S) slots."""

    valid: torch.Tensor        # (N, S) bool
    is_obstacle: torch.Tensor  # (N, S) bool
    confirmed: torch.Tensor    # (N, S) bool
    center_pos: torch.Tensor   # (N, S, 2)
    center_dist: torch.Tensor  # (N, S)
    count: torch.Tensor        # (N, S) int32


class RiskOutput(NamedTuple):
    tracks: TrackState
    top_k_pose_vel: torch.Tensor  # (N, K, 4)
    top_k_cp: torch.Tensor        # (N, K)
    cp_max: torch.Tensor          # (N,)
    ego_cp: torch.Tensor          # (N,)
    obstacle_seen: torch.Tensor   # (N,) bool
    ego_violation: torch.Tensor   # (N,) bool
    segments: Segments
    segment_regions: Optional[torch.Tensor] = None


def ground_truth_bbox_size(cfg: EnvConfig) -> float:
    """Association box half-size: the mean gap between consecutive
    free-space scan endpoints (static given the config)."""
    n = cfg.n_scans
    step_gap = 2.0 * cfg.max_scan_range * math.sin(math.pi / 360.0)
    ang = math.radians(n - 1)
    wrap_gap = cfg.max_scan_range * math.sqrt(
        (math.cos(ang) - 1.0) ** 2 + math.sin(ang) ** 2)
    return ((n - 1) * step_gap + wrap_gap) / n


def _take(v, idx):
    """``v[n, idx[n, j]]`` along axis 1; ``v`` (N, X) or (N, X, C)."""
    if v.dim() == 3:
        return torch.gather(v, 1, idx[..., None].expand(-1, -1, v.shape[2]))
    return torch.gather(v, 1, idx)


def segment_scans(cfg: EnvConfig, scans, points) -> Segments:
    """Stages 1-4: label beams, group them into runs, confirm segment
    types. ``scans`` (N, n) rounded ranges, ``points`` (N, n, 2)."""
    N, n = scans.shape
    S = cfg.max_segments
    dev = scans.device
    occupied = ~(scans >= nm.f32(cfg.max_scan_range))

    def nxt(a):
        return torch.roll(a, -1, dims=1)

    def prv(a):
        return torch.roll(a, 1, dims=1)

    px, py = points[..., 0], points[..., 1]
    # The jitted step never materializes the rounded points it differences:
    # XLA computes ``round3(p) - next`` as fma(rint(p * 1000), 0.001, -next),
    # which is not 0 where two points coincide. rint(p * 1000) is exact.
    milli = nm.f32(0.001)
    dx = nm.fma(torch.round(px * 1000.0), milli, -nxt(px))
    dy = nm.fma(torch.round(py * 1000.0), milli, -nxt(py))

    # 1. gradients and change of gradient
    dy0 = dy == 0.0
    grad = torch.where(dy0, 0.0, dx / torch.where(dy0, 1.0, dy))
    grad = nm.round_dec(grad, cfg.grad_round_decimals)
    change = nm.round_dec(torch.abs(grad - nxt(grad)),
                          cfg.grad_round_decimals)
    change_valid = occupied & nxt(occupied)

    # 2. wall vs obstacle point labels
    wall_pt = change_valid & ((change == 0.0)
                              | (nxt(change_valid) & (nxt(change) == 0.0)))
    obs_pt = change_valid & ~wall_pt

    # 3. runs by bounding-box association of consecutive beams
    bbox = ground_truth_bbox_size(cfg)
    if cfg.strict_quirks:
        # the reference's literal rounded-IOU association
        assoc_next = geom.rounded_overlap(dx, dy, 2.0 * bbox)
    else:
        side = nm.f32(2.0 * bbox)
        assoc_next = (torch.abs(dx) < side) & (torch.abs(dy) < side)
    start = occupied & (~prv(occupied) | ~prv(assoc_next))
    start[:, 0] = occupied[:, 0]
    run_id_raw = torch.cumsum(start.to(torch.int32), dim=1,
                              dtype=torch.int32) - 1
    run_id = torch.where(occupied, torch.clamp_max(run_id_raw, S), S)
    n_runs = torch.where(occupied, run_id_raw + 1, 0).amax(dim=1)

    rid = run_id.long()

    def _count(m):
        out = torch.zeros((N, S + 1), dtype=torch.int32, device=dev)
        out.scatter_add_(1, rid, m.to(torch.int32))
        return out[:, :S]

    seg_count = _count(occupied)
    seg_count_o = _count(obs_pt)
    seg_count_w = _count(wall_pt)
    idx = torch.arange(n, dtype=torch.int32, device=dev).expand(N, n)
    seg_start = torch.full((N, S + 1), n, dtype=torch.int32, device=dev)
    seg_start.scatter_reduce_(1, rid, torch.where(occupied, idx, n),
                              reduce="amin")
    seg_start = seg_start[:, :S]
    seg_valid = seg_count > 0

    # wrap merge of the first and the last run
    last_id = torch.clamp_min(n_runs - 1, 0)
    last_c = torch.clamp_max(last_id, S - 1).long()[:, None]
    do_merge = (seg_valid[:, 0] & (n_runs > 1) & (last_id < S)
                & occupied[:, 0] & occupied[:, n - 1]
                & (run_id[:, n - 1] == last_id)
                & geom.boxes_associated(points[:, 0], points[:, n - 1],
                                        bbox * 2.0,
                                        rounded=cfg.strict_quirks))
    sl = torch.arange(S, device=dev)[None, :]
    dm = do_merge[:, None]
    first = sl == 0
    merged_into_0 = dm & (sl == last_id[:, None])

    def _merge(c):
        c0 = c[:, :1] + torch.where(dm, torch.gather(c, 1, last_c), 0)
        return torch.where(first, c0, torch.where(merged_into_0, 0, c))

    count0_pre_merge = seg_count[:, :1]
    seg_count = _merge(seg_count)
    seg_count_o = _merge(seg_count_o)
    seg_count_w = _merge(seg_count_w)
    seg_valid = seg_count > 0

    # centre element of each (merged) run
    center_rank = torch.div(seg_count, 2, rounding_mode="floor")
    count_first = torch.where(first & dm, count0_pre_merge, seg_count)
    in_first = center_rank < count_first
    start_last = torch.gather(seg_start, 1, last_c)
    center_beam = torch.where(in_first, seg_start + center_rank,
                              start_last + (center_rank - count_first))
    center_beam = torch.clamp(center_beam, 0, n - 1).long()
    center_dist = torch.gather(scans, 1, center_beam)
    center_pos = _take(points, center_beam)

    # 4. type confirmation
    n_valid = seg_valid.sum(dim=1, dtype=torch.int32)[:, None]
    est = geom.estimate_num_obs_scans(center_dist, cfg.max_scan_range,
                                      cfg.min_scan_range)
    count_f = seg_count.to(torch.float32)
    big_enough = seg_count >= cfg.min_segment_scans
    mixed = (seg_count_o > 0) & (seg_count_w > 0)
    majority_o = seg_count_o > seg_count_w
    score = seg_count_o.to(torch.float32) / torch.clamp_min(
        torch.minimum(count_f, est), 1.0)
    mixed_type_o = torch.where(score >= 0.5, majority_o,
                               (count_f <= est) & majority_o)
    ident_keep = count_f > torch.minimum(n_valid.to(torch.float32), est)
    confirmed = seg_valid & big_enough & (mixed | ident_keep)
    is_obstacle = torch.where(mixed, mixed_type_o, seg_count_w == 0)
    return Segments(valid=seg_valid, is_obstacle=is_obstacle & confirmed,
                    confirmed=confirmed, center_pos=center_pos,
                    center_dist=center_dist, count=seg_count)


def update_tracks(cfg: EnvConfig, tracks: TrackState, segs: Segments,
                  form: str = "xla") -> TrackState:
    """Stages 5-6: IOU matching of live tracks to confirmed segments
    (first-index argmax), update, removal, and insertion of unclaimed
    obstacle segments into free slots by rank. The Pallas form sums the
    squares of the track's motion the other way round."""
    N, S = segs.confirmed.shape
    dev = tracks.valid.device
    iou = geom.box_iou(tracks.pos[:, :, None, :],
                       segs.center_pos[:, None, :, :], cfg.ped_radius)
    iou = torch.where(segs.confirmed[:, None, :], iou, -1.0)
    best_iou = iou.amax(dim=2)
    best_j = iou.argmax(dim=2)          # first index of the maximum
    matched = tracks.valid & (best_iou > 0.0)
    new_pos = _take(segs.center_pos, best_j)
    new_dist = torch.gather(segs.center_dist, 1, best_j)
    delta = tracks.pos - new_pos                        # prev - curr
    if form == "pallas":
        speed = nm.div_const(
            nm.sqrt(nm.fma(delta[..., 0], delta[..., 0],
                           delta[..., 1] * delta[..., 1])), cfg.dt)
    else:
        speed = nm.div_const(geom.norm(delta), cfg.dt)
    m2 = matched[..., None]
    u_pos = torch.where(m2, new_pos, tracks.pos)
    u_prev = torch.where(m2, tracks.pos, tracks.prev_pos)
    u_dist = torch.where(matched, new_dist, tracks.dist)
    u_speed = torch.where(matched, speed, tracks.speed)
    u_vel = torch.where(m2, nm.div_const(delta, cfg.dt), tracks.vel)

    # insertion: the r-th free slot takes the r-th unclaimed obstacle
    claimed = torch.zeros((N, S + 1), dtype=torch.int32, device=dev)
    claimed.scatter_add_(1, torch.where(matched, best_j, S),
                         matched.to(torch.int32))
    insert = segs.is_obstacle & (claimed[:, :S] == 0)
    free = ~matched
    free_rank = torch.cumsum(free.to(torch.int32), 1) - 1
    n_insert = insert.sum(dim=1, keepdim=True)
    sl = torch.arange(S, device=dev)
    order = torch.argsort(torch.where(insert, sl, S + sl), dim=1)
    inserted = free & (free_rank < n_insert)
    src = torch.gather(order, 1, torch.clamp(free_rank, 0, S - 1).long())
    ins_pos = _take(segs.center_pos, src)
    ins_dist = torch.gather(segs.center_dist, 1, src)
    i2 = inserted[..., None]
    return TrackState(
        valid=matched | inserted,
        pos=torch.where(i2, ins_pos, u_pos),
        prev_pos=torch.where(i2, ins_pos, u_prev),
        has_prev=matched & ~inserted,
        dist=torch.where(inserted, ins_dist, u_dist),
        # fresh tracks carry the reference's -1 speed sentinel
        speed=torch.where(inserted, -1.0, u_speed),
        vel=torch.where(i2, 0.0, u_vel))


def collision_probabilities(cfg: EnvConfig, tracks: TrackState,
                            robot_pos, robot_prev_pos, form: str = "xla"):
    """Stage 7: collision-cone TTC -> CP per track. Returns (cp, ego),
    each (N, T). ``"strict"``: every track's closing speed is the first
    valid track's. ``"pallas"``: the kernel's order of the sums and the
    unit vector as a product with ``1 / max(norm, 1e-9)``. In both, the
    jitted reference fuses the robot's speed into the resultant,
    ``fma(|motion|, 1/dt, -speed)``."""
    mx, my = (robot_pos - robot_prev_pos).unbind(-1)
    vo_shift = (tracks.prev_pos - tracks.pos) * tracks.has_prev[..., None]
    rel = (robot_pos[:, None, :] + vo_shift) - robot_prev_pos[:, None, :]
    if form == "pallas":
        speed_raw = nm.sqrt(nm.fma(mx, mx, my * my))
        rx, ry = rel[..., 0], rel[..., 1]
        inv = nm.rdiv(1.0, torch.clamp_min(nm.sqrt(nm.fma(rx, rx, ry * ry)),
                                           nm.f32(1e-9)))
        ux, uy = rx * inv, ry * inv
        cx = tracks.pos[..., 0] - robot_prev_pos[:, None, 0]
        cy = tracks.pos[..., 1] - robot_prev_pos[:, None, 1]
        b = nm.fma(cx, ux, cy * uy)
        disc = nm.f32(cfg.collision_body_width ** 2) \
            - nm.fma(-b, b, nm.fma(cx, cx, cy * cy))
        sq = nm.sqrt(torch.clamp_min(disc, 0.0))
        dist_cp = torch.where(
            disc >= 0.0, torch.minimum(torch.abs(b - sq), torch.abs(b + sq)),
            INF)
    else:
        speed_raw = nm.norm2(mx, my)
        u = rel / torch.clamp_min(geom.norm(rel)[..., None], nm.f32(1e-9))
        dist_cp = geom.line_circle_min_distance(
            robot_prev_pos[:, None, :], u, tracks.pos,
            cfg.collision_body_width)
    if form == "xla":
        resultant = nm.div_const(speed_raw, cfg.dt)[:, None] - tracks.speed
    else:
        obs_speed = tracks.speed
        if form == "strict":
            # the reference divides every track's TTC by the first track's
            # closing speed
            first = tracks.valid.to(torch.int8).argmax(dim=1, keepdim=True)
            obs_speed = torch.where(tracks.valid.any(dim=1, keepdim=True),
                                    torch.gather(tracks.speed, 1, first),
                                    0.0)
        resultant = nm.fma(speed_raw[:, None], nm.recip_f32(cfg.dt),
                           -obs_speed).expand_as(tracks.speed)
    hit = torch.isfinite(dist_cp)
    still = resultant == 0.0
    ttc = dist_cp / torch.where(still, 1.0, resultant)
    cp_ttc = geom.collision_prob_ttc(ttc, hit & ~still)
    gcp = geom.collision_prob_distance(tracks.dist, cfg.max_scan_range,
                                       cfg.min_scan_range)
    mix = nm.fma(nm.f32(cfg.cp_ttc_weight), cp_ttc,
                 nm.f32(cfg.cp_dist_weight) * gcp)
    cp = torch.where(hit & still, gcp, mix)
    cp = torch.where(tracks.valid, cp, 0.0)
    ego = torch.where(tracks.valid & hit & ~still, cp_ttc, 0.0)
    return cp, ego


def select_top_k(cfg: EnvConfig, tracks: TrackState, cp, live, robot_pos,
                 form: str = "xla"):
    """Stage 8: the K highest-CP tracks in stable order (ties to the lower
    slot, as ``lax.top_k``), padded with the robot pose. ``live`` (N,).
    ``"strict"``: the reference's ``sorted(desc)[-K:]``, which keeps the K
    lowest-CP tracks when more than K are valid, reported in descending CP
    order (ties in the order the selection found them)."""
    K = cfg.k_obstacles
    score = torch.where(tracks.valid, cp, -INF)
    if form == "strict":
        overflow = (tracks.valid.sum(dim=1, keepdim=True) > K)
        score = torch.where(tracks.valid, torch.where(overflow, -cp, cp),
                            -INF)
    top_score, top_idx = torch.sort(score, dim=1, descending=True,
                                    stable=True)
    top_score, top_idx = top_score[:, :K], top_idx[:, :K]
    if form == "strict":
        key = torch.where(torch.isfinite(top_score),
                          torch.gather(cp, 1, top_idx), -INF)
        order = torch.sort(key, dim=1, descending=True, stable=True)[1]
        top_score = torch.gather(top_score, 1, order)
        top_idx = torch.gather(top_idx, 1, order)
    picked = live[:, None] & torch.isfinite(top_score)
    top_cp = torch.where(picked, torch.gather(cp, 1, top_idx), 0.0)
    entries = torch.cat([_take(tracks.pos, top_idx),
                         _take(tracks.vel, top_idx)], dim=-1)
    pad = torch.cat([robot_pos, torch.zeros_like(robot_pos)], dim=-1)
    top_pose_vel = torch.where(picked[..., None], entries, pad[:, None, :])
    return top_cp, top_pose_vel


def track_cp_topk(cfg: EnvConfig, segs: Segments, tracks: TrackState,
                  robot_pos, robot_prev_pos, compute_cp, form: str = "xla"):
    """The tracker -> CP -> top-K chain in ``form`` (:data:`FORMS`) with
    the perceive-level reductions: ``(new_tracks, top_cp (N,K),
    top_pose_vel (N,K,4), cp_max (N,), ego_cp (N,))``. ``compute_cp``
    (N,) bool."""
    if form not in FORMS:
        raise ValueError(f"unknown chain form {form!r}")
    new_tracks = update_tracks(cfg, tracks, segs, form)
    cp, ego = collision_probabilities(cfg, new_tracks, robot_pos,
                                      robot_prev_pos, form)
    live = compute_cp & new_tracks.valid.any(dim=1)
    top_cp, top_pv = select_top_k(cfg, new_tracks, cp, live, robot_pos,
                                  form)
    cp_max = torch.where(live, top_cp.amax(dim=1), 0.0)
    ego_cp = torch.where(
        live, torch.where(new_tracks.valid, ego, 0.0).amax(dim=1), 0.0)
    return new_tracks, top_cp, top_pv, cp_max, ego_cp


def risk_output(cfg: EnvConfig, segs: Segments, chain,
                regions=None) -> RiskOutput:
    """Assemble a :class:`RiskOutput` from the segments and the outputs of
    the tracker -> CP -> top-K chain."""
    new_tracks, top_cp, top_pv, cp_max, ego_cp = chain
    near = segs.center_dist < nm.f32(cfg.ego_distance_threshold)
    return RiskOutput(
        tracks=new_tracks, top_k_pose_vel=top_pv, top_k_cp=top_cp,
        cp_max=cp_max, ego_cp=ego_cp,
        obstacle_seen=segs.is_obstacle.any(dim=1),
        ego_violation=(segs.is_obstacle & near).any(dim=1),
        segments=segs, segment_regions=regions)


def perceive(cfg: EnvConfig, scans, points, tracks: TrackState, robot_pos,
             robot_prev_pos, compute_cp, yaw=None) -> RiskOutput:
    """The full pipeline for the batch (``risk.perceive`` of the JAX
    package, vmapped): segmentation, the tracker -> CP -> top-K kernel
    (``ops.risk_kernel``, in the config's form), the perceive-level
    flags, and with ``yaw`` (N,) each valid segment's social-region code
    (``geom.social_region``; 0 elsewhere). ``compute_cp`` (N,) bool."""
    from crowdnav_tpu_torch.ops.risk_kernel import track_cp_topk_batch
    segs = segment_scans(cfg, scans, points)
    chain = track_cp_topk_batch(cfg, segs, tracks, robot_pos,
                                robot_prev_pos, compute_cp)
    regions = None
    if yaw is not None:
        regions = torch.where(
            segs.valid, geom.social_region(robot_pos[:, None, :],
                                           yaw[:, None], segs.center_pos,
                                           segs.center_dist), 0)
    return risk_output(cfg, segs, chain, regions)
