"""Wrapper of the tracker -> CP -> top-K CUDA kernel
(``kernels/csrc/track_cp_topk.cu``), the port of the Pallas kernel of
``crowdnav_tpu/ops/risk_pallas.py``.

On CPU tensors :func:`track_cp_topk_batch` runs the plain chain
``ops.risk.track_cp_topk``; on CUDA tensors it launches the kernel, or
raises if the inputs are not what the kernel takes.
"""
from __future__ import annotations

from crowdnav_tpu_torch.envs.config import EnvConfig
from crowdnav_tpu_torch.envs.world import TrackState
from crowdnav_tpu_torch.ops import risk


def track_cp_topk_batch(cfg: EnvConfig, segs: risk.Segments,
                        tracks: TrackState, robot_pos, robot_prev_pos,
                        compute_cp):
    """``(new_tracks, top_cp (N,K), top_pose_vel (N,K,4), cp_max (N,),
    ego_cp (N,))`` for the batch, as ``risk_pallas.track_cp_topk_batch``.
    ``compute_cp`` is (N,) bool."""
    if cfg.strict_quirks:
        raise ValueError("the tracker kernel implements the default quirks "
                         "policy only")
    if robot_pos.device.type == "cpu":
        return risk.track_cp_topk(cfg, segs, tracks, robot_pos,
                                  robot_prev_pos, compute_cp)
    from crowdnav_tpu_torch.kernels import build
    trk, (top_cp, top_pv, cp_max, ego_cp) = build.track_cp_topk(
        cfg, segs.confirmed, segs.is_obstacle, segs.center_pos,
        segs.center_dist, tracks.valid, tracks.pos, tracks.prev_pos,
        tracks.dist, tracks.speed, tracks.vel, robot_pos, robot_prev_pos,
        compute_cp)
    track_cp_topk_batch.launches += 1
    return TrackState(*trk), top_cp, top_pv, cp_max, ego_cp


track_cp_topk_batch.launches = 0
