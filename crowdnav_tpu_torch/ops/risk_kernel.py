"""Wrapper of the tracker -> CP -> top-K CUDA kernel
(``kernels/csrc/track_cp_topk.cu``), the port of the Pallas kernel of
``crowdnav_tpu/ops/risk_pallas.py``.

The kernel computes the chain in one of three forms (``ops.risk.FORMS``),
chosen by the config (``ops.risk.chain_form``): the XLA chain, its strict
quirks, or the Pallas kernel's own arithmetic. On CPU tensors
:func:`track_cp_topk_batch` runs the plain chain ``ops.risk.track_cp_topk``
of that form; on CUDA tensors it launches the kernel, or raises if the
inputs are not what the kernel takes. ``track_cp_topk_batch.launches``
counts the kernel's launches, ``form_launches`` those of each form.
"""
from __future__ import annotations

from crowdnav_tpu_torch.envs.config import EnvConfig
from crowdnav_tpu_torch.envs.world import TrackState
from crowdnav_tpu_torch.ops import risk


def track_cp_topk_batch(cfg: EnvConfig, segs: risk.Segments,
                        tracks: TrackState, robot_pos, robot_prev_pos,
                        compute_cp):
    """``(new_tracks, top_cp (N,K), top_pose_vel (N,K,4), cp_max (N,),
    ego_cp (N,))`` for the batch, as ``risk_pallas.track_cp_topk_batch``
    (Pallas form) or the vmapped XLA chain. ``compute_cp`` is (N,)
    bool."""
    form = risk.chain_form(cfg)
    if robot_pos.device.type == "cpu":
        return risk.track_cp_topk(cfg, segs, tracks, robot_pos,
                                  robot_prev_pos, compute_cp, form)
    from crowdnav_tpu_torch.kernels import build
    trk, (top_cp, top_pv, cp_max, ego_cp) = build.track_cp_topk(
        cfg, segs.confirmed, segs.is_obstacle, segs.center_pos,
        segs.center_dist, tracks.valid, tracks.pos, tracks.prev_pos,
        tracks.dist, tracks.speed, tracks.vel, robot_pos, robot_prev_pos,
        compute_cp, form=form)
    track_cp_topk_batch.launches += 1
    track_cp_topk_batch.form_launches[form] += 1
    return TrackState(*trk), top_cp, top_pv, cp_max, ego_cp


track_cp_topk_batch.launches = 0
track_cp_topk_batch.form_launches = dict.fromkeys(risk.FORMS, 0)
