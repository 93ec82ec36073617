#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. ``device``: the card, its power limit, TF32 switched off;
2. ``build``: the one ``nvcc`` call that builds every kernel;
3. ``raycast``: the raycast kernel against its plain version on the card;
4. ``track_cp_topk``: the tracker -> CP -> top-K kernel against its plain
   version, on random populations and edge cases;
5. ``evaluate``: the port's evaluation driver, greedy TD3 on suite
   ``train`` with the exported ``final_full`` actor, 1,024 envs x 500 steps,
   with each kernel's launch count on that run;
6. ``kernels``: one line with each kernel's times, bound and launches.

The last line is ``{"ok": true, "device": {...}}``. Any failed phase raises
and the script exits non-zero; without a CUDA device it fails at once.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

N_BIG = 16384
N_ODD = 1000
EVAL_ENVS = 1024
EVAL_STEPS = 500
REPS = 20
JAX_RECORD = (5655, 5766)   # results/r5/final_full/td3_training_test.csv
H100_BYTES_PER_S = 3.35e12
H100_F32_FLOPS = 67e12


def emit(obj):
    print(json.dumps(obj), flush=True)


def wilson(k, n, z=1.96):
    p = k / n
    den = 1 + z * z / n
    mid = (p + z * z / (2 * n)) / den
    half = z * math.sqrt(p * (1 - p) / n + z * z / (4 * n * n)) / den
    return [round(mid - half, 4), round(mid + half, 4)]


def time_ms(fn, torch):
    """Median milliseconds of ``fn`` over REPS launches, after warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def phase_device(torch):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32})
    return smi


def phase_build():
    from crowdnav_tpu_torch.kernels import build
    t0 = time.perf_counter()
    build.library()
    emit({"phase": "build", "nvcc_s": build.build_seconds,
          "load_s": round(time.perf_counter() - t0, 3),
          "sources": [str(s.relative_to(s.parents[3]))
                      for s in build.sources()],
          "flags": build.NVCC_FLAGS})


def _max_abs(a, b, torch):
    if a.dtype == torch.bool:
        return float((a != b).sum())
    d = (a.double() - b.double()).abs()
    both_inf = torch.isinf(a) & torch.isinf(b) & (a == b)
    return float(torch.where(both_inf, 0.0, d).max()) if d.numel() else 0.0


def phase_raycast(torch, dev):
    from crowdnav_tpu_torch.envs.config import make_config
    from crowdnav_tpu_torch.ops import lidar
    from crowdnav_tpu_torch.utils import numerics as nm
    cfg = make_config("crowd_dense", "crowd")
    h = cfg.room_half_inner
    g = torch.Generator(device=dev).manual_seed(1)

    def u(shape, lo, hi):
        return torch.rand(shape, generator=g, device=dev) * (hi - lo) + lo

    cases = {"n16384_p14": (u((N_BIG, 2), -1.3, 1.3),
                            u((N_BIG,), -math.pi, math.pi),
                            u((N_BIG, 14, 2), -1.35, 1.35)),
             # the n_peds=0 placeholder pedestrian, far out of range
             "n16384_p0": (u((N_BIG, 2), -1.3, 1.3),
                           u((N_BIG,), -math.pi, math.pi),
                           torch.full((N_BIG, 1, 2), 1e3, device=dev)),
             "n1000_p14": (u((N_ODD, 2), -1.3, 1.3),
                           u((N_ODD,), -math.pi, math.pi),
                           u((N_ODD, 14, 2), -1.35, 1.35))}
    consts = dict(ped_radius=cfg.ped_radius, room_half=h,
                  max_range=cfg.max_scan_range,
                  min_range=cfg.lidar_min_range, n_scans=cfg.n_scans)
    result = {}
    for name, (pos, yaw, peds) in cases.items():
        got = lidar.scan_batch(pos, yaw, peds, **consts)
        ca, sa = lidar.beam_tables(cfg.n_scans, dev)
        plain_args = (pos, torch.cos(yaw), torch.sin(yaw), ca, sa, peds,
                      nm.f32(h), nm.f32(cfg.ped_radius ** 2),
                      nm.f32(cfg.lidar_min_range),
                      nm.f32(cfg.max_scan_range))
        ref = lidar.raycast_plain(*plain_args)
        torch.cuda.synchronize()
        raw = _max_abs(got, ref, torch)
        rounded_equal = bool(torch.equal(nm.round3(got), nm.round3(ref)))
        if not rounded_equal or raw > 1e-6:
            raise AssertionError(f"raycast {name}: rounded equal "
                                 f"{rounded_equal}, max |diff| {raw}")
        result[name] = {"max_abs_diff": raw, "rounded_bit_equal": True}
    pos, yaw, peds = cases["n16384_p14"]
    ca, sa = lidar.beam_tables(cfg.n_scans, dev)
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    args = (pos, cy, sy, ca, sa, peds, nm.f32(h),
            nm.f32(cfg.ped_radius ** 2), nm.f32(cfg.lidar_min_range),
            nm.f32(cfg.max_scan_range))
    from crowdnav_tpu_torch.kernels import build
    plain_ms = time_ms(lambda: lidar.raycast_plain(*args), torch)
    ms = time_ms(lambda: build.raycast(*args), torch)
    n, b, p = N_BIG, cfg.n_scans, 14
    bytes_moved = 4 * (n * 2 + 2 * n + 2 * b + n * p * 2 + n * b)
    ops = n * b * (15 + 17 * p)
    bound = max(bytes_moved / H100_BYTES_PER_S, ops / H100_F32_FLOPS) * 1e3
    emit({"phase": "raycast", "cases": result, "ms": ms,
          "plain_ms": plain_ms, "bound_ms": bound,
          "bytes": bytes_moved, "ops": ops})
    return {"max_abs": max(r["max_abs_diff"] for r in result.values()),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": ("bytes" if bytes_moved / H100_BYTES_PER_S
                         >= ops / H100_F32_FLOPS else "operations")}


def _random_population(torch, cfg, n, dev, seed):
    """Segments and tracks built like tests/test_risk_pallas.py, with
    positions on a 1/8 grid so that IOU ties occur."""
    from crowdnav_tpu_torch.envs.world import TrackState
    from crowdnav_tpu_torch.ops.risk import Segments
    S, T = cfg.max_segments, cfg.max_tracks
    g = torch.Generator(device=dev).manual_seed(seed)

    def r(*s):
        return torch.rand(s, generator=g, device=dev)

    def nrm(*s):
        return torch.randn(s, generator=g, device=dev)

    seg_valid = r(n, S) < 0.4
    segs = Segments(
        valid=seg_valid, is_obstacle=seg_valid & (r(n, S) < 0.7),
        confirmed=seg_valid & (r(n, S) < 0.8),
        center_pos=torch.round((r(n, S, 2) * 2.4 - 1.2) * 8) / 8,
        center_dist=r(n, S) * 0.54 + 0.08,
        count=torch.where(seg_valid, 5, 0).to(torch.int32))
    t_valid = r(n, T) < 0.5
    tpos = torch.round((r(n, T, 2) * 2.4 - 1.2) * 8) / 8
    tracks = TrackState(
        valid=t_valid, pos=tpos, prev_pos=tpos + nrm(n, T, 2) * 0.03,
        has_prev=t_valid & (r(n, T) < 0.8), dist=r(n, T) * 0.54 + 0.08,
        speed=nrm(n, T).abs() * 0.3, vel=nrm(n, T, 2) * 0.1)
    pos = r(n, 2) * 2 - 1
    prev = pos - nrm(n, 2) * 0.03
    cc = torch.arange(n, device=dev) % 7 != 0
    return segs, tracks, pos, prev, cc


def _edge_population(torch, cfg, dev):
    """The edge cases of tests/test_risk_pallas.py plus CP ties and a full
    table: 0 nothing; 1 all tracks valid, no segments; 2 segments only
    (mass insertion); 3 identical segments (IOU tie); 4 twelve tracks on
    one segment stack (CP ties); 5 every slot matched, obstacles left
    over."""
    from crowdnav_tpu_torch.envs.world import TrackState
    from crowdnav_tpu_torch.ops.risk import Segments
    S, T, n = cfg.max_segments, cfg.max_tracks, 6
    z = lambda *s: torch.zeros(s, device=dev)
    seg_valid = torch.zeros((n, S), dtype=torch.bool, device=dev)
    seg_valid[2, :10] = True
    seg_valid[3, :2] = True
    seg_valid[4, :12] = True
    seg_valid[5, :] = True
    cpos = z(n, S, 2)
    cpos[3, :2] = 0.5
    cpos[4, :12] = torch.tensor([0.3, 0.2], device=dev)
    cpos[5] = torch.stack([torch.linspace(-1.2, 1.2, S, device=dev),
                           torch.full((S,), 0.4, device=dev)], -1)
    segs = Segments(valid=seg_valid, is_obstacle=seg_valid,
                    confirmed=seg_valid, center_pos=cpos,
                    center_dist=torch.full((n, S), 0.3, device=dev),
                    count=seg_valid.to(torch.int32) * 5)
    t_valid = torch.zeros((n, T), dtype=torch.bool, device=dev)
    t_valid[1] = True
    t_valid[3, 0] = True
    t_valid[4, :12] = True
    t_valid[5] = True
    tpos = z(n, T, 2)
    tpos[3, 0] = 0.5
    tpos[4, :12] = torch.tensor([0.31, 0.2], device=dev)
    tpos[5] = cpos[5, :T] + 0.01
    tracks = TrackState(valid=t_valid, pos=tpos, prev_pos=z(n, T, 2),
                        has_prev=t_valid.clone(),
                        dist=torch.full((n, T), 0.4, device=dev),
                        speed=torch.full((n, T), 0.2, device=dev),
                        vel=z(n, T, 2))
    pos = torch.tensor([[0.1, -0.1]], device=dev).repeat(n, 1)
    prev = torch.tensor([[0.08, -0.12]], device=dev).repeat(n, 1)
    return segs, tracks, pos, prev, torch.ones(n, dtype=torch.bool,
                                                device=dev)


def _flatten(out):
    trk, top_cp, top_pv, cp_max, ego_cp = out
    return [trk.valid, trk.pos, trk.prev_pos, trk.has_prev, trk.dist,
            trk.speed, trk.vel, top_cp, top_pv, cp_max, ego_cp]


def phase_track(torch, dev):
    from crowdnav_tpu_torch.envs.config import make_config
    from crowdnav_tpu_torch.ops import risk
    from crowdnav_tpu_torch.ops.risk_kernel import track_cp_topk_batch
    cfg = make_config("crowd_dense", "crowd")
    cases = {f"random_n{N_BIG}_seed{s}": _random_population(
        torch, cfg, N_BIG, dev, s) for s in range(3)}
    cases[f"random_n{N_ODD}"] = _random_population(torch, cfg, N_ODD, dev, 9)
    cases["edges"] = _edge_population(torch, cfg, dev)
    names = ["valid", "pos", "prev_pos", "has_prev", "dist", "speed", "vel",
             "top_cp", "top_pose_vel", "cp_max", "ego_cp"]
    result = {}
    worst = 0.0
    for case, args in cases.items():
        got = _flatten(track_cp_topk_batch(cfg, *args))
        ref = _flatten(risk.track_cp_topk(cfg, *args))
        torch.cuda.synchronize()
        diffs = {}
        for name, g, r in zip(names, got, ref):
            if g.dtype == torch.bool:
                if not torch.equal(g, r):
                    raise AssertionError(f"track_cp_topk {case}: {name} "
                                         f"differs in {int((g != r).sum())}")
                diffs[name] = 0.0
                continue
            if not torch.allclose(g, r, rtol=1e-6, atol=1e-6):
                raise AssertionError(f"track_cp_topk {case}: {name} max "
                                     f"|diff| {_max_abs(g, r, torch)}")
            diffs[name] = _max_abs(g, r, torch)
        # the top-K order is an index order: the picked positions are equal
        worst = max(worst, max(diffs.values()))
        result[case] = {"max_abs_diff": max(diffs.values()),
                        "bit_equal": all(torch.equal(g, r)
                                         for g, r in zip(got, ref))}
    args = cases[f"random_n{N_BIG}_seed0"]
    plain_ms = time_ms(lambda: risk.track_cp_topk(cfg, *args), torch)
    from crowdnav_tpu_torch.kernels import build
    segs, tracks, pos, prev, cc = args
    kargs = (cfg, segs.confirmed, segs.is_obstacle, segs.center_pos,
             segs.center_dist, tracks.valid, tracks.pos, tracks.prev_pos,
             tracks.dist, tracks.speed, tracks.vel, pos, prev, cc)
    ms = time_ms(lambda: build.track_cp_topk(*kargs), torch)
    n, S, T, K = N_BIG, cfg.max_segments, cfg.max_tracks, cfg.k_obstacles
    bytes_in = n * (S * (1 + 1 + 8 + 4) + T * (1 + 8 + 8 + 4 + 4 + 8)
                    + 8 + 8 + 1)
    bytes_out = n * (T * (1 + 8 + 8 + 1 + 4 + 4 + 8) + K * (4 + 16) + 8)
    ops = n * (T * S * 12 + T * 60 + T * T * 3)
    t_bytes = (bytes_in + bytes_out) / H100_BYTES_PER_S
    t_ops = ops / H100_F32_FLOPS
    bound = max(t_bytes, t_ops) * 1e3
    emit({"phase": "track_cp_topk", "cases": result, "ms": ms,
          "plain_ms": plain_ms, "bound_ms": bound,
          "bytes": bytes_in + bytes_out, "ops": ops})
    return {"max_abs": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def phase_evaluate(torch):
    from crowdnav_tpu_torch.drivers import evaluate
    from crowdnav_tpu_torch.ops.lidar import scan_batch
    from crowdnav_tpu_torch.ops.risk_kernel import track_cp_topk_batch
    ckpt = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "crowdnav_tpu_torch", "assets",
                        "final_full_actor.npz")
    with tempfile.TemporaryDirectory() as out:
        scan_batch.launches = 0
        track_cp_topk_batch.launches = 0
        t0 = time.perf_counter()
        results = evaluate.main([
            "--suite", "train", "--checkpoint", ckpt, "--n-envs",
            str(EVAL_ENVS), "--max-steps", str(EVAL_STEPS), "--jitter",
            "1.0", "--seed", "0", "--outdir", out, "--device", "cuda"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"raycast": scan_batch.launches,
                    "track_cp_topk": track_cp_topk_batch.launches}
    s = results[0]
    for name, count in launches.items():
        if count < EVAL_STEPS:
            raise AssertionError(f"{name} launched {count} times on the "
                                 f"evaluate path, expected >= {EVAL_STEPS}")
    rate = s["success_rate"]
    emit({"phase": "evaluate", "episodes": s["episodes"],
          "successes": s["successes"], "success_rate": rate,
          "wilson95": wilson(s["successes"], s["episodes"]),
          "jax_record": {"successes": JAX_RECORD[0],
                         "episodes": JAX_RECORD[1],
                         "success_rate": JAX_RECORD[0] / JAX_RECORD[1],
                         "wilson95": wilson(*JAX_RECORD)},
          "mean_reward": s["mean_reward"], "mean_steps": s["mean_steps"],
          "mean_ego_safety": s["mean_ego_safety"],
          "mean_social_safety": s["mean_social_safety"],
          "rollout_s": s["timelapse"], "wall_s": wall,
          "env_steps_per_s": EVAL_ENVS * EVAL_STEPS / s["timelapse"],
          "launches": launches})
    if not (s["episodes"] > 0 and rate >= 0.90):
        raise AssertionError(f"success rate {rate} < 0.90")
    return launches


def main():
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    try:
        import crowdnav_tpu_torch  # noqa: F401
    except ImportError as e:
        raise SystemExit(f"chip_smoke: the port is not importable: {e}")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = phase_device(torch)
    phase_build()
    ray = phase_raycast(torch, dev)
    trk = phase_track(torch, dev)
    launches = phase_evaluate(torch)
    kernels = []
    for name, stats, src, tpu, fn in (
            ("raycast", ray, "crowdnav_tpu_torch/kernels/csrc/raycast.cu",
             "crowdnav_tpu/ops/lidar_pallas.py:32",
             "_raycast_kernel, launched by scan_batch_pallas"),
            ("track_cp_topk", trk,
             "crowdnav_tpu_torch/kernels/csrc/track_cp_topk.cu",
             "crowdnav_tpu/ops/risk_pallas.py:61",
             "_kernel, launched by track_cp_topk_batch")):
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": tpu,
            "tpu_kernel": f"{tpu} {fn}", "launches": launches[name],
            "launches_per_step": launches[name] / EVAL_STEPS,
            "max_abs_err": stats["max_abs"],
            "max_abs_diff": stats["max_abs"], "ms": stats["ms"],
            "kernel_ms": stats["ms"], "plain_ms": stats["plain_ms"],
            "bound_ms": stats["bound_ms"], "bound_by": stats["bound_by"],
            "library_ms": None, "card": smi})
    emit({"kernels": kernels})
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    sys.exit(main())
