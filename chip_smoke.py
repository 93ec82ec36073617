#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. ``device``: the card, its power limit, TF32 switched off;
2. ``build``: the one ``nvcc`` call that builds every kernel of the port,
   and beside it, started together, the build of the kernels' first designs
   (``scripts/first_design_kernels/``), kept as a timing baseline;
3. ``raycast``: the raycast kernel against its plain version on the card,
   then its device time at 1,024 and 16,384 envs;
4. ``track_cp_topk``: the tracker -> CP -> top-K kernel against its plain
   version, on random populations and edge cases (also at K = 1 and at
   sizes the kernel takes at run time), then its device time;
5. ``evaluate``: the port's evaluation driver, greedy TD3 on suite
   ``train`` with the exported ``final_full`` actor, 1,024 envs x 500 steps,
   with each kernel's launch count on that run;
6. ``kernels``: one line with each kernel's times, bounds and launches.

Kernel times are device time alone (``kernels/timing.py``): a burst of
wrapper calls queued behind ``torch.cuda._sleep``, over input copies that
keep each launch's bytes out of the L2 cache, at 1,024 envs (the evaluate
path) and 16,384 envs (the training batch of ``bench.py``). ``ms`` and
``bound_ms`` are at 16,384 envs.

The last line is ``{"ok": true, "device": {...}}``. Any failed phase raises
and the script exits non-zero; without a CUDA device it fails at once.
"""
from __future__ import annotations

import ctypes
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

N_BIG = 16384
N_ODD = 1000
EVAL_ENVS = 1024
EVAL_STEPS = 500
SHAPES = (EVAL_ENVS, N_BIG)
JAX_RECORD = (5655, 5766)   # results/r5/final_full/td3_training_test.csv
ROOT = os.path.dirname(os.path.abspath(__file__))
FIRST_DESIGN = os.path.join(ROOT, "scripts", "first_design_kernels")
# C interface of the first designs: every pointer, then the sizes, the
# float32 constants and the stream
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
FIRST_DESIGN_SIGNATURES = {
    "crowdnav_raycast": [_P] * 7 + [_I] * 3 + [_F] * 4 + [_P],
    "crowdnav_track_cp_topk": [_P] * 24 + [_I] * 4 + [_F] * 8 + [_P],
}
TIMING = ("device-only: bursts of wrapper calls queued behind "
          "torch.cuda._sleep, median of 3 bursts, inputs rotated over "
          "copies so that every launch misses L2 (kernels/timing.py); "
          "plain_ms: an event pair around one call, host time included")


def emit(obj):
    print(json.dumps(obj), flush=True)


def wilson(k, n, z=1.96):
    p = k / n
    den = 1 + z * z / n
    mid = (p + z * z / (2 * n)) / den
    half = z * math.sqrt(p * (1 - p) / n + z * z / (4 * n * n)) / den
    return [round(mid - half, 4), round(mid + half, 4)]


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
    """The port's library and the first designs' library, their two
    ``nvcc`` calls started together; returns the first designs' library."""
    from crowdnav_tpu_torch.kernels import build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        first = pool.submit(build.compile_library, FIRST_DESIGN)
        build.library()
        first_path, first_s = first.result()
    first_lib = build.load(first_path, FIRST_DESIGN_SIGNATURES)
    emit({"phase": "build", "nvcc_s": build.build_seconds,
          "first_design_nvcc_s": first_s,
          "load_s": round(time.perf_counter() - t0, 3),
          "sources": [os.path.relpath(s, ROOT) for s in build.sources()],
          "first_design_sources": [os.path.relpath(s, ROOT) for s in
                                   build.sources(FIRST_DESIGN)],
          "flags": build.NVCC_FLAGS})
    return first_lib


def _stream(torch, t):
    return torch.cuda.current_stream(t.device).cuda_stream


def first_design_raycast(torch, lib, pos, cy, sy, ca, sa, peds, half, r2,
                         min_range, max_range):
    """The raycast's first design (one block of 128 threads per env)."""
    from crowdnav_tpu_torch.kernels import build
    ptrs, out = build.raycast_buffers(pos, cy, sy, ca, sa, peds)
    n, b = out.shape
    code = lib.crowdnav_raycast(*ptrs, out.data_ptr(), n, b, peds.shape[1],
                                half, r2, min_range, max_range,
                                _stream(torch, pos))
    if code:
        raise RuntimeError(f"first-design raycast: CUDA error {code}")
    return out


def first_design_track(torch, lib, cfg, *tensors):
    """The tracker kernel's first design (one warp per env, no shared
    memory)."""
    from crowdnav_tpu_torch.kernels import build
    ptrs, outs, consts = build.track_cp_topk_buffers(cfg, *tensors)
    n, S = tensors[0].shape
    code = lib.crowdnav_track_cp_topk(
        *ptrs, *(o.data_ptr() for o in outs), n, S, tensors[4].shape[1],
        cfg.k_obstacles, *consts, _stream(torch, tensors[0]))
    if code:
        raise RuntimeError(f"first-design tracker: CUDA error {code}")
    return outs[:7], outs[7:]


def _timings(kernel, first, plain, args, plain_args, nbytes):
    """Device ms of the kernel and its first design on copies of ``args``,
    and of the plain version on ``plain_args``."""
    from crowdnav_tpu_torch.kernels import timing
    sets = timing.clone_args(args, timing.copies_for(nbytes))
    return {"device_ms": timing.device_ms(kernel, sets, reps=100),
            "first_design_device_ms": timing.device_ms(first, sets,
                                                       reps=100),
            "plain_ms": timing.stream_ms(plain, plain_args)}


def _max_abs(a, b, torch):
    if a.dtype == torch.bool:
        return float((a != b).sum())
    d = (a.double() - b.double()).abs()
    both_inf = torch.isinf(a) & torch.isinf(b) & (a == b)
    return float(torch.where(both_inf, 0.0, d).max()) if d.numel() else 0.0


def phase_raycast(torch, dev, first_lib):
    from crowdnav_tpu_torch.envs.config import make_config
    from crowdnav_tpu_torch.kernels import build, roofline
    from crowdnav_tpu_torch.ops import lidar
    from crowdnav_tpu_torch.utils import numerics as nm
    cfg = make_config("crowd_dense", "crowd")
    h = cfg.room_half_inner
    g = torch.Generator(device=dev).manual_seed(1)

    def u(shape, lo, hi):
        return torch.rand(shape, generator=g, device=dev) * (hi - lo) + lo

    def population(n, p):
        return (u((n, 2), -1.3, 1.3), u((n,), -math.pi, math.pi),
                u((n, p, 2), -1.35, 1.35))

    cases = {"n16384_p14": population(N_BIG, 14),
             # the n_peds=0 placeholder pedestrian, far out of range
             "n16384_p0": (u((N_BIG, 2), -1.3, 1.3),
                           u((N_BIG,), -math.pi, math.pi),
                           torch.full((N_BIG, 1, 2), 1e3, device=dev)),
             "n1000_p14": population(N_ODD, 14),
             "n1024_p14": population(EVAL_ENVS, 14)}
    consts = dict(ped_radius=cfg.ped_radius, room_half=h,
                  max_range=cfg.max_scan_range,
                  min_range=cfg.lidar_min_range, n_scans=cfg.n_scans)
    ca, sa = lidar.beam_tables(cfg.n_scans, dev)

    def plain_args(pos, yaw, peds):
        return (pos, torch.cos(yaw), torch.sin(yaw), ca, sa, peds,
                nm.f32(h), nm.f32(cfg.ped_radius ** 2),
                nm.f32(cfg.lidar_min_range), nm.f32(cfg.max_scan_range))

    result = {}
    for name, (pos, yaw, peds) in cases.items():
        got = lidar.scan_batch(pos, yaw, peds, **consts)
        ref = lidar.raycast_plain(*plain_args(pos, yaw, peds))
        torch.cuda.synchronize()
        raw = _max_abs(got, ref, torch)
        rounded_equal = bool(torch.equal(nm.round3(got), nm.round3(ref)))
        if not rounded_equal or raw > 1e-6:
            raise AssertionError(f"raycast {name}: rounded equal "
                                 f"{rounded_equal}, max |diff| {raw}")
        result[name] = {"max_abs_diff": raw, "rounded_bit_equal": True,
                        "bit_equal": bool(torch.equal(got, ref))}

    def first(*a):
        return first_design_raycast(torch, first_lib, *a)

    shapes = {}
    for n, case in ((EVAL_ENVS, "n1024_p14"), (N_BIG, "n16384_p14")):
        args = plain_args(*cases[case])
        if not torch.equal(build.raycast(*args), first(*args)):
            raise AssertionError(f"raycast {case}: the first design differs")
        hits = roofline.raycast_hits(*args[:6], args[7])
        nbytes, ops = roofline.raycast_work(n, cfg.n_scans, 14, hits)
        bound, bound_by = roofline.bound_ms(nbytes, ops)
        shapes[n] = dict(_timings(build.raycast, first, lidar.raycast_plain,
                                  args, args, nbytes),
                         bound_ms=bound, bound_by=bound_by, bytes=nbytes,
                         ops=ops, hits=hits)
    emit({"phase": "raycast", "cases": result, "timing": TIMING,
          "shapes": shapes})
    return {"max_abs": max(r["max_abs_diff"] for r in result.values()),
            "shapes": shapes}


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


def phase_track(torch, dev, first_lib):
    from crowdnav_tpu_torch.envs.config import make_config
    from crowdnav_tpu_torch.kernels import build, roofline
    from crowdnav_tpu_torch.ops import risk
    from crowdnav_tpu_torch.ops.risk_kernel import track_cp_topk_batch
    cfg = make_config("crowd_dense", "crowd")
    cases = {f"random_n{N_BIG}_seed{s}": _random_population(
        torch, cfg, N_BIG, dev, s) for s in range(3)}
    cases[f"random_n{N_ODD}"] = _random_population(torch, cfg, N_ODD, dev, 9)
    cases[f"random_n{EVAL_ENVS}"] = _random_population(torch, cfg, EVAL_ENVS,
                                                       dev, 11)
    cases["edges"] = _edge_population(torch, cfg, dev)
    cfgs = dict.fromkeys(cases, cfg)
    # the kernel's other instantiations: K = 1 (world "realworld") and
    # sizes it takes at run time
    for name, other in (("k1", dataclasses.replace(cfg, k_obstacles=1)),
                        ("t20_k5", dataclasses.replace(
                            cfg, max_tracks=20, k_obstacles=5))):
        cases[f"random_n{N_ODD}_{name}"] = _random_population(
            torch, other, N_ODD, dev, 13)
        cfgs[f"random_n{N_ODD}_{name}"] = other
    names = ["valid", "pos", "prev_pos", "has_prev", "dist", "speed", "vel",
             "top_cp", "top_pose_vel", "cp_max", "ego_cp"]
    result = {}
    worst = 0.0
    for case, args in cases.items():
        got = _flatten(track_cp_topk_batch(cfgs[case], *args))
        ref = _flatten(risk.track_cp_topk(cfgs[case], *args))
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

    def kernel_args(segs, tracks, pos, prev, cc):
        return (cfg, segs.confirmed, segs.is_obstacle, segs.center_pos,
                segs.center_dist, tracks.valid, tracks.pos, tracks.prev_pos,
                tracks.dist, tracks.speed, tracks.vel, pos, prev, cc)

    def plain(*a):
        return risk.track_cp_topk(cfg, *a)

    def first(*a):
        return first_design_track(torch, first_lib, *a)

    S, T, K = cfg.max_segments, cfg.max_tracks, cfg.k_obstacles
    shapes = {}
    for n, case in ((EVAL_ENVS, f"random_n{EVAL_ENVS}"),
                    (N_BIG, f"random_n{N_BIG}_seed0")):
        args = kernel_args(*cases[case])
        got = build.track_cp_topk(*args)
        old = first(*args)
        if not all(torch.equal(a, b) for a, b in zip(
                [*got[0], *got[1]], [*old[0], *old[1]])):
            raise AssertionError(f"track_cp_topk {case}: the first design "
                                 f"differs")
        nbytes, ops = roofline.track_cp_topk_work(n, S, T, K)
        bound, bound_by = roofline.bound_ms(nbytes, ops)
        shapes[n] = dict(_timings(build.track_cp_topk, first, plain, args,
                                  cases[case], nbytes),
                         bound_ms=bound, bound_by=bound_by, bytes=nbytes,
                         ops=ops)
    emit({"phase": "track_cp_topk", "cases": result, "timing": TIMING,
          "shapes": shapes})
    return {"max_abs": worst, "shapes": shapes}


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
    first_lib = phase_build()
    ray = phase_raycast(torch, dev, first_lib)
    trk = phase_track(torch, dev, first_lib)
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
        big = stats["shapes"][N_BIG]
        entry = {
            "name": name, "route": "cuda", "source": src, "replaces": tpu,
            "tpu_kernel": f"{tpu} {fn}", "launches": launches[name],
            "launches_per_step": launches[name] / EVAL_STEPS,
            "max_abs_err": stats["max_abs"],
            "max_abs_diff": stats["max_abs"], "ms": big["device_ms"],
            "kernel_ms": big["device_ms"], "plain_ms": big["plain_ms"],
            "bound_ms": big["bound_ms"], "bound_by": big["bound_by"],
            "library_ms": None,
            "library_ms_reason": "no single PyTorch call computes it",
            "card": smi, "timing": TIMING}
        for n in SHAPES:
            sh = stats["shapes"][n]
            entry.update({
                f"device_ms_n{n}": sh["device_ms"],
                f"first_design_device_ms_n{n}": sh["first_design_device_ms"],
                f"plain_ms_n{n}": sh["plain_ms"],
                f"bound_ms_n{n}": sh["bound_ms"],
                f"bound_by_n{n}": sh["bound_by"],
                f"bound_share_n{n}": sh["bound_ms"] / sh["device_ms"]})
        kernels.append(entry)
    emit({"kernels": kernels})
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    sys.exit(main())
