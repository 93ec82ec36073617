"""Launch-geometry sweep of the port's two CUDA kernels on the card.

    python scripts/bench_torch_kernels.py

Times, by device time alone (``crowdnav_tpu_torch/kernels/timing.py``),
the raycast's two forms at each block size and number of beams per thread
(each held bit-equal to the plain version first), their second designs
(``scripts/second_design_kernels/``, without the cull by reach) at each
number of beams per thread, and, in its default geometry, both forms at
0 and 28 pedestrians besides 14 (the cost per beam against the cost per
pedestrian), and the tracker -> CP -> top-K kernel at each number of envs
per block, with their first designs (``scripts/first_design_kernels/``)
beside them, at 1,024 and 16,384 envs on the inputs of ``chip_smoke.py``;
at 16,384 envs the raycast also on the state of a 64-step rollout of the
Pallas forms' env (``chip_smoke.phase_forms_rollout``); each geometry's
output is first held bit-equal to the plain version's. Beside them: the
same launches as CUPTI times them, the time of a one-element add (the
method's floor per call) and of filling a fresh output of the raycast's
size (its store traffic alone). Prints one JSON line per shape, then
the card's name and power limit. The wrapper's defaults
(``kernels/launch.py``) are chosen from this sweep.
"""
from __future__ import annotations

import functools
import json
import math
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

ENVS_PER_BLOCK = (1, 2, 4, 8, 16)
THREADS = (128, 256, 512)


def sweep_forms(torch, cs, second_lib, cfg, pos, yaw, peds, dev):
    """Device ms of both raycast forms at each geometry, and of their
    second designs at each number of beams per thread (128 threads)."""
    from crowdnav_tpu_torch.kernels import build, launch, roofline, timing
    from crowdnav_tpu_torch.ops import lidar
    from crowdnav_tpu_torch.utils import numerics as nm
    consts = lidar._consts(cfg.ped_radius, cfg.room_half_inner,
                           cfg.max_scan_range, cfg.lidar_min_range)
    ca, sa = lidar.beam_tables(cfg.n_scans, dev)
    forms = {
        "pallas": ((pos, yaw, peds, cfg.n_scans, *consts),
                   build.raycast_pallas, lidar.raycast_pallas_plain,
                   cs.second_design_raycast_pallas),
        "xla": ((pos, nm.cos(yaw), nm.sin(yaw), ca, sa, peds, *consts),
                build.raycast, lidar.raycast_plain,
                cs.second_design_raycast)}
    n, p = peds.shape[:2]
    nbytes, _ = roofline.raycast_work(n, cfg.n_scans, p, 0)
    out = {}
    for form, (args, kernel, plain, second) in forms.items():
        sets = timing.clone_args(args, timing.copies_for(nbytes))
        ref = plain(*args)
        res = {}
        for r in launch.RAYCAST_BEAMS_PER_THREAD:
            old = functools.partial(second, torch, second_lib,
                                    beams_per_thread=r)
            if not torch.equal(old(*args), ref):
                raise AssertionError(f"raycast {form} second design x{r} "
                                     f"differs")
            res[f"second_design_128x{r}"] = timing.device_ms(old, sets, 100)
            for t in THREADS:
                fn = functools.partial(kernel, threads=t, beams_per_thread=r)
                if not torch.equal(fn(*args), ref):
                    raise AssertionError(f"raycast {form} {t}x{r} differs")
                res[f"{t}x{r}"] = timing.device_ms(fn, sets, 100)
        out[form] = res
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("bench_torch_kernels: no CUDA device")
    import chip_smoke as cs
    from crowdnav_tpu_torch.envs.config import make_config
    from crowdnav_tpu_torch.kernels import build, launch, roofline, timing
    from crowdnav_tpu_torch.ops import lidar, risk
    from crowdnav_tpu_torch.utils import numerics as nm

    dev = torch.device("cuda", 0)
    cfg = make_config("crowd_dense", "crowd")
    first_lib = build.load(build.compile_library(cs.FIRST_DESIGN)[0],
                           cs.FIRST_DESIGN_SIGNATURES)
    second_lib = build.load(
        build.compile_library(cs.SECOND_DESIGN, (build.CSRC,))[0],
        cs.SECOND_DESIGN_SIGNATURES)
    build.library()
    state = cs.phase_forms_rollout(
        torch, dev, ("rollout_pallas",))["rollout_pallas"]["state"]
    ca, sa = lidar.beam_tables(cfg.n_scans, dev)
    g = torch.Generator(device=dev).manual_seed(1)
    S, T, K = cfg.max_segments, cfg.max_tracks, cfg.k_obstacles
    for n in cs.SHAPES:
        u = lambda shape, lo, hi: (torch.rand(shape, generator=g, device=dev)
                                   * (hi - lo) + lo)
        pos, yaw = u((n, 2), -1.3, 1.3), u((n,), -math.pi, math.pi)
        args = (pos, torch.cos(yaw), torch.sin(yaw), ca, sa,
                u((n, 14, 2), -1.35, 1.35), nm.f32(cfg.room_half_inner),
                nm.f32(cfg.ped_radius ** 2), nm.f32(cfg.lidar_min_range),
                nm.f32(cfg.max_scan_range))
        nbytes, _ = roofline.raycast_work(n, cfg.n_scans, 14, 0)
        sets = ray_sets = timing.clone_args(args, timing.copies_for(nbytes))
        ref = lidar.raycast_plain(*args)
        for t in THREADS:
            for r in launch.RAYCAST_BEAMS_PER_THREAD:
                if not torch.equal(build.raycast(*args, threads=t,
                                                 beams_per_thread=r), ref):
                    raise AssertionError(f"raycast {t}x{r} differs")
        ray = {f"{t}x{r}": timing.device_ms(
            functools.partial(build.raycast, threads=t, beams_per_thread=r),
            sets, reps=100)
            for t in THREADS for r in launch.RAYCAST_BEAMS_PER_THREAD}
        # at 0 and 28 pedestrians: the per-beam cost (walls; in the Pallas
        # form also the C library's trig) against the per-pedestrian cost
        for p in (0, 28):
            peds = u((n, p, 2), -1.35, 1.35)
            for form, fargs, kernel, plain in (
                    ("", args[:5] + (peds,) + args[6:], build.raycast,
                     lidar.raycast_plain),
                    ("pallas_", (pos, yaw, peds, cfg.n_scans, *args[6:]),
                     build.raycast_pallas, lidar.raycast_pallas_plain)):
                if not torch.equal(kernel(*fargs), plain(*fargs)):
                    raise AssertionError(f"raycast {form}at {p} pedestrians "
                                         f"differs")
                ray[f"{form}p{p}"] = timing.device_ms(
                    kernel, timing.clone_args(fargs, len(sets)), reps=100)
        ray["first_design"] = timing.device_ms(
            functools.partial(cs.first_design_raycast, torch, first_lib),
            sets, reps=100)
        pallas = {"uniform": sweep_forms(
            torch, cs, second_lib, cfg, pos, yaw, args[5], dev)}
        if n == cs.N_BIG:
            pallas["rollout_state"] = sweep_forms(
                torch, cs, second_lib, cfg, state.pos, state.yaw,
                state.ped_pos, dev)
        segs, tracks, rpos, rprev, cc = cs._random_population(
            torch, cfg, n, dev, 0)
        kargs = (cfg, segs.confirmed, segs.is_obstacle, segs.center_pos,
                 segs.center_dist, tracks.valid, tracks.pos, tracks.prev_pos,
                 tracks.dist, tracks.speed, tracks.vel, rpos, rprev, cc)
        nbytes, _ = roofline.track_cp_topk_work(n, S, T, K)
        sets = timing.clone_args(kargs, timing.copies_for(nbytes))
        ref = cs._flatten(risk.track_cp_topk(cfg, segs, tracks, rpos, rprev,
                                             cc))
        for e in ENVS_PER_BLOCK:
            got = build.track_cp_topk(*kargs, envs_per_block=e)
            if not all(torch.equal(a, b) for a, b in zip([*got[0], *got[1]],
                                                         ref)):
                raise AssertionError(f"track_cp_topk, {e} envs per block, "
                                     f"differs")
        trk = {str(e): timing.device_ms(
            functools.partial(build.track_cp_topk, envs_per_block=e), sets,
            reps=100) for e in ENVS_PER_BLOCK}
        trk["first_design"] = timing.device_ms(
            functools.partial(cs.first_design_track, torch, first_lib), sets,
            reps=100)
        # the same launches as CUPTI times them, cold and with one input
        # set (hot in L2), and the floor of the method: a one-element add
        prof = {
            "raycast_cold": timing.profiled_ms(
                build.raycast, ray_sets, 100, "raycast_kernel"),
            "raycast_hot": timing.profiled_ms(
                build.raycast, ray_sets[:1], 100, "raycast_kernel"),
            "first_raycast_cold": timing.profiled_ms(
                functools.partial(cs.first_design_raycast, torch, first_lib),
                ray_sets, 100, "raycast_kernel"),
            "track_cold": timing.profiled_ms(
                build.track_cp_topk, sets, 100, "track_cp_topk_kernel"),
            "track_hot": timing.profiled_ms(
                build.track_cp_topk, sets[:1], 100, "track_cp_topk_kernel"),
            "first_track_cold": timing.profiled_ms(
                functools.partial(cs.first_design_track, torch, first_lib),
                sets, 100, "track_cp_topk_kernel")}
        burst_hot = {
            "raycast": timing.device_ms(build.raycast, ray_sets[:1], 100),
            "track": timing.device_ms(build.track_cp_topk, sets[:1], 100)}
        one = torch.zeros(1, device=dev)
        floor = timing.device_ms(lambda x: x.add_(1.0), [(one,)], 100)
        # the raycast's output alone: a fresh (n, 359) float32 tensor filled
        fill = timing.device_ms(
            lambda: torch.empty((n, cfg.n_scans), device=dev).fill_(1.0),
            [()], 100)
        print(json.dumps({"n_envs": n,
                          "raycast_ms": ray,
                          "raycast_forms_ms": pallas,
                          "track_cp_topk_ms_by_envs_per_block": trk,
                          "cupti_kernel_ms": prof,
                          "device_ms_hot_l2": burst_hot,
                          "device_ms_one_element_add": floor,
                          "device_ms_fill_fresh_scan_output": fill}),
              flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
