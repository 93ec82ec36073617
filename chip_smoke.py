#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. ``device``: the card, its power limit, TF32 switched off;
2. ``build``: the one ``nvcc`` call that builds every kernel of the port,
   and beside it, started together, the builds of the kernels' first
   designs (``scripts/first_design_kernels/``) and second designs
   (``scripts/second_design_kernels/``: the raycast without its cull by
   reach, the strict tracker with a second walk for its slots), kept as
   timing baselines;
3. ``raycast``: the raycast kernel (its XLA form) against its plain
   version on the card, at the shapes of every path (14 pedestrians; the
   placeholder of an empty room; 6 on ``crowd_sparse``; 20 in the 5 m room
   of ``test_20``), then its device time at each, beside its first and
   second designs';
4. ``track_cp_topk``: the tracker -> CP -> top-K kernel (its XLA form)
   against its plain version, on random populations and edge cases (also
   at K = 1 and at sizes the kernel takes at run time), then its device
   time;
5. ``forms_rollout``: ``CrowdEnv.step_batch`` at 16,384 envs x 64 steps
   of ``crowd_dense``/``crowd`` with no learner, under both kernels'
   Pallas forms and under the strict quirks: one launch of each form a
   step, the env's ms a step;
   ``kernel_forms``: the raycast's Pallas form and the tracker kernel's
   Pallas and strict forms against their plain versions, bit for bit, at
   1,024 and 16,384 envs and the other shapes, both raycast forms on
   pedestrians at the cull's boundary, then their device times, the
   redesigned forms' beside their second designs', also on the state the
   rollouts left;
6. ``libm``: the C-library trig kernel (``cos``, ``sin``, ``atan2`` as the
   host's C library computes them) against the library on the CPU at the
   step's shapes, and its device time;
7. ``evaluate``: the port's evaluation driver, greedy TD3 on suite
   ``train`` with the exported ``final_full`` actor, 1,024 envs x 500 steps,
   through the driver's captured graph: the wrappers' calls on that run,
   and each kernel form once a replay in a profiler window of its graph;
8. ``train``: the default configuration's training path at full width
   (16,384 envs, 32 updates x batch 4,096, bfloat16 replay, the epsilon
   spectrum of the flagship recipe) through the functions ``drivers/train``
   calls: one warm-up and one timed chunk of 64 steps, each kernel's
   launches, the step's time split, peak memory; then the card against
   the CPU at 256 envs, every draw made once on the CPU: env states and
   the replay ring bit-equal; before each step the card's learner state
   is set to the CPU's, and every update the card's trainer makes is held
   to the CPU's update of the same state within the derived float32 bound
   (``utils/error_bounds.py``);
9. ``train_pallas``: the ``bench.py`` cell's configuration
   (``risk_backend="pallas"``) at the same width through the eager loop
   (``rollout_chunk``, with the step's time split), one warm-up and one
   timed chunk;
   ``jitted``: the main path, ``Trainer.make_jitted`` (one captured CUDA
   graph of the step) against the eager chunk from one seed, each side
   1 + 2 chunks of the ``bench.py`` cell as
   ``scripts/bench_torch_train.py`` builds it (0 differing elements in
   every state field, the generator's state included, after the first
   and the last chunk; equal summaries), then ``train_forms``' two paths
   (1 + 1 chunks), DDPG, SAC and DQN at ``train_agents``' widths (one
   chunk, the learn gate opening inside it), the TD3 evaluation at 1,024
   envs x 500 steps, and ``drivers/train``'s collapse restart and
   ``--resume`` at 256 envs, through the graph and eagerly (the same
   events and agent files); ms a step on the host clock and on CUDA
   events, a profiler window of each side (device operations a step,
   busy share), peak memory, the capture's seconds; each kernel form of
   the path launched once a step by the replays in the profiler's trace
   (by the kernels' names), the same as an eager step, and each wrapper
   called by the eager steps and the capture only;
10. ``train_forms``: the Pallas raycast with the Pallas tracker and the
   three noise knobs, and the strict quirks, each one timed chunk of
   training at 1,024 envs;
11. ``bf16_learner``: TD3's bfloat16 learner, card against CPU, each
   update within the derived bfloat16 bound;
12. ``tabular``: ``drivers/train_tabular`` (Q-learning, SARSA) on the card;
13. ``train_agents``: DDPG, SAC and DQN the same way, each at the widths of
   its JAX record (DDPG 2,048 envs x 16 updates x batch 1,024 on
   ``crowd_dense``; SAC and DQN 512 envs x 32 updates x batch 64 on the
   simple env), one timed chunk each, then the card against the CPU at
   64 envs;
14. ``evaluate_agents``: greedy evaluation of the three committed policies
   (``crowdnav_tpu_torch/assets/``) through ``drivers/evaluate``, 256 envs
   x 500 steps, each Wilson 95% interval held to overlap its JAX record's,
   the launches counted as ``evaluate``'s;
15. ``sharded``: the ``bench.py`` cell's training as 2 gloo ranks on the
   one card (``parallel/mesh.ShardedTrainer`` through ``drivers/train``
   under ``--multihost``; 8,192 envs and batch 2,048 a rank, each rank a
   process): a warm-up and a timed chunk, the rate, the step's split and
   the all-reduce's time, each rank's launches, each rank's replay ring
   the 1-rank ring's block count; the ranks' agent states
   bit-equal, and their last update held to the 1-rank update of the same
   global batch within the derived bound. Two ranks share one card: a
   check of the path, not a scaling figure;
16. ``multihost_nccl``: ``drivers/train --multihost --num-processes 1`` on
   NCCL with ``--profile-dir``: 3 chunks at 1,024 envs, and what the
   profiler's trace of chunk 2 saw on the card;
17. ``deploy``: ``drivers/deploy_realworld`` in loopback, 50 ticks on the
   card and on the CPU: the raycast kernel and the tracker kernel at
   K = 1 once a tick, every observation bit-equal to the CPU's, every
   action within the actor's derived bound, the tick's latency;
18. ``trajectory``: ``viz.trace_rollout`` of one env under the goal seeker
   and its ``TrajectoryWriter`` CSV, byte-equal to the CPU's;
19. ``native``: the port's C++ host simulator (``native/fastsim.cpp``),
   built by ``g++`` on the card's host, against the card's world step and
   raycast at 16,384 envs of ``crowd_dense``/``crowd`` for 64 steps, the
   native batch set to the card's state before each step: pose,
   pedestrians, scans and done codes within ``tests/test_native.py``'s
   tolerances; the native step's host ms beside the card's;
20. ``oracle``: the ten scenarios of ``tests/test_parity.py``
   (``parity/scenarios.py``): the port's ``CrowdEnv`` on the card, one
   env, against the port's NumPy oracle on the host;
21. ``kernels``: one line with each kernel form's times, bounds and
   launches on every path.

Before them, ``step_parity`` holds the env step on the card against the
step on the CPU: 1,024 envs x 40 steps of ``crowd_dense``/``crowd`` with
the ``final_full`` actor's greedy actions, 20 steps each of the Pallas
backends with the three noise knobs and of the strict quirks, and 1,024
envs x 50 steps of ``SimpleEnv`` on ``crowd_sparse``/``random`` in each
action mode (and 20 steps with the strict quirks, the Pallas raycast and
the noise knobs), both sides stepped from the same CPU state with the
same draws every step, every observation and state element bit-equal.
Then ``scenario_parity`` does the same, 256 envs x 30 steps with
``max_steps`` 20, on every preset the CPU tests hold to the JAX package
(``tests/torch_presets.py``): the 23 scenarios of the evaluation suites
other than ``train`` and the pillars world, the six ablation arms and the
four robots on ``crowd_dense``/``crowd``, the waffle with the TTC-only CP
on ``test_12``/``random``, suite ``20`` again under both kernels' Pallas
forms, and ``SimpleEnv`` in both action modes on ``test_20``/``random_20``
and ``crowd_sparse``/``crowd`` and with the waffle; it prints each case's
differing and compared elements, first difference and auto-resets, and
the kernels' launches by form.

Kernel times are device time alone (``kernels/timing.py``): a burst of
wrapper calls queued behind ``torch.cuda._sleep``, over input copies that
keep each launch's bytes out of the L2 cache, at 1,024 envs (the evaluate
path) and 16,384 envs (the training batch of ``bench.py``). ``ms`` and
``bound_ms`` are at 16,384 envs; ``launches`` counts the form's kernels
in the profiler's trace of the replays of the graph path that runs the
form (``launches_path``: ``jitted_cell``, the main path, and
``jitted_<path>`` the others), ``launches_<path>`` every
training run, ``launches_evaluate`` the TD3 evaluation,
``launches_train_<algo>`` and ``launches_evaluate_<algo>`` the other
learners' runs (the evaluate driver's, which replays a graph, in a
profiler window of its replays), ``launches_sharded_rank<r>``,
``launches_multihost_nccl``,
``launches_deploy`` and ``launches_trajectory`` the deployment and audit
paths (the last three with their resets' launches), ``launches_native``
and ``launches_oracle`` the host simulator's comparison and the oracle's
scenarios, ``launches_step_parity`` and ``launches_scenario_parity`` the
card's side of the two card-against-CPU phases, ``launches_rollout_pallas``
and ``launches_rollout_strict`` the ``forms_rollout`` phase (the path of
the raycast's Pallas form and of the tracker's strict form).
``second_design_device_ms_<shape>`` is the second design's device time on
the same inputs in the same run. A raycast form's ``bound_ms`` counts the
pair tests of the pedestrians within its cull's reach only, the work the
function needs; ``bound_ms_all_pairs`` counts every pair, as the shares
before the cull did.

The last line is ``{"ok": true, "device": {...}}``. Any failed phase raises
and the script exits non-zero; without a CUDA device it fails at once.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import numpy as np

N_BIG = 16384
N_ODD = 1000
AGENT_ENVS = 512        # SAC and DQN (results/r2/README.md:3-5)
EVAL_20_ENVS = 512      # suites 20 and hard (scripts/r5_chain_t.txt:6-7)
EVAL_ENVS = 1024
EVAL_STEPS = 500
SHAPES = (EVAL_ENVS, N_BIG)
JAX_RECORD = (5655, 5766)   # results/r5/final_full/td3_training_test.csv
ROOT = os.path.dirname(os.path.abspath(__file__))
ACTOR_FILE = os.path.join(ROOT, "crowdnav_tpu_torch", "assets",
                          "final_full_actor.npz")
FIRST_DESIGN = os.path.join(ROOT, "scripts", "first_design_kernels")
# C interface of the first designs: every pointer, then the sizes, the
# float32 constants and the stream
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
FIRST_DESIGN_SIGNATURES = {
    "crowdnav_raycast": [_P] * 7 + [_I] * 3 + [_F] * 4 + [_P],
    "crowdnav_track_cp_topk": [_P] * 24 + [_I] * 4 + [_F] * 8 + [_P],
}
# the kernels as they were before the raycast's cull by reach and the
# strict top-K's closed-form slot, kept unchanged as the yardstick of
# those redesigns (built against the package's libm_f32.cuh, which the
# redesigns left as it was), and their C interface
SECOND_DESIGN = os.path.join(ROOT, "scripts", "second_design_kernels")
SECOND_DESIGN_SIGNATURES = {
    "crowdnav_raycast": [_P] * 7 + [_I] * 7 + [_F] * 4 + [_P],
    "crowdnav_raycast_pallas": [_P] * 4 + [_I] * 7 + [_F] * 5 + [_P],
    "crowdnav_track_cp_topk": [_P] + [_I] * 6 + [_F] * 8 + [_I, _P],
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


# the kernels (and kernel forms) of the default configuration's paths
XLA_KERNELS = ("raycast", "track_cp_topk", "libm_sincos", "libm_atan2")


def _reset_launches():
    from crowdnav_tpu_torch.ops.lidar import scan_batch, scan_batch_pallas
    from crowdnav_tpu_torch.ops.risk_kernel import track_cp_topk_batch
    from crowdnav_tpu_torch.utils import numerics as nm
    for fn in (scan_batch, scan_batch_pallas, track_cp_topk_batch,
               nm.sincos, nm.atan2):
        fn.launches = 0
    for form in track_cp_topk_batch.form_launches:
        track_cp_topk_batch.form_launches[form] = 0


def _read_launches():
    """Launches of each kernel form: the raycast's XLA and Pallas forms,
    the tracker kernel's XLA, Pallas and strict forms, the trig."""
    from crowdnav_tpu_torch.ops.lidar import scan_batch, scan_batch_pallas
    from crowdnav_tpu_torch.ops.risk_kernel import track_cp_topk_batch
    from crowdnav_tpu_torch.utils import numerics as nm
    forms = track_cp_topk_batch.form_launches
    return {"raycast": scan_batch.launches,
            "raycast_pallas": scan_batch_pallas.launches,
            "track_cp_topk": forms["xla"],
            "track_cp_topk_pallas": forms["pallas"],
            "track_cp_topk_strict": forms["strict"],
            "libm_sincos": nm.sincos.launches,
            "libm_atan2": nm.atan2.launches}


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
    """The port's library and the earlier designs' two libraries, their
    three ``nvcc`` calls started together; returns the first and second
    designs' libraries."""
    from crowdnav_tpu_torch.kernels import build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        first = pool.submit(build.compile_library, FIRST_DESIGN)
        second = pool.submit(build.compile_library, SECOND_DESIGN,
                             (build.CSRC,))
        build.library()
        first_path, first_s = first.result()
        second_path, second_s = second.result()
    first_lib = build.load(first_path, FIRST_DESIGN_SIGNATURES)
    second_lib = build.load(second_path, SECOND_DESIGN_SIGNATURES)
    emit({"phase": "build", "nvcc_s": build.build_seconds,
          "first_design_nvcc_s": first_s, "second_design_nvcc_s": second_s,
          "load_s": round(time.perf_counter() - t0, 3),
          "sources": [os.path.relpath(s, ROOT) for s in build.sources()],
          "first_design_sources": [os.path.relpath(s, ROOT) for s in
                                   build.sources(FIRST_DESIGN)],
          "second_design_sources": [os.path.relpath(s, ROOT) for s in
                                    build.sources(SECOND_DESIGN)],
          "flags": build.NVCC_FLAGS})
    return first_lib, second_lib


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


def second_design_raycast(torch, lib, pos, cy, sy, ca, sa, peds, half, r2,
                          min_range, max_range, beams_per_thread=None):
    """The raycast's XLA form without the cull by reach (its launch
    geometry, its shared memory without the reach masks)."""
    from crowdnav_tpu_torch.kernels import build, launch
    ptrs, out = build.raycast_buffers(pos, cy, sy, ca, sa, peds)
    n, b = out.shape
    p = peds.shape[1]
    geo = launch.raycast_launch(n, b, p, beams_per_thread=beams_per_thread)
    code = lib.crowdnav_raycast(
        *ptrs, out.data_ptr(), n, b, p, geo.grid, geo.threads,
        geo.beams_per_thread, geo.envs_per_block * (16 + 12 * p), half, r2,
        min_range, max_range, _stream(torch, pos))
    if code:
        raise RuntimeError(f"second-design raycast: CUDA error {code}")
    return out


def second_design_raycast_pallas(torch, lib, pos, yaw, peds, n_beams, half,
                                 r2, min_range, max_range,
                                 beams_per_thread=None):
    """The raycast's Pallas form without the cull by reach."""
    from crowdnav_tpu_torch.kernels import build, launch
    from crowdnav_tpu_torch.ops.lidar import DEG
    ptrs, out = build.raycast_pallas_buffers(pos, yaw, peds, n_beams)
    n, p = pos.shape[0], peds.shape[1]
    geo = launch.raycast_launch(n, n_beams, p,
                                beams_per_thread=beams_per_thread)
    code = lib.crowdnav_raycast_pallas(
        *ptrs, out.data_ptr(), n, n_beams, p, geo.grid, geo.threads,
        geo.beams_per_thread, geo.envs_per_block * (16 + 12 * p), half, r2,
        min_range, max_range, DEG, _stream(torch, pos))
    if code:
        raise RuntimeError(f"second-design raycast_pallas: CUDA error {code}")
    return out


def second_design_track(torch, lib, cfg, *tensors):
    """The tracker kernel's strict form with its second walk over the
    tracks for its slots."""
    from crowdnav_tpu_torch.kernels import build, launch
    ptrs, outs, consts = build.track_cp_topk_buffers(cfg, *tensors)
    n, S = tensors[0].shape
    geo = launch.track_cp_topk_launch(n)
    addrs = (ctypes.c_void_p * 24)(*ptrs, *(o.data_ptr() for o in outs))
    code = lib.crowdnav_track_cp_topk(
        addrs, n, S, tensors[4].shape[1], cfg.k_obstacles, geo.grid,
        geo.envs_per_block, *consts, build.TRACK_FORMS["strict"],
        _stream(torch, tensors[0]))
    if code:
        raise RuntimeError(f"second-design tracker: CUDA error {code}")
    return outs[:7], outs[7:]


def _timings(kernel, plain, args, plain_args, nbytes, **designs):
    """Device ms of the kernel and of each earlier design in ``designs``
    (``<name>_device_ms``) on copies of ``args``, and of the plain version
    on ``plain_args``."""
    from crowdnav_tpu_torch.kernels import timing
    sets = timing.clone_args(args, timing.copies_for(nbytes))
    out = {"device_ms": timing.device_ms(kernel, sets, reps=100),
           "plain_ms": timing.stream_ms(plain, plain_args)}
    for name, fn in designs.items():
        out[f"{name}_device_ms"] = timing.device_ms(fn, sets, reps=100)
    return out


def _max_abs(a, b, torch):
    if a.dtype == torch.bool:
        return float((a != b).sum())
    d = (a.double() - b.double()).abs()
    both_inf = torch.isinf(a) & torch.isinf(b) & (a == b)
    return float(torch.where(both_inf, 0.0, d).max()) if d.numel() else 0.0


def phase_raycast(torch, dev, first_lib, second_lib):
    from crowdnav_tpu_torch.envs.config import make_config
    from crowdnav_tpu_torch.kernels import build
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
             "n1024_p14": population(EVAL_ENVS, 14),
             # SAC and DQN on crowd_sparse
             "n512_p6": population(AGENT_ENVS, 6),
             "n16384_p6": population(N_BIG, 6)}
    # suite 20 and the test_20 rows of suite hard: the 5 m room (inner
    # half 2.45 m), 20 pedestrians
    big = make_config("test_20", "random_20")
    hb = big.room_half_inner - big.robot_radius
    for n in (EVAL_20_ENVS, N_BIG):
        cases[f"n{n}_p20_room5"] = (u((n, 2), -hb, hb),
                                    u((n,), -math.pi, math.pi),
                                    u((n, 20, 2), -hb, hb))
    case_cfg = {name: big if name.endswith("room5") else cfg
                for name in cases}
    consts = dict(ped_radius=cfg.ped_radius, room_half=h,
                  max_range=cfg.max_scan_range,
                  min_range=cfg.lidar_min_range, n_scans=cfg.n_scans)
    ca, sa = lidar.beam_tables(cfg.n_scans, dev)

    def plain_args(pos, yaw, peds, c=cfg):
        # the yaw terms as scan_batch computes them (the C library's trig)
        return (pos, nm.cos(yaw), nm.sin(yaw), ca, sa, peds,
                nm.f32(c.room_half_inner), nm.f32(c.ped_radius ** 2),
                nm.f32(c.lidar_min_range), nm.f32(c.max_scan_range))

    result = {}
    for name, (pos, yaw, peds) in cases.items():
        c = case_cfg[name]
        got = lidar.scan_batch(pos, yaw, peds, **dict(
            consts, room_half=c.room_half_inner))
        ref = lidar.raycast_plain(*plain_args(pos, yaw, peds, c))
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

    def second(*a):
        return second_design_raycast(torch, second_lib, *a)

    shapes = {}
    for key, case in ((EVAL_ENVS, "n1024_p14"), (N_BIG, "n16384_p14"),
                      ("n512_p6", "n512_p6"), ("n16384_p6", "n16384_p6"),
                      (f"n{EVAL_20_ENVS}_p20_room5",
                       f"n{EVAL_20_ENVS}_p20_room5"),
                      ("n16384_p20_room5", "n16384_p20_room5")):
        args = plain_args(*cases[case], case_cfg[case])
        got = build.raycast(*args)
        for design, fn in (("first", first), ("second", second)):
            if not torch.equal(got, fn(*args)):
                raise AssertionError(f"raycast {case}: the {design} design "
                                     f"differs")
        work = _raycast_work(args, pallas=False)
        shapes[key] = dict(_timings(build.raycast, lidar.raycast_plain, args,
                                    args, work["bytes"], first_design=first,
                                    second_design=second), **work)
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
    over. Then the strict top-K's tie cases, each track on a segment of
    its own distance with the robot still, so that its CP is the distance
    CP (0 beyond the lidar's range): 6 every track valid, all CPs equal;
    7 K tracks, all CPs equal; 8 a tie group across rank K above lower
    distinct CPs; 9 more zero CPs (-0 scores) than K; 10 at most K
    tracks, zeros and ties."""
    from crowdnav_tpu_torch.envs.world import TrackState
    from crowdnav_tpu_torch.ops.risk import Segments
    S, T, K, n = cfg.max_segments, cfg.max_tracks, cfg.k_obstacles, 11
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
    cdist = torch.full((n, S), 0.3, device=dev)
    # the tie cases: segment s at (x_s, 0.8), track s on it
    row = torch.stack([torch.linspace(-1.2, 1.2, S, device=dev),
                       torch.full((S,), 0.8, device=dev)], -1)
    ties = {6: [0.3] * T, 7: [0.3] * K,
            8: [0.55, 0.5, 0.45, 0.42] + [0.3] * 6 + [0.1, 0.15, 0.2],
            9: [0.7] * (K + 2) + [0.3] * 3,
            10: [0.7, 0.7, 0.3, 0.3, 0.2][:K]}
    for e, dists in ties.items():
        k = min(len(dists), T)
        seg_valid[e, :k] = True
        cpos[e] = row
        cdist[e, :k] = torch.tensor(dists[:k], device=dev)
    obstacle = seg_valid.clone()
    obstacle[6:] = False          # no insertion: the valid tracks are given
    segs = Segments(valid=seg_valid, is_obstacle=obstacle,
                    confirmed=seg_valid, center_pos=cpos, center_dist=cdist,
                    count=seg_valid.to(torch.int32) * 5)
    t_valid = torch.zeros((n, T), dtype=torch.bool, device=dev)
    t_valid[1] = True
    t_valid[3, 0] = True
    t_valid[4, :12] = True
    t_valid[5] = True
    t_valid[6:, :] = seg_valid[6:, :T]
    tpos = z(n, T, 2)
    tpos[3, 0] = 0.5
    tpos[4, :12] = torch.tensor([0.31, 0.2], device=dev)
    tpos[5] = cpos[5, :T] + 0.01
    tpos[6:] = row[:T]
    tracks = TrackState(valid=t_valid, pos=tpos, prev_pos=z(n, T, 2),
                        has_prev=t_valid.clone(),
                        dist=torch.full((n, T), 0.4, device=dev),
                        speed=torch.full((n, T), 0.2, device=dev),
                        vel=z(n, T, 2))
    pos = torch.tensor([[0.1, -0.1]], device=dev).repeat(n, 1)
    prev = torch.tensor([[0.08, -0.12]], device=dev).repeat(n, 1)
    prev[6:] = pos[6:]
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
        shapes[n] = dict(_timings(build.track_cp_topk, plain, args,
                                  cases[case], nbytes, first_design=first),
                         bound_ms=bound, bound_by=bound_by, bytes=nbytes,
                         ops=ops)
    emit({"phase": "track_cp_topk", "cases": result, "timing": TIMING,
          "shapes": shapes})
    return {"max_abs": worst, "shapes": shapes}


def _same(torch, got, ref):
    """Elements of two lists of tensors that differ bit for bit."""
    return sum(_n_differ(torch, g, r) for g, r in zip(got, ref))


def _moving_population(torch, cfg, n, dev, seed):
    """:func:`_random_population` with segment centres off the 1/8 grid and
    every track near a segment, so that tracks match and move."""
    segs, tracks, pos, prev, cc = _random_population(torch, cfg, n, dev,
                                                     seed)
    g = torch.Generator(device=dev).manual_seed(100 + seed)
    S, T = cfg.max_segments, cfg.max_tracks
    cpos = torch.rand((n, S, 2), generator=g, device=dev) * 2.4 - 1.2
    pick = torch.randint(0, S, (n, T), generator=g, device=dev)
    near = torch.gather(cpos, 1, pick[..., None].expand(n, T, 2))
    tpos = near + torch.randn((n, T, 2), generator=g, device=dev) * 0.02
    segs = segs._replace(center_pos=cpos)
    tracks = tracks.replace(
        pos=tpos,
        prev_pos=tpos + torch.randn((n, T, 2), generator=g, device=dev)
        * 0.03)
    return segs, tracks, pos, prev, cc


def _reach_population(torch, cfg, n, p, dev, seed):
    """``n`` poses in ``cfg``'s room and ``p`` pedestrians each at the
    raycast's cull boundary (as ``tests/test_torch_raycast_cull.py``): four
    in five at the reach ``max_range + r`` or at the kernel's threshold
    (``launch.raycast_reach2``), a few ulp and 1 mm either side, or inside
    the robot's circle, along a beam's direction, half a beam off it or in
    between; the rest uniform in the room."""
    from crowdnav_tpu_torch.kernels import launch
    from crowdnav_tpu_torch.utils import numerics as nm
    rng = np.random.default_rng(seed)
    h = cfg.room_half_inner - cfg.robot_radius
    pos = rng.uniform(-h, h, (n, 2))
    yaw = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    peds = rng.uniform(-h, h, (n, p, 2))
    r2, max_range = nm.f32(cfg.ped_radius ** 2), nm.f32(cfg.max_scan_range)
    edge = max_range + math.sqrt(r2)
    reach = math.sqrt(launch.raycast_reach2(r2, max_range))
    ulp = float(np.spacing(np.float32(edge)))
    dists = np.array(
        [edge + k * ulp for k in (-4, -2, -1, 0, 1, 2, 3, 4, 6, 8, 16)]
        + [reach + k * ulp for k in (-4, -2, -1, 0, 1, 2, 4)]
        + [edge - 1e-3, edge + 1e-3, reach - 1e-3, reach + 1e-3,
           0.5 * cfg.ped_radius])
    d = dists[rng.integers(0, len(dists), (n, p))]
    off = np.where(rng.uniform(size=(n, p)) < 0.5, 0.0,
                   rng.choice([0.5, -0.25, 0.25], (n, p)))
    a = yaw[:, None].astype(np.float64) - (
        rng.integers(0, cfg.n_scans, (n, p)) + off) * (math.pi / 180.0)
    placed = pos[:, None, :] + d[..., None] * np.stack([np.cos(a),
                                                        np.sin(a)], -1)
    keep = rng.uniform(size=(n, p, 1)) < 0.8
    peds = np.where(keep, placed, peds)

    def t(x):
        return torch.from_numpy(np.asarray(x, np.float32)).to(dev)
    return t(pos), t(yaw), t(peds)


def _raycast_work(args, pallas):
    """The work of one raycast form on ``args`` (its wrapper's arguments)
    and its bound: ``bound_ms`` counts the pair tests and hits of the
    pedestrians in reach only (``kernels/roofline.py``), the work the
    function needs since its cull by reach; ``bound_ms_all_pairs`` counts
    them for every pedestrian, the count before the cull (the earlier
    designs' shares)."""
    from crowdnav_tpu_torch.kernels import launch, roofline
    if pallas:
        pos, yaw, peds, b, _, r2, _, max_range = args

        def hits(reach2=None):
            return roofline.raycast_pallas_hits(pos, yaw, peds, b, r2,
                                                reach2)

        def work(h, in_reach=None):
            nbytes, ops32, ops64 = roofline.raycast_pallas_work(
                n, b, p, h, in_reach)
            return ({"bytes": nbytes, "f32_ops": ops32, "f64_ops": ops64},
                    roofline.mixed_bound_ms(nbytes, ops32, ops64))
    else:
        pos, peds, r2, max_range = args[0], args[5], args[7], args[9]
        b = args[3].shape[0]

        def hits(reach2=None):
            return roofline.raycast_hits(*args[:6], r2, reach2)

        def work(h, in_reach=None):
            nbytes, ops = roofline.raycast_work(n, b, p, h, in_reach)
            return ({"bytes": nbytes, "ops": ops},
                    roofline.bound_ms(nbytes, ops))
    n, p = peds.shape[:2]
    reach2 = launch.raycast_reach2(r2, max_range)
    in_reach = roofline.raycast_in_reach(pos, peds, reach2)
    culled_hits = hits(reach2)
    out, (bound, by) = work(culled_hits, in_reach)
    all_hits = hits()
    counts, (bound_all, by_all) = work(all_hits)
    out.update(bound_ms=bound, bound_by=by, hits=culled_hits,
               peds_in_reach=in_reach, bound_ms_all_pairs=bound_all,
               bound_by_all_pairs=by_all, hits_all_pairs=all_hits,
               **{f"{k}_all_pairs": v for k, v in counts.items()
                  if k != "bytes"})
    return out


def _raycast_shape(torch, kernel, plain, args, pallas, **designs):
    """Device, plain and earlier designs' ms of one raycast form on
    ``args``, with its work and bound (:func:`_raycast_work`)."""
    work = _raycast_work(args, pallas)
    return dict(_timings(kernel, plain, args, args, work["bytes"],
                         **designs), library_ms=None, **work)


def phase_kernel_forms(torch, dev, second_lib, rollouts):
    """The kernels' Pallas and strict forms against their plain versions on
    the card, bit for bit: the raycast's Pallas form (P = 14, the
    placeholder, P = 6, P = 20 in the 5 m room) and the tracker kernel's
    Pallas and strict forms (random, moving and edge populations, K = 1 and
    sizes taken at run time), at 1,024 and 16,384 envs; both raycast forms
    on pedestrians at the cull's boundary (``_reach_population``: P = 6,
    14, 20, the 0.6 m lidar in the 3 m room, the 3.5 m one in the 5 m
    room). Then each form's device time, plain time and bound at the main
    path's shapes, and beside the redesigned forms (the raycast's two
    forms, the strict tracker) the device time of their second design
    (``scripts/second_design_kernels/``) on the same inputs: on uniform
    populations and on the state that ``rollouts``
    (:func:`phase_forms_rollout`) left, the positions the env itself
    produces."""
    from crowdnav_tpu_torch.envs import crowd_env
    from crowdnav_tpu_torch.envs.config import make_config
    from crowdnav_tpu_torch.kernels import build, roofline
    from crowdnav_tpu_torch.ops import lidar, risk
    from crowdnav_tpu_torch.ops.risk_kernel import track_cp_topk_batch
    from crowdnav_tpu_torch.utils import numerics as nm
    cfg = make_config("crowd_dense", "crowd")
    big = make_config("test_20", "random_20")
    waffle = make_config("test_12", "random", robot="waffle")
    g = torch.Generator(device=dev).manual_seed(21)

    def u(shape, lo, hi):
        return torch.rand(shape, generator=g, device=dev) * (hi - lo) + lo

    def second_pallas(*a):
        return second_design_raycast_pallas(torch, second_lib, *a)

    def second_xla(*a):
        return second_design_raycast(torch, second_lib, *a)

    def pallas_args(c, pos, yaw, peds):
        return (pos, yaw, peds, c.n_scans,
                *lidar._consts(c.ped_radius, c.room_half_inner,
                               c.max_scan_range, c.lidar_min_range))

    def xla_args(c, pos, yaw, peds):
        ca, sa = lidar.beam_tables(c.n_scans, dev)
        return (pos, nm.cos(yaw), nm.sin(yaw), ca, sa, peds,
                *lidar._consts(c.ped_radius, c.room_half_inner,
                               c.max_scan_range, c.lidar_min_range))

    def check(name, got, ref):
        torch.cuda.synchronize()
        bad = _n_differ(torch, got, ref)
        if bad:
            raise AssertionError(f"{name}: {bad} elements differ from the "
                                 f"plain version")
        return bad

    def pallas_shape(c, args, name):
        ref = lidar.raycast_pallas_plain(*args)
        check(f"raycast_pallas {name}", build.raycast_pallas(*args), ref)
        check(f"raycast_pallas {name}, second design", second_pallas(*args),
              ref)
        return _raycast_shape(torch, build.raycast_pallas,
                              lidar.raycast_pallas_plain, args, True,
                              second_design=second_pallas)

    def xla_shape(c, args, name):
        ref = lidar.raycast_plain(*args)
        check(f"raycast {name}", build.raycast(*args), ref)
        check(f"raycast {name}, second design", second_xla(*args), ref)
        return _raycast_shape(torch, build.raycast, lidar.raycast_plain,
                              args, False, second_design=second_xla)

    out = {"raycast_pallas": {"cases": {}, "shapes": {}},
           "raycast_xla": {"cases": {}, "shapes": {}},
           "track_cp_topk_pallas": {"cases": {}, "shapes": {}},
           "track_cp_topk_strict": {"cases": {}, "shapes": {}}}
    rc, rx = out["raycast_pallas"], out["raycast_xla"]
    for n in SHAPES:
        for p, c in ((14, cfg), (0, cfg), (6, cfg), (20, big)):
            h = c.room_half_inner - c.robot_radius
            pos, yaw = u((n, 2), -h, h), u((n,), -math.pi, math.pi)
            peds = torch.full((n, 1, 2), 1e3, device=dev) if p == 0 \
                else u((n, p, 2), -h, h)
            args = pallas_args(c, pos, yaw, peds)
            name = f"n{n}_p{p}" + ("_room5" if c is big else "")
            ref = lidar.raycast_pallas_plain(*args)
            rc["cases"][name] = {"differing": check(
                f"raycast_pallas {name}", build.raycast_pallas(*args), ref)}
            check(f"raycast_pallas {name}, second design",
                  second_pallas(*args), ref)
            if p in (14, 20) or (p == 6 and n == N_BIG):
                rc["shapes"][n if p == 14 else name] = pallas_shape(c, args,
                                                                    name)
    # pedestrians at the cull's boundary, both forms
    for p, c, room in ((6, cfg, "room3"), (14, cfg, "room3"),
                       (20, big, "room5"), (20, waffle, "room5_waffle")):
        pop = _reach_population(torch, c, N_BIG, p, dev, seed=60 + p)
        name = f"reach_n{N_BIG}_p{p}_{room}"
        args = pallas_args(c, *pop)
        rc["cases"][name] = {"differing": check(
            f"raycast_pallas {name}", build.raycast_pallas(*args),
            lidar.raycast_pallas_plain(*args))}
        args = xla_args(c, *pop)
        rx["cases"][name] = {"differing": check(
            f"raycast {name}", build.raycast(*args),
            lidar.raycast_plain(*args))}
    # the state the env's own rollouts left
    for form, res, shape in (("rollout_pallas", rc, pallas_shape),
                             ("rollout_strict", rx, xla_shape)):
        c = rollouts[form]["cfg"]
        st = rollouts[form]["state"]
        args = (pallas_args if res is rc else xla_args)(c, st.pos, st.yaw,
                                                          st.ped_pos)
        key = f"state_n{N_BIG}_p{c.n_peds}"
        res["shapes"][key] = shape(c, args, key)

    S, T, K = cfg.max_segments, cfg.max_tracks, cfg.k_obstacles
    for form, over in (("pallas", {"risk_backend": "pallas"}),
                       ("strict", {"strict_quirks": True})):
        fc = dataclasses.replace(cfg, **over)
        res = out[f"track_cp_topk_{form}"]
        cases = {f"random_n{n}": _random_population(torch, cfg, n, dev,
                                                    30 + i)
                 for i, n in enumerate((N_ODD,) + SHAPES)}
        cases.update({f"moving_n{n}": _moving_population(torch, cfg, n, dev,
                                                         40 + i)
                      for i, n in enumerate(SHAPES)})
        cases["edges"] = _edge_population(torch, cfg, dev)
        cfgs = dict.fromkeys(cases, fc)
        for name, other in (("k1", dict(k_obstacles=1)),
                            ("t20_k5", dict(max_tracks=20, k_obstacles=5))):
            oc = dataclasses.replace(fc, **other)
            cases[f"random_n{N_ODD}_{name}"] = _random_population(
                torch, oc, N_ODD, dev, 50)
            cases[f"edges_{name}"] = _edge_population(torch, oc, dev)
            cfgs[f"random_n{N_ODD}_{name}"] = cfgs[f"edges_{name}"] = oc
        for name, args in cases.items():
            before = track_cp_topk_batch.form_launches[form]
            got = _flatten(track_cp_topk_batch(cfgs[name], *args))
            ref = _flatten(risk.track_cp_topk(cfgs[name], *args, form=form))
            torch.cuda.synchronize()
            if track_cp_topk_batch.form_launches[form] != before + 1:
                raise AssertionError(f"track_cp_topk_{form} {name}: the "
                                     f"wrapper did not launch the form")
            bad = _same(torch, got, ref)
            res["cases"][name] = {"differing": bad}
            if bad:
                raise AssertionError(f"track_cp_topk_{form} {name}: {bad} "
                                     f"elements differ from the plain "
                                     f"version")
        timed = {n: cases[f"moving_n{n}"] for n in SHAPES}
        if form == "strict":
            # the tracker's inputs of the step after the strict rollout
            c, st = rollouts["rollout_strict"]["cfg"], \
                rollouts["rollout_strict"]["state"]
            scans, points = crowd_env._sense(c, st)
            timed[f"state_n{N_BIG}"] = (
                risk.segment_scans(c, scans, points), st.tracks, st.pos,
                st.prev_pos, torch.ones(N_BIG, dtype=torch.bool, device=dev))
        for key, (segs, tracks, pos, prev, cc) in timed.items():
            n = pos.shape[0]
            kargs = (fc, segs.confirmed, segs.is_obstacle, segs.center_pos,
                     segs.center_dist, tracks.valid, tracks.pos,
                     tracks.prev_pos, tracks.dist, tracks.speed, tracks.vel,
                     pos, prev, cc)
            nbytes, ops = roofline.track_cp_topk_work(n, S, T, K, form)
            bound, by = roofline.bound_ms(nbytes, ops)

            def kernel(*a, form=form):
                return build.track_cp_topk(*a, form=form)

            def plain(*a, form=form, fc=fc):
                return risk.track_cp_topk(fc, *a, form=form)
            designs = {}
            if form == "strict":
                def second(*a):
                    return second_design_track(torch, second_lib, *a)
                new, old = kernel(*kargs), second(*kargs)
                if _same(torch, [*new[0], *new[1]], [*old[0], *old[1]]):
                    raise AssertionError(f"track_cp_topk_strict {key}: the "
                                         f"second design differs")
                designs["second_design"] = second
            res["shapes"][n if isinstance(key, int) else key] = dict(
                _timings(kernel, plain, kargs, (segs, tracks, pos, prev, cc),
                         nbytes, **designs),
                bound_ms=bound, bound_by=by, bytes=nbytes, ops=ops,
                library_ms=None)
    for r in out.values():
        r["max_abs"] = 0.0
    emit({"phase": "kernel_forms", "timing": TIMING, **out})
    return out


ROLLOUT_STEPS = 64
# the env of bench.py --with-pallas-lidar, and the strict quirks
ROLLOUT_FORMS = {"rollout_pallas": dict(risk_backend="pallas",
                                        lidar_backend="pallas"),
                 "rollout_strict": dict(strict_quirks=True)}
ROLLOUT_KERNELS = {"rollout_pallas": ("raycast_pallas",
                                      "track_cp_topk_pallas"),
                   "rollout_strict": ("raycast", "track_cp_topk_strict")}


def phase_forms_rollout(torch, dev, forms=tuple(ROLLOUT_FORMS)):
    """The redesigned forms' path at full width, with no learner:
    ``CrowdEnv.step_batch`` on ``crowd_dense``/``crowd`` (jitter 1.0) at
    16,384 envs x 64 steps of seeded uniform actions, under both kernels'
    Pallas forms (the env of ``bench.py --with-pallas-lidar``) and under
    the strict quirks. The launch counts are set to 0 after the reset and
    read after the last step: each case's kernels launch once a step. The
    env's ms a step: CUDA events around each ``step_batch`` (the host's
    enqueue included, which sets the step's time), and the host clock over
    the 64 steps. ``forms``: the cases to run, of ``ROLLOUT_FORMS``.
    Returns each case's launches, steps, config and last state."""
    from crowdnav_tpu_torch.envs.config import make_config
    from crowdnav_tpu_torch.envs.crowd_env import CrowdEnv
    out, report = {}, {}
    lo = torch.tensor([0.0, -2.0], device=dev)
    span = torch.tensor([0.22, 4.0], device=dev)
    for name in forms:
        over = ROLLOUT_FORMS[name]
        cfg = make_config("crowd_dense", "crowd", jitter=1.0, **over)
        env = CrowdEnv(cfg, device=dev, seed=0)
        gen = torch.Generator(device=dev).manual_seed(5)
        state, _ = env.reset(N_BIG, gen)
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True))
                  for _ in range(ROLLOUT_STEPS)]
        torch.cuda.synchronize()
        _reset_launches()
        t0 = time.perf_counter()
        for a, b in events:
            act = torch.rand((N_BIG, 2), generator=gen, device=dev) * span \
                + lo
            a.record()
            res = env.step_batch(state, act, gen=gen)
            b.record()
            state = res.state
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _read_launches()
        finite = bool(torch.isfinite(res.obs).all()
                      and torch.isfinite(res.reward).all())
        ms = [a.elapsed_time(b) for a, b in events]
        report[name] = {
            "config": over, "envs": N_BIG, "steps": ROLLOUT_STEPS,
            "env_ms_per_step_median": float(np.median(ms)),
            "env_ms_per_step_mean": float(np.mean(ms)),
            "env_ms_per_step_host_clock": wall * 1e3 / ROLLOUT_STEPS,
            "obs_shape": list(res.obs.shape), "finite": finite,
            "done_after_last_step": int(state.done.sum()),
            "launches": launches}
        out[name] = {"launches": launches, "steps": ROLLOUT_STEPS,
                     "cfg": cfg, "state": state}
        if not finite or tuple(res.obs.shape) != (N_BIG, cfg.state_dim_risk):
            raise AssertionError(f"{name}: observation {tuple(res.obs.shape)}"
                                 f", finite {finite}")
        for kernel in ROLLOUT_KERNELS[name]:
            if launches[kernel] != ROLLOUT_STEPS:
                raise AssertionError(f"{name}: {kernel} launched "
                                     f"{launches[kernel]} times in "
                                     f"{ROLLOUT_STEPS} steps")
    emit({"phase": "forms_rollout", "world": "crowd_dense/crowd, jitter 1.0",
          **report})
    return out


def phase_evaluate(torch):
    from crowdnav_tpu_torch.drivers import evaluate
    ckpt = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "crowdnav_tpu_torch", "assets",
                        "final_full_actor.npz")
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        results, graphs = _through_graphs(
            torch, "evaluate", XLA_KERNELS, lambda: evaluate.main([
                "--suite", "train", "--checkpoint", ckpt, "--n-envs",
                str(EVAL_ENVS), "--max-steps", str(EVAL_STEPS), "--jitter",
                "1.0", "--seed", "0", "--outdir", out, "--device", "cuda"]))
        wall = time.perf_counter() - t0
    s = results[0]
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
          **graphs})
    if not (s["episodes"] > 0 and rate >= 0.90):
        raise AssertionError(f"success rate {rate} < 0.90")
    return {"launches": graphs["launches"], "steps": graphs["launch_steps"]}



def phase_libm(torch, dev):
    """The C-library trig kernel at the step's shapes (one value per env)
    against the library on the CPU, and its device time."""
    from crowdnav_tpu_torch.kernels import build, roofline, timing
    from crowdnav_tpu_torch.utils import numerics as nm
    g = torch.Generator(device=dev).manual_seed(5)
    shapes, worst = {}, 0.0
    for n in SHAPES:
        yaw = (torch.rand(n, generator=g, device=dev) * 2 - 1) * math.pi
        dy = torch.rand(n, generator=g, device=dev) * 3 - 1.5
        dx = torch.rand(n, generator=g, device=dev) * 3 - 1.5
        for name, kernel, plain, args, n_in in (
                ("libm_sincos", lambda x: build.libm_sincos(x, True),
                 nm.cos, (yaw,), 1),
                ("libm_atan2", build.libm_atan2, nm.atan2, (dy, dx), 2)):
            got = kernel(*args)
            ref = plain(*(a.cpu() for a in args))
            torch.cuda.synchronize()
            diff = _n_differ(torch, got, ref)
            if diff:
                raise AssertionError(f"{name} n={n}: {diff} elements differ "
                                     f"from the C library")
            nbytes, ops, rate = roofline.libm_work(n, n_in)
            bound, bound_by = roofline.bound_ms(nbytes, ops, rate)
            sets = timing.clone_args(args, timing.copies_for(nbytes))
            library = torch.cos if n_in == 1 else torch.atan2
            cpu_args = tuple(a.cpu() for a in args)
            t0 = time.perf_counter()
            plain(*cpu_args)
            plain_ms = (time.perf_counter() - t0) * 1e3
            shapes.setdefault(name, {})[n] = {
                "device_ms": timing.device_ms(kernel, sets, reps=100),
                "plain_ms": plain_ms,
                "library_ms": timing.device_ms(library, sets, reps=100),
                "library_differing": _n_differ(torch, library(*args), ref),
                "bound_ms": bound, "bound_by": bound_by, "bytes": nbytes,
                "ops": ops}
    emit({"phase": "libm", "shapes": shapes, "max_abs_diff": worst,
          "plain": "the C library's cosf/atan2f on CPU tensors "
                   "(utils/numerics.py), host clock",
          "library": "torch.cos / torch.atan2 on the card (not the C "
                     "library's values: library_differing elements)"})
    return {name: {"max_abs": 0.0, "shapes": sh}
            for name, sh in shapes.items()}


TRAIN_FLAGS = ["--algo", "td3", "--world", "crowd_dense", "--behavior",
               "crowd", "--jitter", "1.0", "--replay-obs-dtype", "bfloat16",
               "--seed", "0"]
TRAIN_FULL = TRAIN_FLAGS + [
    "--n-envs", "16384", "--chunk", "64", "--updates-per-step", "32",
    "--batch-size", "4096", "--learn-start", "256", "--reset-bank", "256",
    "--explore-eps", "1.0", "--explore-eps-min", "0.05",
    "--explore-spectrum", "--device", "cuda"]
# one timed chunk of the eager loop each: the jitted phase carries the
# bench cell's two timed chunks, eagerly and through the graph
TRAIN_TIMED_CHUNKS = 1
TRAIN_XLA_TIMED_CHUNKS = 1
SMALL = dict(n=256, steps=2, updates=2)


def _to_device(torch, state, dev):
    """A CPU TrainerState on ``dev``, with a generator there (the draws
    then come from the caller)."""
    from crowdnav_tpu_torch.utils.tree import to_device
    return dataclasses.replace(
        to_device(state, dev), gen=torch.Generator(device=dev).manual_seed(0))


def _train_full(torch, extra=(), timed_chunks=TRAIN_TIMED_CHUNKS,
                path=("raycast", "track_cp_topk")):
    """The training path at full width with ``extra`` flags: a warm-up
    chunk, then ``timed_chunks`` timed chunks with the launch counts and
    the step's time split; the kernels of ``path`` launched once a step."""
    from crowdnav_tpu_torch.drivers import train as dtrain
    args = dtrain.parser().parse_args(TRAIN_FULL + list(extra))
    trainer = dtrain.build(args)
    tc = trainer.tcfg
    t0 = time.perf_counter()
    state = trainer.init(args.seed)
    state = trainer.rollout_chunk(state)
    _, state = trainer.drain_stats(state)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    actor0 = state.agent_state.actor_params.clone()
    critic0 = state.agent_state.critic_params.clone()
    torch.cuda.reset_peak_memory_stats()
    trainer.spans = []
    _reset_launches()
    t0 = time.perf_counter()
    for _ in range(timed_chunks):
        state = trainer.rollout_chunk(state)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_launches()
    split = trainer.span_ms()
    trainer.spans = None
    summary, state = trainer.drain_stats(state)
    steps = timed_chunks * tc.rollout_chunk
    total_steps = (timed_chunks + 1) * tc.rollout_chunk
    size = int(state.replay.size)
    want_size = min(total_steps * tc.n_envs, trainer.buffer.capacity)
    out = {"flags": " ".join(extra), "risk_backend":
           trainer.env.cfg.risk_backend, "envs": tc.n_envs,
           "timed_steps": steps,
           "updates_per_step": tc.updates_per_step,
           "batch": trainer.agent.cfg.batch_size,
           "reset_bank": tc.reset_bank, "warmup_chunk_s": warm_s,
           "timed_wall_s": wall,
           "env_steps_per_s": steps * tc.n_envs / wall,
           "wall_ms_per_step": wall * 1e3 / steps,
           "device_ms_per_step": split,
           "launches": launches,
           "launches_per_step": {k: v / steps for k, v in launches.items()},
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "replay_bytes": trainer.buffer.capacity
           * trainer.buffer.row_bytes(),
           "replay_size": size, "replay_rows_written": want_size,
           "learn_metrics": {k: summary[k] for k in
                             ("critic_loss", "actor_loss", "q_target_mean")},
           "episodes": summary["episodes"],
           "actor_moved": float((state.agent_state.actor_params
                                 - actor0).abs().max()),
           "critic_moved": float((state.agent_state.critic_params
                                  - critic0).abs().max())}
    for name in path:
        if launches[name] != steps:
            raise AssertionError(f"{name}: {launches[name]} launches in "
                                 f"{steps} env steps")
    for name in ("libm_sincos", "libm_atan2"):
        if launches[name] < steps:
            raise AssertionError(f"{name}: {launches[name]} launches in "
                                 f"{steps} env steps")
    if not all(math.isfinite(v) for v in out["learn_metrics"].values()):
        raise AssertionError(f"losses not finite: {out['learn_metrics']}")
    if size != want_size:
        raise AssertionError(f"replay size {size} != {want_size} rows")
    if not (out["actor_moved"] > 0 and out["critic_moved"] > 0):
        raise AssertionError("the learner did not move the parameters")
    return out


def _train_small(torch, dev):
    """The card against the CPU at 256 envs, every draw made once on the
    CPU: env states and the replay ring bit-equal after every step; before
    each step the card's learner state is set to the CPU's, and every
    update the card's trainer makes is held to the CPU's update of the
    same state, batch and noise within the derived float32 bound
    (``utils/error_bounds.check_update``: Adam moments, parameters,
    targets, counts)."""
    from crowdnav_tpu_torch.drivers import train as dtrain
    from crowdnav_tpu_torch.envs import world
    from crowdnav_tpu_torch.parallel.runtime import StepDraws
    from crowdnav_tpu_torch.utils.error_bounds import check_update
    from crowdnav_tpu_torch.utils.tree import to_device, tree_leaves
    n, cpu = SMALL["n"], torch.device("cpu")
    flags = TRAIN_FLAGS + [
        "--n-envs", str(n), "--chunk", "1", "--updates-per-step",
        str(SMALL["updates"]), "--batch-size", str(n), "--learn-start",
        str(n), "--reset-bank", str(n), "--buffer-size", str(4 * n),
        "--explore-eps", "1.0"]
    tr_c = dtrain.build(dtrain.parser().parse_args(flags + ["--device",
                                                            "cpu"]))
    tr_g = dtrain.build(dtrain.parser().parse_args(flags + ["--device",
                                                            dev.type]))
    tr_g.env.template = to_device(tr_c.env.template, dev)
    agent_c, agent_g, cfg = tr_c.agent, tr_g.agent, tr_c.env.cfg
    s_c = tr_c.init(0)
    s_g = _to_device(torch, s_c, dev)
    start = s_c.agent_state
    calls = []
    update_g = agent_g.update

    def recorded(state, batch, gen=None, smoothing_noise=None):
        new, m = update_g(state, batch, gen=gen,
                          smoothing_noise=smoothing_noise)
        calls.append((state, batch, smoothing_noise, new))
        return new, m

    agent_g.update = recorded
    gen = torch.Generator().manual_seed(11)
    bsz, updates = agent_c.cfg.batch_size, SMALL["updates"]
    shares = []
    for step in range(SMALL["steps"]):
        rows = min(int(s_c.replay.size) + n, tr_c.buffer.capacity)
        draws = StepDraws(
            act=agent_c.exploration_draws(n, gen),
            bank_idx=torch.randint(0, n, (n,), generator=gen),
            vel=world.random_velocities(cfg, s_c.env_states.ped_pos.shape,
                                        gen, cpu),
            sample_idx=[torch.randint(0, rows, (bsz,), generator=gen)
                        for _ in range(updates)],
            smoothing=[torch.randn((bsz, 2), generator=gen)
                       for _ in range(updates)])
        pre = to_device(s_c.agent_state, dev)
        s_g = dataclasses.replace(s_g, agent_state=pre)
        calls.clear()
        s_c = tr_c.rollout_chunk(s_c, [draws])
        s_g = tr_g.rollout_chunk(s_g, [to_device(draws, dev)])
        pairs = [("obs", s_g.obs, s_c.obs)]
        pairs += [(f"state.{k}", g, c) for (k, g), (_, c) in zip(
            tree_leaves(s_g.env_states), tree_leaves(s_c.env_states))]
        pairs += [(f"replay.{k}", g, c) for (k, g), (_, c) in zip(
            tree_leaves(s_g.replay), tree_leaves(s_c.replay))]
        bad = {k: _n_differ(torch, g, c) for k, g, c in pairs}
        bad = {k: v for k, v in bad.items() if v}
        if bad:
            raise AssertionError(f"card vs CPU, step {step}: {bad}")
        if len(calls) != updates or calls[0][0] is not pre \
                or s_g.agent_state is not calls[-1][3] \
                or any(calls[u][0] is not calls[u - 1][3]
                       for u in range(1, updates)):
            raise AssertionError(f"step {step}: the card's trainer made "
                                 f"{len(calls)} updates, not a chain of "
                                 f"{updates} from the step's state")
        for u, (s_in, b_g, noise_g, s_out) in enumerate(calls):
            state = to_device(s_in, cpu)
            b_c = tr_c.buffer.sample(s_c.replay, idx=draws.sample_idx[u])
            noise = draws.smoothing[u]
            if any(_n_differ(torch, x, y) for x, y in zip(b_g, b_c)) or \
                    _n_differ(torch, noise_g, noise):
                raise AssertionError(f"step {step} update {u}: the card "
                                     f"did not learn from the drawn "
                                     f"sample and noise")
            new_c, m_c = agent_c.update(state, b_c, smoothing_noise=noise)
            shares.append(check_update(agent_g, state, b_c, noise,
                                       to_device(s_out, cpu), new_c, m_c))
    moved = {name: float((getattr(s_g.agent_state, name).cpu()
                          - getattr(start, name)).abs().max())
             for name in ("actor_params", "critic_params")}
    if not all(v > 0 for v in moved.values()):
        raise AssertionError(f"the card's learner did not move: {moved}")
    return {"envs": n, "steps": SMALL["steps"], "updates_per_step": updates,
            "batch": bsz, "bit_equal": ["obs", "env_states", "replay",
                                        "each update's batch and noise"],
            "updates_checked": len(shares),
            "max_bound_share": {k: max(sh[k] for sh in shares)
                                for k in shares[0]},
            "bound_shares": shares, "moved": moved}


def phase_train(torch, dev):
    """The default configuration's training path (the XLA form of the
    tracker kernel), then the card against the CPU."""
    full = _train_full(torch, timed_chunks=TRAIN_XLA_TIMED_CHUNKS)
    small = _train_small(torch, dev)
    emit({"phase": "train", "full": full, "card_vs_cpu": small})
    return full


def phase_train_pallas(torch):
    """The main path: the ``bench.py:103-178`` cell's
    configuration, whose risk backend is ``"pallas"`` (``bench.py:206``),
    at full width: the tracker kernel's Pallas form once a step."""
    full = _train_full(torch, ["--risk-backend", "pallas"],
                       path=("raycast", "track_cp_topk_pallas"))
    emit({"phase": "train_pallas", "full": full})
    return full


# ---- the jitted chunk: Trainer.make_jitted, one captured CUDA graph of
# the step, against the eager chunk ----

JIT_TIMED_CHUNKS = 2        # after a first chunk: 1 + 2 chunks a side
JIT_PROFILE_STEPS = 3
JIT_AGENT_CHUNKS = 1        # DDPG, SAC, DQN: the gate opens inside it
JIT_FORM_CHUNKS = 2
JIT_RESTART_FLAGS = [
    "--algo", "td3", "--n-envs", "256", "--chunk", "8", "--env-steps",
    "4096", "--updates-per-step", "2", "--batch-size", "256",
    "--learn-start", "512", "--max-steps", "3", "--jitter", "1.0",
    "--replay-obs-dtype", "bfloat16", "--buffer-size", "4096",
    "--restart-on-collapse", "1", "--collapse-detect-chunk", "1",
    "--collapse-reward-threshold", "1e9", "--ckpt-every-chunks", "1",
    "--seed", "0", "--device", "cuda"]


def _bench_module():
    """``scripts/bench_torch_train.py``, which builds the ``bench.py``
    cell through the port's ``drivers/train``."""
    import importlib.util
    path = os.path.join(ROOT, "scripts", "bench_torch_train.py")
    spec = importlib.util.spec_from_file_location("bench_torch_train", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _state_differ(torch, a, b):
    """``(differing elements in all, {field: differing elements})`` of two
    trainer states: every tensor, the generators' states, the gate."""
    from crowdnav_tpu_torch.utils.tree import named_tensors
    ta, tb = dict(named_tensors(a)), dict(named_tensors(b))
    if set(ta) != set(tb):
        raise AssertionError(f"state fields differ: {set(ta) ^ set(tb)}")
    out = {k: _n_differ(torch, ta[k], tb[k]) for k in sorted(ta)}
    out["gen_state"] = _n_differ(torch, a.gen.get_state(),
                                 b.gen.get_state())
    out["learning_open"] = int(a.learning_open != b.learning_open)
    elements = sum(t.numel() for t in ta.values())
    return sum(out.values()), {k: v for k, v in out.items() if v}, elements


def _between(trainer, state):
    """The drivers' work between chunks: drained statistics, the DQN's
    epsilon decay."""
    summary, state = trainer.drain_stats(state)
    if hasattr(trainer.agent, "decay_epsilon"):
        state = dataclasses.replace(state, agent_state=trainer.agent
                                    .decay_epsilon(state.agent_state))
    return summary, state


def _same_summary(name, a, b):
    if a != b:
        diff = {k: (a[k], b.get(k)) for k in a if a[k] != b.get(k)}
        raise AssertionError(f"{name}: graph and eager summaries differ: "
                             f"{diff}")


# each kernel form by its kernel's name as the profiler reports it
# (demangled): the raycast's <beams a thread, Pallas form>, the tracker's
# <S, T, K, form>, form 0 XLA, 1 strict, 2 Pallas (kernels/csrc)
KERNEL_EVENTS = (
    ("raycast", r"\braycast_kernel<\d+, false>"),
    ("raycast_pallas", r"\braycast_kernel<\d+, true>"),
    ("track_cp_topk", r"\btrack_cp_topk_kernel<\d+, \d+, \d+, 0>"),
    ("track_cp_topk_strict", r"\btrack_cp_topk_kernel<\d+, \d+, \d+, 1>"),
    ("track_cp_topk_pallas", r"\btrack_cp_topk_kernel<\d+, \d+, \d+, 2>"),
    ("libm_sincos", r"\bsincos_kernel\("),
    ("libm_atan2", r"\batan2_kernel\("))


def kernel_events(card):
    """The kernels of each form among a profiler's records of the card,
    by name; raises on a kernel of the port's sources whose name no form
    matches."""
    out = {name: 0 for name, _ in KERNEL_EVENTS}
    for e in card:
        forms = [n for n, pat in KERNEL_EVENTS if re.search(pat, e.name)]
        if len(forms) > 1 or (not forms and re.search(
                r"raycast_kernel|track_cp_topk_kernel|\b(sincos|atan2)"
                r"_kernel\b", e.name)):
            raise AssertionError(f"kernel {e.name!r}: forms {forms}")
        if forms:
            out[forms[0]] += 1
    return out


def _jit_profile(torch, step, steps=JIT_PROFILE_STEPS):
    """Busy share and device operations a step over ``steps`` calls of
    ``step``, the card's activity only, between two marker kernels
    (``bench_torch_train.marked_window``, ``trace_summary``), and the
    kernels of each form among them (:func:`kernel_events`)."""
    from torch.profiler import ProfilerActivity
    bench = _bench_module()
    prof, card, wall_ms = bench.marked_window(torch, step, steps,
                                              [ProfilerActivity.CUDA])
    out = bench.trace_summary(prof, card, steps, wall_ms)
    out["launches"] = kernel_events(card)
    out.pop("host_calls_per_step_and_self_ms")
    out["top_kernels_ms_per_step"] = dict(
        list(out["top_kernels_ms_per_step"].items())[:5])
    return out


def _timed(torch, chunk, state, n):
    """``n`` chunks of ``chunk`` after the first: host clock and CUDA
    events around them (the host waits for the card at the end), peak
    memory above what was allocated at their start."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    base_res = torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(n):
        state = chunk(state)
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return state, {"wall_s": wall, "event_ms": start.elapsed_time(end),
                   "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
                   "peak_above_start_bytes":
                   torch.cuda.max_memory_allocated() - base,
                   "peak_reserved_bytes": torch.cuda.max_memory_reserved(),
                   "reserved_above_start_bytes":
                   torch.cuda.max_memory_reserved() - base_res}


def _jit_pair(torch, trainer, chunks, label, profile=False):
    """One trainer's eager chunk and jitted chunk from one seed (the
    drivers' work between chunks): every state field 0 differing
    elements after every chunk, equal summaries; the first chunk, then
    ``chunks - 1`` timed chunks a side; the wrappers' calls on each side,
    the capture's seconds; a profiler window of replays, and with
    ``profile`` one of eager steps."""
    tc = trainer.tcfg
    t0 = time.perf_counter()
    eager = trainer.init(0)
    run = trainer.make_jitted()
    graph = trainer.init(0)
    init_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    _reset_launches()
    t0 = time.perf_counter()
    eager = trainer.rollout_chunk(eager)
    torch.cuda.synchronize()
    first_eager_s = time.perf_counter() - t0
    eager_calls = _read_launches()
    _reset_launches()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    graph = run(graph)
    torch.cuda.synchronize()
    first_graph_s = time.perf_counter() - t0
    calls = _read_launches()
    # the capture's chunk: its peak counts the captured step's
    # temporaries, which the graph's pool keeps reserved (the cache was
    # emptied before it, as the capture empties it)
    capture_memory = {
        "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
        "reserved_above_start_bytes": torch.cuda.memory_reserved() - base}
    checked = []

    def check(where):
        n, fields, elements = _state_differ(torch, graph, eager)
        checked.append({"after": where, "differing": n,
                        "elements": elements})
        if n:
            raise AssertionError(f"{label}: graph vs eager after {where}: "
                                 f"{n} differing elements: {fields}")

    check("chunk 1")
    out = {"envs": tc.n_envs, "chunk": tc.rollout_chunk,
           "updates_per_step": tc.updates_per_step if tc.learning else 0,
           "init_s": init_s, "first_chunk_s": {"eager": first_eager_s,
                                               "graph": first_graph_s},
           "capture_s": run.capture_s, "capture_chunk_memory": capture_memory}
    if chunks > 1:
        s_g, graph = _between(trainer, graph)
        s_e, eager = _between(trainer, eager)
        _same_summary(label, s_g, s_e)
        _reset_launches()
        eager, out["eager"] = _timed(torch, trainer.rollout_chunk, eager,
                                     chunks - 1)
        eager_calls = {k: n + c for (k, n), c in
                       zip(eager_calls.items(), _read_launches().values())}
        _reset_launches()
        graph, out["graph"] = _timed(torch, run, graph, chunks - 1)
        calls = {k: n + c for (k, n), c in
                 zip(calls.items(), _read_launches().values())}
        steps = (chunks - 1) * tc.rollout_chunk
        out["timed_steps"] = steps
        for side in ("eager", "graph"):
            out[side]["host_ms_per_step"] = out[side]["wall_s"] * 1e3 / steps
            out[side]["event_ms_per_step"] = out[side]["event_ms"] / steps
        check(f"chunk {chunks}")
    out.update(steps=chunks * tc.rollout_chunk, replayed_steps=run.replays,
               wrapper_calls={"eager": eager_calls, "graph": calls})
    s_g, graph = _between(trainer, graph)
    s_e, eager = _between(trainer, eager)
    _same_summary(label, s_g, s_e)
    out["summary"] = {k: s_g[k] for k in ("episodes", "successes",
                                          "mean_ego_safety",
                                          "mean_social_safety")}
    out["checked"] = checked
    if profile:
        box = [eager]

        def eager_step():
            box[0] = trainer._train_step(box[0])

        out["profile_eager"] = _jit_profile(torch, eager_step)
    out["profile_graph"] = _jit_profile(torch, run.graph.replay)
    return out


def _assert_captured(label, out, path):
    """The replays in ``out``'s profiler window launched the raycast and
    the tracker form of ``path`` once a step, the trig as many times
    every step (at least once), no other form of the raycast or the
    tracker, and as many of each as eager steps in the eager window; the
    graph side's wrappers were called by its eager steps and its captures
    only (``out["captures"]``, one by default)."""
    replays = out["profile_graph"]["steps"]
    seen = out["profile_graph"]["launches"]
    eager_steps = out["steps"] - out["replayed_steps"]
    captures = out.get("captures", 1)
    calls = out["wrapper_calls"]["graph"]
    for name, _ in KERNEL_EVENTS:
        trig = name.startswith("libm")
        if name not in path:
            if not trig and (seen[name] or calls[name]):
                raise AssertionError(f"{label}: {name} is not on the path "
                                     f"but launched {seen[name]} times, "
                                     f"called {calls[name]} times")
            continue
        ok = (seen[name] >= replays and seen[name] % replays == 0
              and calls[name] >= eager_steps + captures) if trig else (
            seen[name] == replays and calls[name] == eager_steps + captures)
        if "profile_eager" in out:
            ok = ok and out["profile_eager"]["launches"][name] == seen[name]
        if not ok:
            raise AssertionError(
                f"{label}: {name}: {seen[name]} launches in {replays} "
                f"replays, {calls[name]} wrapper calls in {eager_steps} "
                f"eager steps and {captures} captures; eager window: "
                f"{out.get('profile_eager', {}).get('launches')}")


def _through_graphs(torch, label, path, call):
    """``call()``, a driver's run whose chunks go through
    ``Trainer.make_jitted`` (one call of each chunk, as the evaluate
    driver makes), with those chunks kept: the wrappers' calls in the run,
    then a profiler window of replays of each chunk's graph, held to
    ``path`` as the jitted phase's (:func:`_assert_captured`). Returns
    ``call()``'s result and a record: the windows' launches by form and
    their steps, the replayed steps, the wrappers' calls inside the
    chunks' calls (the driver's resets outside them also launch)."""
    from crowdnav_tpu_torch.parallel.runtime import JittedChunk, Trainer
    chunks, make, run = [], Trainer.make_jitted, JittedChunk.__call__
    calls = {name: 0 for name, _ in KERNEL_EVENTS}

    def keep(self):
        chunks.append(make(self))
        return chunks[-1]

    def counted(self, state):
        _reset_launches()
        state = run(self, state)
        for name, n in _read_launches().items():
            calls[name] += n
        return state

    with mock.patch.object(Trainer, "make_jitted", keep), \
            mock.patch.object(JittedChunk, "__call__", counted):
        result = call()
    torch.cuda.synchronize()
    out = {"chunks": len(chunks), "captures": len(chunks),
           "steps": sum(c.trainer.tcfg.rollout_chunk for c in chunks),
           "replayed_steps": sum(c.replays for c in chunks),
           "wrapper_calls": {"graph": calls}}
    windows = [_jit_profile(torch, c.graph.replay) for c in chunks]
    out["profile_graph"] = {
        "steps": sum(w["steps"] for w in windows),
        "launches": {k: sum(w["launches"][k] for w in windows)
                     for k, _ in KERNEL_EVENTS}}
    _assert_captured(label, out, path)
    out["launches"] = out["profile_graph"]["launches"]
    out["launch_steps"] = out["profile_graph"]["steps"]
    return result, out


def _driver_restart(torch):
    """``drivers/train`` with a collapse restart and a ``--resume``,
    through the graph, then again through the eager loop (``make_jitted``
    replaced by ``rollout_chunk``): equal events and the same agent
    files, bit for bit."""
    from crowdnav_tpu_torch.drivers import train as dtrain
    from crowdnav_tpu_torch.parallel.runtime import Trainer
    runs = {}
    for mode in ("graph", "eager"):
        patch = mock.patch.object(Trainer, "make_jitted",
                                  lambda self: self.rollout_chunk) \
            if mode == "eager" else contextlib.nullcontext()
        with tempfile.TemporaryDirectory() as out, patch:
            lines = []
            for extra in ([], ["--resume", "--env-steps", "8192"]):
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    dtrain.main(JIT_RESTART_FLAGS + ["--outdir", out]
                                + extra)
                lines += [json.loads(x) for x in buf.getvalue().splitlines()
                          if x.startswith("{")]
            agent_dir = os.path.join(out, "agent_ckpt_td3")
            files = sorted(f for f in os.listdir(agent_dir)
                           if f.endswith(".npz"))
            arrays = {}
            for f in files:
                with np.load(os.path.join(agent_dir, f)) as z:
                    arrays[f] = {k: z[k] for k in z.files
                                 if k != "run_config"}
        # the clocks and the allocator's totals differ between the runs
        drop = ("sps", "sps_ema", "secs", "seconds", "device_memory")
        runs[mode] = ([{k: v for k, v in e.items() if k not in drop}
                       for e in lines], arrays)
    (ev_g, ag_g), (ev_e, ag_e) = runs["graph"], runs["eager"]
    if ev_g != ev_e:
        raise AssertionError(f"driver events differ: {ev_g} vs {ev_e}")
    if sorted(ag_g) != sorted(ag_e) or any(
            not np.array_equal(ag_g[f][k], ag_e[f][k])
            for f in ag_g for k in ag_g[f]):
        raise AssertionError("the agent files differ, graph vs eager")
    restarts = [e for e in ev_g if e.get("event") == "collapse_restart"]
    resumed = [e for e in ev_g if e.get("event") == "resumed"]
    if len(restarts) != 1 or len(resumed) != 1:
        raise AssertionError(f"expected one restart and one resume: {ev_g}")
    return {"events": len(ev_g), "restarts": len(restarts),
            "resumed_at": resumed[0]["step"], "agent_files": sorted(ag_g),
            "identical": True}


def phase_jitted(torch, smi):
    """``Trainer.make_jitted`` against the eager chunk, each from one
    seed: the ``bench.py`` cell, ``train_forms``' two paths, DDPG, SAC
    and DQN at ``train_agents``' widths, the TD3 evaluation at 1,024 envs
    x 500 steps; the driver's collapse restart and resume. Each graph
    path's launches are those of its profiler window of replays."""
    from crowdnav_tpu_torch.drivers import evaluate
    from crowdnav_tpu_torch.drivers import train as dtrain
    bench = _bench_module()
    result, paths = {"card": smi}, {}

    def counted(name, out, path):
        _assert_captured(name, out, path)
        paths[f"jitted_{name}"] = {"launches": out["profile_graph"]
                                   ["launches"],
                                   "steps": out["profile_graph"]["steps"]}
        result[name] = out

    t0 = time.perf_counter()
    trainer = bench.build(bench.parser().parse_args(
        ["--iters", str(JIT_TIMED_CHUNKS)]), learning=True)
    cell = _jit_pair(torch, trainer, 1 + JIT_TIMED_CHUNKS, "cell",
                     profile=True)
    cell["flags"] = " ".join(bench.flags(bench.parser().parse_args([])))
    cell["seconds"] = time.perf_counter() - t0
    counted("cell", cell, ("raycast", "track_cp_topk_pallas", "libm_sincos",
                           "libm_atan2"))
    del trainer
    emit({"phase": "jitted", "part": "cell", **cell})

    for name, (flags, over, path) in FORM_PATHS.items():
        t0 = time.perf_counter()
        trainer = dtrain.build(dtrain.parser().parse_args(
            FORM_FLAGS + flags), **over)
        out = _jit_pair(torch, trainer, JIT_FORM_CHUNKS, name)
        out["seconds"] = time.perf_counter() - t0
        counted(name, out, path)
        del trainer
    for algo in ("ddpg", "sac", "dqn"):
        t0 = time.perf_counter()
        trainer = dtrain.build(dtrain.parser().parse_args(
            AGENT_FLAGS[algo] + ["--device", "cuda"]))
        out = _jit_pair(torch, trainer, JIT_AGENT_CHUNKS, algo)
        out["seconds"] = time.perf_counter() - t0
        counted(algo, out, _path_kernels(algo))
        del trainer
    emit({"phase": "jitted", "part": "forms_and_agents",
          **{k: result[k] for k in (*FORM_PATHS, "ddpg", "sac", "dqn")}})

    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    params, meta = evaluate.load_actor_file(ACTOR_FILE)
    agent = evaluate.build_agent(meta and meta.get("agent_config"), 398,
                                 dev, "td3", EVAL_ENVS)
    agent.load_actor(evaluate.flax_actor_to_state_dict(params))
    trainer = evaluate.scenario_trainer(
        agent, "crowd_dense", "crowd", EVAL_ENVS, EVAL_STEPS, 0,
        jitter=1.0, device=dev)
    ev = _evaluate_pair(torch, trainer)
    ev["seconds"] = time.perf_counter() - t0
    counted("evaluate", ev, XLA_KERNELS)
    del trainer
    t0 = time.perf_counter()
    result["driver_restart"] = _driver_restart(torch)
    result["driver_restart"]["seconds"] = time.perf_counter() - t0
    emit({"phase": "jitted", "part": "evaluate_and_driver",
          "evaluate": result["evaluate"],
          "driver_restart": result["driver_restart"]})
    return paths


def _evaluate_pair(torch, trainer):
    """The evaluation chunk (one chunk of ``EVAL_STEPS``), eager and
    through the graph, each from one seed: states and summaries equal;
    host and event ms a step, the wrappers' calls on each side, a
    profiler window of each."""
    out = {"envs": trainer.tcfg.n_envs, "steps": EVAL_STEPS}
    eager = trainer.init(0)
    _reset_launches()
    eager, out["eager"] = _timed(torch, trainer.rollout_chunk, eager, 1)
    eager_calls = _read_launches()
    run = trainer.make_jitted()
    graph = trainer.init(0)
    _reset_launches()
    graph, out["graph"] = _timed(torch, run, graph, 1)
    out["wrapper_calls"] = {"eager": eager_calls, "graph": _read_launches()}
    out["replayed_steps"] = run.replays
    out["capture_s"] = run.capture_s
    for side in ("eager", "graph"):
        out[side]["host_ms_per_step"] = out[side]["wall_s"] * 1e3 \
            / EVAL_STEPS
        out[side]["event_ms_per_step"] = out[side]["event_ms"] / EVAL_STEPS
    n, fields, elements = _state_differ(torch, graph, eager)
    out["differing"], out["elements"] = n, elements
    if n:
        raise AssertionError(f"evaluate: graph vs eager: {n} differing "
                             f"elements: {fields}")
    s_g, graph = trainer.drain_stats(graph)
    s_e, eager = trainer.drain_stats(eager)
    _same_summary("evaluate", s_g, s_e)
    out["summary"] = {k: s_g[k] for k in (
        "episodes", "successes", "success_rate", "mean_ego_safety",
        "mean_social_safety")}
    box = [eager]

    def eager_step():
        box[0] = trainer._train_step(box[0])

    out["profile_eager"] = _jit_profile(torch, eager_step)
    out["profile_graph"] = _jit_profile(torch, run.graph.replay)
    return out


# the other learners at the widths of their JAX records: DDPG as
# results/r3/chain4.log:1 (float32 replay, as that command passes no
# --replay-obs-dtype), SAC and DQN as results/r2/README.md:3-5 on the
# simple env with their configs' batch of 64
AGENT_FLAGS = {
    "ddpg": ["--algo", "ddpg", "--world", "crowd_dense", "--behavior",
             "crowd", "--n-envs", "2048", "--chunk", "64",
             "--updates-per-step", "16", "--batch-size", "1024",
             "--learn-start", "16384", "--jitter", "1.0", "--explore-eps",
             "1.0", "--explore-eps-min", "0.05", "--explore-spectrum",
             "--seed", "0"],
    "sac": ["--algo", "sac", "--world", "crowd_sparse", "--behavior",
            "random", "--n-envs", str(AGENT_ENVS), "--chunk", "64",
            "--updates-per-step", "32", "--jitter", "1.0", "--seed", "0"],
    "dqn": ["--algo", "dqn", "--world", "crowd_sparse", "--behavior",
            "random", "--n-envs", str(AGENT_ENVS), "--chunk", "64",
            "--updates-per-step", "32", "--jitter", "1.0", "--seed", "0"]}
AGENT_SMALL = dict(n=64, steps=2, updates=2)
AGENT_TIMED_CHUNKS = 1    # after a warm-up chunk
# each committed policy, its record (episodes, successes) and suite
ASSETS = os.path.join(ROOT, "crowdnav_tpu_torch", "assets")
AGENT_EVAL = {
    "ddpg": (["--checkpoint", os.path.join(ASSETS, "ddpg_peak"),
              "--checkpoint-step", "1572864"], "train", (921, 1123),
             "results/r3/ddpg_spectrum/ddpg_training_test.csv"),
    "sac": (["--checkpoint", os.path.join(ASSETS, "sac_actor.npz")],
            "train_sparse", (656, 758),
            "results/r2/sac/sac_training_test.csv"),
    "dqn": (["--checkpoint", os.path.join(ASSETS, "dqn_qnet.npz")],
            "train_sparse", (777, 847),
            "results/r2/dqn/dqn_training_test.csv")}
AGENT_EVAL_ENVS = 256     # the JAX evaluate driver's defaults
SIMPLE_KERNELS = ("raycast", "libm_sincos", "libm_atan2")


def _path_kernels(algo):
    """The kernels a path launches: the tracker only on the risk env."""
    return XLA_KERNELS if algo in ("td3", "ddpg") else SIMPLE_KERNELS


def _train_agent(torch, algo):
    """One learner's training path through the functions ``drivers/train``
    calls: a warm-up chunk, then two timed chunks with the launch counts
    and the step's time split."""
    from crowdnav_tpu_torch.drivers import train as dtrain
    args = dtrain.parser().parse_args(AGENT_FLAGS[algo] + ["--device",
                                                           "cuda"])
    trainer = dtrain.build(args)
    tc, agent = trainer.tcfg, trainer.agent
    t0 = time.perf_counter()
    state = trainer.init(args.seed)
    state = trainer.rollout_chunk(state)
    _, state = trainer.drain_stats(state)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    field = "params" if algo == "dqn" else "actor_params"
    before = getattr(state.agent_state, field).clone()
    torch.cuda.reset_peak_memory_stats()
    trainer.spans = []
    _reset_launches()
    t0 = time.perf_counter()
    for _ in range(AGENT_TIMED_CHUNKS):
        state = trainer.rollout_chunk(state)
        if hasattr(agent, "decay_epsilon"):
            state = dataclasses.replace(
                state, agent_state=agent.decay_epsilon(state.agent_state))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_launches()
    split = trainer.span_ms()
    trainer.spans = None
    summary, state = trainer.drain_stats(state)
    steps = AGENT_TIMED_CHUNKS * tc.rollout_chunk
    metrics = {k: summary[k] for k in agent.METRICS}
    out = {"flags": " ".join(AGENT_FLAGS[algo]), "envs": tc.n_envs,
           "timed_steps": steps, "updates_per_step": tc.updates_per_step,
           "batch": agent.cfg.batch_size, "warmup_chunk_s": warm_s,
           "timed_wall_s": wall, "env_steps_per_s": steps * tc.n_envs / wall,
           "wall_ms_per_step": wall * 1e3 / steps,
           "device_ms_per_step": split, "launches": launches,
           "launches_per_step": {k: v / steps for k, v in launches.items()},
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "replay_size": int(state.replay.size),
           "learn_metrics": metrics, "episodes": summary["episodes"],
           "success_rate": summary["success_rate"],
           "moved": float((getattr(state.agent_state, field)
                           - before).abs().max())}
    for name in _path_kernels(algo):
        if launches[name] < steps:
            raise AssertionError(f"{algo}: {name} launched {launches[name]}"
                                 f" times in {steps} env steps")
    if not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"{algo}: losses not finite: {metrics}")
    if not out["moved"] > 0:
        raise AssertionError(f"{algo}: the learner did not move")
    return out


def _agent_vs_cpu(torch, dev, algo):
    """The card against the CPU at 64 envs, every draw made once on the
    CPU: env states and the replay ring bit-equal after every step; before
    each step the card's learner state is set to the CPU's, and every
    update the card's trainer makes is held to the CPU's update of the
    same state, batch and draws (``utils/error_bounds.check_update``).
    DDPG explores with epsilon 1 and DQN starts at epsilon 1, so their
    actions are the drawn ones on both devices; SAC's action passes
    through its networks, so the card's act is held within the derived
    bound of the CPU's and the card's step takes the CPU's action."""
    from crowdnav_tpu_torch.drivers import train as dtrain
    from crowdnav_tpu_torch.envs import world
    from crowdnav_tpu_torch.parallel.runtime import StepDraws
    from crowdnav_tpu_torch.utils import error_bounds as eb
    from crowdnav_tpu_torch.utils.tree import to_device, tree_leaves
    n, cpu = AGENT_SMALL["n"], torch.device("cpu")
    base = [f for f in AGENT_FLAGS[algo]]
    for flag in ("--n-envs", "--chunk", "--updates-per-step",
                 "--batch-size", "--learn-start", "--explore-eps-min"):
        if flag in base:
            i = base.index(flag)
            del base[i:i + 2]
    base = [f for f in base if f != "--explore-spectrum"]
    flags = base + [
        "--n-envs", str(n), "--chunk", "1", "--updates-per-step",
        str(AGENT_SMALL["updates"]), "--batch-size", str(n),
        "--learn-start", str(n), "--reset-bank", str(n), "--buffer-size",
        str(4 * n)]
    tr_c = dtrain.build(dtrain.parser().parse_args(flags + ["--device",
                                                            "cpu"]))
    tr_g = dtrain.build(dtrain.parser().parse_args(flags + ["--device",
                                                            dev.type]))
    tr_g.env.template = to_device(tr_c.env.template, dev)
    agent_c, agent_g, cfg = tr_c.agent, tr_g.agent, tr_c.env.cfg
    s_c = tr_c.init(0)
    s_g = _to_device(torch, s_c, dev)
    calls, acted = [], []
    update_g, act_c, act_g = agent_g.update, agent_c.act, agent_g.act

    def recorded(state, batch, gen=None, **kw):
        new, m = update_g(state, batch, gen=gen, **kw)
        calls.append((state, batch, kw.get("noise"), new))
        return new, m

    def act_cpu(obs, explore=False, state=None, gen=None, draws=None):
        out = act_c(obs, explore, state, gen, draws)
        acted.append((obs, state, draws, out))
        return out

    act_shares = []

    def act_card(obs, explore=False, state=None, gen=None, draws=None):
        out = act_g(obs, explore, state, gen, draws)
        obs_c, state_c, draws_c, out_c = acted[-1]
        fw = eb.sac_sample_bound(agent_c, eb._bparams(
            agent_c, "actor", state_c.actor_params), obs_c.numpy(),
            draws_c.numpy())
        box = eb.bclip(fw["action"], np.array([0.0, -2.0]),
                       np.array([0.22, 2.0]))
        act_shares.append(eb.within("sac act (card)", out.cpu().numpy(),
                                    box))
        return out_c.to(dev)

    agent_g.update = recorded
    if algo == "sac":
        agent_c.act, agent_g.act = act_cpu, act_card
    gen = torch.Generator().manual_seed(11)
    bsz, updates = agent_c.cfg.batch_size, AGENT_SMALL["updates"]
    own = agent_c.UPDATE_DRAW
    shares = []
    for step in range(AGENT_SMALL["steps"]):
        rows = min(int(s_c.replay.size) + n, tr_c.buffer.capacity)
        vel = world.random_velocities(cfg, s_c.env_states.ped_pos.shape,
                                      gen, cpu)
        draws = StepDraws(
            act=agent_c.exploration_draws(n, gen),
            bank_idx=torch.randint(0, n, (n,), generator=gen), vel=vel,
            sample_idx=[torch.randint(0, rows, (bsz,), generator=gen)
                        for _ in range(updates)],
            sac_noise=[torch.randn((bsz, 2), generator=gen)
                       for _ in range(updates)] if algo == "sac" else None)
        pre = to_device(s_c.agent_state, dev)
        s_g = dataclasses.replace(s_g, agent_state=pre)
        calls.clear()
        s_c = tr_c.rollout_chunk(s_c, [draws])
        s_g = tr_g.rollout_chunk(s_g, [to_device(draws, dev)])
        pairs = [("obs", s_g.obs, s_c.obs)]
        pairs += [(f"state.{k}", g, c) for (k, g), (_, c) in zip(
            tree_leaves(s_g.env_states), tree_leaves(s_c.env_states))]
        pairs += [(f"replay.{k}", g, c) for (k, g), (_, c) in zip(
            tree_leaves(s_g.replay), tree_leaves(s_c.replay))]
        if algo == "ddpg":
            pairs.append(("ou_state", s_g.agent_state.ou_state,
                          s_c.agent_state.ou_state))
        bad = {k: _n_differ(torch, g, c) for k, g, c in pairs}
        bad = {k: v for k, v in bad.items() if v}
        if bad:
            raise AssertionError(f"{algo} card vs CPU, step {step}: {bad}")
        if len(calls) != updates:
            raise AssertionError(f"{algo} step {step}: {len(calls)} updates")
        for u, (s_in, b_g, noise_g, s_out) in enumerate(calls):
            state = to_device(s_in, cpu)
            b_c = tr_c.buffer.sample(s_c.replay, idx=draws.sample_idx[u])
            kw, noise = {}, None
            if own is not None:
                noise = getattr(draws, own[0])[u]
                kw[own[1]] = noise
                if _n_differ(torch, noise_g, noise):
                    raise AssertionError(f"{algo}: the card's update noise")
            if any(_n_differ(torch, x, y) for x, y in zip(b_g, b_c)):
                raise AssertionError(f"{algo} step {step} update {u}: the "
                                     f"card did not learn from the sample")
            new_c, m_c = agent_c.update(state, b_c, **kw)
            shares.append(eb.check_update(agent_g, state, b_c, noise,
                                          to_device(s_out, cpu), new_c,
                                          m_c))
    out = {"envs": n, "steps": AGENT_SMALL["steps"],
           "updates_per_step": updates, "batch": bsz,
           "bit_equal": ["obs", "env_states", "replay",
                         "each update's batch and draws"],
           "updates_checked": len(shares),
           "max_bound_share": {k: max(sh[k] for sh in shares)
                               for k in shares[0]}}
    if act_shares:
        out["sac_act_bound_share"] = max(act_shares)
    return out


def phase_train_agents(torch, dev):
    """DDPG, SAC and DQN: each learner's training path at the widths of
    its JAX record, then the card against the CPU."""
    result = {}
    for algo in ("ddpg", "sac", "dqn"):
        t0 = time.perf_counter()
        full = _train_agent(torch, algo)
        small = _agent_vs_cpu(torch, dev, algo)
        result[algo] = {"full": full, "card_vs_cpu": small,
                        "seconds": time.perf_counter() - t0}
        emit({"phase": "train_agents", "algo": algo, **result[algo]})
    return {algo: r["full"]["launches"] for algo, r in result.items()}


# the paths of the forms outside the bench cell, through the functions
# drivers/train calls (flags, and config fields its command line does not
# expose): the Pallas raycast with the Pallas tracker and the three noise
# knobs, and the strict quirks (the XLA raycast, the strict tracker)
FORM_PATHS = {
    "pallas_backends_noise": (
        ["--risk-backend", "pallas", "--actuation-noise", "0.05",
         "--dt-jitter", "0.15", "--lidar-noise", "0.005"],
        {"lidar_backend": "pallas"},
        ("raycast_pallas", "track_cp_topk_pallas")),
    "strict_quirks": ([], {"strict_quirks": True},
                      ("raycast", "track_cp_topk_strict"))}
FORM_CHUNK = 32
FORM_FLAGS = ["--algo", "td3", "--world", "crowd_dense", "--behavior",
              "crowd", "--n-envs", "1024", "--chunk", str(FORM_CHUNK),
              "--updates-per-step", "2", "--batch-size", "1024",
              "--learn-start", "1024", "--jitter", "1.0", "--buffer-size",
              "65536", "--replay-obs-dtype", "bfloat16", "--seed", "0",
              "--device", "cuda"]


def phase_train_forms(torch):
    """One timed chunk of each form's training path at 1,024 envs (after a
    warm-up chunk): its kernels launched once a step, finite losses."""
    from crowdnav_tpu_torch.drivers import train as dtrain
    result = {}
    for name, (flags, over, path) in FORM_PATHS.items():
        trainer = dtrain.build(dtrain.parser().parse_args(FORM_FLAGS
                                                          + flags), **over)
        state = trainer.init(0)
        state = trainer.rollout_chunk(state)
        _, state = trainer.drain_stats(state)
        torch.cuda.synchronize()
        _reset_launches()
        t0 = time.perf_counter()
        state = trainer.rollout_chunk(state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _read_launches()
        summary, state = trainer.drain_stats(state)
        steps = trainer.tcfg.rollout_chunk
        metrics = {k: summary[k] for k in trainer.agent.METRICS}
        n = trainer.tcfg.n_envs
        result[name] = {"flags": " ".join(flags), "config": over,
                        "envs": n,
                        "steps": steps, "wall_s": wall,
                        "env_steps_per_s": steps * n / wall,
                        "launches": launches, "learn_metrics": metrics,
                        "episodes": summary["episodes"]}
        for k in path:
            if launches[k] != steps:
                raise AssertionError(f"{name}: {k} launched {launches[k]} "
                                     f"times in {steps} steps")
        if not all(math.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"{name}: losses not finite: {metrics}")
    emit({"phase": "train_forms", **result})
    return {name: r["launches"] for name, r in result.items()}


BF16_BATCH = 1024
BF16_UPDATES = 3


def phase_bf16(torch, dev):
    """TD3 with ``compute_dtype="bfloat16"`` at the flagship's widths
    (398-dim state, 256 wide, batch 1,024): a chain of updates on the card,
    each held to the CPU's update of the same state, batch and noise
    within the derived bound of the bfloat16 learner
    (``error_bounds.check_update`` under ``lowp``)."""
    from crowdnav_tpu_torch.agents.replay import Transition
    from crowdnav_tpu_torch.agents.td3 import TD3, TD3Config
    from crowdnav_tpu_torch.utils.error_bounds import check_update
    from crowdnav_tpu_torch.utils.tree import to_device
    cpu = torch.device("cpu")
    cfg = TD3Config(batch_size=BF16_BATCH, compute_dtype="bfloat16")
    a_c, a_g = TD3(cfg, 398, device=cpu), TD3(cfg, 398, device=dev)
    state = a_c.init_state(0)
    g = torch.Generator().manual_seed(4)
    shares = []
    t0 = time.perf_counter()
    for _ in range(BF16_UPDATES):
        b = Transition(
            obs=(torch.rand((BF16_BATCH, 398), generator=g) * 3 - 1.5
                 ).to(torch.bfloat16),
            action=torch.rand((BF16_BATCH, 2), generator=g)
            * torch.tensor([0.22, 4.0]) - torch.tensor([0.0, 2.0]),
            reward=torch.randn(BF16_BATCH, generator=g) * 5,
            next_obs=(torch.rand((BF16_BATCH, 398), generator=g) * 3 - 1.5
                      ).to(torch.bfloat16),
            done=(torch.rand(BF16_BATCH, generator=g) < 0.1).float())
        noise = torch.randn((BF16_BATCH, 2), generator=g)
        new_g, _ = a_g.update(to_device(state, dev), to_device(b, dev),
                              smoothing_noise=noise.to(dev))
        new_c, m_c = a_c.update(state, b, smoothing_noise=noise)
        shares.append(check_update(a_g, state, b, noise,
                                   to_device(new_g, cpu), new_c, m_c))
        state = new_c
    out = {"batch": BF16_BATCH, "updates": BF16_UPDATES,
           "max_bound_share": {k: max(sh[k] for sh in shares)
                               for k in shares[0]},
           "seconds": time.perf_counter() - t0}
    emit({"phase": "bf16_learner", **out})
    return out


def phase_tabular(torch):
    """``drivers/train_tabular`` on the card: Q-learning and SARSA on the
    simple env's empty room, 64 envs x 2 chunks of 100 steps, the tables
    on the device; the run's files and a greedy evaluation from the
    table."""
    from crowdnav_tpu_torch.drivers import train_tabular
    result = {}
    for algo in ("qlearn", "sarsa"):
        with tempfile.TemporaryDirectory() as out:
            t0 = time.perf_counter()
            carry = train_tabular.main(
                ["--algo", algo, "--n-envs", "64", "--chunk", "100",
                 "--env-steps", "12800", "--jitter", "1.0", "--outdir", out,
                 "--device", "cuda"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            table = carry.table
            files = sorted(os.listdir(out))
            train_tabular.main(
                ["--algo", algo, "--n-envs", "64", "--chunk", "100",
                 "--env-steps", "6400", "--no-learning", "--load",
                 os.path.join(out, f"{algo}_qtable"), "--outdir", out,
                 "--device", "cuda"])
        visited = int(table.visited.sum())
        result[algo] = {"device": str(table.q.device), "wall_s": wall,
                        "visited_entries": visited, "files": files,
                        "epsilon": float(table.epsilon)}
        if table.q.device.type != "cuda" or visited == 0 or \
                not torch.isfinite(table.q).all():
            raise AssertionError(f"train_tabular {algo}: {result[algo]}")
    emit({"phase": "tabular", **result})
    return result


def _overlap(a, b):
    return a[0] <= b[1] and b[0] <= a[1]


def phase_evaluate_agents(torch):
    """Greedy evaluation of the three committed policies through
    ``drivers/evaluate`` (256 envs x 500 steps, jitter 1.0, seed 0: the
    JAX driver's defaults), against the JAX records: the port's Wilson
    95% interval must overlap the record's."""
    from crowdnav_tpu_torch.drivers import evaluate
    launches, rows = {}, {}
    for algo, (ckpt, suite, record, source) in AGENT_EVAL.items():
        with tempfile.TemporaryDirectory() as out:
            t0 = time.perf_counter()
            results, graphs = _through_graphs(
                torch, f"{algo} evaluate", _path_kernels(algo),
                lambda: evaluate.main(
                    ["--algo", algo, "--suite", suite, *ckpt, "--n-envs",
                     str(AGENT_EVAL_ENVS), "--max-steps", str(EVAL_STEPS),
                     "--jitter", "1.0", "--seed", "0", "--outdir", out,
                     "--device", "cuda"]))
            wall = time.perf_counter() - t0
            launches[algo] = graphs["launches"]
        s = results[0]
        port = wilson(s["successes"], s["episodes"])
        rec = wilson(*record)
        rows[algo] = {"suite": suite, "scenario": s["scenario"],
                      "episodes": s["episodes"],
                      "successes": s["successes"],
                      "success_rate": s["success_rate"], "wilson95": port,
                      "jax_record": {"successes": record[0],
                                     "episodes": record[1],
                                     "success_rate": record[0] / record[1],
                                     "wilson95": rec, "source": source},
                      "overlap": _overlap(port, rec),
                      "mean_reward": s["mean_reward"],
                      "mean_steps": s["mean_steps"],
                      "rollout_s": s["timelapse"], "wall_s": wall,
                      "env_steps_per_s": AGENT_EVAL_ENVS * EVAL_STEPS
                      / s["timelapse"], **graphs}
    emit({"phase": "evaluate_agents", "envs": AGENT_EVAL_ENVS,
          "steps": EVAL_STEPS, "agents": rows})
    bad = [a for a, r in rows.items() if not r["overlap"]]
    if bad:
        raise AssertionError(f"Wilson intervals do not overlap the JAX "
                             f"records: {bad}")
    return launches


# ---- the sharded learner, the multi-host driver, deployment and the
# trajectory audit ----

SHARDED_RANKS = 2
# the bench cell (train_pallas) as 2 gloo ranks on one card: 8,192 envs a
# rank, global batch 4,096 (2,048 a rank)
SHARDED_FLAGS = TRAIN_FULL + ["--risk-backend", "pallas", "--multihost"]
SHARDED_TIMED_CHUNKS = 1     # after a warm-up chunk
SHARDED_PROBE_STEPS = 2      # steps with each all-reduce timed
SHARDED_TIMEOUT_S = 600


def _free_port() -> str:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return str(sock.getsockname()[1])


def sharded_rank(rank, port, out):
    """One rank of the ``sharded`` phase, in a process of its own: the
    bench cell's training through ``drivers/train.build`` under
    ``--multihost`` on gloo, this rank's 8,192 envs on ``cuda:0``; a
    warm-up and a timed chunk (launches, the step's split, the rate),
    probe steps with each all-reduce timed, then one update of this rank's
    sample from the final state, written to ``out`` with the final agent
    state."""
    import torch
    import torch.distributed as dist

    from crowdnav_tpu_torch.drivers import train as dtrain
    from crowdnav_tpu_torch.parallel import distributed
    from crowdnav_tpu_torch.utils.tree import to_device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = int(rank)
    dev = distributed.init_multihost(f"localhost:{port}", SHARDED_RANKS,
                                     rank, backend="gloo", device="cuda:0")
    try:
        args = dtrain.parser().parse_args(SHARDED_FLAGS)
        trainer = dtrain.build(args, dev)
        tc, cpu = trainer.tcfg, torch.device("cpu")
        t0 = time.perf_counter()
        state = trainer.init(args.seed)
        state = trainer.rollout_chunk(state)
        _, state = trainer.drain_stats(state)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        dist.barrier()
        _reset_launches()
        trainer.spans = []
        t0 = time.perf_counter()
        for _ in range(SHARDED_TIMED_CHUNKS):
            state = trainer.rollout_chunk(state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _read_launches()
        split = trainer.span_ms()
        trainer.spans = None
        summary, state = trainer.drain_stats(state)
        reduce_ms, reduce = [], trainer.update_kw["grad_reduce"]

        def timed_reduce(t):
            torch.cuda.current_stream(t.device).synchronize()
            t0 = time.perf_counter()
            out = reduce(t)
            torch.cuda.current_stream(t.device).synchronize()
            reduce_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        trainer.update_kw["grad_reduce"] = timed_reduce
        for _ in range(SHARDED_PROBE_STEPS):
            state = trainer._train_step(state)
        trainer.update_kw["grad_reduce"] = reduce
        agent, s_in = trainer.agent, state.agent_state
        batch = trainer.buffer.sample(state.replay, trainer.batch_size,
                                      state.gen)
        noise = torch.randn((trainer.batch_size, 2), generator=state.gen,
                            device=dev)
        new, metrics = agent.update(s_in, batch, smoothing_noise=noise,
                                    grad_reduce=trainer.mesh.mean)
        torch.save({
            "rank": rank, "envs": tc.n_envs, "rows": trainer.rows,
            "batch_size": trainer.batch_size, "warmup_chunk_s": warm_s,
            "timed_steps": SHARDED_TIMED_CHUNKS * tc.rollout_chunk,
            "timed_wall_s": wall, "device_ms_per_step": split,
            "launches": launches, "summary": summary,
            "replay_size": int(state.replay.size),
            "replay_blocks": trainer.buffer.n_blocks,
            "replay_capacity": trainer.buffer.capacity,
            "one_rank_blocks": -(-trainer.agent.cfg.buffer_size
                                 // trainer.n_global),
            "reduce_ms": reduce_ms,
            "updates_probed": SHARDED_PROBE_STEPS * tc.updates_per_step,
            "agent_cfg": dataclasses.asdict(agent.cfg),
            "final": to_device(state.agent_state, cpu),
            "state_in": to_device(s_in, cpu), "batch": to_device(batch, cpu),
            "noise": noise.cpu(), "new": to_device(new, cpu),
            "metrics": to_device(metrics, cpu),
            "peak_memory_bytes": torch.cuda.max_memory_allocated(dev)}, out)
    finally:
        distributed.shutdown()


def _run_ranks(argvs, timeout):
    """One process per argv, one time limit for all, every one of them
    stopped when it is reached; their exit codes."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    procs = [subprocess.Popen(a, cwd=ROOT, env=env) for a in argvs]
    deadline = time.perf_counter() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.perf_counter(), 1))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [p.returncode for p in procs]


def phase_sharded(torch, dev):
    """The sharded learner (``parallel/mesh.ShardedTrainer``) at the bench
    cell's full width as 2 gloo ranks on this one card, each its own
    process (NCCL takes one rank a card): the rate, the step's split, the
    all-reduce's time, each rank's kernel launches; then the two ranks'
    agent states bit-equal after the run, and their last update (each on
    its own half of the global batch, the gradients summed over the ranks
    and halved) held to the 1-rank update of the same global batch and
    noise on the card within ``error_bounds.check_update``. Two ranks on
    one card share it: a check of the path, not a scaling figure."""
    from crowdnav_tpu_torch.agents.replay import Transition
    from crowdnav_tpu_torch.agents.td3 import TD3, TD3Config
    from crowdnav_tpu_torch.utils.error_bounds import check_update
    from crowdnav_tpu_torch.utils.tree import to_device, tree_leaves
    torch.cuda.empty_cache()
    port = _free_port()
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"rank{r}.pt")
                for r in range(SHARDED_RANKS)]
        t0 = time.perf_counter()
        codes = _run_ranks([[
            sys.executable, "-c",
            "import sys, chip_smoke; chip_smoke.sharded_rank(*sys.argv[1:])",
            str(r), port, outs[r]] for r in range(SHARDED_RANKS)],
            SHARDED_TIMEOUT_S)
        wall = time.perf_counter() - t0
        if any(codes):
            raise AssertionError(f"sharded ranks exited with {codes}")
        res = [torch.load(o, weights_only=False) for o in outs]
    cpu = torch.device("cpu")
    for (k, a), (_, b) in zip(tree_leaves(res[0]["final"]),
                              tree_leaves(res[1]["final"])):
        if not torch.equal(a, b):
            raise AssertionError(f"the ranks' agent states differ: {k}")
    for (k, a), (_, b) in zip(tree_leaves(res[0]["new"]),
                              tree_leaves(res[1]["new"])):
        if not torch.equal(a, b):
            raise AssertionError(f"the ranks' last updates differ: {k}")
    agent = TD3(TD3Config(**res[0]["agent_cfg"]), 398, device=dev)
    s_in = res[0]["state_in"]
    batch = Transition(*(torch.cat([x, y]) for x, y in
                         zip(res[0]["batch"], res[1]["batch"])))
    noise = torch.cat([res[0]["noise"], res[1]["noise"]])
    new_1, m_1 = agent.update(to_device(s_in, dev), to_device(batch, dev),
                              smoothing_noise=noise.to(dev))
    shares = check_update(agent, s_in, batch, noise, res[0]["new"],
                          to_device(new_1, cpu), to_device(m_1, cpu))
    ranks = []
    for r in res:
        steps = r["timed_steps"]
        for name in ("raycast", "track_cp_topk_pallas"):
            if r["launches"][name] != steps:
                raise AssertionError(f"rank {r['rank']}: {name} launched "
                                     f"{r['launches'][name]} times in "
                                     f"{steps} steps")
        if r["replay_blocks"] != r["one_rank_blocks"]:
            raise AssertionError(f"rank {r['rank']}: a ring of "
                                 f"{r['replay_blocks']} blocks, the 1-rank "
                                 f"ring has {r['one_rank_blocks']}")
        ms = r["reduce_ms"]
        ranks.append({
            "rank": r["rank"], "envs": r["envs"], "rows": [r["rows"].start,
                                                          r["rows"].stop],
            "batch": r["batch_size"], "warmup_chunk_s": r["warmup_chunk_s"],
            "timed_steps": steps, "timed_wall_s": r["timed_wall_s"],
            "wall_ms_per_step": r["timed_wall_s"] * 1e3 / steps,
            "device_ms_per_step": r["device_ms_per_step"],
            "allreduce_calls": len(ms),
            "allreduce_ms_per_call": float(np.mean(ms)),
            "allreduce_ms_per_update": float(np.sum(ms))
            / r["updates_probed"],
            "launches": r["launches"], "replay_size": r["replay_size"],
            "replay_blocks": r["replay_blocks"],
            "replay_capacity": r["replay_capacity"],
            "peak_memory_bytes": r["peak_memory_bytes"]})
    n_all = sum(r["envs"] for r in res)
    slowest = max(r["timed_wall_s"] for r in res)
    out = {"ranks": ranks, "backend": "gloo", "devices": "cuda:0 (both)",
           "global_envs": n_all,
           "env_steps_per_s": n_all * res[0]["timed_steps"] / slowest,
           "episodes": res[0]["summary"]["episodes"],
           "summaries_equal": res[0]["summary"] == res[1]["summary"],
           "update_vs_one_rank": {"global_batch": int(noise.shape[0]),
                                  "max_bound_share": shares},
           "phase_wall_s": wall,
           "note": "two ranks share one card: a check of the sharded "
                   "path, not a scaling figure"}
    if not out["summaries_equal"]:
        raise AssertionError("the ranks drained different statistics")
    emit({"phase": "sharded", **out})
    return res


NCCL_FLAGS = ["--algo", "td3", "--world", "crowd_dense", "--behavior",
              "crowd", "--jitter", "1.0", "--replay-obs-dtype", "bfloat16",
              "--risk-backend", "pallas", "--n-envs", "1024", "--chunk", "16",
              "--env-steps", str(1024 * 16 * 3), "--updates-per-step", "2",
              "--batch-size", "1024", "--learn-start", "1024",
              "--reset-bank", "256", "--buffer-size", "65536",
              "--ckpt-every-chunks", "0", "--device", "cuda"]
NCCL_STEPS = 16 * 3


def phase_multihost_nccl(torch):
    """``drivers/train --multihost --num-processes 1`` on NCCL (the
    backend ``init_multihost`` picks for a card), the sharded trainer at
    one rank, 3 chunks of 16 steps at 1,024 envs with ``--profile-dir``:
    the driver's events, the kernels' launches, and what the profiler's
    trace of chunk 2 saw on the card."""
    import contextlib
    import io

    from crowdnav_tpu_torch.drivers import train as dtrain
    with tempfile.TemporaryDirectory() as out:
        prof = os.path.join(out, "prof")
        argv = NCCL_FLAGS + [
            "--outdir", out, "--profile-dir", prof, "--multihost",
            "--coordinator", f"localhost:{_free_port()}",
            "--num-processes", "1", "--process-id", "0"]
        buf = io.StringIO()
        _reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            dtrain.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _read_launches()
        events = [json.loads(x) for x in buf.getvalue().splitlines()
                  if x.startswith("{")]
        with open(os.path.join(prof, "chunk2_rank0.json")) as fp:
            trace = json.load(fp)["traceEvents"]
        files = sorted(os.listdir(out))
    kernels = [e for e in trace if e.get("cat") == "kernel"]
    names = [e.get("name", "") for e in kernels]
    summary = next(e for e in events if "process_count" in e)
    chunks = [e for e in events if "chunk" in e]
    out = {"process_summary": summary, "chunks": len(chunks),
           "sps": [c["sps"] for c in chunks],
           "critic_loss": chunks[-1].get("critic_loss"),
           "wall_s": wall, "launches": launches, "files": files,
           "trace_events": len(trace), "trace_device_kernels": len(kernels),
           "trace_device_kernel_us": sum(e.get("dur", 0) for e in kernels),
           "trace_raycast_kernels": sum("raycast" in n for n in names),
           "trace_track_kernels": sum("track_cp_topk" in n for n in names)}
    emit({"phase": "multihost_nccl", **out})
    if summary.get("backend") != "nccl" or len(chunks) != 3:
        raise AssertionError(f"multihost_nccl: {summary}, {len(chunks)} "
                             f"chunks")
    for name in ("raycast", "track_cp_topk_pallas"):
        # one a step, and one for each of the three resets of the run
        # (the env's template, the initial batch, the reset bank)
        if launches[name] != NCCL_STEPS + 3:
            raise AssertionError(f"multihost_nccl: {name} launched "
                                 f"{launches[name]} times")
    if not math.isfinite(out["critic_loss"]):
        raise AssertionError(f"multihost_nccl: {out['critic_loss']}")
    return out


DEPLOY_TICKS = 50


def phase_deploy(torch, dev):
    """``drivers/deploy_realworld.run_deployment`` in loopback, 50 ticks
    on the card and 50 on the CPU with one actor (random weights from a
    seed: no trained 370-dim actor is committed): the source's raycast
    kernel and the tracker kernel at K = 1 once a tick, every observation
    bit-equal to the CPU's, every action of both within the actor's
    derived float32 bound, the tick's latency."""
    from crowdnav_tpu_torch.agents.td3 import TD3, TD3Config
    from crowdnav_tpu_torch.drivers import deploy_realworld as deploy
    from crowdnav_tpu_torch.models.networks import flatten
    from crowdnav_tpu_torch.utils.error_bounds import (actor_action_bound,
                                                       within)
    agent = TD3(TD3Config(), 370, device="cpu").init(3)
    sd = {k: v.clone() for k, v in agent.actor.state_dict().items()}
    flat = flatten(agent.actor)
    runs, launches = {}, None
    for name, device in (("cpu", "cpu"), ("card", dev)):
        ticks, lat = [], []
        if name == "card":
            _reset_launches()
        hist = deploy.run_deployment(
            actor=sd, n_ticks=DEPLOY_TICKS, tick_period=0.0, device=device,
            latencies=lat, on_tick=lambda st, obs, a: ticks.append(
                (obs.cpu(), a.cpu())))
        if name == "card":
            launches = _read_launches()
        runs[name] = (hist, ticks, lat)
    (h_c, t_c, l_c), (h_g, t_g, l_g) = runs["cpu"], runs["card"]
    if not len(t_c) == len(t_g) == DEPLOY_TICKS:
        raise AssertionError(f"deploy: {len(t_c)} / {len(t_g)} ticks")
    shares = []
    for i, ((o_c, a_c), (o_g, a_g)) in enumerate(zip(t_c, t_g)):
        if _n_differ(torch, o_g, o_c):
            raise AssertionError(f"deploy tick {i}: the card's observation "
                                 f"differs from the CPU's")
        bnd = actor_action_bound(agent, flat, o_c.numpy())
        shares += [within(f"deploy tick {i} card", a_g.numpy(), bnd),
                   within(f"deploy tick {i} cpu", a_c.numpy(), bnd)]
    for name in ("raycast", "track_cp_topk"):
        # one a tick, and one for each of the env's template and the
        # loop's reset
        if launches[name] != DEPLOY_TICKS + 2:
            raise AssertionError(f"deploy: {name} launched "
                                 f"{launches[name]} times in "
                                 f"{DEPLOY_TICKS} ticks and 2 resets")
    lat_ms = np.array(l_g) * 1e3
    out = {"ticks": DEPLOY_TICKS, "obs_dim": int(t_g[0][0].shape[1]),
           "observations_bit_equal": True,
           "max_action_bound_share": max(shares),
           "final_dtg": h_g[-1][1], "launches": launches,
           "tick_ms_median": float(np.median(lat_ms)),
           "tick_ms_p90": float(np.percentile(lat_ms, 90)),
           "tick_ms_first": float(lat_ms[0]),
           "tick_ms_median_cpu": float(np.median(l_c) * 1e3)}
    emit({"phase": "deploy", **out})
    return out


TRAJ_STEPS = 200


def phase_trajectory(torch, dev):
    """``viz.trace_rollout`` of one ``crowd_dense``/``crossing`` env (no
    draws) under the goal seeker, 200 steps on the card and on the CPU,
    each written by ``viz.TrajectoryWriter``: the two CSVs byte-equal, the
    kernels once a step on the card."""
    from crowdnav_tpu_torch import baselines, viz
    from crowdnav_tpu_torch.envs.config import make_config
    from crowdnav_tpu_torch.envs.crowd_env import CrowdEnv
    cfg = make_config("crowd_dense", "crossing", max_steps=TRAJ_STEPS // 2)
    texts, launches, wall, ended = {}, None, None, None
    for name, device in (("cpu", "cpu"), ("card", dev)):
        env = CrowdEnv(cfg, device=device)
        if name == "card":
            _reset_launches()
            t0 = time.perf_counter()
        _, _, traj, _, dones = viz.trace_rollout(env, baselines.goal_seeker,
                                                 0, TRAJ_STEPS)
        if name == "card":
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = _read_launches()
            ended = int(dones.sum())
        with tempfile.TemporaryDirectory() as out:
            w = viz.TrajectoryWriter(out, "goal_seeker_trajectory")
            w.record_rollout(traj)
            with open(w.path) as fp:
                texts[name] = fp.read()
    rows = texts["card"].splitlines()
    out = {"steps": TRAJ_STEPS, "rows": len(rows), "episodes_ended": ended,
           "csv_bytes": len(texts["card"]),
           "csv_equal_to_cpu": texts["card"] == texts["cpu"],
           "first_row": rows[0], "last_row": rows[-1], "wall_s": wall,
           "launches": launches}
    emit({"phase": "trajectory", **out})
    if not out["csv_equal_to_cpu"] or len(rows) != TRAJ_STEPS:
        raise AssertionError("trajectory: the card's CSV differs from the "
                             "CPU's")
    for name in ("raycast", "track_cp_topk"):
        # one a step, and one for the rollout's reset
        if launches[name] != TRAJ_STEPS + 1:
            raise AssertionError(f"trajectory: {name} launched "
                                 f"{launches[name]} times")
    return out


NATIVE_STEPS = 64
NATIVE_POSE_ATOL = 1e-4     # tests/test_native.py's tolerances
NATIVE_SCAN_ATOL = 2e-3
# a beam whose float64 discriminant or hit distance lies this close to 0
# grazes a pedestrian: the two sides' last-bit differences may decide hit
# or miss differently there
GRAZE_EPS = 1e-6


def _gxx_version():
    res = subprocess.run(["g++", "--version"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.splitlines()[0]


def _omp_threads():
    """The OpenMP runtime's thread count (the one ``fastsim`` runs on)."""
    import ctypes.util
    name = ctypes.util.find_library("gomp")
    return ctypes.CDLL(name).omp_get_max_threads() if name else None


def _grazing(cfg, x, y, yaw, peds, env, beam):
    """Whether beam ``beam`` of env ``env`` (arrays of indices) grazes a
    pedestrian in float64, from the native side's state."""
    a = yaw[env].astype(np.float64) - beam * (math.pi / 180.0)
    dx, dy = np.cos(a)[:, None], np.sin(a)[:, None]
    rx = peds[env, :, 0].astype(np.float64) - x[env, None]
    ry = peds[env, :, 1].astype(np.float64) - y[env, None]
    b = rx * dx + ry * dy
    disc = cfg.ped_radius ** 2 - (rx * rx + ry * ry - b * b)
    th = b - np.sqrt(np.maximum(disc, 0.0))
    return ((np.abs(disc) <= GRAZE_EPS)
            | ((disc >= 0) & (np.abs(th) <= GRAZE_EPS))).any(axis=1)


def _done_codes(torch, cfg, pos, scans, step):
    """``fastsim``'s termination codes from a state and its raw scans:
    1 at the goal, 2 collided, 3 timed out, 0 live (in that order)."""
    from crowdnav_tpu_torch.utils import numerics as nm
    goal = torch.tensor(cfg.goal, dtype=torch.float32, device=pos.device)
    at_goal = (torch.abs(pos - goal) <= nm.f32(cfg.goal_eps)).all(dim=1)
    collided = scans.amin(dim=1) < nm.f32(cfg.min_scan_range) \
        if cfg.min_scan_range > 0 else torch.zeros_like(at_goal)
    code = torch.where(step >= cfg.max_steps, 3, 0)
    code = torch.where(collided, 2, code)
    return torch.where(at_goal, 1, code).to(torch.int32)


def _near_threshold(cfg, pos, min_scan):
    """Envs within tolerance of a termination threshold (the goal box,
    the collision range; step counts are integers, equal on both
    sides)."""
    off = np.abs(np.abs(pos - np.asarray(cfg.goal, np.float32))
                 - cfg.goal_eps)
    return (off <= NATIVE_POSE_ATOL).any(axis=1) | (
        np.abs(min_scan - cfg.min_scan_range) <= NATIVE_SCAN_ATOL)


def phase_native(torch, dev, smi):
    """The port's C++ host simulator (``crowdnav_tpu_torch/native``) built
    here by ``g++``, then held against the card's world step at the
    ``bench.py`` cell's width: 16,384 envs of ``crowd_dense``/``crowd``
    (jitter 0), 64 steps of random actions. Before each step the native
    batch is set to the card's state (pose, pedestrians, the step count,
    done 0) and given the crowd velocities the card draws for the step
    (built as the STATIC family, which keeps the state's velocities: its
    RANDOM family draws its own); the card steps with
    ``envs/world.world_step`` and the raycast (its XLA form), the native
    batch with ``FastSimBatch.step``. Robot pose and pedestrians within
    1e-4, scans within 2e-3 except beams that graze a pedestrian, done
    codes equal except in envs within tolerance of a threshold or with a
    grazing beam."""
    from crowdnav_tpu_torch import native
    from crowdnav_tpu_torch.envs import world
    from crowdnav_tpu_torch.envs.config import CrowdBehavior, make_config
    from crowdnav_tpu_torch.ops import lidar
    t0 = time.perf_counter()
    native.library()
    build_s = native.build_seconds
    cfg = make_config("crowd_dense", "crowd")
    n = N_BIG
    sim = native.FastSimBatch(
        dataclasses.replace(cfg, behavior=CrowdBehavior.STATIC), n)
    state = world.init_state(cfg, n, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.default_rng(0)
    worst = dict.fromkeys(("pose", "yaw", "peds", "scans"), 0.0)
    grazing = done_excused = done_differ = 0
    host_ms, card_ms, dones = [], [], np.zeros(4, np.int64)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    _reset_launches()
    for step in range(NATIVE_STEPS):
        act = np.stack([rng.uniform(0, 0.22, n), rng.uniform(-2, 2, n)],
                       1).astype(np.float32)
        vel = world.random_velocities(cfg, state.ped_pos.shape, gen, dev)
        for field, value in (("x", state.pos[:, 0]), ("y", state.pos[:, 1]),
                             ("yaw", state.yaw),
                             ("prev_x", state.prev_pos[:, 0]),
                             ("prev_y", state.prev_pos[:, 1]),
                             ("peds", state.ped_pos), ("ped_vel", vel),
                             ("step_count", state.step)):
            getattr(sim, field).copy_(value.cpu())
        sim.done.zero_()
        act_card = torch.from_numpy(act).to(dev)
        torch.cuda.synchronize()
        start.record()
        state = world.world_step(cfg, state, act_card, vel_draw=vel)
        scans = lidar.scan_batch(state.pos, state.yaw, state.ped_pos,
                                 cfg.ped_radius, cfg.room_half_inner,
                                 cfg.max_scan_range, cfg.lidar_min_range,
                                 cfg.n_scans)
        end.record()
        t = time.perf_counter()
        nscans = sim.step(act).numpy()
        host_ms.append((time.perf_counter() - t) * 1e3)
        torch.cuda.synchronize()
        card_ms.append(start.elapsed_time(end))
        codes = _done_codes(torch, cfg, state.pos, scans, state.step).cpu()
        pos, yaw = state.pos.cpu().numpy(), state.yaw.cpu().numpy()
        peds, cscans = state.ped_pos.cpu().numpy(), scans.cpu().numpy()
        x, y, nyaw = sim.x.numpy(), sim.y.numpy(), sim.yaw.numpy()
        npeds = sim.peds.numpy()
        dyaw = np.abs(yaw - nyaw)
        diffs = {"pose": np.abs(pos - np.stack([x, y], 1)).max(),
                 "yaw": np.minimum(dyaw, 2 * np.pi - dyaw).max(),
                 "peds": np.abs(peds - npeds).max()}
        for k, d in diffs.items():
            worst[k] = max(worst[k], float(d))
            if not d <= NATIVE_POSE_ATOL:
                raise AssertionError(f"native step {step}: {k} differs by "
                                     f"{d}")
        dscan = np.abs(cscans - nscans)
        env, beam = np.nonzero(dscan > NATIVE_SCAN_ATOL)
        graze = _grazing(cfg, x, y, nyaw, npeds, env, beam)
        if not graze.all():
            i = int(np.argmin(graze))
            raise AssertionError(
                f"native step {step}: env {env[i]} beam {beam[i]} scans "
                f"{cscans[env[i], beam[i]]} (card) {nscans[env[i], beam[i]]}"
                f" (native)")
        grazing += len(env)
        worst["scans"] = max(worst["scans"], float(np.where(
            dscan > NATIVE_SCAN_ATOL, 0.0, dscan).max()))
        ncodes = sim.done.numpy()
        dones += np.bincount(ncodes, minlength=4)
        differ = np.nonzero(codes.numpy() != ncodes)[0]
        excused = _near_threshold(cfg, pos[differ], np.minimum(
            cscans[differ].min(axis=1), nscans[differ].min(axis=1)))
        excused |= np.isin(differ, env)
        if not excused.all():
            i = differ[int(np.argmin(excused))]
            raise AssertionError(f"native step {step}: env {i} done "
                                 f"{int(codes[i])} (card) {int(ncodes[i])} "
                                 f"(native)")
        done_differ += len(differ)
        done_excused += int(excused.sum())
    launches = _read_launches()
    out = {"envs": n, "steps": NATIVE_STEPS, "world": "crowd_dense/crowd",
           "card": smi, "gxx": _gxx_version(), "gxx_flags": native.GXX_FLAGS,
           "build_s": build_s, "omp_threads": _omp_threads(),
           "host_cpu": _cpu_model(), "max_abs_diff": worst,
           "scan_atol": NATIVE_SCAN_ATOL, "pose_atol": NATIVE_POSE_ATOL,
           "grazing_beams_beyond_atol": grazing,
           "compared_beams": n * cfg.n_scans * NATIVE_STEPS,
           "done_codes_native": dict(zip(("live", "success", "collision",
                                          "timeout"), dones.tolist())),
           "done_codes_differing": done_differ,
           "done_codes_differing_excused": done_excused,
           "native_step_ms_median": float(np.median(host_ms)),
           "native_step_ms_all": host_ms,
           "card_world_step_raycast_ms_median": float(np.median(card_ms)),
           "card_ms_timing": "event pair around world_step + scan_batch "
                             "(the host's enqueue included)",
           "launches": launches, "seconds": time.perf_counter() - t0}
    emit({"phase": "native", **out})
    if launches["raycast"] != NATIVE_STEPS:
        raise AssertionError(f"native: the raycast launched "
                             f"{launches['raycast']} times in "
                             f"{NATIVE_STEPS} steps")
    return out


def phase_oracle(torch, dev, smi):
    """The ten scenarios of ``tests/test_parity.py``
    (``crowdnav_tpu_torch/parity/scenarios.py``): the port's ``CrowdEnv``
    on the card, one env, the raycast and the tracker kernel (its XLA
    form; its strict form in the strict scenario) on its path, against
    the port's NumPy oracle on the host, within that file's tolerances.
    Each scenario raises on its first violation."""
    from crowdnav_tpu_torch.parity import scenarios
    t0 = time.perf_counter()
    results = {}
    _reset_launches()
    for name in scenarios.SPECS:
        ts = time.perf_counter()
        results[name] = dict(scenarios.run(name, dev),
                             seconds=time.perf_counter() - ts)
    launches = _read_launches()
    steps = sum(r["steps"] for r in results.values())
    worst = {}
    for r in results.values():
        for k, v in r.get("max_abs", {}).items():
            worst[k] = max(worst.get(k, 0.0), v)
    out = {"scenarios": results, "steps_checked": steps, "card": smi,
           "max_abs_diff": worst,
           "tolerances": {"scans": scenarios.SCAN_ATOL,
                          "goal_features": scenarios.GOAL_ATOL,
                          "pose": scenarios.POSE_ATOL,
                          "reward": scenarios.REWARD_ATOL},
           "launches": launches, "seconds": time.perf_counter() - t0}
    emit({"phase": "oracle", **out})
    strict = results["strict_quirks_trajectory"]["steps"]
    for name, least in (("raycast", steps), ("track_cp_topk", steps - strict),
                        ("track_cp_topk_strict", strict)):
        if launches[name] < least:
            raise AssertionError(f"oracle: {name} launched {launches[name]} "
                                 f"times in {least} steps")
    return out


PARITY_ENVS = 1024
PARITY_STEPS = 40
SIMPLE_PARITY_STEPS = 50
# the configurations of the kernels' other forms and of the noise knobs,
# card vs CPU
PARITY_FORM_STEPS = 20
PARITY_FORMS = {
    "pallas_backends_noise": dict(risk_backend="pallas",
                                  lidar_backend="pallas",
                                  actuation_noise=0.05, dt_jitter=0.15,
                                  lidar_noise=0.005),
    "strict_quirks": dict(strict_quirks=True)}
# SimpleEnv runs the raycast's XLA form whatever its lidar_backend, as
# the JAX SimpleEnv does: the key shows that the option is ignored
PARITY_SIMPLE_FORM = dict(strict_quirks=True, lidar_backend="pallas",
                          actuation_noise=0.05, dt_jitter=0.15,
                          lidar_noise=0.005)
TRIG_SAMPLES = 1 << 20


def _n_differ(torch, a, b):
    """Elements of ``a`` and ``b`` (same shape and dtype) that differ bit
    for bit, counted on ``a``'s device."""
    a, b = a.contiguous(), b.to(a.device).contiguous()
    if a.dtype.is_floating_point:
        bits = {2: torch.int16, 4: torch.int32, 8: torch.int64}
        a = a.view(bits[a.element_size()])
        b = b.view(bits[b.element_size()])
    return int((a != b).sum())


def _trig_inputs(torch):
    """Float32 arguments for the trig check: the step's ranges (headings,
    angular rates, goal offsets), then random bit patterns of every finite
    float32."""
    g = torch.Generator().manual_seed(7)
    n = TRIG_SAMPLES // 2
    small = (torch.rand(n, generator=g) * 2 - 1) * (4 * math.pi)
    bits = torch.randint(-2 ** 31, 2 ** 31 - 1, (n,), generator=g,
                         dtype=torch.int64).to(torch.int32).view(
                             torch.float32)
    bits = torch.where(torch.isfinite(bits), bits, 0.5)
    x = torch.cat([small, bits])
    y = torch.cat([(torch.rand(n, generator=g) * 2 - 1) * 4,
                   torch.roll(bits, 1)])
    return x, y


def phase_step_parity(torch, dev):
    """The env step on the card against the step on the CPU, from the same
    input state at every step, so that differences do not compound."""
    from crowdnav_tpu_torch.drivers.evaluate import build_agent, \
        load_actor_file
    from crowdnav_tpu_torch.envs.config import make_config
    from crowdnav_tpu_torch.utils import numerics as nm
    from crowdnav_tpu_torch.utils.convert import flax_actor_to_state_dict
    t0 = time.perf_counter()
    _reset_launches()
    x, y = _trig_inputs(torch)
    trig = {}
    for name, fn, args in (("cos", nm.cos, (x,)), ("sin", nm.sin, (x,)),
                           ("atan2", nm.atan2, (y, x))):
        ref = fn(*args)
        got = fn(*(a.to(dev) for a in args))
        trig[name] = _n_differ(torch, got, ref)

    cpu = torch.device("cpu")
    params, meta = load_actor_file(ACTOR_FILE)
    agent = build_agent(meta["agent_config"],
                        make_config("crowd_dense", "crowd").state_dim_risk,
                        cpu)
    agent.load_actor(flax_actor_to_state_dict(params))
    cfg = make_config("crowd_dense", "crowd", jitter=1.0)
    crowd = _crowd_parity(torch, dev, cfg, agent, PARITY_STEPS)
    counts, first, n_elems = crowd["by_field"], crowd["first_difference"], \
        crowd["compared_elements"]
    forms = {}
    for name, over in PARITY_FORMS.items():
        forms[name] = _crowd_parity(
            torch, dev, make_config("crowd_dense", "crowd", jitter=1.0,
                                    **over), agent, PARITY_FORM_STEPS)
    total = sum(counts.values())
    simple = {mode: _simple_parity(torch, dev, mode == "discrete")
              for mode in ("continuous", "discrete")}
    simple["strict_noise_pallas_lidar"] = _simple_parity(
        torch, dev, False, steps=PARITY_FORM_STEPS, **PARITY_SIMPLE_FORM)
    launches = _read_launches()
    steps = sum(r["steps"] for r in
                [crowd, *forms.values(), *simple.values()])
    emit({"phase": "step_parity", "envs": PARITY_ENVS,
          "steps": PARITY_STEPS, "world": "crowd_dense/crowd, jitter 1.0",
          "differing_elements": total, "compared_elements": n_elems,
          "first_difference": first,
          "by_field": {k: v for k, v in counts.items() if v},
          "forms": forms, "simple_env": simple,
          "trig_samples": TRIG_SAMPLES, "trig_differing": trig,
          "glibc": os.confstr("CS_GNU_LIBC_VERSION"),
          "host_cpu": _cpu_model(), "launches": launches,
          "seconds": time.perf_counter() - t0})
    bad_simple = {m: r for m, r in simple.items() if r["differing_elements"]}
    bad_forms = {m: r for m, r in forms.items() if r["differing_elements"]}
    if total or any(trig.values()) or bad_simple or bad_forms:
        raise AssertionError(f"the card's step differs from the CPU's in "
                             f"{total} elements (first: {first}); trig "
                             f"samples differing: {trig}; SimpleEnv: "
                             f"{bad_simple}; forms: {bad_forms}")
    return {"launches": launches, "steps": steps}


SCENARIO_ENVS = 256
SCENARIO_STEPS = 30
SCENARIO_MAX_STEPS = 20      # every env auto-resets inside the 30 steps
SCENARIO_ARMS = ("no_cp", "basic", "basic_grp", "basic_grp_cp",
                 "basic_grp_cp_gcp", "no_cpdto")
SCENARIO_ROBOTS = ("burger", "burger2", "waffle", "waffle_naked")
# SimpleEnv on the worlds of SAC's and DQN's suites, and with the waffle
SCENARIO_SIMPLE = (("test_20", "random_20", None),
                   ("crowd_sparse", "crowd", None),
                   ("test_20", "random_20", "waffle"))
PALLAS_BACKENDS = dict(risk_backend="pallas", lidar_backend="pallas")


def scenario_cases():
    """``(name, world, behavior, overrides)`` of every ``CrowdEnv`` preset
    the CPU tests hold to the JAX package (``tests/torch_presets.py``):
    the distinct scenarios of the evaluation suites other than ``train``
    and the pillars world, each ablation arm and each robot on
    ``crowd_dense``/``crowd``, the waffle with the TTC-only CP on
    ``test_12``/``random``; then suite ``20`` again under both kernels'
    Pallas forms."""
    from crowdnav_tpu_torch.drivers.evaluate import SUITES
    pairs = []
    for suite, scen in SUITES.items():
        pairs += [p for p in scen if suite != "train" and p not in pairs]
    pairs.append(("turtlebot3_world_pillars", None))
    cases = [(f"{w}/{b}", w, b, {}) for w, b in pairs]
    cases += [(f"arm {a}", "crowd_dense", "crowd", dict(ablation=a))
              for a in SCENARIO_ARMS]
    cases += [(f"robot {r}", "crowd_dense", "crowd", dict(robot=r))
              for r in SCENARIO_ROBOTS]
    cases.append(("test_12/random waffle basic_grp_cp", "test_12", "random",
                  dict(robot="waffle", ablation="basic_grp_cp")))
    cases += [(f"{w}/{b} pallas backends", w, b, PALLAS_BACKENDS)
              for w, b in SUITES["20"]]
    return cases


def phase_scenario_parity(torch, dev):
    """The env step on the card against the step on the CPU on every
    preset the CPU tests hold to the JAX package: ``SCENARIO_ENVS`` envs x
    ``SCENARIO_STEPS`` steps each (``max_steps`` ``SCENARIO_MAX_STEPS``,
    jitter 1.0), both sides stepped from the same CPU state with the same
    draws every step (``_crowd_parity``, ``_simple_parity``). The full
    398-dim state takes the ``final_full`` actor's greedy actions, the
    other state variants seeded uniform actions."""
    from crowdnav_tpu_torch.drivers.evaluate import build_agent, \
        load_actor_file
    from crowdnav_tpu_torch.envs.config import make_config
    from crowdnav_tpu_torch.utils.convert import flax_actor_to_state_dict
    t0 = time.perf_counter()
    cpu = torch.device("cpu")
    params, meta = load_actor_file(ACTOR_FILE)
    dim = make_config("crowd_dense", "crowd").state_dim_risk
    agent = build_agent(meta["agent_config"], dim, cpu)
    agent.load_actor(flax_actor_to_state_dict(params))
    _reset_launches()
    results = {}
    for name, world_name, behavior, over in scenario_cases():
        cfg = make_config(world_name, behavior, jitter=1.0,
                          max_steps=SCENARIO_MAX_STEPS, **over)
        full = cfg.state_variant == "full"
        assert not full or cfg.state_dim_risk == dim, name
        r = _crowd_parity(torch, dev, cfg, agent if full else None,
                          SCENARIO_STEPS, envs=SCENARIO_ENVS)
        results[name] = {"actions": "final_full" if full else "uniform",
                         **{k: r[k] for k in (
                             "differing_elements", "compared_elements",
                             "first_difference", "auto_resets")}}
    for world_name, behavior, robot in SCENARIO_SIMPLE:
        for mode in ("continuous", "discrete"):
            r = _simple_parity(
                torch, dev, mode == "discrete", steps=SCENARIO_STEPS,
                world_name=world_name, behavior=behavior,
                envs=SCENARIO_ENVS, max_steps=SCENARIO_MAX_STEPS,
                robot=robot)
            results[f"simple {world_name}/{behavior} {robot or 'burger'} "
                    f"{mode}"] = {"actions": "uniform", **{k: r[k] for k in (
                        "differing_elements", "compared_elements",
                        "first_difference", "auto_resets")}}
    launches = _read_launches()
    total = sum(r["differing_elements"] for r in results.values())
    out = {"phase": "scenario_parity", "envs": SCENARIO_ENVS,
           "steps": SCENARIO_STEPS, "max_steps": SCENARIO_MAX_STEPS,
           "jitter": 1.0, "scenarios": results,
           "differing_elements": total,
           "compared_elements": sum(r["compared_elements"]
                                    for r in results.values()),
           "launches": launches, "seconds": time.perf_counter() - t0}
    emit(out)
    bad = {k: r for k, r in results.items() if r["differing_elements"]}
    if bad:
        raise AssertionError(f"scenario_parity: the card's step differs "
                             f"from the CPU's in {total} elements: {bad}")
    no_reset = [k for k, r in results.items() if not r["auto_resets"]]
    if no_reset:
        raise AssertionError(f"scenario_parity: no auto-reset in {no_reset}")
    for kernel in ("raycast", "raycast_pallas", "track_cp_topk",
                   "track_cp_topk_pallas"):
        if not launches[kernel]:
            raise AssertionError(f"scenario_parity: {kernel} never launched")
    return {"launches": launches,
            "steps": SCENARIO_STEPS * len(results)}


def _noise(torch, cfg, n, gen):
    """The step's noise knobs' draws, made once on the CPU for both
    sides (an empty dict without knobs)."""
    from crowdnav_tpu_torch.envs import world
    from crowdnav_tpu_torch.envs.crowd_env import lidar_noise_draw
    cpu = torch.device("cpu")
    d = world.noise_draws(cfg, n, gen, cpu)
    if cfg.lidar_noise > 0.0:
        d["lidar"] = lidar_noise_draw(cfg, n, gen, cpu)
    return d


def _uniform_actions(torch, n, gen):
    """(n, 2) uniform (lin, ang) actions over the robot's box, drawn on the
    CPU from ``gen``."""
    return torch.rand((n, 2), generator=gen) \
        * torch.tensor([0.22, 4.0]) - torch.tensor([0.0, 2.0])


def _crowd_parity(torch, dev, cfg, agent, steps, envs=PARITY_ENVS):
    """``CrowdEnv`` with ``cfg``, ``envs`` envs x ``steps`` steps of the
    ``final_full`` actor's greedy actions (seeded uniform actions when
    ``agent`` is None), each step taken from the same CPU state on both
    devices with the same crowd and noise draws: the differing elements,
    by field, and the first difference."""
    from crowdnav_tpu_torch.envs import world
    from crowdnav_tpu_torch.envs.crowd_env import CrowdEnv
    from crowdnav_tpu_torch.utils.tree import to_device, tree_leaves
    cpu = torch.device("cpu")
    env_c = CrowdEnv(cfg, device=cpu, seed=0)
    env_g = CrowdEnv(cfg, device=dev, seed=0)
    # the card's auto-reset template is the CPU's (the two generators
    # draw different numbers from one seed)
    env_g.template = to_device(env_c.template, dev)
    gen = torch.Generator().manual_seed(0)
    state, obs = env_c.reset(envs, gen)
    counts, first, n_elems, resets = {}, None, 0, 0
    for step in range(steps):
        act = agent.act(obs) if agent is not None else \
            _uniform_actions(torch, envs, gen)
        # the crowd's fresh velocities and the noise, drawn once
        vel = world.random_velocities(cfg, state.ped_pos.shape, gen, cpu)
        noise = _noise(torch, cfg, envs, gen)
        out_c = env_c.step_batch(state, act, vel_draw=vel, noise=noise)
        out_g = env_g.step_batch(
            to_device(state, dev), act.to(dev), vel_draw=vel.to(dev),
            noise={k: v.to(dev) for k, v in noise.items()})
        # in the order the step computes them: kinematics and crowd,
        # perception, observation, reward
        pairs = [(f"state.{n}", g, c) for (n, g), (_, c) in zip(
            tree_leaves(out_g.state), tree_leaves(out_c.state))]
        pairs += [("obs", out_g.obs, out_c.obs),
                  ("reward", out_g.reward, out_c.reward),
                  ("done", out_g.done, out_c.done)]
        for name, g, c in pairs:
            d = _n_differ(torch, g, c)
            counts[name] = counts.get(name, 0) + d
            n_elems += c.numel()
            if d and first is None:
                first = {"step": step, "field": name, "elements": d,
                         "fields": [n for n, g2, c2 in pairs
                                    if _n_differ(torch, g2, c2)]}
        resets += int(state.done.sum())
        state, obs = out_c.state, out_c.obs
    return {"config": {k: getattr(cfg, k) for k in
                       ("risk_backend", "lidar_backend", "strict_quirks",
                        "actuation_noise", "dt_jitter", "lidar_noise")},
            "envs": envs, "steps": steps, "auto_resets": resets,
            "differing_elements": sum(counts.values()),
            "compared_elements": n_elems, "first_difference": first,
            "by_field": {k: v for k, v in counts.items() if v}}


def _simple_parity(torch, dev, discrete, steps=None, *,
                   world_name="crowd_sparse", behavior="random",
                   envs=PARITY_ENVS, max_steps=40, **over):
    """``SimpleEnv`` on ``world_name``/``behavior`` (jitter 1.0,
    ``max_steps``, and the config overrides ``over``), ``envs`` envs, each
    step taken from the same CPU state on both devices with the same
    random actions (indices into the discrete table, or (lin, ang) from
    the box), crowd velocities and noise; the number of differing
    elements."""
    from crowdnav_tpu_torch.envs import world
    from crowdnav_tpu_torch.envs.config import make_config
    from crowdnav_tpu_torch.envs.simple_env import SimpleEnv
    from crowdnav_tpu_torch.utils.tree import to_device, tree_leaves
    cfg = make_config(world_name, behavior, jitter=1.0, max_steps=max_steps,
                      **over)
    steps = SIMPLE_PARITY_STEPS if steps is None else steps
    cpu = torch.device("cpu")
    env_c, env_g = SimpleEnv(cfg, cpu), SimpleEnv(cfg, dev)
    env_g.template = to_device(env_c.template, dev)
    gen = torch.Generator().manual_seed(3)
    state, obs = env_c.reset(envs, gen)
    differ, n_elems, first, resets = 0, 0, None, 0
    for step in range(steps):
        if discrete:
            act = torch.randint(0, 3, (envs,), generator=gen)
            fn_c, fn_g = env_c.step_discrete, env_g.step_discrete
        else:
            act = _uniform_actions(torch, envs, gen)
            fn_c, fn_g = env_c.step_batch, env_g.step_batch
        vel = world.random_velocities(cfg, state.ped_pos.shape, gen, cpu)
        noise = _noise(torch, cfg, envs, gen)
        out_c = fn_c(state, act, vel_draw=vel, noise=noise)
        out_g = fn_g(to_device(state, dev), act.to(dev),
                     vel_draw=vel.to(dev),
                     noise={k: v.to(dev) for k, v in noise.items()})
        pairs = [(f"state.{n}", g, c) for (n, g), (_, c) in zip(
            tree_leaves(out_g.state), tree_leaves(out_c.state))]
        pairs += [("obs", out_g.obs, out_c.obs),
                  ("reward", out_g.reward, out_c.reward),
                  ("done", out_g.done, out_c.done)]
        for name, g, c in pairs:
            d = _n_differ(torch, g, c)
            differ += d
            n_elems += c.numel()
            if d and first is None:
                first = {"step": step, "field": name, "elements": d}
        resets += int(state.done.sum())
        state = out_c.state
    return {"world": f"{world_name}/{behavior}, jitter 1.0, max_steps "
                     f"{max_steps}",
            "overrides": over, "envs": envs, "steps": steps,
            "auto_resets": resets, "differing_elements": differ,
            "compared_elements": n_elems, "first_difference": first}


def _cpu_model():
    """The host CPU: model, vendor, FMA and AVX2, and the ``rsqrt`` form
    the port replays on it (``utils/numerics.rsqrt_form``)."""
    from crowdnav_tpu_torch.utils import numerics as nm
    try:
        with open("/proc/cpuinfo") as fp:
            info = fp.read()
    except OSError:
        return None
    model = next((line.split(":", 1)[1].strip() for line in
                  info.splitlines() if line.startswith("model name")), None)
    flags = next((line.split(":", 1)[1].split() for line in
                  info.splitlines() if line.startswith("flags")), [])
    form = nm.RSQRT_FORMS.get(nm.cpu_vendor())
    return {"model": model, "vendor": nm.cpu_vendor(),
            "fma": "fma" in flags, "avx2": "avx2" in flags,
            "rsqrt_form": None if form is None else
            {"table": form.table, "newton_steps": form.newton_steps}}


KERNELS = (
    ("raycast", "crowdnav_tpu_torch/kernels/csrc/raycast.cu",
     "crowdnav_tpu/ops/lidar_pallas.py:32",
     "_raycast_kernel, launched by scan_batch_pallas (the XLA form of "
     "lidar.scan)", "jitted_cell"),
    ("raycast_pallas", "crowdnav_tpu_torch/kernels/csrc/raycast.cu",
     "crowdnav_tpu/ops/lidar_pallas.py:32",
     "_raycast_kernel, launched by scan_batch_pallas (its own arithmetic, "
     "lidar_backend='pallas')", "jitted_pallas_backends_noise"),
    ("track_cp_topk", "crowdnav_tpu_torch/kernels/csrc/track_cp_topk.cu",
     "crowdnav_tpu/ops/risk_pallas.py:61",
     "_kernel, launched by track_cp_topk_batch (the XLA chain's "
     "arithmetic, risk_backend='xla')", "jitted_evaluate"),
    ("track_cp_topk_pallas",
     "crowdnav_tpu_torch/kernels/csrc/track_cp_topk.cu",
     "crowdnav_tpu/ops/risk_pallas.py:61",
     "_kernel, launched by track_cp_topk_batch (its own arithmetic, "
     "risk_backend='pallas')", "jitted_cell"),
    ("track_cp_topk_strict",
     "crowdnav_tpu_torch/kernels/csrc/track_cp_topk.cu",
     "crowdnav_tpu/ops/risk_pallas.py:61",
     "_kernel's chain under strict_quirks (the XLA chain's strict first "
     "track speed and top-K, crowdnav_tpu/ops/risk.py:349,388)",
     "jitted_strict_quirks"),
    ("libm_sincos", "crowdnav_tpu_torch/kernels/csrc/libm_trig.cu",
     "crowdnav_tpu/envs/world.py:196",
     "no TPU kernel: the C library's cosf/sinf that the reference's CPU "
     "step calls (world.py:196, ops/lidar.py:41, envs/crowd_env.py:127)",
     "jitted_cell"),
    ("libm_atan2", "crowdnav_tpu_torch/kernels/csrc/libm_trig.cu",
     "crowdnav_tpu/ops/geom.py:34",
     "no TPU kernel: the C library's atan2f that the reference's CPU step "
     "calls (ops/geom.py:34, envs/world.py:143)", "jitted_cell"))


def kernel_line(smi, stats, paths, evaluate, train_agents, eval_agents):
    """One entry per kernel form: device time, bound, plain and library
    times at 16,384 envs (and every measured shape, with the earlier
    designs' times); ``launches`` in the profiler's window of replays of
    the captured graph that runs the form (``launches_path`` names it: the
    bench cell's training through ``Trainer.make_jitted``, the main path,
    for the forms it runs; the Pallas backends' and the strict quirks'
    training;
    the TD3 evaluation for the tracker's XLA form), and the launches on
    every other path: each training run, the TD3 evaluation, DDPG's,
    SAC's and DQN's training and evaluation, each graph path
    (``launches_jitted_<path>``)."""
    kernels = []
    for name, src, replaces, what, path in KERNELS:
        st = stats[name]
        big = st["shapes"][N_BIG]
        lib = big.get("library_ms")
        run = paths[path]
        entry = {
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "tpu_kernel": f"{replaces} {what}",
            "launches": run["launches"][name], "launches_path": path,
            "launches_per_step": run["launches"][name] / run["steps"],
            "launches_evaluate": evaluate["launches"][name],
            "launches_per_evaluate_step": evaluate["launches"][name]
            / evaluate["steps"],
            "max_abs_err": st["max_abs"], "max_abs_diff": st["max_abs"],
            "ms": big["device_ms"], "kernel_ms": big["device_ms"],
            "plain_ms": big["plain_ms"], "bound_ms": big["bound_ms"],
            "bound_by": big["bound_by"], "library_ms": lib,
            "card": smi, "timing": TIMING}
        if "bound_ms_all_pairs" in big:
            entry["bound_ms_all_pairs"] = big["bound_ms_all_pairs"]
        for other, r in paths.items():
            entry[f"launches_{other}"] = r["launches"][name]
        if lib is None:
            entry["library_ms_reason"] = "no single PyTorch call computes it"
        else:
            entry["library_ms_reason"] = (
                "torch.cos / torch.atan2 on the card: the same function, "
                "not the C library's values")
        for algo, counts in train_agents.items():
            entry[f"launches_train_{algo}"] = counts[name]
        for algo, counts in eval_agents.items():
            entry[f"launches_evaluate_{algo}"] = counts[name]
        for n, sh in st["shapes"].items():
            n = f"n{n}" if isinstance(n, int) else n
            entry.update({
                f"device_ms_{n}": sh["device_ms"],
                f"plain_ms_{n}": sh["plain_ms"],
                f"bound_ms_{n}": sh["bound_ms"],
                f"bound_by_{n}": sh["bound_by"],
                f"bound_share_{n}": sh["bound_ms"] / sh["device_ms"]})
            if "bound_ms_all_pairs" in sh:
                entry[f"bound_ms_all_pairs_{n}"] = sh["bound_ms_all_pairs"]
            for design in ("first_design", "second_design"):
                if f"{design}_device_ms" in sh:
                    entry[f"{design}_device_ms_{n}"] = \
                        sh[f"{design}_device_ms"]
            if "library_ms" in sh:
                entry[f"library_ms_{n}"] = sh["library_ms"]
        kernels.append(entry)
    return kernels


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
    first_lib, second_lib = phase_build()
    step_parity = phase_step_parity(torch, dev)
    scenario_parity = phase_scenario_parity(torch, dev)
    stats = {"raycast": phase_raycast(torch, dev, first_lib, second_lib),
             "track_cp_topk": phase_track(torch, dev, first_lib)}
    rollouts = phase_forms_rollout(torch, dev)
    forms = phase_kernel_forms(torch, dev, second_lib, rollouts)
    stats["raycast"]["shapes"].update(forms.pop("raycast_xla")["shapes"])
    stats.update(forms)
    stats.update(phase_libm(torch, dev))
    evaluate = phase_evaluate(torch)
    train = phase_train(torch, dev)
    train_pallas = phase_train_pallas(torch)
    jitted = phase_jitted(torch, smi)
    train_forms = phase_train_forms(torch)
    phase_bf16(torch, dev)
    phase_tabular(torch)
    train_agents = phase_train_agents(torch, dev)
    eval_agents = phase_evaluate_agents(torch)
    sharded = phase_sharded(torch, dev)
    nccl = phase_multihost_nccl(torch)
    deploy = phase_deploy(torch, dev)
    trajectory = phase_trajectory(torch, dev)
    native_run = phase_native(torch, dev, smi)
    oracle = phase_oracle(torch, dev, smi)
    paths = {"train_pallas": {"launches": train_pallas["launches"],
                              "steps": train_pallas["timed_steps"]},
             "train": {"launches": train["launches"],
                       "steps": train["timed_steps"]}}
    for r in sharded:
        paths[f"sharded_rank{r['rank']}"] = {"launches": r["launches"],
                                             "steps": r["timed_steps"]}
    paths["multihost_nccl"] = {"launches": nccl["launches"],
                               "steps": NCCL_STEPS}
    paths["deploy"] = {"launches": deploy["launches"],
                       "steps": DEPLOY_TICKS}
    paths["trajectory"] = {"launches": trajectory["launches"],
                           "steps": TRAJ_STEPS}
    paths["native"] = {"launches": native_run["launches"],
                       "steps": NATIVE_STEPS}
    paths["oracle"] = {"launches": oracle["launches"],
                       "steps": oracle["steps_checked"]}
    for name, counts in train_forms.items():
        paths[name] = {"launches": counts, "steps": FORM_CHUNK}
    for name, r in rollouts.items():
        paths[name] = {"launches": r["launches"], "steps": r["steps"]}
    paths.update(jitted)
    paths["step_parity"] = step_parity
    paths["scenario_parity"] = scenario_parity
    emit({"kernels": kernel_line(smi, stats, paths, evaluate, train_agents,
                                 eval_agents)})
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
