"""Training throughput of the PyTorch port on one card: the cell of the
JAX package's ``bench.py`` (``bench_config``), run through the functions
the port's ``drivers/train`` calls.

    python scripts/bench_torch_train.py [--repeats 3] [--profile-steps 8]
        [--risk-backend pallas] [--dtype float32] [--with-pallas-lidar]

The cell, as ``bench.py`` builds it: world ``crowd_dense``, behavior
``crowd``, jitter 1.0, the env config's ``max_steps``, reset bank 256,
the 398-dim observation, 16,384 envs, chunks of 64 steps, 32 updates x
batch 4,096 a batched step, ``learn_start`` 256, bfloat16 replay
observations, the tracker's Pallas form (``--risk-backend``, default
``pallas`` as ``bench.py``), the learner's ``--dtype`` (float32 by
default) with TF32 off, and ``TD3Config``'s exploration defaults (a
constant Gaussian sigma of 1.0, no uniform mixing, no epsilon spectrum).
Each repeat builds a fresh trainer, runs one warm-up chunk and
``--iters`` timed chunks (host clock around work that ends in a device
synchronisation), for the learning variant and the no-learn variant (the
evaluation rollout, greedy actions, no replay), each through
``Trainer.make_jitted`` (one captured CUDA graph of the step, as
``bench.py:122`` runs its jitted chunk) and through the eager
``rollout_chunk``, in turns. Prints one JSON line: env-steps/s of each
variant, ``learning`` and ``no_learn`` through the graph,
``learning_eager`` and ``no_learn_eager`` eagerly (median, min, max over
the repeats), peak device memory (the graph's pool included), the card's
name and power limit, the host's CPU model, and with ``--profile-steps`` a
``torch.profiler`` window of the learning step, ``profile`` over replays
and ``profile_eager`` over eager steps (device busy share, device
operations per step, the largest kernels), and the capture's seconds. With
``--with-pallas-lidar`` a line for the raycast's Pallas form comes first,
as ``bench.py`` prints it; the main configuration's line is the last. It
needs a CUDA device; it fails without one.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def flags(args):
    """The port's ``drivers/train`` command line of the cell."""
    from crowdnav_tpu_torch.envs.config import EnvConfig
    return ["--algo", "td3", "--world", "crowd_dense", "--behavior",
            "crowd", "--jitter", "1.0", "--max-steps",
            str(EnvConfig.max_steps), "--reset-bank", "256", "--n-envs",
            str(args.n_envs), "--chunk", str(args.chunk),
            "--updates-per-step", str(args.updates_per_step),
            "--batch-size", str(args.batch_size), "--learn-start", "256",
            "--replay-obs-dtype", args.replay_obs_dtype, "--risk-backend",
            args.risk_backend, "--learner-dtype", args.dtype, "--seed", "0",
            "--device", "cuda"]


def build(args, learning: bool, lidar_backend: str = "xla", device=None):
    """The cell's trainer on ``device`` (default the card); with
    ``learning`` False the no-learn variant, which holds no replay ring."""
    from crowdnav_tpu_torch.drivers import train as dtrain
    return dtrain.build(dtrain.parser().parse_args(flags(args)),
                        device=device, learning=learning,
                        lidar_backend=lidar_backend)


def run(args, learning: bool, torch, lidar_backend: str = "xla",
        jitted: bool = True):
    """One repeat: a fresh trainer, a warm-up chunk and ``--iters`` timed
    chunks, through ``Trainer.make_jitted`` (the captured graph, as
    ``bench.py:122`` runs its jitted chunk) or, with ``jitted`` False,
    the eager ``rollout_chunk``."""
    trainer = build(args, learning, lidar_backend)
    state = trainer.init(0)
    if not learning:
        trainer.agent.init(0)
    chunk = trainer.make_jitted() if jitted else trainer.rollout_chunk
    state = chunk(state)                          # warm-up chunk
    _, state = trainer.drain_stats(state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.iters):
        state = chunk(state)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    summary, state = trainer.drain_stats(state)
    sps = args.n_envs * args.chunk * args.iters / dt
    return sps, trainer, state, chunk


def profile(args, step, torch):
    """Device busy share and launches per step over ``--profile-steps``
    calls of ``step`` (one env step: an eager step, or a replay)."""
    from torch.profiler import ProfilerActivity
    prof, card, wall_ms = marked_window(
        torch, step, args.profile_steps,
        [ProfilerActivity.CPU, ProfilerActivity.CUDA])
    return trace_summary(prof, card, args.profile_steps, wall_ms)


# the two marker kernels of a window (``torch.cuda._sleep`` cycles), and
# the host's wait at each end of it
MARK_CYCLES = 100
HOLD_S = 0.05


def marked_window(torch, step, steps, activities):
    """``steps`` calls of ``step`` in a ``torch.profiler`` window with
    ``activities``. The profiler loses some of the card's records at a
    window's start (seen on an H100 with PyTorch 2.11), so the counted
    calls run between two marker kernels, after
    and before one call that is not counted and 50 ms of the host's
    wait; only the card's records between the markers count. Returns the
    profiler, those records in the order they started, and the host's ms
    for the counted calls (from an idle card to the last one's end)."""
    from torch.profiler import profile as tprofile
    torch.cuda.synchronize()
    with tprofile(activities=activities) as prof:
        time.sleep(HOLD_S)
        step()
        torch.cuda._sleep(MARK_CYCLES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda._sleep(MARK_CYCLES)
        step()
        torch.cuda.synchronize()
        time.sleep(HOLD_S)
    card = sorted((e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA),
                  key=lambda e: e.time_range.start)
    marks = [i for i, e in enumerate(card) if "spin_kernel" in e.name]
    if len(marks) != 2:
        raise RuntimeError(f"profiler window: {len(marks)} of its 2 marker "
                           f"kernels recorded")
    return prof, card[marks[0] + 1:marks[1]], wall_ms


def trace_summary(prof, card, steps, wall_ms):
    """A ``torch.profiler`` window of ``steps`` env steps
    (:func:`marked_window`; ``card``: the card's records of those steps):
    the device's busy time (kernels and copies, overlaps merged) and its
    share of the window, device operations a step, the largest kernels
    and the host's largest calls (over the window's ``steps`` + 2
    calls)."""
    busy = sorted((e.time_range.start, e.time_range.end) for e in card)
    merged, cur = 0.0, None
    for s, e in busy:
        if cur is None or s > cur[1]:
            if cur is not None:
                merged += cur[1] - cur[0]
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    if cur is not None:
        merged += cur[1] - cur[0]
    span_us = (busy[-1][1] - busy[0][0]) if busy else 0.0
    by_name = {}
    for e in card:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    host = {}
    calls = steps + 2
    for e in prof.key_averages():
        if e.key.startswith("cuda") or e.key.startswith("aten::"):
            host[e.key] = (e.count / calls, e.self_cpu_time_total / 1e3
                           / calls)
    host_top = sorted(host.items(), key=lambda kv: -kv[1][1])[:15]
    return {"steps": steps, "traced_wall_ms_per_step": wall_ms / steps,
            "device_busy_ms_per_step": merged / 1e3 / steps,
            "device_busy_share_of_kernel_span": merged / max(span_us, 1e-9),
            "device_busy_share_of_wall": merged / 1e3 / max(wall_ms, 1e-9),
            "kernel_launches_per_step": len(card) / steps,
            "top_kernels_ms_per_step": {k[:80]: v / 1e3 / steps
                                        for k, v in top},
            "host_calls_per_step_and_self_ms": {k: [round(c, 1), round(t, 3)]
                                                for k, (c, t) in host_top}}


def host_cpu():
    """The host's CPU model (``/proc/cpuinfo``), or None."""
    try:
        with open("/proc/cpuinfo") as fp:
            for line in fp:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return None


def parser():
    """``bench.py``'s options (the same names and defaults), and the
    port's ``--repeats`` and ``--profile-steps``."""
    p = argparse.ArgumentParser()
    p.add_argument("--n-envs", type=int, default=16384)
    p.add_argument("--chunk", type=int, default=64)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--updates-per-step", type=int, default=32)
    p.add_argument("--batch-size", type=int, default=4096)
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="the learner's compute dtype (TD3Config)")
    p.add_argument("--replay-obs-dtype", default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--risk-backend", default="pallas",
                   choices=["xla", "pallas"],
                   help="the tracker kernel's form; bench.py's default")
    p.add_argument("--with-pallas-lidar", action="store_true",
                   help="first a line with the raycast's Pallas form")
    p.add_argument("--profile-steps", type=int, default=0)
    return p


def measure(args, torch, lidar_backend: str, smi: str):
    """One configuration's JSON line: both variants over the repeats."""
    out = {"metric": "env_steps_per_sec_td3_risk_k8_crowd_dense_torch",
           "unit": "env-steps/s", "card": smi,
           "device": torch.cuda.get_device_name(0), "host_cpu": host_cpu(),
           "config": {"n_envs": args.n_envs, "chunk": args.chunk,
                      "iters": args.iters, "repeats": args.repeats,
                      "updates_per_step": args.updates_per_step,
                      "batch_size": args.batch_size, "reset_bank": 256,
                      "replay_obs_dtype": args.replay_obs_dtype,
                      "jitter": 1.0, "dtype": args.dtype,
                      "risk_backend": args.risk_backend,
                      "lidar_backend": lidar_backend,
                      "explore": "TD3Config defaults (sigma 1.0, no "
                                 "uniform mixing, no spectrum)",
                      "matmul_allow_tf32": False}}
    if lidar_backend == "pallas":
        out["metric"] += "_pallas_lidar"
    for learning in (True, False):
        name = "learning" if learning else "no_learn"
        rates = {True: [], False: []}
        peak = {}
        for r in range(args.repeats):
            # the graph and the eager loop in turns, each in a fresh trainer
            for jitted in ((True, False) if r % 2 == 0 else (False, True)):
                torch.cuda.reset_peak_memory_stats()
                sps, trainer, state, chunk = run(args, learning, torch,
                                                 lidar_backend, jitted)
                rates[jitted].append(sps)
                peak[jitted] = max(peak.get(jitted, 0),
                                   torch.cuda.max_memory_allocated())
                if learning and args.profile_steps and r == 0:
                    key = "profile" if jitted else "profile_eager"
                    box = [state]

                    def eager_step():
                        box[0] = trainer._train_step(box[0])
                    out[key] = profile(args, chunk.graph.replay if jitted
                                       else eager_step, torch)
                    del box
                    if jitted:
                        out["capture_s"] = chunk.capture_s
                del trainer, state, chunk
        for jitted, suffix in ((True, ""), (False, "_eager")):
            runs = rates[jitted]
            out[name + suffix] = {
                "median": statistics.median(runs), "min": min(runs),
                "max": max(runs), "runs": runs,
                "peak_memory_bytes": peak[jitted]}
    out["value"] = out["learning"]["median"]
    return out


def main(argv=None):
    args = parser().parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("bench_torch_train: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    if args.with_pallas_lidar:
        print(json.dumps(measure(args, torch, "pallas", smi)), flush=True)
    # the main configuration last, as bench.py prints it
    out = measure(args, torch, "xla", smi)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
