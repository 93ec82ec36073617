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
evaluation rollout, greedy actions, no replay). Prints one JSON line:
env-steps/s of each variant (median, min, max over the repeats), peak
device memory, the card's name and power limit, the host's CPU model, and
with ``--profile-steps`` a ``torch.profiler`` window of the learning step
(device busy share, kernel launches per step, the largest kernels). With
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


def run(args, learning: bool, torch, lidar_backend: str = "xla"):
    trainer = build(args, learning, lidar_backend)
    state = trainer.init(0)
    if not learning:
        trainer.agent.init(0)
    state = trainer.rollout_chunk(state)          # warm-up chunk
    _, state = trainer.drain_stats(state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.iters):
        state = trainer.rollout_chunk(state)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    summary, state = trainer.drain_stats(state)
    sps = args.n_envs * args.chunk * args.iters / dt
    return sps, trainer, state, summary


def profile(args, trainer, state, torch):
    """Device busy share and launches per step over ``--profile-steps``
    learning steps."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.profile_steps):
            state = trainer._train_step(state)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sorted((e.time_range.start, e.time_range.end) for e in kernels)
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
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    steps = args.profile_steps
    host = {}
    for e in prof.key_averages():
        if e.key.startswith("cuda") or e.key.startswith("aten::"):
            host[e.key] = (e.count / steps, e.self_cpu_time_total / 1e3
                           / steps)
    host_top = sorted(host.items(), key=lambda kv: -kv[1][1])[:15]
    return {"steps": steps, "traced_wall_ms_per_step": wall_ms / steps,
            "device_busy_ms_per_step": merged / 1e3 / steps,
            "device_busy_share_of_kernel_span": merged / max(span_us, 1e-9),
            "device_busy_share_of_wall": merged / 1e3 / max(wall_ms, 1e-9),
            "kernel_launches_per_step": len(kernels) / steps,
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
        rates = []
        torch.cuda.reset_peak_memory_stats()
        for _ in range(args.repeats):
            sps, trainer, state, _ = run(args, learning, torch,
                                         lidar_backend)
            rates.append(sps)
            if learning and args.profile_steps and len(rates) == 1:
                out["profile"] = profile(args, trainer, state, torch)
            del trainer, state
        out[name] = {"median": statistics.median(rates), "min": min(rates),
                     "max": max(rates), "runs": rates,
                     "peak_memory_bytes": torch.cuda.max_memory_allocated()}
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
