"""Training throughput of the PyTorch port on one card: the cell of the
JAX package's ``bench.py`` (``bench_config``), run through the functions
the port's ``drivers/train`` calls.

    python scripts/bench_torch_train.py [--repeats 3] [--profile-steps 8]

The cell: world ``crowd_dense``, behavior ``crowd``, jitter 1.0, reset
bank 256, the 398-dim observation, 16,384 envs, chunks of 64 steps, 32
updates x batch 4,096 a batched step, ``learn_start`` 256, bfloat16
replay observations, a float32 MLP with TF32 off, and the epsilon
spectrum of the flagship recipe (``scripts/r5_chain_v.txt:21``; the JAX
``bench.py`` explores with its defaults). Each repeat builds a fresh
trainer, runs one warm-up chunk and ``--iters`` timed chunks (host clock
around work that ends in a device synchronisation), for the learning
variant and the ``--no-learn`` variant (the evaluation rollout, greedy
actions, no replay). Prints one JSON line: env-steps/s of each variant
(median, min, max over the repeats), peak device memory, and with
``--profile-steps`` a ``torch.profiler`` window of the learning step
(device busy share, kernel launches per step, the largest kernels). It
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
    return ["--algo", "td3", "--world", "crowd_dense", "--behavior",
            "crowd", "--jitter", "1.0", "--reset-bank", "256", "--n-envs",
            str(args.n_envs), "--chunk", str(args.chunk),
            "--updates-per-step", str(args.updates_per_step),
            "--batch-size", str(args.batch_size), "--learn-start", "256",
            "--replay-obs-dtype", "bfloat16", "--explore-eps", "1.0",
            "--explore-eps-min", "0.05", "--explore-spectrum", "--seed", "0",
            "--device", "cuda"]


def build(args, learning: bool):
    import dataclasses

    from crowdnav_tpu_torch.drivers import train as dtrain
    trainer = dtrain.build(dtrain.parser().parse_args(flags(args)))
    if not learning:
        from crowdnav_tpu_torch.parallel.runtime import Trainer
        trainer = Trainer(trainer.env, trainer.agent, dataclasses.replace(
            trainer.tcfg, learning=False))
    return trainer


def run(args, learning: bool, torch):
    trainer = build(args, learning)
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


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--n-envs", type=int, default=16384)
    p.add_argument("--chunk", type=int, default=64)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--updates-per-step", type=int, default=32)
    p.add_argument("--batch-size", type=int, default=4096)
    p.add_argument("--profile-steps", type=int, default=0)
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("bench_torch_train: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    out = {"metric": "env_steps_per_sec_td3_risk_k8_crowd_dense_torch",
           "unit": "env-steps/s", "card": smi,
           "device": torch.cuda.get_device_name(0),
           "config": {"n_envs": args.n_envs, "chunk": args.chunk,
                      "iters": args.iters, "repeats": args.repeats,
                      "updates_per_step": args.updates_per_step,
                      "batch_size": args.batch_size, "reset_bank": 256,
                      "replay_obs_dtype": "bfloat16", "jitter": 1.0,
                      "explore": "eps spectrum 1.0 -> 0.05",
                      "matmul_allow_tf32": False}}
    for learning in (True, False):
        name = "learning" if learning else "no_learn"
        rates = []
        torch.cuda.reset_peak_memory_stats()
        for _ in range(args.repeats):
            sps, trainer, state, summary = run(args, learning, torch)
            rates.append(sps)
            if learning and args.profile_steps and len(rates) == 1:
                out["profile"] = profile(args, trainer, state, torch)
            del trainer, state
        out[name] = {"median": statistics.median(rates), "min": min(rates),
                     "max": max(rates), "runs": rates,
                     "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    out["value"] = out["learning"]["median"]
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
