"""Host and device time of the env step of the ``bench.py`` cell on one
card, and of the raycast's wrapper alone, for one checkout of the port.

    python scripts/bench_torch_env_step.py [--root DIR] [--envs 16384]
        [--steps 64] [--repeats 3] [--calls 200] [--no-learn-chunks N]

``--root`` is the checkout whose ``crowdnav_tpu_torch`` is imported
(default: this one), so that one script times two checkouts, each in a
process of its own. The env is the cell's (``crowd_dense``/``crowd``,
jitter 1.0, the tracker's Pallas form, the raycast's XLA form) at
``--envs`` envs, stepped with seeded uniform actions and no learner.
Prints one JSON line: per repeat the host clock over ``--steps`` steps
(ending in a device synchronisation) and the host time spent inside
``step_batch`` calls; the wrapper ``ops.lidar.scan_batch`` on the last
state, ``--calls`` calls without a synchronisation between them (host
time per call) and with one after each (host and device); a
``torch.profiler`` window of 8 steps (device time per step by kernel,
host time per step by operator, the largest of each); the card's name
and power limit. With ``--no-learn-chunks N`` it first runs
``scripts/bench_torch_train.py``'s no-learn variant (the evaluation
rollout: greedy actor and env step, no replay) of the cell, one warm-up
and N timed chunks a repeat, with the checkout's trainer. It needs a CUDA
device; it fails without one.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--envs", type=int, default=16384)
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--calls", type=int, default=200)
    ap.add_argument("--no-learn-chunks", type=int, default=0)
    args = ap.parse_args()
    import bench_torch_train as bt        # this script's directory
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("bench_torch_env_step: no CUDA device")
    no_learn = []
    if args.no_learn_chunks:
        cell = bt.parser().parse_args(["--iters", str(args.no_learn_chunks),
                                       "--n-envs", str(args.envs)])
        for _ in range(args.repeats):
            # the eager loop, which every checkout's Trainer has
            no_learn.append(bt.run(cell, False, torch, jitted=False)[0])
    from crowdnav_tpu_torch.envs.config import make_config
    from crowdnav_tpu_torch.envs.crowd_env import CrowdEnv
    from crowdnav_tpu_torch.ops import lidar
    dev = torch.device("cuda", 0)
    cfg = make_config("crowd_dense", "crowd", jitter=1.0,
                      risk_backend="pallas")
    env = CrowdEnv(cfg, device=dev, seed=0)
    gen = torch.Generator(device=dev).manual_seed(5)
    lo = torch.tensor([0.0, -2.0], device=dev)
    span = torch.tensor([0.22, 4.0], device=dev)
    state, _ = env.reset(args.envs, gen)

    def steps(n, state):
        inside = 0.0
        for _ in range(n):
            act = torch.rand((args.envs, 2), generator=gen,
                             device=dev) * span + lo
            t = time.perf_counter()
            state = env.step_batch(state, act, gen=gen).state
            inside += time.perf_counter() - t
        return state, inside

    state, _ = steps(8, state)                      # warm-up
    torch.cuda.synchronize()
    wall, inside = [], []
    for _ in range(args.repeats):
        t0 = time.perf_counter()
        state, t_in = steps(args.steps, state)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3 / args.steps)
        inside.append(t_in * 1e3 / args.steps)

    scan_args = (state.pos, state.yaw, state.ped_pos, cfg.ped_radius,
                 cfg.room_half_inner, cfg.max_scan_range,
                 cfg.lidar_min_range, cfg.n_scans)
    lidar.scan_batch(*scan_args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.calls):
        lidar.scan_batch(*scan_args)
    enqueue = (time.perf_counter() - t0) * 1e6 / args.calls
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.calls):
        lidar.scan_batch(*scan_args)
        torch.cuda.synchronize()
    synced = (time.perf_counter() - t0) * 1e6 / args.calls

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, _ = steps(8, state)
        torch.cuda.synchronize()
    events = prof.key_averages()
    device = sorted(((e.key, e.self_device_time_total / 8e3, e.count / 8)
                     for e in events if e.self_device_time_total > 0),
                    key=lambda x: -x[1])
    host = sorted(((e.key, e.self_cpu_time_total / 8e3, e.count / 8)
                   for e in events), key=lambda x: -x[1])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({
        "root": args.root, "card": smi, "envs": args.envs,
        "no_learn_env_steps_per_s": no_learn,
        "steps": args.steps, "config": "crowd_dense/crowd, jitter 1.0, "
        "risk_backend pallas, lidar_backend xla",
        "step_ms_host_clock": wall,
        "step_ms_host_clock_median": statistics.median(wall),
        "step_batch_host_ms": inside,
        "scan_batch_host_us_per_call": enqueue,
        "scan_batch_synced_us_per_call": synced,
        "profile_device_ms_per_step": sum(d[1] for d in device),
        "profile_top_device_ms_per_step": device[:10],
        "profile_top_host_ms_per_step": host[:15]}), flush=True)


if __name__ == "__main__":
    main()
