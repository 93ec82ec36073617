"""Where the time of the port's greedy evaluation goes, on the card.

    python scripts/profile_torch_eval.py [--n-envs 1024] [--steps 50]

Runs the evaluation path of ``crowdnav_tpu_torch.drivers.evaluate`` (suite
``train``, the exported ``final_full`` actor, jitter 1.0, reset bank),
warms up, times ``--steps`` env-steps, then traces as many with
``torch.profiler`` and prints one JSON line: the host wall time per step
(untraced and traced), the device time per step summed over kernels, the
device's busy share of the untraced wall time, the kernel launches per
step, the port's own kernels' time per step, and the device time by
kernel, largest first. ``--table PATH`` also writes the profiler's full
table there.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--n-envs", type=int, default=1024)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--warmup", type=int, default=20)
    p.add_argument("--table", default=None,
                   help="write the profiler's full table to this file")
    args = p.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from crowdnav_tpu_torch.drivers.evaluate import (build_agent,
                                                     load_actor_file)
    from crowdnav_tpu_torch.envs.config import make_config
    from crowdnav_tpu_torch.envs.crowd_env import CrowdEnv
    from crowdnav_tpu_torch.parallel.runtime import Trainer, TrainerConfig
    from crowdnav_tpu_torch.utils.convert import flax_actor_to_state_dict

    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_eval: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    params, meta = load_actor_file(os.path.join(
        ROOT, "crowdnav_tpu_torch", "assets", "final_full_actor.npz"))
    cfg = make_config("crowd_dense", "crowd", jitter=1.0, max_steps=500)
    env = CrowdEnv(cfg, device=dev, seed=0)
    agent = build_agent(meta["agent_config"], env.obs_dim, dev)
    agent.load_actor(flax_actor_to_state_dict(params))
    trainer = Trainer(env, agent, TrainerConfig(
        n_envs=args.n_envs, rollout_chunk=1, learning=False,
        reset_bank=args.n_envs))
    state = trainer.init(0)
    for _ in range(args.warmup):
        state = trainer._train_step(state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        state = trainer._train_step(state)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            state = trainer._train_step(state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    events = prof.key_averages()
    kernels = []
    for e in events:
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
        if dev_us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            kernels.append((e.key, dev_us, e.count))
    kernels.sort(key=lambda k: -k[1])
    device_us = sum(k[1] for k in kernels)
    launches = sum(k[2] for k in kernels)
    if args.table:
        with open(args.table, "w") as fp:
            fp.write(events.table(sort_by="self_cuda_time_total",
                                  row_limit=60))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({
        "card": smi, "n_envs": args.n_envs, "steps": args.steps,
        "wall_ms_per_step": plain_wall * 1e3 / args.steps,
        "wall_ms_per_step_profiled": wall * 1e3 / args.steps,
        "device_ms_per_step": device_us / 1e3 / args.steps,
        "device_busy_share": device_us / 1e6 / plain_wall,
        "port_kernels_ms_per_step": {
            name: sum(k[1] for k in kernels if name in k[0]) / 1e3
            / args.steps for name in ("raycast_kernel",
                                      "track_cp_topk_kernel")},
        "kernel_launches_per_step": launches / args.steps,
        "env_steps_per_s": args.n_envs * args.steps / plain_wall,
        "top_kernels_ms_per_step": [
            [k[0][:80], k[1] / 1e3 / args.steps, k[2] / args.steps]
            for k in kernels[:15]]}), flush=True)


if __name__ == "__main__":
    main()
