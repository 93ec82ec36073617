"""Real-robot deployment loop (port of
``crowdnav_tpu/drivers/deploy_realworld.py``).

A TD3 actor drives the robot: at each control tick the latest lidar scan
and odometry go through ``CrowdEnv.observe_external`` (the 370-dim
``realworld`` state: K = 1, no waypoints) and the greedy action goes out.
The transport is pluggable: ``source(state) -> (scans, pos, yaw)`` and
``sink(action)`` (thin wrappers of the robot's topics); the default
loopback source reads the simulated world's own scan through the raycast
kernel, so that the loop runs end to end without hardware.

    python -m crowdnav_tpu_torch.drivers.deploy_realworld --ticks 50 \\
        [--period 0.15] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from crowdnav_tpu_torch.agents.td3 import TD3, TD3Config
from crowdnav_tpu_torch.envs.config import make_config
from crowdnav_tpu_torch.envs.crowd_env import CrowdEnv
from crowdnav_tpu_torch.ops import lidar
from crowdnav_tpu_torch.utils.device import resolve


def loopback_source(cfg):
    """A source that reads the simulated world of the state: its raycast
    (the kernel of the config's lidar backend) at the state's pose."""
    scan = lidar.scan_fn(cfg.lidar_backend)

    def source(state):
        scans = scan(state.pos, state.yaw, state.ped_pos, cfg.ped_radius,
                     cfg.room_half_inner, cfg.max_scan_range,
                     cfg.lidar_min_range, cfg.n_scans)
        return scans, state.pos, state.yaw

    return source


def run_deployment(actor=None, n_ticks: int = 100, source=None, sink=None,
                   tick_period: float = 0.15, device="cuda", on_tick=None,
                   latencies: list | None = None):
    """``n_ticks`` control ticks (fewer if the episode ends); returns the
    history ``[(action (2,), distance to goal)]`` as the JAX package's.

    ``actor``: the actor module's state dict (the arrays of
    ``scripts/export_torch_actor.py`` through ``utils/convert``), else
    the actor's initialisation from seed 0. A source gives the scan
    (n_scans,) and the pose ((2,), ()) as arrays or tensors.
    ``on_tick(state, obs, action)`` sees each tick's tensors; each tick's
    seconds, source to sink, go to ``latencies``."""
    device = resolve(device)
    cfg = make_config("realworld")
    env = CrowdEnv(cfg, device=device)
    agent = TD3(TD3Config(), env.obs_dim, device=device)
    if actor is None:
        agent.init(0)
    else:
        agent.load_actor(actor)
    state, _ = env.reset(1, torch.Generator(device=device).manual_seed(1))
    source = source or loopback_source(cfg)
    sink = sink or (lambda action: None)

    def tensor(x, shape):
        return torch.as_tensor(x, dtype=torch.float32,
                               device=device).reshape(shape)

    history = []
    for _ in range(n_ticks):
        t0 = time.perf_counter()
        scans, pos, yaw = source(state)
        state, obs = env.observe_external(
            state, tensor(scans, (1, cfg.n_scans)), tensor(pos, (1, 2)),
            tensor(yaw, (1,)))
        action = agent.act(obs)
        host = action[0].cpu().numpy()
        sink(host)
        if latencies is not None:
            latencies.append(time.perf_counter() - t0)
        if on_tick is not None:
            on_tick(state, obs, action)
        history.append((host, float(obs[0, 360])))
        if bool(state.done[0]):
            break
        dt = time.perf_counter() - t0
        if tick_period > dt:
            time.sleep(tick_period - dt)
    return history


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--ticks", type=int, default=50)
    p.add_argument("--period", type=float, default=0.0)
    p.add_argument("--device", default="cuda",
                   help="torch device, 'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)
    try:
        device = resolve(args.device)
    except RuntimeError as e:       # no card for --device cuda
        raise SystemExit(str(e))
    latencies = []
    hist = run_deployment(n_ticks=args.ticks, tick_period=args.period,
                          device=device, latencies=latencies)
    print(f"ran {len(hist)} ticks; final dtg={hist[-1][1]:.2f}")
    print(json.dumps({"ticks": len(hist),
                      "tick_ms_median": float(np.median(latencies)) * 1e3}))
    return hist


if __name__ == "__main__":
    main()
