"""Throughput counters of the port (``StepThroughput`` of
``crowdnav_tpu/utils/profiling.py``).

A chunk's end is a device synchronisation: the counter waits for the card
before it reads the clock, so the rate is that of finished work.
"""
from __future__ import annotations

import time

import torch


class StepThroughput:
    """Running env-steps/s counter: instantaneous, EMA and lifetime mean."""

    def __init__(self, steps_per_chunk: int, ema_alpha: float = 0.2,
                 device="cpu"):
        self.steps_per_chunk = steps_per_chunk
        self.ema_alpha = ema_alpha
        self.device = torch.device(device)
        self.total_steps = 0
        self.sps_ema = None
        self._t_last = time.perf_counter()
        self._t_start = self._t_last

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def tick(self, steps: int | None = None) -> dict:
        """Call once per completed chunk."""
        self._sync()
        now = time.perf_counter()
        steps = self.steps_per_chunk if steps is None else steps
        dt = max(now - self._t_last, 1e-9)
        sps = steps / dt
        self.total_steps += steps
        self.sps_ema = (sps if self.sps_ema is None else
                        self.ema_alpha * sps +
                        (1 - self.ema_alpha) * self.sps_ema)
        self._t_last = now
        return {
            "sps": sps,
            "sps_ema": self.sps_ema,
            "sps_mean": self.total_steps / max(now - self._t_start, 1e-9),
            "total_steps": self.total_steps,
        }

    def device_memory(self) -> dict:
        """Bytes allocated by PyTorch on each CUDA device (none on the
        CPU)."""
        out = {}
        for i in range(torch.cuda.device_count()):
            stats = torch.cuda.memory_stats(i)
            out[f"cuda:{i}"] = stats.get("allocated_bytes.all.current", 0)
        return out
