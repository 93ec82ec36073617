"""Tracing and throughput counters of the port (``trace``, ``trace_if``,
``annotate`` and ``StepThroughput`` of ``crowdnav_tpu/utils/profiling.py``).

``trace`` records the enclosed block with ``torch.profiler`` (the host's
operators, and the card's kernels and copies when CUDA is up) and writes
it as a Chrome trace, ``<logdir>/<name>.json`` (chrome://tracing or
Perfetto); ``annotate`` names a region on that timeline. A chunk's end is
a device synchronisation: the counter waits for the card before it reads
the clock, so the rate is that of finished work.

    run = trainer.make_jitted()
    with trace_if("/tmp/trace", chunk == 2):
        with annotate("rollout_chunk"):
            state = run(state)
        stats = timer.tick()
"""
from __future__ import annotations

import contextlib
import os
import time

import torch


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(logdir: str, name: str = "trace"):
    """Record the enclosed block with ``torch.profiler`` and write its
    Chrome trace to ``<logdir>/<name>.json``; yields the profiler (its
    ``key_averages()`` and ``events()``). The card is synchronised before
    the recording stops, so that its queued work is in the trace."""
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=_activities())
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, f"{name}.json"))


@contextlib.contextmanager
def trace_if(logdir: str | None, condition: bool, name: str = "trace"):
    """:func:`trace` when ``logdir`` is set and ``condition`` holds (e.g.
    exactly one warm chunk), else nothing; yields the profiler or None."""
    if logdir and condition:
        with trace(logdir, name) as prof:
            yield prof
    else:
        yield None


def annotate(name: str):
    """A named region on the trace's timeline
    (``torch.profiler.record_function``)."""
    return torch.profiler.record_function(name)


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
