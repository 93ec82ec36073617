"""Device-only time of a kernel's launches, without its wrapper's host work.

A wrapper spends host time on each call (argument checks, output
allocation, the ``ctypes`` call), and an event pair around one call on an
idle card measures that host time too. :func:`device_ms` instead holds the
stream behind ``torch.cuda._sleep`` while the host enqueues a burst of
calls, so the whole burst is queued before the card reaches its first
event; the time between the events after the sleep, over the number of
calls, is device time alone. It checks that the host finished enqueueing
before the sleep ended, and raises if not.

The calls rotate over copies of the inputs and keep every output alive
until the burst ends, so that each launch reads inputs and writes outputs
that are not in the 50 MB L2 cache from the launch before: the bytes come
from device memory, as the bytes bound counts them.
"""
from __future__ import annotations

import statistics
import time

import torch

L2_BYTES = 50 * 2 ** 20


def copies_for(bytes_per_call: int, cap: int = 64) -> int:
    """Input copies a burst rotates over: enough that the bytes of one
    round of calls are at least five times the L2 cache."""
    return max(2, min(cap, -(-5 * L2_BYTES // max(bytes_per_call, 1))))


def clone_args(args, n: int):
    """``n`` copies of an argument tuple, each tensor cloned."""
    return [tuple(a.clone() if torch.is_tensor(a) else a for a in args)
            for _ in range(n)]


def _cycles_per_ms() -> float:
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    cycles = 20_000_000
    torch.cuda._sleep(cycles // 10)   # wake the clocks
    a.record()
    torch.cuda._sleep(cycles)
    b.record()
    b.synchronize()
    return cycles / a.elapsed_time(b)


def stream_ms(call, args, reps: int = 5) -> float:
    """Median ms of one ``call(*args)`` between an event pair on the
    stream, host time included. For the plain versions: they launch
    hundreds of small kernels a call, more than the launch queue holds
    while the card sleeps."""
    call(*args)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        call(*args)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def profiled_ms(call, arg_sets, reps: int, kernel: str) -> float:
    """Mean duration of the device kernels whose name holds ``kernel``
    over ``reps`` calls, as CUPTI reports them through ``torch.profiler``:
    the kernel's own run, without the gaps between launches (over the
    launches it recorded: it may drop some records of a long burst)."""
    from torch.profiler import ProfilerActivity, profile
    for args in arg_sets:
        call(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        kept = [call(*arg_sets[i % len(arg_sets)]) for i in range(reps)]
        torch.cuda.synchronize()
    del kept
    total_us, count = 0.0, 0
    for e in prof.key_averages():
        if kernel in e.key and e.device_type == torch.autograd.DeviceType.CUDA:
            total_us += getattr(e, "self_device_time_total",
                                getattr(e, "self_cuda_time_total", 0.0))
            count += e.count
    if count == 0:    # CUPTI may drop records of a burst, not all of them
        raise RuntimeError(f"the profiler saw no launch of {kernel}")
    return total_us / 1e3 / count


def device_ms(call, arg_sets, reps: int, trials: int = 3) -> float:
    """Median over ``trials`` bursts of the device ms per ``call(*args)``,
    a burst being ``reps`` calls over ``arg_sets`` in turn."""
    def burst():
        return [call(*arg_sets[i % len(arg_sets)]) for i in range(reps)]

    for args in arg_sets:
        call(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    kept = burst()        # also leaves the outputs' blocks in the cache
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    del kept
    cycles = int((4.0 * host_ms + 5.0) * _cycles_per_ms())
    samples = []
    for _ in range(trials):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        torch.cuda._sleep(cycles)
        ev[1].record()
        t0 = time.perf_counter()
        kept = burst()
        host_ms = (time.perf_counter() - t0) * 1e3
        ev[2].record()
        ev[2].synchronize()
        slept = ev[0].elapsed_time(ev[1])
        if host_ms >= slept:
            raise RuntimeError(f"the burst took {host_ms:.3f} ms to enqueue, "
                               f"longer than the {slept:.3f} ms sleep ahead "
                               f"of it: the card was not kept waiting")
        samples.append(ev[1].elapsed_time(ev[2]) / reps)
        del kept
    return statistics.median(samples)
