"""Launch geometry of the CUDA kernels, computed on the host.

The wrappers in ``kernels/build.py`` pass these numbers to the kernels, so
that the geometry is plain Python that the CPU tests check. The defaults
come from the sweep of ``scripts/bench_torch_kernels.py``.

Tracker -> CP -> top-K (``csrc/track_cp_topk.cu``): one warp per env,
``envs_per_block`` envs to a block.

Elementwise C-library trig (``csrc/libm_trig.cu``): one thread an element,
blocks of 256, at most 8 blocks an SM, a grid-stride loop beyond.

Raycast (``csrc/raycast.cu``): a thread takes R beams of one env, beams
j + r * M for r < R with M = ceil(B / R) slots per env; threads run over
the flat (env, slot) index. A block's threads touch at most
``ceil((threads - 1) / M) + 1`` envs; it keeps per env the pose (a float4)
and per env and pedestrian the relative centre (a float2) and its squared
norm (a float) in shared memory.
"""
from __future__ import annotations

import dataclasses

TRACK_ENVS_PER_BLOCK = 4
RAYCAST_BEAMS_PER_THREAD = (2, 4, 8)
TRACK_MAX_ENVS_PER_BLOCK = 16   # blocks of at most 512 threads
ELEMENTWISE_THREADS = 256
ELEMENTWISE_MAX_BLOCKS = 132 * 8   # 8 blocks on each of the H100's SMs


@dataclasses.dataclass(frozen=True)
class ElementwiseLaunch:
    grid: int
    threads: int


def elementwise_launch(n: int) -> ElementwiseLaunch:
    blocks = -(-n // ELEMENTWISE_THREADS)
    return ElementwiseLaunch(max(1, min(blocks, ELEMENTWISE_MAX_BLOCKS)),
                             ELEMENTWISE_THREADS)


@dataclasses.dataclass(frozen=True)
class TrackLaunch:
    envs_per_block: int
    grid: int
    threads: int


def track_cp_topk_launch(n: int,
                         envs_per_block: int | None = None) -> TrackLaunch:
    e = TRACK_ENVS_PER_BLOCK if envs_per_block is None else envs_per_block
    if not 1 <= e <= TRACK_MAX_ENVS_PER_BLOCK:
        raise ValueError(f"envs_per_block must be in "
                         f"[1, {TRACK_MAX_ENVS_PER_BLOCK}], got {e}")
    return TrackLaunch(e, -(-n // e), 32 * e)


def raycast_block(n: int):
    """``(threads, beams per thread)`` for a batch of ``n`` envs: small
    batches take few beams a thread, so that enough warps are in flight."""
    return 128, (2 if n <= 4096 else 4)


@dataclasses.dataclass(frozen=True)
class RaycastLaunch:
    grid: int
    threads: int
    beams_per_thread: int
    slots: int           # threads per env, ceil(B / beams_per_thread)
    envs_per_block: int  # the most envs one block's threads touch
    smem_bytes: int


def raycast_launch(n: int, b: int, p: int, threads: int | None = None,
                   beams_per_thread: int | None = None) -> RaycastLaunch:
    d_threads, d_beams = raycast_block(n)
    threads = d_threads if threads is None else threads
    r = d_beams if beams_per_thread is None else beams_per_thread
    if not (32 <= threads <= 512 and threads % 32 == 0):
        raise ValueError(f"threads must be a multiple of 32 in [32, 512], "
                         f"got {threads}")
    if r not in RAYCAST_BEAMS_PER_THREAD:
        raise ValueError(f"beams per thread must be one of "
                         f"{RAYCAST_BEAMS_PER_THREAD}, got {r}")
    slots = -(-b // r)
    if n * slots >= 2 ** 31:
        raise ValueError(f"{n} envs x {slots} slots overflow the kernel's "
                         f"32-bit index")
    envs = -(-(threads - 1) // slots) + 1
    return RaycastLaunch(-(-n * slots // threads), threads, r, slots, envs,
                         envs * (16 + 12 * p))
