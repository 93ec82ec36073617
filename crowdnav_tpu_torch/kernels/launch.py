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
``ceil((threads - 1) / M) + 1`` envs; it keeps per env the pose (a float4),
per env and pedestrian the relative centre (a float2) and its squared
norm (a float), and per env and 32 pedestrians the bit mask of those in
reach (a word) in shared memory. :func:`raycast_reach2` is the reach: the
float32 threshold on the squared norm beyond which a pedestrian cannot
change a beam (the derivation is in the kernel's note).
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np

TRACK_ENVS_PER_BLOCK = 4
RAYCAST_BEAMS_PER_THREAD = (2, 4, 8)
TRACK_MAX_ENVS_PER_BLOCK = 16   # blocks of at most 512 threads
ELEMENTWISE_THREADS = 256
ELEMENTWISE_MAX_BLOCKS = 132 * 8   # 8 blocks on each of the H100's SMs
F32_UNIT_ROUNDOFF = 2.0 ** -24
# the norm of a beam direction is at most 1 + this, in both raycast forms
RAYCAST_DIR_ERR = 16 * F32_UNIT_ROUNDOFF


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
                         envs * (16 + 12 * p + 4 * -(-p // 32)))


@functools.lru_cache(maxsize=None)
def raycast_reach2(r2: float, max_range: float) -> float:
    """The float32 threshold on a pedestrian's squared distance ``rel2``
    beyond which every hit it gives a beam, computed in float32, is at
    least ``max_range`` (``r2``, ``max_range``: the kernel's float32
    constants): ``(max_range + (1 + 2u) r) / (1 - (1 + 2u) kappa /
    (1 - u))`` squared and rounded up, with ``r = sqrt(r2)`` and
    ``kappa = sqrt(2 RAYCAST_DIR_ERR + 7u)``."""
    u = F32_UNIT_ROUNDOFF
    kappa = math.sqrt(2 * RAYCAST_DIR_ERR + 7 * u)
    reach = (max_range + (1 + 2 * u) * math.sqrt(r2)) \
        / (1 - (1 + 2 * u) * kappa / (1 - u))
    want = reach * reach * (1 + 2.0 ** -50)   # above float64's rounding
    q = np.float32(want)
    if float(q) < want:
        q = np.nextafter(q, np.float32(np.inf))
    return float(q)
