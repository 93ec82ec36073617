"""Build and bind the CUDA kernels of ``kernels/csrc``.

All ``.cu`` files are compiled by one ``nvcc`` call into one shared library
with a plain C interface (no PyTorch headers), loaded with ``ctypes``; the
launch geometry (grid, block, shared memory) comes from ``kernels/launch.py``.
The build runs at first use into ``kernels/build/``; the library's file name
carries a hash of the sources and flags, so a stale build is never loaded.
There are no lock files: the library is written under a temporary name and
renamed into place.

``-fmad=false`` keeps the compiler from contracting multiply-adds, and there
is no fast-math flag: the kernels must equal their plain PyTorch versions
bit for bit (``utils/numerics.py``).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from crowdnav_tpu_torch.kernels import launch
from crowdnav_tpu_torch.utils import numerics as nm

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC"]
BUILD_TIMEOUT_S = 600

build_seconds = None   # wall time of this process's nvcc call, if it built
# the kernel's kForm of each form of ops.risk.FORMS
TRACK_FORMS = {"xla": 0, "strict": 1, "pallas": 2}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "crowdnav_raycast": [_P] * 7 + [_I] * 7 + [_F] * 5 + [_P],
    "crowdnav_raycast_pallas": [_P] * 4 + [_I] * 7 + [_F] * 6 + [_P],
    "crowdnav_track_cp_topk": [_P] + [_I] * 6 + [_F] * 8 + [_I, _P],
    "crowdnav_libm_sincos": [_P] * 2 + [_I] * 4 + [_P],
    "crowdnav_libm_atan2": [_P] * 3 + [_I] * 3 + [_P],
}


def sources(csrc: Path = CSRC):
    return sorted(Path(csrc).glob("*.cu"))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin)")


def library_path(csrc: Path = CSRC, include_dirs=()) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    files = sorted(Path(csrc).glob("*.cu*"))
    for d in include_dirs:
        files += sorted(Path(d).glob("*.cuh"))
    for src in files:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libcrowdnav_kernels_{h.hexdigest()[:16]}.so"


def compile_library(csrc: Path = CSRC,
                    include_dirs=()) -> tuple[Path, float | None]:
    """Run one ``nvcc`` call over the ``.cu`` files of ``csrc`` (headers
    also from ``include_dirs``) if their library is not built yet; return
    its path and the call's seconds (None if it was built already)."""
    path = library_path(csrc, include_dirs)
    if path.exists():
        return path, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, *(f"-I{d}" for d in include_dirs), "-o",
           str(tmp), *map(str, sources(csrc))]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True,
                         timeout=BUILD_TIMEOUT_S)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                           f"{' '.join(cmd)}\n{res.stdout}\n{res.stderr}")
    os.replace(tmp, path)
    return path, time.perf_counter() - t0


def load(path: Path, signatures: dict) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    global build_seconds
    path, build_seconds = compile_library()
    return load(path, _SIGNATURES)


def _check(code: int, name: str):
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code}")


def _cuda_input(name, t, dtype, shape):
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.data_ptr() % 8:   # the kernels load float pairs
        raise ValueError(f"{name}: expected an 8-byte aligned tensor")
    return t.data_ptr()


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def raycast_buffers(pos, cos_yaw, sin_yaw, cos_beam, sin_beam, peds):
    """Checked input addresses and the (N, B) float32 output."""
    f32 = torch.float32
    n, b, p = pos.shape[0], cos_beam.shape[0], peds.shape[1]
    ptrs = [_cuda_input("pos", pos, f32, (n, 2)),
            _cuda_input("cos_yaw", cos_yaw, f32, (n,)),
            _cuda_input("sin_yaw", sin_yaw, f32, (n,)),
            _cuda_input("cos_beam", cos_beam, f32, (b,)),
            _cuda_input("sin_beam", sin_beam, f32, (b,)),
            _cuda_input("peds", peds, f32, (n, p, 2))]
    return ptrs, torch.empty((n, b), dtype=f32, device=pos.device)


def raycast(pos, cos_yaw, sin_yaw, cos_beam, sin_beam, peds, half, r2,
            min_range, max_range, threads: int | None = None,
            beams_per_thread: int | None = None):
    """Launch the raycast kernel; arguments as ``ops.lidar.raycast_plain``.
    Returns (N, B) float32 ranges."""
    ptrs, out = raycast_buffers(pos, cos_yaw, sin_yaw, cos_beam, sin_beam,
                                peds)
    n, b = out.shape
    p = peds.shape[1]
    geo = launch.raycast_launch(n, b, p, threads, beams_per_thread)
    code = library().crowdnav_raycast(
        *ptrs, out.data_ptr(), n, b, p, geo.grid, geo.threads,
        geo.beams_per_thread, geo.smem_bytes, half, r2, min_range, max_range,
        launch.raycast_reach2(r2, max_range), _stream(pos.device))
    _check(code, "crowdnav_raycast")
    return out


def raycast_pallas_buffers(pos, yaw, peds, n_beams):
    """Checked input addresses of the Pallas form and the (N, n_beams)
    float32 output."""
    f32 = torch.float32
    n, p = pos.shape[0], peds.shape[1]
    ptrs = [_cuda_input("pos", pos, f32, (n, 2)),
            _cuda_input("yaw", yaw, f32, (n,)),
            _cuda_input("peds", peds, f32, (n, p, 2))]
    return ptrs, torch.empty((n, n_beams), dtype=f32, device=pos.device)


def raycast_pallas(pos, yaw, peds, n_beams, half, r2, min_range,
                   max_range, threads: int | None = None,
                   beams_per_thread: int | None = None):
    """Launch the raycast kernel's Pallas form; arguments as
    ``ops.lidar.raycast_pallas_plain``. Returns (N, n_beams) float32
    ranges."""
    ptrs, out = raycast_pallas_buffers(pos, yaw, peds, n_beams)
    n, p = pos.shape[0], peds.shape[1]
    geo = launch.raycast_launch(n, n_beams, p, threads, beams_per_thread)
    code = library().crowdnav_raycast_pallas(
        *ptrs, out.data_ptr(), n, n_beams, p, geo.grid, geo.threads,
        geo.beams_per_thread, geo.smem_bytes, half, r2, min_range, max_range,
        nm.f32(math.pi / 180.0), launch.raycast_reach2(r2, max_range),
        _stream(pos.device))
    _check(code, "crowdnav_raycast_pallas")
    return out


def track_cp_topk_buffers(cfg, seg_conf, seg_obs, seg_pos, seg_dist,
                          t_valid, t_pos, t_prev, t_dist, t_speed, t_vel,
                          r_pos, r_prev, compute_cp):
    """Checked input addresses, the 11 outputs (new track fields, then
    top_cp, top_pose_vel, cp_max, ego_cp) and the kernel's float32
    constants."""
    f32, b8 = torch.float32, torch.bool
    n, S = seg_conf.shape
    T, K = t_valid.shape[1], cfg.k_obstacles
    if not (1 <= S <= 32 and 1 <= T <= 32 and 1 <= K <= T):
        raise ValueError(f"kernel needs 1 <= S <= 32, 1 <= T <= 32, "
                         f"1 <= K <= T; got S={S}, T={T}, K={K}")
    ptrs = [_cuda_input("confirmed", seg_conf, b8, (n, S)),
            _cuda_input("is_obstacle", seg_obs, b8, (n, S)),
            _cuda_input("center_pos", seg_pos, f32, (n, S, 2)),
            _cuda_input("center_dist", seg_dist, f32, (n, S)),
            _cuda_input("tracks.valid", t_valid, b8, (n, T)),
            _cuda_input("tracks.pos", t_pos, f32, (n, T, 2)),
            _cuda_input("tracks.prev_pos", t_prev, f32, (n, T, 2)),
            _cuda_input("tracks.dist", t_dist, f32, (n, T)),
            _cuda_input("tracks.speed", t_speed, f32, (n, T)),
            _cuda_input("tracks.vel", t_vel, f32, (n, T, 2)),
            _cuda_input("robot_pos", r_pos, f32, (n, 2)),
            _cuda_input("robot_prev_pos", r_prev, f32, (n, 2)),
            _cuda_input("compute_cp", compute_cp, b8, (n,))]
    dev = seg_conf.device
    outs = (torch.empty((n, T), dtype=b8, device=dev),
            torch.empty((n, T, 2), dtype=f32, device=dev),
            torch.empty((n, T, 2), dtype=f32, device=dev),
            torch.empty((n, T), dtype=b8, device=dev),
            torch.empty((n, T), dtype=f32, device=dev),
            torch.empty((n, T), dtype=f32, device=dev),
            torch.empty((n, T, 2), dtype=f32, device=dev),
            torch.empty((n, K), dtype=f32, device=dev),
            torch.empty((n, K, 4), dtype=f32, device=dev),
            torch.empty((n,), dtype=f32, device=dev),
            torch.empty((n,), dtype=f32, device=dev))
    side = 2.0 * cfg.ped_radius
    consts = (nm.f32(side), nm.f32(2.0 * side * side), nm.recip_f32(cfg.dt),
              nm.f32(cfg.collision_body_width * cfg.collision_body_width),
              nm.f32(cfg.cp_ttc_weight), nm.f32(cfg.cp_dist_weight),
              nm.f32(cfg.max_scan_range),
              nm.recip_f32(max(nm.f32(cfg.max_scan_range
                                      - cfg.min_scan_range), nm.f32(1e-9))))
    return ptrs, outs, consts


def track_cp_topk(cfg, seg_conf, seg_obs, seg_pos, seg_dist, t_valid, t_pos,
                  t_prev, t_dist, t_speed, t_vel, r_pos, r_prev, compute_cp,
                  envs_per_block: int | None = None, form: str = "xla"):
    """Launch the tracker -> CP -> top-K kernel in ``form`` (one of
    ``ops.risk.FORMS``). Returns the new track fields ``(valid, pos,
    prev_pos, has_prev, dist, speed, vel)`` and ``(top_cp, top_pose_vel,
    cp_max, ego_cp)``."""
    if form not in TRACK_FORMS:
        raise ValueError(f"unknown chain form {form!r}")
    ptrs, outs, consts = track_cp_topk_buffers(
        cfg, seg_conf, seg_obs, seg_pos, seg_dist, t_valid, t_pos, t_prev,
        t_dist, t_speed, t_vel, r_pos, r_prev, compute_cp)
    n, S = seg_conf.shape
    T, K = t_valid.shape[1], cfg.k_obstacles
    geo = launch.track_cp_topk_launch(n, envs_per_block)
    addrs = (ctypes.c_void_p * 24)(*ptrs, *(o.data_ptr() for o in outs))
    code = library().crowdnav_track_cp_topk(
        addrs, n, S, T, K, geo.grid, geo.envs_per_block, *consts,
        TRACK_FORMS[form], _stream(seg_conf.device))
    _check(code, "crowdnav_track_cp_topk")
    return outs[:7], outs[7:]


def _elementwise_input(name, t):
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name}: expected float32, got {t.dtype}")
    if t.numel() >= 2 ** 31:
        raise ValueError(f"{name}: {t.numel()} elements overflow the "
                         f"kernel's 32-bit index")
    return t.contiguous()


def libm_sincos(x, cosine: bool):
    """Launch the C library's ``cosf`` (``cosine``) or ``sinf`` of every
    element of the float32 CUDA tensor ``x``."""
    x = _elementwise_input("x", x)
    out = torch.empty_like(x)
    geo = launch.elementwise_launch(x.numel())
    code = library().crowdnav_libm_sincos(
        x.data_ptr(), out.data_ptr(), x.numel(), int(cosine), geo.grid,
        geo.threads, _stream(x.device))
    _check(code, "crowdnav_libm_sincos")
    return out


def libm_atan2(y, x):
    """Launch the C library's ``atan2f(y, x)`` elementwise; ``y`` and
    ``x`` broadcast."""
    y, x = torch.broadcast_tensors(y, x)
    y, x = _elementwise_input("y", y), _elementwise_input("x", x)
    out = torch.empty_like(y)
    geo = launch.elementwise_launch(y.numel())
    code = library().crowdnav_libm_atan2(
        y.data_ptr(), x.data_ptr(), out.data_ptr(), y.numel(), geo.grid,
        geo.threads, _stream(y.device))
    _check(code, "crowdnav_libm_atan2")
    return out
