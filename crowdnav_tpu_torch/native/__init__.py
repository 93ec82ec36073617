"""Native (C++) host simulator, bound through ctypes.

``fastsim.cpp`` is the host-side counterpart of the port's world model:
the same diff-drive kinematics and raycast as ``envs/world.py`` and
``ops/lidar.py``, in plain C++ with OpenMP over envs. It backs robot-side
deployment loops (no PyTorch device on the robot) and is a third
independent implementation for parity tests. It is a host simulator by
design: it takes no device and never moves data to the card, and nothing
on the training or evaluation path calls it.

The library is built at first use by one ``g++`` call into
``native/build/``. Its file name carries a hash of the source and the
flags, so a stale build is never loaded, and it is written under a
temporary name and renamed into place, so that processes building at the
same time each load a whole library. A failed build raises. The flags
carry no fast-math option: the library computes what the JAX package's
``crowdnav_tpu/native`` library computes, bit for bit.

State fields and scans are CPU tensors whose memory the C side writes in
place; the xorshift seeds stay a NumPy ``uint64`` array.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from crowdnav_tpu_torch.envs.config import CrowdBehavior, EnvConfig

SRC = Path(__file__).resolve().parent / "fastsim.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "build"
GXX_FLAGS = ["-O3", "-fopenmp", "-shared", "-fPIC"]
BUILD_TIMEOUT_S = 300

MAX_PEDS = 64

build_seconds = None   # wall time of this process's g++ call, if it built


class _Config(ctypes.Structure):
    _fields_ = [
        ("n_scans", ctypes.c_int32), ("n_peds", ctypes.c_int32),
        ("dt", ctypes.c_float), ("wheel_separation", ctypes.c_float),
        ("wheel_radius", ctypes.c_float), ("robot_radius", ctypes.c_float),
        ("ped_radius", ctypes.c_float), ("room_half_inner", ctypes.c_float),
        ("max_scan_range", ctypes.c_float),
        ("lidar_min_range", ctypes.c_float),
        ("goal_x", ctypes.c_float), ("goal_y", ctypes.c_float),
        ("goal_eps", ctypes.c_float), ("min_scan_range", ctypes.c_float),
        ("max_steps", ctypes.c_int32),
    ]


class _State(ctypes.Structure):
    _fields_ = [
        ("x", ctypes.c_float), ("y", ctypes.c_float),
        ("yaw", ctypes.c_float),
        ("prev_x", ctypes.c_float), ("prev_y", ctypes.c_float),
        ("step", ctypes.c_int32), ("done", ctypes.c_int32),
        ("peds", ctypes.c_float * (2 * MAX_PEDS)),
    ]


class _BatchConfig(ctypes.Structure):
    _fields_ = [
        ("base", _Config),
        ("n_envs", ctypes.c_int32),
        ("behavior", ctypes.c_int32),
        ("crowd_speed", ctypes.c_float),
        ("redraw_window", ctypes.c_int32),
        ("start_x", ctypes.c_float), ("start_y", ctypes.c_float),
        ("start_yaw", ctypes.c_float),
        ("start_pos_jitter", ctypes.c_float),
        ("start_yaw_jitter", ctypes.c_float),
        ("ped_pos_jitter", ctypes.c_float),
        ("ped_init", ctypes.POINTER(ctypes.c_float)),
        ("ped_dirs", ctypes.POINTER(ctypes.c_float)),
    ]


def library_path(src: Path = SRC, build_dir: Path = BUILD_DIR) -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(Path(src).read_bytes())
    return Path(build_dir) / f"libfastsim_{h.hexdigest()[:16]}.so"


def compile_library(src: Path = SRC, build_dir: Path = BUILD_DIR
                    ) -> tuple[Path, float | None]:
    """Run ``g++`` over ``src`` if its library is not built yet; return
    the library's path and the call's seconds (None if it was built
    already)."""
    path = library_path(src, build_dir)
    if path.exists():
        return path, None
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
    cmd = ["g++", *GXX_FLAGS, str(src), "-o", str(tmp)]
    t0 = time.perf_counter()
    try:
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=BUILD_TIMEOUT_S)
    except FileNotFoundError as e:
        raise RuntimeError(f"g++ not found: {e}") from e
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed ({res.returncode}):\n{' '.join(cmd)}"
                           f"\n{res.stdout}\n{res.stderr}")
    os.replace(tmp, path)
    return path, time.perf_counter() - t0


def bind(path) -> ctypes.CDLL:
    """Load a fastsim library and declare its C interface."""
    lib = ctypes.CDLL(str(path))
    fp = ctypes.POINTER(ctypes.c_float)
    cfg, st = ctypes.POINTER(_Config), ctypes.POINTER(_State)
    lib.fastsim_integrate.argtypes = [cfg, st, ctypes.c_float,
                                      ctypes.c_float]
    lib.fastsim_scan.argtypes = [cfg, st, fp]
    lib.fastsim_step.argtypes = [cfg, st, ctypes.c_float, ctypes.c_float,
                                 fp, fp]
    lib.fastsim_step.restype = ctypes.c_int32
    lib.fastsim_rollout.argtypes = [cfg, st, fp, ctypes.c_int32, fp, fp, fp]
    lib.fastsim_rollout.restype = ctypes.c_int32
    ip = ctypes.POINTER(ctypes.c_int32)
    up = ctypes.POINTER(ctypes.c_uint64)
    soa = [ctypes.POINTER(_BatchConfig), fp, fp, fp, fp, fp, ip, ip, fp, fp,
           up]
    lib.fastsim_reset_batch.argtypes = soa
    lib.fastsim_step_batch.argtypes = soa + [fp, fp]
    return lib


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    global build_seconds
    path, build_seconds = compile_library()
    return bind(path)


_CTYPES = {torch.float32: ctypes.c_float, torch.int32: ctypes.c_int32}


def _ptr(t: torch.Tensor, dtype, numel: int):
    """A C pointer to the memory of ``t``, a contiguous CPU tensor of
    ``dtype`` with ``numel`` elements (the C side reads and writes it in
    place)."""
    if not isinstance(t, torch.Tensor) or t.device.type != "cpu":
        raise ValueError(f"fastsim: expected a CPU tensor, got "
                         f"{getattr(t, 'device', type(t))}")
    if t.dtype != dtype or not t.is_contiguous() or t.numel() != numel:
        raise ValueError(f"fastsim: expected a contiguous {dtype} tensor of "
                         f"{numel} elements, got {t.dtype} {tuple(t.shape)}")
    return ctypes.cast(t.data_ptr(), ctypes.POINTER(_CTYPES[dtype]))


def _floats(x, numel: int | None = None) -> torch.Tensor:
    """``x`` (a CPU tensor or a NumPy array) as a contiguous float32 CPU
    tensor; CUDA tensors are refused, not copied."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x, np.float32))
    if t.device.type != "cpu":
        raise ValueError(f"fastsim: expected a CPU tensor or a NumPy array, "
                         f"got a tensor on {t.device}")
    t = t.to(torch.float32).contiguous()
    if numel is not None and t.numel() != numel:
        raise ValueError(f"fastsim: expected {numel} values, got "
                         f"{tuple(t.shape)}")
    return t


def _config(cfg: EnvConfig) -> _Config:
    return _Config(
        n_scans=cfg.n_scans, n_peds=cfg.n_peds, dt=cfg.dt,
        wheel_separation=cfg.wheel_separation,
        wheel_radius=cfg.wheel_radius, robot_radius=cfg.robot_radius,
        ped_radius=cfg.ped_radius, room_half_inner=cfg.room_half_inner,
        max_scan_range=cfg.max_scan_range,
        lidar_min_range=cfg.lidar_min_range,
        goal_x=cfg.goal[0], goal_y=cfg.goal[1], goal_eps=cfg.goal_eps,
        min_scan_range=cfg.min_scan_range, max_steps=cfg.max_steps)


class FastSim:
    """Native single-env simulator mirroring ``envs.world`` and the
    raycast of ``ops.lidar``."""

    def __init__(self, cfg: EnvConfig):
        if cfg.n_peds > MAX_PEDS:
            raise ValueError(f"fastsim supports <= {MAX_PEDS} pedestrians")
        self._lib = library()
        self._cfg = _config(cfg)
        self.cfg = cfg
        self.reset()

    def reset(self):
        self._st = _State()
        self._st.x, self._st.y, self._st.yaw = self.cfg.start_pose
        self._st.prev_x, self._st.prev_y = self.cfg.start_pose[:2]
        peds = np.zeros(2 * MAX_PEDS, np.float32)
        if self.cfg.n_peds:
            peds[:2 * self.cfg.n_peds] = np.asarray(
                self.cfg.ped_init, np.float32).ravel()
        self._st.peds = (ctypes.c_float * (2 * MAX_PEDS))(*peds)

    @property
    def pose(self) -> torch.Tensor:
        """(3,) float32: x, y, yaw."""
        return torch.tensor([self._st.x, self._st.y, self._st.yaw],
                            dtype=torch.float32)

    @property
    def done(self) -> int:
        return int(self._st.done)

    def scan(self) -> torch.Tensor:
        out = torch.empty(self.cfg.n_scans, dtype=torch.float32)
        self._lib.fastsim_scan(ctypes.byref(self._cfg),
                               ctypes.byref(self._st),
                               _ptr(out, torch.float32, out.numel()))
        return out

    def _ped_vels(self, vel, steps: int):
        if vel is None:
            return None
        return _floats(vel, 2 * self.cfg.n_peds * steps)

    def step(self, lin: float, ang: float, ped_vel=None):
        """One transition; ``ped_vel`` (P, 2) moves the crowd (None: it
        stays). Returns (scan, done code)."""
        scan = torch.empty(self.cfg.n_scans, dtype=torch.float32)
        pv = self._ped_vels(ped_vel, 1)
        done = self._lib.fastsim_step(
            ctypes.byref(self._cfg), ctypes.byref(self._st),
            ctypes.c_float(lin), ctypes.c_float(ang),
            None if pv is None else _ptr(pv, torch.float32, pv.numel()),
            _ptr(scan, torch.float32, scan.numel()))
        return scan, int(done)

    def rollout(self, actions, ped_vels=None) -> torch.Tensor:
        """actions (T, 2) -> trajectory (n, 3) of (x, y, yaw); stops at the
        episode's end."""
        actions = _floats(actions).reshape(-1, 2)
        n_steps = actions.shape[0]
        traj = torch.zeros((n_steps, 3), dtype=torch.float32)
        scan_buf = torch.empty(self.cfg.n_scans, dtype=torch.float32)
        pv = self._ped_vels(ped_vels, n_steps)
        n = self._lib.fastsim_rollout(
            ctypes.byref(self._cfg), ctypes.byref(self._st),
            _ptr(actions, torch.float32, actions.numel()), n_steps,
            None if pv is None else _ptr(pv, torch.float32, pv.numel()),
            _ptr(traj, torch.float32, traj.numel()),
            _ptr(scan_buf, torch.float32, scan_buf.numel()))
        return traj[:n]


class FastSimBatch:
    """Native batched multi-env simulator (SoA, OpenMP over envs).

    The host-side counterpart of the port's batched world step
    (``envs/world.py``): N independent envs per call, crowd behavior
    families (static / random-redraw / fixed direction tables, from
    ``crowd_behaviors/simulate_*.py``), jittered auto-reset, raycast and
    termination. RANDOM draws use per-env xorshift64* streams, seeded
    from ``np.random.SeedSequence(seed)`` as the JAX package's class seeds
    them: behaviorally equivalent to, and deliberately not bit-matching,
    the port's ``torch.Generator`` draws (parity tests feed both engines
    explicit velocities instead). The STATIC family keeps whatever
    velocities the state holds.

    State fields, (N,) or (N, P, 2) CPU tensors the C side updates in
    place: ``x``, ``y``, ``yaw``, ``prev_x``, ``prev_y``, ``step_count``
    and ``done`` (int32), ``peds``, ``ped_vel``; ``rng`` (N,) uint64
    NumPy; ``scans`` (N, n_scans), the last step's.
    """

    # behavior codes shared with the C side
    STATIC, RANDOM, TABLE = 0, 1, 2

    def __init__(self, cfg: EnvConfig, n_envs: int, seed: int = 0):
        self._lib = library()
        self.cfg = cfg
        self.n_envs = int(n_envs)
        p = max(cfg.n_peds, 1)
        self._ped_init = torch.zeros((p, 2), dtype=torch.float32)
        self._ped_dirs = torch.zeros((p, 2), dtype=torch.float32)
        if cfg.n_peds:
            self._ped_init[:] = torch.tensor(cfg.ped_init,
                                             dtype=torch.float32)
            self._ped_dirs[:] = torch.tensor(cfg.direction_table(),
                                             dtype=torch.float32)
        if cfg.behavior == CrowdBehavior.STATIC:
            behavior = self.STATIC
        elif cfg.behavior == CrowdBehavior.RANDOM:
            behavior = self.RANDOM
        else:
            behavior = self.TABLE
        self._bc = _BatchConfig(
            base=_config(cfg), n_envs=self.n_envs, behavior=behavior,
            crowd_speed=cfg.crowd_speed,
            redraw_window=max(cfg.redraw_window_steps, 1),
            start_x=cfg.start_pose[0], start_y=cfg.start_pose[1],
            start_yaw=cfg.start_pose[2],
            start_pos_jitter=cfg.start_pos_jitter,
            start_yaw_jitter=cfg.start_yaw_jitter,
            ped_pos_jitter=cfg.ped_pos_jitter,
            ped_init=_ptr(self._ped_init, torch.float32, 2 * p),
            ped_dirs=_ptr(self._ped_dirs, torch.float32, 2 * p))
        n, s = self.n_envs, cfg.n_scans
        zf = lambda *shape: torch.zeros(shape, dtype=torch.float32)
        self.x, self.y, self.yaw = zf(n), zf(n), zf(n)
        self.prev_x, self.prev_y = zf(n), zf(n)
        self.step_count = torch.zeros(n, dtype=torch.int32)
        self.done = torch.zeros(n, dtype=torch.int32)
        self.peds = zf(n, p, 2)
        self.ped_vel = zf(n, p, 2)
        rng = np.random.SeedSequence(seed).generate_state(2 * n, np.uint64)
        self.rng = (rng[:n] | 1).astype(np.uint64)  # nonzero xorshift seeds
        self.scans = zf(n, s)
        self.reset()

    def _soa_args(self):
        n = self.n_envs
        p2 = 2 * max(self.cfg.n_peds, 1) * n
        f, i = torch.float32, torch.int32
        if self.rng.dtype != np.uint64 or self.rng.shape != (n,) \
                or not self.rng.flags.c_contiguous:
            raise ValueError("fastsim: rng must be a contiguous (N,) uint64 "
                             "array")
        return [ctypes.byref(self._bc),
                _ptr(self.x, f, n), _ptr(self.y, f, n),
                _ptr(self.yaw, f, n), _ptr(self.prev_x, f, n),
                _ptr(self.prev_y, f, n), _ptr(self.step_count, i, n),
                _ptr(self.done, i, n), _ptr(self.peds, f, p2),
                _ptr(self.ped_vel, f, p2),
                self.rng.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))]

    def reset(self):
        self._lib.fastsim_reset_batch(*self._soa_args())

    def step(self, actions) -> torch.Tensor:
        """actions (N, 2), a CPU tensor or a NumPy array -> scans (N,
        n_scans); done codes in ``.done`` (0 live, 1 success, 2 collision,
        3 timeout). Done envs auto-reset at the START of the next call
        (their final state stays readable)."""
        actions = _floats(actions, 2 * self.n_envs)
        self._lib.fastsim_step_batch(
            *self._soa_args(), _ptr(actions, torch.float32, actions.numel()),
            _ptr(self.scans, torch.float32, self.scans.numel()))
        return self.scans
