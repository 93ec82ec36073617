"""Multi-process execution over ``torch.distributed`` (port of
``crowdnav_tpu/parallel/distributed.py``).

The JAX package's multi-controller recipe, rank for device:

1. every process calls :func:`init_multihost` before it touches the card:
   ``torch.distributed.init_process_group`` over TCP at the coordinator's
   address, NCCL for a CUDA device and gloo for the CPU unless the caller
   names the backend;
2. ``parallel.mesh.make_mesh`` lays the ranks out on one ``env`` axis, one
   device a rank;
3. every process builds the same whole trainer state from the same seed,
   and :func:`distribute` keeps this rank's rows of it;
4. each rank steps its own envs; the learners' gradients, the replay
   gate's row count and the episode statistics are summed over the ranks
   (``parallel/mesh.py``).

Nothing is auto-detected: the coordinator's address, the process count and
this process's id come from the arguments or the environment
(``JAX_COORDINATOR_ADDRESS``/``JAX_NUM_PROCESSES``/``JAX_PROCESS_ID``, as
the JAX driver reads them, or ``MASTER_ADDR``:``MASTER_PORT``/
``WORLD_SIZE``/``RANK``).
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from crowdnav_tpu_torch.utils.device import resolve
from crowdnav_tpu_torch.utils.tree import map_tensors


def _env_int(*names):
    for name in names:
        if os.environ.get(name):
            return int(os.environ[name])
    return None


def _coordinator():
    addr = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if addr:
        return addr
    if os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        return f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    return None


def rank_device(device="cuda", process_id: int = 0) -> torch.device:
    """This process's device: ``device`` as given when it names an index
    or the CPU; for a bare ``"cuda"`` the card ``LOCAL_RANK`` (else the
    process id modulo the local card count), one card a rank."""
    dev = resolve(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    local = _env_int("LOCAL_RANK")
    if local is None:
        local = process_id % torch.cuda.device_count()
    return torch.device("cuda", local)


def init_multihost(coordinator: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None,
                   backend: str | None = None,
                   device="cuda") -> torch.device:
    """Join the process group (``jax.distributed.initialize`` of the JAX
    package); returns this rank's device (:func:`rank_device`), made the
    current card for a CUDA device. ``backend`` None: NCCL for a CUDA
    device, gloo for the CPU; a named backend is used as given (gloo
    also all-reduces CUDA tensors, through the host)."""
    coordinator = coordinator or _coordinator()
    if num_processes is None:
        num_processes = _env_int("JAX_NUM_PROCESSES", "WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("JAX_PROCESS_ID", "RANK")
    missing = [name for name, v in (("coordinator", coordinator),
                                    ("num_processes", num_processes),
                                    ("process_id", process_id)) if v is None]
    if missing:
        raise ValueError(f"init_multihost: no {', '.join(missing)} given "
                         f"and none in the environment")
    dev = rank_device(device, process_id)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
    return dev


def shutdown():
    """Leave the process group, if this process is in one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def world() -> tuple[int, int]:
    """``(rank, world size)``; ``(0, 1)`` outside a process group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def shard_rows(n_rows: int, rank: int, world_size: int) -> slice:
    """The rows of rank ``rank`` of ``n_rows`` split evenly."""
    if n_rows % world_size:
        raise ValueError(f"{n_rows} rows do not split over {world_size} "
                         f"ranks")
    per = n_rows // world_size
    return slice(rank * per, (rank + 1) * per)


def distribute(tree, n_rows: int, rank: int | None = None,
               world_size: int | None = None):
    """Keep this rank's rows of a state that every rank built whole from
    the same seed: each tensor whose leading axis is ``n_rows`` long is
    cut to its rows (a copy), every other leaf stays whole."""
    if rank is None or world_size is None:
        rank, world_size = world()
    rows = shard_rows(n_rows, rank, world_size)

    def keep(t):
        if t.dim() >= 1 and t.shape[0] == n_rows:
            return t[rows].clone()
        return t

    return map_tensors(keep, tree)


def all_min(value: int, device="cpu") -> int:
    """The least of each rank's ``value`` (the value outside a group)."""
    if not dist.is_initialized():
        return value
    t = torch.tensor([value], dtype=torch.int64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return int(t.item())


def process_summary() -> dict:
    """This process's place in the group, one device a rank."""
    rank, size = world()
    return {"process_index": rank, "process_count": size,
            "local_devices": 1, "global_devices": size,
            "backend": dist.get_backend() if dist.is_initialized()
            else None}
