"""Checkpoints of the port (the counterpart of
``crowdnav_tpu/utils/checkpoint.py``, which is Orbax and stays with the
JAX package).

- The full trainer state, for ``--resume``: env states, observations,
  episode statistics, the generator's state, the reset bank, the learner
  state, the replay ring's written blocks and ``drivers/train``'s
  counters, in one ``torch.save`` file per step,
  ``<dir>/state_<step>.pt``, written under a temporary name and renamed
  into place (the ring alone is 1.6 GB at the flagship width; as in the
  JAX package, every step's file is kept).
- The agent alone: ``<dir>/agent_<step>.npz``, the arrays of the learner
  state (any algorithm) under the keys of ``utils/convert.py`` and the
  run's metadata as
  the JSON string ``run_config``; the same file format that
  ``scripts/export_torch_agent.py`` writes from a JAX checkpoint, and what
  ``drivers/evaluate --checkpoint`` reads.
- ``run_config.json`` beside them, with the keys of the JAX driver's
  ``run_metadata``.
"""
from __future__ import annotations

import dataclasses
import glob
import json
import os
import re

import numpy as np
import torch

from crowdnav_tpu_torch.agents.replay import ReplayState
from crowdnav_tpu_torch.utils.convert import (state_from_arrays,
                                              state_to_arrays)
from crowdnav_tpu_torch.utils.tree import to_device


def _steps(path: str, prefix: str, suffix: str):
    pat = re.compile(rf"{prefix}_(\d+){re.escape(suffix)}$")
    found = []
    for f in glob.glob(os.path.join(path, f"{prefix}_*{suffix}")):
        m = pat.search(os.path.basename(f))
        if m:
            found.append(int(m.group(1)))
    return sorted(found)


def latest_step(path: str, prefix: str = "state", suffix: str = ".pt"):
    steps = _steps(path, prefix, suffix)
    return steps[-1] if steps else None


def _atomic_save(obj, path: str, save):
    tmp = f"{path}.{os.getpid()}.tmp"
    save(obj, tmp)
    os.replace(tmp, path)


def save_checkpoint(path: str, trainer_state, step: int,
                    counters: dict | None = None):
    """The full trainer state at ``step``, plus ``drivers/train``'s
    ``counters``."""
    os.makedirs(path, exist_ok=True)
    fields = {f.name: getattr(trainer_state, f.name)
              for f in dataclasses.fields(trainer_state)}
    gen = fields.pop("gen")
    replay = fields.get("replay")
    if isinstance(replay, ReplayState):
        # the ring fills from block 0: only the blocks written so far
        n = int(replay.size) // replay.reward.shape[1]
        fields["replay"] = dataclasses.replace(replay, **{
            f: getattr(replay, f)[:n]
            for f in ("obs", "next_obs", "action", "reward", "done")})
    payload = to_device(fields, "cpu")
    payload["gen_state"] = gen.get_state()
    payload["counters"] = dict(counters or {})
    payload["step"] = int(step)
    out = os.path.join(path, f"state_{step}.pt")
    _atomic_save(payload, out, torch.save)


def restore_checkpoint(path: str, template, step: int | None = None):
    """``(state, step, counters)`` from the newest (or ``step``'s) full
    checkpoint, on the template's device and generator."""
    step = latest_step(path) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {path}; cannot resume")
    payload = torch.load(os.path.join(path, f"state_{step}.pt"),
                         weights_only=False)
    kw = {f.name: to_device(payload[f.name], template.obs.device)
          for f in dataclasses.fields(template) if f.name != "gen"}
    if isinstance(template.replay, ReplayState):
        saved, ring = kw["replay"], template.replay
        for f in ("obs", "next_obs", "action", "reward", "done"):
            part = getattr(saved, f)
            getattr(ring, f)[:part.shape[0]].copy_(part)
        kw["replay"] = dataclasses.replace(ring, head=saved.head,
                                           size=saved.size)
    template.gen.set_state(payload["gen_state"])
    state = dataclasses.replace(template, **kw)
    return state, payload["step"], payload["counters"]


def save_agent(path: str, agent, agent_state, step: int,
               meta: dict | None = None) -> str:
    """The agent alone at ``step``: ``<path>/agent_<step>.npz``."""
    os.makedirs(path, exist_ok=True)
    arrays = state_to_arrays(agent, agent_state)
    if meta is not None:
        arrays["run_config"] = np.asarray(json.dumps(meta, sort_keys=True))
    out = os.path.join(path, f"agent_{step}.npz")
    def write(a, f):
        with open(f, "wb") as fp:
            np.savez(fp, **a)

    _atomic_save(arrays, out, write)
    return out


def agent_file(path: str, step: int | None = None) -> str:
    """The agent file at ``path``: the file itself, or in a directory the
    newest (or ``step``'s) ``agent_<step>.npz``."""
    if os.path.isfile(path):
        return path
    step = latest_step(path, "agent", ".npz") if step is None else step
    if step is None:
        raise FileNotFoundError(f"no agent checkpoint under {path}")
    return os.path.join(path, f"agent_{step}.npz")


def read_arrays(path: str):
    """``(arrays, run metadata or None)`` of an agent or actor file."""
    with np.load(path, allow_pickle=False) as f:
        arrays = {k: f[k] for k in f.files}
    meta = None
    if "run_config" in arrays:
        meta = json.loads(str(arrays.pop("run_config")))
    return arrays, meta


def load_agent(path: str, agent, step: int | None = None):
    """``(learner state, metadata)`` from an agent file or directory, for
    any of the port's agents (``utils/convert.state_from_arrays``)."""
    arrays, meta = read_arrays(agent_file(path, step))
    return state_from_arrays(agent, arrays), meta


def save_run_metadata(path: str, meta: dict):
    """``run_config.json`` beside a checkpoint, as the JAX driver writes
    it."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "run_config.json"), "w") as fp:
        json.dump(meta, fp, indent=1, sort_keys=True)


def load_run_metadata(path: str) -> dict | None:
    p = os.path.join(path, "run_config.json")
    if not os.path.isfile(p):
        return None
    with open(p) as fp:
        return json.load(fp)
