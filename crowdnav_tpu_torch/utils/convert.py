"""Flax parameters (numpy) <-> the port's modules and learner states.

Flax ``Dense`` kernels are (in, out); torch ``Linear`` weights are
(out, in). Every network of the port names its layers ``dense{i}`` where
flax names them ``Dense_{i}`` (``models/networks.py``)."""
from __future__ import annotations

import re

import numpy as np
import torch

from crowdnav_tpu_torch.agents.optim import AdamState, RMSpropState
from crowdnav_tpu_torch.models.networks import unflatten


def _dense_names(p) -> list:
    """``[(flax layer, port layer)]`` of the ``Dense_i`` keys, in order."""
    idx = sorted(int(m.group(1)) for k in p
                 for m in [re.fullmatch(r"Dense_(\d+)", k)] if m)
    return [(f"Dense_{i}", f"dense{i}") for i in idx]


def flax_actor_to_state_dict(params) -> dict:
    """``{"params": {"Dense_i": {"kernel", "bias"}}}`` (or the inner dict)
    -> ``{"dense{i}.weight", "dense{i}.bias"}`` float32 tensors, for any
    of the port's single networks (actor, Gaussian actor, Q-network)."""
    p = params.get("params", params)
    sd = {}
    for flax_name, name in _dense_names(p):
        kernel = np.asarray(p[flax_name]["kernel"], np.float32)
        sd[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(
            kernel.T))
        sd[f"{name}.bias"] = torch.from_numpy(
            np.asarray(p[flax_name]["bias"], np.float32).copy())
    return sd


def state_dict_to_flax_actor(sd: dict) -> dict:
    """Inverse of :func:`flax_actor_to_state_dict`."""
    out = {}
    n = len({k.split(".")[0] for k in sd})
    for i in range(n):
        out[f"Dense_{i}"] = {
            "kernel": sd[f"dense{i}.weight"].detach().cpu().numpy().T.copy(),
            "bias": sd[f"dense{i}.bias"].detach().cpu().numpy().copy()}
    return {"params": out}


def npz_to_flax_actor(arrays) -> dict:
    """The arrays of an exported policy file (keys ``Dense_i/kernel``,
    ``Dense_i/bias``) -> flax's nested params."""
    out = {}
    for key in arrays:
        m = re.fullmatch(r"(Dense_\d+)/(kernel|bias)", key)
        if m:
            out.setdefault(m.group(1), {})[m.group(2)] = arrays[key]
    return {"params": out}


# ---- whole learner states ----
#
# A JAX agent state crosses over as a dict of numpy arrays under
# slash-separated keys (``scripts/export_torch_agent.py`` writes them):
#   <net field>/[q1/|q2/]Dense_i/{kernel,bias}     (flax's (in, out) kernels)
#   <adam field>/{mu,nu}/..., <adam field>/count
#   <rmsprop field>/nu/...
#   scalars and per-env arrays under their field names
# The port's state holds each network as one flat vector in its module's
# parameter order (``models/networks.layout``). Each agent lists its
# state's fields in ``STATE_FIELDS``: (field, kind, network), kinds
# "net", "adam", "rmsprop", "int32", "float32" and "per_env" (an (N, ...)
# float32 carry such as DDPG's OU state).


def _flax_key(name: str) -> str:
    """``"q1.dense0.weight"`` -> ``"q1/Dense_0/kernel"``."""
    *head, layer, kind = name.split(".")
    return "/".join(head + [f"Dense_{int(layer[5:])}",
                            "kernel" if kind == "weight" else "bias"])


def _flat_from_arrays(arrays, prefix: str, lay) -> torch.Tensor:
    parts = []
    for name, shape in lay:
        a = np.asarray(arrays[f"{prefix}/{_flax_key(name)}"], np.float32)
        parts.append((a.T if len(shape) == 2 else a).reshape(-1))
    return torch.from_numpy(np.concatenate(parts))


def _arrays_from_flat(flat, lay, prefix: str, out: dict):
    views = unflatten(flat.detach().cpu(), lay)
    for name, shape in lay:
        v = views[name].numpy()
        out[f"{prefix}/{_flax_key(name)}"] = (v.T if len(shape) == 2
                                              else v).copy()


def state_from_arrays(agent, arrays):
    """The agent's learner state on ``agent.device`` from exported arrays.
    A per-env carry saved at another env count (DDPG's OU state of a
    training run, read for evaluation) starts at zeros, as the JAX
    package's ``restore_agent_state`` does."""
    dev = agent.device

    def flat(prefix, net):
        return _flat_from_arrays(arrays, prefix, agent.layouts[net]).to(dev)

    kw = {}
    for field, kind, net in agent.STATE_FIELDS:
        if kind == "net":
            kw[field] = flat(field, net)
        elif kind == "adam":
            kw[field] = AdamState(
                mu=flat(f"{field}/mu", net), nu=flat(f"{field}/nu", net),
                count=torch.tensor(np.asarray(arrays[f"{field}/count"])
                                   .item(), dtype=torch.int32, device=dev))
        elif kind == "rmsprop":
            kw[field] = RMSpropState(nu=flat(f"{field}/nu", net))
        elif kind == "per_env":
            a = np.asarray(arrays[field], np.float32)
            if a.shape[0] != agent.n_envs:
                a = np.zeros((agent.n_envs,) + a.shape[1:], np.float32)
            kw[field] = torch.from_numpy(a.copy()).to(dev)
        else:
            kw[field] = torch.tensor(np.asarray(arrays[field]).item(),
                                     dtype=getattr(torch, kind), device=dev)
    return agent.state_cls(**kw)


def state_to_arrays(agent, state) -> dict:
    """Inverse of :func:`state_from_arrays` (numpy arrays)."""
    out = {}
    for field, kind, net in agent.STATE_FIELDS:
        v = getattr(state, field)
        lay = agent.layouts.get(net)
        if kind == "net":
            _arrays_from_flat(v, lay, field, out)
        elif kind == "adam":
            _arrays_from_flat(v.mu, lay, f"{field}/mu", out)
            _arrays_from_flat(v.nu, lay, f"{field}/nu", out)
            out[f"{field}/count"] = np.asarray(int(v.count), np.int32)
        elif kind == "rmsprop":
            _arrays_from_flat(v.nu, lay, f"{field}/nu", out)
        elif kind == "per_env":
            out[field] = v.detach().cpu().numpy().astype(np.float32)
        else:
            out[field] = np.asarray(v.item(), getattr(np, kind))
    return out

