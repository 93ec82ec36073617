"""Flax actor parameters (numpy) <-> the port's actor ``state_dict``.

Flax ``Dense`` kernels are (in, out); torch ``Linear`` weights are
(out, in)."""
from __future__ import annotations

import numpy as np
import torch

from crowdnav_tpu_torch.agents.optim import AdamState
from crowdnav_tpu_torch.agents.td3 import TD3State
from crowdnav_tpu_torch.models.networks import unflatten

_LAYERS = (("Dense_0", "dense0"), ("Dense_1", "dense1"),
           ("Dense_2", "dense2"))


def flax_actor_to_state_dict(params) -> dict:
    """``{"params": {"Dense_i": {"kernel", "bias"}}}`` (or the inner dict)
    -> ``{"dense{i}.weight", "dense{i}.bias"}`` float32 tensors."""
    p = params.get("params", params)
    sd = {}
    for flax_name, name in _LAYERS:
        kernel = np.asarray(p[flax_name]["kernel"], np.float32)
        sd[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(
            kernel.T))
        sd[f"{name}.bias"] = torch.from_numpy(
            np.asarray(p[flax_name]["bias"], np.float32).copy())
    return sd


def state_dict_to_flax_actor(sd: dict) -> dict:
    """Inverse of :func:`flax_actor_to_state_dict`."""
    out = {}
    for flax_name, name in _LAYERS:
        out[flax_name] = {
            "kernel": sd[f"{name}.weight"].detach().cpu().numpy().T.copy(),
            "bias": sd[f"{name}.bias"].detach().cpu().numpy().copy()}
    return {"params": out}


def npz_to_flax_actor(arrays) -> dict:
    """The arrays of an exported actor file (keys ``Dense_i/kernel``,
    ``Dense_i/bias``) -> flax's nested params."""
    out = {}
    for flax_name, _ in _LAYERS:
        out[flax_name] = {"kernel": arrays[f"{flax_name}/kernel"],
                          "bias": arrays[f"{flax_name}/bias"]}
    return {"params": out}


# ---- the whole TD3 learner state ----
#
# A JAX ``TD3State`` crosses over as a dict of numpy arrays under
# slash-separated keys (``scripts/export_torch_agent.py`` writes them):
#   {actor,critic}_{params,target}/[q1/|q2/]Dense_i/{kernel,bias}
#   {actor,critic}_opt/{mu,nu}/[q1/|q2/]Dense_i/{kernel,bias}
#   {actor,critic}_opt/count, update_count, explore_sigma, explore_eps
# with flax's (in, out) kernels. The port's state holds each network as one
# flat vector in its module's parameter order (``models/networks.layout``).

_NETS = {"actor": ("",), "critic": ("q1/", "q2/")}


def _flat_from_arrays(arrays, prefix: str, heads) -> torch.Tensor:
    parts = []
    for head in heads:
        for i in range(3):
            key = f"{prefix}/{head}Dense_{i}"
            parts.append(np.asarray(arrays[f"{key}/kernel"], np.float32).T
                         .reshape(-1))
            parts.append(np.asarray(arrays[f"{key}/bias"], np.float32)
                         .reshape(-1))
    return torch.from_numpy(np.concatenate(parts))


def _arrays_from_flat(flat, lay, prefix: str, heads, out: dict):
    views = unflatten(flat.detach().cpu(), lay)
    for head in heads:
        mod = head.replace("/", ".")
        for i in range(3):
            key = f"{prefix}/{head}Dense_{i}"
            out[f"{key}/kernel"] = views[f"{mod}dense{i}.weight"].numpy() \
                .T.copy()
            out[f"{key}/bias"] = views[f"{mod}dense{i}.bias"].numpy().copy()


def td3_state_from_arrays(agent, arrays):
    """The port's ``TD3State`` on ``agent.device`` from exported arrays."""
    dev = agent.device

    def net(name, field):
        return _flat_from_arrays(arrays, f"{name}_{field}",
                                 _NETS[name]).to(dev)

    def scalar(key, dtype):
        return torch.tensor(np.asarray(arrays[key]).item(), dtype=dtype,
                            device=dev)

    def opt(name):
        return AdamState(
            mu=_flat_from_arrays(arrays, f"{name}_opt/mu",
                                 _NETS[name]).to(dev),
            nu=_flat_from_arrays(arrays, f"{name}_opt/nu",
                                 _NETS[name]).to(dev),
            count=scalar(f"{name}_opt/count", torch.int32))

    return TD3State(
        actor_params=net("actor", "params"),
        actor_target=net("actor", "target"),
        critic_params=net("critic", "params"),
        critic_target=net("critic", "target"),
        actor_opt=opt("actor"), critic_opt=opt("critic"),
        update_count=scalar("update_count", torch.int32),
        explore_sigma=scalar("explore_sigma", torch.float32),
        explore_eps=scalar("explore_eps", torch.float32))


def td3_state_to_arrays(agent, state) -> dict:
    """Inverse of :func:`td3_state_from_arrays` (numpy arrays)."""
    out = {}
    lays = {"actor": agent.actor_layout, "critic": agent.critic_layout}
    for name, heads in _NETS.items():
        for field in ("params", "target"):
            _arrays_from_flat(getattr(state, f"{name}_{field}"), lays[name],
                              f"{name}_{field}", heads, out)
        opt = getattr(state, f"{name}_opt")
        for moment in ("mu", "nu"):
            _arrays_from_flat(getattr(opt, moment), lays[name],
                              f"{name}_opt/{moment}", heads, out)
        out[f"{name}_opt/count"] = np.asarray(int(opt.count), np.int32)
    out["update_count"] = np.asarray(int(state.update_count), np.int32)
    for key in ("explore_sigma", "explore_eps"):
        out[key] = np.asarray(float(getattr(state, key)), np.float32)
    return out
