"""Flax actor parameters (numpy) <-> the port's actor ``state_dict``.

Flax ``Dense`` kernels are (in, out); torch ``Linear`` weights are
(out, in)."""
from __future__ import annotations

import numpy as np
import torch

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
