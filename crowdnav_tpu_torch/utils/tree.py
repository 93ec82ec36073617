"""Leaf-wise maps over dataclasses of tensors (the port's pytrees)."""
from __future__ import annotations

import dataclasses

import torch


def tree_map(fn, *objs):
    """``fn`` applied leaf-wise over equal dataclasses (nested, with
    tensor leaves); a leaf that is None stays None."""
    first = objs[0]
    if dataclasses.is_dataclass(first):
        return type(first)(**{
            f.name: tree_map(fn, *(getattr(o, f.name) for o in objs))
            for f in dataclasses.fields(first)})
    if first is None:
        return None
    return fn(*objs)


def tree_leaves(obj, prefix: str = ""):
    """``[(dotted name, leaf)]`` of a nested dataclass, in field order."""
    if dataclasses.is_dataclass(obj):
        out = []
        for f in dataclasses.fields(obj):
            out += tree_leaves(getattr(obj, f.name), f"{prefix}{f.name}.")
        return out
    return [] if obj is None else [(prefix[:-1], obj)]


def map_tensors(fn, obj):
    """A copy of ``obj`` with ``fn`` applied to every tensor: tensors,
    dicts, tuples (named too) and lists of them, and dataclasses of
    tensors; anything else (None, flags, generators) as it is."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: map_tensors(fn, v) for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        items = [map_tensors(fn, v) for v in obj]
        return type(obj)(*items) if hasattr(obj, "_fields") \
            else type(obj)(items)
    if dataclasses.is_dataclass(obj):
        return type(obj)(**{f.name: map_tensors(fn, getattr(obj, f.name))
                            for f in dataclasses.fields(obj)})
    return obj


def named_tensors(obj, prefix: str = "") -> list:
    """``[(dotted name, tensor)]`` of every tensor of ``obj``, walked as
    :func:`map_tensors` walks it (dict keys, tuple and list positions,
    dataclass fields, in order)."""
    if isinstance(obj, torch.Tensor):
        return [(prefix[:-1], obj)]
    if isinstance(obj, dict):
        items = obj.items()
    elif isinstance(obj, (tuple, list)):
        items = enumerate(obj)
    elif dataclasses.is_dataclass(obj):
        items = ((f.name, getattr(obj, f.name))
                 for f in dataclasses.fields(obj))
    else:
        return []
    out = []
    for k, v in items:
        out += named_tensors(v, f"{prefix}{k}.")
    return out


def to_device(obj, device):
    """A copy of ``obj`` (as :func:`map_tensors` walks it) with every
    tensor on ``device``."""
    return map_tensors(lambda t: t.detach().to(device), obj)
