"""Export a TD3 learner state from an Orbax agent checkpoint to the
PyTorch port's full-state file.

    python scripts/export_torch_agent.py \
        --checkpoint results/r5/final_full/agent_ckpt_td3 \
        --out /tmp/final_full_agent.npz

The file holds every array of the JAX ``TD3State`` (actor and critic
parameters, their targets, both optimizers' Adam ``mu``/``nu``/``count``,
``update_count``, ``explore_sigma``, ``explore_eps``) under the slash-
separated keys that ``crowdnav_tpu_torch/utils/convert.py`` reads, with
flax's (in, out) kernel layout, and the checkpoint's ``run_config.json``
as the JSON string ``run_config``. The port reads it with
``crowdnav_tpu_torch.utils.checkpoint.load_agent``. This script reads the
checkpoint with the JAX package, run where JAX is installed; it imports no
module of the port. The file (about 8 MB) is made when needed, not kept in
the repository.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np


def _walk(tree, prefix: str, out: dict):
    for name in sorted(tree):
        v = tree[name]
        if isinstance(v, dict):
            _walk(v, f"{prefix}/{name}", out)
        else:
            out[f"{prefix}/{name}"] = np.asarray(v)


def state_arrays(state) -> dict:
    """A JAX ``TD3State`` -> ``{key: numpy array}`` (the port's keys)."""
    out = {}
    for field in ("actor_params", "actor_target", "critic_params",
                  "critic_target"):
        _walk(getattr(state, field)["params"], field, out)
    for field in ("actor_opt", "critic_opt"):
        adam = getattr(state, field)[0]          # optax ScaleByAdamState
        out[f"{field}/count"] = np.asarray(adam.count)
        _walk(adam.mu["params"], f"{field}/mu", out)
        _walk(adam.nu["params"], f"{field}/nu", out)
    for field in ("update_count", "explore_sigma", "explore_eps"):
        out[field] = np.asarray(getattr(state, field))
    return out


def export(checkpoint: str, out: str) -> dict:
    import jax

    from crowdnav_tpu.drivers.train import build_agent_from_metadata
    from crowdnav_tpu.utils.checkpoint import (load_run_metadata,
                                               restore_agent_state)

    meta = load_run_metadata(checkpoint)
    if meta is None or meta.get("algo") != "td3":
        raise SystemExit(f"{checkpoint}: needs a td3 run_config.json")
    agent, _ = build_agent_from_metadata("td3", meta["agent_config"],
                                         meta["obs_dim"], 1)
    template = jax.jit(agent.init)(jax.random.PRNGKey(0))
    arrays = state_arrays(restore_agent_state(checkpoint, template))
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    np.savez(out, run_config=np.asarray(json.dumps(meta, sort_keys=True)),
             **arrays)
    return arrays


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--checkpoint",
                   default="results/r5/final_full/agent_ckpt_td3")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    arrays = export(args.checkpoint, args.out)
    print(json.dumps({"out": args.out, "arrays": len(arrays),
                      "floats": int(sum(v.size for v in arrays.values()))}))


if __name__ == "__main__":
    main()
