"""Export a trained TD3 actor from an Orbax agent checkpoint to the
PyTorch port's actor file.

    python scripts/export_torch_actor.py \
        --checkpoint results/r5/final_full/agent_ckpt_td3 \
        --out crowdnav_tpu_torch/assets/final_full_actor.npz

The file holds the flax actor arrays under ``Dense_i/kernel`` and
``Dense_i/bias`` (float32, flax's (in, out) kernel layout) and the
checkpoint's ``run_config.json`` as the JSON string ``run_config``. Only the
actor is exported: no critics, optimizer state or replay. This script reads
the checkpoint with the JAX package; the port itself reads only the file it
writes.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np


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
    state = restore_agent_state(checkpoint, template)
    params = state.actor_params["params"]
    arrays = {}
    for layer in sorted(params):
        for name in ("kernel", "bias"):
            arrays[f"{layer}/{name}"] = np.asarray(params[layer][name],
                                                   np.float32)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    np.savez_compressed(out, run_config=np.asarray(json.dumps(
        meta, sort_keys=True)), **arrays)
    return arrays


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--checkpoint",
                   default="results/r5/final_full/agent_ckpt_td3")
    p.add_argument("--out",
                   default="crowdnav_tpu_torch/assets/final_full_actor.npz")
    args = p.parse_args(argv)
    arrays = export(args.checkpoint, args.out)
    print(json.dumps({"out": args.out, "arrays": {
        k: list(v.shape) for k, v in arrays.items()},
        "floats": int(sum(v.size for v in arrays.values()))}))


if __name__ == "__main__":
    main()
