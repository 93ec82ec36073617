"""Export a learner state (TD3, DDPG, SAC or DQN) from an Orbax agent
checkpoint to the PyTorch port's agent file, or its greedy policy alone.

    python scripts/export_torch_agent.py \
        --checkpoint results/r5/final_full/agent_ckpt_td3 \
        --out /tmp/final_full_agent.npz
    python scripts/export_torch_agent.py --algo ddpg --policy \
        --checkpoint results/r3/ddpg_spectrum/agent_peak_ddpg \
        --step 1572864 \
        --out crowdnav_tpu_torch/assets/ddpg_peak/agent_1572864.npz

The agent file holds every array of the JAX agent state (networks, their
targets, the optimizers' moments and counts, and the agent's scalars and
carries) under the slash-separated keys that
``crowdnav_tpu_torch/utils/convert.py`` reads, with flax's (in, out)
kernel layout, and the checkpoint's ``run_config.json`` as the JSON string
``run_config``. With ``--policy`` it holds only the greedy policy (the
actor, SAC's Gaussian actor, or DQN's Q-network) under ``Dense_i/kernel``
and ``Dense_i/bias``, compressed, as ``scripts/export_torch_actor.py``
writes TD3's. A checkpoint written before ``run_config.json`` existed is
read against the algorithm's default config (``--algo`` names it, and the
world's observation width follows: 398 for TD3 and DDPG, 363 for SAC and
DQN), as the JAX evaluate driver restores it; its file then carries the
metadata ``{"algo", "checkpoint", "step"}``. The port reads the agent file
with ``crowdnav_tpu_torch.utils.checkpoint.load_agent`` and a policy file
with ``drivers/evaluate --checkpoint``. This script reads the checkpoint
with the JAX package, run where JAX is installed; it imports no module of
the port.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

# the greedy policy's field of each algorithm's state
POLICY_FIELD = {"td3": "actor_params", "ddpg": "actor_params",
                "sac": "actor_params", "dqn": "params"}


def _walk(tree, prefix: str, out: dict):
    for name in sorted(tree):
        v = tree[name]
        if isinstance(v, dict):
            _walk(v, f"{prefix}/{name}", out)
        else:
            out[f"{prefix}/{name}"] = np.asarray(v)


def state_arrays(state) -> dict:
    """A JAX agent state -> ``{key: numpy array}`` (the port's keys):
    network fields by their flax tree, an optax state by its first
    element's moments (Adam's ``mu``/``nu``/``count``, RMSprop's ``nu``),
    every other field as an array."""
    import dataclasses
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if isinstance(v, dict):
            _walk(v["params"], f.name, out)
        elif isinstance(v, tuple):               # an optax chain state
            inner = v[0]
            if hasattr(inner, "mu"):
                out[f"{f.name}/count"] = np.asarray(inner.count)
                _walk(inner.mu["params"], f"{f.name}/mu", out)
            _walk(inner.nu["params"], f"{f.name}/nu", out)
        else:
            out[f.name] = np.asarray(v)
    return out


def restore(checkpoint: str, algo: str | None = None,
            step: int | None = None):
    """``(JAX agent state, metadata)`` of an agent checkpoint directory."""
    import jax

    from crowdnav_tpu.drivers.train import (_build_agent,
                                            build_agent_from_metadata)
    from crowdnav_tpu.envs import make_config
    from crowdnav_tpu.utils.checkpoint import (load_run_metadata,
                                               restore_agent_state)

    if step is None:
        step = max(int(d) for d in os.listdir(checkpoint) if d.isdigit())
    meta = load_run_metadata(checkpoint)
    if meta is not None:
        if algo not in (None, meta["algo"]):
            raise SystemExit(f"{checkpoint}: trained as {meta['algo']!r}")
        algo = meta["algo"]
        agent, _ = build_agent_from_metadata(algo, meta["agent_config"],
                                             meta["obs_dim"], 1)
    else:
        if algo is None:
            raise SystemExit(f"{checkpoint}: no run_config.json; pass "
                             f"--algo")
        cfg = make_config("crowd_dense" if algo in ("td3", "ddpg")
                          else "crowd_sparse")
        obs_dim = cfg.state_dim_risk if algo in ("td3", "ddpg") \
            else cfg.state_dim_simple
        agent, _ = _build_agent(algo, obs_dim, 1)
        meta = {"algo": algo, "checkpoint": checkpoint, "step": step}
    template = jax.jit(agent.init)(jax.random.PRNGKey(0))
    return restore_agent_state(checkpoint, template, step=step), meta


def export(checkpoint: str, out: str, algo: str | None = None,
           step: int | None = None, policy: bool = False) -> dict:
    import jax

    state, meta = restore(checkpoint, algo, step)
    arrays = state_arrays(jax.tree.map(np.asarray, state))
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    config = np.asarray(json.dumps(meta, sort_keys=True))
    if policy:
        prefix = POLICY_FIELD[meta["algo"]] + "/"
        arrays = {k[len(prefix):]: v.astype(np.float32)
                  for k, v in arrays.items() if k.startswith(prefix)}
        np.savez_compressed(out, run_config=config, **arrays)
    else:
        np.savez(out, run_config=config, **arrays)
    return arrays


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--checkpoint",
                   default="results/r5/final_full/agent_ckpt_td3")
    p.add_argument("--algo", default=None,
                   choices=["td3", "ddpg", "sac", "dqn"],
                   help="needed for a checkpoint without run_config.json")
    p.add_argument("--step", type=int, default=None,
                   help="the checkpoint's step; default the newest")
    p.add_argument("--policy", action="store_true",
                   help="export the greedy policy's arrays only")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    arrays = export(args.checkpoint, args.out, args.algo, args.step,
                    args.policy)
    print(json.dumps({"out": args.out, "arrays": len(arrays),
                      "floats": int(sum(v.size for v in arrays.values())),
                      "bytes": os.path.getsize(args.out)}))


if __name__ == "__main__":
    main()
