"""YAML config loading mirroring the reference's parameter files (a copy
of ``crowdnav_tpu/utils/yaml_config.py``; it is pure Python).

The reference loads `configs/<algo>.yaml` + `configs/turtlebot3_world.yaml`
onto the ROS parameter server (`launch/start_td3_training.launch:7-8`) and
reads them under the ``/turtlebot3`` namespace
(`start_td3_training.py:56-61`). This loader accepts the same YAML shape
and maps the keys onto `EnvConfig` / agent-config overrides, so existing
reference config files drop in unchanged.
"""
from __future__ import annotations

from typing import Any

try:
    import yaml
    _HAVE_YAML = True
except ImportError:                      # pragma: no cover
    _HAVE_YAML = False

# reference key -> (target, our key)
_WORLD_KEYS = {
    "scan_ranges": ("env", "n_beams"),
    "max_scan_range": ("env", "max_scan_range"),
    "min_scan_range": ("env", "min_scan_range"),
}
_ALGO_KEYS = {
    "actor_alpha": ("agent", "actor_lr"),
    "critic_alpha": ("agent", "critic_lr"),
    "critic_v_alpha": ("agent", "value_lr"),
    "critic_soft_q_alpha": ("agent", "soft_q_lr"),
    "alpha": ("agent", "lr"),
    "gamma": ("agent", "gamma"),
    "tau": ("agent", "tau"),
    "epsilon": ("agent", "epsilon_start"),
    "epsilon_discount": ("agent", "epsilon_decay"),
    "nepisodes": ("run", "n_episodes"),
    "nsteps": ("env", "max_steps"),
    "stage_name": ("run", "stage_name"),
}


def load_yaml_config(path: str) -> dict[str, dict[str, Any]]:
    """Parse a reference-format YAML into {'env': {...}, 'agent': {...},
    'run': {...}} override dicts."""
    if not _HAVE_YAML:
        raise ImportError("pyyaml is unavailable in this environment")
    with open(path) as fp:
        raw = yaml.safe_load(fp) or {}
    ns = raw.get("turtlebot3", raw)
    out: dict[str, dict[str, Any]] = {"env": {}, "agent": {}, "run": {}}
    for key, value in ns.items():
        if key in _WORLD_KEYS:
            tgt, name = _WORLD_KEYS[key]
            out[tgt][name] = value
        elif key in _ALGO_KEYS:
            tgt, name = _ALGO_KEYS[key]
            out[tgt][name] = value
        elif key == "desired_pose":
            out["env"]["goal"] = (float(value["x"]), float(value["y"]))
        elif key == "starting_pose":
            x, y = float(value["x"]), float(value["y"])
            out["env"]["start_pose"] = (x, y, 3.14159265)
    return out
