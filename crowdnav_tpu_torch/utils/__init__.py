"""Host-side utilities: episode CSV logs, checkpointing, YAML config,
profiling/tracing.

The names below are imported at first use (PEP 562): every module of the
port imports ``utils.numerics``, and ``utils.checkpoint`` imports the
agents, so an eager import here would run in a circle."""
import importlib

_NAMES = {
    "EpisodeLogger": "logging",
    "load_run_metadata": "checkpoint",
    "restore_checkpoint": "checkpoint",
    "save_checkpoint": "checkpoint",
    "save_run_metadata": "checkpoint",
    "load_yaml_config": "yaml_config",
    "StepThroughput": "profiling",
    "annotate": "profiling",
    "trace": "profiling",
    "trace_if": "profiling",
}


def __getattr__(name):
    if name not in _NAMES:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_NAMES[name]}"),
                   name)


def __dir__():
    return sorted(list(globals()) + list(_NAMES))
