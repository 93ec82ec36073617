"""``scripts/bench_torch_train.py`` builds the cell of the JAX package's
``bench.py``: its options have ``bench.py``'s names and defaults, and the
env config, the ``TD3Config`` and the ``TrainerConfig`` it builds through
the port's ``drivers/train`` equal, field by field, those ``bench.py``'s
``bench_config`` builds, for both lidar backends (``--with-pallas-lidar``)
and both variants (learning, and ``--no-learn``'s rollout). Each side's
``Trainer`` is replaced by a stub that records what it is given, so that
nothing is compiled, allocated or run."""
import dataclasses
import enum
import importlib.util
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(1)


def _module(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Built(Exception):
    pass


def _stub(env, agent, tcfg, **_):
    raise _Built(env, agent, tcfg)


def _fields(obj):
    """A config dataclass as a dict of plain values (enums by value)."""
    return {k: v.value if isinstance(v, enum.Enum) else v
            for k, v in dataclasses.asdict(obj).items()}


@pytest.fixture(scope="module")
def scripts():
    return (_module("bench", os.path.join(ROOT, "bench.py")),
            _module("bench_torch_train",
                    os.path.join(ROOT, "scripts", "bench_torch_train.py")))


def _bench_args(bench, monkeypatch):
    """``bench.py``'s parsed default options and the configurations its
    ``main`` asks ``bench_config`` for."""
    calls = []
    monkeypatch.setattr(bench, "bench_config", lambda args, lidar, learning:
                        calls.append((args, lidar, learning))
                        or {"metric": ""})
    monkeypatch.setattr(sys, "argv", ["bench.py", "--with-pallas-lidar"])
    bench.main()
    return calls


def test_options_are_bench_py_options(scripts, monkeypatch):
    bench, port = scripts
    calls = _bench_args(bench, monkeypatch)
    assert [(lidar, learning) for _, lidar, learning in calls] == [
        ("pallas", True), ("xla", True)]
    ref = vars(calls[0][0])
    got = vars(port.parser().parse_args(["--with-pallas-lidar"]))
    shared = set(ref) - {"no_learn"}
    assert shared <= set(got)
    assert {k: got[k] for k in shared} == {k: ref[k] for k in shared}
    assert got["risk_backend"] == "pallas"


@pytest.mark.parametrize("lidar_backend", ["xla", "pallas"])
@pytest.mark.parametrize("learning", [True, False])
def test_cell_is_bench_py_cell(scripts, monkeypatch, lidar_backend,
                               learning):
    bench, port = scripts
    import crowdnav_tpu.parallel as jparallel
    from crowdnav_tpu_torch.drivers import train as dtrain
    bench_config = bench.bench_config
    args = _bench_args(bench, monkeypatch)[0][0]
    monkeypatch.setattr(jparallel, "Trainer", _stub)
    with pytest.raises(_Built) as ref:
        bench_config(args, lidar_backend, learning)
    monkeypatch.setattr(dtrain, "Trainer", _stub)
    with pytest.raises(_Built) as got:
        port.build(port.parser().parse_args([]), learning, lidar_backend,
                   device="cpu")
    (jenv, jagent, jtcfg), (tenv, tagent, ttcfg) = \
        ref.value.args, got.value.args
    assert _fields(tenv.cfg) == _fields(jenv.cfg)
    assert tenv.cfg.risk_backend == "pallas"
    assert tenv.cfg.lidar_backend == lidar_backend
    assert tenv.obs_dim == jenv.obs_dim == 398
    assert _fields(tagent.cfg) == _fields(jagent.cfg)
    assert not tagent.cfg.explore_eps_spectrum
    assert _fields(ttcfg) == _fields(jtcfg)
    assert ttcfg.learning is learning
