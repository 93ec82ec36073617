"""Rules of the PyTorch port: it imports nothing of JAX or of the JAX
package, its entry points refuse ``device="cuda"`` without a card, its
kernel wrappers send every tensor that is not on the CPU to the kernel
(never to the plain version), and its kernels build without fast math."""
import ast
import os
import subprocess
import sys
import textwrap

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "crowdnav_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "crowdnav_tpu",
             "pytest", "tests")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(PKG):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_roots(path):
    with open(path) as fp:
        tree = ast.parse(fp.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_files_import_no_jax_and_nothing_of_the_jax_package():
    files = _port_files()
    assert len(files) > 15
    bad = [(os.path.relpath(f, ROOT), m) for f in files
           for m in _imported_roots(f) if m in FORBIDDEN]
    assert not bad, bad


def test_port_imports_with_jax_blocked():
    code = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        BLOCKED = {FORBIDDEN!r}

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError("blocked: " + name)
                return None

        sys.meta_path.insert(0, Block())
        import crowdnav_tpu_torch
        for m in pkgutil.walk_packages(crowdnav_tpu_torch.__path__,
                                       "crowdnav_tpu_torch."):
            importlib.import_module(m.name)
        import chip_smoke
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal of device='cuda' without a card")


def test_entry_points_refuse_cuda_without_a_card():
    _no_cuda()
    from crowdnav_tpu_torch.agents.td3 import TD3, TD3Config
    from crowdnav_tpu_torch.drivers import evaluate
    from crowdnav_tpu_torch.envs.config import make_config
    from crowdnav_tpu_torch.envs.crowd_env import CrowdEnv
    from crowdnav_tpu_torch.envs.world import init_state
    cfg = make_config("crowd_dense", "crowd")
    with pytest.raises(RuntimeError):
        CrowdEnv(cfg)                       # default device is "cuda"
    with pytest.raises(RuntimeError):
        TD3(TD3Config(), cfg.state_dim_risk)
    with pytest.raises(SystemExit):
        evaluate.main(["--n-envs", "2", "--max-steps", "2"])
    with pytest.raises(RuntimeError):
        init_state(cfg, 2)


def test_tabular_learners_refuse_cuda_without_a_card(tmp_path):
    """``QLearning``, ``Sarsa`` and ``load_table`` default to the card, as
    every other learner, and refuse it without one."""
    _no_cuda()
    from crowdnav_tpu_torch.agents import tabular
    for cls in (tabular.QLearning, tabular.Sarsa):
        with pytest.raises(RuntimeError):
            cls(tabular.TabularConfig())
    algo = tabular.QLearning(tabular.TabularConfig(), device="cpu")
    tabular.save_table(str(tmp_path / "q"), algo.init())
    with pytest.raises(RuntimeError):
        tabular.load_table(str(tmp_path / "q"))


def test_wrappers_send_non_cpu_tensors_to_the_kernel():
    """A tensor that is not on the CPU never reaches the plain version:
    the wrapper hands it to the kernel's binding, which refuses anything
    but a CUDA tensor, and the launch count does not move."""
    from crowdnav_tpu_torch.envs.config import make_config
    from crowdnav_tpu_torch.envs.world import init_state
    from crowdnav_tpu_torch.ops import lidar, risk
    from crowdnav_tpu_torch.ops.risk_kernel import track_cp_topk_batch
    meta = torch.device("meta")
    n, p = 4, 14
    with pytest.raises(ValueError, match="CUDA"):
        lidar.scan_batch(torch.zeros(n, 2, device=meta),
                         torch.zeros(n, device=meta),
                         torch.zeros(n, p, 2, device=meta), 0.05, 1.45, 0.6,
                         0.08)
    assert lidar.scan_batch.launches == 0
    cfg = make_config("crowd_dense", "crowd")
    st = init_state(cfg, n, "cpu")
    segs = risk.Segments(
        *(torch.zeros(n, cfg.max_segments, *s, dtype=d, device=meta)
          for s, d in (((), torch.bool), ((), torch.bool), ((), torch.bool),
                       ((2,), torch.float32), ((), torch.float32),
                       ((), torch.int32))))
    tracks = st.tracks.map(lambda a: a.to(meta))
    with pytest.raises(ValueError, match="CUDA"):
        track_cp_topk_batch(cfg, segs, tracks, st.pos.to(meta),
                            st.prev_pos.to(meta),
                            torch.ones(n, dtype=torch.bool, device=meta))
    assert track_cp_topk_batch.launches == 0


def test_build_uses_one_exact_nvcc_call():
    from crowdnav_tpu_torch.kernels import build
    flags = " ".join(build.NVCC_FLAGS)
    assert "-fmad=false" in flags and "sm_90a" in flags
    with open(build.__file__) as fp:
        text = fp.read()
    for src in build.sources():
        with open(src) as fp:
            text += fp.read()
    assert "use_fast_math" not in text
    assert "cpp_extension" not in text and "torch/extension.h" not in text
    assert {s.name for s in build.sources()} == {
        "libm_trig.cu", "raycast.cu", "track_cp_topk.cu"}


def test_trig_wrappers_send_non_cpu_tensors_to_the_kernel():
    """``nm.cos``/``nm.sin``/``nm.atan2`` hand a tensor that is not on the
    CPU to the C-library trig kernel's binding, never to the plain path."""
    from crowdnav_tpu_torch.utils import numerics as nm
    x = torch.zeros(8, device="meta")
    for fn, args in ((nm.cos, (x,)), (nm.sin, (x,)), (nm.atan2, (x, x))):
        with pytest.raises(ValueError, match="CUDA"):
            fn(*args)
    assert nm.sincos.launches == 0 and nm.atan2.launches == 0


@pytest.mark.parametrize("form", ["pallas", "strict"])
def test_new_kernel_forms_send_non_cpu_tensors_to_the_kernel(form):
    """The Pallas form of the raycast and the Pallas and strict forms of
    the tracker kernel: a tensor that is not on the CPU goes to the
    kernel's binding (which refuses all but CUDA tensors), never to the
    plain version, and no count moves."""
    import dataclasses
    from crowdnav_tpu_torch.envs.config import make_config
    from crowdnav_tpu_torch.envs.world import init_state
    from crowdnav_tpu_torch.ops import lidar, risk
    from crowdnav_tpu_torch.ops.risk_kernel import track_cp_topk_batch
    meta = torch.device("meta")
    n, p = 4, 14
    with pytest.raises(ValueError, match="CUDA"):
        lidar.scan_batch_pallas(torch.zeros(n, 2, device=meta),
                                torch.zeros(n, device=meta),
                                torch.zeros(n, p, 2, device=meta), 0.05,
                                1.45, 0.6, 0.08)
    assert lidar.scan_batch_pallas.launches == 0
    cfg = make_config("crowd_dense", "crowd")
    cfg = dataclasses.replace(cfg, **({"risk_backend": "pallas"}
                                      if form == "pallas"
                                      else {"strict_quirks": True}))
    st = init_state(cfg, n, "cpu")
    segs = risk.Segments(
        *(torch.zeros(n, cfg.max_segments, *s, dtype=d, device=meta)
          for s, d in (((), torch.bool), ((), torch.bool), ((), torch.bool),
                       ((2,), torch.float32), ((), torch.float32),
                       ((), torch.int32))))
    tracks = st.tracks.map(lambda a: a.to(meta))
    with pytest.raises(ValueError, match="CUDA"):
        track_cp_topk_batch(cfg, segs, tracks, st.pos.to(meta),
                            st.prev_pos.to(meta),
                            torch.ones(n, dtype=torch.bool, device=meta))
    assert track_cp_topk_batch.launches == 0
    assert track_cp_topk_batch.form_launches[form] == 0


def test_slice_six_entry_points_refuse_cuda_without_a_card(tmp_path):
    """The multi-process launch, the deployment loop and the baselines
    refuse ``device="cuda"`` without a card, as the other entry points:
    nothing falls back to the CPU."""
    _no_cuda()
    from crowdnav_tpu_torch import baselines
    from crowdnav_tpu_torch.drivers import deploy_realworld, train
    from crowdnav_tpu_torch.parallel import distributed
    with pytest.raises(SystemExit):
        deploy_realworld.main(["--ticks", "1"])
    with pytest.raises(RuntimeError):
        deploy_realworld.run_deployment(n_ticks=1)
    with pytest.raises(RuntimeError):
        distributed.init_multihost("localhost:1", 1, 0)
    argv = ["--algo", "td3", "--n-envs", "8", "--outdir", str(tmp_path)]
    with pytest.raises(SystemExit):
        train.main(argv + ["--multihost", "--coordinator", "localhost:1",
                           "--num-processes", "1", "--process-id", "0"])
    with pytest.raises(SystemExit):
        train.main(argv + ["--n-devices", "2"])
    with pytest.raises((RuntimeError, AssertionError)):
        baselines.fsm_init((2,))
    assert not os.listdir(tmp_path)


def test_native_build_uses_no_fast_math():
    """The host simulator builds with the JAX package's flags and no
    fast-math option, so that it computes what that package's library
    computes, bit for bit."""
    from crowdnav_tpu_torch import native
    assert native.GXX_FLAGS == ["-O3", "-fopenmp", "-shared", "-fPIC"]
    for flag in native.GXX_FLAGS:
        for opt in ("fast-math", "Ofast", "unsafe-math", "march",
                    "fp-contract"):
            assert opt not in flag, flag
    with open(native.SRC) as fp:
        text = fp.read()
    assert "#pragma GCC optimize" not in text
    assert "optimize(" not in text and "fast-math" not in text


def _jax_init_names(sub):
    path = os.path.join(ROOT, "crowdnav_tpu", sub, "__init__.py")
    with open(path) as fp:
        tree = ast.parse(fp.read(), path)
    return [a.name for node in tree.body if isinstance(node, ast.ImportFrom)
            for a in node.names]


@pytest.mark.parametrize("sub", ["agents", "envs", "models", "parallel",
                                 "utils"])
def test_subpackages_export_the_jax_package_names(sub):
    """Each subpackage gives the names its JAX counterpart's ``__init__``
    exports, each the port's own object of that name."""
    import importlib
    names = _jax_init_names(sub)
    assert names
    pkg = importlib.import_module(f"crowdnav_tpu_torch.{sub}")
    for name in names:
        module = getattr(getattr(pkg, name), "__module__", None)
        assert module is None or module.startswith(
            f"crowdnav_tpu_torch.{sub}."), (name, module)


def test_every_module_imports_first():
    """Every module of the port imports in an interpreter where no other
    module of the port is loaded yet (no import runs in a circle), and the
    subpackages' names load no kernel module."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import crowdnav_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            crowdnav_tpu_torch.__path__, "crowdnav_tpu_torch.")]

        def fresh():
            for k in [k for k in sys.modules
                      if k.startswith("crowdnav_tpu_torch.")]:
                del sys.modules[k]

        for name in names:
            fresh()
            importlib.import_module(name)
        fresh()
        for sub in ("agents", "envs", "models", "parallel", "utils",
                    "native", "parity"):
            importlib.import_module("crowdnav_tpu_torch." + sub)
        kernels = [k for k in sys.modules if ".kernels" in k]
        print(len(names), kernels)
    """)
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    count, kernels = res.stdout.split(" ", 1)
    assert int(count) > 40 and kernels.strip() == "[]", res.stdout
