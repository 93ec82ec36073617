"""The port's native host simulator (``crowdnav_tpu_torch/native``).

The cases of ``tests/test_native.py`` on the port's ``FastSim`` and
``FastSimBatch`` against the port's world (``envs/world.integrate_robot``)
and raycast (``ops/lidar.scan_batch``, which runs its plain version on CPU
tensors), with that file's tolerances: pose 1e-4, scans 2e-3. Then the
port's library against the JAX package's, bit for bit: the JAX package's
``fastsim.cpp`` is built with its own flags into a temporary directory
(never next to its source, where ``tests/test_native.py`` may build at the
same time) and driven through the JAX package's bindings. Last, two
processes building into one empty directory at once."""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from crowdnav_tpu_torch import native
from crowdnav_tpu_torch.envs.config import make_config
from crowdnav_tpu_torch.envs.world import init_state, integrate_robot, wrap_pi
from crowdnav_tpu_torch.native import FastSim, FastSimBatch
from crowdnav_tpu_torch.ops import lidar

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("x", "y", "yaw", "prev_x", "prev_y", "step_count", "done", "peds",
          "ped_vel")


@pytest.fixture(scope="module")
def sim():
    return FastSim(make_config("crowd_dense", "static", max_steps=100))


def test_native_builds_and_scans(sim):
    scan = sim.scan()
    assert scan.shape == (359,) and scan.dtype == torch.float32
    assert 0.08 <= scan.min() and scan.max() <= 0.6 + 1e-6


def test_native_kinematics_matches_the_port(sim):
    cfg = sim.cfg
    sim.reset()
    rng = np.random.default_rng(0)
    pos = torch.tensor([cfg.start_pose[:2]], dtype=torch.float32)
    yaw = torch.tensor([cfg.start_pose[2]], dtype=torch.float32)
    lim = cfg.room_half_inner - cfg.robot_radius
    for _ in range(25):
        v = float(rng.uniform(0, 0.22))
        w = float(rng.uniform(-2, 2))
        sim.step(v, w)
        pos, yaw = integrate_robot(pos, yaw, torch.tensor([v]),
                                   torch.tensor([w]), cfg.dt,
                                   cfg.wheel_separation, cfg.wheel_radius)
        pos = torch.clamp(pos, -lim, lim)
        yaw = wrap_pi(yaw)
    np.testing.assert_allclose(sim.pose[:2].numpy(), pos[0].numpy(),
                               atol=1e-4)
    dyaw = abs(float(sim.pose[2]) - float(yaw[0]))
    assert min(dyaw, 2 * np.pi - dyaw) < 1e-4


def test_native_scan_matches_the_port(sim):
    cfg = sim.cfg
    sim.reset()
    sim.step(0.2, 0.5)
    native_scan = sim.scan()
    st = init_state(cfg, 1, "cpu")
    scan = lidar.scan_batch(sim.pose[None, :2], sim.pose[None, 2],
                            st.ped_pos, cfg.ped_radius, cfg.room_half_inner,
                            cfg.max_scan_range, cfg.lidar_min_range,
                            cfg.n_scans)
    np.testing.assert_allclose(native_scan.numpy(), scan[0].numpy(),
                               atol=2e-3)


def test_native_rollout_terminates(sim):
    sim.reset()
    acts = np.tile(np.array([[0.22, 0.0]], np.float32), (300, 1))
    traj = sim.rollout(acts)
    # driving straight from yaw=pi must hit the -x wall and stop (collision)
    assert sim.done in (2, 3)
    assert traj.shape[1] == 3 and len(traj) <= 300


def test_batch_matches_single_env():
    """FastSimBatch with zero jitter + static crowd reproduces the
    single-env FastSim trajectory for every env in the batch."""
    cfg = make_config("crowd_none", "static", n_peds=3,
                      ped_init=((0.3, -0.75), (0.0, -0.3), (-0.5, 0.2)),
                      max_steps=60)
    single = FastSim(cfg)
    batch = FastSimBatch(cfg, n_envs=4)
    rng = np.random.default_rng(0)
    for _ in range(30):
        lin = float(rng.uniform(0, 0.22))
        ang = float(rng.uniform(-2, 2))
        scan_s, done_s = single.step(lin, ang,
                                     np.zeros((cfg.n_peds, 2), np.float32))
        scans_b = batch.step(np.tile([[lin, ang]], (4, 1)))
        np.testing.assert_allclose(batch.x.numpy(), float(single.pose[0]),
                                   atol=1e-6)
        np.testing.assert_allclose(batch.yaw.numpy(), float(single.pose[2]),
                                   atol=1e-6)
        np.testing.assert_allclose(scans_b[0].numpy(), scan_s.numpy(),
                                   atol=1e-6)
        np.testing.assert_allclose(scans_b[1].numpy(), scans_b[0].numpy(),
                                   atol=0)
        assert (batch.done == done_s).all()
        if done_s:
            break


def test_batch_jittered_resets_and_autoreset():
    cfg = make_config("crowd_dense", "crowd", jitter=1.0, max_steps=5)
    batch = FastSimBatch(cfg, n_envs=16, seed=3)
    # jittered spawns distinct
    assert len(np.unique(batch.x.numpy())) > 8
    x0 = batch.x.clone()
    acts = torch.tensor([[0.22, 0.0]]).repeat(16, 1)
    for _ in range(6):
        batch.step(acts)
    assert (batch.done > 0).any() or (batch.step_count <= 5).all()
    # run past max_steps: every env auto-reset at least once and landed on
    # NEW jittered spawns (not the original ones)
    for _ in range(6):
        batch.step(acts)
    assert not np.allclose(np.sort(batch.x.numpy()), np.sort(x0.numpy()))


def test_batch_crowd_moves_and_robot_collides():
    cfg = make_config("crowd_dense", "crossing", max_steps=400)
    batch = FastSimBatch(cfg, n_envs=2)
    p0 = batch.peds.clone()
    acts = np.tile([[0.22, 0.0]], (2, 1))
    for _ in range(10):
        batch.step(acts)
    assert not torch.allclose(batch.peds, p0)   # crowd moved (table)


def test_batch_state_is_the_c_side_memory():
    """State fields are CPU tensors the C side writes in place: a state
    set through them is what the next step starts from; actions may be a
    tensor or an array; a tensor on another device is refused."""
    cfg = make_config("crowd_dense", "static", max_steps=50)
    a, b = FastSimBatch(cfg, 3), FastSimBatch(cfg, 3)
    for t in (a, b):
        t.x.copy_(torch.tensor([0.1, -0.2, 0.3]))
        t.yaw.fill_(0.5)
    acts = np.array([[0.2, 0.1], [0.1, -1.0], [0.0, 2.0]], np.float32)
    a.step(acts)
    b.step(torch.from_numpy(acts))
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert not np.allclose(a.prev_x.numpy(), cfg.start_pose[0])
    np.testing.assert_array_equal(a.prev_x.numpy(),
                                  np.float32([0.1, -0.2, 0.3]))
    with pytest.raises(ValueError, match="CPU"):
        a.step(torch.zeros((3, 2), device="meta"))
    with pytest.raises(ValueError):
        a.step(np.zeros((2, 2), np.float32))


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """The JAX package's ``native`` module bound to its ``fastsim.cpp``
    built with its own flags (``-O3 -fopenmp -shared -fPIC``) into a
    temporary directory."""
    from crowdnav_tpu import native as jn
    src = os.path.join(os.path.dirname(jn.__file__), "fastsim.cpp")
    path, _ = native.compile_library(src, tmp_path_factory.mktemp("jaxsim"))
    mp = pytest.MonkeyPatch()
    mp.setattr(jn, "_SO", str(path))
    yield jn
    mp.undo()


def _actions(rng, n):
    return np.stack([rng.uniform(0, 0.22, n), rng.uniform(-2, 2, n)],
                    1).astype(np.float32)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def test_fastsim_equals_the_jax_package_bit_for_bit(jax_native):
    from crowdnav_tpu.envs.config import make_config as jmake
    args = ("crowd_sparse", "crossing")
    cfg_t, cfg_j = make_config(*args, max_steps=80), jmake(*args,
                                                           max_steps=80)
    t, j = FastSim(cfg_t), jax_native.FastSim(cfg_j)
    rng = np.random.default_rng(11)
    vel = np.asarray(cfg_t.direction_table(), np.float32) * 0.1
    steps = 0
    for a in _actions(rng, 60):
        st, dt = t.step(float(a[0]), float(a[1]), vel)
        sj, dj = j.step(float(a[0]), float(a[1]), vel)
        assert dt == dj
        np.testing.assert_array_equal(_bits(st.numpy()), _bits(sj))
        np.testing.assert_array_equal(_bits(t.pose.numpy()), _bits(j.pose))
        np.testing.assert_array_equal(_bits(t.scan().numpy()),
                                      _bits(j.scan()))
        steps += 1
        if dt:
            break
    assert steps > 10
    t.reset()
    j.reset()
    acts = _actions(rng, 300)
    vels = np.tile(vel[None], (300, 1, 1))
    tt, tj = t.rollout(acts, vels), j.rollout(acts, vels)
    assert len(tt) == len(tj) > 1 and t.done == j.done
    np.testing.assert_array_equal(_bits(tt.numpy()), _bits(tj))


@pytest.mark.parametrize("world,behavior", [
    ("crowd_dense", "static"), ("crowd_sparse", "random"),
    ("crowd_dense", "crowd"), ("crowd_dense", "crossing")])
def test_fastsim_batch_equals_the_jax_package_bit_for_bit(jax_native,
                                                          world, behavior):
    """Same seed, same actions: every state field, the scans, the done
    codes and the xorshift words equal bit for bit at every step, through
    collisions, timeouts and jittered auto-resets."""
    from crowdnav_tpu.envs.config import make_config as jmake
    kw = dict(jitter=1.0, max_steps=12)
    n = 48
    t = FastSimBatch(make_config(world, behavior, **kw), n, seed=7)
    j = jax_native.FastSimBatch(jmake(world, behavior, **kw), n, seed=7)
    rng = np.random.default_rng(5)
    resets = 0
    for step in range(40):
        for f in FIELDS:
            np.testing.assert_array_equal(
                _bits(getattr(t, f).numpy()), _bits(getattr(j, f)),
                err_msg=f"{f} before step {step}")
        np.testing.assert_array_equal(t.rng, j.rng)
        resets += int((t.done.numpy() > 0).sum())
        acts = _actions(rng, n)
        np.testing.assert_array_equal(_bits(t.step(acts).numpy()),
                                      _bits(j.step(acts)),
                                      err_msg=f"scans at step {step}")
    assert resets > n


def test_concurrent_builds_load_one_library(tmp_path):
    """Two processes build into one empty directory at the same time:
    each loads a whole library, the same file, and no temporary is left."""
    code = textwrap.dedent("""
        import hashlib, json, sys
        from pathlib import Path
        from crowdnav_tpu_torch import native
        path, _ = native.compile_library(native.SRC, Path(sys.argv[1]))
        lib = native.bind(path)
        print(json.dumps([str(path),
                          hashlib.sha256(path.read_bytes()).hexdigest()]))
    """)
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1] for o in outs]
    got = [json.loads(o[0].strip().splitlines()[-1]) for o in outs]
    assert got[0] == got[1]
    assert os.listdir(tmp_path) == [os.path.basename(got[0][0])]
