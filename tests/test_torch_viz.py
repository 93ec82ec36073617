"""The port's host-side tools against the JAX package's:
``crowdnav_tpu_torch/viz.py`` (``trace_rollout`` with the goal seeker
bit-equal to the jitted JAX rollout, the trajectory CSV byte-equal, the
color ramp equal, the frame, path and GIF renders written),
``drivers/evaluate --trajectory`` on the CPU, ``utils/yaml_config.py``
(equal to the JAX loader on ``tests/test_io.py``'s YAML) and the
profiler trace of ``utils/profiling.py`` (a Chrome trace of the enclosed
block, gated by ``trace_if``)."""
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from crowdnav_tpu import baselines as jbase
from crowdnav_tpu import viz as jviz
from crowdnav_tpu.envs import CrowdEnv, make_config
from crowdnav_tpu.utils.yaml_config import load_yaml_config as jload
from crowdnav_tpu_torch import baselines as tbase
from crowdnav_tpu_torch import viz as tviz
from crowdnav_tpu_torch.drivers import evaluate as tevaluate
from crowdnav_tpu_torch.envs import config as tcfg
from crowdnav_tpu_torch.envs.crowd_env import CrowdEnv as TCrowdEnv
from crowdnav_tpu_torch.utils import profiling
from crowdnav_tpu_torch.utils.yaml_config import load_yaml_config as tload
from torch_parity import assert_env_state_equal

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSET = os.path.join(ROOT, "crowdnav_tpu_torch", "assets",
                     "final_full_actor.npz")
STEPS = 40


@pytest.fixture(scope="module")
def rollouts():
    """The goal seeker's rollout of one ``crowd_dense``/``crossing`` env
    (no draws: the crossing crowd and the template reset), 40 steps with
    an auto-reset at the 30-step timeout, in both packages."""
    kw = dict(max_steps=30)
    jenv = CrowdEnv(make_config("crowd_dense", "crossing", **kw))
    jout = jax.jit(lambda k: jviz.trace_rollout(
        jenv, jbase.goal_seeker, k, STEPS))(jax.random.PRNGKey(0))
    tc = tcfg.make_config("crowd_dense", "crossing", **kw)
    tout = tviz.trace_rollout(TCrowdEnv(tc, device="cpu"), tbase.goal_seeker,
                              0, STEPS)
    return tc, jout, tout


def test_trace_rollout_matches_jax(rollouts):
    _, (js, jscans, jtraj, jrew, jdone), (ts, tscans, ttraj, trew, tdone) \
        = rollouts
    assert ttraj.shape == (STEPS, 3) and tscans.shape == (STEPS, 359)
    for name, got, want in (("scans", tscans, jscans), ("traj", ttraj, jtraj),
                            ("rewards", trew, jrew), ("dones", tdone, jdone)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=name)
    assert_env_state_equal(ts, js, "states")
    assert bool(tdone.any()), "the rollout never ended an episode"
    assert float(torch.linalg.norm(ttraj[10, :2] - ttraj[0, :2])) > 0.05


def test_trajectory_csv_is_byte_equal(rollouts, tmp_path):
    _, jout, tout = rollouts
    jw = jviz.TrajectoryWriter(str(tmp_path / "j"), "traj")
    jw.record_rollout(jax.device_get(jout[2]))
    jw.record(STEPS, 0.123456, -0.5, 1.0)
    tw = tviz.TrajectoryWriter(str(tmp_path / "t"), "traj")
    tw.record_rollout(tout[2])
    tw.record(STEPS, 0.123456, -0.5, 1.0)
    with open(jw.path, "rb") as a, open(tw.path, "rb") as b:
        want, got = a.read(), b.read()
    assert got == want
    assert len(got.splitlines()) == STEPS + 1


def test_cp_color_matches_jax():
    for cp in (-1.0, 0.0, 0.25, 0.5, 0.7, 1.0, 2.0):
        assert tviz.cp_color(cp) == jviz.cp_color(cp)
    g, r = tviz.cp_color(0.0), tviz.cp_color(1.0)
    assert g[1] > g[0] and r[0] > r[1]


def test_render_frame_trajectory_and_gif(rollouts, tmp_path):
    """A frame with tracks colored by CP and social tags, the path plot,
    and a GIF of the rollout, each written as an image."""
    tc, _, (ts, tscans, ttraj, _, _) = rollouts
    last = tviz.state_at(ts, STEPS - 12)
    assert bool(last.tracks.valid.any()), "no track to draw"
    cp = np.full(tc.max_tracks, 0.7, np.float32)
    ax = tviz.render_frame(tc, last, scans=tscans[STEPS - 12], cp=cp)
    out = str(tmp_path / "frame.png")
    tviz.save_figure(ax, out)
    assert os.path.getsize(out) > 5000
    ax = tviz.render_trajectory(tc, ttraj, label="goal seeker")
    out = str(tmp_path / "traj.png")
    tviz.save_figure(ax, out)
    assert os.path.getsize(out) > 5000
    out = str(tmp_path / "roll.gif")
    tviz.save_gif(tc, tviz.state_at(ts, slice(0, 8)), tscans[:8], out,
                  every=2, fps=4)
    assert os.path.getsize(out) > 5000


def test_evaluate_trajectory_writes_the_audit(tmp_path):
    """``drivers/evaluate --trajectory --device cpu`` with the exported
    actor: the CSV of one env's greedy rollout (equal to the rollout
    ``trace_rollout`` records with the same actor), the path plot and the
    last frame."""
    out = str(tmp_path)
    res = tevaluate.main(["--device", "cpu", "--suite", "train",
                          "--checkpoint", ASSET, "--n-envs", "2",
                          "--max-steps", "12", "--outdir", out,
                          "--trajectory"])
    assert res[0]["scenario"] == "crowd_dense/crowd"
    tag = os.path.join(out, "td3_crowd_dense_crowd")
    for suffix in ("_trajectory.png", "_final_frame.png"):
        assert os.path.getsize(tag + suffix) > 5000
    with open(tag + "_trajectory.csv") as fp:
        rows = fp.read().splitlines()
    assert len(rows) == 12
    params, _ = tevaluate.load_actor_file(ASSET)
    agent = tevaluate.build_agent(None, 398, "cpu")
    from crowdnav_tpu_torch.utils.convert import flax_actor_to_state_dict
    agent.load_actor(flax_actor_to_state_dict(params))
    env = TCrowdEnv(tcfg.make_config("crowd_dense", "crowd", max_steps=12),
                    device="cpu", seed=0)
    _, _, traj, _, _ = tviz.trace_rollout(env, lambda o: agent.act(o), 0, 12)
    w = tviz.TrajectoryWriter(str(tmp_path / "again"), "t")
    w.record_rollout(traj)
    with open(w.path) as fp:
        assert fp.read().splitlines() == rows


def test_evaluate_trajectory_takes_the_ablation(tmp_path):
    """The audit's rollout runs the evaluated agent's state variant (the
    JAX driver's builds the default world, whose 398-dim observation a
    ``basic`` actor cannot take)."""
    out = str(tmp_path)
    tevaluate.main(["--device", "cpu", "--suite", "train", "--ablation",
                    "basic", "--n-envs", "2", "--max-steps", "6",
                    "--outdir", out, "--trajectory"])
    with open(os.path.join(out, "td3_crowd_dense_crowd_trajectory.csv")) \
            as fp:
        assert len(fp.read().splitlines()) == 6


def test_trajectory_without_matplotlib_raises(rollouts, tmp_path,
                                             monkeypatch):
    """Without matplotlib the CSV is still written and the renders raise
    (as the JAX package's)."""
    tc, _, (ts, tscans, ttraj, _, _) = rollouts
    for name in [m for m in sys.modules if m.startswith("matplotlib")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    w = tviz.TrajectoryWriter(str(tmp_path), "t")
    w.record_rollout(ttraj)
    assert os.path.getsize(w.path) > 0
    with pytest.raises(ImportError):
        tviz.render_trajectory(tc, ttraj)
    with pytest.raises(ImportError):
        tviz.render_frame(tc, tviz.state_at(ts, 0), scans=tscans[0])


YAML = """
turtlebot3:
    actor_alpha: 0.0003
    critic_alpha: 0.0003
    gamma: 0.99
    tau: 0.005
    nepisodes: 3020
    nsteps: 1000
    scan_ranges: 359
    alpha: 0.01
    epsilon_discount: 0.995
    stage_name: stage_1
    desired_pose:
      x: -1.0
      y: 1.0
      z: 0.0
    starting_pose:
      x: 0.5
      y: -0.5
"""


@pytest.mark.parametrize("text", [YAML, "gamma: 0.9\nnsteps: 20\n", ""],
                         ids=["namespaced", "flat", "empty"])
def test_load_yaml_config_matches_jax(text, tmp_path):
    p = tmp_path / "cfg.yaml"
    p.write_text(text)
    got, want = tload(str(p)), jload(str(p))
    assert got == want
    if text == YAML:
        assert got["agent"]["actor_lr"] == 0.0003
        assert got["env"]["goal"] == (-1.0, 1.0)
        assert got["run"]["n_episodes"] == 3020


def test_trace_writes_a_chrome_trace(tmp_path):
    logdir = str(tmp_path / "trace")
    with profiling.trace(logdir, "block") as prof:
        with profiling.annotate("traced_matmul"):
            x = torch.ones((64, 64))
            (x @ x).sum()
    path = os.path.join(logdir, "block.json")
    with open(path) as fp:
        events = json.load(fp)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "traced_matmul" in names
    assert any("mm" in str(n) for n in names)
    assert any(e.key == "traced_matmul" for e in prof.key_averages())


def test_trace_if_gating(tmp_path):
    logdir = str(tmp_path / "off")
    with profiling.trace_if(logdir, False) as prof:
        pass
    assert prof is None and not os.path.exists(logdir)
    with profiling.trace_if(None, True) as prof:
        pass
    assert prof is None
    with profiling.trace_if(logdir, True, "on") as prof:
        torch.zeros(3).add_(1)
    assert prof is not None
    assert os.path.isfile(os.path.join(logdir, "on.json"))
