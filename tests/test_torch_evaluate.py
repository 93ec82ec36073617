"""The slice as a whole: a ``learning=False`` chunk of the port's
``Trainer`` against the JAX package's, from JAX's reset states and reset
template (a crossing crowd, so no draws are made during the chunk); and
the port's evaluation driver end to end on the CPU with the exported
``final_full`` actor."""
import csv
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from crowdnav_tpu.envs import CrowdEnv, make_config
from crowdnav_tpu.parallel import Trainer as JTrainer
from crowdnav_tpu.parallel import TrainerConfig as JTrainerConfig
from crowdnav_tpu_torch.drivers import evaluate as tevaluate
from crowdnav_tpu_torch.envs import config as tcfg
from crowdnav_tpu_torch.envs.crowd_env import CrowdEnv as TCrowdEnv
from crowdnav_tpu_torch.parallel.runtime import Trainer, TrainerConfig
from torch_parity import env_state_to_torch

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSET = os.path.join(ROOT, "crowdnav_tpu_torch", "assets",
                     "final_full_actor.npz")
N, CHUNK = 16, 120
INT_KEYS = ("episodes", "successes", "failures", "greedy_episodes")
FLOAT_KEYS = ("success_rate", "mean_reward", "mean_steps", "mean_ego_safety",
              "mean_social_safety", "mean_dtg_rewards", "mean_htg_rewards",
              "mean_wp_bonuses", "greedy_success_rate")


@dataclasses.dataclass(frozen=True)
class _SeekerConfig:
    buffer_size: int = 4 * N


class _GoalSeeker:
    """A policy both frameworks compute bit for bit: constant speed, turn
    toward the waypoint (``2 * htg``, clipped). The trained actor's
    matmuls round differently in the two frameworks (``test_torch_agent``
    holds them within 1e-5), and over a hundred steps those last-bit action
    differences move episodes; this policy keeps the chunk comparison
    exact."""

    cfg = _SeekerConfig()

    def init(self, key=None):
        return None

    def act(self, state, obs=None, key=None, explore=False):
        obs = state if obs is None else obs     # port: act(obs, explore)
        xp = torch if isinstance(obs, torch.Tensor) else jax.numpy
        turn = xp.clip(obs[:, 359] * 2.0, -2.0, 2.0)
        return xp.stack([xp.full_like(turn, 0.15), turn], -1)


def test_trainer_chunk_matches_jax():
    kw = dict(jitter=1.0, max_steps=100)
    jc = make_config("crowd_dense", "crossing", **kw)
    tc = tcfg.make_config("crowd_dense", "crossing", **kw)
    jenv = CrowdEnv(jc)
    jt = JTrainer(jenv, _GoalSeeker(), JTrainerConfig(
        n_envs=N, rollout_chunk=CHUNK, learning=False))
    j0 = jt.init(jax.random.PRNGKey(0))
    ref, _ = jt.drain_stats(jax.jit(jt.rollout_chunk)(j0))

    tenv = TCrowdEnv(tc, device="cpu")
    st, obs = jenv._template
    tenv.template = (env_state_to_torch(jax.tree.map(lambda a: a[None], st)),
                     torch.from_numpy(np.array(obs))[None])
    tt = Trainer(tenv, _GoalSeeker(), TrainerConfig(
        n_envs=N, rollout_chunk=CHUNK, learning=False))
    ts = dataclasses.replace(
        tt.init(0), env_states=env_state_to_torch(j0.env_states),
        obs=torch.from_numpy(np.array(j0.obs)))
    got, ts = tt.drain_stats(tt.rollout_chunk(ts))

    assert ref["episodes"] > N and 0 < ref["successes"] < ref["episodes"]
    for k in INT_KEYS:
        assert got[k] == ref[k], k
    for k in FLOAT_KEYS:
        assert got[k] == pytest.approx(ref[k], rel=1e-4, abs=1e-4), k
    assert int(ts.stats.episodes) == 0      # drained


def test_evaluate_main_runs_on_cpu_and_writes_the_csv(tmp_path, capsys):
    results = tevaluate.main([
        "--device", "cpu", "--suite", "train", "--checkpoint", ASSET,
        "--n-envs", "4", "--max-steps", "12", "--outdir", str(tmp_path)])
    assert len(results) == 1 and results[0]["scenario"] == \
        "crowd_dense/crowd"
    with open(tmp_path / "td3_training_test.csv") as fp:
        rows = list(csv.reader(fp))
    assert rows[0] == ["episode_number", "success_episode",
                       "failure_episode", "episode_reward", "episode_step",
                       "ego_safety_score", "social_safety_score", "timelapse"]
    assert len(rows) == 2 and len(rows[1]) == 8
    assert '"overall_success_rate"' in capsys.readouterr().out


def test_evaluate_rejects_conflicting_metadata(tmp_path):
    with pytest.raises(SystemExit):
        tevaluate.main(["--device", "cpu", "--checkpoint", ASSET,
                        "--ablation", "no_cp", "--n-envs", "2",
                        "--max-steps", "2", "--outdir", str(tmp_path)])


@pytest.mark.parametrize("n", [16, 1024, 16384])
def test_greedy_env_mask_matches_jax(n):
    """The greedy cohort under the final_full agent's epsilon spectrum."""
    from crowdnav_tpu.agents.td3 import TD3 as JTD3
    from crowdnav_tpu.agents.td3 import TD3Config as JTD3Config
    from crowdnav_tpu.parallel.runtime import greedy_env_mask as jmask
    from crowdnav_tpu_torch.parallel.runtime import greedy_env_mask
    _, meta = tevaluate.load_actor_file(ASSET)
    fields = {f.name for f in dataclasses.fields(JTD3Config)}
    jagent = JTD3(JTD3Config(**{k: v for k, v in meta["agent_config"].items()
                                if k in fields}), 398)
    tagent = tevaluate.build_agent(meta["agent_config"], 398, "cpu")
    assert tagent.cfg.explore_eps_spectrum
    np.testing.assert_array_equal(greedy_env_mask(tagent, n).numpy(),
                                  np.asarray(jmask(jagent, n)))
