"""The port's copy of the env config equals the JAX package's, field by
field, for every preset combination."""
import dataclasses
import itertools

import pytest

from crowdnav_tpu.envs import config as jcfg
from crowdnav_tpu_torch.envs import config as tcfg

BEHAVIORS = [None] + sorted(jcfg.BEHAVIOR_PRESETS)
ABLATIONS = [None] + sorted(jcfg.ABLATION_PRESETS)
ROBOTS = [None] + sorted(jcfg.ROBOT_PRESETS)


def _as_plain(cfg):
    d = dataclasses.asdict(cfg)
    d["behavior"] = int(d["behavior"])
    return d


def test_presets_equal():
    assert sorted(tcfg.WORLD_PRESETS) == sorted(jcfg.WORLD_PRESETS)
    for name in (("BEHAVIOR_PRESETS"), "ABLATION_PRESETS", "ROBOT_PRESETS"):
        j, t = getattr(jcfg, name), getattr(tcfg, name)
        assert sorted(j) == sorted(t)
        for k in j:
            assert repr(j[k]) == repr(t[k]), (name, k)
    assert {int(b): b.name for b in jcfg.CrowdBehavior} == \
        {int(b): b.name for b in tcfg.CrowdBehavior}


@pytest.mark.parametrize("world", sorted(jcfg.WORLD_PRESETS))
def test_make_config_equal_for_every_preset(world):
    for beh, abl, robot, jitter in itertools.product(
            BEHAVIORS, ABLATIONS, ROBOTS, (0.0, 1.0)):
        j = jcfg.make_config(world, beh, ablation=abl, robot=robot,
                             jitter=jitter)
        t = tcfg.make_config(world, beh, ablation=abl, robot=robot,
                             jitter=jitter)
        assert _as_plain(j) == _as_plain(t), (world, beh, abl, robot, jitter)
        assert j.direction_table() == t.direction_table()
        assert (j.n_scans, j.room_half_inner, j.state_dim_risk,
                j.state_dim_simple) == (t.n_scans, t.room_half_inner,
                                        t.state_dim_risk, t.state_dim_simple)
