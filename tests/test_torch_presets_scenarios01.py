"""Evaluation scenarios 1-2 of 24 (``torch_presets.eval_scenarios``):
``test_4``/``crossing``, ``test_4``/``towards``.

The port's ``CrowdEnv.step_batch`` against the jitted JAX
``CrowdEnv.step_batch`` on each scenario, under the tracker's Pallas form
(the JAX kernel in interpret mode) and its XLA form: 16 envs x 12 steps
with ``max_steps`` 8 and reset jitter 1.0, every env auto-reset;
observations, rewards, dones and every state field bit-equal
(``tests/torch_presets.py``)."""
import ast
import os

import pytest
import torch

from torch_presets import (GROUP, case_id, check_preset, eval_scenarios,
                           scenario_cases, scenario_group)

torch.set_num_threads(1)
CASES = scenario_cases(0)


@pytest.mark.parametrize("world,behavior,backend", CASES,
                         ids=[case_id(*c) for c in CASES])
def test_scenario_step_matches_jax(world, behavior, backend):
    check_preset(world, behavior, backend)


def test_the_files_cover_every_evaluation_scenario():
    """The port's suites are the JAX evaluation driver's (read from its
    source: importing it sets a compilation cache), and the twelve files'
    groups are its 23 scenarios other than ``train`` and the pillars
    world, each once."""
    import crowdnav_tpu
    from crowdnav_tpu_torch.drivers.evaluate import SUITES
    path = os.path.join(os.path.dirname(crowdnav_tpu.__file__), "drivers",
                        "evaluate.py")
    with open(path) as fp:
        tree = ast.parse(fp.read())
    node = next(n for n in tree.body if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", None) == "SUITES")
    assert SUITES == eval(compile(ast.Expression(node.value), path, "eval"))
    groups = [scenario_group(i) for i in range(12)]
    assert all(len(g) == GROUP for g in groups)
    flat = [p for g in groups for p in g]
    assert flat == eval_scenarios() and len(set(flat)) == 24
    assert len({p for name, pairs in SUITES.items() if name != "train"
                for p in pairs}) == 23
