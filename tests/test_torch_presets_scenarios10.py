"""Evaluation scenarios 19-20 of 24 (``torch_presets.eval_scenarios``):
``crowd_20``/``crowd``, ``crowd_20``/``crowd_highspeed``.

The port's ``CrowdEnv.step_batch`` against the jitted JAX
``CrowdEnv.step_batch`` on each scenario, under the tracker's Pallas form
(the JAX kernel in interpret mode) and its XLA form: 16 envs x 12 steps
with ``max_steps`` 8 and reset jitter 1.0, every env auto-reset;
observations, rewards, dones and every state field bit-equal
(``tests/torch_presets.py``)."""
import pytest
import torch

from torch_presets import case_id, check_preset, scenario_cases

torch.set_num_threads(1)
CASES = scenario_cases(9)


@pytest.mark.parametrize("world,behavior,backend", CASES,
                         ids=[case_id(*c) for c in CASES])
def test_scenario_step_matches_jax(world, behavior, backend):
    check_preset(world, behavior, backend)
