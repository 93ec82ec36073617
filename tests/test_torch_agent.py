"""The port's actor (``crowdnav_tpu_torch/models``, ``agents/td3.py``) and
its parameter conversion (``utils/convert.py``) against the JAX package's
``DeterministicActor`` and TD3, and the exported ``final_full`` actor file
against the Orbax checkpoint it came from."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from crowdnav_tpu.agents.td3 import TD3 as JTD3
from crowdnav_tpu.agents.td3 import TD3Config as JTD3Config
from crowdnav_tpu.utils.checkpoint import restore_agent_state
from crowdnav_tpu_torch.agents.td3 import TD3, TD3Config
from crowdnav_tpu_torch.drivers.evaluate import load_actor_file
from crowdnav_tpu_torch.utils import convert

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSET = os.path.join(ROOT, "crowdnav_tpu_torch", "assets",
                     "final_full_actor.npz")
CKPT = os.path.join(ROOT, "results", "r5", "final_full", "agent_ckpt_td3")
OBS_DIM = 398


def _jax_agent(seed=0):
    agent = JTD3(JTD3Config(), OBS_DIM)
    return agent, jax.jit(agent.init)(jax.random.PRNGKey(seed))


def test_convert_round_trips():
    _, state = _jax_agent(1)
    params = jax.tree.map(np.asarray, state.actor_params)
    sd = convert.flax_actor_to_state_dict(params)
    assert sd["dense0.weight"].shape == (256, OBS_DIM)
    back = convert.state_dict_to_flax_actor(sd)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)


def test_actor_matches_flax_apply():
    """Within 1e-5: the two frameworks sum the matmuls in other orders."""
    agent, state = _jax_agent(2)
    # scale the weights so that the heads leave their saturated ends too
    params = jax.tree.map(lambda a: np.asarray(a) * 3.0, state.actor_params)
    obs = np.random.default_rng(0).uniform(-1, 1, (64, OBS_DIM)).astype(
        np.float32)
    ref = np.asarray(jax.jit(agent.actor.apply)(params, obs))
    tagent = TD3(TD3Config(), OBS_DIM, device="cpu")
    tagent.load_actor(convert.flax_actor_to_state_dict(params))
    got = tagent.actor(torch.from_numpy(obs)).detach().numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    # greedy act = the clipped actor output, as TD3.act(explore=False)
    js = state.replace(actor_params=params)
    ref_act = np.asarray(jax.jit(lambda s, o: agent.act(s, o, explore=False))(
        js, obs))
    np.testing.assert_allclose(tagent.act(torch.from_numpy(obs)).numpy(),
                               ref_act, rtol=1e-5, atol=1e-5)


def test_init_uses_flax_initializers():
    tagent = TD3(TD3Config(), OBS_DIM, device="cpu").init(0)
    w = tagent.actor.dense0.weight.detach()
    assert float(tagent.actor.dense0.bias.abs().max()) == 0.0
    std = float(w.std())
    assert abs(std - (1.0 / OBS_DIM) ** 0.5) < 0.1 * (1.0 / OBS_DIM) ** 0.5
    assert float(w.abs().max()) <= 2.0 * (1.0 / OBS_DIM) ** 0.5 / 0.879 + 1e-6


def test_exported_actor_equals_checkpoint():
    params, meta = load_actor_file(ASSET)
    with open(os.path.join(CKPT, "run_config.json")) as fp:
        assert meta == json.load(fp)
    agent, template = _jax_agent(0)
    state = restore_agent_state(CKPT, template)
    ref = state.actor_params
    assert jax.tree.structure(ref) == jax.tree.structure(
        jax.tree.map(jnp.asarray, params))
    for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert sum(np.asarray(a).size for a in jax.tree.leaves(ref)) == 168_450
