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


def _actor_f64_with_bound(sd, obs):
    """The actor in float64 from the same float32 parameters, and a bound
    on the error of any float32 evaluation of it, per output element.

    Each layer is a dot product of n terms plus the bias, whose float32
    forward error is at most gamma(n + 1) * sum |w_i x_i| (+ |b|), with
    gamma(m) = m u / (1 - m u) and u = 2^-24 (Higham, Accuracy and Stability
    of Numerical Algorithms, 3.1), whatever order or fused multiply-adds the
    BLAS uses. The error of a layer's input is carried through |W|, ReLU
    adds none, and the heads carry it by the largest slope on the interval
    around the exact value (0.22 * s(1 - s) for the sigmoid, 2 * (1 -
    tanh^2) for the tanh); their own rounding adds one float32 ulp of the
    output. The float64 evaluation's own error (same bound with 2^-53) is
    added too."""
    def gamma(m, u):
        return m * u / (1.0 - m * u)

    x = obs.astype(np.float64)
    err = np.zeros_like(x)
    for i in range(3):
        w = sd[f"dense{i}.weight"].numpy().astype(np.float64)
        b = sd[f"dense{i}.bias"].numpy().astype(np.float64)
        m = w.shape[1] + 1
        mag = (np.abs(x) + err) @ np.abs(w).T + np.abs(b)
        y = x @ w.T + b
        err = err @ np.abs(w).T + (gamma(m, 2.0 ** -24)
                                   + gamma(m, 2.0 ** -53)) * mag
        x = np.maximum(y, 0.0) if i < 2 else y
    # the point of [raw - err, raw + err] nearest 0, where both slopes peak
    near0 = np.sign(x) * np.maximum(np.abs(x) - err, 0.0)
    sig = 1.0 / (1.0 + np.exp(-x[:, 0]))
    sig0 = 1.0 / (1.0 + np.exp(-near0[:, 0]))
    out = np.stack([0.22 * sig, 2.0 * np.tanh(x[:, 1])], -1)
    slope = np.stack([0.22 * sig0 * (1.0 - sig0),
                      2.0 * (1.0 - np.tanh(near0[:, 1]) ** 2)], -1)
    bound = slope * err + np.spacing(np.abs(out).astype(np.float32))
    return out, bound


def _assert_within_bound(got, ref, exact, bound):
    """Each float32 output within its bound of the exact result, and the
    two within the sum of their bounds of each other."""
    for name, y in (("port", got), ("jax", ref)):
        ratio = np.abs(y.astype(np.float64) - exact) / bound
        assert ratio.max() <= 1.0, (name, float(ratio.max()))
    np.testing.assert_array_less(
        np.abs(got.astype(np.float64) - ref.astype(np.float64)), 2 * bound)


def test_actor_matches_flax_apply():
    """Both frameworks within the float32 forward-error bound of the exact
    (float64) actor: they sum the matmuls in other, host-dependent orders,
    so no fixed tolerance tuned on one machine holds on every host."""
    agent, state = _jax_agent(2)
    # scale the weights so that the heads leave their saturated ends too
    params = jax.tree.map(lambda a: np.asarray(a) * 3.0, state.actor_params)
    obs = np.random.default_rng(0).uniform(-1, 1, (64, OBS_DIM)).astype(
        np.float32)
    ref = np.asarray(jax.jit(agent.actor.apply)(params, obs))
    sd = convert.flax_actor_to_state_dict(params)
    tagent = TD3(TD3Config(), OBS_DIM, device="cpu")
    tagent.load_actor(sd)
    got = tagent.actor(torch.from_numpy(obs)).detach().numpy()
    exact, bound = _actor_f64_with_bound(sd, obs)
    _assert_within_bound(got, ref, exact, bound)
    # greedy act = the clipped actor output, as TD3.act(explore=False);
    # clipping to the box moves no value farther from the exact one
    js = state.replace(actor_params=params)
    ref_act = np.asarray(jax.jit(lambda s, o: agent.act(s, o, explore=False))(
        js, obs))
    box_lo, box_hi = np.array([0.0, -2.0]), np.array([0.22, 2.0])
    _assert_within_bound(tagent.act(torch.from_numpy(obs)).numpy(), ref_act,
                         np.clip(exact, box_lo, box_hi), bound)


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
