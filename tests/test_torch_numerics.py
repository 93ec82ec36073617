"""The port's float32 rules (``crowdnav_tpu_torch/utils/numerics.py``)
against the jitted JAX operations they stand for: bit-equal on 10^5
values from a numpy seed."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crowdnav_tpu_torch.utils import numerics as nm

torch.set_num_threads(1)
N = 100_000


def _vals(seed, lo=-3.0, hi=3.0):
    return np.random.default_rng(seed).uniform(lo, hi, N).astype(np.float32)


def _bits_equal(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.dtype == ref.dtype == np.float32
    mism = int((got.view(np.int32) != ref.view(np.int32)).sum())
    assert mism == 0, f"{mism} of {got.size} values differ"


@pytest.mark.parametrize("decimals", [2, 3])
def test_round_dec_matches_jnp_round(decimals):
    v = _vals(0)
    ref = jax.jit(lambda x: jnp.round(x, decimals))(v)
    _bits_equal(nm.round_dec(torch.from_numpy(v), decimals), ref)
    if decimals == 3:
        _bits_equal(nm.round3(torch.from_numpy(v)), ref)


@pytest.mark.parametrize("c", [0.15, 0.1, 3.0, 0.033, 0.16, 0.48])
def test_div_const_matches_jitted_division(c):
    v = _vals(1)
    ref = jax.jit(lambda x: x / c)(v)
    _bits_equal(nm.div_const(torch.from_numpy(v), c), ref)


def test_rdiv_matches_jitted_scalar_over_tensor():
    v = _vals(2)
    ref = jax.jit(lambda x: jnp.minimum(1.0, 0.15 / x))(v)
    got = torch.clamp_max(nm.rdiv(0.15, torch.from_numpy(v)), 1.0)
    _bits_equal(got, ref)


def test_fma_matches_contracted_multiply_add():
    a, b, c, d = (_vals(s) for s in range(3, 7))
    ta, tb, tc, td = map(torch.from_numpy, (a, b, c, d))
    _bits_equal(nm.fma(ta, tb, tc), jax.jit(lambda x, y, z: x * y + z)(a, b, c))
    _bits_equal(nm.fma(ta, tb, tc * td),
                jax.jit(lambda w, x, y, z: w * x + y * z)(a, b, c, d))


def test_norm2_matches_jnp_linalg_norm_along_axis():
    v = np.random.default_rng(7).uniform(-3, 3, (N // 24, 24, 2)).astype(
        np.float32)
    t = torch.from_numpy(v)
    ref = jax.jit(jax.vmap(lambda x: jnp.linalg.norm(x, axis=-1)))(v)
    _bits_equal(nm.norm2(t[..., 0], t[..., 1]), ref)


def test_vec_norm2_matches_norm_of_a_difference():
    """The per-env ``jnp.linalg.norm(p - q)`` of the step program. XLA's
    CPU backend splits a large array between threads and fuses the
    multiply-add in the scalar code at the split points, so at 10^5 envs
    one program computes this norm two ways; it is evaluated here in
    batches of 64 envs, the size of the port's env tests."""
    rng = np.random.default_rng(8)
    p = rng.uniform(-1.5, 1.5, (N, 2)).astype(np.float32)
    q = (p + rng.normal(size=p.shape) * 0.03).astype(np.float32)
    f = jax.jit(jax.vmap(lambda a, b: jnp.linalg.norm(a - b)))
    ref = np.concatenate([np.asarray(f(p[i:i + 64], q[i:i + 64]))
                          for i in range(0, N, 64)])
    d = torch.from_numpy(p) - torch.from_numpy(q)
    _bits_equal(nm.vec_norm2(d[:, 0], d[:, 1]), ref)


@pytest.mark.parametrize("name", ["cos", "sin", "sqrt", "atan2"])
def test_functions_match_jitted_jnp(name):
    x, y = _vals(9, -7.0, 7.0), _vals(10)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    if name == "atan2":
        ref = jax.jit(jnp.arctan2)(y, x)
        got = nm.atan2(ty, tx)
    elif name == "sqrt":
        ref = jax.jit(jnp.sqrt)(np.abs(x))
        got = nm.sqrt(tx.abs())
    else:
        ref = jax.jit(getattr(jnp, name))(x)
        got = getattr(nm, name)(tx)
    _bits_equal(got, ref)
