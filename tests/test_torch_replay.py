"""The port's replay ring (``crowdnav_tpu_torch/agents/replay.py``) against
the JAX package's ``ReplayBuffer`` (``crowdnav_tpu/agents/replay.py``), as
``tests/test_agents.py`` drives it: the same transitions with masks that
keep some rows, none and all, a wrap of the ring, float32 and bfloat16
observation storage. The stored blocks, ``head`` and ``size``, and the
samples at JAX's own sample indices (the two frameworks' generators
differ) are bit-equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crowdnav_tpu.agents.replay import ReplayBuffer as JReplay
from crowdnav_tpu.agents.replay import Transition as JTransition
from crowdnav_tpu_torch.agents.replay import ReplayBuffer, Transition

torch.set_num_threads(1)
OBS = 7
BLOCK = 8


def _transitions(seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 2, (BLOCK, OBS)).astype(np.float32),
            rng.uniform(-2, 2, (BLOCK, 2)).astype(np.float32),
            (rng.normal(0, 100, BLOCK)).astype(np.float32),
            rng.normal(0, 2, (BLOCK, OBS)).astype(np.float32),
            (rng.uniform(size=BLOCK) < 0.3).astype(np.float32))


def _bits(a):
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return a.view(np.uint16)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _tbits(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy().view(np.uint32)


def _assert_ring_equal(tbuf, tst, jbuf, jst):
    assert int(tst.head) == int(jst.head)
    assert int(tst.size) == int(jst.size)
    for b in range(jbuf.n_blocks):
        j = jbuf.read_block(jst, b)
        t = tbuf.read_block(tst, b)
        for name in Transition._fields:
            np.testing.assert_array_equal(_tbits(getattr(t, name)),
                                          _bits(getattr(j, name)),
                                          err_msg=f"block {b} {name}")


MASKS = [None, [1, 0, 1, 1, 0, 1, 1, 1], [0] * 8, [1] * 8,
         [0, 0, 0, 0, 0, 0, 0, 1], None, [0, 1, 0, 1, 0, 1, 0, 1], [0] * 8,
         [1, 1, 0, 0, 1, 1, 0, 0]]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_add_batch_and_sample_are_bit_equal(dtype):
    """Nine adds into a ring of three blocks: masks keeping some rows,
    none (twice: before and after the wrap) and all; then samples at
    JAX's indices."""
    jbuf = JReplay(3 * BLOCK, OBS, 2, block=BLOCK,
                   obs_dtype=getattr(jnp, dtype))
    tbuf = ReplayBuffer(3 * BLOCK, OBS, 2, block=BLOCK, obs_dtype=dtype,
                        device="cpu")
    jst, tst = jbuf.init(), tbuf.init()
    for i, mask in enumerate(MASKS):
        tr = _transitions(i)
        jm = None if mask is None else jnp.asarray(mask, bool)
        tm = None if mask is None else torch.tensor(mask, dtype=torch.bool)
        jst = jbuf.add_batch(jst, JTransition(*map(jnp.asarray, tr)), jm)
        tst = tbuf.add_batch(tst, Transition(*map(torch.from_numpy, tr)), tm)
        _assert_ring_equal(tbuf, tst, jbuf, jst)
    key = jax.random.PRNGKey(4)
    jsample = jbuf.sample(jst, key, 64)
    # JAX's indices, drawn as ReplayBuffer.sample draws them
    rows = int(jst.size) // BLOCK * BLOCK
    idx = np.array(jax.random.randint(key, (64,), 0, max(rows, 1)))
    tsample = tbuf.sample(tst, idx=torch.from_numpy(idx))
    for name in Transition._fields:
        np.testing.assert_array_equal(_tbits(getattr(tsample, name)),
                                      _bits(getattr(jsample, name)),
                                      err_msg=name)


def test_all_masked_batch_changes_nothing():
    tbuf = ReplayBuffer(2 * BLOCK, OBS, 2, block=BLOCK, device="cpu")
    st = tbuf.init()
    for i in range(3):      # wraps: block 0 holds the third batch
        st = tbuf.add_batch(st, Transition(*map(torch.from_numpy,
                                                 _transitions(i))))
    before = [f[:tbuf.n_blocks].clone() for f in st.fields()]
    st2 = tbuf.add_batch(st, Transition(*map(torch.from_numpy,
                                              _transitions(9))),
                         torch.zeros(BLOCK, dtype=torch.bool))
    assert int(st2.head) == int(st.head) == 1
    assert int(st2.size) == int(st.size) == 2 * BLOCK
    for a, f in zip(before, st2.fields()):
        assert torch.equal(a, f[:tbuf.n_blocks])


def test_capacity_rounds_up_to_whole_blocks():
    """The flagship ring: 1,000,000 rows in blocks of 16,384 envs is 62
    blocks (1,015,808 rows) of 1,608 bytes with bfloat16 observations."""
    buf = ReplayBuffer(1_000_000, 398, 2, block=16384, obs_dtype="bfloat16",
                       device="cpu")
    jbuf = JReplay(1_000_000, 398, 2, block=16384, obs_dtype=jnp.bfloat16)
    assert buf.n_blocks == jbuf.n_blocks == 62
    assert buf.capacity == jbuf.capacity == 1_015_808
    assert buf.row_bytes() == 1608


def test_sample_from_generator_stays_in_filled_blocks():
    tbuf = ReplayBuffer(4 * BLOCK, OBS, 2, block=BLOCK, device="cpu")
    st = tbuf.init()
    st = tbuf.add_batch(st, Transition(*map(torch.from_numpy,
                                            _transitions(0))))
    st = tbuf.add_batch(st, Transition(*map(torch.from_numpy,
                                            _transitions(1))))
    idx = tbuf.sample_indices(st, 4096, torch.Generator().manual_seed(0))
    assert int(idx.min()) == 0 and int(idx.max()) == 2 * BLOCK - 1
    batch = tbuf.sample(st, 16, torch.Generator().manual_seed(1))
    assert batch.obs.shape == (16, OBS) and batch.reward.shape == (16,)
