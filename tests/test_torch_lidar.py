"""The port's raycast (``crowdnav_tpu_torch/ops/lidar.py``: the plain
version of the CUDA raycast kernel, which its wrapper runs on CPU tensors)
against the jitted, vmapped ``crowdnav_tpu.ops.lidar.scan``: bit-equal
after 3-decimal rounding, raw ranges within 1e-6; and against the Pallas
kernel in interpret mode at that kernel's own tolerance."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crowdnav_tpu.ops import lidar as jlidar
from crowdnav_tpu.ops.lidar_pallas import scan_batch_pallas
from crowdnav_tpu_torch.ops import lidar as tlidar
from crowdnav_tpu_torch.utils import numerics as nm

torch.set_num_threads(1)
R, H, MAX, MIN = 0.0505, 1.45, 0.6, 0.08


def _inputs(seed, n, p):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1.3, 1.3, (n, 2)).astype(np.float32)
    yaw = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    peds = rng.uniform(-1.35, 1.35, (n, p, 2)).astype(np.float32)
    return pos, yaw, peds


def _jax_scan(pos, yaw, peds):
    f = jax.jit(jax.vmap(lambda a, b, c: jlidar.scan(a, b, c, R, H, MAX, MIN,
                                                     359)))
    return np.asarray(f(pos, yaw, peds))


def _port_scan(pos, yaw, peds):
    return tlidar.scan_batch(torch.from_numpy(pos), torch.from_numpy(yaw),
                             torch.from_numpy(peds), R, H, MAX, MIN, 359)


def _assert_scans_match(got, ref):
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)
    rounded = np.asarray(jax.jit(lambda v: jnp.round(v, 3))(ref))
    np.testing.assert_array_equal(nm.round3(got).numpy(), rounded)


def test_beam_tables_match_folded_jax_tables():
    ca, sa = jax.jit(lambda: (
        jnp.cos(jnp.arange(359, dtype=jnp.float32) * (jnp.pi / 180.0)),
        jnp.sin(jnp.arange(359, dtype=jnp.float32) * (jnp.pi / 180.0))))()
    tca, tsa = tlidar.beam_tables(359)
    np.testing.assert_array_equal(tca.numpy(), np.asarray(ca))
    np.testing.assert_array_equal(tsa.numpy(), np.asarray(sa))


@pytest.mark.parametrize("n,p", [(64, 14), (13, 14), (64, 3)])
def test_raycast_matches_jax_scan(n, p):
    pos, yaw, peds = _inputs(n * 31 + p, n, p)
    _assert_scans_match(_port_scan(pos, yaw, peds), _jax_scan(pos, yaw, peds))


@pytest.mark.parametrize("placeholder", [False, True])
def test_raycast_without_pedestrians(placeholder):
    """``n_peds=0``: no pedestrian axis, or the env's placeholder
    pedestrian far out of range (``world.init_state``)."""
    pos, yaw, _ = _inputs(5, 32, 0)
    peds = (np.full((32, 1, 2), 1e3, np.float32) if placeholder
            else np.zeros((32, 0, 2), np.float32))
    _assert_scans_match(_port_scan(pos, yaw, peds), _jax_scan(pos, yaw, peds))


def test_scan_points_match_jax():
    pos, yaw, peds = _inputs(7, 48, 14)
    scans = np.asarray(jax.jit(lambda v: jnp.round(v, 3))(
        _jax_scan(pos, yaw, peds)))
    ref = jax.jit(jax.vmap(lambda a, b, c: jlidar.scan_points(a, b, c, 359)))(
        pos, yaw, scans)
    got = tlidar.scan_points(torch.from_numpy(pos), torch.from_numpy(yaw),
                             torch.from_numpy(scans))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("n,p", [(16, 6), (13, 3)])
def test_raycast_matches_pallas_interpret(n, p):
    """The Pallas kernel computes cos(yaw - i deg) directly, so it agrees
    with the XLA scan, and with the port, to 2e-5 (its own test's bound)."""
    pos, yaw, peds = _inputs(100 + n, n, p)
    ref = scan_batch_pallas(jnp.asarray(pos), jnp.asarray(yaw),
                            jnp.asarray(peds), R, H, MAX, MIN,
                            interpret=True)
    np.testing.assert_allclose(_port_scan(pos, yaw, peds).numpy(),
                               np.asarray(ref), atol=2e-5)


@pytest.mark.parametrize("p", [6, 14, 20])
@pytest.mark.parametrize("half", [1.45, 2.45], ids=["3m_room", "5m_room"])
def test_pallas_form_matches_pallas_kernel(p, half):
    """The raycast kernel's Pallas form (its plain version, which
    ``scan_batch_pallas`` runs on CPU tensors) against
    ``lidar_pallas.scan_batch_pallas`` as the JAX package's CPU tests run
    it (interpret mode, jitted): bit for bit, raw ranges, at the
    pedestrian counts of ``crowd_sparse``, ``crowd_dense`` and
    ``crowd_20``/``test_20`` and in both room sizes."""
    rng = np.random.default_rng(200 + p)
    n = 48
    lim = half - 0.1
    pos = rng.uniform(-lim, lim, (n, 2)).astype(np.float32)
    yaw = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    peds = rng.uniform(-lim, lim, (n, p, 2)).astype(np.float32)
    # pedestrians right next to the robot, so that near hits and the
    # min-range clip occur
    peds[:, 0] = pos + np.float32(0.07)
    ref = np.asarray(scan_batch_pallas(
        jnp.asarray(pos), jnp.asarray(yaw), jnp.asarray(peds), R, half, MAX,
        MIN, interpret=None))
    before = tlidar.scan_batch_pallas.launches
    got = tlidar.scan_batch_pallas(torch.from_numpy(pos),
                                   torch.from_numpy(yaw),
                                   torch.from_numpy(peds), R, half, MAX, MIN)
    assert tlidar.scan_batch_pallas.launches == before
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  ref.view(np.uint32))
    assert (ref < MAX).mean() > 0.02 and (ref == MIN).any()


def test_pallas_form_differs_from_xla_form():
    """The two forms compute each beam's direction differently, so their
    raw ranges differ in the last bits somewhere: a wrapper that ran the
    other form would fail the tests above."""
    pos, yaw, peds = _inputs(7, 64, 14)
    a = tlidar.scan_batch_pallas(torch.from_numpy(pos), torch.from_numpy(yaw),
                                 torch.from_numpy(peds), R, H, MAX, MIN)
    b = _port_scan(pos, yaw, peds)
    assert (a != b).any()
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5)
