"""The port's ``rsqrt`` (``crowdnav_tpu_torch/utils/numerics.py``) against
jitted ``jax.lax.rsqrt``, and its RMSprop (``agents/optim.py``) against
``optax.rmsprop(2.5e-4, decay=0.9, eps=1e-6)``, DQN's optimizer: bit for
bit.

XLA's CPU backend computes ``rsqrt`` of a positive normal float32 as the
x86 ``rsqrtps`` estimate refined by Newton steps with two fused
multiply-adds each (two on Intel hosts, one on AMD hosts); the port
replays that from a table of the estimate (``scripts/rsqrt_table.py``).
The estimate is the host CPU's: the port selects the table and the
number of steps of this host's vendor (``numerics.rsqrt_form``)."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from crowdnav_tpu_torch.agents.optim import RMSprop
from crowdnav_tpu_torch.utils import numerics as nm

torch.set_num_threads(1)


def _bits_equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    same = got.view(np.uint32) == want.view(np.uint32)
    return same | (np.isnan(got) & np.isnan(want))


@pytest.mark.parametrize("kind", ["rmsprop_range", "all_exponents",
                                  "special"])
def test_rsqrt_is_bit_equal_to_xla(kind):
    rng = np.random.default_rng(5)
    if kind == "rmsprop_range":     # nu + eps of RMSprop
        x = np.concatenate([1e-6 + 10.0 ** rng.uniform(-12, 4, 1 << 20),
                            rng.uniform(1e-6, 2e-6, 1 << 16)])
    elif kind == "all_exponents":   # random bit patterns of finite floats
        x = rng.integers(0, 0x7F800000, 1 << 21,
                         dtype=np.uint32).view(np.float32)
    else:
        x = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -1.0, 1e-45,
                      1.17549435e-38, 1.0, 2.0, 4.0, 3.4028235e38])
    x = x.astype(np.float32)
    want = np.asarray(jax.jit(jax.lax.rsqrt)(x))
    got = nm.rsqrt(torch.from_numpy(x)).numpy()
    bad = ~_bits_equal(got, want)
    assert not bad.any(), (x[bad][:5], got[bad][:5], want[bad][:5])


def test_rsqrt_table_is_the_hosts_estimate():
    """The table of the form selected on this host is this host's
    ``rsqrtps`` (when a C compiler is present to run it)."""
    import importlib.util
    import os
    import shutil
    if shutil.which("cc") is None and shutil.which("gcc") is None:
        pytest.skip("needs a host C compiler to run rsqrtps")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "rsqrt_table", os.path.join(root, "scripts", "rsqrt_table.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    hw = mod._hardware()
    tab = mod.table(hw)
    np.testing.assert_array_equal(
        tab, np.load(nm.rsqrt_table_path(nm.rsqrt_form())))
    assert mod.check_scaling(hw, tab, n=1 << 18) == 0


def test_rmsprop_is_bit_equal_to_optax():
    rng = np.random.default_rng(0)
    p = rng.standard_normal(4096).astype(np.float32)
    tx = optax.rmsprop(2.5e-4, decay=0.9, eps=1e-6)
    jstate, jp = tx.init(jnp.asarray(p)), jnp.asarray(p)
    opt = RMSprop(2.5e-4, decay=0.9, eps=1e-6)
    tstate, tp = opt.init(torch.from_numpy(p)), torch.from_numpy(p.copy())
    for step in range(8):
        g = (rng.standard_normal(p.size)
             * 10.0 ** rng.integers(-6, 2, p.size)).astype(np.float32)
        if step == 3:
            g[:] = 0.0
        u, jstate = tx.update(jnp.asarray(g), jstate, jp)
        jp = optax.apply_updates(jp, u)
        tp, tstate = opt.update(torch.from_numpy(g), tstate, tp)
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp),
                                      err_msg=f"step {step}")
        np.testing.assert_array_equal(tstate.nu.numpy(),
                                      np.asarray(jstate[0].nu))


@pytest.mark.parametrize("vendor,steps", [("GenuineIntel", 2),
                                          ("AuthenticAMD", 1)])
def test_rsqrt_form_follows_the_cpu_vendor(vendor, steps, tmp_path,
                                           monkeypatch):
    """The form is chosen from ``/proc/cpuinfo``'s vendor (never from
    JAX): each vendor's committed table (8,192 12-bit mantissas, the two
    vendors' differing) and its number of Newton steps; an unknown vendor
    raises rather than replaying another's estimate."""
    info = tmp_path / "cpuinfo"
    info.write_text(f"processor\t: 0\nvendor_id\t: {vendor}\nflags\t: fma\n")
    assert nm.cpu_vendor(str(info)) == vendor
    form = nm.RSQRT_FORMS[vendor]
    assert form.newton_steps == steps
    tab = np.load(nm.rsqrt_table_path(form))
    assert tab.shape == (8192,) and tab.max() < 4096
    others = [np.load(nm.rsqrt_table_path(f))
              for v, f in nm.RSQRT_FORMS.items() if v != vendor]
    assert all((o != tab).sum() > 1000 for o in others)
    monkeypatch.setattr(nm, "cpu_vendor", lambda *a: "SomeOtherVendor")
    nm.rsqrt_form.cache_clear()
    try:
        with pytest.raises(NotImplementedError, match="SomeOtherVendor"):
            nm.rsqrt_form()
    finally:
        monkeypatch.undo()
        nm.rsqrt_form.cache_clear()
    assert nm.rsqrt_form().vendor == nm.cpu_vendor()
