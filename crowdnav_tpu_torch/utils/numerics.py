"""Float32 arithmetic rules shared by the plain code and the CUDA kernels.

The JAX package is the reference, and its step program is always jitted.
Jitted XLA on the CPU does four things that eager PyTorch does not, and the
observation is rounded to 3 decimals, so a one-ulp difference anywhere
upstream can flip an observed value. Every module of the port follows
these rules, and every kernel in ``kernels/csrc`` does the same arithmetic:

1. ``x / c`` with a Python-float ``c`` is compiled to ``x * f32(1/f32(c))``
   (:func:`div_const`); ``jnp.round(x, d)`` is ``rint(x * 10^d) * f32(10^-d)``
   (:func:`round_dec`, :func:`round3`). In CUDA: ``rintf(x*1000.f)*0.001f``.
2. ``c / v`` is a true division. PyTorch's ``c / tensor`` is
   ``tensor.reciprocal() * c``, so write it as :func:`rdiv`.
3. XLA's CPU backend contracts ``a*b + c`` into one fused multiply-add, with
   the first product of a sum fused: ``a*b + c*d == fma(a, b, c*d)``, and
   the norm along an axis of size 2 is ``sqrt(fma(y, y, x*x))``
   (:func:`norm2`), while the norm of a whole per-env 2-vector is the
   unfused ``sqrt(x*x + y*y)`` (:func:`vec_norm2`). The plain code writes each such
   site with :func:`fma`; the kernels use ``fmaf`` there and build with
   ``-fmad=false`` so the compiler contracts nothing else.
4. ``sqrt`` is correctly rounded, and ``cos``/``sin``/``atan2`` are the C
   library's float functions. PyTorch's CPU kernels differ in the last ulp;
   :func:`sqrt` goes through float64 (exact after rounding), and on CPU
   tensors :func:`cos`, :func:`sin` and :func:`atan2` call the C library's
   ``cosf``/``sinf``/``atan2f``. On CUDA tensors they launch
   ``kernels/csrc/libm_trig.cu``, which computes what GNU libc's float
   routines compute, operation for operation (``libm_f32.cuh``; PyTorch's
   CUDA functions differ from them on about a sixth of all inputs).
5. ``jax.lax.rsqrt`` is not correctly rounded: XLA's CPU backend takes the
   x86 ``rsqrtps`` estimate and one or two Newton steps, by CPU vendor
   (:func:`rsqrt`, :data:`RSQRT_FORMS`).
6. The Pallas kernels run in interpret mode on the CPU, jitted, and XLA
   fuses their bodies by rules 1-4 as written, not as the sources read:
   ``x / dt`` is still ``x * f32(1/dt)``; ``a*a + b*b`` fuses its first
   product, ``fma(a, a, b*b)`` (the XLA chain's norms, by contrast, are
   ``fma(b, b, a*a)``); ``yaw - i * deg`` is ``fma(-i, deg, yaw)``; a
   product added to a difference fuses across it (the tracker's resultant
   speed is ``fma(|motion|, 1/dt, -speed)``). How much fuses depends on
   the program around an expression: under ``strict_quirks`` the jitted
   step fuses that resultant and the chain jitted alone does not, so the
   port follows the step.
7. XLA folds the constants of a random draw into the scale applied to it
   (``normal * c`` becomes ``erfinv(u) * f32(sqrt(2) * c)``), so a draw is
   passed in as the scaled value the jitted step computes.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import dataclasses
import functools
import os

import numpy as np
import torch

F32 = torch.float32


def f32(c: float) -> float:
    """The float32 value nearest ``c``, as a Python float."""
    return float(np.float32(c))


def recip_f32(c: float) -> float:
    """``f32(1 / f32(c))``: the multiplier XLA substitutes for ``/ c``."""
    return float(np.float32(1.0) / np.float32(c))


def div_const(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` for a Python-float constant ``c``, as jitted XLA computes it."""
    return x * recip_f32(c)


def rdiv(c: float, v: torch.Tensor) -> torch.Tensor:
    """``c / v`` for a constant ``c``: a true float32 division."""
    return torch.full_like(v, f32(c)) / v


def round_dec(x: torch.Tensor, decimals: int) -> torch.Tensor:
    """``jnp.round(x, decimals)`` under jit: round half to even of
    ``x * 10^d``, then times ``f32(10^-d)``."""
    scale = float(10 ** decimals)
    return torch.round(x * f32(scale)) * recip_f32(scale)


def round3(x: torch.Tensor) -> torch.Tensor:
    return round_dec(x, 3)


def fma(a, b, c) -> torch.Tensor:
    """Fused ``a*b + c`` rounded once to float32 (through float64: the
    product of two floats is exact there)."""
    def d(v):
        return v.double() if isinstance(v, torch.Tensor) else float(v)
    out = d(a) * d(b) + d(c)
    return out.float()


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root."""
    return torch.sqrt(x.double()).float()


def norm2(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``jnp.linalg.norm(v, axis=-1)`` of ``v = (x, y)`` under jit."""
    return sqrt(fma(y, y, x * x))


def vec_norm2(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``jnp.linalg.norm(v)`` of a whole per-env 2-vector ``v = (x, y)``
    under jit and vmap: no fused multiply-add."""
    return sqrt(x * x + y * y)


@functools.lru_cache(maxsize=1)
def _libm():
    lib = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
    for name in ("cosf", "sinf"):
        getattr(lib, name).restype = ctypes.c_float
        getattr(lib, name).argtypes = [ctypes.c_float]
    lib.atan2f.restype = ctypes.c_float
    lib.atan2f.argtypes = [ctypes.c_float, ctypes.c_float]
    return lib


def _libm_map(fn, *xs: torch.Tensor) -> torch.Tensor:
    x0 = xs[0]
    cols = [x.detach().to(F32).reshape(-1).tolist() for x in xs]
    out = np.fromiter((fn(*v) for v in zip(*cols)), np.float32,
                      count=x0.numel())
    return torch.from_numpy(out).reshape(x0.shape)


def sincos(x: torch.Tensor, cosine: bool) -> torch.Tensor:
    """The C library's ``cosf`` (``cosine``) or ``sinf`` of each element:
    the library itself on CPU tensors, the ``libm_trig`` kernel on CUDA
    tensors."""
    if x.device.type == "cpu":
        lib = _libm()
        return _libm_map(lib.cosf if cosine else lib.sinf, x)
    from crowdnav_tpu_torch.kernels import build
    out = build.libm_sincos(x, cosine).reshape(x.shape)
    sincos.launches += 1
    return out


sincos.launches = 0


def cos(x: torch.Tensor) -> torch.Tensor:
    return sincos(x, True)


def sin(x: torch.Tensor) -> torch.Tensor:
    return sincos(x, False)


def atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The C library's ``atan2f``, as :func:`sincos` for its devices."""
    if y.device.type == "cpu":
        return _libm_map(_libm().atan2f, *torch.broadcast_tensors(y, x))
    from crowdnav_tpu_torch.kernels import build
    out = build.libm_atan2(y, x)
    atan2.launches += 1
    return out


atan2.launches = 0


_ASSETS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets")


@dataclasses.dataclass(frozen=True)
class RsqrtForm:
    """How XLA's CPU backend computes ``rsqrt`` on one vendor's x86 hosts:
    the ``rsqrtps`` estimate, tabulated by ``scripts/rsqrt_table.py``,
    and the number of Newton steps that refine it."""

    vendor: str
    table: str      # file name under assets/
    newton_steps: int


# Read from XLA's optimized LLVM IR and object code of a jitted
# ``jax.lax.rsqrt`` (``XLA_FLAGS=--xla_dump_to=...``): on an Intel Xeon
# with AVX-512, ``vrsqrtps`` on 256-bit vectors and two Newton steps (no
# ``vrsqrt14ps``); on an AMD EPYC, ``rsqrtps`` and one Newton step.
# Intel's and AMD's ``rsqrtps`` tables differ (4,357 of 8,192 entries).
RSQRT_FORMS = {
    "GenuineIntel": RsqrtForm("GenuineIntel", "rsqrt_table_intel.npy", 2),
    "AuthenticAMD": RsqrtForm("AuthenticAMD", "rsqrt_table_amd.npy", 1),
}


def cpu_vendor(cpuinfo: str = "/proc/cpuinfo") -> str:
    """The host CPU's ``vendor_id``."""
    with open(cpuinfo) as fp:
        for line in fp:
            if line.startswith("vendor_id"):
                return line.split(":", 1)[1].strip()
    raise RuntimeError(f"no vendor_id in {cpuinfo}")


@functools.lru_cache(maxsize=1)
def rsqrt_form() -> RsqrtForm:
    """The :class:`RsqrtForm` of this host, chosen at first use; both
    devices use it, so that the card's learner equals the CPU's beside
    it."""
    vendor = cpu_vendor()
    if vendor not in RSQRT_FORMS:
        raise NotImplementedError(
            f"no rsqrt form for CPU vendor {vendor!r} (known: "
            f"{', '.join(RSQRT_FORMS)}); tabulate its estimate with "
            f"scripts/rsqrt_table.py and read XLA's Newton steps from a "
            f"dump of jitted jax.lax.rsqrt")
    return RSQRT_FORMS[vendor]


def rsqrt_table_path(form: RsqrtForm) -> str:
    return os.path.join(_ASSETS, form.table)


@functools.lru_cache(maxsize=4)
def _rsqrt_estimates(device) -> torch.Tensor:
    """(8192,) int32 bit patterns of this host's ``rsqrtps`` estimate of
    x in [1, 4), indexed by the exponent's last bit and the top 12
    mantissa bits (``scripts/rsqrt_table.py`` wrote the mantissas)."""
    mant = np.load(rsqrt_table_path(rsqrt_form())).astype(np.int32)
    return torch.from_numpy((mant << 11) | (126 << 23)).to(device)


def rsqrt(x: torch.Tensor) -> torch.Tensor:
    """``jax.lax.rsqrt`` as XLA's CPU backend computes it on this host
    (:func:`rsqrt_form`): the ``rsqrtps`` estimate ``y`` (12 bits), then
    ``y = fma(-0.5 y, fma(x y, y, -1), y)`` once or twice for positive
    normal ``x``; the estimate itself (+-inf, 0 or NaN) for the other
    classes. The same integer and float64 operations on either device."""
    bits = x.contiguous().view(torch.int32)
    biased = (bits >> 23) & 255
    est = _rsqrt_estimates(x.device)[(bits >> 11) & 0x1FFF]
    y = (est - (((biased - 127) >> 1) << 23)).view(torch.float32)
    refined = y
    for _ in range(rsqrt_form().newton_steps):
        refined = fma(refined * -0.5, fma(x * refined, refined, -1.0),
                      refined)
    normal = (bits > 0) & (biased > 0) & (biased < 255)
    subnormal = (biased == 0) & (x != 0)
    other = torch.rsqrt(torch.where(subnormal, x * 0.0, x))
    return torch.where(normal, refined, other)
