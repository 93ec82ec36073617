"""Tabulate the host CPU's ``rsqrtps`` approximation, the first step of
XLA's CPU ``rsqrt`` (the port's ``utils/numerics.rsqrt`` replays it).

    python scripts/rsqrt_table.py [--out FILE]

XLA's CPU backend lowers ``jax.lax.rsqrt`` of a positive normal float32 to
the x86 ``rsqrtps`` estimate ``y`` and one or two Newton steps with two
fused multiply-adds each, ``fma(-0.5 y, fma(x y, y, -1), y)``
(``utils/numerics.RSQRT_FORMS`` says which, by CPU vendor). The estimate of ``x``
in [1, 4) depends only on the exponent's last bit and the top 12 mantissa
bits, and is 0.5 <= y < 1 with 12 significant mantissa bits; for other
exponents it scales by powers of two. This script runs the instruction
(a C helper built with ``cc -mavx``) on every such key, checks both
properties on every float32 in [1, 4) and on random exponents, and writes
the 8,192 12-bit mantissas as uint16. Vendors' ``rsqrtps`` tables differ,
so each vendor's table is committed under ``crowdnav_tpu_torch/assets/``
(``rsqrt_table_intel.npy``, ``rsqrt_table_amd.npy``); the default
``--out`` is the table of this host's vendor.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np

SRC = r"""
#include <immintrin.h>
void rsqrt_hw(const float* x, float* y, long n) {
  for (long i = 0; i < n; i += 8)
    _mm256_storeu_ps(y + i, _mm256_rsqrt_ps(_mm256_loadu_ps(x + i)));
}
"""


def _hardware():
    cc = shutil.which("cc") or shutil.which("gcc")
    if cc is None:
        raise SystemExit("needs a host C compiler")
    tmp = tempfile.mkdtemp()
    src, lib = os.path.join(tmp, "rsqrt.c"), os.path.join(tmp, "rsqrt.so")
    with open(src, "w") as fp:
        fp.write(SRC)
    subprocess.run([cc, "-O2", "-mavx", "-shared", "-fPIC", src, "-o", lib],
                   check=True)
    so = ctypes.CDLL(lib)

    def run(x):
        x = np.ascontiguousarray(x, np.float32)
        pad = -x.size % 8
        x = np.concatenate([x, np.ones(pad, np.float32)])
        y = np.empty_like(x)
        so.rsqrt_hw(x.ctypes.data_as(ctypes.c_void_p),
                    y.ctypes.data_as(ctypes.c_void_p), ctypes.c_long(x.size))
        return y[:x.size - pad]
    return run


def table(hw) -> np.ndarray:
    """(8192,) uint16: the 12-bit mantissa of ``rsqrtps`` for the key
    (exponent's last bit, top 12 mantissa bits)."""
    bits = np.arange(0x3F800000, 0x40800000, dtype=np.uint32)  # [1, 4)
    y = hw(bits.view(np.float32)).view(np.uint32)
    key = (bits >> 11) & 0x1FFF
    if not ((y >> 23) == 126).all() or (y & 0x7FF).any():
        raise SystemExit("estimate outside [0.5, 1) or past 12 bits")
    tab = np.zeros(8192, np.uint32)
    tab[key] = y
    if not (tab[key] == y).all():
        raise SystemExit("the estimate depends on more than the key")
    return ((tab & 0x7FFFFF) >> 11).astype(np.uint16)


def check_scaling(hw, tab, n=1 << 22, seed=0):
    """Every positive normal float32's estimate from the table: the key's
    entry scaled by 2^-floor(E/2)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0x00800000, 0x7F800000, n, dtype=np.uint32)
    e = ((x >> 23) & 255).astype(np.int64) - 127
    key = (x >> 11) & 0x1FFF
    want = ((tab[key].astype(np.int64) << 11) | (126 << 23)) \
        - ((e >> 1) << 23)
    got = hw(x.view(np.float32)).view(np.uint32).astype(np.int64)
    return int((got != want).sum())


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=None,
                   help="default: the committed table of this host's "
                        "CPU vendor")
    args = p.parse_args(argv)
    if args.out is None:
        sys.path.insert(0, os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        from crowdnav_tpu_torch.utils import numerics as nm
        args.out = nm.rsqrt_table_path(nm.rsqrt_form())
    hw = _hardware()
    tab = table(hw)
    bad = check_scaling(hw, tab)
    if bad:
        raise SystemExit(f"{bad} estimates off the scaled table")
    np.save(args.out, tab)
    print(json.dumps({"out": args.out, "entries": int(tab.size),
                      "scaling_mismatches": bad}))


if __name__ == "__main__":
    main()
