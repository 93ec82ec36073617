"""The C-library trig of the card (``kernels/csrc/libm_f32.cuh``) against
the host's C library, bit for bit.

The header is plain C under a host compiler, so this test builds it with
``cc`` (``-ffp-contract=off``: the only fused multiply-adds are the
header's explicit ``fma`` calls, as under ``nvcc -fmad=false``) and compares
``sinf``, ``cosf`` and ``atan2f`` with the host's GNU libc on every float32
of the env step's ranges and on random bit patterns of every finite float.
GNU libc on x86-64 selects its build of ``sinf``/``cosf`` with fused
multiply-adds where the CPU has FMA and AVX2; the header's default
(``LIBMF_FMA=1``) is that build, and on a CPU without them the test
compiles the other. The card's kernel (``libm_trig.cu``) runs the same
header; ``chip_smoke.py``'s ``step_parity`` phase holds the card against
the card host's C library."""
import os
import shutil
import subprocess

import pytest
import torch

from crowdnav_tpu_torch.utils import numerics as nm

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEADER = os.path.join(ROOT, "crowdnav_tpu_torch", "kernels", "csrc",
                      "libm_f32.cuh")

HARNESS = r"""
#include <stdio.h>
#include <stdlib.h>
#include HEADER_PATH

static int differ(float a, float b) {
  if (isnan(a) && isnan(b)) return 0;
  return libmf_asuint(a) != libmf_asuint(b);
}

static uint64_t mix(uint64_t z) {
  z += 0x9e3779b97f4a7c15ULL;
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
  return z ^ (z >> 31);
}

int main(void) {
  long long bad[3] = {0, 0, 0}, n = 0;
  /* the env step's ranges (headings, angular rates, goal offsets):
     every float32 of magnitude in [0.5, 8], every 64th below 0.5 */
  for (uint32_t u = 0; u <= 0x41000000u; u += (u < 0x3f000000u ? 64 : 1)) {
    for (int s = 0; s < 2; s++) {
      float x = libmf_asfloat(u | (s ? 0x80000000u : 0u));
      bad[0] += differ(libmf_sinf(x), sinf(x));
      bad[1] += differ(libmf_cosf(x), cosf(x));
      bad[2] += differ(libmf_atan2f(x, 1.0f), atan2f(x, 1.0f));
      n++;
    }
  }
  /* random bit patterns of every exponent, and random pairs */
  for (uint64_t i = 0; i < (1u << 22); i++) {
    uint64_t r = mix(i);
    float y = libmf_asfloat((uint32_t)r);
    float x = libmf_asfloat((uint32_t)(r >> 32));
    bad[0] += differ(libmf_sinf(y), sinf(y));
    bad[1] += differ(libmf_cosf(y), cosf(y));
    bad[2] += differ(libmf_atan2f(y, x), atan2f(y, x));
    float sy = ((int32_t)(uint32_t)r) * 0x1p-29f;
    float sx = ((int32_t)(uint32_t)(r >> 32)) * 0x1p-29f;
    bad[2] += differ(libmf_atan2f(sy, sx), atan2f(sy, sx));
    n++;
  }
  printf("%lld %lld %lld %lld\n", n, bad[0], bad[1], bad[2]);
  return 0;
}
"""


def _host_has_fma():
    try:
        with open("/proc/cpuinfo") as fp:
            flags = next((line.split(":", 1)[1].split()
                          for line in fp if line.startswith("flags")), [])
    except OSError:
        return True
    return "fma" in flags and "avx2" in flags


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    cc = shutil.which("cc") or shutil.which("gcc")
    if cc is None:
        pytest.skip("needs a host C compiler to build libm_f32.cuh")
    d = tmp_path_factory.mktemp("libm")
    src, exe = d / "harness.c", d / "harness"
    src.write_text(HARNESS)
    fma = "1" if _host_has_fma() else "0"
    subprocess.run([cc, "-O2", "-std=c11", "-ffp-contract=off",
                    f"-DLIBMF_FMA={fma}", f'-DHEADER_PATH="{HEADER}"',
                    "-o", str(exe), str(src), "-lm"], check=True,
                   capture_output=True, timeout=120)
    out = subprocess.run([str(exe)], check=True, capture_output=True,
                         text=True, timeout=300).stdout.split()
    return dict(zip(("n", "sinf", "cosf", "atan2f"), map(int, out)))


@pytest.mark.parametrize("name", ["sinf", "cosf", "atan2f"])
def test_header_equals_the_c_library(harness, name):
    assert harness["n"] > 4_000_000
    assert harness[name] == 0, f"{name}: {harness[name]} inputs differ"


def test_numerics_trig_is_the_c_library_on_cpu():
    """On CPU tensors ``nm.cos``/``nm.sin``/``nm.atan2`` are the C
    library's float functions, which the header reproduces."""
    import ctypes
    import ctypes.util
    lib = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
    for name in ("cosf", "sinf", "atan2f"):
        getattr(lib, name).restype = ctypes.c_float
    lib.cosf.argtypes = lib.sinf.argtypes = [ctypes.c_float]
    lib.atan2f.argtypes = [ctypes.c_float, ctypes.c_float]
    g = torch.Generator().manual_seed(3)
    x = (torch.rand(64, generator=g) * 2 - 1) * 7
    y = x.flip(0)
    xs, ys = x.tolist(), y.tolist()
    assert torch.equal(nm.cos(x), torch.tensor([lib.cosf(v) for v in xs]))
    assert torch.equal(nm.sin(x), torch.tensor([lib.sinf(v) for v in xs]))
    assert torch.equal(nm.atan2(y, x), torch.tensor(
        [lib.atan2f(a, b) for a, b in zip(ys, xs)]))


PAIR_HARNESS = r"""
#include <stdio.h>
#include <stdlib.h>
#include HEADER_PATH

static uint64_t mix(uint64_t z) {
  z += 0x9e3779b97f4a7c15ULL;
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
  return z ^ (z >> 31);
}

static long long check(float x, long long *bad) {
  float s, c;
  libmf_sinf_cosf(x, &s, &c);
  float s1 = libmf_sinf(x), c1 = libmf_cosf(x);
  int nan_s = isnan(s) && isnan(s1), nan_c = isnan(c) && isnan(c1);
  *bad += (!nan_s && libmf_asuint(s) != libmf_asuint(s1))
          + (!nan_c && libmf_asuint(c) != libmf_asuint(c1))
          + (!nan_s && libmf_asuint(s) != libmf_asuint(sinf(x)))
          + (!nan_c && libmf_asuint(c) != libmf_asuint(cosf(x)));
  return 1;
}

int main(void) {
  long long bad = 0, n = 0;
  /* every float32 of magnitude up to 10 (the raycast's beam angles lie
     in (-9.5, 3.2]), every 16th below 2^-12, both signs */
  for (uint32_t u = 0; u <= 0x41200000u; u += (u < 0x39800000u ? 16 : 1))
    for (int s = 0; s < 2; s++)
      n += check(libmf_asfloat(u | (s ? 0x80000000u : 0u)), &bad);
  for (uint64_t i = 0; i < (1u << 21); i++)   /* every exponent */
    n += check(libmf_asfloat((uint32_t)mix(i)), &bad);
  printf("%lld %lld\n", n, bad);
  return 0;
}
"""


def test_sin_cos_pair_equals_the_two_calls_and_the_c_library(tmp_path):
    """``libmf_sinf_cosf`` (one argument reduction for both, as the
    raycast's Pallas form calls it) gives ``libmf_sinf`` and
    ``libmf_cosf`` bit for bit, and the host's C library's: on every
    float32 of magnitude up to 10 and on random bit patterns."""
    cc = shutil.which("cc") or shutil.which("gcc")
    if cc is None:
        pytest.skip("needs a host C compiler to build libm_f32.cuh")
    src, exe = tmp_path / "pair.c", tmp_path / "pair"
    src.write_text(PAIR_HARNESS)
    fma = "1" if _host_has_fma() else "0"
    subprocess.run([cc, "-O2", "-std=c11", "-ffp-contract=off",
                    f"-DLIBMF_FMA={fma}", f'-DHEADER_PATH="{HEADER}"',
                    "-o", str(exe), str(src), "-lm"], check=True,
                   capture_output=True, timeout=120)
    n, bad = map(int, subprocess.run(
        [str(exe)], check=True, capture_output=True, text=True,
        timeout=600).stdout.split())
    assert n > 100_000_000
    assert bad == 0, f"{bad} results differ"
