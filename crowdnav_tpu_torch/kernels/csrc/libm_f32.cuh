// The C library's float sinf, cosf and atan2f, for the card and the host.
//
// The reference's env step runs on the CPU, where XLA calls the C library
// (GNU libc) for cos, sin and atan2 of float32 values; the port's plain
// code does the same (utils/numerics.py). CUDA's own sinf, cosf and
// atan2f are accurate to a few ulp but round differently, so the step on
// the card would drift from the reference by an ulp here and there, and
// the observation is rounded to 3 decimals downstream. These functions
// reproduce the library's algorithms operation for operation:
//
//   - sinf, cosf: GNU libc's sysdeps/ieee754/flt-32 (s_sinf.c, s_cosf.c,
//     sincosf.h, from ARM's optimized routines): the argument is taken to
//     double, reduced by a multiple of pi/2 (a double multiply-subtract up
//     to |x| < 120, a 32x96-bit integer product with a 192-bit table of
//     2/pi above), and the polynomial is evaluated in double. On x86-64
//     the library selects its build with fused multiply-adds when the CPU
//     has them (every x86-64 CPU with AVX2 does); the compiler then fuses
//     each a*b + c of the reduction and the polynomial, and so does the
//     code below (LIBMF_FMA = 1);
//   - atan2f: the fdlibm float routine (e_atan2f.c, s_atanf.c), in float
//     arithmetic with no fused multiply-add.
//
// Every operation is IEEE: the file is built with -fmad=false (nvcc) or
// -ffp-contract=off (a host compiler, for the tests), so that the only
// fused multiply-adds are the explicit fma() calls. The tests compile
// this header for the host and hold it against the C library bit for bit.
#pragma once

#include <math.h>
#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#define LIBMF_FN __host__ __device__ __forceinline__
#else
#define LIBMF_FN static inline
#endif

#ifndef LIBMF_FMA
#define LIBMF_FMA 1
#endif

// a*b + c as the library's build computes it
LIBMF_FN double libmf_madd(double a, double b, double c) {
#if LIBMF_FMA
  return fma(a, b, c);
#else
  return a * b + c;
#endif
}

LIBMF_FN uint32_t libmf_asuint(float x) {
  uint32_t u;
  memcpy(&u, &x, sizeof u);
  return u;
}

LIBMF_FN float libmf_asfloat(uint32_t u) {
  float x;
  memcpy(&x, &u, sizeof x);
  return x;
}

// top 12 bits of |x| (exponent and three mantissa bits)
LIBMF_FN uint32_t libmf_abstop12(float x) {
  return (libmf_asuint(x) >> 20) & 0x7ff;
}

// the two halves of sinf_poly of sincosf.h: the sine polynomial of x,
// and the cosine polynomial of x^2, `neg` selecting the second table,
// whose coefficients are negated
LIBMF_FN float libmf_sin_poly(double x, double x2) {
  const double s1 = -0x1.555545995a603p-3;
  const double s2 = 0x1.1107605230bc4p-7;
  const double s3 = -0x1.994eb3774cf24p-13;
  double x3 = x * x2;
  double p1 = libmf_madd(x2, s3, s2);
  double x7 = x3 * x2;
  double s = libmf_madd(x3, s1, x);
  return (float)libmf_madd(x7, p1, s);
}

LIBMF_FN float libmf_cos_poly(double x2, int neg) {
  const double c0 = neg ? -0x1p0 : 0x1p0;
  const double c1 = neg ? 0x1.ffffffd0c621cp-2 : -0x1.ffffffd0c621cp-2;
  const double c2 = neg ? -0x1.55553e1068f19p-5 : 0x1.55553e1068f19p-5;
  const double c3 = neg ? 0x1.6c087e89a359dp-10 : -0x1.6c087e89a359dp-10;
  const double c4 = neg ? -0x1.99343027bf8c3p-16 : 0x1.99343027bf8c3p-16;
  double x4 = x2 * x2;
  double q2 = libmf_madd(x2, c4, c3);
  double q1 = libmf_madd(x2, c1, c0);
  double x6 = x4 * x2;
  double c = libmf_madd(x4, c2, q1);
  return (float)libmf_madd(x6, q2, c);
}

// sinf_poly of sincosf.h: the sine polynomial for even n, else the cosine
LIBMF_FN float libmf_sincos_poly(double x, double x2, int neg, int n) {
  return (n & 1) == 0 ? libmf_sin_poly(x, x2) : libmf_cos_poly(x2, neg);
}

// reduce_fast of sincosf.h (the library's build without round-to-int
// instructions: 2/pi prescaled by 2^24, quadrant in bits 24..31)
LIBMF_FN double libmf_reduce_fast(double x, int *np) {
  const double hpi_inv = 0x1.45F306DC9C883p+23;
  const double hpi = 0x1.921FB54442D18p0;
  double r = x * hpi_inv;
  int n = ((int32_t)r + 0x800000) >> 24;
  *np = n;
  return libmf_madd(-(double)n, hpi, x);
}

// reduce_large of sincosf.h: xi is the float's bit pattern, |x| >= 120
LIBMF_FN double libmf_reduce_large(uint32_t xi, int *np) {
  // 2/pi to 192 bits, 8 new bits per entry
  const uint32_t inv_pio4[24] = {
      0xa2,       0xa2f9,     0xa2f983,   0xa2f9836e, 0xf9836e4e, 0x836e4e44,
      0x6e4e4415, 0x4e441529, 0x441529fc, 0x1529fc27, 0x29fc2757, 0xfc2757d1,
      0x2757d1f5, 0x57d1f534, 0xd1f534dd, 0xf534ddc0, 0x34ddc0db, 0xddc0db62,
      0xc0db6295, 0xdb629599, 0x6295993c, 0x95993c43, 0x993c4390, 0x3c439041};
  const double pi63 = 0x1.921FB54442D18p-62;
  const uint32_t *arr = &inv_pio4[(xi >> 26) & 15];
  int shift = (xi >> 23) & 7;
  uint64_t n, res0, res1, res2;
  xi = (xi & 0xffffff) | 0x800000;
  xi <<= shift;
  res0 = (uint32_t)(xi * arr[0]);
  res1 = (uint64_t)xi * arr[4];
  res2 = (uint64_t)xi * arr[8];
  res0 = (res2 >> 32) | (res0 << 32);
  res0 += res1;
  n = (res0 + (1ULL << 61)) >> 62;
  res0 -= n << 62;
  double x = (double)(int64_t)res0;
  *np = (int)n;
  return x * pi63;
}

// sign of the sine in quadrants 0..3: 1, -1, -1, 1
LIBMF_FN double libmf_quadrant_sign(int n) {
  return ((n & 3) == 1 || (n & 3) == 2) ? -1.0 : 1.0;
}

LIBMF_FN float libmf_sincosf(float y, int cosine) {
  double x = y;
  int n;
  uint32_t top = libmf_abstop12(y);
  if (top < 0x3f4) {  // |y| < abstop12(pi/4)
    if (top < 0x398)  // |y| < 2^-12
      return cosine ? 1.0f : y;
    return libmf_sincos_poly(x, x * x, 0, cosine);
  }
  if (top < 0x42f) {  // |y| < 120
    x = libmf_reduce_fast(x, &n);
    double s = libmf_quadrant_sign(n);
    return libmf_sincos_poly(x * s, x * x, (n & 2) != 0, n ^ cosine);
  }
  if (top < 0x7f8) {  // finite
    uint32_t xi = libmf_asuint(y);
    int sign = xi >> 31;
    x = libmf_reduce_large(xi, &n);
    double s = libmf_quadrant_sign(n + sign);
    return libmf_sincos_poly(x * s, x * x, ((n + sign) & 2) != 0,
                             n ^ cosine);
  }
  return (y - y) / (y - y);  // inf or nan
}

// sinf(y) and cosf(y) from one argument reduction: the values of
// libmf_sinf and libmf_cosf, operation for operation. Both polynomials
// are evaluated for every argument and the quadrant's parity picks which
// is the sine, so that the lanes of a warp do not diverge on it.
LIBMF_FN void libmf_sinf_cosf(float y, float *sin_out, float *cos_out) {
  uint32_t top = libmf_abstop12(y);
  if (top < 0x3f4) {  // |y| < abstop12(pi/4)
    if (top < 0x398) {  // |y| < 2^-12
      *sin_out = y;
      *cos_out = 1.0f;
      return;
    }
    double x = y;
    *sin_out = libmf_sin_poly(x, x * x);
    *cos_out = libmf_cos_poly(x * x, 0);
    return;
  }
  if (top < 0x42f) {  // |y| < 120
    int n;
    double x = libmf_reduce_fast(y, &n);
    double xs = x * libmf_quadrant_sign(n), x2 = x * x;
    float even = libmf_sin_poly(xs, x2);
    float odd = libmf_cos_poly(x2, (n & 2) != 0);
    *sin_out = (n & 1) == 0 ? even : odd;
    *cos_out = (n & 1) == 0 ? odd : even;
    return;
  }
  *sin_out = libmf_sincosf(y, 0);
  *cos_out = libmf_sincosf(y, 1);
}

LIBMF_FN float libmf_sinf(float y) { return libmf_sincosf(y, 0); }

LIBMF_FN float libmf_cosf(float y) { return libmf_sincosf(y, 1); }

// fdlibm's s_atanf.c
LIBMF_FN float libmf_atanf(float x) {
  const float atanhi[4] = {4.6364760399e-01f, 7.8539812565e-01f,
                           9.8279368877e-01f, 1.5707962513e+00f};
  const float atanlo[4] = {5.0121582440e-09f, 3.7748947079e-08f,
                           3.4473217170e-08f, 7.5497894159e-08f};
  const float aT[11] = {3.3333334327e-01f,  -2.0000000298e-01f,
                        1.4285714924e-01f,  -1.1111110449e-01f,
                        9.0908870101e-02f,  -7.6918758452e-02f,
                        6.6610731184e-02f,  -5.8335702866e-02f,
                        4.9768779427e-02f,  -3.6531571299e-02f,
                        1.6285819933e-02f};
  const float one = 1.0f, huge = 1.0e30f;
  float w, s1, s2, z;
  int32_t ix, hx, id;
  hx = (int32_t)libmf_asuint(x);
  ix = hx & 0x7fffffff;
  if (ix >= 0x4c000000) {  // |x| >= 2^25
    if (ix > 0x7f800000) return x + x;  // nan
    if (hx > 0) return atanhi[3] + atanlo[3];
    return -atanhi[3] - atanlo[3];
  }
  if (ix < 0x3ee00000) {  // |x| < 0.4375
    if (ix < 0x31000000) {  // |x| < 2^-29
      if (huge + x > one) return x;
    }
    id = -1;
  } else {
    x = fabsf(x);
    if (ix < 0x3f980000) {  // |x| < 1.1875
      if (ix < 0x3f300000) {  // 7/16 <= |x| < 11/16
        id = 0;
        x = (2.0f * x - one) / (2.0f + x);
      } else {  // 11/16 <= |x| < 19/16
        id = 1;
        x = (x - one) / (x + one);
      }
    } else {
      if (ix < 0x401c0000) {  // |x| < 2.4375
        id = 2;
        x = (x - 1.5f) / (one + 1.5f * x);
      } else {  // 2.4375 <= |x| < 2^25
        id = 3;
        x = -1.0f / x;
      }
    }
  }
  z = x * x;
  w = z * z;
  s1 = z * (aT[0] + w * (aT[2] + w * (aT[4] + w * (aT[6] + w * (aT[8] +
      w * aT[10])))));
  s2 = w * (aT[1] + w * (aT[3] + w * (aT[5] + w * (aT[7] + w * aT[9]))));
  if (id < 0) return x - x * (s1 + s2);
  z = atanhi[id] - ((x * (s1 + s2) - atanlo[id]) - x);
  return (hx < 0) ? -z : z;
}

// fdlibm's e_atan2f.c
LIBMF_FN float libmf_atan2f(float y, float x) {
  const float tiny = 1.0e-30f, pi_o_4 = 7.8539818525e-01f,
              pi_o_2 = 1.5707963705e+00f, pi = 3.1415927410e+00f,
              pi_lo = -8.7422776573e-08f;
  float z;
  int32_t k, m, hx, hy, ix, iy;
  hx = (int32_t)libmf_asuint(x);
  ix = hx & 0x7fffffff;
  hy = (int32_t)libmf_asuint(y);
  iy = hy & 0x7fffffff;
  if (ix > 0x7f800000 || iy > 0x7f800000) return x + y;  // nan
  if (hx == 0x3f800000) return libmf_atanf(y);  // x = 1
  m = ((hy >> 31) & 1) | ((hx >> 30) & 2);  // 2 sign(x) + sign(y)
  if (iy == 0) {
    switch (m) {
      case 0:
      case 1: return y;
      case 2: return pi + tiny;
      default: return -pi - tiny;
    }
  }
  if (ix == 0) return (hy < 0) ? -pi_o_2 - tiny : pi_o_2 + tiny;
  if (ix == 0x7f800000) {
    if (iy == 0x7f800000) {
      switch (m) {
        case 0: return pi_o_4 + tiny;
        case 1: return -pi_o_4 - tiny;
        case 2: return 3.0f * pi_o_4 + tiny;
        default: return -3.0f * pi_o_4 - tiny;
      }
    }
    switch (m) {
      case 0: return 0.0f;
      case 1: return -0.0f;
      case 2: return pi + tiny;
      default: return -pi - tiny;
    }
  }
  if (iy == 0x7f800000) return (hy < 0) ? -pi_o_2 - tiny : pi_o_2 + tiny;
  k = (iy - ix) >> 23;
  if (k > 60) {
    z = pi_o_2 + 0.5f * pi_lo;  // |y/x| > 2^60
  } else if (hx < 0 && k < -60) {
    z = 0.0f;  // |y|/x < -2^60
  } else {
    z = libmf_atanf(fabsf(y / x));
  }
  switch (m) {
    case 0: return z;
    case 1: return libmf_asfloat(libmf_asuint(z) ^ 0x80000000u);
    case 2: return pi - (z - pi_lo);
    default: return (z - pi_lo) - pi;
  }
}
