// Lidar raycast for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_raycast_kernel` of
// crowdnav_tpu/ops/lidar_pallas.py (launched by `scan_batch_pallas`), in
// the two forms of the JAX package's lidar backends:
//   - the XLA form (lidar_backend="xla", the default, which the JAX
//     package's step runs): the arithmetic of `crowdnav_tpu/ops/lidar.scan`,
//     each beam's direction from the angle-addition identity against
//     per-beam tables; plain version `raycast_plain`;
//   - the Pallas form (lidar_backend="pallas"): the arithmetic of
//     `_raycast_kernel`, each beam's direction the C library's cos and sin
//     (libm_f32.cuh) of its angle fma(-i, deg, yaw), as the JAX package's
//     CPU reference computes it; plain version `raycast_pallas_plain`.
// Plain versions in crowdnav_tpu_torch/ops/lidar.py; each form agrees
// with its plain version bit for bit. The walls, the pedestrians and the
// clip are the same operations in both forms (the Pallas kernel's
// where(d >= 0, h, -h) equals sign(d) * h wherever |d| >= 1e-12).
//
// Per env and beam: the exit distance from inside the room [-h, h]^2, the
// minimum with the nearest forward hit on the P pedestrian circles, clipped
// to [min_range, max_range]. Inputs: pos (N,2), cos/sin of yaw (N), the
// beam tables (B), peds (N,P,2); output (N,B) float32, row-major.
//
// Numerics (crowdnav_tpu_torch/utils/numerics.py): built with -fmad=false,
// and fmaf only where the reference's compiler fuses a multiply-add; IEEE
// division and sqrtf. Constants (half, r^2, the range clip) come in as the
// float32 values the plain version uses.
//
// The Pallas form adds per beam the C library's sinf and cosf in double
// precision, from one shared argument reduction (libmf_sinf_cosf).
//
// Bound: about level between bytes and operations. At 16,384 envs x 359
// beams x 14 pedestrians the kernel writes 23.5 MB and reads 2.1 MB (7.6 us
// at 3.35 TB/s); the work these inputs need is ~85 flops per beam (15 for
// the direction, walls and clip, 5 per pedestrian) plus 3 per ray-circle
// hit, ~0.51 GFLOP (7.6 us at 67 TFLOP/s). What the SMs spend, though, is
// instruction slots: the ray-circle test of a (beam, pedestrian) pair is three
// floating-point instructions and a compare on the half-rate ALU pipe,
// and each wall is an IEEE division of a dozen instructions.
//
// Design: a thread takes R beams of one env (R = 2, 4 or 8, from the
// wrapper, kernels/launch.py): beams j, j + M, ..., j + (R-1) M with
// M = ceil(B / R), so that consecutive threads store consecutive floats
// for each of its R beams, and the R beams are independent chains; threads
// run over the flat (env, j) index, so no warp idles at a row's end (the
// R*M - B surplus slots are masked). A block touches at most
// ceil((threads - 1) / M) + 1 envs. It first puts in shared memory each
// env's pose and, per (env, pedestrian), the terms that do not depend on
// the beam: relx, rely and rel2 = relx^2 + rely^2, with the operations of
// the plain version in its order. A thread loads each pedestrian's terms
// once for its R beams (shared memory delivers 128 bytes a clock to an
// SM's lanes: one float4 load per beam and pedestrian cost more clocks
// than the arithmetic it fed). Per beam and pedestrian that leaves
// b = relx*dx + rely*dy, q = rel2 - b^2, and the test disc = r^2 - q >= 0
// (as q <= r^2, the same predicate without the subtraction), which sets a
// bit; the square root and the minimum run afterwards for the set bits
// only (b and q recomputed by the same operations, the hits taken in the
// same pedestrian order), since the root's result is used only there.
// A wall's distance a / f matters only if it is below max_range: every
// value at or above it is clipped to max_range, or loses the minimum to a
// nearer hit. Where a and f have one sign and
// |a| > |f| * max_range * (1 + 2^-20) (which, rounding included, puts the
// quotient above max_range), the division is skipped and the wall taken
// as +inf. (Two designs measured slower: one beam a thread with a branch
// around each pair's root, which cost a warp the root whenever any lane
// met that circle; and one env a block, culling the pedestrians that
// cannot meet a warp's 31-degree fan of beams, whose test cost more than
// the cheap pair tests it saved.)
#include <cuda_runtime.h>
#include <math.h>

#include "libm_f32.cuh"

namespace {

constexpr float kEps = 1e-12f;
constexpr float kAboveOne = 1.00000095367431640625f;  // 1 + 2^-20

// The distance to a wall along one axis, or +inf where the clip to
// max_range makes its value irrelevant (see the note above).
__device__ __forceinline__ float wall(float d, float p, float half,
                                      float range_up) {
  const bool small = fabsf(d) < kEps;
  const float f = small ? kEps : d;
  const float s = f > 0.f ? half : (f < 0.f ? -half : 0.f);
  const float a = s - p;
  const bool far = (a > 0.f) == (f > 0.f) && fabsf(a) > fabsf(f) * range_up;
  float t = __int_as_float(0x7f800000);
  if (!small && !far) t = a / f;
  return t;
}

// kPallas: the Pallas form; cos_yaw then holds the yaw, and sin_yaw and
// the beam tables are not read.
template <int R, bool kPallas>
__global__ void __launch_bounds__(512)
    raycast_kernel(const float2* __restrict__ pos,
                   const float* __restrict__ cos_yaw,
                   const float* __restrict__ sin_yaw,
                   const float* __restrict__ cos_beam,
                   const float* __restrict__ sin_beam,
                   const float2* __restrict__ peds, float* __restrict__ out,
                   int n_envs, int n_beams, int n_peds, float half, float r2,
                   float min_range, float max_range, float deg) {
  extern __shared__ float4 sm[];
  // the wrapper keeps n_envs * slots below 2^31
  const unsigned slots = (n_beams + R - 1) / R;  // threads per env
  const unsigned total = (unsigned)n_envs * slots;
  const unsigned first = blockIdx.x * blockDim.x;
  const unsigned last = min(first + blockDim.x, total) - 1;
  const int env_lo = first / slots;
  const int ne = last / slots - env_lo + 1;
  // (px, py, cos yaw, sin yaw) per env; (px, py, yaw, 0) in the Pallas form
  float4* env_s = sm;
  float2* rel_s = reinterpret_cast<float2*>(sm + ne);  // (relx, rely)
  float* rel2_s = reinterpret_cast<float*>(rel_s + ne * n_peds);
  for (int i = threadIdx.x; i < ne; i += blockDim.x) {
    const int e = env_lo + i;
    const float2 p = pos[e];
    env_s[i] =
        make_float4(p.x, p.y, cos_yaw[e], kPallas ? 0.f : sin_yaw[e]);
  }
  for (int i = threadIdx.x; i < ne * n_peds; i += blockDim.x) {
    const int e = env_lo + i / n_peds;
    const float2 p = pos[e];
    const float2 q = peds[(size_t)env_lo * n_peds + i];
    const float relx = q.x - p.x, rely = q.y - p.y;
    rel_s[i] = make_float2(relx, rely);
    rel2_s[i] = fmaf(relx, relx, rely * rely);
  }
  __syncthreads();

  const unsigned idx = first + threadIdx.x;
  if (idx > last) return;
  int le = 0;
  unsigned j = idx - (unsigned)env_lo * slots;
  while (j >= slots) {
    j -= slots;
    ++le;
  }
  const float4 ev = env_s[le];
  const float px = ev.x, py = ev.y, cy = ev.z, sy = ev.w;
  const float range_up = max_range * kAboveOne;
  float dx[R], dy[R], t[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int beam = min((int)(j + r * slots), n_beams - 1);
    if (kPallas) {
      const float ang = fmaf(-(float)beam, deg, cy);  // cy holds the yaw
      libmf_sinf_cosf(ang, &dy[r], &dx[r]);
    } else {
      const float ca = cos_beam[beam], sa = sin_beam[beam];
      dx[r] = fmaf(cy, ca, sy * sa);
      dy[r] = fmaf(sy, ca, -(cy * sa));
    }
    t[r] = fminf(wall(dx[r], px, half, range_up),
                 wall(dy[r], py, half, range_up));
  }
  // nearest forward hit on the pedestrian circles, 32 pedestrians at a
  // time: first the test of every (beam, pedestrian) pair into a bit mask,
  // then the root and the minimum for the pairs that meet
  const float2* rel = rel_s + le * n_peds;
  const float* rel2 = rel2_s + le * n_peds;
  for (int p0 = 0; p0 < n_peds; p0 += 32) {
    const int np = min(n_peds - p0, 32);
    unsigned hits[R];
#pragma unroll
    for (int r = 0; r < R; ++r) hits[r] = 0u;
    for (int p = 0; p < np; ++p) {
      const float2 q = rel[p0 + p];
      const float q2 = rel2[p0 + p];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float bb = fmaf(q.x, dx[r], q.y * dy[r]);
        const float m = fmaf(-bb, bb, q2);
        if (m <= r2) hits[r] |= 1u << p;  // disc = r2 - m >= 0
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      for (unsigned h = hits[r]; h != 0u; h &= h - 1u) {
        const int p = p0 + __ffs(h) - 1;
        const float2 q = rel[p];
        const float bb = fmaf(q.x, dx[r], q.y * dy[r]);
        const float m = fmaf(-bb, bb, rel2[p]);
        const float th = bb - sqrtf(r2 - m);
        if (th >= 0.f) t[r] = fminf(t[r], th);
      }
    }
  }
  float* row = out + (size_t)(env_lo + le) * n_beams;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int beam = j + r * slots;
    if (beam < n_beams) row[beam] = fminf(fmaxf(t[r], min_range), max_range);
  }
}

}  // namespace

namespace {

int launch_raycast(bool pallas, const float* pos, const float* cos_yaw,
                   const float* sin_yaw, const float* cos_beam,
                   const float* sin_beam, const float* peds, float* out,
                   int n_envs, int n_beams, int n_peds, int blocks,
                   int threads, int beams_per_thread, int smem_bytes,
                   float half, float r2, float min_range, float max_range,
                   float deg, void* stream) {
  if (n_envs == 0 || n_beams == 0) return 0;
  if (beams_per_thread != 2 && beams_per_thread != 4 &&
      beams_per_thread != 8) {
    return (int)cudaErrorInvalidValue;
  }
  const long long slots =
      (n_beams + beams_per_thread - 1) / beams_per_thread;
  if ((long long)n_envs * slots >= (1LL << 31) ||
      (long long)blocks * threads < (long long)n_envs * slots) {
    return (int)cudaErrorInvalidValue;
  }
  const float2* pos2 = reinterpret_cast<const float2*>(pos);
  const float2* peds2 = reinterpret_cast<const float2*>(peds);
  cudaStream_t st = (cudaStream_t)stream;
#define CROWDNAV_RAYCAST(R, P)                                               \
  raycast_kernel<R, P><<<blocks, threads, smem_bytes, st>>>(                 \
      pos2, cos_yaw, sin_yaw, cos_beam, sin_beam, peds2, out, n_envs,        \
      n_beams, n_peds, half, r2, min_range, max_range, deg)
  if (pallas) {
    switch (beams_per_thread) {
      case 2: CROWDNAV_RAYCAST(2, true); break;
      case 4: CROWDNAV_RAYCAST(4, true); break;
      default: CROWDNAV_RAYCAST(8, true); break;
    }
  } else {
    switch (beams_per_thread) {
      case 2: CROWDNAV_RAYCAST(2, false); break;
      case 4: CROWDNAV_RAYCAST(4, false); break;
      default: CROWDNAV_RAYCAST(8, false); break;
    }
  }
#undef CROWDNAV_RAYCAST
  return (int)cudaGetLastError();
}

}  // namespace

// The XLA form. blocks, threads, beams_per_thread, smem_bytes:
// raycast_launch (kernels/launch.py). Returns the launch's cudaError_t.
extern "C" int crowdnav_raycast(const float* pos, const float* cos_yaw,
                                const float* sin_yaw, const float* cos_beam,
                                const float* sin_beam, const float* peds,
                                float* out, int n_envs, int n_beams,
                                int n_peds, int blocks, int threads,
                                int beams_per_thread, int smem_bytes,
                                float half, float r2, float min_range,
                                float max_range, void* stream) {
  return launch_raycast(false, pos, cos_yaw, sin_yaw, cos_beam, sin_beam,
                        peds, out, n_envs, n_beams, n_peds, blocks, threads,
                        beams_per_thread, smem_bytes, half, r2, min_range,
                        max_range, 0.f, stream);
}

// The Pallas form: yaw (N) in place of the trig of the yaw and the beam
// tables; deg = f32(pi / 180).
extern "C" int crowdnav_raycast_pallas(const float* pos, const float* yaw,
                                       const float* peds, float* out,
                                       int n_envs, int n_beams, int n_peds,
                                       int blocks, int threads,
                                       int beams_per_thread, int smem_bytes,
                                       float half, float r2, float min_range,
                                       float max_range, float deg,
                                       void* stream) {
  return launch_raycast(true, pos, yaw, nullptr, nullptr, nullptr, peds,
                        out, n_envs, n_beams, n_peds, blocks, threads,
                        beams_per_thread, smem_bytes, half, r2, min_range,
                        max_range, deg, stream);
}
