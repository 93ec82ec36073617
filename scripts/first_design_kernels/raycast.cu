// First design of this kernel, kept unchanged as a timing baseline:
// chip_smoke.py builds it beside crowdnav_tpu_torch/kernels/csrc/raycast.cu
// and reports its device time as first_design_device_ms_*.
//
// Lidar raycast for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_raycast_kernel` of
// crowdnav_tpu/ops/lidar_pallas.py (launched by `scan_batch_pallas`), but
// follows the arithmetic of the XLA function `crowdnav_tpu/ops/lidar.scan`,
// which the JAX package's step actually runs: each beam's direction comes
// from the angle-addition identity against per-beam tables, not from a
// direct cos(yaw - i deg). The plain version is `raycast_plain` in
// crowdnav_tpu_torch/ops/lidar.py; the two agree bit for bit.
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
// Bound: at 16,384 envs x 359 beams x 14 pedestrians the kernel writes
// 23.5 MB (7 us at 3.35 TB/s) and reads < 2 MB; it does ~82 M ray-circle
// tests of ~15 flops and one sqrtf each, about 1.3 GFLOP plus the
// divisions, so memory and arithmetic are of the same order (tens of us).
// Design: one block per env; its pedestrian centres are staged once in
// shared memory, and each thread walks the beams with stride blockDim, so
// neighbouring threads write neighbouring floats of the output row.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kEps = 1e-12f;

__global__ void raycast_kernel(const float* __restrict__ pos,
                               const float* __restrict__ cos_yaw,
                               const float* __restrict__ sin_yaw,
                               const float* __restrict__ cos_beam,
                               const float* __restrict__ sin_beam,
                               const float* __restrict__ peds,
                               float* __restrict__ out, int n_beams,
                               int n_peds, float half, float r2,
                               float min_range, float max_range) {
  extern __shared__ float2 ped_s[];
  const int env = blockIdx.x;
  const float2* ped_env =
      reinterpret_cast<const float2*>(peds) + (size_t)env * n_peds;
  for (int i = threadIdx.x; i < n_peds; i += blockDim.x) ped_s[i] = ped_env[i];
  __syncthreads();

  const float px = pos[2 * env], py = pos[2 * env + 1];
  const float cy = cos_yaw[env], sy = sin_yaw[env];
  const float inf = __int_as_float(0x7f800000);
  float* row = out + (size_t)env * n_beams;
  for (int b = threadIdx.x; b < n_beams; b += blockDim.x) {
    const float ca = cos_beam[b], sa = sin_beam[b];
    const float dx = fmaf(cy, ca, sy * sa);
    const float dy = fmaf(sy, ca, -(cy * sa));
    // wall exit distance
    const bool small_x = fabsf(dx) < kEps, small_y = fabsf(dy) < kEps;
    const float fx = small_x ? kEps : dx, fy = small_y ? kEps : dy;
    const float sx = fx > 0.f ? half : (fx < 0.f ? -half : 0.f);
    const float sgy = fy > 0.f ? half : (fy < 0.f ? -half : 0.f);
    float tx = (sx - px) / fx, ty = (sgy - py) / fy;
    tx = small_x ? inf : tx;
    ty = small_y ? inf : ty;
    float t = fminf(tx, ty);
    // nearest forward hit on the pedestrian circles
    for (int p = 0; p < n_peds; ++p) {
      const float relx = ped_s[p].x - px, rely = ped_s[p].y - py;
      const float bb = fmaf(relx, dx, rely * dy);
      const float rel2 = fmaf(relx, relx, rely * rely);
      const float disc = r2 - fmaf(-bb, bb, rel2);
      const float th = bb - sqrtf(fmaxf(disc, 0.f));
      if (disc >= 0.f && th >= 0.f) t = fminf(t, th);
    }
    row[b] = fminf(fmaxf(t, min_range), max_range);
  }
}

}  // namespace

extern "C" int crowdnav_raycast(const float* pos, const float* cos_yaw,
                                const float* sin_yaw, const float* cos_beam,
                                const float* sin_beam, const float* peds,
                                float* out, int n_envs, int n_beams,
                                int n_peds, float half, float r2,
                                float min_range, float max_range,
                                void* stream) {
  if (n_envs == 0) return 0;
  const int threads = 128;
  const size_t smem = sizeof(float2) * (size_t)(n_peds > 0 ? n_peds : 1);
  raycast_kernel<<<n_envs, threads, smem, (cudaStream_t)stream>>>(
      pos, cos_yaw, sin_yaw, cos_beam, sin_beam, peds, out, n_beams, n_peds,
      half, r2, min_range, max_range);
  return (int)cudaGetLastError();
}
