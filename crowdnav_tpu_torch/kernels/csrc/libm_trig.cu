// Elementwise cosf, sinf and atan2f of the C library, on the card.
//
// Replaces no TPU kernel: it stands in for the C library calls that the
// reference's jitted env step makes on the CPU (jnp.cos, jnp.sin and
// jnp.arctan2 of float32 values in crowdnav_tpu/envs/world.py,
// crowdnav_tpu/ops/lidar.py, crowdnav_tpu/ops/geom.py and
// crowdnav_tpu/envs/crowd_env.py). The arithmetic is libm_f32.cuh's, which
// the CPU tests hold against the host's C library bit for bit; the plain
// version is that C library itself (utils/numerics.py on CPU tensors).
//
// Bound: launch latency. The step calls these on (N,) vectors: at 16,384
// envs a call reads 64 KB and writes 64 KB (0.04 us at 3.35 TB/s) and does
// about 25 double operations per element (0.01 us at the 34 TFLOP/s float64
// rate outside the tensor cores). Design: one thread an element, a
// grid-stride loop; the argument reduction and the polynomial run in
// double, as the library's do.
#include <cuda_runtime.h>

#include "libm_f32.cuh"

namespace {

__global__ void sincos_kernel(const float* __restrict__ x,
                              float* __restrict__ out, int n, int cosine) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    out[i] = libmf_sincosf(x[i], cosine);
  }
}

__global__ void atan2_kernel(const float* __restrict__ y,
                             const float* __restrict__ x,
                             float* __restrict__ out, int n) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    out[i] = libmf_atan2f(y[i], x[i]);
  }
}

}  // namespace

// cosine != 0: cosf, else sinf, of n floats
extern "C" int crowdnav_libm_sincos(const float* x, float* out, int n,
                                    int cosine, int blocks, int threads,
                                    void* stream) {
  if (n == 0) return 0;
  sincos_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(x, out, n,
                                                              cosine);
  return (int)cudaGetLastError();
}

extern "C" int crowdnav_libm_atan2(const float* y, const float* x,
                                   float* out, int n, int blocks,
                                   int threads, void* stream) {
  if (n == 0) return 0;
  atan2_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(y, x, out, n);
  return (int)cudaGetLastError();
}
