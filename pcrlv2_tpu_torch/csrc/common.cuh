// Helpers shared by the port's kernels: float/bf16 conversion, the
// fixed-order sum of per-block partials that ends each two-pass reduction,
// and the opt-in to more than 48 KB of dynamic shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// out[i] = sum_s partial[s, i], s in increasing order (deterministic).
__global__ void sum_partials_kernel(const float* __restrict__ partial,
                                    float* __restrict__ out, int S, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc = 0.f;
  for (int s = 0; s < S; ++s) acc += partial[(long long)s * n + i];
  out[i] = acc;
}

// Launches sum_partials_kernel over partial (S, n) into out (n); returns the
// launch's CUDA error code.
inline int sum_partials(const float* partial, float* out, int S, long long n,
                        cudaStream_t stream) {
  sum_partials_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(partial, out, S, n);
  return (int)cudaGetLastError();
}

// Allow `kernel` the dynamic shared memory `smem` (above the default 48 KB
// only after this call); returns a CUDA error code.
template <typename K>
int prepare(K kernel, size_t smem) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace
