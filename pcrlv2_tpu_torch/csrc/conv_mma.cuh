// Pieces shared by the tensor-core kernels (conv3d.cu, #1 and #2; the slab
// template slab_conv.cuh of conv3d_packed.cu, #5 and #6, and proto_conv.cu,
// #7; proto_co1.cu's banded product, #9): the PTX helpers (16-byte cp.async
// with zero fill, ldmatrix, mma.sync m16n8k16 bf16 with f32 accumulation)
// and the second pass of a K-split forward, which adds the splits' f32
// partials in order with the bias and casts once.
#pragma once

#include "common.cuh"

namespace {

typedef __nv_bfloat16 bf16;

// ---------------------------------------------------------------------------
// PTX helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared async copy; with valid false the 16 bytes are
// zero-filled and nothing is read (src must still be a mapped address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
// c += a (16x16, row) * b (16x8, col), bf16 operands, f32 accumulator
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// mma fragments of one 16-deep step: A (MI tiles of 16 rows) and B (NI
// tiles of 8 columns).  B is stored k-major (k rows of n), read transposed.
// A is stored row-major (rows of k) when A_KMAJOR is false, else k-major.
template <int MI, int NI, bool A_KMAJOR>
__device__ __forceinline__ void mma_step(float (&acc)[MI][NI][4], const bf16* a, int lda,
                                         const bf16* b, int ldb, int lane) {
  unsigned af[MI][4], bfr[NI][2];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
    if (A_KMAJOR)
      ldsm_x4_trans(af[mi], a + ((lane & 7) + (lane >> 4) * 8) * lda + mi * 16 +
                                ((lane >> 3) & 1) * 8);
    else
      ldsm_x4(af[mi], a + (mi * 16 + (lane & 15)) * lda + (lane >> 4) * 8);
  }
#pragma unroll
  for (int nj = 0; nj < NI / 2; ++nj) {
    unsigned r[4];
    ldsm_x4_trans(r, b + ((lane & 7) + ((lane >> 3) & 1) * 8) * ldb + nj * 16 + (lane >> 4) * 8);
    bfr[2 * nj][0] = r[0];
    bfr[2 * nj][1] = r[1];
    bfr[2 * nj + 1][0] = r[2];
    bfr[2 * nj + 1][1] = r[3];
  }
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) mma_bf16(acc[mi][ni], af[mi], bfr[ni][0], bfr[ni][1]);
}

__device__ __forceinline__ bool in_grid(int d, int h, int w, int D, int H, int W) {
  return (unsigned)d < (unsigned)D && (unsigned)h < (unsigned)H && (unsigned)w < (unsigned)W;
}

// out[i] = bias[i % Co] + sum_s partial[s, i], s in increasing order, cast
// once: the second pass of a K-split forward.
template <typename T>
__global__ void conv3d_fwd_kernel_splitsum(const float* __restrict__ partial,
                                           const T* __restrict__ bias, T* __restrict__ out,
                                           int S, long long n, int Co) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc = bias != nullptr ? to_f(bias[i % Co]) : 0.f;
  for (int s = 0; s < S; ++s) acc += partial[(long long)s * n + i];
  out[i] = from_f<T>(acc);
}

}  // namespace
