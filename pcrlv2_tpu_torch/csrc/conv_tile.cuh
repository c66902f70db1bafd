// The 64x64 output tile of the slab-staged 3^3 conv prototype
// (proto_conv.cu, kernel #7): 256 threads, a 4x4 float micro-tile
// each; tile placement over the (b, d) planes, bias init, the FMA loop over
// a staged slab and the store.
#pragma once

#include "common.cuh"

namespace {

constexpr int BM = 64;   // output rows (voxels) per block
constexpr int BN = 64;   // output columns (channels) per block
constexpr int NT = 256;  // threads per block: a 16x16 grid of 4x4 micro-tiles
constexpr int NWARP = NT / 32;

// First float of the weight tile: after the slab, on a 16-byte boundary.
__device__ __forceinline__ int weight_offset(int slab_floats) {
  return (slab_floats + 3) & ~3;
}

// The tile's first plane and its first plane position.  P == 1: tile t is
// segment t % tpp (L consecutive positions) of plane t / tpp; P > 1: tile t
// is planes t*P .. t*P + P - 1, whole.
__device__ __forceinline__ void tile_origin(int t, int P, int L, int tpp,
                                            int* plane0, int* p0) {
  *plane0 = P == 1 ? t / tpp : t * P;
  *p0 = P == 1 ? (t % tpp) * L : 0;
}

template <typename T>
__device__ __forceinline__ void init_acc(float acc[4][4], const T* __restrict__ bias,
                                         int n0, int tx, int Co) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + tx * 4 + j;
    const float b0 = (bias != nullptr && n < Co) ? to_f(bias[n]) : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i][j] = b0;
  }
}

template <typename T>
__device__ __forceinline__ void store_out(T* __restrict__ out, const float acc[4][4],
                                          const long long obase[4], const bool rok[4],
                                          int n0, int tx, int Co) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!rok[i]) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < Co) out[obase[i] + n] = from_f<T>(acc[i][j]);
    }
  }
}

// acc[i][j] += sum_k a(rows[i] + k) * Bk[k][tx*4 + j], k < kn; A is a
// row-major slab with leading dimension lda.
__device__ __forceinline__ void fma_tile(float acc[4][4], const float* A,
                                         const int rows[4], int lda,
                                         const float* Bk, int kn, int tx) {
#pragma unroll 4
  for (int k = 0; k < kn; ++k) {
    float a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[rows[i] * lda + k];
    const float4 b = *reinterpret_cast<const float4*>(Bk + k * BN + tx * 4);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[i][0] = fmaf(a[i], b.x, acc[i][0]);
      acc[i][1] = fmaf(a[i], b.y, acc[i][1]);
      acc[i][2] = fmaf(a[i], b.z, acc[i][2]);
      acc[i][3] = fmaf(a[i], b.w, acc[i][3]);
    }
  }
}

}  // namespace
