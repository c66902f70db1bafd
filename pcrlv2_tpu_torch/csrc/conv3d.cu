// SAME 3x3x3 conv3d for Hopper (sm_90a): forward (also used for dx) and the
// filter gradient.  Channels-last NDHWC activations, weights repacked by the
// caller to (27*Ci, Co) row-major with row = tap*Ci + ci, tap = 9*td+3*th+tw.
//
// Replaces the Pallas TPU kernels pcrlv2_tpu/ops/pallas_conv.py::_fwd_kernel
// (forward; dx on flipped, io-swapped weights) and ::_dw_kernel (filter grad).
//
// Bound on the H100: at the model's widths every launch is operation-bound
// (K = 27*Ci is 27..13824 deep and Co is 32..512 wide; the operand bytes are
// a few MB against GFLOPs of work), so the figure of merit is FMA rate.
// Design: an implicit GEMM with no im2col buffer and no padded copy of x.
// A 64x64 output tile per block, K walked in chunks of 16; the A tile is
// gathered straight from x with the SAME halo handled by bounds checks, so
// Ci=1 (the stem), W down to 1 and K up to 27*512 all take the same path.
// Both operands are widened to float in shared memory and each thread
// accumulates a 4x4 micro-tile in float registers.  This is the simple, right
// first version: no tensor cores (wgmma), no TMA, no double buffering.
//
// The filter gradient sums over every output voxel.  The TPU grid summed
// sequentially into one block; GPU blocks run in no order, so the sum is
// split into S voxel chunks, each block writes its chunk's partial (27*Ci, Co)
// tile, and a second launch adds the S partials in a fixed order.  No atomics:
// the result is the same on every run.

#include "common.cuh"

namespace {

constexpr int BM = 64;   // output rows (voxels, or dw rows 27*Ci) per block
constexpr int BN = 64;   // output columns (channels) per block
constexpr int BK = 16;   // reduction chunk
constexpr int NT = 256;  // threads per block: a 16x16 grid of 4x4 micro-tiles

// out[m, n] = bias[n] + sum_k A[m, k] * wt[k, n]; m = voxel (b, d, h, w),
// k = tap*Ci + ci, A[m, k] = x[b, d+td-1, h+th-1, w+tw-1, ci] (0 outside).
template <typename T>
__global__ void __launch_bounds__(NT)
conv3d_fwd_kernel(const T* __restrict__ x, const T* __restrict__ wt,
                  const T* __restrict__ bias, T* __restrict__ out,
                  int B, int D, int H, int W, int Ci, int Co) {
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN];
  const int tid = threadIdx.x;
  const long long M = (long long)B * D * H * W;
  const int K = 27 * Ci;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // A gather: this thread always loads column ak of rows tid/BK + 16*r.
  const int ak = tid % BK;
  int vb[4], vd[4], vh[4], vw[4];
  bool vok[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    long long m = m0 + tid / BK + 16 * r;
    vok[r] = m < M;
    long long t = vok[r] ? m : 0;
    vw[r] = (int)(t % W); t /= W;
    vh[r] = (int)(t % H); t /= H;
    vd[r] = (int)(t % D);
    vb[r] = (int)(t / D);
  }

  const int tx = tid % 16, ty = tid / 16;
  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    int n = n0 + tx * 4 + j;
    float b0 = (bias != nullptr && n < Co) ? to_f(bias[n]) : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i][j] = b0;
  }

  for (int k0 = 0; k0 < K; k0 += BK) {
    const int kk = k0 + ak;
    const bool kok = kk < K;
    const int tap = kok ? kk / Ci : 0;
    const int ci = kk - tap * Ci;
    const int td = tap / 9, th = (tap / 3) % 3, tw = tap % 3;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float v = 0.f;
      const int sd = vd[r] + td - 1, sh = vh[r] + th - 1, sw = vw[r] + tw - 1;
      if (vok[r] && kok && sd >= 0 && sd < D && sh >= 0 && sh < H && sw >= 0 && sw < W) {
        long long off = ((((long long)vb[r] * D + sd) * H + sh) * W + sw) * Ci + ci;
        v = to_f(x[off]);
      }
      As[ak][tid / BK + 16 * r] = v;
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int e = tid + NT * r;
      const int bk = e / BN, bn = e % BN;
      const int k = k0 + bk, n = n0 + bn;
      Bs[bk][bn] = (k < K && n < Co) ? to_f(wt[(long long)k * Co + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[k][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < Co) out[m * Co + n] = from_f<T>(acc[i][j]);
    }
  }
}

// partial[s, r, n] = sum over voxels m of chunk s of A[m, r] * g[m, n], where
// r = tap*Ci + ci and A[m, r] = x[b, d+td-1, h+th-1, w+tw-1, ci] (0 outside).
template <typename T>
__global__ void __launch_bounds__(NT)
conv3d_dw_partial_kernel(const T* __restrict__ x, const T* __restrict__ g,
                         float* __restrict__ partial, int B, int D, int H,
                         int W, int Ci, int Co, long long chunk) {
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN];
  const int tid = threadIdx.x;
  const long long M = (long long)B * D * H * W;
  const int R = 27 * Ci;
  const int r0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const long long mbeg = (long long)blockIdx.z * chunk;
  const long long mend = mbeg + chunk < M ? mbeg + chunk : M;

  // x gather: this thread always loads row ar (fixed tap and channel).
  const int ar = tid % BM;
  const int r = r0 + ar;
  const bool rok = r < R;
  const int tap = rok ? r / Ci : 0;
  const int ci = r - tap * Ci;
  const int td = tap / 9, th = (tap / 3) % 3, tw = tap % 3;

  const int tx = tid % 16, ty = tid / 16;
  float acc[4][4] = {};

  for (long long mc = mbeg; mc < mend; mc += BK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = tid / BM + 4 * i;
      const long long m = mc + k;
      float v = 0.f;
      if (rok && m < mend) {
        long long t = m;
        const int w = (int)(t % W); t /= W;
        const int h = (int)(t % H); t /= H;
        const int d = (int)(t % D);
        const int b = (int)(t / D);
        const int sd = d + td - 1, sh = h + th - 1, sw = w + tw - 1;
        if (sd >= 0 && sd < D && sh >= 0 && sh < H && sw >= 0 && sw < W)
          v = to_f(x[((((long long)b * D + sd) * H + sh) * W + sw) * Ci + ci]);
      }
      As[k][ar] = v;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = tid + NT * i;
      const int bk = e / BN, bn = e % BN;
      const long long m = mc + bk;
      const int n = n0 + bn;
      Bs[bk][bn] = (m < mend && n < Co) ? to_f(g[m * Co + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[k][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* dst = partial + (long long)blockIdx.z * R * Co;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int rr = r0 + ty * 4 + i;
    if (rr >= R) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < Co) dst[(long long)rr * Co + n] = acc[i][j];
    }
  }
}

template <typename T>
int launch_fwd(const void* x, const void* wt, const void* bias, void* out,
               int B, int D, int H, int W, int Ci, int Co, void* stream) {
  const long long M = (long long)B * D * H * W;
  dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((Co + BN - 1) / BN));
  conv3d_fwd_kernel<T><<<grid, NT, 0, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)wt, (const T*)bias, (T*)out, B, D, H, W, Ci, Co);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dw(const void* x, const void* g, void* partial, void* out, int B,
              int D, int H, int W, int Ci, int Co, int S, long long chunk,
              void* stream) {
  const int R = 27 * Ci;
  dim3 grid((unsigned)((R + BM - 1) / BM), (unsigned)((Co + BN - 1) / BN), (unsigned)S);
  conv3d_dw_partial_kernel<T><<<grid, NT, 0, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)g, (float*)partial, B, D, H, W, Ci, Co, chunk);
  int err = (int)cudaGetLastError();
  if (err) return err;
  return sum_partials((const float*)partial, (float*)out, S, (long long)R * Co,
                      (cudaStream_t)stream);
}

}  // namespace

extern "C" {

int conv3d_fwd_f32(const void* x, const void* wt, const void* bias, void* out,
                   int B, int D, int H, int W, int Ci, int Co, void* stream) {
  return launch_fwd<float>(x, wt, bias, out, B, D, H, W, Ci, Co, stream);
}

int conv3d_fwd_bf16(const void* x, const void* wt, const void* bias, void* out,
                    int B, int D, int H, int W, int Ci, int Co, void* stream) {
  return launch_fwd<__nv_bfloat16>(x, wt, bias, out, B, D, H, W, Ci, Co, stream);
}

int conv3d_dw_f32(const void* x, const void* g, void* partial, void* out, int B,
                  int D, int H, int W, int Ci, int Co, int S, long long chunk,
                  void* stream) {
  return launch_dw<float>(x, g, partial, out, B, D, H, W, Ci, Co, S, chunk, stream);
}

int conv3d_dw_bf16(const void* x, const void* g, void* partial, void* out, int B,
                   int D, int H, int W, int Ci, int Co, int S, long long chunk,
                   void* stream) {
  return launch_dw<__nv_bfloat16>(x, g, partial, out, B, D, H, W, Ci, Co, S, chunk,
                                  stream);
}

}  // extern "C"
