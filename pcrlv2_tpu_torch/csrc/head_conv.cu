// Co=1 SAME 3x3x3 conv for Hopper (sm_90a): the deep-supervision mask heads.
// Forward and a fused backward (dx and the filter gradient in one pass).
// x is NDHWC (B, D, H, W, Ci); the kernel is flattened to k (Ci, 27) with
// tap t = 9*td + 3*th + tw; the output and its cotangent are (B, D, H, W).
//
// Replaces the Pallas TPU kernels pcrlv2_tpu/ops/head_conv.py::_pallas_kernel
// (forward) and ::_pallas_bwd_kernel (fused backward).
//
// Bound on the H100: memory.  Each output voxel is a 27*Ci dot product with
// one output, 54 FLOPs per input element, well under the card's
// FLOP-per-byte balance, so the least time is reading x (and writing dx).
// Design: a block owns a TH x TW tile of one depth plane (128 voxels, one per
// thread; TW follows W so narrow planes keep every thread busy).  The forward
// stages the tile's (3, TH+2, TW+2) halo slab of x in shared memory, 16
// channels at a time, so x is read from device memory about (TH+2)(TW+2)*3 /
// (TH*TW) times instead of 27 times.  The backward stages the g halo once per
// tile, gathers each voxel's 27 shifted cotangents into shared memory, then
// per 16-channel chunk writes dx (coalesced along channels) and adds the
// tile's x^T.g27 product to a per-block dK accumulator in shared memory.
// Blocks stride over the tiles in a fixed order; each writes its dK partial,
// and a second launch adds the partials in a fixed order (no atomics, so dK
// is the same on every run).

#include "common.cuh"

namespace {

constexpr int HT = 128;   // threads = voxels per tile
constexpr int CC = 16;    // channel chunk
constexpr int SLAB = 204; // max (TH+2)*(TW+2) over the tile shapes below

// Tile width follows W (32, 16, 8 or 4) and TH = 128 / TW.
__host__ __device__ inline int tile_w(int W) {
  return W >= 32 ? 32 : W >= 16 ? 16 : W >= 8 ? 8 : 4;
}

struct Tile { int b, d, h0, w0; };

__device__ __forceinline__ Tile tile_of(long long idx, int D, int H, int W,
                                        int TH, int TW) {
  const int tiles_w = (W + TW - 1) / TW, tiles_h = (H + TH - 1) / TH;
  Tile t;
  t.w0 = (int)(idx % tiles_w) * TW; idx /= tiles_w;
  t.h0 = (int)(idx % tiles_h) * TH; idx /= tiles_h;
  t.d = (int)(idx % D);
  t.b = (int)(idx / D);
  return t;
}

// out[b, d, h, w] = sum_{c, t} x[b, d+td-1, h+th-1, w+tw-1, c] * k[c, t]
template <typename T>
__global__ void __launch_bounds__(HT)
head_fwd_kernel(const T* __restrict__ x, const T* __restrict__ k,
                T* __restrict__ out, int B, int D, int H, int W, int Ci) {
  __shared__ float xs[CC][3][SLAB];
  __shared__ float ks[CC][27];
  const int TW = tile_w(W), TH = HT / TW;
  const int SW = TW + 2, SN = (TH + 2) * SW;
  const Tile tl = tile_of(blockIdx.x, D, H, W, TH, TW);
  const int tid = threadIdx.x, ly = tid / TW, lx = tid % TW;

  float acc = 0.f;
  for (int c0 = 0; c0 < Ci; c0 += CC) {
    for (int e = tid; e < 3 * SN * CC; e += HT) {
      const int cc = e % CC, p = e / CC;
      const int pd = p / SN, q = p % SN;
      const int sd = tl.d + pd - 1, sh = tl.h0 + q / SW - 1, sw = tl.w0 + q % SW - 1;
      float v = 0.f;
      if (c0 + cc < Ci && sd >= 0 && sd < D && sh >= 0 && sh < H && sw >= 0 && sw < W)
        v = to_f(x[((((long long)tl.b * D + sd) * H + sh) * W + sw) * Ci + c0 + cc]);
      xs[cc][pd][q] = v;
    }
    for (int e = tid; e < CC * 27; e += HT) {
      const int cc = e / 27, t = e % 27;
      ks[cc][t] = c0 + cc < Ci ? to_f(k[(c0 + cc) * 27 + t]) : 0.f;
    }
    __syncthreads();
    for (int cc = 0; cc < CC; ++cc) {
#pragma unroll
      for (int td = 0; td < 3; ++td)
#pragma unroll
        for (int th = 0; th < 3; ++th)
#pragma unroll
          for (int tw = 0; tw < 3; ++tw)
            acc = fmaf(xs[cc][td][(ly + th) * SW + lx + tw], ks[cc][td * 9 + th * 3 + tw], acc);
    }
    __syncthreads();
  }
  const int h = tl.h0 + ly, w = tl.w0 + lx;
  if (h < H && w < W)
    out[(((long long)tl.b * D + tl.d) * H + h) * W + w] = from_f<T>(acc);
}

// dx[q, c] = sum_t g(q - off_t + 1) * k[c, t]
// partial[block, c, t] = sum over this block's voxels q of x[q, c] * g(q - off_t + 1)
template <typename T>
__global__ void __launch_bounds__(HT)
head_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                const T* __restrict__ k, T* __restrict__ dx,
                float* __restrict__ partial, int B, int D, int H, int W, int Ci) {
  extern __shared__ float smem[];
  float* dks = smem;                    // [Ci * 27]   this block's dK
  float* ks = dks + Ci * 27;            // [CC][27]    kernel chunk
  float* G = ks + CC * 27;              // [HT][27]    shifted cotangents
  float* gs = G + HT * 27;              // [3][SLAB]   g halo slab
  float* xs = gs + 3 * SLAB;            // [HT][CC+1]  x chunk
  const int TW = tile_w(W), TH = HT / TW;
  const int SW = TW + 2, SN = (TH + 2) * SW;
  const int tid = threadIdx.x;
  const long long n_tiles = (long long)B * D * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);

  for (int e = tid; e < Ci * 27; e += HT) dks[e] = 0.f;

  for (long long ti = blockIdx.x; ti < n_tiles; ti += gridDim.x) {
    const Tile tl = tile_of(ti, D, H, W, TH, TW);
    __syncthreads();  // previous tile is done with gs / G
    for (int e = tid; e < 3 * SN; e += HT) {
      const int pd = e / SN, q = e % SN;
      const int sd = tl.d + pd - 1, sh = tl.h0 + q / SW - 1, sw = tl.w0 + q % SW - 1;
      float v = 0.f;
      if (sd >= 0 && sd < D && sh >= 0 && sh < H && sw >= 0 && sw < W)
        v = to_f(g[(((long long)tl.b * D + sd) * H + sh) * W + sw]);
      gs[pd * SLAB + q] = v;
    }
    __syncthreads();
    {
      const int ly = tid / TW, lx = tid % TW;
      const bool ok = tl.h0 + ly < H && tl.w0 + lx < W;
#pragma unroll
      for (int td = 0; td < 3; ++td)
#pragma unroll
        for (int th = 0; th < 3; ++th)
#pragma unroll
          for (int tw = 0; tw < 3; ++tw)
            G[tid * 27 + td * 9 + th * 3 + tw] =
                ok ? gs[(2 - td) * SLAB + (ly + 2 - th) * SW + lx + 2 - tw] : 0.f;
    }
    for (int c0 = 0; c0 < Ci; c0 += CC) {
      __syncthreads();  // G written / previous chunk done with xs, ks
      for (int e = tid; e < HT * CC; e += HT) {
        const int cc = e % CC, q = e / CC;
        const int h = tl.h0 + q / TW, w = tl.w0 + q % TW;
        float v = 0.f;
        if (c0 + cc < Ci && h < H && w < W)
          v = to_f(x[((((long long)tl.b * D + tl.d) * H + h) * W + w) * Ci + c0 + cc]);
        xs[q * (CC + 1) + cc] = v;
      }
      for (int e = tid; e < CC * 27; e += HT) {
        const int cc = e / 27, t = e % 27;
        ks[e] = c0 + cc < Ci ? to_f(k[(c0 + cc) * 27 + t]) : 0.f;
      }
      __syncthreads();
      for (int e = tid; e < HT * CC; e += HT) {
        const int cc = e % CC, q = e / CC;
        const int h = tl.h0 + q / TW, w = tl.w0 + q % TW;
        if (c0 + cc >= Ci || h >= H || w >= W) continue;
        float s = 0.f;
#pragma unroll
        for (int t = 0; t < 27; ++t) s = fmaf(G[q * 27 + t], ks[cc * 27 + t], s);
        dx[((((long long)tl.b * D + tl.d) * H + h) * W + w) * Ci + c0 + cc] = from_f<T>(s);
      }
      for (int e = tid; e < CC * 27; e += HT) {
        const int cc = e / 27, t = e % 27;
        if (c0 + cc >= Ci) continue;
        float s = 0.f;
        for (int q = 0; q < HT; ++q) s = fmaf(xs[q * (CC + 1) + cc], G[q * 27 + t], s);
        dks[(c0 + cc) * 27 + t] += s;
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < Ci * 27; e += HT)
    partial[(long long)blockIdx.x * Ci * 27 + e] = dks[e];
}

long long n_tiles(int B, int D, int H, int W) {
  const int TW = tile_w(W), TH = HT / TW;
  return (long long)B * D * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
}

template <typename T>
int launch_fwd(const void* x, const void* k, void* out, int B, int D, int H,
               int W, int Ci, void* stream) {
  head_fwd_kernel<T><<<(unsigned)n_tiles(B, D, H, W), HT, 0, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)k, (T*)out, B, D, H, W, Ci);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* x, const void* g, const void* k, void* dx,
               void* partial, void* dk, int B, int D, int H, int W, int Ci,
               int grid, void* stream) {
  const size_t smem = sizeof(float) *
      ((size_t)Ci * 27 + CC * 27 + HT * 27 + 3 * SLAB + HT * (CC + 1));
  int err = (int)cudaFuncSetAttribute(head_bwd_kernel<T>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      (int)smem);
  if (err) return err;
  head_bwd_kernel<T><<<(unsigned)grid, HT, smem, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)g, (const T*)k, (T*)dx, (float*)partial, B, D, H, W, Ci);
  err = (int)cudaGetLastError();
  if (err) return err;
  return sum_partials((const float*)partial, (float*)dk, grid, (long long)Ci * 27,
                      (cudaStream_t)stream);
}

}  // namespace

extern "C" {

long long head_conv_tiles(int B, int D, int H, int W) { return n_tiles(B, D, H, W); }

int head_fwd_f32(const void* x, const void* k, void* out, int B, int D, int H,
                 int W, int Ci, void* stream) {
  return launch_fwd<float>(x, k, out, B, D, H, W, Ci, stream);
}

int head_fwd_bf16(const void* x, const void* k, void* out, int B, int D, int H,
                  int W, int Ci, void* stream) {
  return launch_fwd<__nv_bfloat16>(x, k, out, B, D, H, W, Ci, stream);
}

int head_bwd_f32(const void* x, const void* g, const void* k, void* dx,
                 void* partial, void* dk, int B, int D, int H, int W, int Ci,
                 int grid, void* stream) {
  return launch_bwd<float>(x, g, k, dx, partial, dk, B, D, H, W, Ci, grid, stream);
}

int head_bwd_bf16(const void* x, const void* g, const void* k, void* dx,
                  void* partial, void* dk, int B, int D, int H, int W, int Ci,
                  int grid, void* stream) {
  return launch_bwd<__nv_bfloat16>(x, g, k, dx, partial, dk, B, D, H, W, Ci, grid,
                                   stream);
}

}  // extern "C"
