// SAME 3x3x3 conv3d for Hopper (sm_90a): forward (also used for dx) and the
// filter gradient.  Channels-last NDHWC activations; forward weights (27*Ci,
// Co) row-major with row k = tap*Ci + ci, tap = 9*td + 3*th + tw.
//
// Replaces the Pallas TPU kernels pcrlv2_tpu/ops/pallas_conv.py:75
// _fwd_kernel (forward; dx on flipped, io-swapped weights) and :154
// _dw_kernel (filter grad).  Both compute bf16 (or f32) operands, f32
// accumulation and one rounding of the output.
//
// What bounds them on the H100: every launch of the model is operation-bound
// (K = 27*Ci is 216..13824 deep, Co 32..512 wide; a few MB of operands for
// GFLOPs of work).  In f32 the limit is the FMA rate of the CUDA cores (no
// TF32: the f32 path keeps f32 products); in bf16 the tensor cores'.  The
// hard case is level 0, where most of the work sits at Co = 32..64: a tile
// that pads N to 128 would waste half of it, and every operand byte feeds
// few products.
//
// Design: implicit GEMMs with no im2col buffer and no padded copy of x.
//  * forward/dx, rows = voxels (M = B*D*H*W), columns = Co, K walked tap by
//    tap in chunks of BK channels (Ci % VEC == 0, so a 16-byte vector of a
//    chunk lies in one tap).  Operand tiles fill a STAGES-deep ring in
//    shared memory with 16-byte cp.async copies; SAME-padding halo rows use
//    the zero-fill form (source size 0), so the inner loop has no branch.
//    Each A row's voxel coordinates are decomposed once per block.  bf16
//    multiplies on tensor cores (mma.sync m16n8k16, f32 accumulate, operands
//    by ldmatrix from rows padded by 16 bytes, free of bank conflicts); f32
//    on CUDA cores with an 8x8 (8x4) register micro-tile fed by float4 reads.
//    The tile's N (32, 64 or 128) follows Co; where the grid is short of the
//    card (the deep levels) the wrapper splits K and a fixed-order pass adds
//    the f32 partials, the bias and casts (no atomics: the same result on
//    every run).
//  * filter grad, per tap dw[t] (Ci x Co) = sum_voxels window_t(x)^T g: a
//    block owns one tap and one (Ci, Co) tile, so every row of its x tile
//    shares one shift; it walks its voxel chunk BK voxels at a time, the x
//    rows' coordinates carried from chunk to chunk by a mixed-radix add (no
//    per-element division).  bf16 on tensor cores (ldmatrix.trans for both
//    operands, stored voxel-major), f32 on the FMA micro-tile.  The voxel
//    sum is split S ways; sum_partials_kernel adds the partials in order.
//  * the stem (Ci = 1, K = 27): a scalar gather of the 27 taps per voxel,
//    forward and filter grad; ~0.06 % of the FLOPs.

#include "conv_mma.cuh"

namespace {

// ---------------------------------------------------------------------------
// Operand loaders: each fills one ring slot with 16-byte cp.async copies
// and advances to the next chunk.  VEC elements per copy.
// ---------------------------------------------------------------------------

// Forward: A (BM voxels x BK of k, row-major, row stride LDA) gathered from
// x at the tap's shift, B (BK x BN, row stride LDB) rows of wt.  A thread
// always copies vector column acol of the same A rows and bcol of the same
// B rows; its A column's (tap, ci) advances by BK per chunk.
template <typename T, int BM, int BN, int BK, int NT, int LDA, int LDB>
struct FwdLoader {
  static constexpr int VEC = 16 / sizeof(T);
  static constexpr int AV = BK / VEC, AR = BM * AV / NT, ASTEP = NT / AV;
  static constexpr int BV = BN / VEC, BR = BK * BV / NT, BSTEP = NT / BV;
  static_assert(BM * AV % NT == 0 && BK * BV % NT == 0, "tile not a multiple of the block");
  const T* x;
  const T* wt;
  long long xoff[AR];  // x offset of the row's voxel; -1 past M
  int vd[AR], vh[AR], vw[AR];
  int tap, ci, k, kend, D, H, W, Ci, Co, n0, acol, arow, bcol, brow;

  __device__ void init(const T* x_, const T* wt_, long long m0, int n0_, int kbeg, int kend_,
                       int D_, int H_, int W_, int Ci_, int Co_, long long M) {
    x = x_; wt = wt_; n0 = n0_; k = kbeg; kend = kend_;
    D = D_; H = H_; W = W_; Ci = Ci_; Co = Co_;
    const int tid = threadIdx.x;
    acol = tid % AV; arow = tid / AV; bcol = tid % BV; brow = tid / BV;
#pragma unroll
    for (int i = 0; i < AR; ++i) {
      const long long m = m0 + arow + i * ASTEP;
      long long t = m < M ? m : 0;
      xoff[i] = m < M ? m * Ci : -1;
      vw[i] = (int)(t % W); t /= W;
      vh[i] = (int)(t % H); t /= H;
      vd[i] = (int)(t % D);
    }
    const int kc = kbeg + acol * VEC;
    tap = kc / Ci;
    ci = kc - tap * Ci;
  }

  __device__ __forceinline__ void load(T* As, T* Bs) {
    const int td = tap / 9, th = (tap / 3) % 3, tw = tap % 3;
    const bool kok = k + acol * VEC < kend;
    const long long shift = (long long)(((td - 1) * H + (th - 1)) * W + (tw - 1)) * Ci + ci;
#pragma unroll
    for (int i = 0; i < AR; ++i) {
      const bool ok = kok && xoff[i] >= 0 &&
                      in_grid(vd[i] + td - 1, vh[i] + th - 1, vw[i] + tw - 1, D, H, W);
      cp_async16(As + (arow + i * ASTEP) * LDA + acol * VEC, ok ? x + xoff[i] + shift : x, ok);
    }
#pragma unroll
    for (int i = 0; i < BR; ++i) {
      const int kr = k + brow + i * BSTEP, n = n0 + bcol * VEC;
      const bool ok = kr < kend && n < Co;
      cp_async16(Bs + (brow + i * BSTEP) * LDB + bcol * VEC,
                 ok ? wt + (long long)kr * Co + n : wt, ok);
    }
    k += BK;
    ci += BK;
    while (ci >= Ci) { ci -= Ci; ++tap; }
  }
};

// Filter grad: X (BK voxels x BM channels of tap t's window, row stride
// LDX) and G (BK voxels x BN columns of g, row stride LDG), both voxel-major.
// A thread always copies the same vector column of the same rows; the x
// rows' (d, h, w) advance by BK voxels per chunk with a mixed-radix add.
template <typename T, int BM, int BN, int BK, int NT, int LDX, int LDG>
struct DwLoader {
  static constexpr int VEC = 16 / sizeof(T);
  static constexpr int XV = BM / VEC, XR = BK * XV / NT, XSTEP = NT / XV;
  static constexpr int GV = BN / VEC, GR = BK * GV / NT, GSTEP = NT / GV;
  static_assert(BK * XV % NT == 0 && BK * GV % NT == 0, "tile not a multiple of the block");
  const T* x;
  const T* g;
  long long m;  // voxel of this thread's first x row (and first g row offset below)
  long long mend, shift;
  int vd[XR], vh[XR], vw[XR];
  int td, th, tw, D, H, W, Ci, Co, c, n, xcol, xrow, gcol, grow, sW, sH, sD;
  bool cok, nok;

  __device__ void init(const T* x_, const T* g_, long long mbeg, long long mend_, int tap,
                       int c0, int n0, int D_, int H_, int W_, int Ci_, int Co_) {
    x = x_; g = g_; mend = mend_; D = D_; H = H_; W = W_; Ci = Ci_; Co = Co_;
    td = tap / 9; th = (tap / 3) % 3; tw = tap % 3;
    shift = (long long)(((td - 1) * H + (th - 1)) * W + (tw - 1)) * Ci;
    const int tid = threadIdx.x;
    xcol = tid % XV; xrow = tid / XV; gcol = tid % GV; grow = tid / GV;
    c = c0 + xcol * VEC; n = n0 + gcol * VEC;
    cok = c < Ci; nok = n < Co;
    m = mbeg;
#pragma unroll
    for (int i = 0; i < XR; ++i) {
      long long t = mbeg + xrow + i * XSTEP;
      vw[i] = (int)(t % W); t /= W;
      vh[i] = (int)(t % H); t /= H;
      vd[i] = (int)(t % D);
    }
    sW = BK % W;
    sH = (BK / W) % H;
    sD = (BK / (W * H)) % D;
  }

  __device__ __forceinline__ void load(T* Xs, T* Gs) {
#pragma unroll
    for (int i = 0; i < XR; ++i) {
      const long long mi = m + xrow + i * XSTEP;
      const bool ok = cok && mi < mend &&
                      in_grid(vd[i] + td - 1, vh[i] + th - 1, vw[i] + tw - 1, D, H, W);
      cp_async16(Xs + (xrow + i * XSTEP) * LDX + xcol * VEC, ok ? x + mi * Ci + shift + c : x,
                 ok);
      int w = vw[i] + sW, h = vh[i] + sH, d = vd[i] + sD;
      if (w >= W) { w -= W; ++h; }
      if (h >= H) { h -= H; ++d; }
      if (d >= D) d -= D;
      vw[i] = w; vh[i] = h; vd[i] = d;
    }
#pragma unroll
    for (int i = 0; i < GR; ++i) {
      const long long mi = m + grow + i * GSTEP;
      const bool ok = nok && mi < mend;
      cp_async16(Gs + (grow + i * GSTEP) * LDG + gcol * VEC, ok ? g + mi * Co + n : g, ok);
    }
    m += BK;
  }
};

// ---------------------------------------------------------------------------
// Forward / dx
// ---------------------------------------------------------------------------

// out[m, n] = bias[n] + sum_k A[m, k] * wt[k, n] over k in this block's K
// split [z*kchunk, (z+1)*kchunk); m = voxel (b, d, h, w), k = tap*Ci + ci,
// A[m, k] = x[b, d+td-1, h+th-1, w+tw-1, ci] (0 outside).  With partial
// set, the split's f32 sum goes to partial[z] (no bias) instead of out.
// Block tile BM x BN, warp tile WM x WN, K chunk 32, bf16 tensor cores.
constexpr int MMA_BK = 32, MMA_PAD = 8, MMA_STAGES = 4;

template <int BM, int BN, int WM, int WN>
__global__ void __launch_bounds__((BM / WM) * (BN / WN) * 32)
conv3d_fwd_kernel_mma(const bf16* __restrict__ x, const bf16* __restrict__ wt,
                      const bf16* __restrict__ bias, bf16* __restrict__ out,
                      float* __restrict__ partial, int B, int D, int H, int W, int Ci, int Co,
                      int kchunk) {
  constexpr int NT = (BM / WM) * (BN / WN) * 32, BK = MMA_BK;
  constexpr int LDA = BK + MMA_PAD, LDB = BN + MMA_PAD, MI = WM / 16, NI = WN / 8;
  constexpr int ASZ = BM * LDA, BSZ = BK * LDB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* As = reinterpret_cast<bf16*>(smem_raw);
  bf16* Bs = As + MMA_STAGES * ASZ;
  const long long M = (long long)B * D * H * W;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN, K = 27 * Ci;
  const int kbeg = blockIdx.z * kchunk, kend = min(kbeg + kchunk, K);
  const int nk = (kend - kbeg + BK - 1) / BK;
  FwdLoader<bf16, BM, BN, BK, NT, LDA, LDB> ld;
  ld.init(x, wt, m0, n0, kbeg, kend, D, H, W, Ci, Co, M);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / (BN / WN), wn = warp % (BN / WN);

  float acc[MI][NI][4] = {};
#pragma unroll
  for (int s = 0; s < MMA_STAGES - 1; ++s) {
    if (s < nk) ld.load(As + s * ASZ, Bs + s * BSZ);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<MMA_STAGES - 2>();
    __syncthreads();  // chunk kt landed; every warp is done with chunk kt-1's slot
    const int nx = kt + MMA_STAGES - 1;
    if (nx < nk) ld.load(As + (nx % MMA_STAGES) * ASZ, Bs + (nx % MMA_STAGES) * BSZ);
    cp_async_commit();
    const bf16* a = As + (kt % MMA_STAGES) * ASZ + wm * WM * LDA;
    const bf16* b = Bs + (kt % MMA_STAGES) * BSZ + wn * WN;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16)
      mma_step<MI, NI, false>(acc, a + kk, LDA, b + kk * LDB, LDB, lane);
  }
  cp_async_wait<0>();

  float* dst = partial == nullptr ? nullptr : partial + (long long)blockIdx.z * M * Co;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long m = m0 + wm * WM + mi * 16 + (lane >> 2) + half * 8;
      if (m >= M) continue;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int n = n0 + wn * WN + ni * 8 + (lane & 3) * 2;
        if (n >= Co) continue;
        float v0 = acc[mi][ni][2 * half], v1 = acc[mi][ni][2 * half + 1];
        if (dst != nullptr) {
          *reinterpret_cast<float2*>(dst + m * Co + n) = make_float2(v0, v1);
        } else {
          if (bias != nullptr) {
            v0 += __bfloat162float(bias[n]);
            v1 += __bfloat162float(bias[n + 1]);
          }
          *reinterpret_cast<__nv_bfloat162*>(out + m * Co + n) = __floats2bfloat162_rn(v0, v1);
        }
      }
    }
}

// The same GEMM in f32 on CUDA cores: K chunk 16, a TM x TN micro-tile per
// thread.  A thread's rows are ty + i*(BM/TM) (neighbouring threads of a
// warp read neighbouring rows of the padded A tile: no bank conflict) and
// its columns the float4 groups tx + j*(BN/TN) (a warp's float4 reads of a
// B row are contiguous).
constexpr int FMA_BK = 16, FMA_PAD = 4, FMA_STAGES = 3;

template <int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
conv3d_fwd_kernel_fma(const float* __restrict__ x, const float* __restrict__ wt,
                      const float* __restrict__ bias, float* __restrict__ out,
                      float* __restrict__ partial, int B, int D, int H, int W, int Ci, int Co,
                      int kchunk) {
  constexpr int TX = BN / TN, TY = BM / TM, NT = TX * TY, BK = FMA_BK;
  constexpr int LDA = BK + FMA_PAD, LDB = BN + FMA_PAD, ASZ = BM * LDA, BSZ = BK * LDB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* As = reinterpret_cast<float*>(smem_raw);
  float* Bs = As + FMA_STAGES * ASZ;
  const long long M = (long long)B * D * H * W;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN, K = 27 * Ci;
  const int kbeg = blockIdx.z * kchunk, kend = min(kbeg + kchunk, K);
  const int nk = (kend - kbeg + BK - 1) / BK;
  FwdLoader<float, BM, BN, BK, NT, LDA, LDB> ld;
  ld.init(x, wt, m0, n0, kbeg, kend, D, H, W, Ci, Co, M);
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;

  float acc[TM][TN] = {};
#pragma unroll
  for (int s = 0; s < FMA_STAGES - 1; ++s) {
    if (s < nk) ld.load(As + s * ASZ, Bs + s * BSZ);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<FMA_STAGES - 2>();
    __syncthreads();
    const int nx = kt + FMA_STAGES - 1;
    if (nx < nk) ld.load(As + (nx % FMA_STAGES) * ASZ, Bs + (nx % FMA_STAGES) * BSZ);
    cp_async_commit();
    const float* a = As + (kt % FMA_STAGES) * ASZ;
    const float* b = Bs + (kt % FMA_STAGES) * BSZ;
#pragma unroll
    for (int k4 = 0; k4 < BK; k4 += 4) {
      float4 av[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        av[i] = *reinterpret_cast<const float4*>(a + (ty + i * TY) * LDA + k4);
#pragma unroll
      for (int kq = 0; kq < 4; ++kq) {
        float bv[TN];
#pragma unroll
        for (int j = 0; j < TN / 4; ++j)
          *reinterpret_cast<float4*>(bv + 4 * j) =
              *reinterpret_cast<const float4*>(b + (k4 + kq) * LDB + (tx + j * TX) * 4);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float ai = reinterpret_cast<const float*>(&av[i])[kq];
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(ai, bv[j], acc[i][j]);
        }
      }
    }
  }
  cp_async_wait<0>();

  float* dst = partial == nullptr ? out : partial + (long long)blockIdx.z * M * Co;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long m = m0 + ty + i * TY;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN / 4; ++j) {
      const int n = n0 + (tx + j * TX) * 4;
      if (n >= Co) continue;
      float4 v = make_float4(acc[i][4 * j], acc[i][4 * j + 1], acc[i][4 * j + 2],
                             acc[i][4 * j + 3]);
      if (partial == nullptr && bias != nullptr) {
        v.x += bias[n]; v.y += bias[n + 1]; v.z += bias[n + 2]; v.w += bias[n + 3];
      }
      *reinterpret_cast<float4*>(dst + m * Co + n) = v;
    }
  }
}

// The stem (Ci = 1): a block gathers the 27 taps of 64 voxels into shared
// memory, then its threads write the 64 x Co outputs in order (coalesced).
constexpr int STEM_V = 64, STEM_NT = 256;

template <typename T>
__global__ void __launch_bounds__(STEM_NT)
conv3d_fwd_kernel_stem(const T* __restrict__ x, const T* __restrict__ wt,
                       const T* __restrict__ bias, T* __restrict__ out, int B, int D, int H,
                       int W, int Co) {
  __shared__ float xs[STEM_V][28];
  const long long M = (long long)B * D * H * W;
  const long long m0 = (long long)blockIdx.x * STEM_V;
  for (int e = threadIdx.x; e < STEM_V * 27; e += STEM_NT) {
    const int v = e / 27, tap = e % 27;
    const long long m = m0 + v;
    float val = 0.f;
    if (m < M) {
      long long t = m;
      const int w = (int)(t % W); t /= W;
      const int h = (int)(t % H); t /= H;
      const int d = (int)(t % D);
      const int sd = d + tap / 9 - 1, sh = h + (tap / 3) % 3 - 1, sw = w + tap % 3 - 1;
      if (in_grid(sd, sh, sw, D, H, W))
        val = to_f(x[m + ((long long)(tap / 9 - 1) * H + ((tap / 3) % 3 - 1)) * W + (tap % 3 - 1)]);
    }
    xs[v][tap] = val;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < STEM_V * Co; e += STEM_NT) {
    const int v = e / Co, n = e % Co;
    const long long m = m0 + v;
    if (m >= M) break;
    float acc = bias != nullptr ? to_f(bias[n]) : 0.f;
#pragma unroll 9
    for (int tap = 0; tap < 27; ++tap) acc = fmaf(xs[v][tap], to_f(wt[tap * Co + n]), acc);
    out[m * Co + n] = from_f<T>(acc);
  }
}

// ---------------------------------------------------------------------------
// Filter gradient
// ---------------------------------------------------------------------------

// partial[z, tap*Ci + c, n] = sum over the voxels m of chunk z of
// x[window_tap(m), c] * g[m, n] (0 outside the volume).  blockIdx.x = (tap,
// channel tile), blockIdx.y = column tile, blockIdx.z = voxel chunk.  Four
// warps in 2 x 2, each a (BM/2) x (BN/2) tile; K chunk 32 voxels.
template <int BM, int BN>
__global__ void __launch_bounds__(128)
conv3d_dw_partial_mma(const bf16* __restrict__ x, const bf16* __restrict__ g,
                      float* __restrict__ partial, int B, int D, int H, int W, int Ci, int Co,
                      long long chunk) {
  constexpr int BK = MMA_BK, LDX = BM + MMA_PAD, LDG = BN + MMA_PAD;
  constexpr int WM = BM / 2, WN = BN / 2, MI = WM / 16, NI = WN / 8;
  constexpr int XSZ = BK * LDX, GSZ = BK * LDG;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Xs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Gs = Xs + MMA_STAGES * XSZ;
  const long long M = (long long)B * D * H * W;
  const int ctiles = (Ci + BM - 1) / BM;
  const int tap = blockIdx.x / ctiles, c0 = (blockIdx.x % ctiles) * BM, n0 = blockIdx.y * BN;
  const long long mbeg = (long long)blockIdx.z * chunk;
  const long long mend = mbeg + chunk < M ? mbeg + chunk : M;
  const int nk = (int)((mend - mbeg + BK - 1) / BK);
  DwLoader<bf16, BM, BN, BK, 128, LDX, LDG> ld;
  ld.init(x, g, mbeg, mend, tap, c0, n0, D, H, W, Ci, Co);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 2, wn = warp % 2;

  float acc[MI][NI][4] = {};
#pragma unroll
  for (int s = 0; s < MMA_STAGES - 1; ++s) {
    if (s < nk) ld.load(Xs + s * XSZ, Gs + s * GSZ);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<MMA_STAGES - 2>();
    __syncthreads();
    const int nx = kt + MMA_STAGES - 1;
    if (nx < nk) ld.load(Xs + (nx % MMA_STAGES) * XSZ, Gs + (nx % MMA_STAGES) * GSZ);
    cp_async_commit();
    const bf16* a = Xs + (kt % MMA_STAGES) * XSZ + wm * WM;
    const bf16* b = Gs + (kt % MMA_STAGES) * GSZ + wn * WN;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16)
      mma_step<MI, NI, true>(acc, a + kk * LDX, LDX, b + kk * LDG, LDG, lane);
  }
  cp_async_wait<0>();

  float* dst = partial + (long long)blockIdx.z * 27 * Ci * Co + (long long)tap * Ci * Co;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c = c0 + wm * WM + mi * 16 + (lane >> 2) + half * 8;
      if (c >= Ci) continue;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int n = n0 + wn * WN + ni * 8 + (lane & 3) * 2;
        if (n < Co)
          *reinterpret_cast<float2*>(dst + (long long)c * Co + n) =
              make_float2(acc[mi][ni][2 * half], acc[mi][ni][2 * half + 1]);
      }
    }
}

// The same in f32 on CUDA cores: K chunk 16 voxels, 128 threads as 8 x 16,
// a (BM/8) x (BN/16) micro-tile per thread over the float4 groups ty +
// i*8 of the channels and tx + j*16 of the columns (a warp's reads of an X
// or G row are contiguous).
template <int BM, int BN>
__global__ void __launch_bounds__(128)
conv3d_dw_partial_fma(const float* __restrict__ x, const float* __restrict__ g,
                      float* __restrict__ partial, int B, int D, int H, int W, int Ci, int Co,
                      long long chunk) {
  constexpr int BK = FMA_BK, LDX = BM + FMA_PAD, LDG = BN + FMA_PAD;
  constexpr int TM = BM / 8, TN = BN / 16, XSZ = BK * LDX, GSZ = BK * LDG;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Xs = reinterpret_cast<float*>(smem_raw);
  float* Gs = Xs + FMA_STAGES * XSZ;
  const long long M = (long long)B * D * H * W;
  const int ctiles = (Ci + BM - 1) / BM;
  const int tap = blockIdx.x / ctiles, c0 = (blockIdx.x % ctiles) * BM, n0 = blockIdx.y * BN;
  const long long mbeg = (long long)blockIdx.z * chunk;
  const long long mend = mbeg + chunk < M ? mbeg + chunk : M;
  const int nk = (int)((mend - mbeg + BK - 1) / BK);
  DwLoader<float, BM, BN, BK, 128, LDX, LDG> ld;
  ld.init(x, g, mbeg, mend, tap, c0, n0, D, H, W, Ci, Co);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  float acc[TM][TN] = {};
#pragma unroll
  for (int s = 0; s < FMA_STAGES - 1; ++s) {
    if (s < nk) ld.load(Xs + s * XSZ, Gs + s * GSZ);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<FMA_STAGES - 2>();
    __syncthreads();
    const int nx = kt + FMA_STAGES - 1;
    if (nx < nk) ld.load(Xs + (nx % FMA_STAGES) * XSZ, Gs + (nx % FMA_STAGES) * GSZ);
    cp_async_commit();
    const float* a = Xs + (kt % FMA_STAGES) * XSZ;
    const float* b = Gs + (kt % FMA_STAGES) * GSZ;
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM / 4; ++i)
        *reinterpret_cast<float4*>(av + 4 * i) =
            *reinterpret_cast<const float4*>(a + k * LDX + (ty + i * 8) * 4);
#pragma unroll
      for (int j = 0; j < TN / 4; ++j)
        *reinterpret_cast<float4*>(bv + 4 * j) =
            *reinterpret_cast<const float4*>(b + k * LDG + (tx + j * 16) * 4);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();

  float* dst = partial + (long long)blockIdx.z * 27 * Ci * Co + (long long)tap * Ci * Co;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int c = c0 + (ty + (i / 4) * 8) * 4 + i % 4;
    if (c >= Ci) continue;
#pragma unroll
    for (int j = 0; j < TN / 4; ++j) {
      const int n = n0 + (tx + j * 16) * 4;
      if (n < Co)
        *reinterpret_cast<float4*>(dst + (long long)c * Co + n) =
            make_float4(acc[i][4 * j], acc[i][4 * j + 1], acc[i][4 * j + 2], acc[i][4 * j + 3]);
    }
  }
}

// The stem's filter grad (Ci = 1, 27 rows): per 64-voxel step a block
// gathers the voxels' 27 taps and their g rows (32 columns from n0) into
// shared memory; each thread sums its (tap, column) pairs.
template <typename T>
__global__ void __launch_bounds__(STEM_NT)
conv3d_dw_partial_stem(const T* __restrict__ x, const T* __restrict__ g,
                       float* __restrict__ partial, int B, int D, int H, int W, int Co,
                       long long chunk) {
  constexpr int BN = 32, PAIRS = (27 * BN + STEM_NT - 1) / STEM_NT;
  __shared__ float xs[STEM_V][28];
  __shared__ float gs[STEM_V][BN + 1];
  const long long M = (long long)B * D * H * W;
  const int n0 = blockIdx.y * BN;
  const long long mbeg = (long long)blockIdx.z * chunk;
  const long long mend = mbeg + chunk < M ? mbeg + chunk : M;
  float acc[PAIRS] = {};
  for (long long m0 = mbeg; m0 < mend; m0 += STEM_V) {
    __syncthreads();
    for (int e = threadIdx.x; e < STEM_V * 27; e += STEM_NT) {
      const int v = e / 27, tap = e % 27;
      const long long m = m0 + v;
      float val = 0.f;
      if (m < mend) {
        long long t = m;
        const int w = (int)(t % W); t /= W;
        const int h = (int)(t % H); t /= H;
        const int d = (int)(t % D);
        if (in_grid(d + tap / 9 - 1, h + (tap / 3) % 3 - 1, w + tap % 3 - 1, D, H, W))
          val = to_f(x[m + ((long long)(tap / 9 - 1) * H + ((tap / 3) % 3 - 1)) * W +
                       (tap % 3 - 1)]);
      }
      xs[v][tap] = val;
    }
    for (int e = threadIdx.x; e < STEM_V * BN; e += STEM_NT) {
      const int v = e / BN, n = e % BN;
      const long long m = m0 + v;
      gs[v][n] = (m < mend && n0 + n < Co) ? to_f(g[m * Co + n0 + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int p = 0; p < PAIRS; ++p) {
      const int e = threadIdx.x + p * STEM_NT;
      if (e >= 27 * BN) break;
      const int tap = e / BN, n = e % BN;
      float a = acc[p];
#pragma unroll 8
      for (int v = 0; v < STEM_V; ++v) a = fmaf(xs[v][tap], gs[v][n], a);
      acc[p] = a;
    }
  }
  float* dst = partial + (long long)blockIdx.z * 27 * Co;
#pragma unroll
  for (int p = 0; p < PAIRS; ++p) {
    const int e = threadIdx.x + p * STEM_NT;
    if (e >= 27 * BN) break;
    const int tap = e / BN, n = n0 + e % BN;
    if (n < Co) dst[tap * Co + n] = acc[p];
  }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

constexpr int FWD_BM = 128;  // rows of every forward tile (ops/conv3d_kernel.py::_BM)
constexpr int ERR_BAD_TILE = (int)cudaErrorInvalidValue;

template <int BM, int BN, int WM, int WN>
int launch_fwd_mma(const void* x, const void* wt, const void* bias, void* out, void* partial,
                   int B, int D, int H, int W, int Ci, int Co, int S, int kchunk,
                   cudaStream_t stream) {
  const long long M = (long long)B * D * H * W;
  const size_t smem = sizeof(bf16) * MMA_STAGES *
                      (BM * (MMA_BK + MMA_PAD) + MMA_BK * (BN + MMA_PAD));
  const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((Co + BN - 1) / BN), (unsigned)S);
  auto kernel = conv3d_fwd_kernel_mma<BM, BN, WM, WN>;
  const int err = prepare(kernel, smem);
  if (err) return err;
  kernel<<<grid, (BM / WM) * (BN / WN) * 32, smem, stream>>>(
      (const bf16*)x, (const bf16*)wt, (const bf16*)bias, (bf16*)out,
      S > 1 ? (float*)partial : nullptr, B, D, H, W, Ci, Co, kchunk);
  return (int)cudaGetLastError();
}

template <int BM, int BN, int TM, int TN>
int launch_fwd_fma(const void* x, const void* wt, const void* bias, void* out, void* partial,
                   int B, int D, int H, int W, int Ci, int Co, int S, int kchunk,
                   cudaStream_t stream) {
  const long long M = (long long)B * D * H * W;
  const size_t smem = sizeof(float) * FMA_STAGES *
                      (BM * (FMA_BK + FMA_PAD) + FMA_BK * (BN + FMA_PAD));
  const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((Co + BN - 1) / BN), (unsigned)S);
  auto kernel = conv3d_fwd_kernel_fma<BM, BN, TM, TN>;
  const int err = prepare(kernel, smem);
  if (err) return err;
  kernel<<<grid, (BM / TM) * (BN / TN), smem, stream>>>(
      (const float*)x, (const float*)wt, (const float*)bias, (float*)out,
      S > 1 ? (float*)partial : nullptr, B, D, H, W, Ci, Co, kchunk);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_fwd(const void* x, const void* wt, const void* bias, void* out, void* partial,
               int B, int D, int H, int W, int Ci, int Co, int bn, int S, int kchunk,
               void* stream_) {
  const cudaStream_t stream = (cudaStream_t)stream_;
  const long long M = (long long)B * D * H * W;
  if (Ci == 1) {
    conv3d_fwd_kernel_stem<T><<<(unsigned)((M + STEM_V - 1) / STEM_V), STEM_NT, 0, stream>>>(
        (const T*)x, (const T*)wt, (const T*)bias, (T*)out, B, D, H, W, Co);
    return (int)cudaGetLastError();
  }
  int err;
  constexpr bool MMA = sizeof(T) == 2;
  if (bn == 128)
    err = MMA ? launch_fwd_mma<FWD_BM, 128, 64, 32>(x, wt, bias, out, partial, B, D, H, W, Ci,
                                                    Co, S, kchunk, stream)
              : launch_fwd_fma<FWD_BM, 128, 8, 8>(x, wt, bias, out, partial, B, D, H, W, Ci, Co,
                                                  S, kchunk, stream);
  else if (bn == 64)
    err = MMA ? launch_fwd_mma<FWD_BM, 64, 64, 32>(x, wt, bias, out, partial, B, D, H, W, Ci,
                                                   Co, S, kchunk, stream)
              : launch_fwd_fma<FWD_BM, 64, 8, 8>(x, wt, bias, out, partial, B, D, H, W, Ci, Co,
                                                 S, kchunk, stream);
  else if (bn == 32)
    err = MMA ? launch_fwd_mma<FWD_BM, 32, 32, 32>(x, wt, bias, out, partial, B, D, H, W, Ci,
                                                   Co, S, kchunk, stream)
              : launch_fwd_fma<FWD_BM, 32, 8, 4>(x, wt, bias, out, partial, B, D, H, W, Ci, Co,
                                                 S, kchunk, stream);
  else
    return ERR_BAD_TILE;
  if (err || S == 1) return err;
  const long long n = M * Co;
  conv3d_fwd_kernel_splitsum<T><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      (const float*)partial, (const T*)bias, (T*)out, S, n, Co);
  return (int)cudaGetLastError();
}

template <typename T, int BM, int BN>
int launch_dw_tile(const void* x, const void* g, void* partial, int B, int D, int H, int W,
                   int Ci, int Co, int S, long long chunk, cudaStream_t stream) {
  const dim3 grid((unsigned)(27 * ((Ci + BM - 1) / BM)), (unsigned)((Co + BN - 1) / BN),
                  (unsigned)S);
  if (sizeof(T) == 2) {
    const size_t smem = sizeof(bf16) * MMA_STAGES * MMA_BK * (BM + BN + 2 * MMA_PAD);
    auto kernel = conv3d_dw_partial_mma<BM, BN>;
    const int err = prepare(kernel, smem);
    if (err) return err;
    kernel<<<grid, 128, smem, stream>>>((const bf16*)x, (const bf16*)g, (float*)partial, B, D,
                                        H, W, Ci, Co, chunk);
  } else {
    const size_t smem = sizeof(float) * FMA_STAGES * FMA_BK * (BM + BN + 2 * FMA_PAD);
    auto kernel = conv3d_dw_partial_fma<BM, BN>;
    const int err = prepare(kernel, smem);
    if (err) return err;
    kernel<<<grid, 128, smem, stream>>>((const float*)x, (const float*)g, (float*)partial, B,
                                        D, H, W, Ci, Co, chunk);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dw(const void* x, const void* g, void* partial, void* out, int B, int D, int H,
              int W, int Ci, int Co, int bm, int bn, int S, long long chunk, void* stream_) {
  const cudaStream_t stream = (cudaStream_t)stream_;
  int err;
  if (Ci == 1) {
    conv3d_dw_partial_stem<T><<<dim3(1, (unsigned)((Co + 31) / 32), (unsigned)S), STEM_NT, 0,
                                stream>>>((const T*)x, (const T*)g, (float*)partial, B, D, H, W,
                                          Co, chunk);
    err = (int)cudaGetLastError();
  } else if (bm == 32 && bn == 64) {
    err = launch_dw_tile<T, 32, 64>(x, g, partial, B, D, H, W, Ci, Co, S, chunk, stream);
  } else if (bm == 64 && bn == 64) {
    err = launch_dw_tile<T, 64, 64>(x, g, partial, B, D, H, W, Ci, Co, S, chunk, stream);
  } else if (bm == 64 && bn == 128) {
    err = launch_dw_tile<T, 64, 128>(x, g, partial, B, D, H, W, Ci, Co, S, chunk, stream);
  } else {
    return ERR_BAD_TILE;
  }
  if (err) return err;
  return sum_partials((const float*)partial, (float*)out, S, 27LL * Ci * Co, stream);
}

}  // namespace

extern "C" {

// bn: the tile's columns (32, 64 or 128); S K-splits of kchunk each (S > 1
// needs partial, (S, M, Co) f32).  Ci = 1 takes the stem path.
int conv3d_fwd_f32(const void* x, const void* wt, const void* bias, void* out, void* partial,
                   int B, int D, int H, int W, int Ci, int Co, int bn, int S, int kchunk,
                   void* stream) {
  return launch_fwd<float>(x, wt, bias, out, partial, B, D, H, W, Ci, Co, bn, S, kchunk, stream);
}

int conv3d_fwd_bf16(const void* x, const void* wt, const void* bias, void* out, void* partial,
                    int B, int D, int H, int W, int Ci, int Co, int bn, int S, int kchunk,
                    void* stream) {
  return launch_fwd<bf16>(x, wt, bias, out, partial, B, D, H, W, Ci, Co, bn, S, kchunk, stream);
}

// (bm, bn): the (channel, column) tile; S voxel chunks of `chunk` each,
// partial (S, 27*Ci, Co) f32.  Ci = 1 takes the stem path.
int conv3d_dw_f32(const void* x, const void* g, void* partial, void* out, int B, int D, int H,
                  int W, int Ci, int Co, int bm, int bn, int S, long long chunk, void* stream) {
  return launch_dw<float>(x, g, partial, out, B, D, H, W, Ci, Co, bm, bn, S, chunk, stream);
}

int conv3d_dw_bf16(const void* x, const void* g, void* partial, void* out, int B, int D, int H,
                   int W, int Ci, int Co, int bm, int bn, int S, long long chunk, void* stream) {
  return launch_dw<bf16>(x, g, partial, out, B, D, H, W, Ci, Co, bm, bn, S, chunk, stream);
}

}  // extern "C"
