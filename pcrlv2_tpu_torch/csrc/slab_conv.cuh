// The slab-staged SAME 3x3x3 conv template for Hopper (sm_90a): a block of
// SLAB_BM output voxels x BN output channels walks K in stages of one depth
// tap td and one chunk of BK input channels, each stage a slab of input
// rows in a 2-stage cp.async ring plus the 9 weight tiles (th, tw) of td,
// the 9 taps read from the one slab at row offsets.  bf16 on mma.sync
// (slab_mma), f32 on an FMA micro-tile (slab_fma); a K split writes f32
// partials that conv3d_fwd_kernel_splitsum (conv_mma.cuh) adds in order.
// conv3d_packed.cu's header describes the design at length.
//
// Users: conv3d_packed.cu (#6 PACKED, #5 IM2COL) and proto_conv.cu (#7:
// CONCAT27 IM2COL, CONCAT9 IM2COL_TD).  Each defines its own __global__
// kernels (one name per TPU kernel, so a profile tells them apart) around
// slab_mma / slab_fma and launches them through launch_slab.
//
// MODE, the slab's layout and the order of its stages:
//  * PACKED: the three tw shifts side by side in a slab row, (td, chunk)
//    stages td outer;
//  * IM2COL: the depth plane td - 1 of the tile's rows with a one-voxel
//    halo in h and w, (td, chunk) stages chunk outer (#5, CONCAT27);
//  * IM2COL_TD: IM2COL's slab walked td outer, the chunks inner: three
//    contractions of 9*Ci, one per depth tap (CONCAT9).
#pragma once

#include "conv_mma.cuh"

namespace {

constexpr int PACKED = 0, IM2COL = 1, IM2COL_TD = 2;
constexpr int SLAB_BM = 128;     // output rows per block (ops/conv3d_packed.py::_BM)
constexpr int SLAB_STAGES = 2;   // ring depth (ops/conv3d_packed.py::_STAGES)

// K chunk (input channels per stage) and row pad, per dtype
template <typename T> struct Slab;
template <> struct Slab<bf16> { static constexpr int BK = 16, PAD = 8; };
template <> struct Slab<float> { static constexpr int BK = 8, PAD = 4; };

struct Geo {
  int B, D, H, W, Ci, Co;
  int P, L, tpp, R;  // planes per tile, rows per segment, tiles per plane, im2col input rows
  int rows;          // slab rows of one stage
  int per;           // stages per K split
};

// The tile's first plane and first plane position.  P == 1: tile t is
// segment t % tpp (L consecutive positions) of plane t / tpp; P > 1: tile t
// is planes t*P .. t*P + P - 1, whole.
__device__ __forceinline__ void slab_origin(const Geo& g, int t, int* plane0, int* p0) {
  *plane0 = g.P == 1 ? t / g.tpp : t * g.P;
  *p0 = g.P == 1 ? (t % g.tpp) * g.L : 0;
}

// tab[j] = the source of slab row j: {voxel (plane*HW + position), depth d
// << 16 | w}, or {-1, 0} for a halo row outside the plane or past the last
// plane.
template <int MODE>
__device__ __forceinline__ void build_table(int2* tab, const Geo& g, int plane0, int p0) {
  const int NP = g.B * g.D, HW = g.H * g.W;
  for (int j = threadIdx.x; j < g.rows; j += blockDim.x) {
    int s, h, w;
    bool ok;
    if (MODE == PACKED) {
      const int seg = g.L + 2 * g.W;
      s = j / seg;
      const int p = p0 - g.W + (j - s * seg);
      ok = p >= 0 && p < HW;
      h = ok ? p / g.W : 0;
      w = ok ? p - h * g.W : 0;
    } else {
      const int w2 = g.W + 2, rw = g.R * w2;
      s = j / rw;
      const int rem = j - s * rw, rr = rem / w2;
      w = rem - rr * w2 - 1;
      h = p0 / g.W - 1 + rr;
      ok = h >= 0 && h < g.H && w >= 0 && w < g.W;
    }
    const int plane = plane0 + s;
    ok = ok && plane < NP;
    tab[j] = ok ? make_int2(plane * HW + h * g.W + w, ((plane % g.D) << 16) | w)
                : make_int2(-1, 0);
  }
}

// Slab row of output row r at tap (th, tw) = (0, 0), or -1 past the tile;
// *vox = its output voxel.
template <int MODE>
__device__ __forceinline__ int out_row(const Geo& g, int r, int plane0, int p0, long long* vox) {
  const int s = r / g.L, q = r - s * g.L, plane = plane0 + s, p = p0 + q;
  const int HW = g.H * g.W;
  if (s >= g.P || plane >= g.B * g.D || p >= HW) return -1;
  *vox = (long long)plane * HW + p;
  if (MODE == PACKED) return s * (g.L + 2 * g.W) + q;
  const int h = p / g.W, w = p - h * g.W;
  return (s * g.R + h - p0 / g.W) * (g.W + 2) + w;
}

// Fill one ring slot with stage st: the slab (rows x NTW*BK, row stride
// LDS) and the 9 weight tiles (th, tw) of its td (BK x BN, row stride LDB).
// Stage st is (td, chunk) = (st / nch, st % nch) td outer (PACKED,
// IM2COL_TD), (st % 3, st / 3) chunk outer (IM2COL).
template <typename T, int MODE, int BN, int NT>
__device__ __forceinline__ void load_stage(T* S, T* Bs, const int2* tab, const T* __restrict__ x,
                                           const T* __restrict__ wt, const Geo& g, int nch,
                                           int st, int n0) {
  constexpr int BK = Slab<T>::BK, PAD = Slab<T>::PAD, VEC = 16 / sizeof(T), V = BK / VEC;
  constexpr int NTW = MODE == PACKED ? 3 : 1, LDS = NTW * BK + PAD, LDB = BN + PAD;
  constexpr int NV = BN / VEC, NB = 9 * BK * NV;
  int td, c0;
  if (MODE != IM2COL) {
    td = st / nch;
    c0 = (st - td * nch) * BK;
  } else {
    const int c = st / 3;
    td = st - 3 * c;
    c0 = c * BK;
  }
  const long long dshift = (long long)(td - 1) * g.H * g.W;
  const int nslab = g.rows * NTW * V;
  for (int e = threadIdx.x; e < nslab; e += NT) {
    const int row = e / (NTW * V), rem = e - row * (NTW * V);
    const int tw = rem / V, v = rem - tw * V, c = c0 + v * VEC;
    const int2 t = tab[row];
    const int sh = MODE == PACKED ? tw - 1 : 0;
    const bool ok = t.x >= 0 && c < g.Ci && (unsigned)((t.y >> 16) + td - 1) < (unsigned)g.D &&
                    (unsigned)((t.y & 0xffff) + sh) < (unsigned)g.W;
    cp_async16(S + row * LDS + tw * BK + v * VEC,
               ok ? x + ((long long)t.x + dshift + sh) * g.Ci + c : x, ok);
  }
#pragma unroll 3
  for (int e = threadIdx.x; e < NB; e += NT) {
    const int tap = e / (BK * NV), rem = e - tap * (BK * NV);
    const int k = rem / NV, nv = rem - k * NV, c = c0 + k, n = n0 + nv * VEC;
    const bool ok = c < g.Ci && n < g.Co;
    cp_async16(Bs + (tap * BK + k) * LDB + nv * VEC,
               ok ? wt + ((long long)(9 * td + tap) * g.Ci + c) * g.Co + n : wt, ok);
  }
}

// Rows of shared memory between a tap's row th and th + 1
template <typename T, int MODE>
__device__ __forceinline__ int th_stride(const Geo& g) {
  constexpr int LDS = (MODE == PACKED ? 3 : 1) * Slab<T>::BK + Slab<T>::PAD;
  return (MODE == PACKED ? g.W : g.W + 2) * LDS;
}

// Offset of tap (th, tw)'s A tile from the slab row of tap (0, 0)
template <typename T, int MODE>
__device__ __forceinline__ int tap_offset(int th, int tw, int ths) {
  constexpr int BK = Slab<T>::BK, LDS = (MODE == PACKED ? 3 : 1) * BK + Slab<T>::PAD;
  return th * ths + (MODE == PACKED ? tw * BK : tw * LDS);
}

// out[m, n] = bias[n] + the block's K split of sum_k A[m, k] * wt[k, n], in
// bf16 on tensor cores.  Warp tile WM x WN; with partial set, the split's
// f32 sum goes to partial[z] (no bias) instead of out.
template <int MODE, int BN, int WM, int WN>
__device__ __forceinline__ void slab_mma(const bf16* __restrict__ x, const bf16* __restrict__ wt,
                                         const bf16* __restrict__ bias, bf16* __restrict__ out,
                                         float* __restrict__ partial, const Geo& g) {
  constexpr int NT = (SLAB_BM / WM) * (BN / WN) * 32, BK = Slab<bf16>::BK;
  constexpr int LDS = (MODE == PACKED ? 3 : 1) * BK + Slab<bf16>::PAD, LDB = BN + Slab<bf16>::PAD;
  constexpr int MI = WM / 16, NI = WN / 8, BSZ = 9 * BK * LDB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int SSZ = g.rows * LDS;
  bf16* S = reinterpret_cast<bf16*>(smem_raw);
  bf16* Bs = S + SLAB_STAGES * SSZ;
  int2* tab = reinterpret_cast<int2*>(Bs + SLAB_STAGES * BSZ);
  int plane0, p0;
  slab_origin(g, blockIdx.x, &plane0, &p0);
  build_table<MODE>(tab, g, plane0, p0);
  __syncthreads();
  const int nch = (g.Ci + BK - 1) / BK, sbeg = blockIdx.z * g.per;
  const int nk = min(g.per, 3 * nch - sbeg), n0 = blockIdx.y * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / (BN / WN), wn = warp % (BN / WN);
  int abase[MI];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
    long long v;
    const int r = out_row<MODE>(g, wm * WM + mi * 16 + (lane & 15), plane0, p0, &v);
    abase[mi] = max(r, 0) * LDS + (lane >> 4) * 8;
  }
  const int ths = th_stride<bf16, MODE>(g);

  float acc[MI][NI][4] = {};
#pragma unroll
  for (int s = 0; s < SLAB_STAGES - 1; ++s) {
    if (s < nk)
      load_stage<bf16, MODE, BN, NT>(S + s * SSZ, Bs + s * BSZ, tab, x, wt, g, nch, sbeg + s, n0);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<SLAB_STAGES - 2>();
    __syncthreads();  // stage kt landed; every warp is done with stage kt-1's slot
    const int nx = kt + SLAB_STAGES - 1;
    if (nx < nk)
      load_stage<bf16, MODE, BN, NT>(S + (nx % SLAB_STAGES) * SSZ, Bs + (nx % SLAB_STAGES) * BSZ,
                                     tab, x, wt, g, nch, sbeg + nx, n0);
    cp_async_commit();
    const bf16* a = S + (kt % SLAB_STAGES) * SSZ;
    const bf16* b = Bs + (kt % SLAB_STAGES) * BSZ + wn * WN;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int off = tap_offset<bf16, MODE>(tap / 3, tap % 3, ths);
      unsigned af[MI][4], bfr[NI][2];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) ldsm_x4(af[mi], a + abase[mi] + off);
      const bf16* bt = b + tap * BK * LDB;
#pragma unroll
      for (int nj = 0; nj < NI / 2; ++nj) {
        unsigned r[4];
        ldsm_x4_trans(r, bt + ((lane & 7) + ((lane >> 3) & 1) * 8) * LDB + nj * 16 + (lane >> 4) * 8);
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
  }
  cp_async_wait<0>();

  const long long M = (long long)g.B * g.D * g.H * g.W;
  float* dst = partial == nullptr ? nullptr : partial + (long long)blockIdx.z * M * g.Co;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      long long m;
      if (out_row<MODE>(g, wm * WM + mi * 16 + (lane >> 2) + half * 8, plane0, p0, &m) < 0)
        continue;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int n = n0 + wn * WN + ni * 8 + (lane & 3) * 2;
        if (n >= g.Co) continue;
        float v0 = acc[mi][ni][2 * half], v1 = acc[mi][ni][2 * half + 1];
        if (dst != nullptr) {
          *reinterpret_cast<float2*>(dst + m * g.Co + n) = make_float2(v0, v1);
        } else {
          if (bias != nullptr) {
            v0 += __bfloat162float(bias[n]);
            v1 += __bfloat162float(bias[n + 1]);
          }
          *reinterpret_cast<__nv_bfloat162*>(out + m * g.Co + n) = __floats2bfloat162_rn(v0, v1);
        }
      }
    }
}

// The same in f32 on CUDA cores: a TM x TN micro-tile per thread, rows ty +
// i*(BM/TM), columns the float4 groups tx + j*(BN/TN) (a warp's float4
// reads of a B row are contiguous; its A reads are broadcasts).
template <int MODE, int BN, int TM, int TN>
__device__ __forceinline__ void slab_fma(const float* __restrict__ x, const float* __restrict__ wt,
                                         const float* __restrict__ bias, float* __restrict__ out,
                                         float* __restrict__ partial, const Geo& g) {
  constexpr int TX = BN / TN, TY = SLAB_BM / TM, NT = TX * TY, BK = Slab<float>::BK;
  constexpr int LDS = (MODE == PACKED ? 3 : 1) * BK + Slab<float>::PAD;
  constexpr int LDB = BN + Slab<float>::PAD, BSZ = 9 * BK * LDB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int SSZ = g.rows * LDS;
  float* S = reinterpret_cast<float*>(smem_raw);
  float* Bs = S + SLAB_STAGES * SSZ;
  int2* tab = reinterpret_cast<int2*>(Bs + SLAB_STAGES * BSZ);
  int plane0, p0;
  slab_origin(g, blockIdx.x, &plane0, &p0);
  build_table<MODE>(tab, g, plane0, p0);
  __syncthreads();
  const int nch = (g.Ci + BK - 1) / BK, sbeg = blockIdx.z * g.per;
  const int nk = min(g.per, 3 * nch - sbeg), n0 = blockIdx.y * BN;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  int abase[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    long long v;
    abase[i] = max(out_row<MODE>(g, ty + i * TY, plane0, p0, &v), 0) * LDS;
  }
  const int ths = th_stride<float, MODE>(g);

  float acc[TM][TN] = {};
#pragma unroll
  for (int s = 0; s < SLAB_STAGES - 1; ++s) {
    if (s < nk)
      load_stage<float, MODE, BN, NT>(S + s * SSZ, Bs + s * BSZ, tab, x, wt, g, nch, sbeg + s, n0);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<SLAB_STAGES - 2>();
    __syncthreads();
    const int nx = kt + SLAB_STAGES - 1;
    if (nx < nk)
      load_stage<float, MODE, BN, NT>(S + (nx % SLAB_STAGES) * SSZ, Bs + (nx % SLAB_STAGES) * BSZ,
                                      tab, x, wt, g, nch, sbeg + nx, n0);
    cp_async_commit();
    const float* a = S + (kt % SLAB_STAGES) * SSZ;
    const float* b = Bs + (kt % SLAB_STAGES) * BSZ;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int off = tap_offset<float, MODE>(tap / 3, tap % 3, ths);
      const float* bt = b + tap * BK * LDB;
#pragma unroll
      for (int k4 = 0; k4 < BK; k4 += 4) {
        float4 av[TM];
#pragma unroll
        for (int i = 0; i < TM; ++i)
          av[i] = *reinterpret_cast<const float4*>(a + abase[i] + off + k4);
#pragma unroll
        for (int kq = 0; kq < 4; ++kq) {
          float bv[TN];
#pragma unroll
          for (int j = 0; j < TN / 4; ++j)
            *reinterpret_cast<float4*>(bv + 4 * j) =
                *reinterpret_cast<const float4*>(bt + (k4 + kq) * LDB + (tx + j * TX) * 4);
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            const float ai = reinterpret_cast<const float*>(&av[i])[kq];
#pragma unroll
            for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(ai, bv[j], acc[i][j]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  const long long M = (long long)g.B * g.D * g.H * g.W;
  float* dst = partial == nullptr ? out : partial + (long long)blockIdx.z * M * g.Co;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    long long m;
    if (out_row<MODE>(g, ty + i * TY, plane0, p0, &m) < 0) continue;
#pragma unroll
    for (int j = 0; j < TN / 4; ++j) {
      const int n = n0 + (tx + j * TX) * 4;
      if (n >= g.Co) continue;
      float4 v = make_float4(acc[i][4 * j], acc[i][4 * j + 1], acc[i][4 * j + 2],
                             acc[i][4 * j + 3]);
      if (partial == nullptr && bias != nullptr) {
        v.x += bias[n]; v.y += bias[n + 1]; v.z += bias[n + 2]; v.w += bias[n + 3];
      }
      *reinterpret_cast<float4*>(dst + m * g.Co + n) = v;
    }
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

constexpr int SLAB_THREADS = 256;  // every instantiation's block
constexpr int ERR_BAD_TILE = (int)cudaErrorInvalidValue;

// A kernel of the template (x, wt, bias, out, partial, geometry)
template <typename T>
using SlabKernel = void (*)(const T*, const T*, const T*, T*, float*, const Geo);

// Dynamic shared memory of one block (ops/conv3d_packed.py::smem_bytes)
template <typename T, int MODE>
size_t slab_smem(const Geo& g, int bn) {
  constexpr int BK = Slab<T>::BK, PAD = Slab<T>::PAD, LDS = (MODE == PACKED ? 3 : 1) * BK + PAD;
  return sizeof(T) * SLAB_STAGES * ((size_t)g.rows * LDS + 9 * BK * (bn + PAD)) +
         sizeof(int2) * g.rows;
}

// One launch of `kernel` (the caller's instantiation for tile width bn, or
// nullptr where it has none) over tiles x ceil(Co / bn) x S blocks.  The
// geometry (P, L, tpp, R, rows, tiles) comes from ops/conv3d_packed.py::tiles
// and ::slab_rows; with S > 1 K-splits of `per` stages each, the splits'
// partials ((S, M, Co) f32) are added in order by a second launch.  Returns
// a CUDA error code.
template <typename T, int MODE>
int launch_slab(SlabKernel<T> kernel, const void* x, const void* wt, const void* bias, void* out,
                void* partial, int B, int D, int H, int W, int Ci, int Co, int P, int L, int tpp,
                int R, int rows, int tiles, int bn, int S, int per, void* stream_) {
  if (kernel == nullptr) return ERR_BAD_TILE;
  const Geo g{B, D, H, W, Ci, Co, P, L, tpp, R, rows, per};
  const cudaStream_t stream = (cudaStream_t)stream_;
  const size_t smem = slab_smem<T, MODE>(g, bn);
  if (const int e = prepare(kernel, smem)) return e;
  const dim3 grid((unsigned)tiles, (unsigned)((Co + bn - 1) / bn), (unsigned)S);
  const T* bp = (const T*)bias;
  T* op = (T*)out;
  kernel<<<grid, SLAB_THREADS, smem, stream>>>((const T*)x, (const T*)wt, bp, op,
                                               S > 1 ? (float*)partial : nullptr, g);
  const int err = (int)cudaGetLastError();
  if (err || S == 1) return err;
  const long long n = (long long)B * D * H * W * Co;
  conv3d_fwd_kernel_splitsum<T><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      (const float*)partial, bp, op, S, n, Co);
  return (int)cudaGetLastError();
}

}  // namespace
