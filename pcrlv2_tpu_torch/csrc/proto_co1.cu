// The kernel prototype tool's Co=1 SAME 3x3x3 conv (no bias) for Hopper
// (sm_90a), in its two formulations.  x is NDHWC (B, D, H, W, Ci); the
// output is (B, D, H, W), the single channel squeezed.
//
// co1_stencil replaces the Pallas TPU kernel
// tools/proto_co1_kernel.py::_co1_kernel: 27 multiply-adds on (H, W, Ci)
// slabs, then a sum over Ci.  Weights w27 (27, Ci), tap t = 9*td + 3*th + tw.
// Bound on the H100: bytes.  54 FLOPs per input element, far under the
// card's FLOP-per-byte balance, so the least time is reading x once.
// It computes the mask heads' forward (#3), so co1_stencil_kernel runs #3's
// block template (head_fwd.cuh; head_conv.cu's header gives the design):
// 128-voxel halo tiles, each block walking the depth planes of a chunk on a
// 2-stage ring of 16-byte cp.async copies, per-plane tap partials summed
// over channel chunks (bf16: mma.sync, each product exact in f32; f32: an
// FMA micro-tile, no TF32), three rolling f32 accumulators a voxel, the
// geometry of ops/head_conv.py (tile, fwd_split).  The template reads w27
// where it lies, through its strides (kc = 1, kt = Ci): no transpose launch.
// (The TPU kernel forms each product in the input type and widens it; here
// the inputs are multiplied in f32.)
// A block holds the weights of at most MAX_CI = 512 channels in shared
// memory.  Larger Ci is split on the grid's y axis into slices of at most
// 512 channels (multiples of the ring's channel chunk); each slice's blocks
// write f32 partial sums, which conv3d_fwd_kernel_splitsum adds in slice
// order (no atomics).  A split, not a cp.async ring for the weights: it
// runs the template and the sum as they are, where a weight ring would
// change the template #3 runs, and no shape of the model or the tool has
// Ci above 512.  Ci the 16-byte copies cannot take (not a multiple of 8
// bf16 / 4 f32) run on zero-padded channels (the wrapper's padded route).
//
// co1_band replaces tools/proto_co1_kernel.py::_co1_band_kernel: the same
// function as 9 banded matrix products, out[(b, d), h, :] = sum over (td, th)
// of xpad[b, d + td, h + th].reshape((W+2)*Ci) @ band[3*td + th], with
// band (9, (W+2)*Ci, W) built by the caller (band[(wi, c), wo] = w[td, th,
// wi - wo, c] for wi - wo in {0, 1, 2}, else 0).  The kernel computes that
// product as given, zeros included: (W+2)/3 times the conv's useful FLOPs.
// Bound on the H100: bytes for the conv's useful work (54 FLOPs per input
// element); the banded product's own FLOPs are (W+2)/3 times larger, 0.19
// ms at the bf16 tensor-core peak at the tool's B = 32 shapes, against 0.20
// ms to read x once.  So the design keeps the product on the tensor cores
// and reads x as few times as it can.
//
// Design: a tensor-core GEMM, M = B*D*H output rows (b, d, h), N = W, K = 9
// taps x (W+2)*Ci.  A block takes BM = 256 consecutive rows (P whole
// planes of H rows where H < BM, else a band of one plane; 128 where the
// slab of 256 one-row planes would not fit) x all N columns (a 16- or
// 32-wide tile; a wider N takes more column tiles): 256 rows measured
// 20-35 % faster than 128 on the H100, as each block re-reads the whole
// band from L2.  It walks K in stages of one depth tap td and one chunk of
// BK = 64 (bf16) / 32 (f32) columns of the (W+2)*Ci row, the chunks outer
// and td inner, so the three depth planes of a chunk are read close in
// time and neighbouring blocks, which share planes, find them in L2 (td
// outer, whose three reads of a plane come a third of a block's life
// apart, measured 1.6x slower).  A stage holds, in a 2-stage 16-byte
// cp.async ring, the slab of depth plane d + td - 1 (the tile's rows plus
// one halo row above and below in each plane segment; zero-filled for the
// d/h halo, the w-pad columns k < Ci and k >= (W+1)*Ci, and ragged M) and
// the 3 band tiles band[3*td + th][k0 : k0 + BK, :].  The 3 th taps read
// the slab at row offsets 0, 1, 2 of their segment, so each input row is
// staged 3 times per tile (once per td), not 9.  A row of A is the
// contiguous (W, Ci) row of x between the Ci zeros of the w pad, so no
// padded copy of x is made.  bf16: mma.sync m16n8k16 (ldmatrix from the
// slab and, transposed, from the band tiles), f32 accumulation.  f32: a
// TM x 4 FMA micro-tile (no TF32) fed by the same ring.  The full product
// is computed, zeros included, as the TPU kernel's jnp.dot: the answer is
// the plain version's for any band.  Where the grid is short of the card
// the wrapper splits the stages S ways; each split writes f32 partials and
// conv3d_fwd_kernel_splitsum adds them in split order (no atomics).  Ci or
// W the 16-byte copies cannot take (not multiples of 8 bf16 / 4 f32) run
// on zero-padded channels and band columns (the wrapper's padded route).

#include "head_fwd.cuh"

namespace {

// ---- co1_stencil: #3's forward template on w27 ----------------------------

// Block = (sample, tile, depth chunk) of blockIdx.x and the channel slice
// blockIdx.y of `cs` channels.  OutT = T: the output; f32: the slice's
// partial sums, slice s at out + s*B*D*H*W.
template <typename T, typename OutT>
__global__ void __launch_bounds__(HT, 2)
co1_stencil_kernel(const T* __restrict__ x, const T* __restrict__ w27, OutT* __restrict__ out,
                   int B, int D, int H, int W, int Ci, int cs, int chunk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int c0 = blockIdx.y * cs;
  head_fwd_block<T, OutT>(smem_raw, x + c0, w27 + c0, 1, Ci,
                          out + (long long)blockIdx.y * B * D * H * W, B, D, H, W,
                          min(cs, Ci - c0), Ci, chunk);
}

// ---- co1_band --------------------------------------------------------------

constexpr int BAND_STAGES = 2;     // ring depth (a third stage measured no faster)
constexpr int BAND_THREADS = 256;  // 8 warps

// K columns of one stage (128 bytes of a row) and row pad, per dtype
template <typename T> struct BandK;
template <> struct BandK<bf16> { static constexpr int BK = 64, PAD = 8; };
template <> struct BandK<float> { static constexpr int BK = 32, PAD = 4; };

struct BandGeo {
  int B, D, H, W, Ci, N;  // N: band columns, the output row's length (W or W padded)
  int P, L, tpp, rows;    // planes per tile, rows per segment, tiles per plane, slab rows
  int per;                // stages per K split
};

// The tile's first plane and first h.  P == 1: tile t is segment t % tpp (L
// consecutive h) of plane t / tpp; P > 1: tile t is planes t*P .. t*P + P -
// 1, whole.
__device__ __forceinline__ void band_origin(const BandGeo& g, int t, int* plane0, int* h0) {
  *plane0 = g.P == 1 ? t / g.tpp : t * g.P;
  *h0 = g.P == 1 ? (t % g.tpp) * g.L : 0;
}

// tab[j] = the source of slab row j: {x row (plane*H + h), d}, or {-1, 0}
// for a halo row off the plane or past the last plane.  Segment s of the
// slab holds rows h0 - 1 .. h0 + L of plane plane0 + s.
__device__ __forceinline__ void band_table(int2* tab, const BandGeo& g, int plane0, int h0) {
  const int seg = g.L + 2;
  for (int j = threadIdx.x; j < g.rows; j += blockDim.x) {
    const int s = j / seg, h = h0 - 1 + (j - s * seg), plane = plane0 + s;
    const bool ok = plane < g.B * g.D && h >= 0 && h < g.H;
    tab[j] = ok ? make_int2(plane * g.H + h, plane % g.D) : make_int2(-1, 0);
  }
}

// Slab row of output row r at th = 0, or -1 past the tile; *m = its output row.
__device__ __forceinline__ int band_row(const BandGeo& g, int r, int plane0, int h0,
                                        long long* m) {
  const int s = r / g.L, q = r - s * g.L, plane = plane0 + s, h = h0 + q;
  if (s >= g.P || plane >= g.B * g.D || h >= g.H) return -1;
  *m = (long long)plane * g.H + h;
  return s * (g.L + 2) + q;
}

// Fill one ring slot with stage st = (td, chunk) = (st % 3, st / 3): the
// slab of depth plane d + td - 1 (rows x BK, row stride LDS), zero for the
// d/h halo, the w-pad columns (k < Ci, k >= (W+1)*Ci) and past K, and the
// band tiles band[3*td + th][k0 : k0 + BK, n0 : n0 + BN] (row stride LDB).
template <typename T, int BN>
__device__ __forceinline__ void band_stage(T* S, T* Bs, const int2* tab, const T* __restrict__ x,
                                           const T* __restrict__ band, const BandGeo& g,
                                           int st, int n0) {
  constexpr int BK = BandK<T>::BK, PAD = BandK<T>::PAD, VEC = 16 / sizeof(T), V = BK / VEC;
  constexpr int LDS = BK + PAD, LDB = BN + PAD, NV = BN / VEC, NB = 3 * BK * NV;
  const int kc = st / 3, td = st - 3 * kc, k0 = kc * BK;
  const int K = (g.W + 2) * g.Ci, kx = (g.W + 1) * g.Ci;  // row length; x fills [Ci, kx)
  const long long rowlen = (long long)g.W * g.Ci, dshift = (long long)(td - 1) * g.H;
  for (int e = threadIdx.x; e < g.rows * V; e += BAND_THREADS) {
    const int row = e / V, c = (e - row * V) * VEC, k = k0 + c;
    const int2 t = tab[row];
    const bool ok = t.x >= 0 && (unsigned)(t.y + td - 1) < (unsigned)g.D && k >= g.Ci && k < kx;
    cp_async16(S + row * LDS + c, ok ? x + (t.x + dshift) * rowlen + (k - g.Ci) : x, ok);
  }
  for (int e = threadIdx.x; e < NB; e += BAND_THREADS) {
    const int th = e / (BK * NV), rem = e - th * (BK * NV);
    const int kk = rem / NV, nv = rem - kk * NV, k = k0 + kk, n = n0 + nv * VEC;
    const bool ok = k < K && n < g.N;
    cp_async16(Bs + (th * BK + kk) * LDB + nv * VEC,
               ok ? band + ((long long)(3 * td + th) * K + k) * g.N + n : band, ok);
  }
}

// out[m, n] = the block's K split of the banded product in bf16 on tensor
// cores: 8 warps of BM/8 rows x BN columns; with partial set, the split's
// f32 sum goes to partial[z] instead of out.
template <int BM, int BN>
__global__ void __launch_bounds__(BAND_THREADS)
co1_band_kernel_mma(const bf16* __restrict__ x, const bf16* __restrict__ band,
                    bf16* __restrict__ out, float* __restrict__ partial, const BandGeo g) {
  constexpr int BK = BandK<bf16>::BK, LDS = BK + BandK<bf16>::PAD, LDB = BN + BandK<bf16>::PAD;
  constexpr int WM = BM / (BAND_THREADS / 32), MI = WM / 16, NI = BN / 8, BSZ = 3 * BK * LDB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int SSZ = g.rows * LDS;
  bf16* S = reinterpret_cast<bf16*>(smem_raw);
  bf16* Bs = S + BAND_STAGES * SSZ;
  int2* tab = reinterpret_cast<int2*>(Bs + BAND_STAGES * BSZ);
  int plane0, h0;
  band_origin(g, blockIdx.x, &plane0, &h0);
  band_table(tab, g, plane0, h0);
  __syncthreads();
  const int nkc = ((g.W + 2) * g.Ci + BK - 1) / BK, sbeg = blockIdx.z * g.per;
  const int nk = min(g.per, 3 * nkc - sbeg), n0 = blockIdx.y * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int abase[MI];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
    long long m;
    const int r = band_row(g, warp * WM + mi * 16 + (lane & 15), plane0, h0, &m);
    abase[mi] = max(r, 0) * LDS + (lane >> 4) * 8;
  }

  float acc[MI][NI][4] = {};
#pragma unroll
  for (int s = 0; s < BAND_STAGES - 1; ++s) {
    if (s < nk) band_stage<bf16, BN>(S + s * SSZ, Bs + s * BSZ, tab, x, band, g, sbeg + s, n0);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<BAND_STAGES - 2>();
    __syncthreads();  // stage kt landed; every warp is done with stage kt-1's slot
    const int nx = kt + BAND_STAGES - 1;
    if (nx < nk)
      band_stage<bf16, BN>(S + (nx % BAND_STAGES) * SSZ, Bs + (nx % BAND_STAGES) * BSZ, tab, x,
                           band, g, sbeg + nx, n0);
    cp_async_commit();
    const bf16* a = S + (kt % BAND_STAGES) * SSZ;
    const bf16* b = Bs + (kt % BAND_STAGES) * BSZ;
#pragma unroll
    for (int th = 0; th < 3; ++th)
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks) {
        unsigned af[MI][4], bfr[NI][2];
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) ldsm_x4(af[mi], a + abase[mi] + th * LDS + ks * 16);
        const bf16* bt = b + (th * BK + ks * 16) * LDB;
#pragma unroll
        for (int nj = 0; nj < NI / 2; ++nj) {
          unsigned r[4];
          ldsm_x4_trans(r, bt + ((lane & 7) + ((lane >> 3) & 1) * 8) * LDB + nj * 16 +
                               (lane >> 4) * 8);
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

  const long long M = (long long)g.B * g.D * g.H;
  float* dst = partial == nullptr ? nullptr : partial + (long long)blockIdx.z * M * g.N;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      long long m;
      if (band_row(g, warp * WM + mi * 16 + (lane >> 2) + half * 8, plane0, h0, &m) < 0) continue;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int n = n0 + ni * 8 + (lane & 3) * 2;
        if (n >= g.N) continue;
        const float v0 = acc[mi][ni][2 * half], v1 = acc[mi][ni][2 * half + 1];
        if (dst != nullptr)
          *reinterpret_cast<float2*>(dst + m * g.N + n) = make_float2(v0, v1);
        else
          *reinterpret_cast<__nv_bfloat162*>(out + m * g.N + n) = __floats2bfloat162_rn(v0, v1);
      }
    }
}

// The same in f32 on CUDA cores: a TM x 4 micro-tile per thread, rows ty +
// i*TY, columns the float4 group tx (a warp's float4 reads of a band row are
// contiguous; its slab reads are broadcasts of 4 or 8 rows in distinct banks).
template <int BM, int BN>
__global__ void __launch_bounds__(BAND_THREADS)
co1_band_kernel_fma(const float* __restrict__ x, const float* __restrict__ band,
                    float* __restrict__ out, float* __restrict__ partial, const BandGeo g) {
  constexpr int BK = BandK<float>::BK, LDS = BK + BandK<float>::PAD, LDB = BN + BandK<float>::PAD;
  constexpr int TX = BN / 4, TY = BAND_THREADS / TX, TM = BM / TY, BSZ = 3 * BK * LDB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int SSZ = g.rows * LDS;
  float* S = reinterpret_cast<float*>(smem_raw);
  float* Bs = S + BAND_STAGES * SSZ;
  int2* tab = reinterpret_cast<int2*>(Bs + BAND_STAGES * BSZ);
  int plane0, h0;
  band_origin(g, blockIdx.x, &plane0, &h0);
  band_table(tab, g, plane0, h0);
  __syncthreads();
  const int nkc = ((g.W + 2) * g.Ci + BK - 1) / BK, sbeg = blockIdx.z * g.per;
  const int nk = min(g.per, 3 * nkc - sbeg), n0 = blockIdx.y * BN;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  int abase[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    long long m;
    abase[i] = max(band_row(g, ty + i * TY, plane0, h0, &m), 0) * LDS;
  }

  float acc[TM][4] = {};
#pragma unroll
  for (int s = 0; s < BAND_STAGES - 1; ++s) {
    if (s < nk)
      band_stage<float, BN>(S + s * SSZ, Bs + s * BSZ, tab, x, band, g, sbeg + s, n0);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<BAND_STAGES - 2>();
    __syncthreads();
    const int nx = kt + BAND_STAGES - 1;
    if (nx < nk)
      band_stage<float, BN>(S + (nx % BAND_STAGES) * SSZ, Bs + (nx % BAND_STAGES) * BSZ, tab, x,
                            band, g, sbeg + nx, n0);
    cp_async_commit();
    const float* a = S + (kt % BAND_STAGES) * SSZ;
    const float* b = Bs + (kt % BAND_STAGES) * BSZ + tx * 4;
#pragma unroll
    for (int th = 0; th < 3; ++th)
#pragma unroll
      for (int k4 = 0; k4 < BK; k4 += 4) {
        float4 av[TM];
#pragma unroll
        for (int i = 0; i < TM; ++i)
          av[i] = *reinterpret_cast<const float4*>(a + abase[i] + th * LDS + k4);
#pragma unroll
        for (int kq = 0; kq < 4; ++kq) {
          const float4 bv = *reinterpret_cast<const float4*>(b + (th * BK + k4 + kq) * LDB);
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            const float ai = reinterpret_cast<const float*>(&av[i])[kq];
            acc[i][0] = fmaf(ai, bv.x, acc[i][0]);
            acc[i][1] = fmaf(ai, bv.y, acc[i][1]);
            acc[i][2] = fmaf(ai, bv.z, acc[i][2]);
            acc[i][3] = fmaf(ai, bv.w, acc[i][3]);
          }
        }
      }
  }
  cp_async_wait<0>();

  const long long M = (long long)g.B * g.D * g.H;
  float* dst = partial == nullptr ? out : partial + (long long)blockIdx.z * M * g.N;
  const int n = n0 + tx * 4;
  if (n >= g.N) return;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    long long m;
    if (band_row(g, ty + i * TY, plane0, h0, &m) < 0) continue;
    *reinterpret_cast<float4*>(dst + m * g.N + n) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

template <typename T>
using BandKernel = void (*)(const T*, const T*, T*, float*, const BandGeo);

// The kernel of a tile of bm rows x bn columns (tools/proto_co1_kernel.py::band_tiles)
template <typename T>
BandKernel<T> band_kernel(int bm, int bn) {
  if constexpr (sizeof(T) == 2)
    return bm == 128 ? (bn == 32 ? &co1_band_kernel_mma<128, 32>
                        : bn == 16 ? &co1_band_kernel_mma<128, 16> : nullptr)
         : bm == 256 ? (bn == 32 ? &co1_band_kernel_mma<256, 32>
                        : bn == 16 ? &co1_band_kernel_mma<256, 16> : nullptr)
         : nullptr;
  else
    return bm == 128 ? (bn == 32 ? &co1_band_kernel_fma<128, 32>
                        : bn == 16 ? &co1_band_kernel_fma<128, 16> : nullptr)
         : bm == 256 ? (bn == 32 ? &co1_band_kernel_fma<256, 32>
                        : bn == 16 ? &co1_band_kernel_fma<256, 16> : nullptr)
         : nullptr;
}

// One stencil (geometry from tools/proto_co1_kernel.py::stencil_geometry):
// S = ceil(Ci / cs) channel slices; S > 1 needs partial, (S, B*D*H*W) f32,
// whose slices a second launch adds in order.  Returns a CUDA error code.
template <typename T>
int launch_stencil(const void* x, const void* w27, void* out, void* partial, int B, int D,
                   int H, int W, int Ci, int cs, int chunk, void* stream_) {
  if (Ci % Cfg<T>::VEC || cs < 1 || cs > MAX_CI || (cs < Ci && cs % Cfg<T>::CK) || chunk < 1)
    return (int)cudaErrorInvalidValue;
  const int S = (Ci + cs - 1) / cs;
  if (S > 1 && partial == nullptr) return (int)cudaErrorInvalidValue;
  const cudaStream_t stream = (cudaStream_t)stream_;
  const int TW = tile_w(W), TH = HT / TW;
  const long long tiles = (long long)B * ((H + TH - 1) / TH) * ((W + TW - 1) / TW) *
                          ((D + chunk - 1) / chunk);
  const dim3 grid((unsigned)tiles, (unsigned)S);
  const size_t smem = fwd_smem<T>(cs < Ci ? cs : Ci);
  if (S == 1) {
    if (const int err = prepare(co1_stencil_kernel<T, T>, smem)) return err;
    co1_stencil_kernel<T, T><<<grid, HT, smem, stream>>>((const T*)x, (const T*)w27, (T*)out,
                                                          B, D, H, W, Ci, Ci, chunk);
    return (int)cudaGetLastError();
  }
  if (const int err = prepare(co1_stencil_kernel<T, float>, smem)) return err;
  co1_stencil_kernel<T, float><<<grid, HT, smem, stream>>>(
      (const T*)x, (const T*)w27, (float*)partial, B, D, H, W, Ci, cs, chunk);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  const long long n = (long long)B * D * H * W;
  conv3d_fwd_kernel_splitsum<T><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      (const float*)partial, nullptr, (T*)out, S, n, 1);
  return (int)cudaGetLastError();
}

// One launch of the banded product (geometry from
// tools/proto_co1_kernel.py::band_tiles, tile bm x bn, S K-splits of `per`
// stages each; S > 1 needs partial, (S, B*D*H, N) f32, whose splits a second
// launch adds in order); returns a CUDA error code.
template <typename T>
int launch_band(const void* x, const void* band, void* out, void* partial, int B, int D, int H,
                int W, int Ci, int N, int P, int L, int tpp, int rows, int tiles, int bm, int bn,
                int S, int per, void* stream_) {
  const BandKernel<T> kernel = band_kernel<T>(bm, bn);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  const cudaStream_t stream = (cudaStream_t)stream_;
  const BandGeo g{B, D, H, W, Ci, N, P, L, tpp, rows, per};
  constexpr int BK = BandK<T>::BK, PAD = BandK<T>::PAD;
  const size_t smem = sizeof(T) * BAND_STAGES * ((size_t)rows * (BK + PAD) + 3 * BK * (bn + PAD)) +
                      sizeof(int2) * rows;
  if (const int e = prepare(kernel, smem)) return e;
  const dim3 grid((unsigned)tiles, (unsigned)((N + bn - 1) / bn), (unsigned)S);
  kernel<<<grid, BAND_THREADS, smem, stream>>>((const T*)x, (const T*)band, (T*)out,
                                               S > 1 ? (float*)partial : nullptr, g);
  const int err = (int)cudaGetLastError();
  if (err || S == 1) return err;
  const long long n = (long long)B * D * H * N;
  conv3d_fwd_kernel_splitsum<T><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      (const float*)partial, nullptr, (T*)out, S, n, N);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (B, D, H, W, Ci), w27 (27, Ci), out (B, D, H, W); Ci a multiple of 8
// (bf16) or 4 (f32), x 16-byte aligned; cs channels a slice (Ci, or at most
// MAX_CI and a multiple of the ring's chunk), partial (S, B*D*H*W) f32 for
// S > 1 slices; chunk output planes a block.
int co1_stencil_f32(const void* x, const void* w27, void* out, void* partial, int B, int D,
                    int H, int W, int Ci, int cs, int chunk, void* stream) {
  return launch_stencil<float>(x, w27, out, partial, B, D, H, W, Ci, cs, chunk, stream);
}

int co1_stencil_bf16(const void* x, const void* w27, void* out, void* partial, int B, int D,
                     int H, int W, int Ci, int cs, int chunk, void* stream) {
  return launch_stencil<bf16>(x, w27, out, partial, B, D, H, W, Ci, cs, chunk, stream);
}

// x (B, D, H, W, Ci), band (9, (W+2)*Ci, N), out (B, D, H, N); Ci and N
// multiples of 8 (bf16) or 4 (f32), pointers 16-byte aligned.
int co1_band_f32(const void* x, const void* band, void* out, void* partial, int B, int D, int H,
                 int W, int Ci, int N, int P, int L, int tpp, int rows, int tiles, int bm, int bn,
                 int S, int per, void* stream) {
  return launch_band<float>(x, band, out, partial, B, D, H, W, Ci, N, P, L, tpp, rows, tiles, bm,
                            bn, S, per, stream);
}

int co1_band_bf16(const void* x, const void* band, void* out, void* partial, int B, int D, int H,
                  int W, int Ci, int N, int P, int L, int tpp, int rows, int tiles, int bm, int bn,
                  int S, int per, void* stream) {
  return launch_band<bf16>(x, band, out, partial, B, D, H, W, Ci, N, P, L, tpp, rows, tiles, bm,
                           bn, S, per, stream);
}

}  // extern "C"
