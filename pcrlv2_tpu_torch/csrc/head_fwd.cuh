// The forward of the Co=1 SAME 3x3x3 conv as a block template for Hopper
// (sm_90a): head_conv.cu's #3 (head_fwd_kernel, the mask heads) and
// proto_co1.cu's #8 (co1_stencil_kernel, the prototype tool's stencil)
// each define their own __global__ kernel around head_fwd_block, so a
// profile tells them apart.  head_conv.cu's header describes the design:
// halo tiles of 128 voxels, a block walking the depth planes of a chunk on
// a 2-stage ring of 16-byte cp.async copies, per-plane tap partials summed
// over channel chunks in f32 (bf16: mma.sync; f32: an FMA micro-tile), three
// rolling f32 accumulators a voxel.  Also the constants and helpers that
// head_conv.cu's backward (#4) shares with it.
//
// What a caller chooses: the weights' two strides (k[c * kc + t * kt]:
// #3's k (Ci, 27) has kc = 27, kt = 1; #8's w27 (27, Ci) kc = 1, kt = Ci),
// the row stride of x (ldx >= Ci: a block may take a slice of the channels)
// and the output type (T, or f32 for a channel slice's partial sums, which
// conv3d_fwd_kernel_splitsum adds in order).
#pragma once

#include "conv_mma.cuh"

namespace {

constexpr int HT = 128;        // threads = output voxels of a tile
constexpr int RMAX = 208;      // halo rows (<= 204) rounded up to 16
constexpr int NMT = RMAX / 16; // m-tiles of the forward's partial product
constexpr int RP = 228;        // pitch of P's columns (>= RMAX, = 4 mod 32)
constexpr int MAX_CI = 512;
constexpr int NST = 2;         // stages of the cp.async rings (3 or 4 measured slower)

// Per dtype: the channels a ring stage holds (CK), the row pitch of a
// staged slab (LDX) and of G27 and K (LDG), the elements of a 16-byte copy.
// The pitches put the 8 rows of an ldmatrix (or the 4 rows a warp reads) in
// distinct banks.  (Half as many channels a stage in a 4-stage ring
// measured slower in both dtypes.)
template <typename T> struct Cfg;
template <> struct Cfg<bf16> {
  static constexpr int CK = 64, LDX = 72, LDG = 40, VEC = 8;  // 144- and 80-byte rows
};
template <> struct Cfg<float> {
  static constexpr int CK = 32, LDX = 36, LDG = 36, VEC = 4;
};

// Tile width follows W (32, 16, 8 or 4) and TH = 128 / TW.
__host__ __device__ inline int tile_w(int W) {
  return W >= 32 ? 32 : W >= 16 ? 16 : W >= 8 ? 8 : 4;
}
__host__ __device__ inline int log2i(int v) { return v == 32 ? 5 : v == 16 ? 4 : v == 8 ? 3 : 2; }
__host__ __device__ inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

// ---------------------------------------------------------------------------
// the forward (#3, #8)
// ---------------------------------------------------------------------------

template <typename T>
constexpr size_t fwd_smem_fixed() {
  return sizeof(T) * NST * RMAX * Cfg<T>::LDX + sizeof(float) * 27 * RP;
}
template <typename T>
size_t fwd_smem(int Ci) {
  return fwd_smem_fixed<T>() + sizeof(T) * (size_t)round_up(Ci, Cfg<T>::CK) * Cfg<T>::LDG;
}

// P_z (rows x 32) += slab (rows x CK) @ k[c0 .. c0+CK) (CK x 32), f32 result
// in per-thread registers: bf16 on mma.sync, warp w owning m-tiles w + 4i.
__device__ __forceinline__ void fwd_product(float (&acc)[4][1][4][4], const bf16* xs,
                                            const bf16* ks, int nks, int R, int warp,
                                            int lane) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int mt = warp + 4 * i;
    if (mt >= NMT || mt * 16 >= R) continue;
    for (int kk = 0; kk < nks; ++kk)
      mma_step<1, 4, false>(acc[i], xs + mt * 16 * Cfg<bf16>::LDX + kk * 16, Cfg<bf16>::LDX,
                            ks + kk * 16 * Cfg<bf16>::LDG, Cfg<bf16>::LDG, lane);
  }
}

// f32: thread (rg = tid / 8, cg = tid % 8) owns rows rg + 16j (j < 13) and
// columns 4cg .. 4cg+3.  Only the first R rows (the halo tile's rows that
// the plane reaches) are computed; FULL: all of them.
template <bool FULL>
__device__ __forceinline__ void fwd_product(float (&acc)[NMT][4], const float* xs,
                                            const float* ks, int nk, int R, int tid) {
  const int rg = tid >> 3, cg = tid & 7;
  for (int k = 0; k < nk; k += 4) {
    float4 kv[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      kv[u] = *reinterpret_cast<const float4*>(ks + (k + u) * Cfg<float>::LDG + 4 * cg);
#pragma unroll
    for (int j = 0; j < NMT; ++j) {
      if (!FULL && 16 * j >= R) break;
      const float4 xv =
          *reinterpret_cast<const float4*>(xs + (rg + 16 * j) * Cfg<float>::LDX + k);
      const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        acc[j][0] = fmaf(xa[u], kv[u].x, acc[j][0]);
        acc[j][1] = fmaf(xa[u], kv[u].y, acc[j][1]);
        acc[j][2] = fmaf(xa[u], kv[u].z, acc[j][2]);
        acc[j][3] = fmaf(xa[u], kv[u].w, acc[j][3]);
      }
    }
  }
}

__device__ __forceinline__ void store_p(float* P, const float (&acc)[4][1][4][4], int R,
                                        int warp, int lane) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int mt = warp + 4 * i;
    if (mt >= NMT) continue;
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = mt * 16 + (lane >> 2) + (e >> 1) * 8;
        const int col = ni * 8 + 2 * (lane & 3) + (e & 1);
        if (col < 27 && row < R) P[col * RP + row] = acc[i][0][ni][e];
      }
  }
}

__device__ __forceinline__ void store_p(float* P, const float (&acc)[NMT][4], int R, int tid) {
  const int rg = tid >> 3, cg = tid & 7;
#pragma unroll
  for (int j = 0; j < NMT; ++j)
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int row = rg + 16 * j, col = 4 * cg + u;
      if (col < 27 && row < R) P[col * RP + row] = acc[j][u];
    }
}

template <typename T> struct FwdAcc;
// The forward's per-plane partials in registers, summed over channel chunks.
template <> struct FwdAcc<bf16> {
  float v[4][1][4][4];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) v[i][0][j][e] = 0.f;
  }
};
template <> struct FwdAcc<float> {
  float v[NMT][4];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < NMT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) v[i][e] = 0.f;
  }
};


// One block: (sample, TH x TW tile, depth chunk of `chunk` output planes),
// decoded from blockIdx.x.  x holds the block's Ci channels at a row stride
// of ldx elements; out is (B, D, H, W).  smem_raw: fwd_smem<T>(Ci) bytes.
template <typename T, typename OutT>
__device__ __forceinline__ void head_fwd_block(unsigned char* smem_raw, const T* __restrict__ x,
                                               const T* __restrict__ k, int kc, int kt,
                                               OutT* __restrict__ out, int B, int D, int H,
                                               int W, int Ci, int ldx, int chunk) {
  using C = Cfg<T>;
  T* ring = reinterpret_cast<T*>(smem_raw);                        // [NST][RMAX][LDX]
  float* P = reinterpret_cast<float*>(ring + NST * RMAX * C::LDX);  // [27][RP]
  T* ks = reinterpret_cast<T*>(P + 27 * RP);                         // [CIP][LDG]

  const int TW = tile_w(W), lw = log2i(TW), TH = HT >> lw, SW = TW + 2;
  const int tiles_w = (W + TW - 1) / TW, tiles_h = (H + TH - 1) / TH;
  const int nsplit = (D + chunk - 1) / chunk;
  long long idx = blockIdx.x;
  const int sp = (int)(idx % nsplit); idx /= nsplit;
  const int w0 = (int)(idx % tiles_w) * TW; idx /= tiles_w;
  const int h0 = (int)(idx % tiles_h) * TH;
  const int b = (int)(idx / tiles_h);
  const int z0 = sp * chunk, z1 = min(D, z0 + chunk);
  const int R = (min(TH, H - h0) + 2) * SW;  // halo rows the plane reaches
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int cip = round_up(Ci, C::CK), nc = cip / C::CK;
  const long long plane = (long long)H * W;

  // this thread's copies of a stage: column part `cpart` of rows
  // (tid / CPR) + RPI*i; their in-plane offsets (-1: halo, zero fill; -2:
  // past the R rows) are fixed for the block
  constexpr int CPR = C::CK / C::VEC, RPI = HT / CPR, NCP = (RMAX + RPI - 1) / RPI;
  const int cpart = tid % CPR;
  int roff[NCP];
#pragma unroll
  for (int i = 0; i < NCP; ++i) {
    const int r = tid / CPR + RPI * i;
    const int hh = h0 + r / SW - 1, ww = w0 + r % SW - 1;
    roff[i] = r >= R ? -2
              : ((unsigned)hh < (unsigned)H && (unsigned)ww < (unsigned)W) ? hh * W + ww : -1;
  }
  for (int e = tid; e < cip * 32; e += HT) {
    const int c = e >> 5, t = e & 31;
    ks[c * C::LDG + t] = (c < Ci && t < 27) ? k[c * kc + t * kt] : from_f<T>(0.f);
  }
  __syncthreads();

  const int n_planes = z1 - z0 + 2, n_stages = n_planes * nc;
  auto load_stage = [&](int s) {  // one commit group a stage, empty past the last
    if (s < n_stages) {
      const int z = z0 - 1 + s / nc, c = (s % nc) * C::CK + cpart * C::VEC;
      const bool zin = (unsigned)z < (unsigned)D && c < Ci;
      const T* src = x + ((long long)b * D + (zin ? z : 0)) * plane * ldx + c;
      T* dst = ring + (s % NST) * RMAX * C::LDX + (tid / CPR) * C::LDX + cpart * C::VEC;
#pragma unroll
      for (int i = 0; i < NCP; ++i) {
        if (roff[i] == -2) break;
        const bool ok = zin && roff[i] >= 0;
        cp_async16(dst + RPI * i * C::LDX, ok ? src + (long long)roff[i] * ldx : x, ok);
      }
    }
    cp_async_commit();
  };

  FwdAcc<T> acc;
  float o_m1 = 0.f, o_0 = 0.f, o_p1 = 0.f;  // output planes z-1, z, z+1
  const int ly = tid >> lw, lx = tid & (TW - 1);
  const int h = h0 + ly, w = w0 + lx;
  for (int s = 0; s < NST - 1; ++s) load_stage(s);
  for (int s = 0; s < n_stages; ++s) {
    cp_async_wait<NST - 2>();
    __syncthreads();  // stage s has landed; everyone is done with stage s-1 and P
    load_stage(s + NST - 1);
    const int pi = s / nc, ci = s % nc, c0 = ci * C::CK;
    if (ci == 0) acc.zero();
    const T* xs = ring + (s % NST) * RMAX * C::LDX;
    const int nk = min(C::CK, round_up(Ci - c0, 16));
    if constexpr (sizeof(T) == 2)
      fwd_product(acc.v, xs, ks + c0 * C::LDG, nk / 16, R, warp, lane);
    else if (R > 16 * (NMT - 1))
      fwd_product<true>(acc.v, xs, ks + c0 * C::LDG, nk, R, tid);
    else
      fwd_product<false>(acc.v, xs, ks + c0 * C::LDG, nk, R, tid);
    if (ci != nc - 1) continue;
    if constexpr (sizeof(T) == 2) store_p(P, acc.v, R, warp, lane);
    else store_p(P, acc.v, R, tid);
    __syncthreads();
    const int base = ly * SW + lx;
#pragma unroll
    for (int th = 0; th < 3; ++th)
#pragma unroll
      for (int tw = 0; tw < 3; ++tw) {
        const int q = base + th * SW + tw, t = th * 3 + tw;
        o_p1 += P[t * RP + q];
        o_0 += P[(9 + t) * RP + q];
        o_m1 += P[(18 + t) * RP + q];
      }
    const int zo = z0 - 1 + pi - 1;  // output plane completed by this input plane
    if (zo >= z0 && h < H && w < W)
      out[((long long)b * D + zo) * plane + (long long)h * W + w] = from_f<OutT>(o_m1);
    o_m1 = o_0;
    o_0 = o_p1;
    o_p1 = 0.f;
  }
}

}  // namespace
