// Co=1 SAME 3x3x3 conv for Hopper (sm_90a): the deep-supervision mask heads.
// Forward (#3) and a fused backward (#4: dx and the filter gradient in one
// pass).  x is NDHWC (B, D, H, W, Ci); the kernel is flattened to k (Ci, 27)
// with tap t = 9*td + 3*th + tw; the output and its cotangent are (B, D, H, W).
//
//   out[p]   = sum_t sum_c x[p + off_t - 1, c] * k[c, t]
//   dx[q, c] = sum_t g(q - off_t + 1) * k[c, t]
//   dK[c, t] = sum_q x[q, c] * g(q - off_t + 1)
//
// Replaces the Pallas TPU kernels pcrlv2_tpu/ops/head_conv.py::_pallas_kernel
// (forward) and ::_pallas_bwd_kernel (fused backward).
//
// Bound on the H100: bytes.  A voxel's output is a 27*Ci dot product with one
// result, 54 FLOPs per element of x, far under the card's FLOP-per-byte
// balance, so the least time is reading x once (and, backward, writing dx
// once).  What the design does about it:
//
// Forward.  A block (4 warps) owns a TH x TW tile (128 voxels, TW follows W)
// of one sample's (H, W) plane plus its 1-voxel halo, R = (TH+2)(TW+2) <=
// 204 rows (fewer where the plane ends inside the tile: only those are
// staged and multiplied), and walks the input depth planes of a depth chunk
// in order: the TPU's grid axis over d becomes this loop.  A 2-stage ring of
// 16-byte cp.async copies stages (plane, 64 bf16 or 32 f32 channels) slabs
// of the halo tile; each thread keeps its rows' sources in registers, so a
// copy is one address and one cp.async, and halos and the planes beyond D
// come from the zero fill (x needs no padded copy).  Each plane's tap
// partials P_z[v, t] = sum_c x_z[v, c] * k[c, t] (the TPU's "(hw, Ci) @
// (Ci, 9) per depth plane", 27 columns padded to 32) are summed over the
// channel chunks in f32 registers (bf16: mma.sync m16n8k16 fed by ldmatrix;
// f32: an FMA micro-tile, no TF32) and written once per plane to shared
// memory.  Each thread then owns one output voxel and keeps three f32
// accumulators, for the output planes z+1, z and z-1 that plane z feeds
// (td = 0, 1, 2), adding its 9 (th, tw) neighbours' partials; output plane
// z-1 is then complete and is written with one rounding.  x crosses device
// memory once per depth chunk; the halo rows, (TH+2)(TW+2)/(TH*TW) = 1.6x at
// TW = 32, are shared with the neighbouring tiles through L2.  Grids short
// of the card split D into chunks (each re-stages its 2 halo planes), as
// ops/head_conv.py::fwd_split chooses.  The forward's device code is the block
// template of head_fwd.cuh, which proto_co1.cu's stencil (#8) also runs.
//
// Backward.  A persistent grid of a fixed size (blocks of 8 warps) walks the
// per-plane tiles (128 voxels) in a fixed order.  Per tile it stages the g
// halo (3 planes x (TH+2)(TW+2) values, loaded into registers while the
// tile before is computed) and builds the shifted-cotangent matrix G27 (128
// x 32, g's own values, so exact in bf16).  Per channel chunk (64 bf16 or
// 32 f32), x (no halo) arrives by the cp.async ring; the block adds x^T @
// G27 to its f32 dK partial in shared memory and computes the dx tile G27 @
// K^T, written with 16-byte stores.  bf16: both on mma.sync (x^T read by
// ldmatrix.trans), dx staged through shared memory.  f32: FMA micro-tiles,
// warps 0-3 on dK and warps 4-7 on dx at the same time.  x and dx cross
// device memory once.  Each block writes its dK partial; a second launch
// adds the partials in a fixed order (no atomics: the same dK on every run).
//
// Channels: Ci must be a multiple of 8 (bf16) or 4 (f32) for the 16-byte
// copies and at most MAX_CI; the wrapper zero-pads other counts.

#include <climits>

#include "head_fwd.cuh"

namespace {

// ---------------------------------------------------------------------------
// #3: forward, on head_fwd.cuh's block template
// ---------------------------------------------------------------------------

// Block = (sample, TH x TW tile, depth chunk of `chunk` output planes).
template <typename T>
__global__ void __launch_bounds__(HT, 2)
head_fwd_kernel(const T* __restrict__ x, const T* __restrict__ k, T* __restrict__ out,
                int B, int D, int H, int W, int Ci, int chunk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  head_fwd_block<T, T>(smem_raw, x, k, 27, 1, out, B, D, H, W, Ci, Ci, chunk);
}

// ---------------------------------------------------------------------------
// #4: fused backward
// ---------------------------------------------------------------------------

constexpr int BT = 256;      // threads of a backward block (8 warps, 128-voxel tiles)
constexpr int GS = 3 * 204;  // g halo slab (3 planes x at most 204 rows)

template <typename T>
size_t bwd_smem(int Ci) {
  using C = Cfg<T>;
  const int cip = round_up(Ci, C::CK);
  return sizeof(T) * (NST * HT * C::LDX + HT * C::LDG + 32 * (cip + C::VEC)) +
         sizeof(float) * (cip * 32 + GS);
}

// Register budget: bf16 runs 3 blocks an SM; f32 (whose dx micro-tile
// spills under that budget) 2 (ops/head_conv.py::BWD_BLOCKS_PER_SM).
template <typename T>
__global__ void __launch_bounds__(BT, sizeof(T) == 2 ? 3 : 2)
head_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g, const T* __restrict__ k,
                T* __restrict__ dx, float* __restrict__ partial, int B, int D, int H,
                int W, int Ci) {
  using C = Cfg<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int cip = round_up(Ci, C::CK), nc = cip / C::CK, ldk = cip + C::VEC;
  T* ring = reinterpret_cast<T*>(smem_raw);  // [NST][HT][LDX] x chunk, then dx
  T* G = ring + NST * HT * C::LDX;          // [HT][LDG]       G27
  T* kt = G + HT * C::LDG;                   // [32][ldk]       K^T
  float* dks = reinterpret_cast<float*>(kt + 32 * ldk);  // [cip][32] dK partial
  float* gs = dks + cip * 32;                            // [3][SN]   g halo

  const int TW = tile_w(W), lw = log2i(TW), TH = HT >> lw, SW = TW + 2;
  const int SN = (TH + 2) * SW;
  const int tiles_w = (W + TW - 1) / TW, tiles_h = (H + TH - 1) / TH;
  const int n_tiles = B * D * tiles_h * tiles_w;  // < 2^31 (checked at launch)
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long plane = (long long)H * W;

  for (int e = tid; e < 32 * ldk; e += BT) {
    const int t = e / ldk, c = e % ldk;
    kt[e] = (c < Ci && t < 27) ? k[c * 27 + t] : from_f<T>(0.f);
  }
  for (int e = tid; e < cip * 32; e += BT) dks[e] = 0.f;

  // a tile: its sample, plane, corner, and its corner's voxel index
  struct Tile { int b, z, h0, w0; long long base; };
  auto tile_of = [&](int ti) {
    Tile t;
    t.w0 = ti % tiles_w * TW; ti /= tiles_w;
    t.h0 = ti % tiles_h * TH; ti /= tiles_h;
    t.z = ti % D;
    t.b = ti / D;
    t.base = ((long long)t.b * D + t.z) * plane + (long long)t.h0 * W + t.w0;
    return t;
  };
  // stage s: channel chunk s % nc of the block's tile s / nc
  const int my_tiles = (n_tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int n_stages = my_tiles * nc;
  auto stage_tile = [&](int s) { return (int)blockIdx.x + s / nc * (int)gridDim.x; };
  constexpr int CPR = C::CK / C::VEC;
  // x (and dx) offset of voxel v of tile t; false outside the plane
  auto voxel = [&](const Tile& t, int v, long long& off) {
    const int vy = v >> lw, vx = v & (TW - 1);
    off = (t.base + vy * W + vx) * Ci;
    return t.h0 + vy < H && t.w0 + vx < W;
  };
  auto load_stage = [&](int s) {  // one commit group a stage, empty past the last
    if (s < n_stages) {
      const Tile t = tile_of(stage_tile(s));
      const int c = s % nc * C::CK + tid % CPR * C::VEC;
      T* dst = ring + (s % NST) * HT * C::LDX + tid % CPR * C::VEC;
#pragma unroll
      for (int v = tid / CPR; v < HT; v += BT / CPR) {
        long long off;
        const bool ok = voxel(t, v, off) && c < Ci;
        cp_async16(dst + v * C::LDX, ok ? x + off + c : x, ok);
      }
    }
    cp_async_commit();
  };

  // the g halo of the block's next tile, loaded into registers a tile ahead
  constexpr int GPT = (GS + BT - 1) / BT;
  float gpre[GPT];
  int gpd[GPT], gqy[GPT], gqx[GPT];  // this thread's halo elements: plane, row, column
#pragma unroll
  for (int i = 0; i < GPT; ++i) {
    const int e = tid + i * BT;
    gpd[i] = e < 3 * SN ? e / SN : -8;  // -8: none (outside every grid)
    gqy[i] = e % SN / SW;
    gqx[i] = e % SN % SW;
  }
  auto load_g = [&](int ti) {
    const Tile t = tile_of(ti);
#pragma unroll
    for (int i = 0; i < GPT; ++i) {
      const int sd = t.z + gpd[i] - 1, sh = t.h0 + gqy[i] - 1, sw = t.w0 + gqx[i] - 1;
      gpre[i] = in_grid(sd, sh, sw, D, H, W)
                    ? to_f(g[((long long)t.b * D + sd) * plane + (long long)sh * W + sw])
                    : 0.f;
    }
  };

  if (n_stages > 0) load_g(stage_tile(0));
  for (int s = 0; s < NST - 1; ++s) load_stage(s);
  for (int s = 0; s < n_stages; ++s) {
    cp_async_wait<NST - 2>();
    __syncthreads();  // chunk s has landed; everyone is done with chunk s-1 and G27
    load_stage(s + NST - 1);
    const Tile t = tile_of(stage_tile(s));
    const int c0 = s % nc * C::CK;
    T* xs = ring + (s % NST) * HT * C::LDX;
    if (c0 == 0) {  // a new tile: its g halo, then G27 (threads 0-127: taps
                    // 0-15 of voxel tid; threads 128-255: taps 16-31)
#pragma unroll
      for (int i = 0; i < GPT; ++i)
        if (tid + i * BT < 3 * SN) gs[tid + i * BT] = gpre[i];
      if (s / nc + 1 < my_tiles) load_g(stage_tile(s + nc));
      __syncthreads();
      const int v = tid & (HT - 1), ly = v >> lw, lx = v & (TW - 1);
      const bool ok = t.h0 + ly < H && t.w0 + lx < W;
      const float* gv = gs + (ly + 2) * SW + lx + 2;  // tap (td, th, tw) at
                                                      // -(td-2)SN - th SW - tw
      T* row = G + v * C::LDG;
      if (tid < HT) {
#pragma unroll
        for (int tt = 0; tt < 16; ++tt)
          row[tt] = from_f<T>(ok ? gv[(2 - tt / 9) * SN - (tt / 3) % 3 * SW - tt % 3] : 0.f);
      } else {
#pragma unroll
        for (int tt = 16; tt < 32; ++tt)
          row[tt] = from_f<T>(ok && tt < 27
                                  ? gv[(2 - tt / 9) * SN - (tt / 3) % 3 * SW - tt % 3] : 0.f);
      }
      __syncthreads();
    }
    if constexpr (sizeof(T) == 2) {
      // dK partial: (x^T)[c0 .. c0+64) @ G27; warp w on channels
      // c0 + 16 (w % 4) and taps 16 (w / 4) .. +15
      {
        const int wm = warp & 3, wn = warp >> 2;
        float acc[1][2][4] = {};
#pragma unroll
        for (int kk = 0; kk < HT / 16; ++kk)
          mma_step<1, 2, true>(acc, xs + kk * 16 * C::LDX + wm * 16, C::LDX,
                               G + kk * 16 * C::LDG + wn * 16, C::LDG, lane);
#pragma unroll
        for (int ni = 0; ni < 2; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = c0 + wm * 16 + (lane >> 2) + (e >> 1) * 8;
            const int tt = wn * 16 + ni * 8 + 2 * (lane & 3) + (e & 1);
            dks[c * 32 + tt] += acc[0][ni][e];
          }
      }
      // dx tile: G27 @ K^T[:, c0 .. c0+64); warp w on voxels 32 (w % 4) ..
      // +31 and channels c0 + 32 (w / 4) .. +31
      const int wm = warp & 3, wn = warp >> 2;
      float dacc[2][4][4] = {};
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        mma_step<2, 4, false>(dacc, G + wm * 32 * C::LDG + kk * 16, C::LDG,
                              kt + kk * 16 * ldk + c0 + wn * 32, ldk, lane);
      __syncthreads();  // every warp is done reading this x chunk
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int v = wm * 32 + mi * 16 + (lane >> 2) + hf * 8;
            const int c = wn * 32 + ni * 8 + 2 * (lane & 3);
            *reinterpret_cast<__nv_bfloat162*>(xs + v * C::LDX + c) =
                __floats2bfloat162_rn(dacc[mi][ni][2 * hf], dacc[mi][ni][2 * hf + 1]);
          }
      __syncthreads();
      for (int e = tid; e < HT * CPR; e += BT) {
        const int v = e / CPR, c = c0 + (e % CPR) * C::VEC;
        long long off;
        if (voxel(t, v, off) && c < Ci)
          *reinterpret_cast<uint4*>(dx + off + c) =
              *reinterpret_cast<const uint4*>(xs + v * C::LDX + (c - c0));
      }
    } else if (tid < HT) {
      // f32, warps 0-3, the dK partial: thread (cg = tid / 8, tg = tid % 8)
      // owns channels c0 + 2cg, +1 and taps 4tg .. +3, summed over the
      // tile's 128 voxels
      const int cg = tid >> 3, tg = tid & 7;
      float acc[2][4] = {};
#pragma unroll 4
      for (int v = 0; v < HT; ++v) {
        const float2 xv = *reinterpret_cast<const float2*>(xs + v * C::LDX + 2 * cg);
        const float4 gv = *reinterpret_cast<const float4*>(G + v * C::LDG + 4 * tg);
        const float xa[2] = {xv.x, xv.y}, ga[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xa[i], ga[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dks[(c0 + 2 * cg + i) * 32 + 4 * tg + j] += acc[i][j];
    } else {
      // f32, warps 4-7, the dx tile: thread (rg = u / 8, cg = u % 8), u =
      // tid - 128, owns voxels rg + 16j (j < 8) and channels c0 + 4cg .. +3,
      // written as float4; taps 4 at a time (tap 27 of G27 and K^T is zero)
      const int rg = (tid - HT) >> 3, cg = tid & 7;
      float acc[8][4] = {};
#pragma unroll
      for (int t4 = 0; t4 < 28; t4 += 4) {
        float4 kv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          kv[u] = *reinterpret_cast<const float4*>(kt + (t4 + u) * ldk + c0 + 4 * cg);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float4 gv = *reinterpret_cast<const float4*>(G + (rg + 16 * j) * C::LDG + t4);
          const float ga[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            acc[j][0] = fmaf(ga[u], kv[u].x, acc[j][0]);
            acc[j][1] = fmaf(ga[u], kv[u].y, acc[j][1]);
            acc[j][2] = fmaf(ga[u], kv[u].z, acc[j][2]);
            acc[j][3] = fmaf(ga[u], kv[u].w, acc[j][3]);
          }
        }
      }
      const int c = c0 + 4 * cg;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        long long off;
        if (voxel(t, rg + 16 * j, off) && c < Ci)
          *reinterpret_cast<float4*>(reinterpret_cast<float*>(dx) + off + c) =
              make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < Ci * 27; e += BT)
    partial[(long long)blockIdx.x * Ci * 27 + e] = dks[(e / 27) * 32 + e % 27];
}

// dk[i] = sum_s partial[s, i] in a fixed order: row group r (of 8) sums
// s = r, r + 8, ... in increasing s, then the 8 group sums are added in
// order r = 0 .. 7 (no atomics: the same dK on every run).
__global__ void __launch_bounds__(256)
sum_partials_dk_kernel(const float* __restrict__ partial, float* __restrict__ out, int S,
                       int n) {
  __shared__ float red[8][33];
  const int j = threadIdx.x & 31, r = threadIdx.x >> 5, i = blockIdx.x * 32 + j;
  float acc = 0.f;
  if (i < n)
    for (int s = r; s < S; s += 8) acc += partial[(long long)s * n + i];
  red[r][j] = acc;
  __syncthreads();
  if (r == 0 && i < n) {
    float t = red[0][j];
#pragma unroll
    for (int q = 1; q < 8; ++q) t += red[q][j];
    out[i] = t;
  }
}

template <typename T>
int launch_fwd(const void* x, const void* k, void* out, int B, int D, int H, int W,
               int Ci, int chunk, void* stream) {
  if (Ci % Cfg<T>::VEC || Ci > MAX_CI || chunk < 1) return (int)cudaErrorInvalidValue;
  const int TW = tile_w(W), TH = HT / TW;
  const long long grid = (long long)B * ((H + TH - 1) / TH) * ((W + TW - 1) / TW) *
                         ((D + chunk - 1) / chunk);
  const size_t smem = fwd_smem<T>(Ci);
  int err = prepare(head_fwd_kernel<T>, smem);
  if (err) return err;
  head_fwd_kernel<T><<<(unsigned)grid, HT, smem, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)k, (T*)out, B, D, H, W, Ci, chunk);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* x, const void* g, const void* k, void* dx, void* partial,
               void* dk, int B, int D, int H, int W, int Ci, int grid, void* stream) {
  const int TW = tile_w(W), TH = HT / TW;
  const long long tiles = (long long)B * D * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  if (Ci % Cfg<T>::VEC || Ci > MAX_CI || grid < 1 || tiles > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const size_t smem = bwd_smem<T>(Ci);
  int err = prepare(head_bwd_kernel<T>, smem);
  if (err) return err;
  head_bwd_kernel<T><<<(unsigned)grid, BT, smem, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)g, (const T*)k, (T*)dx, (float*)partial, B, D, H, W, Ci);
  err = (int)cudaGetLastError();
  if (err) return err;
  const int n = Ci * 27;
  sum_partials_dk_kernel<<<(n + 31) / 32, 256, 0, (cudaStream_t)stream>>>(
      (const float*)partial, (float*)dk, grid, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int head_fwd_f32(const void* x, const void* k, void* out, int B, int D, int H, int W,
                 int Ci, int chunk, void* stream) {
  return launch_fwd<float>(x, k, out, B, D, H, W, Ci, chunk, stream);
}

int head_fwd_bf16(const void* x, const void* k, void* out, int B, int D, int H, int W,
                  int Ci, int chunk, void* stream) {
  return launch_fwd<bf16>(x, k, out, B, D, H, W, Ci, chunk, stream);
}

int head_bwd_f32(const void* x, const void* g, const void* k, void* dx, void* partial,
                 void* dk, int B, int D, int H, int W, int Ci, int grid, void* stream) {
  return launch_bwd<float>(x, g, k, dx, partial, dk, B, D, H, W, Ci, grid, stream);
}

int head_bwd_bf16(const void* x, const void* g, const void* k, void* dx, void* partial,
                  void* dk, int B, int D, int H, int W, int Ci, int grid, void* stream) {
  return launch_bwd<bf16>(x, g, k, dx, partial, dk, B, D, H, W, Ci, grid, stream);
}

}  // extern "C"
