// The kernel prototype tool's Co=1 SAME 3x3x3 conv (no bias) for Hopper
// (sm_90a), in its two formulations.  x is NDHWC (B, D, H, W, Ci); the
// output is (B, D, H, W), the single channel squeezed.
//
// co1_stencil replaces the Pallas TPU kernel
// tools/proto_co1_kernel.py::_co1_kernel: 27 multiply-adds on (H, W, Ci)
// slabs, then a sum over Ci.  Weights w27 (27, Ci), tap t = 9*td + 3*th + tw.
// Bound on the H100: bytes.  54 FLOPs per input element, far under the
// card's FLOP-per-byte balance, so the least time is reading x once.
// Design: a block owns TH rows of one (b, d) plane (TH*W <= 256 voxels) and
// walks Ci in chunks of 16; per chunk it stages the (3, TH+2, W+2, 16) halo
// slab in shared memory: each input element is read about 4 times (3 depth
// planes x halo rows and columns, (10/8)(34/32) at W = 32), mostly from L2.
// Its 256 threads are 16 channel lanes x 16 voxel groups, as the TPU kernel
// keeps channels on the lanes: lane c holds the chunk's 27
// weights of channel c in registers and adds its channel's 27 products of
// each of its (up to 16) voxels into a per-voxel f32 sum; at the end the 16
// lanes of each voxel are added by warp shuffles (the TPU kernel's final
// lane reduction) and one lane writes.  The two voxel groups of a warp are
// neighbouring voxels, an odd number of slab positions apart, so their 16
// channel lanes read the two halves of the 32 banks.  The TPU kernel forms
// each product in the input type and widens it; this kernel widens the
// inputs and multiplies in f32.
//
// co1_band replaces tools/proto_co1_kernel.py::_co1_band_kernel: the same
// function as 9 banded matrix products, out[(b, d), h, :] = sum over (td, th)
// of xpad[b, d + td, h + th].reshape((W+2)*Ci) @ band[3*td + th], with
// band (9, (W+2)*Ci, W) built by the caller (band[(wi, c), wo] = w[td, th,
// wi - wo, c] for wi - wo in {0, 1, 2}, else 0).  The kernel computes that
// product as given, zeros included: (W+2)/3 times the conv's useful FLOPs.
// Bound on the H100: bytes for the conv's useful work; the banded product's
// own FLOPs are (W+2)/3 times larger.  Design: a plain tiled GEMM, M = B*D*H
// rows (one (b, d, h) row of padded input per output row), N = W, K = 9 taps
// x (W+2)*Ci; 64x32 output tiles, 128 threads of 4x4 float micro-tiles, K
// staged 16 at a time.  A row of A is the contiguous (W, Ci) row of x between
// Ci zeros on each side, so the staging reads x coalesced along channels and
// needs no padded copy; rows off the volume in d or h are zero.

#include "common.cuh"

namespace {

// ---- co1_stencil -----------------------------------------------------------

constexpr int SC = 16;      // channels per staged chunk = channel lanes
constexpr int SNT = 256;    // threads: SC lanes x 16 voxel groups
constexpr int SG = SNT / SC;
constexpr int SV = 16;      // voxels per thread: a block covers <= SG*SV = 256

template <typename T>
__global__ void __launch_bounds__(SNT)
co1_stencil_kernel(const T* __restrict__ x, const T* __restrict__ w27,
                   T* __restrict__ out, int B, int D, int H, int W, int Ci, int TH) {
  extern __shared__ float S[];  // [3][TH+2][W+2][SC]
  const int W2 = W + 2, R = TH + 2;
  const int hblocks = (H + TH - 1) / TH;
  const int plane = blockIdx.x / hblocks;  // b*D + d
  const int h0 = (blockIdx.x - plane * hblocks) * TH;
  const int b = plane / D, d = plane - b * D;
  const int nvox = min(TH, H - h0) * W;
  const int c = threadIdx.x % SC, g = threadIdx.x / SC;

  float acc[SV];
#pragma unroll
  for (int j = 0; j < SV; ++j) acc[j] = 0.f;

  for (int c0 = 0; c0 < Ci; c0 += SC) {
    const int ck = min(SC, Ci - c0);
    for (int e = threadIdx.x; e < 3 * R * W2 * SC; e += SNT) {
      const int cc = e % SC, p = e / SC, wp = p % W2, r = (p / W2) % R, td = p / (W2 * R);
      const int sd = d + td - 1, sh = h0 + r - 1, sw = wp - 1;
      float v = 0.f;
      if (cc < ck && sd >= 0 && sd < D && sh >= 0 && sh < H && sw >= 0 && sw < W)
        v = to_f(x[((((long long)b * D + sd) * H + sh) * W + sw) * Ci + c0 + cc]);
      S[e] = v;
    }
    float wr[27];
#pragma unroll
    for (int t = 0; t < 27; ++t) wr[t] = c < ck ? to_f(w27[t * Ci + c0 + c]) : 0.f;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < SV; ++j) {
      const int v = g + SG * j;
      if (v < nvox) {
        const int hr = v / W, w = v - hr * W;
        const float* base = S + (hr * W2 + w) * SC + c;
        float s = 0.f;
#pragma unroll
        for (int t = 0; t < 27; ++t)
          s = fmaf(base[(((t / 9) * R + (t / 3) % 3) * W2 + t % 3) * SC], wr[t], s);
        acc[j] += s;
      }
    }
    __syncthreads();
  }
  // sum the 16 channel lanes of each voxel (lanes c of one group are 16
  // consecutive lanes of a warp)
#pragma unroll
  for (int j = 0; j < SV; ++j) {
    float s = acc[j];
#pragma unroll
    for (int off = SC / 2; off > 0; off /= 2) s += __shfl_xor_sync(0xffffffffu, s, off);
    const int v = g + SG * j;
    if (c == 0 && v < nvox) out[(long long)plane * H * W + (long long)h0 * W + v] = from_f<T>(s);
  }
}

// ---- co1_band --------------------------------------------------------------

constexpr int GM = 64, GN = 32, GK = 16;  // output tile and K step
constexpr int GNT = 128;                  // threads: 16 row x 8 column groups
constexpr int GR = GM * GK / GNT;         // A-tile rows each thread stages

template <typename T>
__global__ void __launch_bounds__(GNT)
co1_band_kernel(const T* __restrict__ x, const T* __restrict__ band,
                T* __restrict__ out, int B, int D, int H, int W, int Ci) {
  __shared__ float As[GK][GM + 1];
  __shared__ __align__(16) float Bs[GK][GN];
  const long long M = (long long)B * D * H;
  const int K = (W + 2) * Ci;
  const long long m0 = (long long)blockIdx.x * GM;
  const int n0 = blockIdx.y * GN;
  const int tid = threadIdx.x, tx = tid % 8, ty = tid / 8;
  const int ka = tid % GK;          // this thread's A-tile column
  const int ra = tid / GK;          // its first A-tile row; rows ra + 8*i

  float acc[4][4] = {};
  for (int tap = 0; tap < 9; ++tap) {
    const int td = tap / 3, th = tap % 3;
    // x offset of the (W, Ci) row under each staged A row, or -1 off the volume
    long long rowbase[GR];
#pragma unroll
    for (int i = 0; i < GR; ++i) {
      const long long m = m0 + ra + (GNT / GK) * i;
      const int h = (int)(m % H);
      const long long bd = m / H;
      const int d = (int)(bd % D);
      const int sd = d + td - 1, sh = h + th - 1;
      rowbase[i] = (m < M && sd >= 0 && sd < D && sh >= 0 && sh < H)
                       ? ((bd - d + sd) * H + sh) * (long long)W * Ci
                       : -1;
    }
    for (int k0 = 0; k0 < K; k0 += GK) {
      const int k = k0 + ka;
      const bool kin = k >= Ci && k < K - Ci;  // inside the row, not its zero pad
#pragma unroll
      for (int i = 0; i < GR; ++i)
        As[ka][ra + (GNT / GK) * i] =
            (kin && rowbase[i] >= 0) ? to_f(x[rowbase[i] + k - Ci]) : 0.f;
      for (int e = tid; e < GK * GN; e += GNT) {
        const int n = e % GN, kk = e / GN;
        Bs[kk][n] = (k0 + kk < K && n0 + n < W)
                        ? to_f(band[((long long)tap * K + k0 + kk) * W + n0 + n])
                        : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < GK; ++kk) {
        float a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
        const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][0] = fmaf(a[i], bv.x, acc[i][0]);
          acc[i][1] = fmaf(a[i], bv.y, acc[i][1]);
          acc[i][2] = fmaf(a[i], bv.z, acc[i][2]);
          acc[i][3] = fmaf(a[i], bv.w, acc[i][3]);
        }
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < W) out[m * W + n] = from_f<T>(acc[i][j]);
    }
  }
}

template <typename T>
int launch_stencil(const void* x, const void* w27, void* out, int B, int D, int H,
                   int W, int Ci, int TH, long long smem, void* stream) {
  auto kernel = co1_stencil_kernel<T>;
  if (int err = prepare(kernel, (size_t)smem)) return err;
  const long long blocks = (long long)B * D * ((H + TH - 1) / TH);
  kernel<<<(unsigned)blocks, SNT, (size_t)smem, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)w27, (T*)out, B, D, H, W, Ci, TH);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_band(const void* x, const void* band, void* out, int B, int D, int H, int W,
                int Ci, void* stream) {
  const long long M = (long long)B * D * H;
  dim3 grid((unsigned)((M + GM - 1) / GM), (unsigned)((W + GN - 1) / GN));
  co1_band_kernel<T><<<grid, GNT, 0, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)band, (T*)out, B, D, H, W, Ci);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int co1_stencil_f32(const void* x, const void* w27, void* out, int B, int D, int H,
                    int W, int Ci, int TH, long long smem, void* stream) {
  return launch_stencil<float>(x, w27, out, B, D, H, W, Ci, TH, smem, stream);
}

int co1_stencil_bf16(const void* x, const void* w27, void* out, int B, int D, int H,
                     int W, int Ci, int TH, long long smem, void* stream) {
  return launch_stencil<__nv_bfloat16>(x, w27, out, B, D, H, W, Ci, TH, smem, stream);
}

int co1_band_f32(const void* x, const void* band, void* out, int B, int D, int H,
                 int W, int Ci, void* stream) {
  return launch_band<float>(x, band, out, B, D, H, W, Ci, stream);
}

int co1_band_bf16(const void* x, const void* band, void* out, int B, int D, int H,
                  int W, int Ci, void* stream) {
  return launch_band<__nv_bfloat16>(x, band, out, B, D, H, W, Ci, stream);
}

}  // extern "C"
