// SAME 3x3x3 conv3d forward for Hopper (sm_90a) fed from a staged slab: the
// tw-packed kernel (also used for dx, on flipped io-swapped weights) and the
// im2col kernel.  Channels-last NDHWC activations; weights repacked by the
// caller to (27*Ci, Co) row-major with row = tap*Ci + ci, tap = 9*td+3*th+tw
// (the same buffer is the TPU kernels' w9 (9, 3*Ci, Co) and wmat (27*Ci, Co)).
//
// Replaces the Pallas TPU kernels pcrlv2_tpu/ops/pallas_conv.py::_packed_kernel
// (forward; dx on flipped weights) and ::_im2col_kernel (forward).
//
// Bound on the H100: operations, as for conv3d.cu's forward (K = 27*Ci is
// 27..13824 deep, Co 32..512 wide: GFLOPs of work against MBs of operands),
// so the figure of merit is FMA rate.  What the TPU kernels add over the
// implicit GEMM of conv3d.cu is how the contraction is fed: from a slab
// staged once per block and Ci chunk, not from a gather per (voxel, tap)
// element that recomputes (b, d, h, w) with four divisions each k step.
//
// Tiling.  A block computes 64 output rows (voxels) x 64 output channels,
// 256 threads, a 4x4 float micro-tile each.  The TPU kernels hold whole
// (H+2, W+2, Ci) planes in VMEM; a 64x64x32 plane is 287 KB in f32 and does
// not fit in a block's shared memory, so the 64 rows are a band of one
// (b, d) plane (planes of >= 64 voxels: "segment" = 64 consecutive
// positions of the flattened (h, w) plane), or P whole planes (smaller
// planes: P = 64 / (H*W), segment = the plane), and Ci is walked in chunks
// of CK.  Each segment is staged with its halo, so every output row finds
// its 27 taps at fixed offsets from its own row base and no mask is needed
// in the FMA loop.  The wrapper computes (P, L, tiles per plane, rows) and
// the dynamic shared memory size; every shape takes this one path,
// including Ci = 1 (the chunk is shorter), W = 1 and odd W.
//
// packed (#6): for each td and Ci chunk, the slab is ((L + 2W) per segment,
// 3*CK): slab row j is plane position p0 - W + j, its columns the three tw
// shifts side by side (column tw*CK + c holds x[.., w + tw - 1, c0 + c]).
// An h shift is a row shift of W in the flattened plane, so the three th
// windows are row offsets th*W into that one tile (pallas_conv.py:389-399):
// each input element is read from device memory once per td per output
// tile.
//
// im2col (#5): for each Ci chunk, the 3 depth planes of each segment are
// staged with a one-voxel halo in h and w, (3, P, rows, W+2, CK), and K =
// 27*ck is walked tap-major (k = t*ck + c) out of shared memory.
//
// Both: operands widened to float in shared memory, f32 accumulation, bias
// added in the kernel; weights staged per (td, Ci chunk) as 9 taps x CK rows
// of 64 columns.  The slabs' leading dimensions are padded by one float, so
// the two output-row groups of a warp read different banks.  No tensor
// cores (wgmma), no TMA, no double buffering yet.

#include "conv_tile.cuh"

namespace {

constexpr int CK = 16;   // input channels per staged chunk
constexpr int K3P = 3 * CK + 1;  // packed slab leading dimension
constexpr int CKP = CK + 1;      // im2col slab leading dimension

// Weights of one td and one Ci chunk into Bs[tap9][k][n], k < ck, tap9 =
// 3*th + tw, zero past Co and past the chunk.
template <typename T>
__device__ __forceinline__ void stage_weights(const T* __restrict__ wt, float* Bs,
                                              int td, int c0, int ck, int Ci,
                                              int Co, int n0) {
  for (int e = threadIdx.x; e < 9 * CK * BN; e += NT) {
    const int n = e % BN;
    const int k = (e / BN) % CK;
    const int tap9 = e / (BN * CK);
    float v = 0.f;
    if (k < ck && n0 + n < Co)
      v = to_f(wt[((long long)(9 * td + tap9) * Ci + c0 + k) * Co + n0 + n]);
    Bs[e] = v;
  }
}

// out = bias + sum over (td, th) of window_{td,th}(packed) @ w9[td*3+th].
template <typename T>
__global__ void __launch_bounds__(NT)
conv3d_packed_kernel(const T* __restrict__ x, const T* __restrict__ wt,
                     const T* __restrict__ bias, T* __restrict__ out, int B,
                     int D, int H, int W, int Ci, int Co, int P, int L, int tpp) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int SEG = L + 2 * W;            // slab rows per segment
  float* S = smem;                      // [P*SEG][K3P], column tw*CK + c
  float* Bs = smem + weight_offset(P * SEG * K3P);  // [3 th][3 tw][CK][BN]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int warp = tid / 32, lane = tid % 32;
  const int NP = B * D, HW = H * W;
  const int n0 = blockIdx.y * BN;
  int plane0, p0;
  tile_origin(blockIdx.x, P, L, tpp, &plane0, &p0);

  int rows[4];
  bool rok[4];
  long long obase[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i, s = r / L, q = r - s * L;
    const int plane = plane0 + s, p = p0 + q;
    rok[i] = s < P && plane < NP && p < HW;
    rows[i] = rok[i] ? s * SEG + q : 0;
    obase[i] = ((long long)plane * HW + p) * Co;
  }
  float acc[4][4];
  init_acc(acc, bias, n0, tx, Co);

  for (int td = 0; td < 3; ++td) {
    for (int c0 = 0; c0 < Ci; c0 += CK) {
      const int ck = min(CK, Ci - c0);
      // slab: one warp per row, row j of segment s = plane position p0-W+j
      for (int row = warp; row < P * SEG; row += NWARP) {
        const int s = row / SEG, plane = plane0 + s, p = p0 - W + (row - s * SEG);
        bool ok = plane < NP && p >= 0 && p < HW;
        int w = 0;
        long long base = 0;
        if (ok) {
          const int h = p / W;
          w = p - h * W;
          const int b = plane / D, sd = plane - b * D + td - 1;
          ok = sd >= 0 && sd < D;
          base = ((((long long)b * D + sd) * H + h) * W) * Ci + c0;
        }
        for (int k = lane; k < 3 * CK; k += 32) {
          const int tw = k / CK, c = k % CK, sw = w + tw - 1;
          float v = 0.f;
          if (ok && c < ck && sw >= 0 && sw < W) v = to_f(x[base + (long long)sw * Ci + c]);
          S[row * K3P + k] = v;
        }
      }
      stage_weights(wt, Bs, td, c0, ck, Ci, Co, n0);
      __syncthreads();
#pragma unroll
      for (int th = 0; th < 3; ++th)
#pragma unroll
        for (int tw = 0; tw < 3; ++tw)
          fma_tile(acc, S + th * W * K3P + tw * CK, rows, K3P,
                   Bs + (3 * th + tw) * CK * BN, ck, tx);
      __syncthreads();
    }
  }
  store_out(out, acc, obase, rok, n0, tx, Co);
}

// out = bias + cols @ wmat, cols = the 27 tap windows side by side.
template <typename T>
__global__ void __launch_bounds__(NT)
conv3d_im2col_kernel(const T* __restrict__ x, const T* __restrict__ wt,
                     const T* __restrict__ bias, T* __restrict__ out, int B,
                     int D, int H, int W, int Ci, int Co, int P, int L, int tpp,
                     int R) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int W2 = W + 2;
  const int DPLANE = P * R * W2;       // staged positions per depth tap
  float* S = smem;                     // [3 td][P][R][W2][CKP]
  float* Bs = smem + weight_offset(3 * DPLANE * CKP);  // [9 (th, tw)][CK][BN]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int warp = tid / 32, lane = tid % 32;
  const int NP = B * D, HW = H * W;
  const int n0 = blockIdx.y * BN;
  int plane0, p0;
  tile_origin(blockIdx.x, P, L, tpp, &plane0, &p0);
  const int h0 = p0 / W;  // the first output row of the tile's segments

  int pos[4];
  bool rok[4];
  long long obase[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i, s = r / L, q = r - s * L;
    const int plane = plane0 + s, p = p0 + q;
    rok[i] = s < P && plane < NP && p < HW;
    const int h = p / W, w = p - h * W;
    pos[i] = rok[i] ? (s * R + h - h0) * W2 + w : 0;
    obase[i] = ((long long)plane * HW + p) * Co;
  }
  float acc[4][4];
  init_acc(acc, bias, n0, tx, Co);

  for (int c0 = 0; c0 < Ci; c0 += CK) {
    const int ck = min(CK, Ci - c0);
    // slab: one warp per (td, segment, row) line of W2*CK values; line
    // (td, s, r) holds input row h0 - 1 + r of plane plane0 + s, depth td - 1
    for (int line = warp; line < 3 * P * R; line += NWARP) {
      const int td = line / (P * R), sr = line - td * P * R, s = sr / R;
      const int plane = plane0 + s, h = h0 - 1 + (sr - s * R);
      const int b = plane / D, sd = plane - b * D + td - 1;
      const bool ok = plane < NP && h >= 0 && h < H && sd >= 0 && sd < D;
      const long long base = ((((long long)b * D + sd) * H + h) * W) * Ci + c0;
      float* dst = S + (long long)line * W2 * CKP;
      for (int e = lane; e < W2 * CK; e += 32) {
        const int wp = e / CK, c = e % CK, sw = wp - 1;
        float v = 0.f;
        if (ok && c < ck && sw >= 0 && sw < W) v = to_f(x[base + (long long)sw * Ci + c]);
        dst[wp * CKP + c] = v;
      }
    }
    for (int td = 0; td < 3; ++td) {
      stage_weights(wt, Bs, td, c0, ck, Ci, Co, n0);
      __syncthreads();
#pragma unroll
      for (int th = 0; th < 3; ++th)
#pragma unroll
        for (int tw = 0; tw < 3; ++tw)
          fma_tile(acc, S + (td * DPLANE + th * W2 + tw) * CKP, pos, CKP,
                   Bs + (3 * th + tw) * CK * BN, ck, tx);
      __syncthreads();
    }
  }
  store_out(out, acc, obase, rok, n0, tx, Co);
}

template <typename T>
int launch_packed(const void* x, const void* wt, const void* bias, void* out, int B,
                  int D, int H, int W, int Ci, int Co, int P, int L, int tpp,
                  int tiles, long long smem, void* stream) {
  auto kernel = conv3d_packed_kernel<T>;
  if (int err = prepare(kernel, (size_t)smem)) return err;
  dim3 grid((unsigned)tiles, (unsigned)((Co + BN - 1) / BN));
  kernel<<<grid, NT, (size_t)smem, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)wt, (const T*)bias, (T*)out, B, D, H, W, Ci, Co, P, L, tpp);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_im2col(const void* x, const void* wt, const void* bias, void* out, int B,
                  int D, int H, int W, int Ci, int Co, int P, int L, int tpp,
                  int tiles, int R, long long smem, void* stream) {
  auto kernel = conv3d_im2col_kernel<T>;
  if (int err = prepare(kernel, (size_t)smem)) return err;
  dim3 grid((unsigned)tiles, (unsigned)((Co + BN - 1) / BN));
  kernel<<<grid, NT, (size_t)smem, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)wt, (const T*)bias, (T*)out, B, D, H, W, Ci, Co, P, L, tpp, R);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int conv3d_packed_f32(const void* x, const void* wt, const void* bias, void* out,
                      int B, int D, int H, int W, int Ci, int Co, int P, int L,
                      int tpp, int tiles, long long smem, void* stream) {
  return launch_packed<float>(x, wt, bias, out, B, D, H, W, Ci, Co, P, L, tpp, tiles,
                              smem, stream);
}

int conv3d_packed_bf16(const void* x, const void* wt, const void* bias, void* out,
                       int B, int D, int H, int W, int Ci, int Co, int P, int L,
                       int tpp, int tiles, long long smem, void* stream) {
  return launch_packed<__nv_bfloat16>(x, wt, bias, out, B, D, H, W, Ci, Co, P, L, tpp,
                                      tiles, smem, stream);
}

int conv3d_im2col_f32(const void* x, const void* wt, const void* bias, void* out,
                      int B, int D, int H, int W, int Ci, int Co, int P, int L,
                      int tpp, int tiles, int R, long long smem, void* stream) {
  return launch_im2col<float>(x, wt, bias, out, B, D, H, W, Ci, Co, P, L, tpp, tiles,
                              R, smem, stream);
}

int conv3d_im2col_bf16(const void* x, const void* wt, const void* bias, void* out,
                       int B, int D, int H, int W, int Ci, int Co, int P, int L,
                       int tpp, int tiles, int R, long long smem, void* stream) {
  return launch_im2col<__nv_bfloat16>(x, wt, bias, out, B, D, H, W, Ci, Co, P, L, tpp,
                                      tiles, R, smem, stream);
}

}  // extern "C"
