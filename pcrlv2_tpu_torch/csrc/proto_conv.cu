// The kernel prototype tool's SAME 3x3x3 conv with bias for Hopper (sm_90a),
// in its two formulations: CONCAT27 (the 27 tap windows side by side, one
// contraction of K = 27*Ci) and CONCAT9 (one depth tap at a time, three
// contractions of K = 9*Ci added to one f32 accumulator).  Channels-last
// NDHWC activations; weights (27*Ci, Co) row-major, row = tap*Ci + ci, tap =
// 9*td + 3*th + tw (the DHWIO weights reshaped); bias (Co,).
//
// Replaces the Pallas TPU kernel tools/proto_conv.py::_make_kernel (`kernel`,
// both modes), the prototype the JAX tool measures.
//
// Bound on the H100: operations (K = 27*Ci of 27..3456 against Co of 1..128:
// GFLOPs of work over MBs of operands).  One kernel template on the number
// of taps staged per pass, TAPS = 27 or 9:
//
//  - a block computes 64 output voxels x 64 output channels (the tile of
//    conv_tile.cuh: 256 threads, 4x4 float micro-tiles), the 64 voxels a
//    band of one (b, d) plane or P whole small planes, as conv3d_packed.cu's
//    im2col kernel places them;
//  - a pass stages TAPS/9 depth planes of the band (with a one-voxel halo in
//    h and w) and the TAPS taps' weights for one chunk of input channels,
//    then walks K = TAPS*chunk out of shared memory.  CONCAT27 takes one
//    pass per chunk over all three depth planes; CONCAT9 takes three, one
//    per depth tap, as the TPU kernel's three dots.  The chunk is 8 channels
//    for 27 taps and 16 for 9, so both stage about the same weights (55 and
//    37 KB) and fit three to four blocks on an SM.
//
// Operands are widened to float in shared memory; f32 FMA accumulation,
// started from the bias as the TPU kernel starts from it; output cast to
// the input type.  At Co = 1 63 of each tile's 64 columns are idle.  No
// tensor cores, no TMA, no double buffering.

#include "conv_tile.cuh"

namespace {

template <typename T, int TAPS>
__global__ void __launch_bounds__(NT)
proto_conv_kernel(const T* __restrict__ x, const T* __restrict__ wt,
                  const T* __restrict__ bias, T* __restrict__ out, int B, int D,
                  int H, int W, int Ci, int Co, int P, int L, int tpp, int R) {
  constexpr int CK = TAPS == 27 ? 8 : 16;  // input channels per staged chunk
  constexpr int CKP = CK + 1;           // slab leading dimension (bank pad)
  constexpr int NPL = TAPS / 9;         // depth planes staged per pass
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int W2 = W + 2;
  const int DPLANE = P * R * W2;        // staged positions per depth plane
  float* S = smem;                      // [NPL][P][R][W2][CKP]
  float* Bs = smem + weight_offset(NPL * DPLANE * CKP);  // [TAPS][CK][BN]
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

  for (int td0 = 0; td0 < 3; td0 += NPL) {
    for (int c0 = 0; c0 < Ci; c0 += CK) {
      const int ck = min(CK, Ci - c0);
      // slab: one warp per (plane, segment, row) line of W2*CK values; line
      // (j, s, r) holds input row h0 - 1 + r of plane plane0 + s at depth
      // tap td0 + j
      for (int line = warp; line < NPL * P * R; line += NWARP) {
        const int j = line / (P * R), sr = line - j * P * R, s = sr / R;
        const int plane = plane0 + s, h = h0 - 1 + (sr - s * R);
        const int b = plane / D, sd = plane - b * D + td0 + j - 1;
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
      // weights of taps 9*td0 .. 9*td0 + TAPS - 1 into Bs[tap][k][n]
      for (int e = tid; e < TAPS * CK * BN; e += NT) {
        const int n = e % BN, k = (e / BN) % CK, tap = e / (BN * CK);
        float v = 0.f;
        if (k < ck && n0 + n < Co)
          v = to_f(wt[((long long)(9 * td0 + tap) * Ci + c0 + k) * Co + n0 + n]);
        Bs[e] = v;
      }
      __syncthreads();
      // one staged plane at a time: unrolling the three of CONCAT27 takes
      // 196 registers a thread (one block an SM) against 128
#pragma unroll 1
      for (int j = 0; j < NPL; ++j)
#pragma unroll
        for (int th = 0; th < 3; ++th)
#pragma unroll
          for (int tw = 0; tw < 3; ++tw)
            fma_tile(acc, S + (j * DPLANE + th * W2 + tw) * CKP, pos, CKP,
                     Bs + (9 * j + 3 * th + tw) * CK * BN, ck, tx);
      __syncthreads();
    }
  }
  store_out(out, acc, obase, rok, n0, tx, Co);
}

template <typename T, int TAPS>
int launch(const void* x, const void* wt, const void* bias, void* out, int B, int D,
           int H, int W, int Ci, int Co, int P, int L, int tpp, int tiles, int R,
           long long smem, void* stream) {
  auto kernel = proto_conv_kernel<T, TAPS>;
  if (int err = prepare(kernel, (size_t)smem)) return err;
  dim3 grid((unsigned)tiles, (unsigned)((Co + BN - 1) / BN));
  kernel<<<grid, NT, (size_t)smem, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)wt, (const T*)bias, (T*)out, B, D, H, W, Ci, Co, P, L,
      tpp, R);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

#define PROTO_CONV_ENTRY(NAME, T, TAPS)                                             \
  int NAME(const void* x, const void* wt, const void* bias, void* out, int B, int D, \
           int H, int W, int Ci, int Co, int P, int L, int tpp, int tiles, int R,    \
           long long smem, void* stream) {                                           \
    return launch<T, TAPS>(x, wt, bias, out, B, D, H, W, Ci, Co, P, L, tpp, tiles, R, \
                           smem, stream);                                            \
  }

PROTO_CONV_ENTRY(proto_conv27_f32, float, 27)
PROTO_CONV_ENTRY(proto_conv27_bf16, __nv_bfloat16, 27)
PROTO_CONV_ENTRY(proto_conv9_f32, float, 9)
PROTO_CONV_ENTRY(proto_conv9_bf16, __nv_bfloat16, 9)

}  // extern "C"
