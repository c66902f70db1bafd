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
// GFLOPs of work over MBs of operands).  CONCAT27's body is the im2col
// kernel's (#5, pallas_conv.py:307), so both modes run on #5's slab template
// (slab_conv.cuh): 128-voxel x N tiles (N = 32, 64, 128 after Co), K walked
// in stages of one depth tap and one channel chunk, each stage the im2col
// slab of one depth plane with its h/w halo in a 2-stage 16-byte cp.async
// ring plus the 9 weight tiles of that tap, the 9 (th, tw) taps read from
// the slab at row offsets; bf16 on mma.sync m16n8k16 with f32 accumulation,
// f32 on an FMA micro-tile (no TF32); K split with the fixed-order sum
// where the grid is short of the card.  The two modes differ only in the
// order of the stages:
//
//  - CONCAT27 (IM2COL): the channel chunks outer, the three depth taps
//    inner, as #5 walks its single contraction;
//  - CONCAT9 (IM2COL_TD): the depth taps outer, all chunks of one tap
//    before the next, the TPU kernel's three per-tap dots in order.
//
// The bias is added once at the end (or by the split sum), as #5 adds it.
// Ci or Co the 16-byte copies cannot take (Co = 1, Ci = 1, 3, ...) run on
// zero-padded channels (ops/conv3d_packed.py::launch); at Co = 1 a 32-wide
// tile does 32x the useful tensor work.

#include "slab_conv.cuh"

namespace {

// The kernels: CONCAT27 and CONCAT9, each in bf16 (tensor cores) and f32
// (FMA), registers for two blocks an SM as conv3d_packed.cu's.
template <int BN, int WM, int WN>
__global__ void __launch_bounds__((SLAB_BM / WM) * (BN / WN) * 32, 2)
proto_conv27_kernel_mma(const bf16* __restrict__ x, const bf16* __restrict__ wt,
                        const bf16* __restrict__ bias, bf16* __restrict__ out,
                        float* __restrict__ partial, const Geo g) {
  slab_mma<IM2COL, BN, WM, WN>(x, wt, bias, out, partial, g);
}

template <int BN, int WM, int WN>
__global__ void __launch_bounds__((SLAB_BM / WM) * (BN / WN) * 32, 2)
proto_conv9_kernel_mma(const bf16* __restrict__ x, const bf16* __restrict__ wt,
                       const bf16* __restrict__ bias, bf16* __restrict__ out,
                       float* __restrict__ partial, const Geo g) {
  slab_mma<IM2COL_TD, BN, WM, WN>(x, wt, bias, out, partial, g);
}

template <int BN, int TM, int TN>
__global__ void __launch_bounds__((SLAB_BM / TM) * (BN / TN), BN == 128 ? 1 : 2)
proto_conv27_kernel_fma(const float* __restrict__ x, const float* __restrict__ wt,
                        const float* __restrict__ bias, float* __restrict__ out,
                        float* __restrict__ partial, const Geo g) {
  slab_fma<IM2COL, BN, TM, TN>(x, wt, bias, out, partial, g);
}

template <int BN, int TM, int TN>
__global__ void __launch_bounds__((SLAB_BM / TM) * (BN / TN), BN == 128 ? 1 : 2)
proto_conv9_kernel_fma(const float* __restrict__ x, const float* __restrict__ wt,
                       const float* __restrict__ bias, float* __restrict__ out,
                       float* __restrict__ partial, const Geo g) {
  slab_fma<IM2COL_TD, BN, TM, TN>(x, wt, bias, out, partial, g);
}

// The kernel of each tile width N = 128, 64, 32 (ops/conv3d_kernel.py::fwd_tile)
template <typename T>
SlabKernel<T> conv27_kernel(int bn) {
  if constexpr (sizeof(T) == 2)
    return bn == 128 ? &proto_conv27_kernel_mma<128, 64, 32>
         : bn == 64  ? &proto_conv27_kernel_mma<64, 32, 32>
         : bn == 32  ? &proto_conv27_kernel_mma<32, 16, 32> : nullptr;
  else
    return bn == 128 ? &proto_conv27_kernel_fma<128, 8, 8>
         : bn == 64  ? &proto_conv27_kernel_fma<64, 4, 8>
         : bn == 32  ? &proto_conv27_kernel_fma<32, 4, 4> : nullptr;
}

template <typename T>
SlabKernel<T> conv9_kernel(int bn) {
  if constexpr (sizeof(T) == 2)
    return bn == 128 ? &proto_conv9_kernel_mma<128, 64, 32>
         : bn == 64  ? &proto_conv9_kernel_mma<64, 32, 32>
         : bn == 32  ? &proto_conv9_kernel_mma<32, 16, 32> : nullptr;
  else
    return bn == 128 ? &proto_conv9_kernel_fma<128, 8, 8>
         : bn == 64  ? &proto_conv9_kernel_fma<64, 4, 8>
         : bn == 32  ? &proto_conv9_kernel_fma<32, 4, 4> : nullptr;
}

}  // namespace

extern "C" {

// Arguments as conv3d_packed.cu's entries (geometry from
// ops/conv3d_packed.py::tiles and ::slab_rows, the IM2COL slab).
int proto_conv27_f32(const void* x, const void* wt, const void* bias, void* out, void* partial,
                     int B, int D, int H, int W, int Ci, int Co, int P, int L, int tpp, int R,
                     int rows, int tiles, int bn, int S, int per, void* stream) {
  return launch_slab<float, IM2COL>(conv27_kernel<float>(bn), x, wt, bias, out, partial, B, D, H,
                                    W, Ci, Co, P, L, tpp, R, rows, tiles, bn, S, per, stream);
}

int proto_conv27_bf16(const void* x, const void* wt, const void* bias, void* out, void* partial,
                      int B, int D, int H, int W, int Ci, int Co, int P, int L, int tpp, int R,
                      int rows, int tiles, int bn, int S, int per, void* stream) {
  return launch_slab<bf16, IM2COL>(conv27_kernel<bf16>(bn), x, wt, bias, out, partial, B, D, H,
                                   W, Ci, Co, P, L, tpp, R, rows, tiles, bn, S, per, stream);
}

int proto_conv9_f32(const void* x, const void* wt, const void* bias, void* out, void* partial,
                    int B, int D, int H, int W, int Ci, int Co, int P, int L, int tpp, int R,
                    int rows, int tiles, int bn, int S, int per, void* stream) {
  return launch_slab<float, IM2COL_TD>(conv9_kernel<float>(bn), x, wt, bias, out, partial, B, D,
                                       H, W, Ci, Co, P, L, tpp, R, rows, tiles, bn, S, per,
                                       stream);
}

int proto_conv9_bf16(const void* x, const void* wt, const void* bias, void* out, void* partial,
                     int B, int D, int H, int W, int Ci, int Co, int P, int L, int tpp, int R,
                     int rows, int tiles, int bn, int S, int per, void* stream) {
  return launch_slab<bf16, IM2COL_TD>(conv9_kernel<bf16>(bn), x, wt, bias, out, partial, B, D, H,
                                      W, Ci, Co, P, L, tpp, R, rows, tiles, bn, S, per, stream);
}

}  // extern "C"
