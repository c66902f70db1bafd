// SAME 3x3x3 conv3d forward for Hopper (sm_90a) fed from a staged slab: the
// tw-packed kernel (also used for dx, on flipped io-swapped weights) and the
// im2col kernel.  Channels-last NDHWC activations; weights repacked by the
// caller to (27*Ci, Co) row-major with row = tap*Ci + ci, tap = 9*td+3*th+tw
// (the same buffer is the TPU kernels' w9 (9, 3*Ci, Co) and wmat (27*Ci, Co)).
//
// Replaces the Pallas TPU kernels pcrlv2_tpu/ops/pallas_conv.py:380
// _packed_kernel (forward; dx on flipped weights) and :307 _im2col_kernel
// (forward).
//
// Bound on the H100: operations, as for conv3d.cu's forward (K = 27*Ci is
// 216..13824 deep, Co 32..512 wide: GFLOPs of work against MBs of operands).
// In bf16 the limit is the tensor cores' rate, in f32 the CUDA cores' FMA
// rate (no TF32: the f32 path keeps f32 products).  What these kernels add
// over conv3d.cu's implicit GEMM is how the contraction is fed: each input
// element is staged once per depth tap and output tile and then serves three
// (packed) or nine (im2col) taps from shared memory.
//
// Tiling.  A block of 256 threads computes 128 output rows (voxels) x N
// output channels, N = 32, 64 or 128 following Co
// (ops/conv3d_kernel.py::fwd_tile).  The 128
// rows are a band of one (b, d) plane (planes of >= 128 voxels: "segment" =
// 128 consecutive positions of the flattened (h, w) plane) or P whole
// planes (smaller planes), and K is walked in stages of one depth tap td and
// one chunk of BK input channels (BK = 16 bf16, 8 f32): 3 * ceil(Ci / BK)
// stages.  A stage holds the slab of that (td, chunk) and the 9 weight
// tiles (th, tw) of td, BK x N each; the 9 products of a stage read their
// A rows out of the one slab at fixed row offsets, so the inner loop has no
// mask and no gather.
//
//  * packed (#6), stage (td, chunk): the slab is ((L + 2W) per segment,
//    3*BK): slab row j is plane position p0 - W + j, its columns the three
//    tw shifts side by side (column tw*BK + c holds x[.., w + tw - 1, c0 +
//    c]).  An h shift is a row shift of W in the flattened plane, so the
//    three th windows are row offsets th*W into that one slab
//    (pallas_conv.py:389-399), and tap (th, tw) reads rows q + th*W,
//    columns tw*BK .. tw*BK + BK - 1.
//  * im2col (#5), stage (chunk, td): the slab is the depth plane td - 1 of
//    the tile's rows with a one-voxel halo in h and w, (P, R, W+2, BK); tap
//    (th, tw) reads rows pos + th*(W+2) + tw.  Over the three td stages of a
//    chunk that is the TPU kernel's (3, P, R, W+2, BK) window, staged once.
//
// Staging: every stage is filled with 16-byte cp.async copies in its own
// dtype (bf16 stays bf16) into a 2-stage ring, so the next stage loads
// while the current one multiplies (a stage is 9 products deep; a third
// slot costs a block of occupancy and measured slower on the H100);
// SAME-halo, ragged and past-Ci vectors use the zero-fill form (source size
// 0).  Each slab row's source (voxel, depth, w; or none) is computed once
// per block into a table in shared memory, so a copy costs a table read and
// a few compares, no division.  Rows are padded by 16 bytes: the 8 rows of
// an ldmatrix (and an f32 float4 phase) fall in distinct banks.
//
// Products: bf16 on tensor cores, mma.sync m16n8k16 with f32 accumulation,
// 8 warps of 64x32, 32x32 or 16x32 (N = 128, 64, 32); A fragments by
// ldmatrix from the slab (one row address per lane, so a tap's shift is
// only another row base), B by ldmatrix.trans.  f32 on the CUDA cores with
// an 8x8, 4x8 or 4x4 register micro-tile (N = 128, 64, 32) fed by float4
// reads, as conv3d.cu's f32 forward.
//
// K split: where the grid is short of the card (the deep levels) the
// wrapper splits the stages S ways (blockIdx.z); each split writes its f32
// partial and conv3d_fwd_kernel_splitsum adds them in split order with the
// bias and casts once (no atomics: the same result on every run).
//
// Routes (ops/conv3d_packed.py::route): the copies need Ci and Co to be
// multiples of 8 (bf16) or 4 (f32) and 16-byte aligned pointers.  Such
// shapes take the kernels as they are ("vector"); every other shape,
// the stem (Ci = 1) included, is zero-padded to those multiples by the
// wrapper, runs the same kernels and is sliced back ("padded").  Zero
// channels add exact zeros to every sum.
//
// The template itself (geometry, stage loads, slab_mma, slab_fma, the
// launch) lives in slab_conv.cuh, shared with proto_conv.cu (#7).

#include "slab_conv.cuh"

namespace {

// The kernels: #6 (packed) and #5 (im2col), each in bf16 (tensor cores) and
// f32 (FMA); one name per TPU kernel so a profile tells them apart.  Each
// asks for registers for two blocks of 256 threads an SM (128 a thread):
// without the hint ptxas kept 80 for a third block and spilled, which
// measured no faster.  The f32 8x8 tile, which holds 64 sums, asks for one.
template <int BN, int WM, int WN>
__global__ void __launch_bounds__((SLAB_BM / WM) * (BN / WN) * 32, 2)
conv3d_packed_kernel_mma(const bf16* __restrict__ x, const bf16* __restrict__ wt,
                         const bf16* __restrict__ bias, bf16* __restrict__ out,
                         float* __restrict__ partial, const Geo g) {
  slab_mma<PACKED, BN, WM, WN>(x, wt, bias, out, partial, g);
}

template <int BN, int WM, int WN>
__global__ void __launch_bounds__((SLAB_BM / WM) * (BN / WN) * 32, 2)
conv3d_im2col_kernel_mma(const bf16* __restrict__ x, const bf16* __restrict__ wt,
                         const bf16* __restrict__ bias, bf16* __restrict__ out,
                         float* __restrict__ partial, const Geo g) {
  slab_mma<IM2COL, BN, WM, WN>(x, wt, bias, out, partial, g);
}

template <int BN, int TM, int TN>
__global__ void __launch_bounds__((SLAB_BM / TM) * (BN / TN), BN == 128 ? 1 : 2)
conv3d_packed_kernel_fma(const float* __restrict__ x, const float* __restrict__ wt,
                         const float* __restrict__ bias, float* __restrict__ out,
                         float* __restrict__ partial, const Geo g) {
  slab_fma<PACKED, BN, TM, TN>(x, wt, bias, out, partial, g);
}

template <int BN, int TM, int TN>
__global__ void __launch_bounds__((SLAB_BM / TM) * (BN / TN), BN == 128 ? 1 : 2)
conv3d_im2col_kernel_fma(const float* __restrict__ x, const float* __restrict__ wt,
                         const float* __restrict__ bias, float* __restrict__ out,
                         float* __restrict__ partial, const Geo g) {
  slab_fma<IM2COL, BN, TM, TN>(x, wt, bias, out, partial, g);
}

// The kernel of each tile width N = 128, 64, 32 (ops/conv3d_kernel.py::fwd_tile)
template <typename T>
SlabKernel<T> packed_kernel(int bn) {
  if constexpr (sizeof(T) == 2)
    return bn == 128 ? &conv3d_packed_kernel_mma<128, 64, 32>
         : bn == 64  ? &conv3d_packed_kernel_mma<64, 32, 32>
         : bn == 32  ? &conv3d_packed_kernel_mma<32, 16, 32> : nullptr;
  else
    return bn == 128 ? &conv3d_packed_kernel_fma<128, 8, 8>
         : bn == 64  ? &conv3d_packed_kernel_fma<64, 4, 8>
         : bn == 32  ? &conv3d_packed_kernel_fma<32, 4, 4> : nullptr;
}

template <typename T>
SlabKernel<T> im2col_kernel(int bn) {
  if constexpr (sizeof(T) == 2)
    return bn == 128 ? &conv3d_im2col_kernel_mma<128, 64, 32>
         : bn == 64  ? &conv3d_im2col_kernel_mma<64, 32, 32>
         : bn == 32  ? &conv3d_im2col_kernel_mma<32, 16, 32> : nullptr;
  else
    return bn == 128 ? &conv3d_im2col_kernel_fma<128, 8, 8>
         : bn == 64  ? &conv3d_im2col_kernel_fma<64, 4, 8>
         : bn == 32  ? &conv3d_im2col_kernel_fma<32, 4, 4> : nullptr;
}

}  // namespace

extern "C" {

// Geometry (P, L, tpp, R, rows, tiles) from ops/conv3d_packed.py::tiles and
// ::slab_rows; bn the tile's columns (32, 64 or 128); S K-splits of `per`
// stages each (S > 1 needs partial, (S, M, Co) f32).  Ci and Co multiples
// of 8 (bf16) or 4 (f32), pointers 16-byte aligned.
int conv3d_packed_f32(const void* x, const void* wt, const void* bias, void* out, void* partial,
                      int B, int D, int H, int W, int Ci, int Co, int P, int L, int tpp, int R,
                      int rows, int tiles, int bn, int S, int per, void* stream) {
  return launch_slab<float, PACKED>(packed_kernel<float>(bn), x, wt, bias, out, partial, B, D, H,
                                    W, Ci, Co, P, L, tpp, R, rows, tiles, bn, S, per, stream);
}

int conv3d_packed_bf16(const void* x, const void* wt, const void* bias, void* out, void* partial,
                       int B, int D, int H, int W, int Ci, int Co, int P, int L, int tpp, int R,
                       int rows, int tiles, int bn, int S, int per, void* stream) {
  return launch_slab<bf16, PACKED>(packed_kernel<bf16>(bn), x, wt, bias, out, partial, B, D, H,
                                   W, Ci, Co, P, L, tpp, R, rows, tiles, bn, S, per, stream);
}

int conv3d_im2col_f32(const void* x, const void* wt, const void* bias, void* out, void* partial,
                      int B, int D, int H, int W, int Ci, int Co, int P, int L, int tpp, int R,
                      int rows, int tiles, int bn, int S, int per, void* stream) {
  return launch_slab<float, IM2COL>(im2col_kernel<float>(bn), x, wt, bias, out, partial, B, D, H,
                                    W, Ci, Co, P, L, tpp, R, rows, tiles, bn, S, per, stream);
}

int conv3d_im2col_bf16(const void* x, const void* wt, const void* bias, void* out, void* partial,
                       int B, int D, int H, int W, int Ci, int Co, int P, int L, int tpp, int R,
                       int rows, int tiles, int bn, int S, int per, void* stream) {
  return launch_slab<bf16, IM2COL>(im2col_kernel<bf16>(bn), x, wt, bias, out, partial, B, D, H,
                                   W, Ci, Co, P, L, tpp, R, rows, tiles, bn, S, per, stream);
}

}  // extern "C"
