// The data-movement and dot probes of the kernel prototype tools for Hopper
// (sm_90a).  All tensors are 2-D or 3-D, contiguous, row-major; the last
// dimension is the TPU's lane dimension, the one before it its sublane
// dimension.
//
// Replaces the Pallas TPU harness tools/probe_mosaic.py::run and its 14
// probes.  On the TPU a probe asks whether Mosaic can lower an operation at
// all; every one of them can be written on Hopper, so here a probe asks
// whether its kernel gives the operation's values, bit for bit.
//
// Bound on the H100: the launch.  A probe moves 8-72 KB, tens of
// nanoseconds at the card's memory rate, while a launch through the
// wrapper's ctypes route costs microseconds of host time and a few of
// device time.  So each probe is one launch of one block of 1024 threads,
// with no tiling, and the wrapper (tools/probe_mosaic.py) works out each
// probe's dimensions once per input shapes, so that a call costs one output
// allocation, one stream read and one C call.  Probe -1 launches an empty
// kernel through the same route: the floor of that path.
//
// The copy-like probes (the concatenations, the lane slices, the reshapes,
// the rolls, the lane-offset store) move single elements: at these sizes a
// probe's device time is a few microseconds either way, under the host's
// cost of a call.  Probes that are the same operation share a kernel: the two lane
// concatenations (f32 32+32 and 64+64, bf16 32+32), the two contiguous lane
// slices, the two reshapes (a row-major reshape moves no element: a copy)
// and the two rolls (the JAX probe is written twice, with jnp.roll and
// pltpu.roll, the same values).  The lane-offset store goes through a
// shared-memory scratch as the TPU probe goes through VMEM scratch; the
// transpose through padded shared tiles; the dot with two contraction dims
// runs a warp per two output rows, its lanes over the contraction against
// w staged in shared memory, and adds the lanes' sums by shuffles, in f32.

#include "common.cuh"

namespace {

constexpr int PNT = 1024;  // threads of a probe's one block

// out (R, 2C) = [a | b], a and b (R, C)
template <typename T>
__global__ void __launch_bounds__(PNT)
concat_lanes(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ out, int R, int C) {
#pragma unroll 4
  for (int e = threadIdx.x; e < R * 2 * C; e += PNT) {
    const int r = e / (2 * C), j = e - r * 2 * C;
    out[e] = j < C ? a[r * C + j] : b[r * C + j - C];
  }
}

// out (2n) = [a; b], a and b n elements: the sublane concatenation
template <typename T>
__global__ void __launch_bounds__(PNT)
concat_flat(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ out, int n) {
#pragma unroll 4
  for (int e = threadIdx.x; e < 2 * n; e += PNT) out[e] = e < n ? a[e] : b[e - n];
}

// out (R, n) = a[:, start : start + n], a (R, C)
template <typename T>
__global__ void __launch_bounds__(PNT)
lane_slice(const T* __restrict__ a, T* __restrict__ out, int R, int C, int n, int start) {
#pragma unroll 4
  for (int e = threadIdx.x; e < R * n; e += PNT) {
    const int r = e / n;
    out[e] = a[r * C + start + e - r * n];
  }
}

// out (R, n) = a[:, 0 : STEP*n : STEP], a (R, C)
template <typename T, int STEP>
__global__ void __launch_bounds__(PNT)
lane_stride(const T* __restrict__ a, T* __restrict__ out, int R, int C, int n) {
  for (int e = threadIdx.x; e < R * n; e += PNT) {
    const int r = e / n;
    out[e] = a[r * C + STEP * (e - r * n)];
  }
}

// scratch (R, 2C) in shared memory: scratch[:, 0:C] = a; scratch[:, C:2C] =
// a; out = scratch.  The wrapper checks that R*2C fits.
template <typename T>
__global__ void __launch_bounds__(PNT)
lane_offset_store(const T* __restrict__ a, T* __restrict__ out, int R, int C) {
  extern __shared__ float smem[];
  T* s = reinterpret_cast<T*>(smem);
  for (int e = threadIdx.x; e < R * C; e += PNT) {
    const int r = e / C, j = e - r * C;
    const T v = a[e];
    s[r * 2 * C + j] = v;
    s[r * 2 * C + C + j] = v;
  }
  __syncthreads();
#pragma unroll 4
  for (int e = threadIdx.x; e < R * 2 * C; e += PNT) out[e] = s[e];
}

// a reshape of a contiguous tensor: out[e] = a[e], n elements
template <typename T>
__global__ void __launch_bounds__(PNT)
copy_flat(const T* __restrict__ a, T* __restrict__ out, int n) {
#pragma unroll 4
  for (int e = threadIdx.x; e < n; e += PNT) out[e] = a[e];
}

// out[r, j] = a[r, (j - shift) mod C]: the lanes rolled right by shift
template <typename T>
__global__ void __launch_bounds__(PNT)
roll_lanes(const T* __restrict__ a, T* __restrict__ out, int R, int C, int shift) {
#pragma unroll 4
  for (int e = threadIdx.x; e < R * C; e += PNT) {
    const int r = e / C, j = e - r * C;
    out[e] = a[r * C + ((j - shift) % C + C) % C];
  }
}

// out (M, N) = sum over k of a[m, k] * w[k, n], f32 accumulation.  Warp q
// takes rows 2q and 2q + 1 of each group of 64 rows; the block stages w
// 512 rows x 16 columns at a time in shared memory (rows padded to 17
// floats, so the 32 lanes' rows fall in distinct banks); lane l takes k =
// k0 + l, k0 + l + 32, ... of a chunk, reading a's rows coalesced, and keeps
// 16 column sums a row, which a shuffle butterfly adds over the 32 lanes.
template <typename T>
__global__ void __launch_bounds__(PNT)
dot_rows(const T* __restrict__ a, const T* __restrict__ w, T* __restrict__ out, int M, int K,
         int N) {
  constexpr int NB = 16, KC = 512, NW = PNT / 32, RW = 2;
  __shared__ float ws[KC][NB + 1];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int n0 = 0; n0 < N; n0 += NB)
    for (int mb = 0; mb < M; mb += RW * NW) {  // the same trip count in every warp
      const int m0 = mb + RW * warp;
      float acc[RW][NB] = {};
      for (int k0 = 0; k0 < K; k0 += KC) {
        __syncthreads();  // every warp is done with the chunk before
        for (int e = threadIdx.x; e < KC * NB; e += PNT) {
          const int k = k0 + e / NB, n = n0 + e % NB;
          ws[e / NB][e % NB] = k < K && n < N ? to_f(w[k * N + n]) : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int j = 0; j < KC / 32; ++j) {
          const int kk = lane + 32 * j, k = k0 + kk;
          float av[RW];
#pragma unroll
          for (int i = 0; i < RW; ++i) av[i] = k < K && m0 + i < M ? to_f(a[(m0 + i) * K + k]) : 0.f;
#pragma unroll
          for (int n = 0; n < NB; ++n) {
            const float wv = ws[kk][n];
#pragma unroll
            for (int i = 0; i < RW; ++i) acc[i][n] = fmaf(av[i], wv, acc[i][n]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < RW; ++i)
#pragma unroll
        for (int n = 0; n < NB; ++n)
#pragma unroll
          for (int off = 16; off > 0; off /= 2)
            acc[i][n] += __shfl_xor_sync(0xffffffffu, acc[i][n], off);
      // lane l writes column n0 + l % 16 of row m0 + l / 16
      float mine = 0.f;
#pragma unroll
      for (int i = 0; i < RW; ++i)
#pragma unroll
        for (int n = 0; n < NB; ++n)
          if (lane == i * NB + n) mine = acc[i][n];
      const int m = m0 + lane / NB, n = n0 + lane % NB;
      if (m < M && n < N) out[m * N + n] = from_f<T>(mine);
    }
}

// out (C, R) = a.T, a (R, C), through 32x32 tiles of shared memory walked
// by the one block
template <typename T>
__global__ void __launch_bounds__(PNT)
transpose2d(const T* __restrict__ a, T* __restrict__ out, int R, int C) {
  __shared__ float tile[32][33];  // f32 holds a bf16 exactly
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;  // 32 x 32 threads
  for (int r0 = 0; r0 < R; r0 += 32)
    for (int c0 = 0; c0 < C; c0 += 32) {
      if (r0 + ty < R && c0 + tx < C) tile[ty][tx] = to_f(a[(r0 + ty) * C + c0 + tx]);
      __syncthreads();
      if (c0 + ty < C && r0 + tx < R) out[(c0 + ty) * R + r0 + tx] = from_f<T>(tile[tx][ty]);
      __syncthreads();
    }
}

__global__ void empty_kernel() {}

// Launch probe `probe` (the JAX tool's order, 0-13; -1 the empty kernel) on
// a, viewed as (n0, n1), and b (the second operand, or null) into out.  The
// slice bounds and the shift are the probes' own, as in the JAX kernels; n2
// is the dot's output width.  Each is one launch of one block.  Returns a
// CUDA error code, or cudaErrorInvalidValue for an unknown probe.
template <typename T>
int run(int probe, const void* av, const void* bv, void* ov, int n0, int n1, int n2,
        void* stream) {
  const T* a = (const T*)av;
  const T* b = (const T*)bv;
  T* o = (T*)ov;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (probe) {
    case -1:
      empty_kernel<<<1, PNT, 0, st>>>();
      break;
    case 0:   // concat lanes 32+32
    case 1:   // concat lanes 64+64
    case 13:  // bf16 concat lanes 32+32
      concat_lanes<T><<<1, PNT, 0, st>>>(a, b, o, n0, n1);
      break;
    case 2:   // lane slice [32:64] of 128
    case 3: {  // lane slice [64:128] of 128
      const int start = probe == 2 ? 32 : 64, n = 32 * (probe - 1);
      lane_slice<T><<<1, PNT, 0, st>>>(a, o, n0, n1, n, start);
      break;
    }
    case 4: {  // lane-offset store [32:64]: scratch (n0, 2*n1)
      const size_t smem = 2 * (size_t)n0 * n1 * sizeof(T);
      lane_offset_store<T><<<1, PNT, smem, st>>>(a, o, n0, n1);
      break;
    }
    case 5:   // reshape (64,9,32)->(64,288): a viewed as (n0, n1 = 9*32)
    case 6:   // reshape (8,64,32)->(512,32): a viewed as (n0 = 8*64, n1)
      copy_flat<T><<<1, PNT, 0, st>>>(a, o, n0 * n1);
      break;
    case 7:   // concat sublanes
      concat_flat<T><<<1, PNT, 0, st>>>(a, b, o, n0 * n1);
      break;
    case 8:   // roll lanes by 32 (jnp.roll)
    case 9:   // pltpu.roll lanes by 32
      roll_lanes<T><<<1, PNT, 0, st>>>(a, o, n0, n1, 32);
      break;
    case 10:  // dot 2 contraction dims: a (n0, n1 = 9*32), w (n1, n2)
      dot_rows<T><<<1, PNT, 0, st>>>(a, b, o, n0, n1, n2);
      break;
    case 11:  // transpose 2d
      transpose2d<T><<<1, PNT, 0, st>>>(a, o, n0, n1);
      break;
    case 12: {  // strided lane slice [:, 0:128:4]
      const int n = ((n1 < 128 ? n1 : 128) + 3) / 4;
      lane_stride<T, 4><<<1, PNT, 0, st>>>(a, o, n0, n1, n);
      break;
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int probe_run_f32(int probe, const void* a, const void* b, void* out, int n0, int n1,
                  int n2, void* stream) {
  return run<float>(probe, a, b, out, n0, n1, n2, stream);
}

int probe_run_bf16(int probe, const void* a, const void* b, void* out, int n0, int n1,
                   int n2, void* stream) {
  return run<__nv_bfloat16>(probe, a, b, out, n0, n1, n2, stream);
}

}  // extern "C"
