// The data-movement and dot probes of the kernel prototype tools, one tiny
// kernel per operation, for Hopper (sm_90a).  All tensors are 2-D or 3-D,
// contiguous, row-major; the last dimension is the TPU's lane dimension,
// the one before it its sublane dimension.
//
// Replaces the Pallas TPU harness tools/probe_mosaic.py::run and its 14
// probes.  On the TPU a probe asks whether Mosaic can lower an operation at
// all; every one of them can be written on Hopper, so here a probe asks
// whether its kernel gives the operation's values, bit for bit.
//
// Bound on the H100: launch latency.  The probes move 8-64 KB, microseconds
// of work at the card's memory rate, so each launch is one block (or a few)
// of 256 threads and no tiling.  Probes that are the same operation share a
// kernel: the two lane concatenations (f32 32+32 and 64+64, bf16 32+32), the
// three lane slices (offset 32, offset 64, stride 4), the two reshapes (a
// row-major reshape moves no element: a copy) and the two rolls (the JAX
// probe is written twice, with jnp.roll and pltpu.roll, the same values).
// The lane-offset store goes through a shared-memory scratch as the TPU
// probe goes through VMEM scratch; the transpose through a padded shared
// tile; the dot with two contraction dims accumulates in f32.

#include "common.cuh"

namespace {

constexpr int PNT = 256;

// out (R, 2C) = [a | b], a and b (R, C)
template <typename T>
__global__ void concat_lanes(const T* a, const T* b, T* out, int R, int C) {
  for (int e = blockIdx.x * PNT + threadIdx.x; e < R * 2 * C; e += gridDim.x * PNT) {
    const int r = e / (2 * C), j = e % (2 * C);
    out[e] = j < C ? a[r * C + j] : b[r * C + j - C];
  }
}

// out (2R, C) = [a; b], a and b (R, C)
template <typename T>
__global__ void concat_sublanes(const T* a, const T* b, T* out, int R, int C) {
  for (int e = blockIdx.x * PNT + threadIdx.x; e < 2 * R * C; e += gridDim.x * PNT)
    out[e] = e < R * C ? a[e] : b[e - R * C];
}

// out (R, n) = a[:, start : start + n*step : step], a (R, C)
template <typename T>
__global__ void lane_slice(const T* a, T* out, int R, int C, int n, int start, int step) {
  for (int e = blockIdx.x * PNT + threadIdx.x; e < R * n; e += gridDim.x * PNT) {
    const int r = e / n, j = e % n;
    out[e] = a[r * C + start + j * step];
  }
}

// scratch (R, 2C) in shared memory: scratch[:, 0:C] = a; scratch[:, C:2C] =
// a; out = scratch.  One block; the wrapper checks that R*2C fits.
template <typename T>
__global__ void lane_offset_store(const T* a, T* out, int R, int C) {
  extern __shared__ float4 smem4[];
  T* s = reinterpret_cast<T*>(smem4);
  for (int e = threadIdx.x; e < R * C; e += PNT) {
    const int r = e / C, j = e % C;
    s[r * 2 * C + j] = a[e];
  }
  for (int e = threadIdx.x; e < R * C; e += PNT) {
    const int r = e / C, j = e % C;
    s[r * 2 * C + C + j] = a[e];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < R * 2 * C; e += PNT) out[e] = s[e];
}

// a reshape of a contiguous tensor: out[e] = a[e], n elements
template <typename T>
__global__ void reshape_copy(const T* a, T* out, int n) {
  for (int e = blockIdx.x * PNT + threadIdx.x; e < n; e += gridDim.x * PNT) out[e] = a[e];
}

// out[r, j] = a[r, (j - shift) mod C]: the lanes rolled right by shift
template <typename T>
__global__ void roll_lanes(const T* a, T* out, int R, int C, int shift) {
  for (int e = blockIdx.x * PNT + threadIdx.x; e < R * C; e += gridDim.x * PNT) {
    const int r = e / C, j = e % C;
    out[e] = a[r * C + ((j - shift) % C + C) % C];
  }
}

// out (M, N) = sum over (t, c) of a[m, t, c] * w[t, c, n], f32 accumulation
template <typename T>
__global__ void dot2(const T* a, const T* w, T* out, int M, int K, int N) {
  for (int e = blockIdx.x * PNT + threadIdx.x; e < M * N; e += gridDim.x * PNT) {
    const int m = e / N, n = e % N;
    float s = 0.f;
    for (int k = 0; k < K; ++k) s = fmaf(to_f(a[m * K + k]), to_f(w[k * N + n]), s);
    out[e] = from_f<T>(s);
  }
}

// out (C, R) = a.T, a (R, C), through 32x32 tiles of shared memory
template <typename T>
__global__ void transpose2d(const T* a, T* out, int R, int C) {
  __shared__ float tile[32][33];
  const int r0 = blockIdx.y * 32, c0 = blockIdx.x * 32;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;  // 32 x 8 threads
  for (int i = ty; i < 32; i += PNT / 32)
    if (r0 + i < R && c0 + tx < C) tile[i][tx] = to_f(a[(r0 + i) * C + c0 + tx]);
  __syncthreads();
  for (int i = ty; i < 32; i += PNT / 32)
    if (c0 + i < C && r0 + tx < R) out[(c0 + i) * R + r0 + tx] = from_f<T>(tile[tx][i]);
}

unsigned blocks_for(int n) { return (unsigned)((n + PNT - 1) / PNT); }

// Launch probe `probe` (the JAX tool's order, 0-13) on a, viewed as (n0,
// n1), and b (the second operand, or null) into out.  The slice bounds and
// the shift are the probes' own, as in the JAX kernels; n2 is the dot's
// output width.  Returns a CUDA error code, or
// cudaErrorInvalidValue for an unknown probe.
template <typename T>
int run(int probe, const void* av, const void* bv, void* ov, int n0, int n1, int n2,
        void* stream) {
  const T* a = (const T*)av;
  const T* b = (const T*)bv;
  T* o = (T*)ov;
  cudaStream_t st = (cudaStream_t)stream;
  switch (probe) {
    case 0:   // concat lanes 32+32
    case 1:   // concat lanes 64+64
    case 13:  // bf16 concat lanes 32+32
      concat_lanes<T><<<blocks_for(2 * n0 * n1), PNT, 0, st>>>(a, b, o, n0, n1);
      break;
    case 2:   // lane slice [32:64] of 128
      lane_slice<T><<<blocks_for(n0 * 32), PNT, 0, st>>>(a, o, n0, n1, 32, 32, 1);
      break;
    case 3:   // lane slice [64:128] of 128
      lane_slice<T><<<blocks_for(n0 * 64), PNT, 0, st>>>(a, o, n0, n1, 64, 64, 1);
      break;
    case 4:   // lane-offset store [32:64]: scratch (n0, 2*n1)
      lane_offset_store<T><<<1, PNT, 2 * n0 * n1 * sizeof(T), st>>>(a, o, n0, n1);
      break;
    case 5:   // reshape (64,9,32)->(64,288): a viewed as (n0, n1 = 9*32)
    case 6:   // reshape (8,64,32)->(512,32): a viewed as (n0 = 8*64, n1)
      reshape_copy<T><<<blocks_for(n0 * n1), PNT, 0, st>>>(a, o, n0 * n1);
      break;
    case 7:   // concat sublanes
      concat_sublanes<T><<<blocks_for(2 * n0 * n1), PNT, 0, st>>>(a, b, o, n0, n1);
      break;
    case 8:   // roll lanes by 32 (jnp.roll)
    case 9:   // pltpu.roll lanes by 32
      roll_lanes<T><<<blocks_for(n0 * n1), PNT, 0, st>>>(a, o, n0, n1, 32);
      break;
    case 10:  // dot 2 contraction dims: a (n0, n1 = 9*32), w (n1, n2)
      dot2<T><<<blocks_for(n0 * n2), PNT, 0, st>>>(a, b, o, n0, n1, n2);
      break;
    case 11: {  // transpose 2d
      dim3 grid((unsigned)((n1 + 31) / 32), (unsigned)((n0 + 31) / 32));
      transpose2d<T><<<grid, PNT, 0, st>>>(a, o, n0, n1);
      break;
    }
    case 12:  // strided lane slice [:, 0:128:4]
      lane_slice<T><<<blocks_for(n0 * (n1 / 4)), PNT, 0, st>>>(a, o, n0, n1, n1 / 4, 0, 4);
      break;
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
