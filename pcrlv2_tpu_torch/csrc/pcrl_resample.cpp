// pcrl_resample — the port's copy of the JAX package's native resampler
// (native/pcrl_resample.cpp), built into the port's own library beside
// pcrl_io.cpp.  Host code only: it makes no CUDA call.
//
// Replaces SimpleITK's linear resample to 1mm isotropic spacing (reference
// luna_preprocess.py:322-348) with ONE fused pass: trilinear sample +
// int16→float32 convert + (z,y,x)→(x,y,z) transpose, parallelized over a
// std::thread pool.  Same sampling semantics as the NumPy path
// (pcrlv2_tpu_torch/preprocess/mhd.py: output voxel i samples input
// continuous index i·out_sp/in_sp, clamped): trilinear interpolation is
// separable, so results agree to fp rounding.
//
// C ABI (consumed via ctypes from pcrlv2_tpu_torch/native.py):
//   pcrl_resample_i16_to_xyz / pcrl_resample_f32_to_xyz

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

struct AxisTable {
  std::vector<int64_t> lo, hi;
  std::vector<float> frac;
};

AxisTable make_table(int64_t out_n, int64_t in_n, double scale) {
  AxisTable t;
  t.lo.resize(out_n);
  t.hi.resize(out_n);
  t.frac.resize(out_n);
  for (int64_t i = 0; i < out_n; ++i) {
    double c = static_cast<double>(i) * scale;
    if (c < 0) c = 0;
    if (c > static_cast<double>(in_n - 1)) c = static_cast<double>(in_n - 1);
    int64_t lo = static_cast<int64_t>(std::floor(c));
    int64_t hi = std::min(lo + 1, in_n - 1);
    t.lo[i] = lo;
    t.hi[i] = hi;
    t.frac[i] = static_cast<float>(c - static_cast<double>(lo));
  }
  return t;
}

template <typename T>
void resample_to_xyz(const T* in, int64_t zi, int64_t yi, int64_t xi,
                     double sz, double sy, double sx, float* out, int64_t zo,
                     int64_t yo, int64_t xo, int n_threads) {
  const AxisTable tz = make_table(zo, zi, sz);
  const AxisTable ty = make_table(yo, yi, sy);
  const AxisTable tx = make_table(xo, xi, sx);
  const int64_t in_zstride = yi * xi;

  auto worker = [&](int64_t x0, int64_t x1) {
    for (int64_t x = x0; x < x1; ++x) {
      const int64_t xl = tx.lo[x], xh = tx.hi[x];
      const float fx = tx.frac[x];
      float* out_plane = out + x * yo * zo;  // out is (x, y, z) C-order
      for (int64_t y = 0; y < yo; ++y) {
        const int64_t yl = ty.lo[y], yh = ty.hi[y];
        const float fy = ty.frac[y];
        const T* r00 = in + yl * xi;  // (y-lo row base, z added below)
        const T* r01 = in + yh * xi;
        float* out_row = out_plane + y * zo;
        for (int64_t z = 0; z < zo; ++z) {
          const int64_t zl = tz.lo[z], zh = tz.hi[z];
          const float fz = tz.frac[z];
          const T* p00 = r00 + zl * in_zstride;
          const T* p01 = r01 + zl * in_zstride;
          const T* p10 = r00 + zh * in_zstride;
          const T* p11 = r01 + zh * in_zstride;
          // lerp over x (innermost input axis), then y, then z — matching
          // the Python path's z→y→x pass order is unnecessary: trilinear
          // interpolation is symmetric in the lerp order.
          const float v00 = static_cast<float>(p00[xl]) +
              (static_cast<float>(p00[xh]) - static_cast<float>(p00[xl])) * fx;
          const float v01 = static_cast<float>(p01[xl]) +
              (static_cast<float>(p01[xh]) - static_cast<float>(p01[xl])) * fx;
          const float v10 = static_cast<float>(p10[xl]) +
              (static_cast<float>(p10[xh]) - static_cast<float>(p10[xl])) * fx;
          const float v11 = static_cast<float>(p11[xl]) +
              (static_cast<float>(p11[xh]) - static_cast<float>(p11[xl])) * fx;
          const float v0 = v00 + (v01 - v00) * fy;
          const float v1 = v10 + (v11 - v10) * fy;
          out_row[z] = v0 + (v1 - v0) * fz;
        }
      }
    }
  };

  if (n_threads < 1) n_threads = 1;
  n_threads = static_cast<int>(
      std::min<int64_t>(n_threads, std::max<int64_t>(xo, 1)));
  std::vector<std::thread> pool;
  pool.reserve(n_threads);
  const int64_t chunk = (xo + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    const int64_t a = t * chunk;
    const int64_t b = std::min(xo, a + chunk);
    if (a >= b) break;
    pool.emplace_back(worker, a, b);
  }
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// in: (zi, yi, xi) C-order; out: (xo, yo, zo) C-order float32.
// s{z,y,x} = out_spacing/in_spacing per axis (output voxel i samples input
// continuous index i*s, clamped) — SimpleITK's linear-resampler semantics.
void pcrl_resample_i16_to_xyz(const int16_t* in, int64_t zi, int64_t yi,
                              int64_t xi, double sz, double sy, double sx,
                              float* out, int64_t zo, int64_t yo, int64_t xo,
                              int n_threads) {
  resample_to_xyz<int16_t>(in, zi, yi, xi, sz, sy, sx, out, zo, yo, xo,
                           n_threads);
}

void pcrl_resample_f32_to_xyz(const float* in, int64_t zi, int64_t yi,
                              int64_t xi, double sz, double sy, double sx,
                              float* out, int64_t zo, int64_t yo, int64_t xo,
                              int n_threads) {
  resample_to_xyz<float>(in, zi, yi, xi, sz, sy, sx, out, zo, yo, xo,
                         n_threads);
}

}  // extern "C"
