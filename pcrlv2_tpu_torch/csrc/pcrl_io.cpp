// pcrl_io — the port's copy of the JAX package's native data plane
// (native/pcrl_io.cpp), kept apart so that the port builds and loads its own
// library and never writes into native/.
//
// The reference feeds its GPUs from torch DataLoader worker *processes*
// (reference data.py:95-98): fork + pickle + page-cache-cold npy reads in
// Python.  Here the host input pipeline is a C++ thread pool reading
// preprocessed .npy crops straight into one preallocated batch buffer —
// no per-sample Python allocation, no GIL on the IO path, one memcpy.
// Host code only: it makes no CUDA call.
//
// Exposed C ABI (consumed via ctypes from pcrlv2_tpu_torch/native.py):
//   pcrl_read_npy    — parse one .npy (v1/v2 header) into a float32 buffer
//   pcrl_read_batch  — thread-pooled batch read into a strided buffer
//   pcrl_version     — ABI version stamp
//
// Built at first use by pcrlv2_tpu_torch/native.py with
// g++ -O3 -std=c++17 -fPIC -pthread -shared into pcrlv2_tpu_torch/_build/.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr int kVersion = 1;

// ---------------------------------------------------------------------------
// .npy parsing
// ---------------------------------------------------------------------------

struct NpyInfo {
  char dtype;        // 'f' float32, 'd' float64, 'h' int16, 'B' uint8
  int itemsize;
  int64_t count;     // total elements
  int64_t data_off;  // byte offset of payload
};

// Parse a NumPy v1.0/v2.0 header. Returns 0 on success.
int parse_npy_header(FILE* f, NpyInfo* info) {
  unsigned char magic[8];
  if (fread(magic, 1, 8, f) != 8) return -1;
  if (memcmp(magic, "\x93NUMPY", 6) != 0) return -2;
  const int major = magic[6];
  uint32_t header_len = 0;
  int64_t preamble = 0;
  if (major == 1) {
    unsigned char l[2];
    if (fread(l, 1, 2, f) != 2) return -3;
    header_len = l[0] | (l[1] << 8);
    preamble = 10;
  } else {
    unsigned char l[4];
    if (fread(l, 1, 4, f) != 4) return -3;
    header_len = l[0] | (l[1] << 8) | (l[2] << 16) | ((uint32_t)l[3] << 24);
    preamble = 12;
  }
  std::string header(header_len, '\0');
  if (fread(&header[0], 1, header_len, f) != header_len) return -4;

  // descr
  size_t dp = header.find("'descr'");
  if (dp == std::string::npos) return -5;
  size_t q1 = header.find('\'', dp + 7);
  size_t q2 = header.find('\'', q1 + 1);
  std::string descr = header.substr(q1 + 1, q2 - q1 - 1);
  if (descr == "<f4") { info->dtype = 'f'; info->itemsize = 4; }
  else if (descr == "<f8") { info->dtype = 'd'; info->itemsize = 8; }
  else if (descr == "<i2") { info->dtype = 'h'; info->itemsize = 2; }
  else if (descr == "|u1") { info->dtype = 'B'; info->itemsize = 1; }
  else return -6;  // unsupported dtype

  // fortran_order must be False (the preprocessing stage writes C-order)
  if (header.find("'fortran_order': True") != std::string::npos) return -7;

  // shape tuple → element count
  size_t sp = header.find("'shape'");
  if (sp == std::string::npos) return -8;
  size_t p1 = header.find('(', sp);
  size_t p2 = header.find(')', p1);
  std::string shape = header.substr(p1 + 1, p2 - p1 - 1);
  int64_t count = 1;
  bool any = false;
  const char* s = shape.c_str();
  while (*s) {
    while (*s == ' ' || *s == ',') ++s;
    if (!*s) break;
    count *= strtoll(s, const_cast<char**>(&s), 10);
    any = true;
  }
  info->count = any ? count : 1;
  info->data_off = preamble + header_len;
  return 0;
}

template <typename T>
int read_payload_as_f32(FILE* f, int64_t count, float* out) {
  constexpr int64_t kChunk = 1 << 16;
  std::vector<T> buf(static_cast<size_t>(std::min(count, kChunk)));
  int64_t done = 0;
  while (done < count) {
    const int64_t n = std::min(count - done, kChunk);
    if (fread(buf.data(), sizeof(T), n, f) != static_cast<size_t>(n))
      return -10;
    for (int64_t i = 0; i < n; ++i) out[done + i] = static_cast<float>(buf[i]);
    done += n;
  }
  return 0;
}

int read_npy_f32(const char* path, float* out, int64_t capacity,
                 int64_t* n_read) {
  FILE* f = fopen(path, "rb");
  if (!f) return -100;
  NpyInfo info{};
  int rc = parse_npy_header(f, &info);
  if (rc != 0) { fclose(f); return rc; }
  if (info.count > capacity) { fclose(f); return -11; }
  if (info.dtype == 'f') {
    // fast path: direct read, no conversion
    if (fread(out, 4, info.count, f) != static_cast<size_t>(info.count))
      rc = -10;
  } else if (info.dtype == 'd') {
    rc = read_payload_as_f32<double>(f, info.count, out);
  } else if (info.dtype == 'h') {
    rc = read_payload_as_f32<int16_t>(f, info.count, out);
  } else {
    rc = read_payload_as_f32<uint8_t>(f, info.count, out);
  }
  fclose(f);
  if (rc == 0 && n_read) *n_read = info.count;
  return rc;
}

}  // namespace

extern "C" {

int pcrl_version() { return kVersion; }

// Read one .npy into a float32 buffer of `capacity` elements.
// Returns the element count, or a negative error code.
int64_t pcrl_read_npy(const char* path, float* out, int64_t capacity) {
  int64_t n = 0;
  int rc = read_npy_f32(path, out, capacity, &n);
  return rc == 0 ? n : rc;
}

// Batch read: paths[i] → out + i*stride (stride in elements). Every file must
// hold exactly `stride` elements. Returns 0, or (1 + index) of the first
// failing file, negated.
int64_t pcrl_read_batch(const char** paths, int64_t n_items, float* out,
                        int64_t stride, int n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::atomic<int64_t> next(0);
  std::atomic<int64_t> failed(0);  // 0 = ok
  auto worker = [&]() {
    for (;;) {
      const int64_t i = next.fetch_add(1);
      if (i >= n_items || failed.load(std::memory_order_relaxed)) return;
      int64_t n = 0;
      int rc = read_npy_f32(paths[i], out + i * stride, stride, &n);
      if (rc != 0 || n != stride) {
        int64_t expect = 0;
        failed.compare_exchange_strong(expect, i + 1);
        return;
      }
    }
  };
  std::vector<std::thread> pool;
  const int t = static_cast<int>(
      std::min<int64_t>(n_threads, n_items > 0 ? n_items : 1));
  pool.reserve(t);
  for (int k = 0; k < t; ++k) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return -failed.load();
}

}  // extern "C"
