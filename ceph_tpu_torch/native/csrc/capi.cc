// Flat C API for the Python ctypes bridge (ceph_tpu_torch/native/bridge.py):
// byte-exactness cross-checks between the native core and the numpy
// oracle, and the CPU codecs' w=8 _apply seam (ec/codecs.py).

#include <algorithm>
#include <cstring>
#include <thread>
#include <vector>

#include "ec_api.h"
#include "gf256.h"
#include "rs.h"

using namespace ceph_tpu;

namespace {

// technique name -> coding matrix; false when the name is unknown.
// Shared by the ST and MT encodes so they can never diverge.
bool make_coding_matrix(const std::string& t, int k, int m, Matrix* out) {
  if (t == "reed_sol_van") *out = vandermonde_coding_matrix(k, m);
  else if (t == "reed_sol_r6_op") *out = r6_coding_matrix(k);
  else if (t == "cauchy_orig") *out = cauchy_orig_matrix(k, m);
  else if (t == "isa_reed_sol_van") *out = isa_vandermonde_matrix(k, m);
  else if (t == "isa_cauchy") *out = isa_cauchy_matrix(k, m);
  else return false;
  return true;
}

}  // namespace

extern "C" {

// flat GF ops (table cross-check)
uint8_t ceph_tpu_gf_mul(uint8_t a, uint8_t b) {
  return GF256::instance().mul(a, b);
}

// which region kernel is live: "gfni" | "avx2" | "scalar"
const char* ceph_tpu_simd_kind() { return GF256::instance().simd_kind(); }

// contiguous-buffer encode: data is k*chunk bytes, parity out m*chunk
int ceph_tpu_rs_encode(const char* technique, int k, int m,
                       const uint8_t* data, uint8_t* parity, size_t chunk) {
  try {
    Matrix coding;
    if (!make_coding_matrix(technique, k, m, &coding)) return -22;
    RSCodec rs(k, m, std::move(coding));
    std::vector<const uint8_t*> dptr(k);
    std::vector<uint8_t*> pptr(m);
    for (int i = 0; i < k; ++i) dptr[i] = data + static_cast<size_t>(i) * chunk;
    for (int i = 0; i < m; ++i) pptr[i] = parity + static_cast<size_t>(i) * chunk;
    rs.encode(dptr.data(), pptr.data(), chunk);
    return 0;
  } catch (...) {
    return -22;
  }
}

// Multi-threaded contiguous-buffer encode: the SOCKET-level baseline.
// Each thread encodes a contiguous column range of every chunk (the GF
// region kernels are column-independent), the way a saturated multi-core
// isa-l deployment would run — one core per range, no cross-thread
// synchronization inside the kernel.  nthreads <= 0 picks
// hardware_concurrency.  Returns the thread count used, or -errno.
int ceph_tpu_rs_encode_mt(const char* technique, int k, int m,
                          const uint8_t* data, uint8_t* parity, size_t chunk,
                          int nthreads) {
  try {
    Matrix coding;
    if (!make_coding_matrix(technique, k, m, &coding)) return -22;
    RSCodec rs(k, m, std::move(coding));
    if (nthreads <= 0) {
      nthreads = static_cast<int>(std::thread::hardware_concurrency());
      if (nthreads <= 0) nthreads = 1;
    }
    // ceil-divide FIRST so nthreads ranges always cover the whole chunk
    // (floor + align could leave an unencoded tail), then 64B-align so
    // every thread's kernel runs on full vectors
    size_t per = (((chunk + nthreads - 1) / nthreads + 63) / 64) * 64;
    if (per == 0) per = chunk;
    std::vector<std::thread> threads;
    int used = 0;
    try {
      for (int ti = 0; ti < nthreads; ++ti) {
        size_t lo = static_cast<size_t>(ti) * per;
        if (lo >= chunk) break;
        size_t len = std::min(per, chunk - lo);
        threads.emplace_back([&, lo, len] {
          std::vector<const uint8_t*> dptr(k);
          std::vector<uint8_t*> pptr(m);
          for (int i = 0; i < k; ++i)
            dptr[i] = data + static_cast<size_t>(i) * chunk + lo;
          for (int i = 0; i < m; ++i)
            pptr[i] = parity + static_cast<size_t>(i) * chunk + lo;
          rs.encode(dptr.data(), pptr.data(), len);
        });
        ++used;
      }
    } catch (...) {
      // spawn failure (thread limits): join what started — destroying a
      // joinable std::thread would std::terminate the whole process —
      // then report the failure
      for (auto& th : threads) th.join();
      return -11;
    }
    for (auto& th : threads) th.join();
    return used;
  } catch (...) {
    return -22;
  }
}

// Apply an ARBITRARY GF(2^8) matrix to symbol regions: out[rows x chunk]
// = M[rows x cols] (x) data[cols x chunk].  This is the codec _apply
// seam — encode (generator), decode (inverted signature matrix), and
// recovery all ride it, so the daemon's CPU path gets the vectorized
// region kernels for every matrix, not just named techniques.
int ceph_tpu_gf_apply(const uint8_t* matrix, int rows, int cols,
                      const uint8_t* data, uint8_t* out, size_t chunk) {
  try {
    Matrix mat(rows, std::vector<uint8_t>(cols));
    for (int r = 0; r < rows; ++r)
      for (int c = 0; c < cols; ++c)
        mat[r][c] = matrix[static_cast<size_t>(r) * cols + c];
    RSCodec rs(cols, rows, std::move(mat));
    std::vector<const uint8_t*> dptr(cols);
    std::vector<uint8_t*> optr(rows);
    for (int i = 0; i < cols; ++i)
      dptr[i] = data + static_cast<size_t>(i) * chunk;
    for (int i = 0; i < rows; ++i)
      optr[i] = out + static_cast<size_t>(i) * chunk;
    rs.encode(dptr.data(), optr.data(), chunk);
    return 0;
  } catch (...) {
    return -22;
  }
}

// decode: sources = k global ids; source_data k*chunk contiguous;
// targets = ntargets ids; out ntargets*chunk
int ceph_tpu_rs_decode(const char* technique, int k, int m,
                       const int* sources, const uint8_t* source_data,
                       int ntargets, const int* targets, uint8_t* out,
                       size_t chunk) {
  try {
    Matrix coding;
    if (!make_coding_matrix(technique, k, m, &coding)) return -22;
    RSCodec rs(k, m, std::move(coding));
    std::vector<int> src(sources, sources + k);
    std::vector<int> tgt(targets, targets + ntargets);
    std::vector<const uint8_t*> sptr(k);
    std::vector<uint8_t*> optr(ntargets);
    for (int i = 0; i < k; ++i)
      sptr[i] = source_data + static_cast<size_t>(i) * chunk;
    for (int i = 0; i < ntargets; ++i)
      optr[i] = out + static_cast<size_t>(i) * chunk;
    rs.decode(src, sptr.data(), tgt, optr.data(), chunk);
    return 0;
  } catch (...) {
    return -5;
  }
}

}  // extern "C"
