// GF(2^8) arithmetic over the 0x11D field — the native CPU core.
//
// Same field and table discipline as the reference's jerasure/gf-complete
// stack (galois_init_default_field w=8, poly 0435 octal = 0x11D); region
// multiply uses split hi/lo-nibble tables, the layout both isa-l's pshufb
// kernels and gf-complete's SPLIT_TABLE(8,4) use, which the compiler can
// auto-vectorize with -O3 -mavx2.
//
// This library is the byte-exactness oracle's native twin: the Python
// numpy oracle (ceph_tpu_torch/ec/gf.py) and this file must agree bit-for-bit
// (asserted by tests/test_torch_native.py through the ctypes bridge).

#pragma once

#include <cstdint>
#include <cstddef>

namespace ceph_tpu {

class GF256 {
 public:
  static const GF256& instance();

  uint8_t mul(uint8_t a, uint8_t b) const {
    if (a == 0 || b == 0) return 0;
    return antilog_[log_[a] + log_[b]];
  }
  uint8_t div(uint8_t a, uint8_t b) const;  // b != 0
  uint8_t inv(uint8_t a) const { return div(1, a); }
  uint8_t pow(uint8_t a, unsigned n) const;

  // dst[i] ^= c * src[i] over len bytes (the region kernel)
  void mul_region_xor(uint8_t c, const uint8_t* src, uint8_t* dst,
                      size_t len) const;
  // dst[i] = c * src[i]
  void mul_region(uint8_t c, const uint8_t* src, uint8_t* dst,
                  size_t len) const;

  // which vectorized region kernel is live ("gfni", "avx2", "scalar") —
  // the honest-baseline requirement: the bench's CPU A/B must be the
  // fastest encode this host can produce, not a scalar strawman
  const char* simd_kind() const { return simd_kind_; }

 private:
  GF256();
  void init_simd();
  int log_[256];
  uint8_t antilog_[512];
  // split nibble tables: nib_[c][0][x] = c*x, nib_[c][1][x] = c*(x<<4)
  uint8_t nib_[256][2][16];
  // GFNI affine matrices: affine_[c] is the 8x8 GF(2) matrix of
  // "multiply by c" over THIS field's polynomial (0x11D) in the layout
  // vgf2p8affineqb expects; validated at init against mul()
  uint64_t affine_[256];
  const char* simd_kind_ = "scalar";
  bool use_gfni_ = false;
  bool use_avx2_ = false;
};

}  // namespace ceph_tpu
