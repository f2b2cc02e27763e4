#include "gf256.h"

#include <cstdlib>

#if defined(__x86_64__)
#include <immintrin.h>
#endif

namespace ceph_tpu {

static constexpr int kPoly = 0x11D;

GF256::GF256() {
  int x = 1;
  for (int i = 0; i < 255; ++i) {
    log_[x] = i;
    antilog_[i] = static_cast<uint8_t>(x);
    x <<= 1;
    if (x & 0x100) x ^= kPoly;
  }
  for (int i = 255; i < 510; ++i) antilog_[i] = antilog_[i - 255];
  log_[0] = -1;
  for (int c = 0; c < 256; ++c) {
    for (int v = 0; v < 16; ++v) {
      nib_[c][0][v] = mul(static_cast<uint8_t>(c), static_cast<uint8_t>(v));
      nib_[c][1][v] = mul(static_cast<uint8_t>(c), static_cast<uint8_t>(v << 4));
    }
  }
  init_simd();
}

void GF256::init_simd() {
  // CEPH_TPU_NO_SIMD=1 pins the scalar nibble-table path: the bench
  // measures it so the reported ratios cover both the honest SIMD
  // baseline and the scalar one earlier rounds compared against
  if (const char* e = getenv("CEPH_TPU_NO_SIMD")) {
    if (e[0] == '1') return;
  }
  // Multiplication by a constant c is GF(2)-linear, so it is an 8x8 bit
  // matrix — exactly what vgf2p8affineqb applies, for ANY field
  // polynomial (the fixed-poly gf2p8mulb is useless here: it hardwires
  // 0x11B, ours is gf-complete's 0x11D).  Build the matrix from the
  // images of the basis vectors; the instruction's layout is qword byte
  // i = matrix row for OUTPUT bit (7-i), rows dotted with the input
  // byte.  Rather than trust the convention from memory, validate the
  // whole table against mul() below and fall back to AVX2 pshufb split
  // tables (unambiguous) if anything disagrees.
#if defined(__GFNI__) && defined(__AVX512F__) && defined(__AVX512BW__)
  for (int c = 0; c < 256; ++c) {
    uint64_t a = 0;
    for (int row = 0; row < 8; ++row) {
      // row r of the matrix produces output bit (7 - byte index); the
      // matrix entry (r, j) multiplies input bit (7 - j).  Build row r
      // so that parity(row & x) == bit r of mul(c, x).
      uint8_t rowbits = 0;
      for (int j = 0; j < 8; ++j) {
        uint8_t basis = static_cast<uint8_t>(1u << (7 - j));
        if (mul(static_cast<uint8_t>(c), basis) & (1u << (7 - row)))
          rowbits |= static_cast<uint8_t>(1u << (7 - j));
      }
      a |= static_cast<uint64_t>(rowbits) << (8 * row);
    }
    affine_[c] = a;
  }
  bool ok = true;
  for (int c = 2; c < 256 && ok; c += 61) {  // spot constants incl. c=2
    __m512i A = _mm512_set1_epi64(static_cast<long long>(affine_[c]));
    alignas(64) uint8_t in[64], out[64];
    for (int i = 0; i < 64; ++i) in[i] = static_cast<uint8_t>(i * 37 + 11);
    __m512i v = _mm512_loadu_si512(in);
    _mm512_storeu_si512(out, _mm512_gf2p8affine_epi64_epi8(v, A, 0));
    for (int i = 0; i < 64 && ok; ++i)
      ok = out[i] == mul(static_cast<uint8_t>(c), in[i]);
  }
  if (ok) {
    use_gfni_ = true;
    simd_kind_ = "gfni";
    return;
  }
#endif
#if defined(__AVX2__)
  use_avx2_ = true;
  simd_kind_ = "avx2";
#endif
}

const GF256& GF256::instance() {
  static GF256 gf;
  return gf;
}

uint8_t GF256::div(uint8_t a, uint8_t b) const {
  if (a == 0) return 0;
  return antilog_[log_[a] - log_[b] + 255];
}

uint8_t GF256::pow(uint8_t a, unsigned n) const {
  if (n == 0) return 1;
  if (a == 0) return 0;
  return antilog_[(static_cast<unsigned>(log_[a]) * n) % 255];
}

void GF256::mul_region_xor(uint8_t c, const uint8_t* src, uint8_t* dst,
                           size_t len) const {
  if (c == 0) return;
  size_t i = 0;
  if (c == 1) {
#if defined(__AVX2__)
    for (; i + 32 <= len; i += 32) {
      __m256i d = _mm256_loadu_si256(reinterpret_cast<const __m256i*>(dst + i));
      __m256i s = _mm256_loadu_si256(reinterpret_cast<const __m256i*>(src + i));
      _mm256_storeu_si256(reinterpret_cast<__m256i*>(dst + i),
                          _mm256_xor_si256(d, s));
    }
#endif
    for (; i < len; ++i) dst[i] ^= src[i];
    return;
  }
#if defined(__GFNI__) && defined(__AVX512F__) && defined(__AVX512BW__)
  if (use_gfni_) {
    __m512i A = _mm512_set1_epi64(static_cast<long long>(affine_[c]));
    for (; i + 64 <= len; i += 64) {
      __m512i s = _mm512_loadu_si512(src + i);
      __m512i d = _mm512_loadu_si512(dst + i);
      __m512i p = _mm512_gf2p8affine_epi64_epi8(s, A, 0);
      _mm512_storeu_si512(dst + i, _mm512_xor_si512(d, p));
    }
  }
#endif
#if defined(__AVX2__)
  if (use_avx2_ || use_gfni_) {  // gfni path also uses this for the tail
    const __m128i lo128 =
        _mm_loadu_si128(reinterpret_cast<const __m128i*>(nib_[c][0]));
    const __m128i hi128 =
        _mm_loadu_si128(reinterpret_cast<const __m128i*>(nib_[c][1]));
    const __m256i lo_tbl = _mm256_broadcastsi128_si256(lo128);
    const __m256i hi_tbl = _mm256_broadcastsi128_si256(hi128);
    const __m256i mask = _mm256_set1_epi8(0x0F);
    for (; i + 32 <= len; i += 32) {
      __m256i v = _mm256_loadu_si256(reinterpret_cast<const __m256i*>(src + i));
      __m256i d = _mm256_loadu_si256(reinterpret_cast<const __m256i*>(dst + i));
      __m256i lo = _mm256_and_si256(v, mask);
      __m256i hi = _mm256_and_si256(_mm256_srli_epi16(v, 4), mask);
      __m256i p = _mm256_xor_si256(_mm256_shuffle_epi8(lo_tbl, lo),
                                   _mm256_shuffle_epi8(hi_tbl, hi));
      _mm256_storeu_si256(reinterpret_cast<__m256i*>(dst + i),
                          _mm256_xor_si256(d, p));
    }
  }
#endif
  const uint8_t* lo = nib_[c][0];
  const uint8_t* hi = nib_[c][1];
  for (; i < len; ++i) {
    uint8_t v = src[i];
    dst[i] ^= static_cast<uint8_t>(lo[v & 0xF] ^ hi[v >> 4]);
  }
}

void GF256::mul_region(uint8_t c, const uint8_t* src, uint8_t* dst,
                       size_t len) const {
  if (c == 0) {
    for (size_t i = 0; i < len; ++i) dst[i] = 0;
    return;
  }
  if (c == 1) {
    for (size_t i = 0; i < len; ++i) dst[i] = src[i];
    return;
  }
  size_t i = 0;
#if defined(__GFNI__) && defined(__AVX512F__) && defined(__AVX512BW__)
  if (use_gfni_) {
    __m512i A = _mm512_set1_epi64(static_cast<long long>(affine_[c]));
    for (; i + 64 <= len; i += 64) {
      __m512i s = _mm512_loadu_si512(src + i);
      _mm512_storeu_si512(dst + i, _mm512_gf2p8affine_epi64_epi8(s, A, 0));
    }
  }
#endif
#if defined(__AVX2__)
  if (use_avx2_ || use_gfni_) {
    const __m128i lo128 =
        _mm_loadu_si128(reinterpret_cast<const __m128i*>(nib_[c][0]));
    const __m128i hi128 =
        _mm_loadu_si128(reinterpret_cast<const __m128i*>(nib_[c][1]));
    const __m256i lo_tbl = _mm256_broadcastsi128_si256(lo128);
    const __m256i hi_tbl = _mm256_broadcastsi128_si256(hi128);
    const __m256i mask = _mm256_set1_epi8(0x0F);
    for (; i + 32 <= len; i += 32) {
      __m256i v = _mm256_loadu_si256(reinterpret_cast<const __m256i*>(src + i));
      __m256i lo = _mm256_and_si256(v, mask);
      __m256i hi = _mm256_and_si256(_mm256_srli_epi16(v, 4), mask);
      _mm256_storeu_si256(
          reinterpret_cast<__m256i*>(dst + i),
          _mm256_xor_si256(_mm256_shuffle_epi8(lo_tbl, lo),
                           _mm256_shuffle_epi8(hi_tbl, hi)));
    }
  }
#endif
  const uint8_t* lo = nib_[c][0];
  const uint8_t* hi = nib_[c][1];
  for (; i < len; ++i) {
    uint8_t v = src[i];
    dst[i] = static_cast<uint8_t>(lo[v & 0xF] ^ hi[v >> 4]);
  }
}

}  // namespace ceph_tpu
