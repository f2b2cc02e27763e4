// Copy of native/wirepath.cc at commit d2d1706, built by
// ceph_tpu_torch/native/bridge.py at first use.
//
// Native wirepath entry points (see wirepath.h): batch crc, gather,
// fused copy+crc, whole-window writev, and guarded rx scatter for the
// Python messenger's hot loop.  Byte-identity with the python arm is
// the contract — every function is a pure function of its input bytes,
// with crc32c (crc32c.cc, hardware or table — bit-identical) as the
// only checksum.

#include "wirepath.h"

#include <algorithm>
#include <cerrno>
#include <cstring>
#include <vector>

#include <sys/uio.h>
#include <unistd.h>

// crc32c.cc exports this without a header of its own
extern "C" uint32_t ceph_tpu_crc32c(uint32_t seed, const uint8_t* data,
                                    size_t len);

namespace {

// one batch's iovec ceiling: conservative vs UIO_MAXIOV (1024 on
// linux), matching the Python CorkedWriter's IOV_MAX discipline
constexpr int kIovMax = 512;

// fused copy+crc block: big enough to amortize the two loop heads,
// small enough that the crc pass re-reads L1/L2-hot bytes
constexpr size_t kCopyBlock = 64 * 1024;

}  // namespace

extern "C" {

const char* ceph_tpu_wirepath_kind() { return "native"; }

int32_t ceph_tpu_wire_crc_batch(const uint8_t* const* ptrs,
                                const size_t* lens, int32_t nseg,
                                const int32_t* starts, int32_t ngroups,
                                const uint32_t* seeds, uint32_t* out_crcs) {
  if (nseg < 0 || ngroups < 0 || !starts || !out_crcs) return -EINVAL;
  if ((nseg > 0 && (!ptrs || !lens)) || starts[ngroups] != nseg)
    return -EINVAL;
  // validate EVERY boundary before dereferencing any segment: a single
  // corrupt starts[] entry must not drive an out-of-bounds ptrs[] read
  for (int32_t g = 0; g < ngroups; ++g)
    if (starts[g] < 0 || starts[g] > starts[g + 1]) return -EINVAL;
  for (int32_t s = 0; s < nseg; ++s)
    if (!ptrs[s] && lens[s]) return -EINVAL;
  for (int32_t g = 0; g < ngroups; ++g) {
    uint32_t crc = seeds ? seeds[g] : 0;
    for (int32_t s = starts[g]; s < starts[g + 1]; ++s)
      crc = ceph_tpu_crc32c(crc, ptrs[s], lens[s]);
    out_crcs[g] = crc;
  }
  return 0;
}

int64_t ceph_tpu_wire_gather(const uint8_t* const* ptrs, const size_t* lens,
                             int32_t nseg, uint8_t* out, size_t cap) {
  if (nseg < 0 || !out || (nseg > 0 && (!ptrs || !lens))) return -EINVAL;
  size_t total = 0;
  for (int32_t i = 0; i < nseg; ++i) {
    if (!ptrs[i] && lens[i]) return -EINVAL;
    if (lens[i] > cap - total) return -EINVAL;  // cap - total can't wrap
    total += lens[i];
  }
  size_t off = 0;
  for (int32_t i = 0; i < nseg; ++i) {
    if (lens[i]) std::memcpy(out + off, ptrs[i], lens[i]);
    off += lens[i];
  }
  return static_cast<int64_t>(total);
}

uint32_t ceph_tpu_wire_copy_crc32c(const uint8_t* src, uint8_t* dst,
                                   size_t n, uint32_t seed) {
  uint32_t crc = seed;
  if (!src) return crc;
  if (!dst) return ceph_tpu_crc32c(crc, src, n);
  size_t off = 0;
  while (off < n) {
    size_t blk = std::min(kCopyBlock, n - off);
    std::memcpy(dst + off, src + off, blk);
    // checksum the DESTINATION bytes: cache-hot from the copy, and it
    // proves the landed copy, not just the source
    crc = ceph_tpu_crc32c(crc, dst + off, blk);
    off += blk;
  }
  return crc;
}

int64_t ceph_tpu_wire_writev(int fd, const uint8_t* const* ptrs,
                             const size_t* lens, int32_t nseg, size_t skip) {
  if (fd < 0 || nseg < 0 || (nseg > 0 && (!ptrs || !lens))) return -EINVAL;
  int32_t i = 0;
  size_t off = skip;
  while (i < nseg && off >= lens[i]) {
    off -= lens[i];
    ++i;
  }
  if (i >= nseg) return off ? -EINVAL : 0;  // skip past the end
  int64_t written = 0;
  std::vector<iovec> iov;
  iov.reserve(std::min(nseg - i, kIovMax));
  while (i < nseg) {
    iov.clear();
    size_t batch_bytes = 0;
    size_t o = off;
    for (int32_t j = i; j < nseg && static_cast<int>(iov.size()) < kIovMax;
         ++j) {
      if (!ptrs[j] && lens[j]) return -EINVAL;
      size_t len = lens[j] - o;
      if (len) {
        iovec v;
        v.iov_base = const_cast<uint8_t*>(ptrs[j]) + o;
        v.iov_len = len;
        iov.push_back(v);
        batch_bytes += len;
      }
      o = 0;
    }
    if (iov.empty()) break;  // nothing but empty segments left
    ssize_t w = ::writev(fd, iov.data(), iov.size());
    if (w < 0) {
      if (errno == EINTR) continue;
      if (errno == EAGAIN || errno == EWOULDBLOCK) return written;
      return -static_cast<int64_t>(errno);
    }
    written += w;
    size_t n = static_cast<size_t>(w);
    while (i < nseg && n >= lens[i] - off) {
      n -= lens[i] - off;
      off = 0;
      ++i;
    }
    off += n;
    if (static_cast<size_t>(w) < batch_bytes) {
      // short write: the socket buffer is nearly full — one more
      // writev round usually returns EAGAIN; loop rather than assume
      continue;
    }
  }
  return written;
}

int32_t ceph_tpu_wire_verify_regions(const uint8_t* base, size_t base_len,
                                     const int64_t* offs,
                                     const size_t* lens,
                                     const uint32_t* want, int32_t n) {
  if (n < 0 || (n > 0 && (!base || !offs || !lens || !want)))
    return -EINVAL;
  for (int32_t i = 0; i < n; ++i) {
    int64_t o = offs[i];
    if (o < 0 || static_cast<uint64_t>(o) > base_len
        || lens[i] > base_len - static_cast<size_t>(o))
      return -EINVAL;
  }
  for (int32_t i = 0; i < n; ++i) {
    if (ceph_tpu_crc32c(0, base + offs[i], lens[i]) != want[i]) return i;
  }
  return -1;
}

int32_t ceph_tpu_wire_scatter(const uint8_t* const* src_ptrs,
                              const size_t* src_lens, int32_t nfrags,
                              const int64_t* dst_offs, uint8_t* dst,
                              size_t dst_len, const uint32_t* want_crcs,
                              int32_t check_crc, int32_t* bad_idx) {
  if (bad_idx) *bad_idx = -1;
  if (nfrags < 0 || !dst
      || (nfrags > 0 && (!src_ptrs || !src_lens || !dst_offs)))
    return -EINVAL;
  if (check_crc && !want_crcs) return -EINVAL;
  int32_t copied = 0;
  for (int32_t f = 0; f < nfrags; ++f) {
    int64_t o = dst_offs[f];
    size_t len = src_lens[f];
    if (!src_ptrs[f] || o < 0 || static_cast<uint64_t>(o) > dst_len
        || len > dst_len - static_cast<size_t>(o)) {
      if (bad_idx) *bad_idx = f;
      return -EINVAL;
    }
    // overlap guard vs the fragments already accepted in THIS batch
    // (the Python LaneGroup guards against previously-confirmed
    // ranges before the call; together they keep a corrupt-offset
    // fragment from stomping verified bytes of the assembly buffer)
    for (int32_t p = 0; p < f; ++p) {
      int64_t po = dst_offs[p];
      size_t plen = src_lens[p];
      if (o < po + static_cast<int64_t>(plen)
          && po < o + static_cast<int64_t>(len)) {
        if (bad_idx) *bad_idx = f;
        return -EINVAL;
      }
    }
    if (check_crc) {
      // verify the SOURCE bytes first: a corrupt fragment must die
      // before a single byte of it lands in the assembly
      if (ceph_tpu_crc32c(0, src_ptrs[f], len) != want_crcs[f]) {
        if (bad_idx) *bad_idx = f;
        return -EBADMSG;
      }
    }
    if (len) std::memcpy(dst + o, src_ptrs[f], len);
    ++copied;
  }
  return copied;
}

int32_t ceph_tpu_wirepath_selftest() {
  // deterministic payload
  uint8_t data[4096];
  for (size_t i = 0; i < sizeof(data); ++i)
    data[i] = static_cast<uint8_t>((i * 131) ^ (i >> 3));

  // 1: crc_batch == chained single crc
  {
    const uint8_t* ptrs[3] = {data, data + 100, data + 1000};
    size_t lens[3] = {100, 900, 3096};
    int32_t starts[3] = {0, 2, 3};
    uint32_t seeds[2] = {0, 7};
    uint32_t out[2] = {0, 0};
    if (ceph_tpu_wire_crc_batch(ptrs, lens, 3, starts, 2, seeds, out) != 0)
      return 1;
    uint32_t want0 = ceph_tpu_crc32c(ceph_tpu_crc32c(0, data, 100),
                                     data + 100, 900);
    uint32_t want1 = ceph_tpu_crc32c(7, data + 1000, 3096);
    if (out[0] != want0 || out[1] != want1) return 2;
    // bad geometry: starts not ending at nseg / decreasing
    int32_t bad_starts[3] = {0, 2, 2};
    if (ceph_tpu_wire_crc_batch(ptrs, lens, 3, bad_starts, 2, seeds, out)
        != -EINVAL)
      return 3;
    int32_t dec_starts[3] = {0, 2, 1};
    if (ceph_tpu_wire_crc_batch(ptrs, lens, 1, dec_starts, 2, seeds, out)
        != -EINVAL)
      return 4;
  }

  // 2: gather round-trip + cap refusal
  {
    const uint8_t* ptrs[2] = {data, data + 2048};
    size_t lens[2] = {2048, 2048};
    uint8_t out[4096];
    if (ceph_tpu_wire_gather(ptrs, lens, 2, out, sizeof(out)) != 4096)
      return 5;
    if (std::memcmp(out, data, 4096) != 0) return 6;
    if (ceph_tpu_wire_gather(ptrs, lens, 2, out, 4095) != -EINVAL)
      return 7;  // truncated destination must refuse, not spill
  }

  // 3: fused copy+crc == memcmp + plain crc
  {
    uint8_t out[4096];
    std::memset(out, 0xAA, sizeof(out));
    uint32_t crc = ceph_tpu_wire_copy_crc32c(data, out, sizeof(data), 5);
    if (crc != ceph_tpu_crc32c(5, data, sizeof(data))) return 8;
    if (std::memcmp(out, data, sizeof(data)) != 0) return 9;
    if (ceph_tpu_wire_copy_crc32c(data, nullptr, 64, 0)
        != ceph_tpu_crc32c(0, data, 64))
      return 10;
  }

  // 4: scatter — benign reassembly, then the hostile battery
  {
    uint8_t dst[4096];
    std::memset(dst, 0, sizeof(dst));
    const uint8_t* srcs[2] = {data + 2048, data};
    size_t lens[2] = {2048, 2048};
    int64_t offs[2] = {2048, 0};  // arrival order != offset order
    uint32_t crcs[2] = {ceph_tpu_crc32c(0, data + 2048, 2048),
                        ceph_tpu_crc32c(0, data, 2048)};
    int32_t bad = -1;
    if (ceph_tpu_wire_scatter(srcs, lens, 2, offs, dst, sizeof(dst), crcs,
                              1, &bad) != 2 || bad != -1)
      return 11;
    if (std::memcmp(dst, data, sizeof(dst)) != 0) return 12;

    // corrupt offset: fragment 1 claims an offset overlapping frag 0
    int64_t overlap_offs[2] = {0, 1024};
    if (ceph_tpu_wire_scatter(srcs, lens, 2, overlap_offs, dst,
                              sizeof(dst), crcs, 1, &bad) != -EINVAL
        || bad != 1)
      return 13;

    // out-of-bounds tail: off + len > dst_len (truncated assembly)
    int64_t oob_offs[1] = {3000};
    if (ceph_tpu_wire_scatter(srcs, lens, 1, oob_offs, dst, sizeof(dst),
                              crcs, 1, &bad) != -EINVAL || bad != 0)
      return 14;

    // negative offset (corrupt i64 from the wire)
    int64_t neg_offs[1] = {-1};
    if (ceph_tpu_wire_scatter(srcs, lens, 1, neg_offs, dst, sizeof(dst),
                              crcs, 1, &bad) != -EINVAL || bad != 0)
      return 15;

    // crc mismatch: the corrupt fragment must not land a byte
    std::memset(dst, 0x55, sizeof(dst));
    uint32_t wrong[1] = {crcs[0] ^ 1};
    if (ceph_tpu_wire_scatter(srcs, lens, 1, offs, dst, sizeof(dst),
                              wrong, 1, &bad) != -EBADMSG || bad != 0)
      return 16;
    for (size_t i = 0; i < sizeof(dst); ++i)
      if (dst[i] != 0x55) return 17;

    // zero-length fragment at the boundary is legal (empty tail)
    size_t zlen[1] = {0};
    int64_t edge[1] = {static_cast<int64_t>(sizeof(dst))};
    uint32_t zcrc[1] = {0};
    if (ceph_tpu_wire_scatter(srcs, zlen, 1, edge, dst, sizeof(dst), zcrc,
                              1, &bad) != 1)
      return 18;
  }

  // 5: burst region verify — match, mismatch index, truncated bounds
  {
    int64_t offs[3] = {0, 512, 2048};
    size_t lens[3] = {512, 1536, 2048};
    uint32_t want[3] = {ceph_tpu_crc32c(0, data, 512),
                        ceph_tpu_crc32c(0, data + 512, 1536),
                        ceph_tpu_crc32c(0, data + 2048, 2048)};
    if (ceph_tpu_wire_verify_regions(data, sizeof(data), offs, lens, want,
                                     3) != -1)
      return 19;
    want[1] ^= 1;
    if (ceph_tpu_wire_verify_regions(data, sizeof(data), offs, lens, want,
                                     3) != 1)
      return 20;
    // region running past the buffer (truncated backlog) must refuse
    // before any read, not checksum out of bounds
    int64_t oob[1] = {4000};
    size_t oob_len[1] = {1000};
    if (ceph_tpu_wire_verify_regions(data, sizeof(data), oob, oob_len,
                                     want, 1) != -EINVAL)
      return 21;
  }

  return 0;
}

}  // extern "C"
