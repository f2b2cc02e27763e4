// Copy of native/wirepath.h at commit d2d1706, built by
// ceph_tpu_torch/native/bridge.py at first use; its comments leave out
// the reference's round numbers.
//
// Native wirepath: the messenger's per-byte hot loop below the GIL.
//
// The sharded reactor plane measured an honest wall: on a
// GIL-bound host the multi-reactor TCP arm cannot beat the single-loop
// path because every per-byte operation — frame crc, fragment memcpy,
// writev segment assembly — runs under the interpreter lock.  These
// entry points batch that work into single foreign calls (ctypes drops
// the GIL around them), the wire-plane application of the
// specialize-the-byte-loops technique from "Accelerating XOR-based
// Erasure Coding using Program Optimization Techniques"
// (arXiv:2108.02692): the compiler vectorizes the copy/crc loops, and
// reactor threads overlap while a call runs.
//
// Contract shared with ceph_tpu/native/bridge.py and the python arm in
// ceph_tpu/utils/wirepath.py: every function is a PURE function of its
// input bytes (byte-identity with the python arm is the correctness
// gate), never calls back into Python, and validates peer-claimed
// geometry (offsets, lengths, overlap) before touching memory — the
// FRAG_MAX overlap guard of LaneGroup.frag_view must hold here too.

#pragma once

#include <cstddef>
#include <cstdint>

extern "C" {

// which arm is live — "native" (mirrors ceph_tpu_crc32c_kind's role:
// BENCH records and /metrics report the arm that actually ran)
const char* ceph_tpu_wirepath_kind();

// Batch chained crc32c: ngroups frame-crc groups over a flat segment
// list; group g covers segments [starts[g], starts[g+1]) (starts has
// ngroups+1 entries, nondecreasing, ending at nseg) and chains
// crc32c from seeds[g] across its segments into out_crcs[g] — one
// released-GIL call for a whole flush window / rx burst instead of one
// ctypes round-trip per segment.  Returns 0, or -EINVAL on bad
// geometry (nothing written).
int32_t ceph_tpu_wire_crc_batch(const uint8_t* const* ptrs,
                                const size_t* lens, int32_t nseg,
                                const int32_t* starts, int32_t ngroups,
                                const uint32_t* seeds, uint32_t* out_crcs);

// Gather nseg segments into one contiguous tx buffer (the corked flush
// window's segment walk, natively).  Returns total bytes gathered, or
// -EINVAL when the segments exceed `cap` (nothing written).
int64_t ceph_tpu_wire_gather(const uint8_t* const* ptrs, const size_t* lens,
                             int32_t nseg, uint8_t* out, size_t cap);

// Single-pass copy + crc32c: copies src[0..n) to dst and returns the
// crc32c of the bytes, chained from `seed` — the rx verify+land step
// fused (blockwise, so the checksum pass runs cache-hot behind the
// copy).  dst may be NULL to checksum without copying.
uint32_t ceph_tpu_wire_copy_crc32c(const uint8_t* src, uint8_t* dst,
                                   size_t n, uint32_t seed);

// writev the segment list (minus `skip` leading logical bytes) onto a
// NONBLOCKING fd, looping over partial writes, EINTR, and IOV_MAX
// batches until everything is written or the kernel would block.
// Returns bytes written this call (0 = would-block immediately), or
// -errno on a hard socket error.  One foreign call drains a whole
// corked flush window with the GIL released.
int64_t ceph_tpu_wire_writev(int fd, const uint8_t* const* ptrs,
                             const size_t* lens, int32_t nseg, size_t skip);

// rx burst verify: n regions of ONE contiguous buffer (the
// FrameReceiver's pending backlog), each at offs[i]/lens[i], must
// crc32c (seed 0) to want[i].  One released-GIL call covers a whole
// burst's frame+blob crc sections — the caller passes plain integer
// offsets, so no per-region marshalling happens above.  Returns -1
// when every region matches, the first mismatching index on crc
// failure, or -EINVAL on out-of-bounds geometry.
int32_t ceph_tpu_wire_verify_regions(const uint8_t* base, size_t base_len,
                                     const int64_t* offs,
                                     const size_t* lens,
                                     const uint32_t* want, int32_t n);

// rx scatter: copy nfrags source fragments into dst at dst_offs[i],
// refusing peer-claimed geometry that is out of bounds or overlaps
// another fragment in the batch (the assembly-buffer overlap guard).
// With check_crc, fragment i's crc32c must equal want_crcs[i] — the
// crc runs over the SOURCE bytes before any copy, so a corrupt frame
// never lands a byte.  Fragments are validated and copied in order;
// on refusal *bad_idx gets the offending index and no later fragment
// is touched.  Returns fragments copied (== nfrags on success),
// -EINVAL (geometry) or -EBADMSG (crc) with *bad_idx set.
int32_t ceph_tpu_wire_scatter(const uint8_t* const* src_ptrs,
                              const size_t* src_lens, int32_t nfrags,
                              const int64_t* dst_offs, uint8_t* dst,
                              size_t dst_len, const uint32_t* want_crcs,
                              int32_t check_crc, int32_t* bad_idx);

// Adversarial self-battery: truncated, overlapping, corrupt-offset and
// oversize fragment geometries against the scatter/gather/crc entry
// points above.  Returns 0 when every hostile case is refused and every
// benign case round-trips; a nonzero return is the failing case number.
// Runs under the ASan/UBSan flavor in the slow native test leg (an
// asan .so cannot be dlopen'd into a plain python process, so the
// battery lives here and a sanitized exe wraps it) and via ctypes in
// the tier-1 smoke.
int32_t ceph_tpu_wirepath_selftest();

}  // extern "C"
