// Packed-bit XOR-schedule kernels for Hopper: the C interface bound by ctypes
// (ceph_tpu_torch/ops/cuda_packedbit.py) and the program encoding it shares
// with the host.
//
// A GF(2) bit-matrix runs as a straight-line XOR program (xor_schedule_program
// in ops/gf2.py), its output rows split into groups, each with its own
// sub-program (the temps its rows need, then its rows), encoded once per
// matrix on the host (cuda_packedbit.py encode_program) as int32 [n, 4] steps
// (a, b, d, meta), the groups one after another, and read by the kernels as
// int4.  Values are addressed by index: 0..C-1 are the C input rows, then
// each group's temp slots (reused by liveness within the group), then ZERO
// (n_vals - 2, always zero) and DUMMY (n_vals - 1, written, never read).  On
// the device a, b and d are byte offsets (index times the row pitch of the
// values in shared memory: 32 elements; DUMMY is -1, and a step whose d is
// -1 stores nothing), a header of int4 rows holding each group's first step
// (group_off[0..G], G = n_groups) comes first, and PREFETCH + 1 steps that
// do nothing follow the last.  Every step does the same:
//   x = value[a] ^ value[b];  value[d] = x;
//   acc = (meta & FIRST) ? x : acc ^ x;  if (meta & LAST) row meta >> 2 = acc
// A temp step writes its slot; an output step writes DUMMY and folds one or
// two terms into the row being built.  No step reads a value that one of
// the PREFETCH steps before it in its group wrote, so the kernels load a
// step's operands PREFETCH steps early.
// Warp g of a block walks group g, steps group_off[g] .. group_off[g+1]-1;
// n_instr = group_off[G].
#pragma once

#include <cstdint>

#define CTT_PB_FIRST 1
#define CTT_PB_LAST 2

// Steps ahead of the one it computes that the walk loads operands for.
#define CTT_PB_PREFETCH 1

// Shared memory a block may use on an H100 (227 KB).
#define CTT_PB_MAX_SMEM 232448

// Output-row groups of a program: warps of a K3 or K4 block.
#define CTT_PB_MAX_GROUPS 16

#ifdef __cplusplus
extern "C" {
#endif

// K3: the program over the first C rows of `in` ([>= C, row_bytes] bytes of
// any element type) -> `out` [R, row_bytes].  A block takes 32 elements of
// `vec` bytes (16, 4 or 1) of every row and one warp for each of n_groups
// groups; `in`, `out` and row_bytes must be multiples of vec, and the
// program's offsets are for a row pitch of 32 * vec bytes.
// n_vals = C + slots + 2.  Returns a cudaError_t value.
int ctt_xor_schedule(const int32_t* prog, int n_instr, int n_groups, int C,
                     int n_vals, const void* in, void* out,
                     long long row_bytes, int vec, void* stream);

// K4: [out_rows*8, k*8] program applied to [k, B] uint8 chunks (w=8 byte
// layout) -> [out_rows, B] uint8, through u32 plane words in shared memory.
// A block takes 32 * `words` word columns (words: 1 or 2 a lane; the
// program's offsets are for a row pitch of 128 * words bytes) and one warp
// for each group.  With `planes` non-null it also stores the data and parity
// plane words, [(k + out_rows)*8, ceil(B/32)] u32 (the resident form).
int ctt_apply_packedbit(const int32_t* prog, int n_instr, int n_groups, int k,
                        int out_rows, int n_vals, const uint8_t* data,
                        long long B, uint8_t* out, uint32_t* planes,
                        int words, void* stream);

// K5: [n, B] uint8 -> [n*8, ceil(B/32)] u32 plane words (pad bits zero).
int ctt_to_packedbit(const uint8_t* data, int n, long long B, uint32_t* planes,
                     int threads, void* stream);

// K6: [rows*8, W] u32 plane words -> [rows, W*32] uint8.
int ctt_from_packedbit(const uint32_t* planes, int rows, long long W,
                       uint8_t* out, int threads, void* stream);

// Paged K6: plane rows of a paged resident (addr: int64 addresses of its
// n_pages pages, page_words words each, in order), out_rows*8 rows of
// row_words words from its word w0 -> bytes.  cs = 0: [out_rows, L] shard
// rows.  cs > 0 (L a multiple of cs): the object's stripe-major bytes,
// byte c of row o at (c / cs) * out_rows * cs + o * cs + c % cs, those
// below `limit` only.  L <= 32 * row_words.
int ctt_from_packedbit_paged(const long long* addr, int n_pages,
                             long long page_words, long long w0,
                             long long row_words, int out_rows, long long L,
                             long long cs, long long limit, uint8_t* out,
                             int threads, void* stream);

// Paged K5: [n, B] uint8 -> the plane words of a resident of n_pages pages
// (n*8 rows of ceil(B/32) words, through addr as above), and zeros over the
// rest of the last page.
int ctt_to_packedbit_paged(const uint8_t* data, int n, long long B,
                           const long long* addr, int n_pages,
                           long long page_words, int threads, void* stream);

const char* ctt_pb_error_string(int code);

#ifdef __cplusplus
}
#endif
