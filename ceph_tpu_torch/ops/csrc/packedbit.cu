// The packed-bit XOR-schedule lane for Hopper (sm_90a): four kernels behind a
// plain C interface (packedbit.cuh), built by ceph_tpu_torch/ops/build.py with
// nvcc and bound by ops/cuda_packedbit.py.
//
// They replace the XLA functions of the reference's production w=8 lane
// (ceph_tpu/ops/gf2.py), which XLA fuses into one loop per compiled schedule.
// In eager PyTorch each XOR of a schedule would be its own launch (a k=8 m=3
// encode is 230 XORs), so each function is one hand-written kernel, and the
// schedule is an operand: one build serves every matrix.
//
// * xor_schedule (K3) <- gf2_xor_packed: an XOR program over C rows of any
//   bytes (u32 plane words or uint8 packet rows; XOR is XOR) -> R rows.
//   A block takes 32 columns (elements of 16, 4 or 1 bytes, as the
//   addresses and the row pitch allow) and one warp for each group of
//   output rows: the host splits the rows into G groups, each with its own
//   sub-program (the temps its rows need, then its rows) and its own temp
//   slots.  The block stages its C input elements in shared memory as
//   [value][column], the G warps share them, and each warp walks its own
//   sub-program over them (staged in shared memory, read as a broadcast), so
//   no warp diverges.  Lanes past the row's end load zeros and store nothing.
//   Bound: bytes, C rows read once and R rows written once ((64 + 24) *
//   64 KiB at the cauchy_good k=8 m=3 main shape: 1.7 us at 3.35 TB/s).  The
//   XORs are a few hundred shared-memory operations per element.  On an
//   H100 80GB HBM3 at 700 W one warp walking a whole program at one warp a
//   scheduler waited on each step's shared-memory loads (55 to 100 cycles
//   a step, PERF.md); split over six warps, each warp's chain is about a
//   third as long and the walk is held by shared-memory throughput instead,
//   beside the loads' burst from device memory.  Every step takes one path,
//   its operands are loaded a step ahead (run_program), the operands'
//   addresses are byte offsets precomputed on the host, and an output step
//   stores no temp.
// * apply_packedbit (K4) <- gf2_apply_packedbit and, with `planes`,
//   gf2_encode_packedbit_resident: the one-shot lane in one launch.  A block
//   takes 32 or 64 word columns (1 or 2 KiB of each of the k chunks: a lane
//   holds one or two word columns, so that a step moves two words for
//   about the cost of one) and one warp a group.  The warps share the
//   (row, KiB) items: each copies its items into shared memory with 16-byte
//   asynchronous copies, then its part of the program, and as soon as its
//   own items have landed it turns them into plane words (lane i turns the
//   32 bytes of its word column into 8 plane words in registers: four 8x8
//   bit transposes and byte permutes) while the other warps' loads are
//   still arriving.  After a barrier each warp walks its group's
//   sub-program over the shared words, and after another they share the
//   output (chunk, word) items' packing back to bytes.
//   Bound: bytes, k*B read and out*B written (4 MiB + 1.5 MiB at the main
//   shape: 1.72 us), the same as apply_bytes_w8's.  A first version
//   transposed with warp ballots (__ballot_sync over bit x of 32 lanes'
//   bytes is one plane word): about one warp instruction a byte, against
//   about one per 10 bytes here.  The walk is K3's.
// * to_packedbit (K5) / from_packedbit (K6): the two transposes alone, one
//   word column a thread, from K4's device functions.  Bound: bytes, each
//   byte read once and written once in the other layout (2 * 4 MiB at the
//   main shape: 2.5 us).
// * to_packedbit_paged / from_packedbit_paged: K5 and K6 addressed through
//   a paged resident's page table (int64 addresses of its pages in the
//   store's sub-slabs, in order; a resident's words run through them
//   page_words a page, so a plane row may straddle two pages and the pages
//   lie anywhere in any sub-slab).  At the transposes' sizes one pass over
//   the bytes costs what a copy of them costs (PERF.md), so the gain is in
//   passes, not cycles: the paged K6 reads each plane word once from its
//   page and writes each byte once where the read wants it, either as
//   shard rows or, for an object read, already de-interleaved into the
//   object's stripe-major order with the object's tail cut off; this
//   replaces the gather of the pages into a fresh tensor, K6 and the
//   host's de-interleave.  The paged K5 writes an admit's plane words
//   straight into its pages and zeroes the last page's tail, in place of
//   K5 into a tensor, a zero-filled page image, a copy into it and the
//   install.  Bound: bytes, as K5 and K6.  A thread's eight plane words
//   lie row_words apart: one 32-bit division by page_words finds the
//   first's page (any page size the store takes), and the others' pages
//   follow by stepping, so their eight page addresses load at once.
//
// Every kernel masks its own ragged edge: pad columns read as zero and only
// the real columns are written, so nothing is padded on the host.

#include <cuda_runtime.h>

#include "packedbit.cuh"

namespace {

// The program as the kernels stage it: a header of int4 rows holding the
// groups' offsets (group g's steps are g's offset up to g + 1's, counted
// from the first step), the steps, and the PREFETCH + 1 steps the walk
// reads past its end.
__host__ __device__ inline int header_rows(int n_groups) {
  return (n_groups + 4) / 4;
}
__host__ __device__ inline int staged_rows(int n_instr, int n_groups) {
  return header_rows(n_groups) + n_instr + CTT_PB_PREFETCH + 1;
}
__host__ __device__ inline long long prog_bytes(int n_instr, int n_groups) {
  return 16LL * staged_rows(n_instr, n_groups);
}

__host__ inline long long max_ll(long long a, long long b) { return a > b ? a : b; }

bool aligned(const void* p, unsigned n) {
  return reinterpret_cast<uintptr_t>(p) % n == 0;
}

__device__ __forceinline__ uint4 vxor(uint4 a, uint4 b) {
  return make_uint4(a.x ^ b.x, a.y ^ b.y, a.z ^ b.z, a.w ^ b.w);
}
__device__ __forceinline__ uint32_t vxor(uint32_t a, uint32_t b) { return a ^ b; }
__device__ __forceinline__ uint8_t vxor(uint8_t a, uint8_t b) {
  return static_cast<uint8_t>(a ^ b);
}

template <typename V>
__device__ __forceinline__ V vzero() { return V(0); }
template <>
__device__ __forceinline__ uint4 vzero<uint4>() { return make_uint4(0, 0, 0, 0); }
template <>
__device__ __forceinline__ uint2 vzero<uint2>() { return make_uint2(0, 0); }
__device__ __forceinline__ uint2 vxor(uint2 a, uint2 b) {
  return make_uint2(a.x ^ b.x, a.y ^ b.y);
}

// Word i of a value of one or two words.
__device__ __forceinline__ uint32_t word(uint32_t v, int) { return v; }
__device__ __forceinline__ uint32_t word(uint2 v, int i) { return i ? v.y : v.x; }

// Asynchronous 16- and 4-byte copies from device to shared memory, so that
// every row of a block's loads is in flight at once (cp.async.wait_all, then
// a barrier, before the data is read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's most recent copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy the program (header, steps and padding: `rows` int4) into shared
// memory with 16-byte asynchronous copies (the caller waits for them and
// syncs).
__device__ __forceinline__ void stage_program(const int4* __restrict__ prog,
                                              int rows, int4* sprog) {
  for (int i = threadIdx.x; i < rows; i += blockDim.x)
    cp_async16(sprog + i, prog + i);
}

template <typename V>
__device__ __forceinline__ V& at(unsigned char* col, int offset) {
  return *reinterpret_cast<V*>(col + offset);
}

// Walk one sub-program of n steps over this lane's column of values (`col`
// points at the lane's element of value 0; an instruction's a, b and d are
// byte offsets from it), handing each finished output row to
// store(row, value).  Only the lane's own column is touched, and the
// values other warps read (the inputs) are not written, so no barrier is
// needed inside.  The operands of step p + PREFETCH are loaded before step
// p stores its result (the host's schedule never lets a step read what the
// PREFETCH steps before it write), so that a step's loads have PREFETCH
// steps to land in, and the instruction after that is read meanwhile; the
// list holds PREFETCH + 1 steps past every group's end for that.  Every
// step takes the same path: value[d] = value[a] ^ value[b], folded into
// the accumulator too; an output step's d is -1, and its store is skipped
// (predicated, so the warp does not branch), which spares shared-memory
// bandwidth.
template <typename V, typename Store>
__device__ __forceinline__ void run_program(const int4* sprog, int n,
                                            unsigned char* col, Store store) {
  static_assert(CTT_PB_PREFETCH == 1, "the walk keeps one step in flight");
  if (n <= 0) return;
  int4 cur = sprog[0], nxt = sprog[1];
  V xa = at<V>(col, cur.x), xb = at<V>(col, cur.y);
  V acc = vzero<V>();
#pragma unroll 4
  for (int p = 0; p < n; ++p) {
    const int4 after = sprog[p + 2];
    const V ya = at<V>(col, nxt.x), yb = at<V>(col, nxt.y);
    const V x = vxor(xa, xb);
    if (cur.z >= 0) at<V>(col, cur.z) = x;  // output steps store no temp
    acc = (cur.w & CTT_PB_FIRST) ? x : vxor(acc, x);
    if (cur.w & CTT_PB_LAST) store(cur.w >> 2, acc);
    xa = ya;
    xb = yb;
    cur = nxt;
    nxt = after;
  }
}

// After staging: run_program over this warp's group of the staged program.
template <typename V, typename Store>
__device__ __forceinline__ void run_group(const int4* sprog, int n_groups,
                                          int group, unsigned char* col,
                                          Store store) {
  const int* off = reinterpret_cast<const int*>(sprog);
  const int first = off[group];
  run_program<V>(sprog + header_rows(n_groups) + first,
                 off[group + 1] - first, col, store);
}

// Columns [c, c + 1024) of one row of B bytes into shared memory at dst,
// zeros past B, by the 32 lanes of one warp.  vec16: the row and B are
// multiples of 16 (16-byte asynchronous copies; the caller waits for them
// and syncs the warp).
__device__ __forceinline__ void load_item(const uint8_t* __restrict__ row,
                                          long long B, long long c,
                                          uint8_t* dst, int lane,
                                          bool vec16) {
  if (vec16) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int v = lane + 32 * q;
      const long long g = c + 16LL * v;
      uint4* d = reinterpret_cast<uint4*>(dst) + v;
      if (g < B)
        cp_async16(d, row + g);
      else
        *d = make_uint4(0, 0, 0, 0);
    }
  } else {
    for (int q = lane; q < 1024; q += 32)
      dst[q] = c + q < B ? __ldg(row + c + q) : uint8_t(0);
  }
}

// 8x8 bit transpose of the eight bytes lo (bytes 0-3) and hi (bytes 4-7):
// bit x of byte b moves to bit b of byte x.  Three rounds swap the
// off-diagonal 1x1, 2x2 and 4x4 blocks (shifts 7, 14 and 28 of the 64-bit
// word; the last round crosses the two halves).
__device__ __forceinline__ void transpose8(uint32_t& lo, uint32_t& hi) {
  uint32_t t;
  t = (lo ^ (lo >> 7)) & 0x00AA00AAu;
  lo ^= t ^ (t << 7);
  t = (hi ^ (hi >> 7)) & 0x00AA00AAu;
  hi ^= t ^ (t << 7);
  t = (lo ^ (lo >> 14)) & 0x0000CCCCu;
  lo ^= t ^ (t << 14);
  t = (hi ^ (hi >> 14)) & 0x0000CCCCu;
  hi ^= t ^ (t << 14);
  t = (lo ^ (hi << 4)) & 0xF0F0F0F0u;
  lo ^= t;
  hi ^= t >> 4;
}

// Byte x of each of s0..s3, in that order, as one word.
__device__ __forceinline__ uint32_t gather4(uint32_t s0, uint32_t s1,
                                            uint32_t s2, uint32_t s3, int x) {
  const uint32_t sel = x | ((x + 4) << 4);
  return __byte_perm(__byte_perm(s0, s1, sel), __byte_perm(s2, s3, sel),
                     0x5410);
}

// The 32 bytes of one word column of one row (v: eight little-endian words,
// column c in byte c) -> its 8 plane words (w[x]: bit x of byte c in bit c).
// Each group of 8 bytes is transposed in registers, and byte x of the four
// groups' results is plane x's word.  A thread does this for its own column:
// no other lane and no shared memory take part.
__device__ __forceinline__ void bytes_to_words(const uint32_t v[8],
                                               uint32_t w[8]) {
  uint32_t lo[4], hi[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    lo[g] = v[2 * g];
    hi[g] = v[2 * g + 1];
    transpose8(lo[g], hi[g]);
  }
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    w[x] = gather4(lo[0], lo[1], lo[2], lo[3], x);
    w[x + 4] = gather4(hi[0], hi[1], hi[2], hi[3], x);
  }
}

// The inverse: 8 plane words -> the 32 bytes of their column, as eight
// little-endian words.
__device__ __forceinline__ void words_to_bytes(const uint32_t w[8],
                                               uint32_t v[8]) {
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    uint32_t lo = gather4(w[0], w[1], w[2], w[3], g);
    uint32_t hi = gather4(w[4], w[5], w[6], w[7], g);
    transpose8(lo, hi);
    v[2 * g] = lo;
    v[2 * g + 1] = hi;
  }
}

// Columns col..col+31 of one row of B bytes, zeros past B.  vec16: the row
// base and B are multiples of 16 (two 16-byte loads for a whole column).
__device__ __forceinline__ void load32(const uint8_t* __restrict__ row,
                                       long long col, long long B, bool vec16,
                                       uint32_t v[8]) {
  if (vec16 && col + 32 <= B) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(row + col));
    const uint4 b = __ldg(reinterpret_cast<const uint4*>(row + col + 16));
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    return;
  }
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    uint32_t word = 0;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const long long g = col + 4 * q + c;
      if (g < B) word |= static_cast<uint32_t>(__ldg(row + g)) << (8 * c);
    }
    v[q] = word;
  }
}

// Eight plane words of one word column (wx[x] = plane x) -> the 32 bytes of
// columns col..col+31 of one output row of B bytes; only columns below B
// are written.  vec16: the row base and B are multiples of 16.
__device__ __forceinline__ void pack_store(const uint32_t wx[8], uint8_t* row,
                                           long long col, long long B,
                                           bool vec16) {
  uint32_t u[8];
  words_to_bytes(wx, u);
  if (vec16 && col + 32 <= B) {
    uint4* d = reinterpret_cast<uint4*>(row + col);
    d[0] = make_uint4(u[0], u[1], u[2], u[3]);
    d[1] = make_uint4(u[4], u[5], u[6], u[7]);
  } else {
#pragma unroll
    for (int c = 0; c < 32; ++c)
      if (col + c < B) row[col + c] = static_cast<uint8_t>(u[c >> 2] >> (8 * (c & 3)));
  }
}

// ---------------------------------------------------------------- K3 --

// One block: 32 columns, blockDim.x / 32 groups, warp g walking group g.
template <typename V>
__global__ void __launch_bounds__(32 * CTT_PB_MAX_GROUPS)
xor_schedule_kernel(const int4* __restrict__ prog, int n_instr, int C,
                    int n_vals, const V* __restrict__ in, V* __restrict__ out,
                    long long E) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, group = threadIdx.x >> 5;
  const int G = blockDim.x >> 5;
  int4* sprog = reinterpret_cast<int4*>(smem);
  V* vals = reinterpret_cast<V*>(smem + prog_bytes(n_instr, G));
  const long long e = (long long)blockIdx.x * 32 + lane;
  const bool live = e < E;
  // the data rows first, so that they are in flight while the program is
  // staged; each warp loads every G-th row
#pragma unroll 4
  for (int r = group; r < C; r += G) {
    if (!live) {
      vals[r * 32 + lane] = vzero<V>();
    } else if constexpr (sizeof(V) == 16) {
      cp_async16(&vals[r * 32 + lane], &in[r * E + e]);
    } else if constexpr (sizeof(V) == 4) {
      cp_async4(&vals[r * 32 + lane], &in[r * E + e]);
    } else {
      vals[r * 32 + lane] = in[r * E + e];
    }
  }
  stage_program(prog, staged_rows(n_instr, G), sprog);
  if (group == 0) vals[(n_vals - 2) * 32 + lane] = vzero<V>();  // ZERO
  cp_async_wait_all();
  __syncthreads();
  V* mine = out + e;
  run_group<V>(sprog, G, group, reinterpret_cast<unsigned char*>(vals + lane),
               [&](int row, V v) {
                 if (live) mine[row * E] = v;
               });
}

template <typename V>
cudaError_t launch_xor_schedule(const int4* prog, int n_instr, int n_groups,
                                int C, int n_vals, const void* in, void* out,
                                long long E, size_t smem,
                                cudaStream_t stream) {
  auto kernel = xor_schedule_kernel<V>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (E + 31) / 32;
  kernel<<<(unsigned)blocks, 32 * n_groups, smem, stream>>>(
      prog, n_instr, C, n_vals, static_cast<const V*>(in),
      static_cast<V*>(out), E);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- K4 --

// One block: 32 * NW word columns (1024 * NW bytes of each chunk) and
// blockDim.x / 32 groups, warp g walking group g.  Lane i holds word
// columns i and, with NW = 2, i + 32 of the block in one V of NW words, so
// that a step moves NW words for about the cost of one.
template <typename V>
__global__ void __launch_bounds__(32 * CTT_PB_MAX_GROUPS)
apply_packedbit_kernel(const int4* __restrict__ prog, int n_instr, int k,
                       int out_rows, int n_vals,
                       const uint8_t* __restrict__ data, long long B,
                       uint8_t* __restrict__ out,
                       uint32_t* __restrict__ planes, bool vec16_in,
                       bool vec16_out) {
  constexpr int NW = sizeof(V) / 4;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, group = threadIdx.x >> 5;
  const int G = blockDim.x >> 5;
  const int C = k * 8;
  const int width = 1024 * NW;
  int4* sprog = reinterpret_cast<int4*>(smem);
  V* vals = reinterpret_cast<V*>(smem + prog_bytes(n_instr, G));
  // the byte tile is dead once transposed; the output words reuse its room
  uint8_t* tile = reinterpret_cast<uint8_t*>(vals + (long long)n_vals * 32);
  V* outw = reinterpret_cast<V*>(tile);
  const long long W = (B + 31) / 32;
  const long long c0 = (long long)blockIdx.x * width;
  const long long w0 = (long long)blockIdx.x * 32 * NW + lane;
  // The warps share the (row, word) items: a warp loads each of its items
  // (1024 bytes of one row), then the program, and waits for its own items
  // only, so that its transposes overlap the other warps' loads; lane i
  // turns its own 32 columns of an item into 8 plane words.
  for (int t = group; t < k * NW; t += G) {
    const int j = t / NW, i = t % NW;
    load_item(data + j * B, B, c0 + 1024 * i,
              tile + (long long)j * width + 1024 * i, lane, vec16_in);
  }
  cp_async_commit();
  stage_program(prog, staged_rows(n_instr, G), sprog);
  cp_async_commit();
  cp_async_wait_group<1>();  // this thread's items, not the program
  __syncwarp();
  uint32_t* words = reinterpret_cast<uint32_t*>(vals + lane);
  for (int t = group; t < k * NW; t += G) {
    const int j = t / NW, i = t % NW;
    const uint4* src = reinterpret_cast<const uint4*>(
        tile + (long long)j * width + 1024 * i + 32 * lane);
    const uint4 a = src[0], b = src[1];
    const uint32_t v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    uint32_t wx[8];
    bytes_to_words(v, wx);
#pragma unroll
    for (int x = 0; x < 8; ++x) {
      words[(j * 8 + x) * 32 * NW + i] = wx[x];  // word i of value j*8+x
      if (planes != nullptr && w0 + 32 * i < W)
        planes[(j * 8 + x) * W + w0 + 32 * i] = wx[x];
    }
  }
  cp_async_wait_all();
  if (group == 0) vals[(n_vals - 2) * 32 + lane] = vzero<V>();  // ZERO
  __syncthreads();  // every row transposed; the output words reuse the tile
  V* mine = outw + lane;
  uint32_t* resident = planes == nullptr ? nullptr : planes + C * W + w0;
  run_group<V>(sprog, G, group, reinterpret_cast<unsigned char*>(vals + lane),
               [&](int row, V v) {
                 mine[row * 32] = v;
                 if (resident != nullptr) {
#pragma unroll
                   for (int i = 0; i < NW; ++i)
                     if (w0 + 32 * i < W) resident[row * W + 32 * i] = word(v, i);
                 }
               });
  __syncthreads();  // a chunk's 8 rows may come from several groups
  // the warps share the (chunk, word) pairs: lane i packs word column
  // w0 + 32 * word of one output chunk back to its 32 bytes
  const uint32_t* outs = reinterpret_cast<const uint32_t*>(outw);
  for (int t = group; t < out_rows * NW; t += G) {
    const int o = t / NW, i = t % NW;
    if (w0 + 32 * i >= W) continue;
    uint32_t wx[8];
#pragma unroll
    for (int x = 0; x < 8; ++x) wx[x] = outs[((o * 8 + x) * 32 + lane) * NW + i];
    pack_store(wx, out + o * B, 32 * (w0 + 32 * i), B, vec16_out);
  }
}

template <typename V>
cudaError_t launch_apply_packedbit(const int4* prog, int n_instr,
                                   int n_groups, int k, int out_rows,
                                   int n_vals, const uint8_t* data,
                                   long long B, uint8_t* out,
                                   uint32_t* planes, size_t smem,
                                   cudaStream_t stream) {
  auto kernel = apply_packedbit_kernel<V>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long W = (B + 31) / 32;
  const long long cols = 32LL * (sizeof(V) / 4);
  kernel<<<(unsigned)((W + cols - 1) / cols), 32 * n_groups, smem, stream>>>(
      prog, n_instr, k, out_rows, n_vals, data, B, out, planes,
      aligned(data, 16) && B % 16 == 0, aligned(out, 16) && B % 16 == 0);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- K5 --

__global__ void to_packedbit_kernel(const uint8_t* __restrict__ data,
                                    long long B, uint32_t* __restrict__ planes,
                                    bool vec16) {
  const long long w = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long W = (B + 31) / 32;
  const int j = blockIdx.y;
  if (w >= W) return;
  uint32_t v[8], wx[8];
  load32(data + j * B, 32 * w, B, vec16, v);
  bytes_to_words(v, wx);
#pragma unroll
  for (int x = 0; x < 8; ++x) planes[((long long)j * 8 + x) * W + w] = wx[x];
}

// ---------------------------------------------------------------- K6 --

__global__ void from_packedbit_kernel(const uint32_t* __restrict__ planes,
                                      long long W, uint8_t* __restrict__ out,
                                      bool vec16) {
  const long long w = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int o = blockIdx.y;
  if (w >= W) return;
  uint32_t wx[8];
#pragma unroll
  for (int x = 0; x < 8; ++x) wx[x] = __ldg(planes + ((long long)o * 8 + x) * W + w);
  pack_store(wx, out + (long long)o * 32 * W, 32 * w, 32 * W, vec16);
}

// ------------------------------------------------------ paged K5/K6 --

// Word `flat` of a paged resident whose pages start at addr[0], addr[1], ...
__device__ __forceinline__ uint32_t* page_word(const long long* __restrict__ addr,
                                               unsigned flat, unsigned page_words) {
  const unsigned p = flat / page_words;
  return reinterpret_cast<uint32_t*>(__ldg(addr + p)) + (flat - p * page_words);
}

// Words flat, flat + step, ..., flat + 7 * step of a paged resident (one
// word column of eight plane rows): one division for the first, then
// each page and offset by stepping, so that the eight page addresses are
// known before any word is loaded.
__device__ __forceinline__ void plane_words(const long long* __restrict__ addr,
                                            unsigned flat, unsigned step,
                                            unsigned page_words,
                                            uint32_t* at[8]) {
  unsigned p = flat / page_words, off = flat - p * page_words;
  const unsigned q = step / page_words, r = step - q * page_words;
#pragma unroll
  for (int x = 0; x < 8; ++x) {
    at[x] = reinterpret_cast<uint32_t*>(__ldg(addr + p)) + off;
    p += q;
    off += r;
    if (off >= page_words) {
      off -= page_words;
      ++p;
    }
  }
}

// The first n (at most 32) of the 32 bytes in u (eight little-endian words)
// to dst; vec16: dst is a multiple of 16, so 32 bytes go as two 16-byte
// stores.
__device__ __forceinline__ void store_bytes(const uint32_t u[8], uint8_t* dst,
                                            int n, bool vec16) {
  if (vec16 && n == 32) {
    uint4* d = reinterpret_cast<uint4*>(dst);
    d[0] = make_uint4(u[0], u[1], u[2], u[3]);
    d[1] = make_uint4(u[4], u[5], u[6], u[7]);
    return;
  }
#pragma unroll
  for (int c = 0; c < 32; ++c)  // unrolled, so that u stays in registers
    if (c < n) dst[c] = static_cast<uint8_t>(u[c >> 2] >> (8 * (c & 3)));
}

// Thread (w, o): plane rows o*8 .. o*8+7 of the resident, starting at its
// word w0, row_words words a row; word column w -> bytes 32w .. 32w+31 of
// output row o, of which the first L are real.  rows: out is [out_rows, L].
// object (cs > 0): byte c of row o goes to (c / cs) * out_rows * cs +
// o * cs + c % cs, and only below `limit` (the object's size).  Where cs is
// a multiple of 32 a thread's 32 bytes stay in one chunk and go as one run
// (two 16-byte stores where aligned); else byte by byte.
__global__ void from_packedbit_paged_kernel(const long long* __restrict__ addr,
                                            unsigned page_words, unsigned w0,
                                            unsigned row_words, int L, int cs,
                                            long long limit,
                                            uint8_t* __restrict__ out,
                                            bool vec16) {
  const unsigned w = blockIdx.x * blockDim.x + threadIdx.x;
  const int o = blockIdx.y;
  if (w >= (unsigned)(L + 31) / 32) return;
  uint32_t* at[8];
  plane_words(addr, w0 + (unsigned)o * 8u * row_words + w, row_words,
              page_words, at);
  uint32_t wx[8], u[8];
#pragma unroll
  for (int x = 0; x < 8; ++x) wx[x] = __ldg(at[x]);
  words_to_bytes(wx, u);
  const unsigned c = 32u * w;
  const int real = min(32, L - (int)c);
  if (cs == 0) {
    store_bytes(u, out + (long long)o * L + c, real, vec16);
    return;
  }
  const long long K = gridDim.y;
  if (cs % 32 == 0) {
    const long long dst = (long long)(c / cs) * K * cs + (long long)o * cs + c % cs;
    const long long n = min((long long)real, limit - dst);
    if (n > 0) store_bytes(u, out + dst, (int)n, vec16);
    return;
  }
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const unsigned cc = c + j;
    const long long dst = (long long)(cc / cs) * K * cs + (long long)o * cs + cc % cs;
    if (j < real && dst < limit) out[dst] = static_cast<uint8_t>(u[j >> 2] >> (8 * (j & 3)));
  }
}

// Thread (w, j), j < n: the 32 bytes of word column w of row j -> its 8
// plane words, into words (j*8+x)*W + w of the resident's pages.  Row
// j = n (one more row of blocks): zeros into words total .. end-1, the last
// page's tail.
__global__ void to_packedbit_paged_kernel(const uint8_t* __restrict__ data,
                                          long long B,
                                          const long long* __restrict__ addr,
                                          unsigned page_words, unsigned total,
                                          unsigned end, bool vec16) {
  const unsigned w = blockIdx.x * blockDim.x + threadIdx.x;
  const unsigned j = blockIdx.y;
  const unsigned W = (unsigned)((B + 31) / 32);
  if (j == gridDim.y - 1) {
    for (unsigned t = total + w; t < end; t += gridDim.x * blockDim.x)
      *page_word(addr, t, page_words) = 0;
    return;
  }
  if (w >= W) return;
  uint32_t v[8], wx[8], *at[8];
  load32(data + j * B, 32LL * w, B, vec16, v);
  plane_words(addr, j * 8 * W + w, W, page_words, at);
  bytes_to_words(v, wx);
#pragma unroll
  for (int x = 0; x < 8; ++x) *at[x] = wx[x];
}

bool valid_threads(int threads) {
  return threads >= 32 && threads <= 1024 && threads % 32 == 0;
}

}  // namespace

extern "C" int ctt_xor_schedule(const int32_t* prog, int n_instr,
                                int n_groups, int C, int n_vals,
                                const void* in, void* out,
                                long long row_bytes, int vec, void* stream) {
  if (n_instr < 1 || n_groups < 1 || n_groups > CTT_PB_MAX_GROUPS || C < 1 ||
      n_vals < C + 2 || (vec != 16 && vec != 4 && vec != 1) ||
      row_bytes % vec != 0 || !aligned(in, vec) || !aligned(out, vec) ||
      !aligned(prog, 16))
    return cudaErrorInvalidValue;
  const long long smem = prog_bytes(n_instr, n_groups) +
                         (long long)n_vals * 32 * vec;
  if (smem > CTT_PB_MAX_SMEM) return cudaErrorInvalidValue;
  const long long E = row_bytes / vec;
  if (E == 0) return cudaSuccess;
  const int4* p = reinterpret_cast<const int4*>(prog);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == 16)
    return launch_xor_schedule<uint4>(p, n_instr, n_groups, C, n_vals, in,
                                      out, E, smem, s);
  if (vec == 4)
    return launch_xor_schedule<uint32_t>(p, n_instr, n_groups, C, n_vals, in,
                                         out, E, smem, s);
  return launch_xor_schedule<uint8_t>(p, n_instr, n_groups, C, n_vals, in,
                                      out, E, smem, s);
}

extern "C" int ctt_apply_packedbit(const int32_t* prog, int n_instr,
                                   int n_groups, int k, int out_rows,
                                   int n_vals, const uint8_t* data,
                                   long long B, uint8_t* out,
                                   uint32_t* planes, int words,
                                   void* stream) {
  if (n_instr < 1 || n_groups < 1 || n_groups > CTT_PB_MAX_GROUPS || k < 1 ||
      out_rows < 1 || n_vals < k * 8 + 2 || B < 1 ||
      (words != 1 && words != 2) || !aligned(prog, 16) ||
      (planes != nullptr && !aligned(planes, 4)))
    return cudaErrorInvalidValue;
  const long long smem = prog_bytes(n_instr, n_groups) +
                         (long long)n_vals * 32 * 4 * words +
                         max_ll(k, out_rows) * 1024 * words;
  if (smem > CTT_PB_MAX_SMEM) return cudaErrorInvalidValue;
  const int4* p = reinterpret_cast<const int4*>(prog);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (words == 2)
    return launch_apply_packedbit<uint2>(p, n_instr, n_groups, k, out_rows,
                                         n_vals, data, B, out, planes, smem, s);
  return launch_apply_packedbit<uint32_t>(p, n_instr, n_groups, k, out_rows,
                                          n_vals, data, B, out, planes, smem,
                                          s);
}

extern "C" int ctt_to_packedbit(const uint8_t* data, int n, long long B,
                                uint32_t* planes, int threads, void* stream) {
  if (!valid_threads(threads) || n < 1 || n > 65535 || B < 1 ||
      !aligned(planes, 4))
    return cudaErrorInvalidValue;
  const long long W = (B + 31) / 32;
  const dim3 grid((unsigned)((W + threads - 1) / threads), (unsigned)n);
  to_packedbit_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      data, B, planes, aligned(data, 16) && B % 16 == 0);
  return cudaGetLastError();
}

extern "C" int ctt_from_packedbit(const uint32_t* planes, int rows,
                                  long long W, uint8_t* out, int threads,
                                  void* stream) {
  if (!valid_threads(threads) || rows < 1 || rows > 65535 || W < 1 ||
      !aligned(planes, 4))
    return cudaErrorInvalidValue;
  const dim3 grid((unsigned)((W + threads - 1) / threads), (unsigned)rows);
  from_packedbit_kernel<<<grid, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      planes, W, out, aligned(out, 16));
  return cudaGetLastError();
}

extern "C" int ctt_from_packedbit_paged(const long long* addr, int n_pages,
                                        long long page_words, long long w0,
                                        long long row_words, int out_rows,
                                        long long L, long long cs,
                                        long long limit, uint8_t* out,
                                        int threads, void* stream) {
  const long long words = w0 + 8LL * out_rows * row_words;
  if (!valid_threads(threads) || n_pages < 1 || page_words < 1 || w0 < 0 ||
      row_words < 1 || out_rows < 1 || out_rows > 65535 || L < 1 ||
      L > 32 * row_words || words > (long long)n_pages * page_words ||
      (long long)n_pages * page_words > 0x7fffffffLL || cs < 0 ||
      (cs > 0 && L % cs != 0) || !aligned(addr, 8))
    return cudaErrorInvalidValue;
  const bool vec16 = aligned(out, 16) && (cs > 0 ? cs % 16 == 0 : L % 16 == 0);
  const dim3 grid((unsigned)((L + 32LL * threads - 1) / (32LL * threads)),
                  (unsigned)out_rows);
  from_packedbit_paged_kernel<<<grid, threads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      addr, (unsigned)page_words, (unsigned)w0, (unsigned)row_words, (int)L,
      (int)cs, cs > 0 ? limit : 0, out, vec16);
  return cudaGetLastError();
}

extern "C" int ctt_to_packedbit_paged(const uint8_t* data, int n, long long B,
                                      const long long* addr, int n_pages,
                                      long long page_words, int threads,
                                      void* stream) {
  const long long W = (B + 31) / 32;
  const long long total = 8LL * n * W, end = (long long)n_pages * page_words;
  if (!valid_threads(threads) || n < 1 || n > 65534 || B < 1 ||
      page_words < 1 || n_pages < 1 || total > end ||
      end - total >= page_words || end > 0x7fffffffLL || !aligned(addr, 8))
    return cudaErrorInvalidValue;
  const dim3 grid((unsigned)((W + threads - 1) / threads), (unsigned)n + 1);
  to_packedbit_paged_kernel<<<grid, threads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      data, B, addr, (unsigned)page_words, (unsigned)total, (unsigned)end,
      aligned(data, 16) && B % 16 == 0);
  return cudaGetLastError();
}

extern "C" const char* ctt_pb_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
