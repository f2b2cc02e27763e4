// The two bit-plane GF(2) kernels of the erasure-code data path, written for
// Hopper (sm_90a).  Built by ceph_tpu_torch/ops/build.py with nvcc into a shared
// library with a plain C interface (gf2.cuh); bound by ops/cuda_gf2.py.
//
// apply_bytes_w8 replaces pallas_apply_bytes_w8 (ceph_tpu/ops/pallas_gf2.py,
// kernel _apply_bytes_w8_kernel).  It applies an [out*8, k*8] bit-matrix to
// [k, B] data bytes in one pass: no bit-plane ever reaches device memory.
//   Bit-row j*8+x of a column is bit x of chunk j's byte, so a column's k bytes,
//   packed little-endian, ARE its bit vector: the gather is byte moves, no bit
//   transpose.  Output bit x of parity chunk o is the parity of
//   (mask[o*8+x] & vector); eight of them pack into one parity byte.
//   Bound: bytes.  It must read k*B and write out*B bytes ((k+m)*B, 23 MB at
//   k=8 m=3 and B = 2 MiB, 6.9 us at the H100 SXM's 3.35 TB/s).  A device
//   copy of the same bytes, timed the same way, takes about twice that
//   (chip_smoke.py's floor line), so the floor is launch and latency, not work.
//   Two routes, chosen by k1_route from the shape and the alignment alone:
//   * xor (k <= 16, out <= 4, B and the three addresses multiples of 16: every
//     reed_sol_van k=8 m=3 encode, decode and recovery), popcount-free.  The
//     product is linear over GF(2), so a parity byte is the XOR over chunks j
//     and 3-bit fields g of each data byte of the block (o, j) of the
//     bit-matrix applied to that field alone: an
//     8-entry byte table per (o, j, g), built once per block in shared memory
//     from 64-bit loads of the bit-matrix, and looked up for four columns at
//     once by one prmt whose selector nibbles are the four fields.  At k=8 m=3
//     that is about 52 integer operations a column (24 prmt lookups and the
//     selectors and XORs around them), against the popc route's 24 popcounts
//     at a quarter of the integer rate plus about 100 other operations.  Each
//     thread takes 16 columns with one 16-byte load per data row and one
//     16-byte store per parity row, the first group's loads issued before the
//     tables are built.  What bounds it on an H100 80GB HBM3 at 700 W: the
//     launch and load latency a copy of the same bytes also pays, plus the
//     integer work, which the single wave of loads barely overlaps (PERF.md:
//     about 18 us at B = 2 MiB against the copy's 14 us and the popc route's
//     24 us).  Binary tensor-core products (mma m16n8k128 b1 AND-popc) were
//     exact but ran within 5% of the popc route on that card, and deeper load
//     pipelines (register double buffers, cp.async stages, smaller rounds)
//     and fewer selector operations measured no faster.
//   * popc (any other shape: k > 16, out > 4, ragged B or a misaligned base),
//     the first port's kernel:
//     each thread takes four adjacent columns with one 32-bit load per data row
//     and one 32-bit store per parity row; per column it issues out*8
//     popcounts, at 16 per clock per SM, plus a few logic operations each, so
//     instruction issue bounds it (about 29% of the byte bound at B = 2 MiB on
//     an H100 80GB HBM3 at 700 W, PERF.md).
//   The popc route has a byte-load variant for ragged B or a misaligned base;
//   there is no padding to a tile multiple.
//
// gf2_matmul replaces pallas_gf2_matmul (same file, kernel _gf2_matmul_kernel):
// (M[R, C] @ bits[C, B]) & 1 on int8 bit-planes, the lane of the w=16 and w=4
// byte layouts and of the packet-layout codes (cauchy, liberation, blaum_roth,
// liber8tion).
//   Bound: bytes, (C + R) * B of 8x-expanded int8 planes, one read of bits
//   and one write of the result (13.8 us at [24,64] x [64, 524288] at the
//   H100 SXM's 3.35 TB/s).  Two routes, chosen by k2_route from the shape
//   and the alignment alone:
//   * mma (R <= 64, C <= 128, B and the bits and out addresses multiples of
//     16: the main path's cauchy_good k=8 m=3 encode, decode and parity
//     re-encode, and the w=16 byte layout at k=8 m=3).  The first port's kernel kept one group of eight
//     row loads in flight per thread and then computed, so DRAM latency and
//     popcount issue (R popcounts a column) added up.  Here persistent
//     blocks keep the loads in flight apart from the arithmetic: two
//     producer warps fill a ring of 256-column stages in shared memory with
//     bulk asynchronous copies (cp.async.bulk, one per row segment,
//     completion on mbarriers) while eight consumer warps compute
//     (M @ bits) & 1 on int8 tensor cores (mma.sync m16n8k32 s8), about one
//     instruction per 8 columns, 16 output rows and 32 input rows, whatever
//     R and C are.  What bounds it on an H100 80GB HBM3 at 700 W: the rate
//     at which a warp issues bulk copies (one producer warp per block ran
//     the w=16 shape no faster than the first kernel), and the launch and
//     DRAM ramp a device copy of the same bytes also pays.  Measured
//     (PERF.md): 25-26 us at the main shape against the first kernel's 37
//     and a copy's 22; 74-75 us at B = 2 MiB against 90 and 67.
//   * popc (any other shape), the first port's kernel: the popcount-parity
//     core over C input rows.  Eight rows' 32-bit loads are masked to their
//     low bits (0x01010101) and shifted into one word whose byte c holds
//     column c's eight bits, so a column's vector is built four columns at
//     a time.  Each thread keeps only one group of eight row loads in
//     flight, so it is bound by memory latency more than by bandwidth.
//
// All: the bit-matrix is an operand (encode, decode and recovery share one
// kernel), the grid strides over column groups, and each launch checks its own
// arguments.  The popc routes build row masks per block in shared memory,
// the xor route its lookup tables, the mma route its A fragments.

#include <cuda_runtime.h>

#include "gf2.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;  // 8 x 256 threads fills an SM's 2048 slots

// ------------------------------------------------------- K1, xor route -----

constexpr int kXorMaxK = 16;
constexpr int kXorMaxOut = 4;
constexpr int kXorThreads = 128;
constexpr int kXorBlocksPerSm = 6;  // 6 x 128 threads at <= 85 registers
constexpr int kXorCols = 16;        // a thread's columns: one 16-byte load a row

// prmt.b32 in its default mode: byte n of the result is byte sel.nibble[n]
// of the pair {b, a}.  A table lookup here: {b, a} holds 8 one-byte entries.
__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(sel));
  return r;
}

__device__ __forceinline__ uint32_t word_of(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// The prmt selector of one field (the bits of m, at most 3) of each byte of
// x: its nibbles hold the field of columns 0, 2, 1, 3, so every lookup
// returns its four columns in that order.
__device__ __forceinline__ uint32_t field_selector(uint32_t x, uint32_t m) {
  const uint32_t v = x & m;
  return v | (v >> 12);
}

// Data rows j0..j0+7 (zero past row k), columns col0..col0+15 (zero past B,
// which is a multiple of 16 on this route).
__device__ __forceinline__ void xor_load(uint4 (&v)[8],
                                         const uint8_t* __restrict__ data,
                                         int j0, int k, long long B,
                                         long long col0) {
#pragma unroll
  for (int r = 0; r < 8; ++r)
    v[r] = j0 + r < k && col0 < B
               ? __ldg(reinterpret_cast<const uint4*>(
                     data + (long long)(j0 + r) * B + col0))
               : make_uint4(0, 0, 0, 0);
}

// table[o][j][g]: the 8x8 block (o, j) of the bit-matrix applied to every
// value of field g of a data byte (bits 0-2, 3-5, 6-7), as 8 one-byte entries.
// One thread per block reads its eight rows with one 64-bit load each and
// gathers the low bit of each int8, so byte b of u is the block's column b
// (bit x = mbits[o*8+x, j*8+b] & 1); an entry is the XOR of its field's
// columns.
__device__ __forceinline__ void xor_load_tables(
    const int8_t* __restrict__ mbits, int k, int out_rows,
    uint2 (*table)[kXorMaxK][3]) {
  for (int i = threadIdx.x; i < out_rows * k; i += blockDim.x) {
    const int o = i / k, j = i % k;
    unsigned long long u = 0;
#pragma unroll
    for (int x = 0; x < 8; ++x) {
      const unsigned long long v = __ldg(reinterpret_cast<const unsigned long long*>(
          mbits + (long long)(o * 8 + x) * k * 8 + j * 8));
      u |= (v & 0x0101010101010101ull) << x;
    }
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      uint32_t half[2] = {0, 0};
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        uint32_t v = 0;
#pragma unroll
        for (int i = 0; i < 3; ++i)
          if (3 * g + i < 8 && ((e >> i) & 1))
            v ^= static_cast<uint32_t>(u >> (8 * (3 * g + i))) & 0xffu;
        half[e >> 2] |= v << (8 * (e & 3));
      }
      table[o][j][g] = make_uint2(half[0], half[1]);
    }
  }
}

// Parity byte o of four columns, held in one word, is the XOR over chunks j
// and fields g of table[o][j][g] looked up at that field of chunk j's bytes:
// three selectors a chunk word (shared by every o), then one prmt and about
// one LOP3 a lookup.  No popcount.
template <int OUT>
__global__ void __launch_bounds__(kXorThreads, kXorBlocksPerSm)
apply_bytes_w8_xor_kernel(const int8_t* __restrict__ mbits,
                          const uint8_t* __restrict__ data,
                          uint8_t* __restrict__ out, int k, long long B) {
  __shared__ __align__(16) uint2 table[kXorMaxOut][kXorMaxK][3];
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long groups = (B + kXorCols - 1) / kXorCols;
  long long grp = (long long)blockIdx.x * blockDim.x + threadIdx.x;

  uint4 d[8];  // the first group's loads go out before the tables are built
  xor_load(d, data, 0, k, B, grp * kXorCols);
  xor_load_tables(mbits, k, OUT, table);
  __syncthreads();

  for (; grp < groups; grp += stride) {
    const long long col0 = grp * kXorCols;
    uint32_t acc[OUT][4];  // columns 0, 2, 1, 3 of each word
#pragma unroll
    for (int o = 0; o < OUT; ++o)
#pragma unroll
      for (int w = 0; w < 4; ++w) acc[o][w] = 0;

    for (int j0 = 0; j0 < k; j0 += 8) {
      if (j0 > 0) xor_load(d, data, j0, k, B, col0);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        if (j0 + jj < k) {
          uint32_t sel[3][4];
#pragma unroll
          for (int w = 0; w < 4; ++w) {
            const uint32_t x = word_of(d[jj], w);
            sel[0][w] = field_selector(x, 0x07070707u);
            sel[1][w] = field_selector(x >> 3, 0x07070707u);
            sel[2][w] = field_selector(x >> 6, 0x03030303u);
          }
#pragma unroll
          for (int o = 0; o < OUT; ++o) {
            const uint2 t0 = table[o][j0 + jj][0], t1 = table[o][j0 + jj][1],
                        t2 = table[o][j0 + jj][2];
#pragma unroll
            for (int w = 0; w < 4; ++w)
              acc[o][w] ^= prmt(t0.x, t0.y, sel[0][w]) ^
                           prmt(t1.x, t1.y, sel[1][w]) ^
                           prmt(t2.x, t2.y, sel[2][w]);
          }
        }
      }
    }

    if (grp + stride < groups)  // the next group's loads go out before the stores
      xor_load(d, data, 0, k, B, (grp + stride) * kXorCols);
#pragma unroll
    for (int o = 0; o < OUT; ++o)
      *reinterpret_cast<uint4*>(out + (long long)o * B + col0) =
          make_uint4(prmt(acc[o][0], 0, 0x3120), prmt(acc[o][1], 0, 0x3120),
                     prmt(acc[o][2], 0, 0x3120), prmt(acc[o][3], 0, 0x3120));
  }
}

// ------------------------------------------------------ K1, popc route -----

template <int MAXW, int COLS, bool VEC>
__global__ void __launch_bounds__(kThreads)
apply_bytes_w8_kernel(const int8_t* __restrict__ mbits,
                      const uint8_t* __restrict__ data,
                      uint8_t* __restrict__ out, int k, int out_rows,
                      long long B) {
  static_assert(!VEC || COLS == 4, "vector path moves 4 columns per thread");
  extern __shared__ uint64_t smask[];
  const int W = (k + 7) / 8;  // 64-bit words per column vector
  ctt_load_row_masks(mbits, out_rows * 8, k * 8, W, smask);

  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       g * COLS < B; g += stride) {
    const long long col0 = g * COLS;
    uint64_t vec[COLS][MAXW];
#pragma unroll
    for (int c = 0; c < COLS; ++c)
#pragma unroll
      for (int w = 0; w < MAXW; ++w) vec[c][w] = 0;

    // gather: byte of chunk j -> bits 8*(j%8).. of word j/8
#pragma unroll
    for (int w = 0; w < MAXW; ++w) {
      if (w < W) {
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          const int j = w * 8 + b;
          if (j < k) {
            const uint8_t* row = data + (long long)j * B + col0;
            if (VEC) {
              const uint32_t v = __ldg(reinterpret_cast<const uint32_t*>(row));
#pragma unroll
              for (int c = 0; c < COLS; ++c)
                vec[c][w] |= static_cast<uint64_t>((v >> (8 * c)) & 0xffu)
                             << (8 * b);
            } else {
#pragma unroll
              for (int c = 0; c < COLS; ++c)
                if (col0 + c < B)
                  vec[c][w] |= static_cast<uint64_t>(__ldg(row + c)) << (8 * b);
            }
          }
        }
      }
    }

    // parity rows o*8+x -> bit x of parity byte o
    for (int o = 0; o < out_rows; ++o) {
      uint32_t ob[COLS];
#pragma unroll
      for (int c = 0; c < COLS; ++c) ob[c] = 0;
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        const uint64_t* m = smask + (o * 8 + x) * W;
        uint64_t acc[COLS];
#pragma unroll
        for (int c = 0; c < COLS; ++c) acc[c] = 0;
#pragma unroll
        for (int w = 0; w < MAXW; ++w) {
          if (w < W) {
            const uint64_t mw = m[w];
#pragma unroll
            for (int c = 0; c < COLS; ++c) acc[c] ^= mw & vec[c][w];
          }
        }
#pragma unroll
        for (int c = 0; c < COLS; ++c) ob[c] |= ctt_parity64(acc[c]) << x;
      }
      uint8_t* orow = out + (long long)o * B + col0;
      if (VEC) {
        *reinterpret_cast<uint32_t*>(orow) =
            ob[0] | (ob[1] << 8) | (ob[2] << 16) | (ob[3] << 24);
      } else {
#pragma unroll
        for (int c = 0; c < COLS; ++c)
          if (col0 + c < B) orow[c] = static_cast<uint8_t>(ob[c]);
      }
    }
  }
}

// ---------------------------------------------------------- K2, mma route --

constexpr int kMmaMaxR = 64;            // four m16 tiles of output rows
constexpr int kMmaMaxC = 128;           // four k32 tiles of input rows
constexpr int kMmaConsumerWarps = 8;    // one 32-column block of a tile each
// A producer warp issues bulk copies at a limited rate (a copy of 256 bytes
// about every 45 ns on an H100), too slow to keep a stage of 128 rows
// filling; two warps, each with its own `full` barriers, copy the even and
// the odd rows.
constexpr int kMmaProducerWarps = 2;
constexpr int kMmaThreads = (kMmaConsumerWarps + kMmaProducerWarps) * 32;
constexpr int kMmaBlocksPerSm = 2;
constexpr int kMmaTile = kMmaConsumerWarps * 32;  // columns a stage holds
// Row pitch of a stage in shared memory: 32 bytes over the tile, so rows
// 4i+t (t = 0..3) start 8 banks apart and the fragment loads are free of
// bank conflicts; a multiple of 16, as bulk-copy destinations must be.
constexpr int kMmaPitch = kMmaTile + 32;
constexpr int kMmaMaxStages = 4;
constexpr int kMmaBarrierBytes = 128;  // empty[4], full[2][4]
constexpr int kMmaSmemBudget = 110 * 1024;  // two blocks share an SM's 228 KB

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Spin until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// One bulk asynchronous copy of `bytes` (a multiple of 16, both addresses
// 16-byte aligned) from global to shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mma_s8(uint32_t (&c)[4], const uint4& a,
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// Transpose 4x4 bytes: byte j of w[i] becomes byte i of col[j].
__device__ __forceinline__ void transpose4x4(const uint32_t (&w)[4],
                                             uint32_t (&col)[4]) {
  const uint32_t x0 = prmt(w[0], w[1], 0x5140), x1 = prmt(w[0], w[1], 0x7362);
  const uint32_t y0 = prmt(w[2], w[3], 0x5140), y1 = prmt(w[2], w[3], 0x7362);
  col[0] = prmt(x0, y0, 0x5410);
  col[1] = prmt(x0, y0, 0x7632);
  col[2] = prmt(x1, y1, 0x5410);
  col[3] = prmt(x1, y1, 0x7632);
}

// The A fragment (mma m16n8k32, s8, row-major) of lane `lane` for m-tile mt
// and k-tile kt, masked to the low bits and zero past R and C.  Lane (g, t)
// holds rows g and g+8 at logical k 4t..4t+3 (a.x, a.y) and 16+4t.. (a.z,
// a.w).  Logical k 4t+i of a half is physical input row 4i+t, the order in
// which the B fragments are read (mma_route_tile).
__device__ __forceinline__ uint4 mma_a_fragment(const int8_t* __restrict__ mbits,
                                                int R, int C, int mt, int kt,
                                                int lane) {
  const int g = lane >> 2, t = lane & 3;
  uint32_t reg[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int r = mt * 16 + g + (q & 1) * 8;
    uint32_t v = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = kt * 32 + (q >> 1) * 16 + 4 * i + t;
      if (r < R && c < C)
        v |= static_cast<uint32_t>(mbits[(long long)r * C + c] & 1) << (8 * i);
    }
    reg[q] = v;
  }
  return make_uint4(reg[0], reg[1], reg[2], reg[3]);
}

// (M[R, C] @ bits[C, B]) & 1 on int8 tensor cores, for R <= 64, C <= 128,
// B a multiple of 16 and 16-byte aligned bits and out.
//   Persistent blocks walk tiles of kMmaTile columns.  Warps 8 and 9 are
//   producers: they keep `stages` tiles in flight in a ring in shared
//   memory, one bulk copy per input row segment (warp 8 the even rows, warp
//   9 the odd), each counting its copies' completion on its own `full`
//   mbarrier of the stage; the consumer warps release a stage on its
//   `empty` mbarrier.  Warps 0-7 are consumers: warp w takes columns 32w..32w+31 of
//   each tile.  Lane (g, t) reads input rows 4i+t (and 16+4i+t), i = 0..3,
//   at columns 4g..4g+3 (four 32-bit shared loads), and transposes the 4x4
//   bytes, so that byte i of word j is row 4i+t at column 4g+j: its B
//   fragment for n-tile j.  Columns are independent, so n-tile j, column g
//   is physical column 4g+j; rows are summed, so reading them in the order
//   4i+t only asks the A fragments for the same order.  Then the
//   accumulators of lane (g, t) hold rows g and g+8 at physical columns
//   8t..8t+7: eight consecutive bytes, packed with prmt, masked to the low
//   bit and stored as one 8-byte store a row.
//   Exact for any int8: A is masked to 0/1, so each int32 sum is a sum of
//   input bytes (at most 128 of them) and cannot overflow, and its low bit
//   is the parity of their low bits.  B needs no mask for that reason.
template <int MT, int KT>
__global__ void __launch_bounds__(kMmaThreads, kMmaBlocksPerSm)
gf2_matmul_mma_kernel(const int8_t* __restrict__ mbits,
                      const int8_t* __restrict__ bits, int8_t* __restrict__ out,
                      int R, int C, long long B, int stages) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint64_t* empty = reinterpret_cast<uint64_t*>(smem);
  uint64_t* full = empty + kMmaMaxStages;  // [producer][stage]
  uint4* afrag = reinterpret_cast<uint4*>(smem + kMmaBarrierBytes);
  uint8_t* ring = smem + kMmaBarrierBytes + MT * KT * 32 * sizeof(uint4);
  constexpr int kStageBytes = KT * 32 * kMmaPitch;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long tiles = (B + kMmaTile - 1) / kMmaTile;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      for (int p = 0; p < kMmaProducerWarps; ++p)
        mbar_init(&full[p * kMmaMaxStages + s], 1);
      mbar_init(&empty[s], kMmaConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= kMmaConsumerWarps) {  // producer p: rows p, p+2, p+4, ...
    const int p = warp - kMmaConsumerWarps;
    const uint32_t rows = (C + 1 - p) / 2;
    int s = 0;
    uint32_t phase = 0;  // of the ring's current lap; lap 0 needs no release
    bool lap0 = true;
    for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      if (!lap0) mbar_wait(&empty[s], phase ^ 1);
      const long long col0 = tile * kMmaTile;
      const uint32_t ncols = static_cast<uint32_t>(
          B - col0 < kMmaTile ? B - col0 : kMmaTile);
      uint64_t* bar = &full[p * kMmaMaxStages + s];
      if (lane == 0) mbar_arrive_expect_tx(bar, ncols * rows);
      __syncwarp();
      uint8_t* stage = ring + s * kStageBytes;
      for (int r = p + 2 * lane; r < C; r += 64)
        bulk_load(stage + r * kMmaPitch, bits + (long long)r * B + col0, ncols,
                  bar);
      if (++s == stages) {
        s = 0;
        phase ^= 1;
        lap0 = false;
      }
    }
    return;
  }

  // consumers: the A fragments go to shared memory while the first stages load
  for (int i = threadIdx.x; i < MT * KT * 32; i += kMmaConsumerWarps * 32)
    afrag[i] = mma_a_fragment(mbits, R, C, i / 32 / KT, i / 32 % KT, i % 32);
  asm volatile("bar.sync 1, %0;" ::"n"(kMmaConsumerWarps * 32) : "memory");

  const int g = lane >> 2, t = lane & 3;
  int s = 0;
  uint32_t phase = 0;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
#pragma unroll
    for (int p = 0; p < kMmaProducerWarps; ++p)
      mbar_wait(&full[p * kMmaMaxStages + s], phase);
    const uint8_t* base = ring + s * kStageBytes + warp * 32 + 4 * g;

    uint32_t acc[MT][4][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mt][j][q] = 0;

#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      uint32_t b[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          w[i] = *reinterpret_cast<const uint32_t*>(
              base + (kt * 32 + h * 16 + 4 * i + t) * kMmaPitch);
        transpose4x4(w, b[h]);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const uint4 a = afrag[(mt * KT + kt) * 32 + lane];
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[mt][j], a, b[0][j], b[1][j]);
      }
    }
    __syncwarp();  // the stage is read: release it
    if (lane == 0) mbar_arrive(&empty[s]);
    if (++s == stages) {
      s = 0;
      phase ^= 1;
    }

    const long long col = tile * kMmaTile + warp * 32 + 8 * t;
    if (col < B) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // rows g (c0, c1) and g+8 (c2, c3)
          const int r = mt * 16 + g + 8 * h;
          if (r < R) {
            const uint32_t lo =
                prmt(prmt(acc[mt][0][2 * h], acc[mt][1][2 * h], 0x0040),
                     prmt(acc[mt][2][2 * h], acc[mt][3][2 * h], 0x0040),
                     0x5410) & 0x01010101u;
            const uint32_t hi =
                prmt(prmt(acc[mt][0][2 * h + 1], acc[mt][1][2 * h + 1], 0x0040),
                     prmt(acc[mt][2][2 * h + 1], acc[mt][3][2 * h + 1], 0x0040),
                     0x5410) & 0x01010101u;
            *reinterpret_cast<uint2*>(out + (long long)r * B + col) =
                make_uint2(lo, hi);
          }
        }
      }
    }
  }
}

// ------------------------------------------------------- K2, popc route ----

template <int MAXW, int COLS, bool VEC>
__global__ void __launch_bounds__(kThreads)
gf2_matmul_kernel(const int8_t* __restrict__ mbits,
                  const int8_t* __restrict__ bits, int8_t* __restrict__ out,
                  int R, int C, long long B) {
  static_assert(!VEC || COLS == 4, "vector path moves 4 columns per thread");
  extern __shared__ uint64_t smask[];
  const int W = (C + 63) / 64;
  ctt_load_row_masks(mbits, R, C, W, smask);

  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       g * COLS < B; g += stride) {
    const long long col0 = g * COLS;
    uint64_t vec[COLS][MAXW];
#pragma unroll
    for (int c = 0; c < COLS; ++c)
#pragma unroll
      for (int w = 0; w < MAXW; ++w) vec[c][w] = 0;

    // gather: input row i -> bit i%64 of word i/64, eight rows per byte
#pragma unroll
    for (int w = 0; w < MAXW; ++w) {
      if (w < W) {
#pragma unroll 1
        for (int b8 = 0; b8 < 8; ++b8) {
          const int i0 = w * 64 + b8 * 8;
          if (i0 >= C) break;
          if (VEC) {
            uint32_t p = 0;  // byte c = column c's bits of rows i0..i0+7
#pragma unroll
            for (int b = 0; b < 8; ++b) {
              if (i0 + b < C) {
                const uint32_t v = __ldg(reinterpret_cast<const uint32_t*>(
                    bits + (long long)(i0 + b) * B + col0));
                p |= (v & 0x01010101u) << b;
              }
            }
#pragma unroll
            for (int c = 0; c < COLS; ++c)
              vec[c][w] |= static_cast<uint64_t>((p >> (8 * c)) & 0xffu)
                           << (8 * b8);
          } else {
            uint32_t q[COLS];
#pragma unroll
            for (int c = 0; c < COLS; ++c) q[c] = 0;
#pragma unroll
            for (int b = 0; b < 8; ++b) {
              if (i0 + b < C) {
                const int8_t* row = bits + (long long)(i0 + b) * B + col0;
#pragma unroll
                for (int c = 0; c < COLS; ++c)
                  if (col0 + c < B)
                    q[c] |= static_cast<uint32_t>(__ldg(row + c) & 1) << b;
              }
            }
#pragma unroll
            for (int c = 0; c < COLS; ++c)
              vec[c][w] |= static_cast<uint64_t>(q[c]) << (8 * b8);
          }
        }
      }
    }

    for (int r = 0; r < R; ++r) {
      const uint64_t* m = smask + r * W;
      uint64_t acc[COLS];
#pragma unroll
      for (int c = 0; c < COLS; ++c) acc[c] = 0;
#pragma unroll
      for (int w = 0; w < MAXW; ++w) {
        if (w < W) {
          const uint64_t mw = m[w];
#pragma unroll
          for (int c = 0; c < COLS; ++c) acc[c] ^= mw & vec[c][w];
        }
      }
      int8_t* orow = out + (long long)r * B + col0;
      if (VEC) {
        *reinterpret_cast<uint32_t*>(orow) =
            ctt_parity64(acc[0]) | (ctt_parity64(acc[1]) << 8) |
            (ctt_parity64(acc[2]) << 16) | (ctt_parity64(acc[3]) << 24);
      } else {
#pragma unroll
        for (int c = 0; c < COLS; ++c)
          if (col0 + c < B) orow[c] = static_cast<int8_t>(ctt_parity64(acc[c]));
      }
    }
  }
}

// ------------------------------------------------------------ launch -------

// The current device's SM count, read once per device.
int sm_count() {
  static int cached[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) dev = 0;
  if (cached[dev] < 1) {
    int sms = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cached[dev] = sms < 1 ? 1 : sms;
  }
  return cached[dev];
}

int grid_for(long long columns, int cols_per_thread,
             int blocks_per_sm = kBlocksPerSm, int threads = kThreads) {
  const long long groups = (columns + cols_per_thread - 1) / cols_per_thread;
  const long long blocks = (groups + threads - 1) / threads;
  const long long cap = (long long)sm_count() * blocks_per_sm;
  return static_cast<int>(blocks < cap ? blocks : cap);
}

bool aligned4(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 3u) == 0;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Launch `kernel<MAXW, COLS, VEC>` for the word count W of the column vector:
// one word (k <= 8, C <= 64) and up to four (k <= 32, C <= 256) keep four
// columns per thread in registers; wider vectors take one column per thread.
template <template <int, int, bool> class Launch, typename... Args>
int dispatch(int W, bool vec, long long B, size_t smem, cudaStream_t stream,
             Args... args) {
  if (W == 1) {
    vec ? Launch<1, 4, true>::run(grid_for(B, 4), smem, stream, args...)
        : Launch<1, 4, false>::run(grid_for(B, 4), smem, stream, args...);
  } else if (W <= 4) {
    vec ? Launch<4, 4, true>::run(grid_for(B, 4), smem, stream, args...)
        : Launch<4, 4, false>::run(grid_for(B, 4), smem, stream, args...);
  } else {
    Launch<CTT_MAX_MASK_WORDS, 1, false>::run(grid_for(B, 1), smem, stream,
                                              args...);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int MAXW, int COLS, bool VEC>
struct ApplyBytesW8 {
  static void run(int grid, size_t smem, cudaStream_t stream,
                  const int8_t* mbits, const uint8_t* data, uint8_t* out,
                  int k, int out_rows, long long B) {
    apply_bytes_w8_kernel<MAXW, COLS, VEC><<<grid, kThreads, smem, stream>>>(
        mbits, data, out, k, out_rows, B);
  }
};

template <int MAXW, int COLS, bool VEC>
struct Gf2Matmul {
  static void run(int grid, size_t smem, cudaStream_t stream,
                  const int8_t* mbits, const int8_t* bits, int8_t* out, int R,
                  int C, long long B) {
    gf2_matmul_kernel<MAXW, COLS, VEC><<<grid, kThreads, smem, stream>>>(
        mbits, bits, out, R, C, B);
  }
};

// K1's routes (ops/cuda_gf2.py K1_ROUTES names them): the xor kernel, the
// popc kernel with 4- or 1-byte accesses.
enum K1Route { kXor = 0, kPopcV4 = 1, kPopcB1 = 2 };

int popc_route(const uint8_t* data, const uint8_t* out, int k, long long B) {
  return k <= 32 && B % 4 == 0 && aligned4(data) && aligned4(out) ? kPopcV4
                                                                  : kPopcB1;
}

int k1_route(const int8_t* mbits, const uint8_t* data, const uint8_t* out,
             int k, int out_rows, long long B) {
  if (k <= kXorMaxK && out_rows <= kXorMaxOut && B % kXorCols == 0 &&
      aligned16(mbits) && aligned16(data) && aligned16(out))
    return kXor;
  return popc_route(data, out, k, B);
}

template <int OUT>
void launch_xor(cudaStream_t stream, const int8_t* mbits, const uint8_t* data,
                uint8_t* out, int k, long long B) {
  apply_bytes_w8_xor_kernel<OUT>
      <<<grid_for(B, kXorCols, kXorBlocksPerSm, kXorThreads), kXorThreads, 0,
         stream>>>(mbits, data, out, k, B);
}

int launch_w8(int route, const int8_t* mbits, const uint8_t* data, uint8_t* out,
              int k, int out_rows, long long B, cudaStream_t stream) {
  const int W = (k + 7) / 8;
  const size_t smem = (size_t)out_rows * 8 * W * sizeof(uint64_t);
  if (k < 1 || out_rows < 1 || B < 1 || W > CTT_MAX_MASK_WORDS ||
      smem > CTT_MAX_MASK_BYTES)
    return static_cast<int>(cudaErrorInvalidValue);
  if (route == kXor) {
    switch (out_rows) {
      case 1: launch_xor<1>(stream, mbits, data, out, k, B); break;
      case 2: launch_xor<2>(stream, mbits, data, out, k, B); break;
      case 3: launch_xor<3>(stream, mbits, data, out, k, B); break;
      default: launch_xor<4>(stream, mbits, data, out, k, B); break;
    }
    return static_cast<int>(cudaGetLastError());
  }
  return dispatch<ApplyBytesW8>(W, route == kPopcV4, B, smem, stream, mbits,
                                data, out, k, out_rows, B);
}

// K2's routes (ops/cuda_gf2.py K2_ROUTES names them): the int8 tensor-core
// kernel, the popc kernel with 4- or 1-byte accesses.
enum K2Route { kMma = 0, kK2PopcV4 = 1, kK2PopcB1 = 2 };

int k2_popc_route(const int8_t* bits, const int8_t* out, long long B) {
  return B % 4 == 0 && aligned4(bits) && aligned4(out) ? kK2PopcV4 : kK2PopcB1;
}

int k2_route(const int8_t* bits, const int8_t* out, int R, int C,
             long long B) {
  if (R >= 1 && R <= kMmaMaxR && C >= 1 && C <= kMmaMaxC && B % 16 == 0 &&
      aligned16(bits) && aligned16(out))
    return kMma;
  return k2_popc_route(bits, out, B);
}

// Shared memory of the mma kernel: barriers, A fragments, `stages` stages.
size_t mma_smem(int mt, int kt, int stages) {
  return kMmaBarrierBytes + (size_t)mt * kt * 32 * sizeof(uint4) +
         (size_t)stages * kt * 32 * kMmaPitch;
}

template <int MT, int KT>
int launch_mma(cudaStream_t stream, const int8_t* mbits, const int8_t* bits,
               int8_t* out, int R, int C, long long B) {
  int stages = kMmaMaxStages;
  while (stages > 2 && mma_smem(MT, KT, stages) > kMmaSmemBudget) --stages;
  const size_t smem = mma_smem(MT, KT, stages);
  cudaError_t err = cudaFuncSetAttribute(
      gf2_matmul_mma_kernel<MT, KT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = (B + kMmaTile - 1) / kMmaTile;
  const long long cap = (long long)sm_count() * kMmaBlocksPerSm;
  const int grid = static_cast<int>(tiles < cap ? tiles : cap);
  gf2_matmul_mma_kernel<MT, KT><<<grid, kMmaThreads, smem, stream>>>(
      mbits, bits, out, R, C, B, stages);
  return static_cast<int>(cudaGetLastError());
}

template <int MT>
int launch_mma_kt(int kt, cudaStream_t stream, const int8_t* mbits,
                  const int8_t* bits, int8_t* out, int R, int C, long long B) {
  switch (kt) {
    case 1: return launch_mma<MT, 1>(stream, mbits, bits, out, R, C, B);
    case 2: return launch_mma<MT, 2>(stream, mbits, bits, out, R, C, B);
    case 3: return launch_mma<MT, 3>(stream, mbits, bits, out, R, C, B);
    default: return launch_mma<MT, 4>(stream, mbits, bits, out, R, C, B);
  }
}

int launch_k2(int route, const int8_t* mbits, const int8_t* bits, int8_t* out,
              int R, int C, long long B, cudaStream_t stream) {
  const int W = (C + 63) / 64;
  const size_t smem = (size_t)R * W * sizeof(uint64_t);
  if (R < 1 || C < 1 || B < 1 || W > CTT_MAX_MASK_WORDS ||
      smem > CTT_MAX_MASK_BYTES)
    return static_cast<int>(cudaErrorInvalidValue);
  if (route == kMma) {
    const int mt = (R + 15) / 16, kt = (C + 31) / 32;
    switch (mt) {
      case 1: return launch_mma_kt<1>(kt, stream, mbits, bits, out, R, C, B);
      case 2: return launch_mma_kt<2>(kt, stream, mbits, bits, out, R, C, B);
      case 3: return launch_mma_kt<3>(kt, stream, mbits, bits, out, R, C, B);
      default: return launch_mma_kt<4>(kt, stream, mbits, bits, out, R, C, B);
    }
  }
  return dispatch<Gf2Matmul>(W, route == kK2PopcV4, B, smem, stream, mbits,
                             bits, out, R, C, B);
}

}  // namespace

extern "C" int ctt_apply_bytes_w8_route(const int8_t* mbits,
                                        const uint8_t* data,
                                        const uint8_t* out, int k,
                                        int out_rows, long long B) {
  return k1_route(mbits, data, out, k, out_rows, B);
}

extern "C" int ctt_apply_bytes_w8(const int8_t* mbits, const uint8_t* data,
                                  uint8_t* out, int k, int out_rows,
                                  long long B, void* stream) {
  return launch_w8(k1_route(mbits, data, out, k, out_rows, B), mbits, data,
                   out, k, out_rows, B, static_cast<cudaStream_t>(stream));
}

extern "C" int ctt_apply_bytes_w8_popc(const int8_t* mbits,
                                       const uint8_t* data, uint8_t* out,
                                       int k, int out_rows, long long B,
                                       void* stream) {
  return launch_w8(popc_route(data, out, k, B), mbits, data, out, k,
                   out_rows, B, static_cast<cudaStream_t>(stream));
}

extern "C" int ctt_gf2_matmul_route(const int8_t* bits, const int8_t* out,
                                    int R, int C, long long B) {
  return k2_route(bits, out, R, C, B);
}

extern "C" int ctt_gf2_matmul(const int8_t* mbits, const int8_t* bits,
                              int8_t* out, int R, int C, long long B,
                              void* stream) {
  return launch_k2(k2_route(bits, out, R, C, B), mbits, bits, out, R, C, B,
                   static_cast<cudaStream_t>(stream));
}

extern "C" int ctt_gf2_matmul_popc(const int8_t* mbits, const int8_t* bits,
                                   int8_t* out, int R, int C, long long B,
                                   void* stream) {
  return launch_k2(k2_popc_route(bits, out, B), mbits, bits, out, R, C, B,
                   static_cast<cudaStream_t>(stream));
}

extern "C" const char* ctt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
