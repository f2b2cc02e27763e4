// Bit-plane GF(2) kernels for Hopper: the C interface bound by ctypes
// (ceph_tpu_torch/ops/cuda_gf2.py) and the device helpers the popcount kernels
// share.
//
// Every kernel computes out_bits = (M @ bits) & 1 over GF(2).  In the popcount
// kernels (gf2_matmul and apply_bytes_w8's popc route) a bit-matrix row becomes
// a row of 64-bit masks held in shared memory, a data column becomes a bit
// vector gathered into registers, and each output bit is the parity of
// (mask & vector): popcount, low bit.  The parity of a sum of products depends
// only on the low bit of each operand, so taking `& 1` of both operands first
// is exact for every int8 input, negative ones included, and equals the int32
// accumulate-then-`& 1` of the Pallas kernels this replaces.  apply_bytes_w8's
// xor route reads the bit-matrix the same way (low bits only); gf2_matmul's
// mma route masks the bit-matrix and sums input bytes in int32, whose low bit
// is the same parity.
#pragma once

#include <cstdint>

// Row masks live in (static-limit) dynamic shared memory.
#define CTT_MAX_MASK_BYTES (48 * 1024)
// Widest bit vector a column may have, in 64-bit words (2048 bit-rows).
#define CTT_MAX_MASK_WORDS 32

#ifdef __cplusplus
extern "C" {
#endif

// [out_rows*8, k*8] int8 bit-matrix applied to [k, B] uint8 chunks (w=8 byte
// layout) -> [out_rows, B] uint8, on the route ctt_apply_bytes_w8_route names.
// Returns a cudaError_t value, 0 on success.
int ctt_apply_bytes_w8(const int8_t* mbits, const uint8_t* data, uint8_t* out,
                       int k, int out_rows, long long B, void* stream);

// The route ctt_apply_bytes_w8 takes for these operands: 0 xor (k <= 16,
// out_rows <= 4, B and the three addresses multiples of 16), else 1 popc with
// 4-byte accesses or 2 popc with byte accesses.
int ctt_apply_bytes_w8_route(const int8_t* mbits, const uint8_t* data,
                             const uint8_t* out, int k, int out_rows,
                             long long B);

// ctt_apply_bytes_w8 on the popc route whatever the shape, so that the two
// routes can be compared on the same operands.
int ctt_apply_bytes_w8_popc(const int8_t* mbits, const uint8_t* data,
                            uint8_t* out, int k, int out_rows, long long B,
                            void* stream);

// (M[R, C] @ bits[C, B]) & 1 on int8 operands -> [R, B] int8 0/1, on the
// route ctt_gf2_matmul_route names.  Returns a cudaError_t value, 0 on success.
int ctt_gf2_matmul(const int8_t* mbits, const int8_t* bits, int8_t* out,
                   int R, int C, long long B, void* stream);

// The route ctt_gf2_matmul takes for these operands: 0 mma (R <= 64,
// C <= 128, B and the bits and out addresses multiples of 16), else 1 popc
// with 4-byte accesses or 2 popc with byte accesses.
int ctt_gf2_matmul_route(const int8_t* bits, const int8_t* out, int R, int C,
                         long long B);

// ctt_gf2_matmul on the popc route whatever the shape, so that the two
// routes can be compared on the same operands.
int ctt_gf2_matmul_popc(const int8_t* mbits, const int8_t* bits, int8_t* out,
                        int R, int C, long long B, void* stream);

const char* ctt_error_string(int code);

#ifdef __cplusplus
}
#endif

#ifdef __CUDACC__

// Row masks of an [R, C] int8 bit-matrix into shared memory: word w of row r
// (smask[r * W + w]) holds bit b = mbits[r, w*64 + b] & 1.  Each thread builds
// whole bytes, stored little-endian into the words.
__device__ __forceinline__ void ctt_load_row_masks(
    const int8_t* __restrict__ mbits, int R, int C, int W, uint64_t* smask) {
  uint8_t* sbytes = reinterpret_cast<uint8_t*>(smask);
  const int row_bytes = W * 8;
  for (int i = threadIdx.x; i < R * row_bytes; i += blockDim.x) {
    const int r = i / row_bytes;
    const int c0 = (i % row_bytes) * 8;
    uint32_t v = 0;
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const int c = c0 + b;
      if (c < C) v |= static_cast<uint32_t>(mbits[(long long)r * C + c] & 1) << b;
    }
    sbytes[i] = static_cast<uint8_t>(v);
  }
  __syncthreads();
}

// Parity of a 64-bit word: one 32-bit popcount after folding the halves.
__device__ __forceinline__ uint32_t ctt_parity64(uint64_t x) {
  return static_cast<uint32_t>(
      __popc(static_cast<uint32_t>(x) ^ static_cast<uint32_t>(x >> 32)) & 1);
}

#endif  // __CUDACC__
