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
//   Each thread owns one element of every row, 16 bytes where the addresses
//   and the row pitch allow it, else 4 or 1; threads past the row's end load
//   zeros and store nothing.  The block stages its C input elements and its
//   temps in shared memory as [value][thread], and every thread walks the
//   same instruction list (staged in shared memory, read as a broadcast), so
//   there is no divergence.
//   Bound: bytes, C rows read once and R rows written once ((64 + 24) *
//   64 KiB at the cauchy_good k=8 m=3 main shape: 1.7 us at 3.35 TB/s).  The
//   XORs are a few hundred shared-memory operations per element.  What
//   bounds K3 and K4 on an H100 80GB HBM3 at 700 W is the program walk: at
//   4 MiB an SM holds about one warp a scheduler, so a step's latency is the
//   time (about 18 and 16.5 us at the main shapes against copy floors of
//   7.7 us, PERF.md).  Every step therefore takes one path, and a step's
//   operands are loaded before the step before it stores (run_program).
// * apply_packedbit (K4) <- gf2_apply_packedbit and, with `planes`,
//   gf2_encode_packedbit_resident: the one-shot lane in one launch.  A block
//   takes 32 * threads columns of the k chunks: it copies them into shared
//   memory with 16-byte asynchronous copies (every row in flight at once);
//   thread i then turns the 32 bytes of its own word column of each row into
//   8 plane words in registers (four 8x8 bit transposes and byte
//   permutes), runs the program on its words, and packs its output words
//   back to bytes the same way.
//   Bound: bytes, k*B read and out*B written (4 MiB + 1.5 MiB at the main
//   shape: 1.72 us), the same as apply_bytes_w8's.  A first version
//   transposed with warp ballots (__ballot_sync over bit x of 32 lanes'
//   bytes is one plane word): about one warp instruction a byte, against
//   about one per 10 bytes here, and at the main shape each SM runs about
//   one warp a scheduler, so instruction count per warp is the time
//   (PERF.md has both versions' times on an H100).
// * to_packedbit (K5) / from_packedbit (K6): the two transposes alone, one
//   word column a thread, from K4's device functions.  Bound: bytes, each
//   byte read once and written once in the other layout (2 * 4 MiB at the
//   main shape: 2.5 us).
//
// Every kernel masks its own ragged edge: pad columns read as zero and only
// the real columns are written, so nothing is padded on the host.

#include <cuda_runtime.h>

#include "packedbit.cuh"

namespace {

__host__ __device__ inline long long prog_bytes(int n_instr) {
  return ((long long)n_instr * 8 + 15) / 16 * 16;
}

__host__ inline long long max_ll(long long a, long long b) { return a > b ? a : b; }

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

// Copy the instruction list into shared memory (caller syncs).
__device__ __forceinline__ void stage_program(const int2* __restrict__ prog,
                                              int n_instr, int2* sprog) {
  for (int i = threadIdx.x; i < n_instr; i += blockDim.x) sprog[i] = prog[i];
}

// Walk the program over this thread's column of vals ([n_vals][T], column
// tid), handing each finished output row to store(row, value).  Only the
// thread's own column is touched, so no barrier is needed inside.  With at
// most a warp a scheduler, the chain of shared-memory loads is the time, so
// step p+1's operands are loaded before step p stores its result (the host's
// schedule never lets a step read what the step before it wrote), and the
// instruction after that is read meanwhile.  Every step takes the same path:
// value[d] = value[a] ^ value[b], folded into the accumulator too.
template <typename V, typename Store>
__device__ __forceinline__ void run_program(const int2* sprog, int n_instr,
                                            V* vals, int T, int tid,
                                            Store store) {
  int2 cur = sprog[0];
  int2 nxt = sprog[n_instr > 1 ? 1 : 0];
  V xa = vals[(cur.x & 0xffff) * T + tid];
  V xb = vals[(cur.x >> 16) * T + tid];
  V acc = vzero<V>();
  for (int p = 0; p < n_instr; ++p) {
    const int2 after = sprog[p + 2 < n_instr ? p + 2 : n_instr - 1];
    const V ya = vals[(nxt.x & 0xffff) * T + tid];
    const V yb = vals[(nxt.x >> 16) * T + tid];
    const V x = vxor(xa, xb);
    vals[(cur.y & 0xffff) * T + tid] = x;
    const int meta = cur.y >> 16;
    acc = (meta & CTT_PB_FIRST) ? x : vxor(acc, x);
    if (meta & CTT_PB_LAST) store(meta >> 2, acc);
    xa = ya;
    xb = yb;
    cur = nxt;
    nxt = after;
  }
}

// Columns [c0, c0 + width) of one row of B bytes into shared memory, zeros
// past B.  vec16: the row base and B are multiples of 16 (16-byte
// asynchronous copies; the caller waits for them).
__device__ __forceinline__ void load_tile_row(const uint8_t* __restrict__ row,
                                              long long B, long long c0,
                                              int width, uint8_t* dst,
                                              bool vec16) {
  if (vec16) {
    uint4* d = reinterpret_cast<uint4*>(dst);
#pragma unroll 2
    for (int v = threadIdx.x; v < width / 16; v += blockDim.x) {
      const long long c = c0 + 16LL * v;
      if (c < B)
        cp_async16(d + v, row + c);
      else
        d[v] = make_uint4(0, 0, 0, 0);
    }
  } else {
    for (int c = threadIdx.x; c < width; c += blockDim.x) {
      const long long g = c0 + c;
      dst[c] = g < B ? __ldg(row + g) : uint8_t(0);
    }
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

template <typename V>
__global__ void xor_schedule_kernel(const int2* __restrict__ prog, int n_instr,
                                    int C, int n_vals,
                                    const V* __restrict__ in,
                                    V* __restrict__ out, long long E) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int T = blockDim.x, tid = threadIdx.x;
  int2* sprog = reinterpret_cast<int2*>(smem);
  V* vals = reinterpret_cast<V*>(smem + prog_bytes(n_instr));
  const long long e = (long long)blockIdx.x * T + tid;
  const bool live = e < E;
  stage_program(prog, n_instr, sprog);
  if (!live) {
    for (int r = 0; r < C; ++r) vals[r * T + tid] = vzero<V>();
  } else if constexpr (sizeof(V) == 16) {
    for (int r = 0; r < C; ++r) cp_async16(&vals[r * T + tid], &in[r * E + e]);
  } else if constexpr (sizeof(V) == 4) {
    for (int r = 0; r < C; ++r) cp_async4(&vals[r * T + tid], &in[r * E + e]);
  } else {
#pragma unroll 8
    for (int r = 0; r < C; ++r) vals[r * T + tid] = in[r * E + e];
  }
  vals[(n_vals - 2) * T + tid] = vzero<V>();  // ZERO
  cp_async_wait_all();
  __syncthreads();
  run_program<V>(sprog, n_instr, vals, T, tid, [&](int row, V v) {
    if (live) out[row * E + e] = v;
  });
}

template <typename V>
cudaError_t launch_xor_schedule(const int16_t* prog, int n_instr, int C,
                                int n_vals, const void* in, void* out,
                                long long E,
                                int threads, size_t smem, cudaStream_t stream) {
  auto kernel = xor_schedule_kernel<V>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (E + threads - 1) / threads;
  kernel<<<(unsigned)blocks, threads, smem, stream>>>(
      reinterpret_cast<const int2*>(prog), n_instr, C, n_vals,
      static_cast<const V*>(in), static_cast<V*>(out), E);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- K4 --

__global__ void apply_packedbit_kernel(const int2* __restrict__ prog,
                                       int n_instr, int k, int out_rows,
                                       int n_vals,
                                       const uint8_t* __restrict__ data,
                                       long long B, uint8_t* __restrict__ out,
                                       uint32_t* __restrict__ planes,
                                       bool vec16_in, bool vec16_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int T = blockDim.x, tid = threadIdx.x;
  const int C = k * 8;
  const int width = 32 * T;
  int2* sprog = reinterpret_cast<int2*>(smem);
  uint32_t* vals = reinterpret_cast<uint32_t*>(smem + prog_bytes(n_instr));
  // the byte tile is dead once transposed; the output words reuse its room
  uint8_t* tile = reinterpret_cast<uint8_t*>(vals + (long long)n_vals * T);
  uint32_t* outw = reinterpret_cast<uint32_t*>(tile);
  const long long W = (B + 31) / 32;
  const long long c0 = (long long)blockIdx.x * width;
  stage_program(prog, n_instr, sprog);
  for (int j = 0; j < k; ++j)
    load_tile_row(data + j * B, B, c0, width, tile + (long long)j * width,
                  vec16_in);
  cp_async_wait_all();
  __syncthreads();
  // each thread turns its own 32 columns of each row into plane words
  for (int j = 0; j < k; ++j) {
    const uint4* src = reinterpret_cast<const uint4*>(
        tile + (long long)j * width + 32 * tid);
    const uint4 a = src[0], b = src[1];
    const uint32_t v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    uint32_t wx[8];
    bytes_to_words(v, wx);
#pragma unroll
    for (int x = 0; x < 8; ++x) vals[(j * 8 + x) * T + tid] = wx[x];
  }
  vals[(n_vals - 2) * T + tid] = 0;  // ZERO
  __syncthreads();  // the output words reuse the tile's room
  const long long w = (long long)blockIdx.x * T + tid;
  const bool live = w < W;
  if (planes != nullptr && live)
    for (int r = 0; r < C; ++r) planes[r * W + w] = vals[r * T + tid];
  run_program<uint32_t>(sprog, n_instr, vals, T, tid,
                        [&](int row, uint32_t v) {
                          outw[row * T + tid] = v;
                          if (planes != nullptr && live)
                            planes[(C + row) * W + w] = v;
                        });
  if (!live) return;
  for (int o = 0; o < out_rows; ++o) {
    uint32_t wx[8];
#pragma unroll
    for (int x = 0; x < 8; ++x) wx[x] = outw[(o * 8 + x) * T + tid];
    pack_store(wx, out + o * B, 32 * w, B, vec16_out);
  }
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

bool aligned(const void* p, unsigned n) {
  return reinterpret_cast<uintptr_t>(p) % n == 0;
}

bool valid_threads(int threads) {
  return threads >= 32 && threads <= 1024 && threads % 32 == 0;
}

}  // namespace

extern "C" int ctt_xor_schedule(const int16_t* prog, int n_instr, int C,
                                int n_vals, const void* in, void* out,
                                long long row_bytes, int vec, int threads,
                                void* stream) {
  if (!valid_threads(threads) || n_instr < 1 || C < 1 || n_vals < C + 2 ||
      (vec != 16 && vec != 4 && vec != 1) || row_bytes % vec != 0 ||
      !aligned(in, vec) || !aligned(out, vec) || !aligned(prog, 8))
    return cudaErrorInvalidValue;
  const long long smem = prog_bytes(n_instr) + (long long)n_vals * threads * vec;
  if (smem > CTT_PB_MAX_SMEM) return cudaErrorInvalidValue;
  const long long E = row_bytes / vec;
  if (E == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == 16)
    return launch_xor_schedule<uint4>(prog, n_instr, C, n_vals, in, out, E,
                                   threads, smem, s);
  if (vec == 4)
    return launch_xor_schedule<uint32_t>(prog, n_instr, C, n_vals, in, out, E,
                                   threads, smem, s);
  return launch_xor_schedule<uint8_t>(prog, n_instr, C, n_vals, in, out, E,
                                   threads, smem, s);
}

extern "C" int ctt_apply_packedbit(const int16_t* prog, int n_instr, int k,
                                   int out_rows, int n_vals,
                                   const uint8_t* data, long long B,
                                   uint8_t* out, uint32_t* planes, int threads,
                                   void* stream) {
  if (!valid_threads(threads) || n_instr < 1 || k < 1 || out_rows < 1 ||
      n_vals < k * 8 + 2 || B < 1 || !aligned(prog, 8) ||
      (planes != nullptr && !aligned(planes, 4)))
    return cudaErrorInvalidValue;
  const long long smem = prog_bytes(n_instr) + (long long)n_vals * threads * 4 +
                         max_ll(32LL * k, 32LL * out_rows) * threads;
  if (smem > CTT_PB_MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      apply_packedbit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const long long W = (B + 31) / 32;
  const long long blocks = (W + threads - 1) / threads;
  apply_packedbit_kernel<<<(unsigned)blocks, threads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const int2*>(prog), n_instr, k, out_rows, n_vals, data,
      B, out, planes, aligned(data, 16) && B % 16 == 0,
      aligned(out, 16) && B % 16 == 0);
  return cudaGetLastError();
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

extern "C" const char* ctt_pb_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
