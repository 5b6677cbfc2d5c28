// K4, K5, K6 and K6s: rotate -> per-token quantize -> int8 / fp8 GEMM in
// one kernel, for sm_90a; dense (K4, K5: quant_dot.cu) and over stacked
// experts (K6, K6s: quant_dot_experts.cu), each with the rotate-once (K4,
// K6) or the streamed (K5, K6s) schedule; and their checksum-verified
// (ABFT) twins K7a-ro, K7a-s (quant_dot_abft.cu), K7b, K7b-s
// (quant_dot_experts_abft.cu); and the dense revisit schedule K8
// (quant_dot.cu) with its ABFT twin K7a-rv (quant_dot_abft.cu). This header
// holds their shared body; each source instantiates its own kernels, so the
// four build in parallel.
//
// Replaces the TPU kernels of repro/kernels/quant_dot.py:
//   K4     _quant_dot_kernel_rotate_once              (launched by _pallas_quant_dot)
//   K5     _quant_dot_kernel_streamed, _ring_dmas     (_pallas_quant_dot, streamed)
//   K6     _quant_dot_experts_kernel                  (_pallas_quant_dot_experts)
//   K6s    _quant_dot_experts_kernel_streamed         (_pallas_quant_dot_experts)
//   K7a-ro _quant_dot_kernel_rotate_once_abft         (_pallas_quant_dot_abft)
//   K7a-s  _quant_dot_kernel_streamed_abft            (_pallas_quant_dot_abft)
//   K7b    _quant_dot_experts_kernel_abft             (_pallas_quant_dot_experts_abft)
//   K7b-s  _quant_dot_experts_kernel_streamed_abft    (_pallas_quant_dot_experts_abft)
//   K8     _quant_dot_kernel_revisit                  (_pallas_quant_dot, revisit)
//   K7a-rv _quant_dot_kernel_revisit_abft             (_pallas_quant_dot_abft, revisit)
// with the helpers _rotate_quantize_block, _operand_from_q, _operand_dot,
// _abft_check_col.
// Same function, with the same rounding points: each row of x is rotated
// through K1's passes in the compute dtype (hadacore.cuh), quantized per
// token from the f32 copy of the rounded row (quant.cuh), contracted with the
// (n, d) weight wq, and scaled as (float)acc * s * sw[col], then rounded
// once to the io dtype.
//   int8: exact int32 accumulation (dp4a), converted with __int2float_rn as
//         XLA converts -- the result equals the plain version bitwise
//         whenever the two rotations agree;
//   fp8:  both operands embedded exactly (the activation's grid values as
//         bf16, the weight bytes decoded to f32, e4m3 by the hardware's
//         exact cvt to f16), every product exact in f32, f32 accumulation in
//         a fixed order. Not fp8 tensor-core MMA: Hopper keeps fewer than
//         f32's bits in that accumulator.
// An all-zero row has absmax 0, scale 1e-8 / qmax and q = 0: its outputs
// are exact zeros.
//
// Experts (K6, K6s). x is (B, E, c, n), the dispatched activations; wq is
// (E, n, d) and sw (E, d); out is (B, E, c, d). blockIdx.z is the expert:
// its weight and scale pointers are offset by it, and its m = B * c rows are
// read in the reference's expert-major order (row r is x[r / c, e, r % c])
// through their strides, in place, and written back the same way. With
// E = c = 1 the expert kernel's body is the dense kernel's.
//
// Bound on an H100: at decode bytes -- the weight is read once (K6 at
// llama4-maverick's 128 x 8192 x 5120 fp8: 5.37 GB, 1.60 ms at 3.35 TB/s)
// against 2 * rows * n * d operations. The design keeps the rotated,
// quantized rows in shared memory (int8, or bf16 for fp8) and streams the
// weight past them, so the activations never round-trip through HBM.
//
// Launch. A decode step gives the kernel a few rows against the whole
// weight, so one block per row block would leave most SMs idle. The grid is
// (row blocks of BM rows) x (column splits) x (experts), and consecutive
// splits of a row block form a thread-block cluster of up to 8: each member
// rotates and quantizes its share of the rows and stores them into every
// member's shared memory (distributed shared memory), so each row is rotated
// once per cluster; then each block walks its run of 32-column tiles. The
// splits are chosen for about one wave of resident blocks; every split gives
// the same bits (the rotation of a row does not depend on the block, and
// each output's sum runs in a fixed order). Within a tile, thread (cq, ks)
// owns 4 columns and the ks-th of 64 contiguous k-chunks; its 4 x 4 byte
// blocks of the weight are read as 32-bit words (a warp reads 32 contiguous
// bytes of 4 weight rows), 16 words per k-step of 16 rows, and transposed
// with byte permutes into dp4a operands. A warp adds its 4 chunks' partial
// sums with shuffles and the 16 warps' sums are added in shared memory in
// warp order. Rows beyond m and columns beyond d are masked; neither input
// is padded.
//
// Streamed schedule (K5, K6s). The TPU ring holds whole (n, bn) weight
// tiles; at n = 8192 one such tile does not fit beside the operand, so here
// the ring holds k-steps: each stage is one k-step's 16 weight words of
// every thread (32 KB), kStages stages deep, filled by cp.async (4-byte
// copies, zero-filled past the edges) kStages - 1 k-steps ahead of the
// contraction, across tile boundaries. Each thread copies exactly the words
// it later reads, so a thread's own cp.async groups order its ring and no
// barrier is needed. The first stages are issued before the rotation, so
// their latency hides behind it (the reference's j == 0 warm-up). A copy is
// issued only for a k-step that exists (the reference's j + 1 < nj guard)
// and waited on before it is read, so no copy is in flight when a block's
// run of tiles -- its (expert, row block) pair -- ends. The contraction reads
// the same words in the same order as the rotate-once loop, so the two
// schedules give the same bits.
//
// Shared memory: the operand (BM x n, 1 or 2 bytes), the ring (streamed
// only: kStages x 32 KB), a work area that holds the f32 rows being rotated
// (all BM rows at once when they fit, else rw at a time) and later the
// partial sums, and the scales. BM is the largest of 16, 8, 4, 2, 1 that the
// rows need and the 227 KB limit allows (n = 8192, rotate-once: 16 rows for
// int8, 8 for fp8; streamed: 8 and 4); a launch that cannot fit returns an
// error, which the wrapper raises. 512 threads: the rotation's barrier-
// separated stages are latency-bound at one block per SM, so more warps
// hide more of it.
//
// ABFT twins (kAbft). Three additions, none on the output's path: (a) in
// the rotation phase each cluster member sums chk = op . cw for the rows it
// rotates (f32, a fixed order; cw, the weight's column checksum, is read
// from global memory and, streamed, never through the ring, so a
// mis-delivered ring stage shows in the residual) and stores it into every
// member, beside the scales; (b) each block sums, per row, the f32
// contributions acc * s * sw that the output casts (tile by tile, each
// tile's columns in order); (c) the residual needs every split of the row
// block: each block writes its row sums to a (row block, split) workspace
// and bumps the row block's counter (__threadfence, atomicAdd); the last to
// arrive adds the sums in split order, writes r = sum - s * chk and resets
// the counter to 0. One launch per site, and the same bits every run (no
// float atomics). The extra shared memory (about 2 KB at 16 rows) leaves
// the rows per block of every n the kernels serve unchanged; the outputs
// would not depend on them anyway (each output's sum has a fixed order).
//
// Revisit schedule (K8, K7a-rv; kRevisit). The reference's A/B baseline for
// rotate-once: the grid is (row blocks) x (column tiles of block_n), with no
// thread-block cluster and no distributed shared memory. Every block
// rotates and quantizes its WHOLE row block into its own shared memory and
// contracts it with its one weight tile of block_n columns (block_n / 32 of
// the 32-column tiles), so a row is rotated ceil(d / block_n) times -- the
// redundancy the schedule exists to show. The rotation, the quantization,
// the contraction and its k-order are the rotate-once code's, so K8's
// output is bitwise K4's; the shared-memory layout is K4's too (K4's blocks
// also hold every row of the row block), so are the rows per block. K7a-rv
// is K8 with kAbft: each block's row sums go to the (row block, tile)
// workspace and the last block of a row block adds them in tile order.
//
// Linter builds (repro_torch/analysis). With -DREPRO_COUNT_ROTATIONS the body
// counts, per element row of x, how often a rotation phase rotated it
// (g_rotations: one atomicAdd per row and phase, read and zeroed through the
// sources' *_rotations exports); without it the code is unchanged. The
// mutants of csrc/mutants/ define REPRO_MUTANT_UNGUARDED_ROTATE (M1: the
// rotation runs again before every column tile) or
// REPRO_MUTANT_DANGLING_DMA (M2: the streamed ring's waits are gone) before
// including this header; no main source defines either.
//
// What this first version leaves on the table: CUDA-core dp4a / FMA instead
// of the tensor cores (wgmma), 4-byte cp.async instead of TMA bulk copies,
// the rotation repeated in every cluster, and the all-zero rows of a dense
// MoE dispatch rotated and contracted like any other.
#pragma once

#include <cooperative_groups.h>
#include <cuda_fp8.h>

#include <type_traits>

#include "quant.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kBN = 32;              // output columns per tile
constexpr int kCQ = kBN / 4;         // column quads across a tile (lanes 0-7 of a warp)
constexpr int kKS = kThreads / kCQ;  // k-chunks per tile (4 per warp)
constexpr int kKW = kKS / 4;         // partial sums per output once a warp has added its 4
constexpr int kSteps = 4;            // k-steps of 4 whose weight loads are issued together
constexpr int kStepRows = 4 * kSteps;  // weight rows (32-bit words per thread) per k-step
constexpr int kStages = 3;           // streamed: k-steps in the ring
constexpr int kMaxCluster = 8;       // blocks sharing one row block's rotation (portable max)
constexpr size_t kSmemLimit = 232448;  // 227 KB, the per-block maximum on sm_90
constexpr size_t kSmemPerSM = 233472;  // 228 KB of shared memory on an SM

#if defined(REPRO_COUNT_ROTATIONS)
// Rotations per element row of x (row_index order), for the linter's
// rotate-once rule; rows past the array count in g_rotations_lost.
constexpr long long kCountRows = 1LL << 20;
__device__ unsigned int g_rotations[kCountRows];
__device__ unsigned int g_rotations_lost;

__device__ __forceinline__ void count_rotation(size_t row) {
  if (row < (size_t)kCountRows) atomicAdd(&g_rotations[row], 1u);
  else atomicAdd(&g_rotations_lost, 1u);
}
#endif

// Operand row stride: n rounded up to a whole 32-bit word of int8 values.
__host__ __device__ __forceinline__ int op_stride(int n) { return n < 4 ? 4 : n; }

// Bytes of the streamed schedule's ring (0 for rotate-once).
__host__ __device__ __forceinline__ size_t ring_bytes(bool streamed) {
  return streamed ? (size_t)kStages * kStepRows * kThreads * sizeof(uint32_t) : 0;
}

// Shared memory of a block of bm rows that rotates rw rows at a time: the
// operand, the ring, the work area (rw f32 rows, later the partial sums),
// bm scales and rw absmax words.
__host__ __device__ __forceinline__ size_t work_bytes(int n, int bm, int rw) {
  const size_t rot = (size_t)rw * n * sizeof(float);
  const size_t red = (size_t)kKW * bm * kBN * sizeof(float);
  return rot > red ? rot : red;
}

__host__ __device__ __forceinline__ size_t op_bytes(int n, int bm, bool is_int) {
  return (size_t)bm * op_stride(n) * (is_int ? 1 : 2);
}

// ABFT twins only: each row's activation checksum, the f32 contributions
// of one output tile, one partial sum per warp and the last-block flag.
__host__ __device__ __forceinline__ size_t abft_bytes(int bm, bool abft) {
  return abft ? (size_t)(bm + bm * kBN + kThreads / 32 + 1) * sizeof(float) : 0;
}

__host__ __device__ __forceinline__ size_t layout_bytes(int n, int bm, int rw, bool is_int,
                                                        bool streamed, bool abft) {
  return op_bytes(n, bm, is_int) + ring_bytes(streamed) + work_bytes(n, bm, rw) +
         (size_t)bm * sizeof(float) + (size_t)rw * sizeof(int) + abft_bytes(bm, abft);
}

// Rows rotated at once: all bm when they fit, else the most (a power of 2)
// that do. More rows per group means fewer barriers per row.
__host__ __device__ __forceinline__ int work_rows(int n, int bm, bool is_int, bool streamed,
                                                  bool abft) {
  int rw = bm;
  while (rw > 1 && layout_bytes(n, bm, rw, is_int, streamed, abft) > kSmemLimit) rw /= 2;
  return rw;
}

__host__ __device__ __forceinline__ size_t smem_bytes(int n, int bm, bool is_int,
                                                      bool streamed, bool abft) {
  return layout_bytes(n, bm, work_rows(n, bm, is_int, streamed, abft), is_int, streamed,
                      abft);
}

// Element row of row r (0 <= r < m) of expert e in x (B, E, cap, n) and out
// (B, E, cap, d): the reference's expert-major order. Dense: E = cap = 1.
__device__ __forceinline__ size_t row_index(long long r, int E, int cap, int e) {
  return (size_t)((r / cap) * E + e) * cap + (size_t)(r % cap);
}

// Columns j..j+3 of weight row k as one little-endian word (0 beyond n / d).
__device__ __forceinline__ uint32_t load_w4(const uint8_t* w, int k, int j, int n, int d,
                                            bool vec) {
  if (k >= n) return 0u;
  const uint8_t* row = w + (size_t)k * d;
  if (vec && j + 3 < d) return __ldg(reinterpret_cast<const unsigned int*>(row + j));
  uint32_t v = 0;
  for (int c = 0; c < 4; ++c)
    if (j + c < d) v |= (uint32_t)__ldg(row + j + c) << (8 * c);
  return v;
}

// The four fp8 bytes of a little-endian word as f32 (exact: every e4m3 and
// e5m2 value is an f16 value). e4m3 goes through the hardware's cvt of two
// bytes to two f16 at once; e5m2 is the high byte of its f16 encoding.
__device__ __forceinline__ void fp8x4_to_float(uint32_t w, int mode, float (&f)[4]) {
  if (mode == quant::kE4M3) {
    const __half2_raw lo =
        __nv_cvt_fp8x2_to_halfraw2((__nv_fp8x2_storage_t)(w & 0xffffu), __NV_E4M3);
    const __half2_raw hi =
        __nv_cvt_fp8x2_to_halfraw2((__nv_fp8x2_storage_t)(w >> 16), __NV_E4M3);
    f[0] = __half2float(__ushort_as_half(lo.x));
    f[1] = __half2float(__ushort_as_half(lo.y));
    f[2] = __half2float(__ushort_as_half(hi.x));
    f[3] = __half2float(__ushort_as_half(hi.y));
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      f[c] = __half2float(__ushort_as_half((unsigned short)(((w >> (8 * c)) & 0xffu) << 8)));
  }
}

__device__ __forceinline__ float bf16_bits_to_float(uint32_t h) {
  return __uint_as_float(h << 16);
}

// acc[i][c] += the contraction of rows k..k+3 of the operand (row i) with
// weight columns c of the four words w[0..3] (rows k..k+3, 4 columns each).
template <int BM, bool kInt, typename Acc>
__device__ __forceinline__ void contract4(Acc (&acc)[BM][4], const uint32_t* w,
                                          const unsigned char* op, int k, int np4, int mode) {
  if constexpr (kInt) {
    // 4 x 4 byte transpose: col[c] holds column c's weights of rows k..k+3
    const uint32_t lo01 = __byte_perm(w[0], w[1], 0x5140), hi01 = __byte_perm(w[0], w[1], 0x7362);
    const uint32_t lo23 = __byte_perm(w[2], w[3], 0x5140), hi23 = __byte_perm(w[2], w[3], 0x7362);
    const int col[4] = {(int)__byte_perm(lo01, lo23, 0x5410), (int)__byte_perm(lo01, lo23, 0x7632),
                        (int)__byte_perm(hi01, hi23, 0x5410), (int)__byte_perm(hi01, hi23, 0x7632)};
    const int* op32 = reinterpret_cast<const int*>(op);
#pragma unroll
    for (int i = 0; i < BM; ++i) {
      const int a = op32[(i * np4 + k) >> 2];
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] = __dp4a(a, col[c], acc[i][c]);
    }
  } else {
    float wf[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u) fp8x4_to_float(w[u], mode, wf[u]);
    const uint2* op64 = reinterpret_cast<const uint2*>(op);
#pragma unroll
    for (int i = 0; i < BM; ++i) {
      const uint2 h = op64[(i * np4 + k) >> 2];
      const float a[4] = {bf16_bits_to_float(h.x & 0xffffu), bf16_bits_to_float(h.x >> 16),
                          bf16_bits_to_float(h.y & 0xffffu), bf16_bits_to_float(h.y >> 16)};
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          acc[i][c] = __fmaf_rn(a[u], wf[u][c], acc[i][c]);  // exact product, f32 sum
    }
  }
}

// cp.async of one 32-bit word into shared memory, zero-filled when src_bytes
// is 0 (no byte is read then), and the group bookkeeping around it.
__device__ __forceinline__ void cp_async_word(uint32_t* dst, const void* src, int src_bytes) {
  const unsigned saddr = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(saddr), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The k-step of 16 weight rows that thread (cq, ks) contracts: rows
// k0 .. k0 + 15 of columns j .. j + 3, as 16 little-endian words (0 beyond
// ke, n or d) -- the words the rotate-once loop loads into registers.
struct KStep {
  const uint8_t* wq;
  int n, d, j, ke;
  bool vec;

  __device__ __forceinline__ void load(int k0, uint32_t (&wv)[kStepRows]) const {
    const bool whole = vec && j + 3 < d && ke <= n;
#pragma unroll
    for (int u = 0; u < kStepRows; ++u) {
      const int k = k0 + u;
      if (whole) {
        wv[u] = k < ke ? __ldg(reinterpret_cast<const unsigned int*>(wq + (size_t)k * d + j))
                       : 0u;
      } else {
        wv[u] = k < ke ? load_w4(wq, k, j, n, d, vec) : 0u;
      }
    }
  }

  // Streamed: the same words into a ring stage (thread-major: word u of
  // thread t at stage[u * kThreads + t]), by cp.async where the words are
  // whole aligned quads of real columns, synchronously otherwise.
  __device__ __forceinline__ void fetch(int k0, uint32_t* stage) const {
#pragma unroll
    for (int u = 0; u < kStepRows; ++u) {
      const int k = k0 + u;
      uint32_t* dst = stage + u * kThreads + threadIdx.x;
      if (vec) {
        const bool real = k < ke && k < n && j + 3 < d;
        cp_async_word(dst, real ? wq + (size_t)k * d + j : wq, real ? 4 : 0);
      } else {
        *dst = k < ke ? load_w4(wq, k, j, n, d, false) : 0u;
      }
    }
  }
};

// The ABFT twins' extra operands (unused by K4 / K5 / K6 / K6s): cw the
// (E, n) f32 column checksums, resid the (m) f32 per-row residuals (in
// out's row order), part the per-(expert, row block, split) row partial
// sums (gridDim.z * gridDim.x * gridDim.y * BM floats), count one arrival
// counter per (expert, row block), zero on entry and left zero on exit.
struct Abft {
  const float* cw;
  float* resid;
  float* part;
  unsigned int* count;
};

// Activation checksum of one operand row: sum_k op[k] * cw[k] in f32, each
// thread over k = tid, tid + kThreads, ... in order, then the warp's lanes
// by a fixed butterfly and the warps in order: the same bits in every block.
template <bool kInt>
__device__ __forceinline__ float row_check(const unsigned char* op_row, const float* cw, int n,
                                           float* wsum) {
  float a = 0.0f;
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    float v;
    if constexpr (kInt) v = (float)(int8_t)op_row[k];
    else v = bf16_bits_to_float(reinterpret_cast<const uint16_t*>(op_row)[k]);
    a = __fadd_rn(a, __fmul_rn(v, __ldg(cw + k)));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) a = __fadd_rn(a, __shfl_xor_sync(0xffffffffu, a, o));
  if ((threadIdx.x & 31) == 0) wsum[threadIdx.x >> 5] = a;
  __syncthreads();
  float c = 0.0f;
  for (int w = 0; w < kThreads / 32; ++w) c = __fadd_rn(c, wsum[w]);
  __syncthreads();  // wsum is reused by the next row
  return c;
}

// The barrier around the rotation phase: the cluster's, or (revisit, no
// cluster) the block's own.
template <bool kLocal>
__device__ __forceinline__ void rows_sync() {
  if constexpr (kLocal) __syncthreads();
  else cg::this_cluster().sync();
}

// One block of K4 / K5 / K6 / K6s (kAbft = false) or of their ABFT twins
// K7a-ro / K7a-s / K7b / K7b-s (kAbft = true): rows [row0, row0 + BM) of
// expert e (dense: e = 0, E = cap = 1) against this block's run of column
// tiles. The twins compute the outputs with the same operations in the
// same order, so out is bitwise the unverified kernel's; besides, each
// row's checksum chk = op . cw (in the rotation phase, cw read from global
// memory: under the streamed schedule it never passes through the ring),
// each block's per-row sum of its f32 contributions (tile by tile, each
// tile's 32 columns in order), and, in the last block of the row block to
// finish, r = (the blocks' sums in split order) - s * chk.
template <typename T, int BM, bool kInt, bool kStreamed, bool kAbft, bool kRevisit>
__device__ __forceinline__ void quant_dot_block(const T* x, const uint8_t* wq, const float* sw,
                                                T* out, long long m, int n, int d, int E,
                                                int cap, int e, int r, int cd, float scale,
                                                int mode, int tiles_per_block, int vec,
                                                Abft ab) {
  using Acc = typename std::conditional<kInt, int, float>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const int np4 = op_stride(n);
  const int lg = __ffs(n) - 1;  // n is a power of 2
  const int rw = work_rows(n, BM, kInt, kStreamed, kAbft);
  unsigned char* op = smem;  // BM x np4 int8, or BM x np4 bf16 bits
  uint32_t* ring = reinterpret_cast<uint32_t*>(smem + op_bytes(n, BM, kInt));
  float* work = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(ring) +
                                         ring_bytes(kStreamed));
  float* s_row = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(work) +
                                          work_bytes(n, BM, rw));
  int* amax = reinterpret_cast<int*>(s_row + BM);
  float* chk = reinterpret_cast<float*>(amax + rw);  // ABFT: BM checksums,
  float* tile_c = chk + BM;                          // BM x kBN contributions,
  float* wsum = tile_c + BM * kBN;                   // kThreads / 32 warp sums,
  int* last = reinterpret_cast<int*>(wsum + kThreads / 32);  // the last-block flag
  wq += (size_t)e * n * d;  // expert e's weight and scales
  sw += (size_t)e * d;

  // this thread's share of the contraction: k-chunk [kb, ke) of columns
  // j .. j + 3 of every tile in [t0, t1)
  const int tiles = (d + kBN - 1) / kBN;
  const int t0 = blockIdx.y * tiles_per_block;
  const int t1 = t0 + tiles_per_block < tiles ? t0 + tiles_per_block : tiles;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cq = lane & (kCQ - 1), ks = warp * 4 + (lane >> 3);
  int chunk = (np4 + kKS - 1) / kKS;
  chunk = (chunk + 3) & ~3;
  const int kb = ks * chunk;
  const int ke = kb + chunk < np4 ? kb + chunk : np4;
  const int steps = ke > kb ? (ke - kb + kStepRows - 1) / kStepRows : 0;
  const int items = (t1 > t0 ? t1 - t0 : 0) * steps;  // k-steps of the whole run
  KStep w{wq, n, d, 0, ke, vec != 0};
  auto fetch = [&](int item) {  // streamed: k-step `item` into its ring stage
    KStep at = w;
    at.j = (t0 + item / steps) * kBN + cq * 4;
    at.fetch(kb + (item % steps) * kStepRows,
             ring + (size_t)(item % kStages) * kStepRows * kThreads);
  };
  if constexpr (kStreamed) {
    // warm-up: the first kStages - 1 k-steps fly while the rows rotate
#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) {
      if (i < items) fetch(i);
      cp_async_commit();
    }
  }

  // ---- rotate + quantize the row block once per cluster: the blocks of a
  // cluster (consecutive column splits of one row block) each rotate
  // BM / csize of the rows, rw at a time, and store the quantized rows and
  // their scales into the shared memory of every member. Revisit: no
  // cluster, the block rotates every row itself.
  constexpr int kMembers = kRevisit ? 1 : kMaxCluster;
  int csize = 1, crank = 0;
  if constexpr (!kRevisit) {
    csize = (int)cg::this_cluster().num_blocks();
    crank = (int)cg::this_cluster().block_rank();
  }
  const long long row0 = (long long)blockIdx.x * BM;
  const int rows = (int)(m - row0 < BM ? m - row0 : BM);
  const int mine0 = crank * (BM / csize);
  const int mine1 = mine0 + BM / csize < rows ? mine0 + BM / csize : rows;
  unsigned char* op_at[kMembers];
  float* s_at[kMembers];
  float* chk_at[kMembers];
#pragma unroll
  for (int c = 0; c < kMembers; ++c) {
    op_at[c] = op;
    s_at[c] = s_row;
    chk_at[c] = chk;
    if constexpr (!kRevisit) {
      if (c < csize) {
        op_at[c] = cg::this_cluster().map_shared_rank(op, c);
        s_at[c] = cg::this_cluster().map_shared_rank(s_row, c);
        if constexpr (kAbft) chk_at[c] = cg::this_cluster().map_shared_rank(chk, c);
      }
    }
  }
  auto rotate_rows = [&]() {
    rows_sync<kRevisit>();  // every member runs before anyone writes into it
    for (int g = mine0; g < mine1; g += rw) {
      const int nr = mine1 - g < rw ? mine1 - g : rw;
      quant::rotate_rows_absmax_at<T>(
          [=](int i) { return x + row_index(row0 + g + i, E, cap, e) * n; }, work, amax, nr, n,
          r, cd, scale);
#if defined(REPRO_COUNT_ROTATIONS)
      for (int i = threadIdx.x; i < nr; i += blockDim.x)
        count_rotation(row_index(row0 + g + i, E, cap, e));
#endif
      for (int i = threadIdx.x; i < nr; i += blockDim.x) {
        const float s = quant::row_scale(__int_as_float(amax[i]), mode);
#pragma unroll
        for (int c = 0; c < kMembers; ++c)
          if (c < csize) s_at[c][g + i] = s;
      }
      __syncthreads();
      for (int i = threadIdx.x; i < nr * n; i += blockDim.x) {
        const int rr = i >> lg, k = i & (n - 1);
        const float q = quant::to_grid(work[i], s_row[g + rr], mode);
        const size_t at = (size_t)(g + rr) * np4 + k;
#pragma unroll
        for (int c = 0; c < kMembers; ++c) {
          if (c >= csize) break;
          if constexpr (kInt) {
            op_at[c][at] = (uint8_t)(int8_t)(int)q;
          } else {
            reinterpret_cast<uint16_t*>(op_at[c])[at] =
                __bfloat16_as_ushort(__float2bfloat16_rn(q));  // exact: q is on the fp8 grid
          }
        }
      }
      __syncthreads();
      if constexpr (kAbft) {
        // this member's rows are in its own operand too: their checksums,
        // into every member's chk
        for (int i = 0; i < nr; ++i) {
          const float c =
              row_check<kInt>(op + (size_t)(g + i) * np4 * (kInt ? 1 : 2), ab.cw + (size_t)e * n,
                              n, wsum);
          if (threadIdx.x == 0) {
#pragma unroll
            for (int cc = 0; cc < kMembers; ++cc)
              if (cc < csize) chk_at[cc][g + i] = c;
          }
        }
      }
    }
    // zero the masked rows, and the padding of rows shorter than a word
    for (int i = rows * np4 + threadIdx.x; i < BM * np4; i += blockDim.x) {
      if constexpr (kInt) op[i] = 0;
      else reinterpret_cast<uint16_t*>(op)[i] = 0;
    }
    if (n < 4) {
      for (int i = threadIdx.x; i < rows * 4; i += blockDim.x) {
        if ((i & 3) < n) continue;
        if constexpr (kInt) op[i] = 0;
        else reinterpret_cast<uint16_t*>(op)[i] = 0;
      }
    }
    rows_sync<kRevisit>();  // every member's rows and scales are in place
  };
#if !defined(REPRO_MUTANT_UNGUARDED_ROTATE)
  rotate_rows();
#endif

  // ---- contract the operand with this block's run of column tiles
  Acc* red = reinterpret_cast<Acc*>(work);
  float rowacc = 0.0f;  // ABFT: thread i < BM's running sum of row i
  int item = 0;
#if defined(REPRO_MUTANT_UNGUARDED_ROTATE)
  // M1: the row block is rotated and quantized again before every tile.
  // Every member walks tiles_per_block tiles, real or not, so the cluster's
  // barriers inside rotate_rows stay matched.
  for (int t = t0; t < t0 + tiles_per_block; ++t) {
    rotate_rows();
    if (t >= t1) continue;
#else
  for (int t = t0; t < t1; ++t) {
#endif
    w.j = t * kBN + cq * 4;
    Acc acc[BM][4];
#pragma unroll
    for (int i = 0; i < BM; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] = 0;
    for (int k0 = kb; k0 < ke; k0 += kStepRows, ++item) {
      // 16 weight words per k-step: rotate-once issues their loads
      // together before using any; streamed issues the copies of the
      // k-step kStages - 1 ahead, then waits for this one's
      uint32_t wv[kStepRows];
      if constexpr (kStreamed) {
        if (item + kStages - 1 < items) fetch(item + kStages - 1);
        cp_async_commit();
#if !defined(REPRO_MUTANT_DANGLING_DMA)
        cp_async_wait<kStages - 1>();
#endif
        const uint32_t* stage = ring + (size_t)(item % kStages) * kStepRows * kThreads;
#pragma unroll
        for (int u = 0; u < kStepRows; ++u) wv[u] = stage[u * kThreads + threadIdx.x];
      } else {
        w.load(k0, wv);
      }
#pragma unroll
      for (int st = 0; st < kSteps; ++st) {
        const int k = k0 + 4 * st;
        if (k >= ke) break;
        contract4<BM, kInt>(acc, wv + 4 * st, op, k, np4, mode);
      }
    }
    // the warp adds its 4 k-chunks ((0 + 1) + (2 + 3), lanes 8 apart), then
    // the kKW warp sums are added in warp order: a fixed order
#pragma unroll
    for (int i = 0; i < BM; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        Acc v = acc[i][c];
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (lane < kCQ) red[(warp * BM + i) * kBN + cq * 4 + c] = v;
      }
    __syncthreads();
    for (int o = threadIdx.x; o < BM * kBN; o += blockDim.x) {
      const int i = o / kBN, col = t * kBN + (o - i * kBN);
      Acc sum = 0;
      for (int kw = 0; kw < kKW; ++kw) sum += red[(kw * BM + i) * kBN + (o - i * kBN)];
      float contrib = 0.0f;
      if (i < rows && col < d) {
        float v;
        if constexpr (kInt) v = __int2float_rn(sum);
        else v = sum;
        contrib = __fmul_rn(__fmul_rn(v, s_row[i]), sw[col]);
        out[row_index(row0 + i, E, cap, e) * d + col] = hadacore::from_float<T>(contrib);
      }
      if constexpr (kAbft) tile_c[o] = contrib;
    }
    __syncthreads();
    if constexpr (kAbft) {
      // read before the next tile's contributions: those are written only
      // after the barrier that follows its partial sums
      if (threadIdx.x < BM) {
        float a = 0.0f;
        for (int c = 0; c < kBN; ++c) a = __fadd_rn(a, tile_c[threadIdx.x * kBN + c]);
        rowacc = __fadd_rn(rowacc, a);
      }
    }
  }
#if !defined(REPRO_MUTANT_DANGLING_DMA)
  if constexpr (kStreamed) cp_async_wait<0>();  // only empty groups remain
#endif

  if constexpr (kAbft) {
    // ---- the residual: every block of the row block writes its row sums,
    // then the last to arrive adds them in split order
    const size_t grp = (size_t)e * gridDim.x + blockIdx.x;
    const int splits = (int)gridDim.y;
    if (threadIdx.x < BM) {
      ab.part[(grp * splits + blockIdx.y) * BM + threadIdx.x] = rowacc;
      __threadfence();
    }
    __syncthreads();
    if (threadIdx.x == 0) *last = atomicAdd(ab.count + grp, 1u) == (unsigned)(splits - 1);
    __syncthreads();
    if (*last) {
      __threadfence();
      if (threadIdx.x < rows) {
        float a = 0.0f;
        for (int sp = 0; sp < splits; ++sp)
          a = __fadd_rn(a, __ldcg(ab.part + (grp * splits + sp) * BM + threadIdx.x));
        ab.resid[row_index(row0 + threadIdx.x, E, cap, e)] =
            __fsub_rn(a, __fmul_rn(s_row[threadIdx.x], chk[threadIdx.x]));
      }
      if (threadIdx.x == 0) ab.count[grp] = 0u;
    }
  }
}

template <typename T, int BM, bool kInt, bool kStreamed, bool kAbft, bool kRevisit>
__global__ void __launch_bounds__(kThreads)
    quant_dot_kernel(const T* x, const uint8_t* wq, const float* sw, T* out, long long m,
                     int n, int d, int r, int cd, float scale, int mode, int tiles_per_block,
                     int vec, Abft ab) {
  quant_dot_block<T, BM, kInt, kStreamed, kAbft, kRevisit>(x, wq, sw, out, m, n, d, 1, 1, 0, r,
                                                           cd, scale, mode, tiles_per_block,
                                                           vec, ab);
}

template <typename T, int BM, bool kInt, bool kStreamed, bool kAbft>
__global__ void __launch_bounds__(kThreads)
    quant_dot_experts_kernel(const T* x, const uint8_t* wq, const float* sw, T* out,
                             long long m, int n, int d, int E, int cap, int r, int cd,
                             float scale, int mode, int tiles_per_block, int vec, Abft ab) {
  quant_dot_block<T, BM, kInt, kStreamed, kAbft, false>(x, wq, sw, out, m, n, d, E, cap,
                                                        (int)blockIdx.z, r, cd, scale, mode,
                                                        tiles_per_block, vec, ab);
}

// SM count of the current device, read once (0 when it cannot be read).
int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 0;
  }
  return sms;
}

// The row tile: the largest of 16, 8, 4, 2, 1 rows that the call needs and
// that fits the shared-memory limit; 0 when not even one row fits.
int pick_bm(long long m, int n, bool is_int, bool streamed, bool abft) {
  int bm = 16;
  while (bm > 1 && bm / 2 >= m) bm /= 2;
  while (bm >= 1 && smem_bytes(n, bm, is_int, streamed, abft) > kSmemLimit) bm /= 2;
  return bm;
}

// The grid of a call with bm rows per block over `experts` experts (1 for
// the dense kernels): row blocks x column splits x experts. The splits aim
// at one wave: as many blocks as fit on the SMs at once (two per SM at
// decode's 98 KB, one above 113 KB), so no block waits for a second wave
// while every split repeats the rotation. They are a multiple of the
// cluster size (the largest power of 2 up to 8 that divides the rows among
// the blocks and does not exceed the splits), rounded down, and the tiles
// are spread evenly over them. Revisit (block_n > 0): one split per weight
// tile of block_n columns (block_n / 32 tiles each), no cluster.
struct Grid {
  long long row_blocks, splits, tpb;
  int csize;
};

Grid grid_for(long long m, int d, int bm, size_t smem, int experts, int block_n = 0) {
  Grid g;
  g.row_blocks = (m + bm - 1) / bm;
  const long long tiles = (d + kBN - 1) / kBN;
  if (block_n > 0) {
    g.tpb = block_n / kBN;
    g.splits = (tiles + g.tpb - 1) / g.tpb;
    g.csize = 1;
    return g;
  }
  long long per_sm = (long long)(kSmemPerSM / (smem + 1024));  // 1 KB reserved per block
  if (per_sm < 1) per_sm = 1;
  if (per_sm > 2) per_sm = 2;
  const long long target = per_sm * (sm_count() > 0 ? sm_count() : 132);
  long long tpb = (tiles * g.row_blocks * experts + target - 1) / target;
  if (tpb < 1) tpb = 1;
  g.splits = (tiles + tpb - 1) / tpb;
  g.csize = kMaxCluster;
  while (g.csize > 1 && (g.csize > bm || g.csize > g.splits)) g.csize /= 2;
  g.splits = g.splits / g.csize * g.csize;
  g.tpb = (tiles + g.splits - 1) / g.splits;
  return g;
}

template <typename T, int BM, bool kInt, bool kStreamed, bool kExperts, bool kAbft,
          bool kRevisit>
int launch_bm(const void* x, const void* wq, const void* sw, void* out, long long m, int n,
              int d, int experts, int cap, int block_n, int r, int cd, float scale, int mode,
              Abft ab, cudaStream_t stream) {
  const size_t smem = smem_bytes(n, BM, kInt, kStreamed, kAbft);
  const Grid g = grid_for(m, d, BM, smem, experts, kRevisit ? block_n : 0);
  if (g.row_blocks > 0x7fffffffLL || g.splits > 65535 || experts > 65535)
    return (int)cudaErrorInvalidConfiguration;
  const int vec = (d % 4 == 0) && (reinterpret_cast<uintptr_t>(wq) % 4 == 0);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)g.row_blocks, (unsigned)g.splits, (unsigned)experts);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = (unsigned)g.csize;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = kRevisit ? 0 : 1;  // revisit: no cluster
  const T* xt = static_cast<const T*>(x);
  const uint8_t* w8 = static_cast<const uint8_t*>(wq);
  const float* s32 = static_cast<const float*>(sw);
  T* o = static_cast<T*>(out);
  cudaError_t e;
  if constexpr (kExperts) {
    auto kernel = quant_dot_experts_kernel<T, BM, kInt, kStreamed, kAbft>;
    static_assert(!kRevisit, "the expert grid has no revisit schedule");
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    e = cudaLaunchKernelEx(&cfg, kernel, xt, w8, s32, o, m, n, d, experts, cap, r, cd, scale,
                           mode, (int)g.tpb, vec, ab);
  } else {
    auto kernel = quant_dot_kernel<T, BM, kInt, kStreamed, kAbft, kRevisit>;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    e = cudaLaunchKernelEx(&cfg, kernel, xt, w8, s32, o, m, n, d, r, cd, scale, mode,
                           (int)g.tpb, vec, ab);
  }
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T, bool kInt, bool kStreamed, bool kExperts, bool kAbft, bool kRevisit>
int launch(const void* x, const void* wq, const void* sw, void* out, long long m, int n,
           int d, int experts, int cap, int block_n, int r, int cd, float scale, int mode,
           Abft ab, cudaStream_t s) {
  switch (pick_bm(m, n, kInt, kStreamed, kAbft)) {
#define QD_CASE(BM)                                                                         \
  case BM:                                                                                  \
    return launch_bm<T, BM, kInt, kStreamed, kExperts, kAbft, kRevisit>(                    \
        x, wq, sw, out, m, n, d, experts, cap, block_n, r, cd, scale, mode, ab, s);
    QD_CASE(16)
    QD_CASE(8)
    QD_CASE(4)
    QD_CASE(2)
    QD_CASE(1)
#undef QD_CASE
    default: return (int)cudaErrorInvalidValue;  // the rows do not fit shared memory
  }
}

// Schedule codes of the C interface.
constexpr int kRotateOnce = 0, kStreamedSchedule = 1, kRevisitSchedule = 2;

template <typename T, bool kExperts, bool kAbft>
int launch_io(const void* x, const void* wq, const void* sw, void* out, long long m, int n,
              int d, int experts, int cap, int schedule, int block_n, int r, int cd,
              float scale, int mode, Abft ab, cudaStream_t s) {
  const bool is_int = mode == quant::kInt8;
  if (schedule == kRevisitSchedule) {
    if constexpr (kExperts) {
      return (int)cudaErrorInvalidValue;  // the expert grid has no revisit body
    } else {
      if (is_int)
        return launch<T, true, false, false, kAbft, true>(x, wq, sw, out, m, n, d, experts,
                                                          cap, block_n, r, cd, scale, mode, ab,
                                                          s);
      return launch<T, false, false, false, kAbft, true>(x, wq, sw, out, m, n, d, experts, cap,
                                                         block_n, r, cd, scale, mode, ab, s);
    }
  }
  const bool streamed = schedule == kStreamedSchedule;
  if (is_int && streamed)
    return launch<T, true, true, kExperts, kAbft, false>(x, wq, sw, out, m, n, d, experts, cap,
                                                         0, r, cd, scale, mode, ab, s);
  if (is_int)
    return launch<T, true, false, kExperts, kAbft, false>(x, wq, sw, out, m, n, d, experts,
                                                          cap, 0, r, cd, scale, mode, ab, s);
  if (streamed)
    return launch<T, false, true, kExperts, kAbft, false>(x, wq, sw, out, m, n, d, experts,
                                                          cap, 0, r, cd, scale, mode, ab, s);
  return launch<T, false, false, kExperts, kAbft, false>(x, wq, sw, out, m, n, d, experts, cap,
                                                         0, r, cd, scale, mode, ab, s);
}

// One launch of the dense (kExperts = false: experts = cap = 1) or the
// expert kernel, of the schedule's code (0 rotate-once, 1 streamed, 2
// revisit: dense only, block_n a positive multiple of 32), unverified or
// (kAbft) its ABFT twin; argument checks, then the io dtype.
template <bool kExperts, bool kAbft>
int launch_checked(const void* x, const void* wq, const void* sw, void* out, long long m,
                   int n, int d, int experts, int cap, int schedule, int block_n, int r, int io,
                   int cd, float scale, int mode, Abft ab, void* stream) {
  if (schedule < kRotateOnce || schedule > kRevisitSchedule) return (int)cudaErrorInvalidValue;
  if (schedule == kRevisitSchedule && (block_n <= 0 || block_n % kBN != 0))
    return (int)cudaErrorInvalidValue;
  if (m <= 0 || d <= 0) return 0;
  if (n < 2 || (n & (n - 1)) != 0) return (int)cudaErrorInvalidValue;
  if (mode < quant::kInt8 || mode > quant::kE5M2) return (int)cudaErrorInvalidValue;
  if (experts < 1 || cap < 1 || m % cap != 0) return (int)cudaErrorInvalidValue;
  if (kAbft && !(ab.cw && ab.resid && ab.part && ab.count)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (io) {
    case hadacore::kF32:
      return launch_io<float, kExperts, kAbft>(x, wq, sw, out, m, n, d, experts, cap, schedule,
                                               block_n, r, cd, scale, mode, ab, s);
    case hadacore::kBF16:
      return launch_io<__nv_bfloat16, kExperts, kAbft>(x, wq, sw, out, m, n, d, experts, cap,
                                                       schedule, block_n, r, cd, scale, mode,
                                                       ab, s);
    case hadacore::kF16:
      return launch_io<__half, kExperts, kAbft>(x, wq, sw, out, m, n, d, experts, cap,
                                                schedule, block_n, r, cd, scale, mode, ab, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The launch geometry of a call (the wrappers' launch_shape and the
// linter's rotate-once rule): out = {rows per block, dynamic shared bytes,
// row blocks, column splits, tiles per block, cluster size (1 under
// revisit)}. Nonzero when it does not fit.
inline int launch_grid(long long m, int n, int d, int experts, int schedule, int block_n,
                       int mode, bool abft, long long* out) {
  const bool is_int = mode == quant::kInt8;
  const bool streamed = schedule == kStreamedSchedule;
  const int bm = pick_bm(m, n, is_int, streamed, abft);
  if (bm == 0) return 1;
  if (schedule == kRevisitSchedule && (block_n <= 0 || block_n % kBN != 0)) return 1;
  const size_t smem = smem_bytes(n, bm, is_int, streamed, abft);
  const Grid g = grid_for(m, d, bm, smem, experts, schedule == kRevisitSchedule ? block_n : 0);
  out[0] = bm;
  out[1] = (long long)smem;
  out[2] = g.row_blocks;
  out[3] = g.splits;
  out[4] = g.tpb;
  out[5] = schedule == kRevisitSchedule ? 1 : g.csize;
  return 0;
}

// The kernel function of one instantiation, and of a call's (rows per block
// bm, schedule, mode), for cudaFuncGetAttributes.
template <typename T, int BM, bool kInt, bool kStreamed, bool kExperts, bool kAbft,
          bool kRevisit>
const void* kernel_ptr() {
  if constexpr (kExperts)
    return reinterpret_cast<const void*>(quant_dot_experts_kernel<T, BM, kInt, kStreamed, kAbft>);
  else
    return reinterpret_cast<const void*>(
        quant_dot_kernel<T, BM, kInt, kStreamed, kAbft, kRevisit>);
}

template <typename T, bool kInt, bool kStreamed, bool kExperts, bool kAbft, bool kRevisit>
const void* kernel_for_bm(int bm) {
  switch (bm) {
    case 16: return kernel_ptr<T, 16, kInt, kStreamed, kExperts, kAbft, kRevisit>();
    case 8: return kernel_ptr<T, 8, kInt, kStreamed, kExperts, kAbft, kRevisit>();
    case 4: return kernel_ptr<T, 4, kInt, kStreamed, kExperts, kAbft, kRevisit>();
    case 2: return kernel_ptr<T, 2, kInt, kStreamed, kExperts, kAbft, kRevisit>();
    case 1: return kernel_ptr<T, 1, kInt, kStreamed, kExperts, kAbft, kRevisit>();
    default: return nullptr;
  }
}

template <typename T, bool kExperts, bool kAbft>
const void* kernel_for_io(int bm, int schedule, int mode) {
  const bool is_int = mode == quant::kInt8;
  if (schedule == kRevisitSchedule) {
    if constexpr (kExperts) {
      return nullptr;
    } else {
      return is_int ? kernel_for_bm<T, true, false, false, kAbft, true>(bm)
                    : kernel_for_bm<T, false, false, false, kAbft, true>(bm);
    }
  }
  if (schedule == kStreamedSchedule)
    return is_int ? kernel_for_bm<T, true, true, kExperts, kAbft, false>(bm)
                  : kernel_for_bm<T, false, true, kExperts, kAbft, false>(bm);
  return is_int ? kernel_for_bm<T, true, false, kExperts, kAbft, false>(bm)
                : kernel_for_bm<T, false, false, kExperts, kAbft, false>(bm);
}

// cudaFuncGetAttributes of f into out = {bm, static shared bytes, the
// largest dynamic shared memory it may take (what its last launch set),
// registers per thread, local bytes per thread}.
inline int func_attributes(const void* f, int bm, long long* out) {
  if (!f) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, f);
  if (e != cudaSuccess) return (int)e;
  out[0] = bm;
  out[1] = (long long)a.sharedSizeBytes;
  out[2] = a.maxDynamicSharedSizeBytes;
  out[3] = a.numRegs;
  out[4] = (long long)a.localSizeBytes;
  return 0;
}

// The attributes of the instantiation a call of m rows launches.
template <bool kExperts, bool kAbft>
int kernel_attributes(long long m, int n, int schedule, int io, int mode, long long* out) {
  if (mode < quant::kInt8 || mode > quant::kE5M2 || schedule < kRotateOnce ||
      schedule > kRevisitSchedule)
    return (int)cudaErrorInvalidValue;
  const int bm = pick_bm(m, n, mode == quant::kInt8, schedule == kStreamedSchedule, kAbft);
  switch (io) {
    case hadacore::kF32:
      return func_attributes(kernel_for_io<float, kExperts, kAbft>(bm, schedule, mode), bm, out);
    case hadacore::kBF16:
      return func_attributes(kernel_for_io<__nv_bfloat16, kExperts, kAbft>(bm, schedule, mode),
                             bm, out);
    case hadacore::kF16:
      return func_attributes(kernel_for_io<__half, kExperts, kAbft>(bm, schedule, mode), bm, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

#if defined(REPRO_COUNT_ROTATIONS)
// The first `rows` rotation counters into host memory, and the count of
// rotations of rows past the array.
inline int rotation_counts(unsigned int* host, long long rows, unsigned int* lost) {
  if (rows < 0 || rows > kCountRows) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess && rows > 0)
    e = cudaMemcpyFromSymbol(host, g_rotations, (size_t)rows * sizeof(unsigned int));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(lost, g_rotations_lost, sizeof(unsigned int));
  return (int)e;
}

// Every counter to 0.
inline int rotation_reset() {
  void* p = nullptr;
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess) e = cudaGetSymbolAddress(&p, g_rotations);
  if (e == cudaSuccess) e = cudaMemset(p, 0, sizeof(g_rotations));
  if (e == cudaSuccess) e = cudaGetSymbolAddress(&p, g_rotations_lost);
  if (e == cudaSuccess) e = cudaMemset(p, 0, sizeof(unsigned int));
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  return (int)e;
}
#define QUANT_DOT_COUNT_EXPORTS(prefix)                                                     \
  extern "C" int prefix##_rotations(unsigned int* host, long long rows, unsigned int* lost) { \
    return rotation_counts(host, rows, lost);                                               \
  }                                                                                         \
  extern "C" int prefix##_rotations_reset() { return rotation_reset(); }
#else
#define QUANT_DOT_COUNT_EXPORTS(prefix)
#endif

}  // namespace

// The queries of one source's kernels: the launch geometry of a call
// (experts: the expert count, m the rows of one expert; schedule 0
// rotate-once, 1 streamed, 2 revisit), and for the linter
// (repro_torch/analysis) the attributes of the instantiation it launches
// and, in the builds with REPRO_COUNT_ROTATIONS, the rotation counters.
#define QUANT_DOT_LINT_EXPORTS(prefix, kExperts, kAbft)                                      \
  extern "C" int prefix##_grid(long long m, int n, int d, int experts, int schedule,         \
                               int block_n, int mode, long long* out) {                      \
    return launch_grid(m, n, d, (kExperts) ? experts : 1, schedule, block_n, mode, (kAbft),  \
                       out);                                                                 \
  }                                                                                          \
  extern "C" int prefix##_attributes(long long m, int n, int schedule, int io, int mode,     \
                                     long long* out) {                                       \
    return kernel_attributes<(kExperts), (kAbft)>(m, n, schedule, io, mode, out);            \
  }                                                                                          \
  QUANT_DOT_COUNT_EXPORTS(prefix)
