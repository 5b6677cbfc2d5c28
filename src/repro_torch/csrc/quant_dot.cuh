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
// once to the io dtype. An all-zero row has absmax 0, scale 1e-8 / qmax and
// q = 0: its outputs are exact zeros.
//
// The contraction runs on the tensor cores: mma.sync m16n8k32 with 8-bit
// operands, s8 x s8 -> s32 for int8 and e4m3 / e5m2 -> f32 for fp8 (Hopper
// lowers the fp8 mma.sync to fp8 -> f16 conversions and f16 MMAs, as its
// SASS shows, PERF.md PR 17; the rate it reaches beside int8's is not
// measured). Not wgmma: Hopper's 8-bit wgmma takes only K-major operands
// from shared memory, and the weight is stored (n, d) with d contiguous
// (N-major). The weight columns are the MMA's A operand (M = 16 output
// columns) and the quantized rows its B operand (N = 8 rows): a decode step
// has 4 rows, so this orientation wastes half of each instruction where the
// other would waste three quarters. A lane reads 8 words of a staged weight
// block (4 columns of 8 consecutive k) and transposes them with byte
// permutes into two 4 x 4 blocks: each word then holds 4 consecutive k of
// one column, an A fragment register. Its B fragment is 8 consecutive k of
// one row, one 8-byte shared load. Within an MMA, logical k 4t..4t+3 is k
// 8t..8t+3 of the step and logical 16+4t.. is 8t+4.., the same permutation
// for both operands, so the products pair as they should.
//   int8: exact int32 accumulation on the tensor core (n <= 32768, so
//         |sum| <= 127^2 * 2^15 < 2^31), converted with __int2float_rn as XLA
//         converts -- the result equals the plain version bitwise whenever
//         the two rotations agree;
//   fp8:  the products of two fp8 values are exact, but the tensor core
//         does not accumulate in IEEE f32. So it sums at most 128 k (C
//         carried over at most 4 instructions, a "chunk"); the chunks are
//         added into f32 registers with __fadd_rn in k order from zero: one
//         fixed order for every schedule, split and run. The output is within
//         2^-7 of the row max of the plain GEMM (chip_smoke.py), no longer
//         bitwise the CUDA-core FMA sum of earlier versions.
//
// Experts (K6, K6s). x is (B, E, c, n), the dispatched activations; wq is
// (E, n, d) and sw (E, d); out is (B, E, c, d). blockIdx.z is the expert:
// its weight and scale pointers are offset by it, and its m = B * c rows are
// read in the reference's expert-major order (row r is x[r / c, e, r % c])
// through their strides, in place, and written back the same way. With
// E = c = 1 the expert kernel's body is the dense kernel's.
//
// Bounds on an H100. At decode, bytes: the weight is read once (K6 at
// llama4-maverick's 128 x 8192 x 5120 fp8: 5.37 GB, 1.60 ms at 3.35 TB/s)
// against 2 * rows * n * d operations; K4 / K5 at a dense decode site read
// 25-42 MB, and the rotation of a few rows and the launch weigh as much.
// At training rows (2048 x 8192 -> 3072), operations: 103 G, 0.052 ms at
// 1979 TOP/s; a block keeps 16 rows, so each weight byte fetched from L2
// serves 16 rows, and the L2 -> SM feed and the rotation bound the kernel
// long before the tensor cores do. The design keeps the rotated, quantized
// rows in shared memory (1 byte a value, fp8 as its storage byte) and
// streams the weight past them, so the activations never round-trip
// through HBM.
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
// each output's sum runs in a fixed order).
//
// Work of a block: its tiles in rounds. A whole round gives each of the 16
// warps one tile over the full k range (two m16 column halves x ceil(BM / 8)
// n8 row groups of MMAs), with no reduction across warps: its outputs leave
// from the warp's registers. The tiles left (fewer than 16) go one per
// split round, in which the warps share the tile's k range. A tile's
// k-steps fall in groups, each summed from zero and the groups' sums added
// in group order: int8 the 16 k-slices (exact, so a whole round's tensor
// core simply carries one sum over the tile), fp8 the 128-k chunks (so a
// whole round's warp holds only the tile's f32 sums and one chunk's). In a
// split round warp w takes groups w, w + 16, ... (int8: its slice; fp8 at n
// = 8192: 4 chunks, one per pass), and the threads of the block add the
// groups' partial sums through shared memory in group order. Both kinds of
// round give the same bits. Rows beyond m and columns beyond d are masked;
// neither input is padded.
//
// Weight reads: 16 bytes a copy. Each quad of 4 warps has a ring of
// kStages k-steps (one k-step: 32 weight rows x 128 columns, 4 KB), filled
// by cp.async.cg of 16 bytes (zero-filled past n and d; synchronous loads
// when d is not a multiple of 16) kStages - 1 k-steps ahead of the
// contraction, across tile and round boundaries. In a whole round the
// quad's 4 adjacent tiles share each stage: each warp copies 8 rows of all
// 128 columns, so a warp's copy instruction covers 4 rows x 128 contiguous
// bytes (on the H100 the L2 delivers whole lines at a much higher rate
// than the 32-byte pieces of one tile's rows); in a split round each
// warp copies its own k-steps of its tile into its quarter of the stage.
// The lanes read words other lanes (or warps) copied, so each k-step
// starts with cp.async.wait_group and the quad's barrier (a named barrier
// of 128 threads) or the warp's; the lanes read the stage and their B
// fragments, then issue the next copy and commit, then run the MMAs. A
// block barrier separates the last whole round from the first split one:
// the first split k-step refills the stage that the quad read last. The
// stages are swizzled so that the 32 words a warp reads at once fall in 32
// banks. Under rotate-once (K4, K6) the ring shares the rotation's work
// area and is filled after the rotation; under the streamed schedule (K5,
// K6s) it has its own shared memory and its first k-steps are issued before
// the rotation, so their latency hides behind it (the reference's j == 0
// warm-up). A copy is issued only for a k-step that exists (the reference's
// j + 1 < nj guard) and the ring drains before the block ends. Both
// schedules contract the same words in the same order, so they give the
// same bits.
//
// Shared memory: the operand (BM rows of n bytes, padded so the 8 rows an
// MMA reads start in distinct banks), the ring (streamed only: 4 quads x
// kStages x 4 KB), a work area that holds the f32 rows being rotated (all
// BM rows at once when they fit, else rw at a time) and later the split
// rounds' partial sums and, under rotate-once, the ring; the scales. BM is
// the largest of 16, 8, 4, 2, 1 that the rows need and the 227 KB limit
// allows (n = 8192: 16 rows under both schedules, int8 and fp8 alike); a
// launch that cannot fit returns an error, which the wrapper raises. 512
// threads: the rotation's barrier-separated stages are latency-bound at one
// block per SM, so more warps hide more of it.
//
// ABFT twins (kAbft). Three additions, none on the output's path: (a) in
// the rotation phase each cluster member sums chk = op . cw for the rows it
// rotates (f32, a fixed order; cw, the weight's column checksum, is read
// from global memory and, streamed, never through the ring, so a
// mis-delivered ring stage shows in the residual) and stores it into every
// member, beside the scales; (b) each block sums, per row, the f32
// contributions acc * s * sw that the output casts (tile by tile, each
// tile's columns in order; a whole round's 16 tiles through shared memory
// in tile order); (c) the residual needs every split of the row block: each
// block writes its row sums to a (row block, split) workspace and bumps the
// row block's counter (__threadfence, atomicAdd); the last to arrive adds
// the sums in split order, writes r = sum - s * chk and resets the counter
// to 0. One launch per site, and the same bits every run (no float
// atomics). The extra shared memory (about 2 KB at 16 rows) leaves the rows
// per block of every n the kernels serve unchanged; the outputs would not
// depend on them anyway (each output's sum has a fixed order).
//
// Revisit schedule (K8, K7a-rv; kRevisit). The reference's A/B baseline for
// rotate-once: the grid is (row blocks) x (column tiles of block_n), with no
// thread-block cluster and no distributed shared memory. Every block
// rotates and quantizes its WHOLE row block into its own shared memory and
// contracts it with its one weight tile of block_n columns (block_n / 32 of
// the 32-column tiles, split rounds), so a row is rotated ceil(d / block_n)
// times -- the redundancy the schedule exists to show. The rotation, the
// quantization, the contraction and its k-order are the rotate-once code's,
// so K8's output is bitwise K4's; the shared-memory layout is K4's too (K4's
// blocks also hold every row of the row block), so are the rows per block.
// K7a-rv is K8 with kAbft: each block's row sums go to the (row block, tile)
// workspace and the last block of a row block adds them in tile order.
//
// Linter builds (repro_torch/analysis). With -DREPRO_COUNT_ROTATIONS the body
// counts, per element row of x, how often a rotation phase rotated it
// (g_rotations: one atomicAdd per row and phase, read and zeroed through the
// sources' *_rotations exports); without it the code is unchanged. The
// mutants of csrc/mutants/ define REPRO_MUTANT_UNGUARDED_ROTATE (M1: the
// rotation runs again before every round, which is every tile where the
// tiles are split, and the ring restarts after it) or
// REPRO_MUTANT_DANGLING_DMA (M2: the ring's final drain, cp.async.wait_group
// 0 before the block ends, is gone) before including this header; no main
// source defines either.
//
// What this version leaves on the table: wgmma (the full tensor rate, int8
// and fp8 alike; what mma.sync reaches on Hopper is not measured) with TMA
// bulk copies, mbarriers, warp-specialised producers and a deeper ring (they need a
// K-major copy of the weight or a transpose in shared memory), and TMA
// multicast of a weight tile to the row blocks of a cluster (each weight
// byte from L2 serves only 16 rows at training sizes); the rotation on
// CUDA-core f32 butterflies (K1's code: about 30% of K4's time at 2048
// rows, PERF.md) rather than the paper's tensor-core form; the
// rotation repeated in every cluster; and the all-zero rows of a dense MoE
// dispatch rotated and contracted like any other (K6 streams the weights of
// experts that only multiply zeros).
#pragma once

#include <cooperative_groups.h>
#include <cuda_fp8.h>

#include <type_traits>

#include "quant.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBN = 32;                    // output columns per tile (one warp's in a whole round)
constexpr int kKStep = 32;                 // k per MMA (m16n8k32)
constexpr int kSlices = kWarps;            // int8: a tile's k-slices (one per warp when split)
constexpr int kChunkSteps = 4;             // fp8: k-steps summed on the tensor core (128 k)
constexpr int kStageBytes = kKStep * kBN;  // one warp's k-step of weight: 32 rows x 32 columns
constexpr int kStages = 4;                 // k-steps in a ring (a power of 2)
constexpr int kQuad = 4;                   // warps whose whole-round tiles share a stage
constexpr int kMaxCluster = 8;             // blocks sharing one row block's rotation (portable max)
constexpr size_t kSmemLimit = 232448;      // 227 KB, the per-block maximum on sm_90
constexpr size_t kSmemPerSM = 233472;      // 228 KB of shared memory on an SM

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

// The contraction's k extent: n, at least one MMA's k (zeros beyond n).
__host__ __device__ __forceinline__ int k_extent(int n) { return n < kKStep ? kKStep : n; }

// Operand row stride in bytes: the k extent rounded up to 128, plus 32, so
// the 8 rows of a B fragment start 8 banks apart.
__host__ __device__ __forceinline__ int op_stride(int n) {
  return (k_extent(n) + 127) / 128 * 128 + 32;
}

__host__ __device__ __forceinline__ size_t op_bytes(int n, int bm) {
  return (size_t)bm * op_stride(n);
}

// The quads' rings, kStages k-steps of 4 KB each.
__host__ __device__ __forceinline__ size_t ring_bytes() {
  return (size_t)kWarps * kStages * kStageBytes;
}

// A split round's partial sums (one tile's per warp of a pass), and a whole
// round's ABFT contributions (one tile's per warp).
__host__ __device__ __forceinline__ size_t red_bytes(int bm) {
  return (size_t)kSlices * bm * kBN * sizeof(float);
}

// The work area: rw f32 rows being rotated, later the partial sums and,
// under rotate-once, the ring.
__host__ __device__ __forceinline__ size_t work_bytes(int n, int bm, int rw, bool streamed) {
  const size_t rot = (size_t)rw * n * sizeof(float);
  const size_t con = red_bytes(bm) + (streamed ? 0 : ring_bytes());
  return rot > con ? rot : con;
}

// ABFT twins only: each row's activation checksum, the f32 contributions
// of one output tile, one partial sum per warp and the last-block flag.
__host__ __device__ __forceinline__ size_t abft_bytes(int bm, bool abft) {
  return abft ? (size_t)(bm + bm * kBN + kWarps + 1) * sizeof(float) : 0;
}

// Shared memory of a block of bm rows that rotates rw rows at a time: the
// operand, the ring (streamed), the work area, bm scales, rw absmax words
// and the ABFT scratch.
__host__ __device__ __forceinline__ size_t layout_bytes(int n, int bm, int rw, bool streamed,
                                                        bool abft) {
  return op_bytes(n, bm) + (streamed ? ring_bytes() : 0) + work_bytes(n, bm, rw, streamed) +
         (size_t)bm * sizeof(float) + (size_t)rw * sizeof(int) + abft_bytes(bm, abft);
}

// Rows rotated at once: all bm when they fit, else the most (a power of 2)
// that do. More rows per group means fewer barriers per row.
__host__ __device__ __forceinline__ int work_rows(int n, int bm, bool streamed, bool abft) {
  int rw = bm;
  while (rw > 1 && layout_bytes(n, bm, rw, streamed, abft) > kSmemLimit) rw /= 2;
  return rw;
}

__host__ __device__ __forceinline__ size_t smem_bytes(int n, int bm, bool streamed, bool abft) {
  return layout_bytes(n, bm, work_rows(n, bm, streamed, abft), streamed, abft);
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

// The fp8 byte b as f32 (exact: every e4m3 and e5m2 value is an f16 value;
// e5m2 is the high byte of its f16 encoding).
__device__ __forceinline__ float fp8_to_float(uint8_t b, int mode) {
  if (mode == quant::kE4M3)
    return __half2float(__ushort_as_half(
        __nv_cvt_fp8x2_to_halfraw2((__nv_fp8x2_storage_t)b, __NV_E4M3).x));
  return __half2float(__ushort_as_half((unsigned short)((unsigned)b << 8)));
}

// 4 x 4 byte transpose: w[u] holds 4 columns of k-row u; col[c] gets column
// c's bytes of rows 0..3, row 0 in the low byte -- an 8-bit MMA fragment
// register.
__device__ __forceinline__ void transpose4(const uint32_t* w, uint32_t (&col)[4]) {
  const uint32_t lo01 = __byte_perm(w[0], w[1], 0x5140), hi01 = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t lo23 = __byte_perm(w[2], w[3], 0x5140), hi23 = __byte_perm(w[2], w[3], 0x7362);
  col[0] = __byte_perm(lo01, lo23, 0x5410);
  col[1] = __byte_perm(lo01, lo23, 0x7632);
  col[2] = __byte_perm(hi01, hi23, 0x5410);
  col[3] = __byte_perm(hi01, hi23, 0x7632);
}

// D = A B + C on the tensor cores, m16n8k32: A 16 x 32 (row), B 32 x 8
// (col), 8-bit operands.
__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_fp8(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                        uint32_t a3, uint32_t b0, uint32_t b1, int mode) {
  if (mode == quant::kE4M3) {
    asm("mma.sync.aligned.m16n8k32.row.col.f32.e4m3.e4m3.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
        "{%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  } else {
    asm("mma.sync.aligned.m16n8k32.row.col.f32.e5m2.e5m2.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
        "{%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  }
}

// cp.async of 16 bytes into shared memory, zero-filled when src_bytes is 0
// (no byte is read then), and the group bookkeeping around it.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned saddr = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(saddr), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The barrier of the 4 warps of quad q (named barrier 1 + q of 128
// threads; __syncthreads is barrier 0).
__device__ __forceinline__ void quad_sync(int q) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + q), "r"(kQuad * 32) : "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}


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
                                           float* wsum, int mode) {
  float a = 0.0f;
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    float v;
    if constexpr (kInt) v = (float)(int8_t)op_row[k];
    else v = fp8_to_float(op_row[k], mode);
    a = __fadd_rn(a, __fmul_rn(v, __ldg(cw + k)));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) a = __fadd_rn(a, __shfl_xor_sync(0xffffffffu, a, o));
  if ((threadIdx.x & 31) == 0) wsum[threadIdx.x >> 5] = a;
  __syncthreads();
  float c = 0.0f;
  for (int w = 0; w < kWarps; ++w) c = __fadd_rn(c, wsum[w]);
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
  constexpr int NF = (BM + 7) / 8;  // the MMA's n8 row groups
  extern __shared__ __align__(16) unsigned char smem[];
  const int ops = op_stride(n);
  const int lg = __ffs(n) - 1;  // n is a power of 2
  const int rw = work_rows(n, BM, kStreamed, kAbft);
  unsigned char* op = smem;  // BM x ops bytes: int8, or the fp8 storage bytes
  unsigned char* after_op = smem + op_bytes(n, BM);
  float* work = reinterpret_cast<float*>(after_op + (kStreamed ? ring_bytes() : 0));
  float* s_row = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(work) +
                                          work_bytes(n, BM, rw, kStreamed));
  int* amax = reinterpret_cast<int*>(s_row + BM);
  float* chk = reinterpret_cast<float*>(amax + rw);  // ABFT: BM checksums,
  float* tile_c = chk + BM;                          // BM x kBN contributions,
  float* wsum = tile_c + BM * kBN;                   // kWarps warp sums,
  int* last = reinterpret_cast<int*>(wsum + kWarps);  // the last-block flag
  Acc* red = reinterpret_cast<Acc*>(work);  // kSlices x BM x kBN partial sums
  wq += (size_t)e * n * d;  // expert e's weight and scales
  sw += (size_t)e * d;

  // ---- this block's tiles in rounds (see the header): `whole` rounds of
  // one tile per warp over all k-steps, then `rest` split rounds of one
  // tile. A tile's k-steps fall in G groups of gs, each summed from zero:
  // int8 the 16 k-slices (exact, so a whole round's tensor core carries one
  // sum over the tile), fp8 the 128-k chunks the tensor core sums before
  // their f32 promotion. In a split round warp w takes groups w, w + 16,
  // ..., one pass each, and the groups' partial sums are added in group
  // order: the order a whole round adds them in.
  const int t0 = blockIdx.y * tiles_per_block;
#if defined(REPRO_MUTANT_UNGUARDED_ROTATE)
  // M1 walks tiles_per_block tiles, real or not (past d they are masked), so
  // every member of the cluster runs as many rotations and barriers
  const int ntiles = tiles_per_block;
#else
  const int tiles = (d + kBN - 1) / kBN;
  const int ntiles =
      t0 + tiles_per_block < tiles ? tiles_per_block : (tiles > t0 ? tiles - t0 : 0);
#endif
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane >> 2, tig = lane & 3;  // the MMA fragments' row group, lane in group
  const int ksteps = k_extent(n) / kKStep;   // a power of 2
  const int slices = ksteps < kSlices ? ksteps : kSlices;
  const int gs = kInt ? ksteps / slices : (ksteps < kChunkSteps ? ksteps : kChunkSteps);
  const int groups = ksteps / gs, passes = (groups + kWarps - 1) / kWarps;
  const int per_split = warp < groups ? passes * gs : 0;  // k-steps per split round
  const int lks = __ffs(ksteps) - 1, lgs = __ffs(gs) - 1, lps = __ffs(passes * gs) - 1;
  const int whole = ntiles / kWarps, rest = ntiles % kWarps;
  const int wi = whole * ksteps;  // this warp's k-steps in the whole rounds
  const int items = wi + rest * per_split;
  // the ring of this warp's quad (warps 4q .. 4q + 3): kStages stages of
  // 4 KB; in a whole round the quad's four adjacent tiles share each stage
  // (32 rows x 128 columns), in a split round each warp has its quarter
  unsigned char* ring =
      kStreamed ? after_op : reinterpret_cast<unsigned char*>(work) + red_bytes(BM);
  const int quad = warp >> 2, qw = warp & 3;
  unsigned char* ring_q = ring + (size_t)quad * kStages * kQuad * kStageBytes;

  // k-step `it` of this warp's sequence into its ring stage, as two
  // 16-byte copies per lane. Whole rounds: this warp copies rows 8 qw ..
  // 8 qw + 7 of the quad's 128 columns (a warp's copy covers 4 rows x 128
  // contiguous bytes: L2 serves whole lines at a much higher rate than
  // 32-byte pieces), row rr at rr * 128 with its 16-byte chunks XORed
  // by 2 (rr / 8). Split rounds: rows 0..31 of this warp's own 32 columns
  // into its quarter, row rr at slot (rr % 8) * 4 + rr / 8. Either way the
  // 32 words the warp reads at once fall in 32 banks.
  auto fetch = [&](int it) {
    unsigned char* st = ring_q + (it & (kStages - 1)) * kQuad * kStageBytes;
    int k0, j0;
    const bool together = it < wi;
    if (together) {
      k0 = (it & (ksteps - 1)) * kKStep;
      j0 = (t0 + (it >> lks) * kWarps + 4 * quad) * kBN;
    } else {
      const int j = it - wi, jj = j & (passes * gs - 1);  // split round j / (passes gs)
      k0 = (((warp + kWarps * (jj >> lgs)) << lgs) + (jj & (gs - 1))) * kKStep;
      j0 = (t0 + whole * kWarps + (j >> lps)) * kBN;
      st += qw * kStageBytes;
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {  // 64 16-byte chunks per warp, two per lane
      const int c = lane + 32 * q;
      int rr, j;
      unsigned char* dst;
      if (together) {
        rr = 8 * qw + (c >> 3);
        j = j0 + 16 * (c & 7);
        dst = st + rr * (kQuad * kBN) + 16 * ((c & 7) ^ (2 * qw));
      } else {
        rr = c >> 1;
        j = j0 + 16 * (c & 1);
        dst = st + ((rr & 7) * 4 + (rr >> 3)) * kBN + 16 * (c & 1);
      }
      const int k = k0 + rr;
      if (vec == 2) {
        const bool real = k < n && j < d;
        cp_async16(dst, real ? wq + (size_t)k * d + j : wq, real ? 16 : 0);
      } else {
        uint4 v;
        v.x = load_w4(wq, k, j, n, d, vec == 1);
        v.y = load_w4(wq, k, j + 4, n, d, vec == 1);
        v.z = load_w4(wq, k, j + 8, n, d, vec == 1);
        v.w = load_w4(wq, k, j + 12, n, d, vec == 1);
        *reinterpret_cast<uint4*>(dst) = v;
      }
    }
  };
  int next = 0;  // the next k-step to fetch
  // the first kStages - 1 k-steps below lim, one commit group each
  auto prologue = [&](int lim) {
#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) {
      if (next < lim) fetch(next++);
      cp_async_commit();
    }
  };
  if constexpr (kStreamed) prologue(items);  // the warm-up flies while the rows rotate

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
      // the int8 value, or the storage byte of the fp8 grid value (exact;
      // e4m3 by the hardware's conversion, which is exact on the grid: no
      // grid value is out of range, and a NaN stays NaN), 4 consecutive k
      // a word: one 32-bit store into each member
      auto grid_byte = [&](float y, float s) {
        return (uint32_t)quant::encode(quant::to_grid(y, s, mode), mode);
      };
      auto grid_word = [&](float4 v, float s) -> uint32_t {
        if (mode == quant::kE4M3) {
          const float2 lo = make_float2(quant::to_grid(v.x, s, mode), quant::to_grid(v.y, s, mode));
          const float2 hi = make_float2(quant::to_grid(v.z, s, mode), quant::to_grid(v.w, s, mode));
          return (uint32_t)__nv_cvt_float2_to_fp8x2(lo, __NV_SATFINITE, __NV_E4M3) |
                 (uint32_t)__nv_cvt_float2_to_fp8x2(hi, __NV_SATFINITE, __NV_E4M3) << 16;
        }
        return grid_byte(v.x, s) | grid_byte(v.y, s) << 8 | grid_byte(v.z, s) << 16 |
               grid_byte(v.w, s) << 24;
      };
      if (n >= 4) {
        const float4* w4 = reinterpret_cast<const float4*>(work);
        for (int i = threadIdx.x; i < (nr * n) >> 2; i += blockDim.x) {
          const int rr = (i << 2) >> lg, k = (i << 2) & (n - 1);
          const uint32_t word = grid_word(w4[i], s_row[g + rr]);
          const size_t at = (size_t)(g + rr) * ops + k;
#pragma unroll
          for (int c = 0; c < kMembers; ++c) {
            if (c >= csize) break;
            *reinterpret_cast<uint32_t*>(op_at[c] + at) = word;
          }
        }
      } else {
        for (int i = threadIdx.x; i < nr * n; i += blockDim.x) {
          const int rr = i >> lg, k = i & (n - 1);
          const uint8_t b = (uint8_t)grid_byte(work[i], s_row[g + rr]);
#pragma unroll
          for (int c = 0; c < kMembers; ++c) {
            if (c >= csize) break;
            op_at[c][(size_t)(g + rr) * ops + k] = b;
          }
        }
      }
      __syncthreads();
      if constexpr (kAbft) {
        // this member's rows are in its own operand too: their checksums,
        // into every member's chk
        for (int i = 0; i < nr; ++i) {
          const float c =
              row_check<kInt>(op + (size_t)(g + i) * ops, ab.cw + (size_t)e * n, n, wsum, mode);
          if (threadIdx.x == 0) {
#pragma unroll
            for (int cc = 0; cc < kMembers; ++cc)
              if (cc < csize) chk_at[cc][g + i] = c;
          }
        }
      }
    }
    // zero the masked rows, and the k padding of rows shorter than an MMA
    for (int i = rows * ops + threadIdx.x; i < BM * ops; i += blockDim.x) op[i] = 0;
    if (n < kKStep) {
      for (int i = threadIdx.x; i < rows * kKStep; i += blockDim.x)
        if (i % kKStep >= n) op[(size_t)(i / kKStep) * ops + i % kKStep] = 0;
    }
    rows_sync<kRevisit>();  // every member's rows and scales are in place
  };
  // each lane's output rows (2 tig, 2 tig + 1 of each n8 group) and scales
  float s_own[NF][2];
  auto load_scales = [&]() {
#pragma unroll
    for (int f = 0; f < NF; ++f)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int tok = f * 8 + 2 * tig + h;
        s_own[f][h] = tok < BM ? s_row[tok] : 0.0f;
      }
  };
  int lim = items;  // no copy is issued for a k-step at or past lim
#if !defined(REPRO_MUTANT_UNGUARDED_ROTATE)
  rotate_rows();
  load_scales();
  if constexpr (!kStreamed) prologue(lim);  // the ring shares the rotation's work area
#endif

  // ---- contract the operand with this block's tiles, round by round
  float rowacc = 0.0f;  // ABFT: thread i < BM's running sum of row i
  int it = 0;           // this warp's k-steps so far
  // this warp's k-step `at` (k-step ks of its tile) into the MMA
  // accumulators C
  auto kstep = [&](int at, int ks, bool together, auto& C) {
    cp_async_wait<kStages - 2>();  // this lane's copies of k-step `at` have landed
    // ... and every lane's of the quad (whole rounds) or the warp; all of
    // them are done with the stage refilled next
    const uint32_t* st32 = reinterpret_cast<const uint32_t*>(
        ring_q + (at & (kStages - 1)) * kQuad * kStageBytes);
    uint32_t wv[8];  // rows 8 tig + u, columns 4 grp .. 4 grp + 3 of the tile
    if (together) {
      quad_sync(quad);
#pragma unroll
      for (int u = 0; u < 8; ++u) wv[u] = st32[(8 * tig + u) * 32 + 8 * (qw ^ tig) + grp];
    } else {
      __syncwarp();
      st32 += qw * (kStageBytes / 4);
#pragma unroll
      for (int u = 0; u < 8; ++u) wv[u] = st32[32 * u + 8 * tig + grp];
    }
    uint2 b[NF];  // row f * 8 + grp, k 8 tig .. 8 tig + 7
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      const int tok = f * 8 + grp;
      b[f] = tok < BM ? *reinterpret_cast<const uint2*>(op + (size_t)tok * ops +
                                                         ks * kKStep + 8 * tig)
                      : make_uint2(0u, 0u);
    }
    if (next < lim) fetch(next++);
    cp_async_commit();
    uint32_t lo[4], hi[4];  // column 4 grp + c: k 8 tig .. +3 and 8 tig + 4 .. +7
    transpose4(wv, lo);
    transpose4(wv + 4, hi);
#pragma unroll
    for (int mf = 0; mf < 2; ++mf)  // MMA rows grp, grp + 8: columns 4 grp + 2 mf, + 1
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        if constexpr (kInt)
          mma_s8(C[mf][f], lo[2 * mf], lo[2 * mf + 1], hi[2 * mf], hi[2 * mf + 1], b[f].x,
                 b[f].y);
        else
          mma_fp8(C[mf][f], lo[2 * mf], lo[2 * mf + 1], hi[2 * mf], hi[2 * mf + 1], b[f].x,
                  b[f].y, mode);
      }
  };
  // group g of the tile, from zero, added into acc: int8 on the tensor core
  // itself, fp8 through one chunk's accumulator and __fadd_rn
  auto group = [&](int g, bool together, Acc (&acc)[2][NF][4]) {
    if constexpr (kInt) {
      for (int stp = 0; stp < gs; ++stp, ++it) kstep(it, g * gs + stp, together, acc);
    } else {
      float ck[2][NF][4];
#pragma unroll
      for (int mf = 0; mf < 2; ++mf)
#pragma unroll
        for (int f = 0; f < NF; ++f)
#pragma unroll
          for (int i = 0; i < 4; ++i) ck[mf][f][i] = 0.0f;
      for (int stp = 0; stp < gs; ++stp, ++it) kstep(it, g * gs + stp, together, ck);
#pragma unroll
      for (int mf = 0; mf < 2; ++mf)
#pragma unroll
        for (int f = 0; f < NF; ++f)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mf][f][i] = __fadd_rn(acc[mf][f][i], ck[mf][f][i]);
    }
  };
  auto zero = [](Acc (&a)[2][NF][4]) {
#pragma unroll
    for (int mf = 0; mf < 2; ++mf)
#pragma unroll
      for (int f = 0; f < NF; ++f)
#pragma unroll
        for (int i = 0; i < 4; ++i) a[mf][f][i] = 0;
  };
  for (int rd = 0; rd < whole + rest; ++rd) {
    const bool split = rd >= whole;
    const int tile = split ? t0 + whole * kWarps + (rd - whole) : t0 + rd * kWarps + warp;
    // the first split k-step refills the stage of the last whole one, which
    // every warp of the quad read, and syncs only its own warp: wait until
    // all warps are past the whole rounds
    if (split && rd == whole && whole > 0) __syncthreads();
#if defined(REPRO_MUTANT_UNGUARDED_ROTATE)
    // M1: the row block is rotated and quantized again before every round;
    // the ring, in the rotation's work area, restarts for the round's own
    // k-steps once the last round's copies have landed
    cp_async_wait<0>();
    rotate_rows();
    load_scales();
    lim = it + (split ? per_split : ksteps);
    prologue(lim);
#endif
    // register i of fragment (mf, f): column 4 grp + 2 mf + i / 2 of the
    // tile, row f * 8 + 2 tig + i % 2
    if (!split) {
      // a whole round: the warp's own tile, all groups in order, leaves
      // from its registers
      Acc acc[2][NF][4];
      zero(acc);
      for (int g = 0; g < groups; ++g) group(g, true, acc);
#pragma unroll
      for (int mf = 0; mf < 2; ++mf)
#pragma unroll
        for (int f = 0; f < NF; ++f)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int tok = f * 8 + 2 * tig + (i & 1);
            const int cc = 4 * grp + 2 * mf + (i >> 1), col = tile * kBN + cc;
            float contrib = 0.0f;
            if (tok < rows && col < d) {
              float v;
              if constexpr (kInt) v = __int2float_rn(acc[mf][f][i]);
              else v = acc[mf][f][i];
              contrib = __fmul_rn(__fmul_rn(v, s_own[f][i & 1]), __ldg(sw + col));
              out[row_index(row0 + tok, E, cap, e) * d + col] = hadacore::from_float<T>(contrib);
            }
            if constexpr (kAbft)
              if (tok < BM) work[(warp * BM + tok) * kBN + cc] = contrib;
          }
      if constexpr (kAbft) {
        // the round's 16 tiles' row sums, in tile order
        __syncthreads();
        if (threadIdx.x < BM) {
          for (int w = 0; w < kWarps; ++w) {
            float a = 0.0f;
            for (int c = 0; c < kBN; ++c) a = __fadd_rn(a, work[(w * BM + threadIdx.x) * kBN + c]);
            rowacc = __fadd_rn(rowacc, a);
          }
        }
        __syncthreads();
      }
    } else {
      // a split round: pass p, warp w adds group w + 16 p into red, and
      // thread o (< BM x 32) adds the pass's groups in group order
      const int o = threadIdx.x, oi = o / kBN, oc = o - oi * kBN;
      Acc sum = 0;
      for (int p = 0; p < passes; ++p) {
        const int g = warp + kWarps * p;
        if (g < groups) {
          Acc part[2][NF][4];
          zero(part);
          group(g, false, part);
#pragma unroll
          for (int mf = 0; mf < 2; ++mf)
#pragma unroll
            for (int f = 0; f < NF; ++f)
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const int tok = f * 8 + 2 * tig + (i & 1);
                if (tok < BM)
                  red[(warp * BM + tok) * kBN + 4 * grp + 2 * mf + (i >> 1)] = part[mf][f][i];
              }
        }
        __syncthreads();
        if (o < BM * kBN) {
          const int last_g = groups - kWarps * p < kWarps ? groups - kWarps * p : kWarps;
          for (int s = 0; s < last_g; ++s) {
            if constexpr (kInt) sum += red[(s * BM + oi) * kBN + oc];
            else sum = __fadd_rn(sum, red[(s * BM + oi) * kBN + oc]);
          }
        }
        __syncthreads();
      }
      if (o < BM * kBN) {
        const int col = tile * kBN + oc;
        float contrib = 0.0f;
        if (oi < rows && col < d) {
          float v;
          if constexpr (kInt) v = __int2float_rn(sum);
          else v = sum;
          contrib = __fmul_rn(__fmul_rn(v, s_row[oi]), __ldg(sw + col));
          out[row_index(row0 + oi, E, cap, e) * d + col] = hadacore::from_float<T>(contrib);
        }
        if constexpr (kAbft) tile_c[o] = contrib;
      }
      if constexpr (kAbft) {
        __syncthreads();
        // read before the next tile's contributions: those are written only
        // after the barriers of its first pass
        if (threadIdx.x < BM) {
          float a = 0.0f;
          for (int c = 0; c < kBN; ++c) a = __fadd_rn(a, tile_c[threadIdx.x * kBN + c]);
          rowacc = __fadd_rn(rowacc, a);
        }
      }
    }
  }
#if !defined(REPRO_MUTANT_DANGLING_DMA)
  cp_async_wait<0>();  // only empty groups remain: the ring drains
#endif

  if constexpr (kAbft) {
    // ---- the residual: every block of the row block writes its row sums,
    // then the last to arrive adds them in split order
    const size_t grp_id = (size_t)e * gridDim.x + blockIdx.x;
    const int splits = (int)gridDim.y;
    if (threadIdx.x < BM) {
      ab.part[(grp_id * splits + blockIdx.y) * BM + threadIdx.x] = rowacc;
      __threadfence();
    }
    __syncthreads();
    if (threadIdx.x == 0) *last = atomicAdd(ab.count + grp_id, 1u) == (unsigned)(splits - 1);
    __syncthreads();
    if (*last) {
      __threadfence();
      if (threadIdx.x < rows) {
        float a = 0.0f;
        for (int sp = 0; sp < splits; ++sp)
          a = __fadd_rn(a, __ldcg(ab.part + (grp_id * splits + sp) * BM + threadIdx.x));
        ab.resid[row_index(row0 + threadIdx.x, E, cap, e)] =
            __fsub_rn(a, __fmul_rn(s_row[threadIdx.x], chk[threadIdx.x]));
      }
      if (threadIdx.x == 0) ab.count[grp_id] = 0u;
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
int pick_bm(long long m, int n, bool streamed, bool abft) {
  int bm = 16;
  while (bm > 1 && bm / 2 >= m) bm /= 2;
  while (bm >= 1 && smem_bytes(n, bm, streamed, abft) > kSmemLimit) bm /= 2;
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
  const size_t smem = smem_bytes(n, BM, kStreamed, kAbft);
  const Grid g = grid_for(m, d, BM, smem, experts, kRevisit ? block_n : 0);
  if (g.row_blocks > 0x7fffffffLL || g.splits > 65535 || experts > 65535)
    return (int)cudaErrorInvalidConfiguration;
  // weight reads: 2 16-byte cp.async, 1 32-bit loads, 0 bytes (every
  // expert's weight starts as aligned as the first: n * d is a multiple of d)
  const uintptr_t wa = reinterpret_cast<uintptr_t>(wq);
  const int vec = (d % 16 == 0 && wa % 16 == 0) ? 2 : (d % 4 == 0 && wa % 4 == 0) ? 1 : 0;
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
  switch (pick_bm(m, n, kStreamed, kAbft)) {
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
  if (mode < quant::kInt8 || mode > quant::kE5M2) return 1;
  const bool streamed = schedule == kStreamedSchedule;
  const int bm = pick_bm(m, n, streamed, abft);
  if (bm == 0) return 1;
  if (schedule == kRevisitSchedule && (block_n <= 0 || block_n % kBN != 0)) return 1;
  const size_t smem = smem_bytes(n, bm, streamed, abft);
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
  const int bm = pick_bm(m, n, schedule == kStreamedSchedule, kAbft);
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
