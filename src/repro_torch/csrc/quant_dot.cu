// K4: rotate -> per-token quantize -> int8 / fp8 GEMM in one kernel, for
// sm_90a (the rotate-once schedule).
//
// Replaces the TPU kernel repro/kernels/quant_dot.py::
// _quant_dot_kernel_rotate_once (launched by _pallas_quant_dot; helpers
// _rotate_quantize_block, _operand_from_q, _operand_dot). Same function,
// with the same rounding points: each row of x (m, n) is rotated through K1's
// passes in the compute dtype (hadacore.cuh), quantized per token from the f32
// copy of the rounded row (quant.cuh), contracted with the (n, d) weight wq,
// and scaled as (float)acc * s * sw[col], then rounded once to the io dtype.
//   int8: exact int32 accumulation (dp4a), converted with __int2float_rn as
//         XLA converts -- the result equals the plain version bitwise
//         whenever the two rotations agree;
//   fp8:  both operands embedded exactly (the activation's grid values as
//         bf16, the weight bytes decoded to f32), every product exact in f32,
//         f32 accumulation in a fixed order. Not fp8 tensor-core MMA: Hopper
//         keeps fewer than f32's bits in that accumulator.
// This is the MLP down-projection site (n = d_ff) when d_ff is a power of 2.
//
// Bound on an H100: at decode (4 rows) bytes -- the (n, d) weight is read
// once, 25.2 MB at phi4-mini's 8192 x 3072, against 4 * 2 * n * d integer
// operations; prefill rows raise the operations per weight byte. The design
// keeps the rotated, quantized rows in shared memory (int8, or bf16 for fp8)
// and streams the weight past them, so the activations never round-trip
// through HBM.
//
// Launch. A decode step gives the kernel 4 rows against the whole weight, so
// one block per row block would leave 131 of 132 SMs idle. The grid is
// (row blocks of BM rows) x (column splits), and consecutive splits of a row
// block form a thread-block cluster of up to 8: each member rotates and
// quantizes its share of the rows and stores them into every member's
// shared memory (distributed shared memory), so each row is rotated once
// per cluster; then each block walks its run of 32-column tiles. The
// splits are chosen for one wave of resident blocks; every split
// gives the same bits (the rotation of a row does not depend on the block, and each
// output's sum runs in a fixed order). Within a tile, thread (cq, ks) owns 4
// columns and the ks-th of 64 contiguous k-chunks; its 4 x 4 byte blocks of
// the weight are read as 32-bit words (a warp reads 32 contiguous bytes of 4
// weight rows), 16 loads issued before any is used so that enough bytes are
// in flight to approach the memory rate, and transposed with byte permutes
// into dp4a operands. A warp adds its 4 chunks' partial sums with shuffles
// and the 16 warps' sums are added in shared memory in warp order. Rows
// beyond m and columns beyond d are masked; neither input is padded.
//
// Shared memory: the operand (BM x n, 1 or 2 bytes), a work area that holds
// the f32 rows being rotated (all BM rows at once when they fit, else rw
// at a time) and later the partial sums, and the scales. BM is the largest
// of 16, 8, 4, 2, 1 that the rows need and the 227 KB limit allows (n =
// 8192: 16 rows for int8, 8 for fp8); a launch that cannot fit returns an
// error, which the wrapper raises. 512 threads: the rotation's barrier-
// separated stages are latency-bound at one block per SM, so more warps
// hide more of it.
//
// What this first version leaves on the table: CUDA-core dp4a / FMA instead
// of the tensor cores (wgmma), plain loads instead of a TMA ring over the
// weight (K5), and the rotation repeated in every cluster.
#include <cooperative_groups.h>

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
constexpr int kMaxCluster = 8;       // blocks sharing one row block's rotation (portable max)
constexpr size_t kSmemLimit = 232448;  // 227 KB, the per-block maximum on sm_90
constexpr size_t kSmemPerSM = 233472;  // 228 KB of shared memory on an SM

// Operand row stride: n rounded up to a whole 32-bit word of int8 values.
__host__ __device__ __forceinline__ int op_stride(int n) { return n < 4 ? 4 : n; }

// Shared memory of a block of bm rows that rotates rw rows at a time: the
// operand, the work area (rw f32 rows, later the partial sums), bm scales
// and rw absmax words.
__host__ __device__ __forceinline__ size_t work_bytes(int n, int bm, int rw) {
  const size_t rot = (size_t)rw * n * sizeof(float);
  const size_t red = (size_t)kKW * bm * kBN * sizeof(float);
  return rot > red ? rot : red;
}

__host__ __device__ __forceinline__ size_t layout_bytes(int n, int bm, int rw, bool is_int) {
  return (size_t)bm * op_stride(n) * (is_int ? 1 : 2) + work_bytes(n, bm, rw) +
         (size_t)bm * sizeof(float) + (size_t)rw * sizeof(int);
}

// Rows rotated at once: all bm when they fit, else the most (a power of 2)
// that do. More rows per group means fewer barriers per row.
__host__ __device__ __forceinline__ int work_rows(int n, int bm, bool is_int) {
  int rw = bm;
  while (rw > 1 && layout_bytes(n, bm, rw, is_int) > kSmemLimit) rw /= 2;
  return rw;
}

__host__ __device__ __forceinline__ size_t smem_bytes(int n, int bm, bool is_int) {
  return layout_bytes(n, bm, work_rows(n, bm, is_int), is_int);
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

__device__ __forceinline__ float e4m3_to_float(uint32_t b) {
  const uint32_t sign = (b & 0x80u) << 24;
  const uint32_t e = (b >> 3) & 0xfu, mt = b & 7u;
  if ((b & 0x7fu) == 0x7fu) return __uint_as_float(sign | 0x7fc00000u);
  if (e == 0) return __uint_as_float(sign | __float_as_uint((float)mt * 0.001953125f));
  return __uint_as_float(sign | ((e + 120u) << 23) | (mt << 20));
}

__device__ __forceinline__ float e5m2_to_float(uint32_t b) {
  return __half2float(__ushort_as_half((unsigned short)(b << 8)));
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
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const uint32_t b = (w[u] >> (8 * c)) & 0xffu;
        wf[u][c] = mode == quant::kE4M3 ? e4m3_to_float(b) : e5m2_to_float(b);
      }
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

template <typename T, int BM, bool kInt>
__global__ void __launch_bounds__(kThreads)
    quant_dot_kernel(const T* x, const uint8_t* wq, const float* sw, T* out, long long m,
                     int n, int d, int r, int cd, float scale, int mode, int tiles_per_block,
                     int vec) {
  using Acc = typename std::conditional<kInt, int, float>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const int np4 = op_stride(n);
  const int lg = __ffs(n) - 1;  // n is a power of 2
  const int rw = work_rows(n, BM, kInt);
  unsigned char* op = smem;  // BM x np4 int8, or BM x np4 bf16 bits
  float* work = reinterpret_cast<float*>(smem + (size_t)BM * np4 * (kInt ? 1 : 2));
  float* s_row = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(work) +
                                          work_bytes(n, BM, rw));
  int* amax = reinterpret_cast<int*>(s_row + BM);

  // ---- rotate + quantize the row block once per cluster: the blocks of a
  // cluster (consecutive column splits of one row block) each rotate
  // BM / csize of the rows, rw at a time, and store the quantized rows and
  // their scales into the shared memory of every member
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = (int)cluster.num_blocks();
  const long long row0 = (long long)blockIdx.x * BM;
  const int rows = (int)(m - row0 < BM ? m - row0 : BM);
  const int mine0 = (int)cluster.block_rank() * (BM / csize);
  const int mine1 = mine0 + BM / csize < rows ? mine0 + BM / csize : rows;
  unsigned char* op_at[kMaxCluster];
  float* s_at[kMaxCluster];
#pragma unroll
  for (int c = 0; c < kMaxCluster; ++c) {
    op_at[c] = c < csize ? cluster.map_shared_rank(op, c) : op;
    s_at[c] = c < csize ? cluster.map_shared_rank(s_row, c) : s_row;
  }
  cluster.sync();  // every member runs before anyone writes into it
  for (int g = mine0; g < mine1; g += rw) {
    const int nr = mine1 - g < rw ? mine1 - g : rw;
    quant::rotate_rows_absmax(x + (size_t)(row0 + g) * n, work, amax, nr, n, r, cd, scale);
    for (int i = threadIdx.x; i < nr; i += blockDim.x) {
      const float s = quant::row_scale(__int_as_float(amax[i]), mode);
#pragma unroll
      for (int c = 0; c < kMaxCluster; ++c)
        if (c < csize) s_at[c][g + i] = s;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < nr * n; i += blockDim.x) {
      const int rr = i >> lg, k = i & (n - 1);
      const float q = quant::to_grid(work[i], s_row[g + rr], mode);
      const size_t at = (size_t)(g + rr) * np4 + k;
#pragma unroll
      for (int c = 0; c < kMaxCluster; ++c) {
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
  cluster.sync();  // every member's rows and scales are in place

  // ---- contract the operand with this block's run of column tiles
  const int tiles = (d + kBN - 1) / kBN;
  const int t0 = blockIdx.y * tiles_per_block;
  const int t1 = t0 + tiles_per_block < tiles ? t0 + tiles_per_block : tiles;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cq = lane & (kCQ - 1), ks = warp * 4 + (lane >> 3);
  int chunk = (np4 + kKS - 1) / kKS;
  chunk = (chunk + 3) & ~3;
  const int kb = ks * chunk;
  const int ke = kb + chunk < np4 ? kb + chunk : np4;
  Acc* red = reinterpret_cast<Acc*>(work);
  for (int t = t0; t < t1; ++t) {
    const int j = t * kBN + cq * 4;
    // whole aligned quads of real columns and rows read as 32-bit words
    const bool fast = vec && j + 3 < d && ke <= n;
    Acc acc[BM][4];
#pragma unroll
    for (int i = 0; i < BM; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] = 0;
    for (int k0 = kb; k0 < ke; k0 += 4 * kSteps) {
      // issue the loads of kSteps k-steps before using any: 4 * kSteps
      // independent loads in flight per thread
      uint32_t wv[4 * kSteps];
#pragma unroll
      for (int u = 0; u < 4 * kSteps; ++u) {
        const int k = k0 + u;
        if (fast) {
          wv[u] = k < ke ? __ldg(reinterpret_cast<const unsigned int*>(wq + (size_t)k * d + j))
                         : 0u;
        } else {
          wv[u] = k < ke ? load_w4(wq, k, j, n, d, vec) : 0u;
        }
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
      if (i < rows && col < d) {
        float v;
        if constexpr (kInt) v = __int2float_rn(sum);
        else v = sum;
        out[(size_t)(row0 + i) * d + col] =
            hadacore::from_float<T>(__fmul_rn(__fmul_rn(v, s_row[i]), sw[col]));
      }
    }
    __syncthreads();
  }
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

// Column splits for one wave: as many blocks as fit on the SMs at once
// (two per SM at decode's 98 KB, one at prefill's 196 KB), so no block
// waits for a second wave while every split repeats the rotation. Returns
// the tiles per block, given the row blocks.
long long tiles_per_block(long long row_blocks, long long tiles, size_t smem) {
  long long per_sm = (long long)(kSmemPerSM / (smem + 1024));  // 1 KB reserved per block
  if (per_sm < 1) per_sm = 1;
  if (per_sm > 2) per_sm = 2;
  const long long target = per_sm * (sm_count() > 0 ? sm_count() : 132);
  const long long tpb = (tiles * row_blocks + target - 1) / target;
  return tpb < 1 ? 1 : tpb;
}

// The row tile: the largest of 16, 8, 4, 2, 1 rows that the call needs and
// that fits the shared-memory limit; 0 when not even one row fits.
int pick_bm(long long m, int n, bool is_int) {
  int bm = 16;
  while (bm > 1 && bm / 2 >= m) bm /= 2;
  while (bm >= 1 && smem_bytes(n, bm, is_int) > kSmemLimit) bm /= 2;
  return bm;
}

// The grid of a call with bm rows per block: row blocks x column splits,
// the splits a multiple of the cluster size (the largest power of 2 up to
// 8 that divides the rows among the blocks and does not exceed the
// splits); extra splits get no tiles and only rotate.
struct Grid {
  long long row_blocks, splits, tpb;
  int csize;
};

Grid grid_for(long long m, int d, int bm, size_t smem) {
  Grid g;
  g.row_blocks = (m + bm - 1) / bm;
  const long long tiles = (d + kBN - 1) / kBN;
  g.tpb = tiles_per_block(g.row_blocks, tiles, smem);
  g.splits = (tiles + g.tpb - 1) / g.tpb;
  g.csize = kMaxCluster;
  while (g.csize > 1 && (g.csize > bm || g.csize > g.splits)) g.csize /= 2;
  g.splits = (g.splits + g.csize - 1) / g.csize * g.csize;
  return g;
}

template <typename T, int BM, bool kInt>
int launch_bm(const void* x, const void* wq, const void* sw, void* out, long long m, int n,
              int d, int r, int cd, float scale, int mode, cudaStream_t stream) {
  const size_t smem = smem_bytes(n, BM, kInt);
  auto kernel = quant_dot_kernel<T, BM, kInt>;
  if (smem > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const Grid g = grid_for(m, d, BM, smem);
  if (g.row_blocks > 0x7fffffffLL || g.splits > 65535) return (int)cudaErrorInvalidConfiguration;
  const int vec = (d % 4 == 0) && (reinterpret_cast<uintptr_t>(wq) % 4 == 0);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)g.row_blocks, (unsigned)g.splits);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = (unsigned)g.csize;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(x), static_cast<const uint8_t*>(wq),
      static_cast<const float*>(sw), static_cast<T*>(out), m, n, d, r, cd, scale, mode,
      (int)g.tpb, vec);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T, bool kInt>
int launch(const void* x, const void* wq, const void* sw, void* out, long long m, int n,
           int d, int r, int cd, float scale, int mode, cudaStream_t s) {
  switch (pick_bm(m, n, kInt)) {
    case 16: return launch_bm<T, 16, kInt>(x, wq, sw, out, m, n, d, r, cd, scale, mode, s);
    case 8: return launch_bm<T, 8, kInt>(x, wq, sw, out, m, n, d, r, cd, scale, mode, s);
    case 4: return launch_bm<T, 4, kInt>(x, wq, sw, out, m, n, d, r, cd, scale, mode, s);
    case 2: return launch_bm<T, 2, kInt>(x, wq, sw, out, m, n, d, r, cd, scale, mode, s);
    case 1: return launch_bm<T, 1, kInt>(x, wq, sw, out, m, n, d, r, cd, scale, mode, s);
    default: return (int)cudaErrorInvalidValue;  // the rows do not fit shared memory
  }
}

template <typename T>
int launch_io(const void* x, const void* wq, const void* sw, void* out, long long m, int n,
              int d, int r, int cd, float scale, int mode, cudaStream_t s) {
  if (mode == quant::kInt8) return launch<T, true>(x, wq, sw, out, m, n, d, r, cd, scale, mode, s);
  return launch<T, false>(x, wq, sw, out, m, n, d, r, cd, scale, mode, s);
}

}  // namespace

// x (m, n) io dtype, wq (n, d) one storage byte per element (int8 / e4m3 /
// e5m2 by mode), sw (d) f32, out (m, d) io dtype; all contiguous.
extern "C" int quant_dot_launch(const void* x, const void* wq, const void* sw, void* out,
                                long long m, int n, int d, int r, int io, int cd,
                                float scale, int mode, void* stream) {
  if (m <= 0 || d <= 0) return 0;
  if (n < 2 || (n & (n - 1)) != 0) return (int)cudaErrorInvalidValue;
  if (mode < quant::kInt8 || mode > quant::kE5M2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (io) {
    case hadacore::kF32: return launch_io<float>(x, wq, sw, out, m, n, d, r, cd, scale, mode, s);
    case hadacore::kBF16:
      return launch_io<__nv_bfloat16>(x, wq, sw, out, m, n, d, r, cd, scale, mode, s);
    case hadacore::kF16: return launch_io<__half>(x, wq, sw, out, m, n, d, r, cd, scale, mode, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The launch shape a call would get: rows per block (0 = does not fit),
// dynamic shared memory bytes, grid size. For the wrapper's size rule and
// the smoke script's report.
extern "C" int quant_dot_shape(long long m, int n, int d, int mode, int* bm, long long* smem,
                               long long* blocks) {
  const bool is_int = mode == quant::kInt8;
  *bm = pick_bm(m, n, is_int);
  *smem = *bm ? (long long)smem_bytes(n, *bm, is_int) : 0;
  *blocks = 0;
  if (*bm == 0) return 1;
  const Grid g = grid_for(m, d, *bm, (size_t)*smem);
  *blocks = g.row_blocks * g.splits;
  return 0;
}
