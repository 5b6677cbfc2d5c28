// The tensor-core HadaCore rotation shared by K1 (hadacore.cu) and K2 / K3
// (fused_quant.cu) for a 16-bit compute dtype (bf16, fp16), for sm_90a.
//
// The function is the reference plan's (repro/core/hadamard.py
// _apply_passes; hadacore.cuh run_passes computes the same with f32
// butterflies on CUDA cores): pass 0 the minor factor with the
// compute-dtype-rounded scale folded in, then one 128-point pass per major
// factor; f32 sums inside a pass, a rounding to the compute dtype at the
// end of each pass and nowhere else.
//
// Design (the paper's 16x16 tensor-core base case): a block holds its rows
// in shared memory as compute-dtype values (they are exact there between
// passes). Each pass is one mma.sync.m16n8k16 stage and at most one
// butterfly stage:
//   * the mma's A operand is the constant 16 x 16 factor -- H_16 (times the
//     scale on pass 0), the block diagonal I (x) H_f for a minor factor f < 16
//     (the paper's section 3.3 tiling), or H_f in the corner for rows below
//     16 points -- built once per pass in registers; its B operand is 16
//     values along four element bits of the row (k) by 8 columns along
//     three other bits (n), exact compute-dtype values, so the f32
//     accumulator holds the reference's f32 products summed;
//   * a warp runs up to 8 such mmas whose columns differ in the pass's
//     remaining (up to 3) bits; the C fragment gives a thread the same
//     (row, column) of each product, so those bits are f32 butterflies
//     across the thread's own accumulators: no data moves between threads;
//   * the pass rounds to the compute dtype and writes back in place; one
//     __syncthreads between passes is the only exchange;
//   * fragments move by ldmatrix / stmatrix (four 8 x 8 tiles of 16-byte
//     rows) where the pass's k bits 0-2 or its n bits are the element bits
//     0-2, else by 16-bit loads and stores.
// Which element bits form k, n and the registers is chosen on the host
// (repro_torch/kernels/hadacore.py tc_passes: tile moves where the bits
// allow, then the fewest bank conflicts in a layout padded by 8 values per
// 128), with every constant the task loop needs, and passed in as a Plan,
// which a block copies into shared memory first; the kernel hard-codes no
// layout. Register bits never cross a row, so the values a thread holds
// for one n column are of one row: the absmax of K2 / K3 reduces them,
// then across lanes with shuffles, then one atomic per row and task.
//
// At decode the kernel is a latency chain (load, one or two passes of one
// task per warp, store); the host's geometry (hadacore.py tc_geometry)
// keeps 4-8 warps per block and, for K2 / K3 at few rows below 1024
// points, one zero-padded row per block.
//
// Bound on an H100: bytes (one read and one write of each element; at most
// three passes of shared-memory traffic, against log2(n) of them for the
// CUDA-core butterflies).
#pragma once

#include <stdint.h>

#include <type_traits>

#include "hadacore.cuh"

namespace hadacore_tc {

#ifdef REPRO_STAMP_PHASES
// The phase-stamping build (fused_quant.cu compiled with
// -DREPRO_STAMP_PHASES; a measurement aid, never on a path): thread 0 of
// each of the first kStampBlocks blocks of a K2 launch records the SM clock
// (clock64) at the block's start (0), after its prologue (1: the plan
// staged, load_block: the first pass's lane constants and the thread's rows
// stored), after the barrier that ends the load (2), in the last pass's
// first task of warp 0 (3; the earlier passes and the last's lane
// constants before it), with that task's mmas, butterflies and stores
// done (4) and its absmax written (5), after the last pass's barrier (6)
// and after the epilogue's (7). Read back by fused_dequant_stamps.
constexpr int kStampBlocks = 4096, kStamps = 8;
__device__ long long g_stamps[kStampBlocks][kStamps];
__device__ __forceinline__ void stamp(int i) {
  if (threadIdx.x == 0 && blockIdx.x < kStampBlocks) g_stamps[blockIdx.x][i] = clock64();
}
#else
__device__ __forceinline__ void stamp(int) {}
#endif

// repro_torch/kernels/hadacore.py TcLaunch (ctypes), field for field. The
// host derives every layout constant, so a pass reads fixed fields and runs
// no loop over a runtime count of bits.
struct Pass {
  int kbits[4];   // element bits of the mma's k axis
  int nbits[3];   // element bits of its n axis
  int fbits;      // log2 of the factor the operand applies on the k axis
  int amode;      // 0 H_16, 1 I (x) H_f block diagonal, 2 H_f top-left (rows < 16)
  int scaled;     // the scale is folded into the operand (pass 0)
  int nb;         // butterfly bits: register index bits 0 .. nb - 1
  int nmma;       // mmas per task: 2^(register bits)
  int ntask;      // warp tasks in a block
  int tmask;      // the task bits of an element offset
  int tstep;      // the task bits of the warp count (a warp's stride)
  int tbase[8];   // the task bits of warp w's first task
  int proff[8];   // shared index of register i's element offset
  int mode;       // fragment moves: kScalar, kKRows, kNRows
};

// How a pass moves its fragments (hadacore.py SCALAR, K_ROWS, N_ROWS):
// 16-bit loads and stores of single values, or ldmatrix / stmatrix of 8 x 8
// tiles whose 16-byte rows run along the k axis (its bits 0-2 are the
// element bits 0-2) or along the n axis (the n bits are 0-2).
enum Mode : int { kScalar = 0, kKRows = 1, kNRows = 2 };

struct Plan {
  int npass, n, lg_pitch, lg_block, threads;
  Pass passes[3];
};

// 16-bit compute dtypes: raw bits, conversions, the mma.
__device__ __forceinline__ uint16_t bits_of(__nv_bfloat16 v) { return __bfloat16_as_ushort(v); }
__device__ __forceinline__ uint16_t bits_of(__half v) { return __half_as_ushort(v); }

template <typename C> __device__ __forceinline__ float bits_to_float(uint32_t b);
template <> __device__ __forceinline__ float bits_to_float<__nv_bfloat16>(uint32_t b) {
  return __uint_as_float(b << 16);
}
template <> __device__ __forceinline__ float bits_to_float<__half>(uint32_t b) {
  return __half2float(__ushort_as_half((uint16_t)b));
}

// f32 -> the compute dtype's bits, round to nearest even
template <typename C> __device__ __forceinline__ uint16_t round_bits(float v) {
  return bits_of(hadacore::from_float<C>(v));
}

// Two f32 values -> the compute dtype's bits, lo | hi << 16, one
// conversion instruction (round to nearest even, as round_bits).
template <typename C> __device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <> __device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
template <> __device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  const __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <typename C>
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1);
template <>
__device__ __forceinline__ void mma<__nv_bfloat16>(float (&d)[4], const uint32_t (&a)[4],
                                                   uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.0f));
}
template <>
__device__ __forceinline__ void mma<__half>(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                            uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.0f));
}

// Four 8 x 8 tiles of 16-bit values between shared memory and the mma
// fragments; lane l gives the address of row l % 8 of tile l / 8. The
// memory clobber keeps them in order with the kernel's other accesses.
__device__ __forceinline__ void ldsm(uint32_t (&r)[4], const uint16_t* p, bool trans) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  if (trans)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a) : "memory");
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a) : "memory");
}

__device__ __forceinline__ void stsm(uint16_t* p, uint32_t r0, uint32_t r1, uint32_t r2,
                                     uint32_t r3, bool trans) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  if (trans)
    asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1,%2,%3,%4};"
                 :: "r"(a), "r"(r0), "r"(r1), "r"(r2), "r"(r3) : "memory");
  else
    asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1,%2,%3,%4};"
                 :: "r"(a), "r"(r0), "r"(r1), "r"(r2), "r"(r3) : "memory");
}

// Shared-memory index of element e: 8 values of padding after every 128.
__device__ __forceinline__ int phys(int e) { return e + ((e >> 7) << 3); }

// The bits of v scattered to the element bits `bits`.
template <int N>
__device__ __forceinline__ int dep(const int (&bits)[N], int v) {
  int out = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) out |= ((v >> j) & 1) << bits[j];
  return out;
}

// The operand's entry (output m, input k) of a pass, as a float.
__device__ __forceinline__ float coef(const Pass& P, int m, int k, float s) {
  const int f = P.fbits;
  const bool on = P.amode == 2 ? ((m | k) >> f) == 0 : ((m ^ k) >> f) == 0;
  if (!on) return 0.0f;
  return (__popc(m & k & ((1 << f) - 1)) & 1) ? -s : s;
}

template <typename C>
__device__ __forceinline__ uint32_t coef2(const Pass& P, int m, int k, float s) {
  return pack2<C>(coef(P, m, k, s), coef(P, m, k + 1, s));
}

// One butterfly stage across register index bit H: (i, i | H) -> (a + b, a - b).
// Registers past the task's mma count hold copies (see run_pass) and never
// mix with the real ones: for i < nmma, i | H < nmma.
template <int H>
__device__ __forceinline__ void butterfly(float (&acc)[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (i & H) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float a = acc[i][c], b = acc[i | H][c];
      acc[i][c] = __fadd_rn(a, b);
      acc[i | H][c] = __fsub_rn(a, b);
    }
  }
}

// A lane's constants of one pass: the mma's A operand (the pass's factor)
// and the shared-memory offsets that its task loop adds to each task's
// base. They depend on the plan alone, so a kernel derives the first
// pass's while its rows' loads are in flight (load_block), and rotate the
// later passes' before each.
struct Lane {
  uint32_t a[4];
  int pb, c_lo, pc, pk1, pk8, pn1, prow;
  int proff[8];
};

// scalar moves: B (k = 2t + {0, 1, 8, 9}, n = g); C (m = g + {0, 8},
// n = 2t + {0, 1}); tile moves: this lane's row of tile lane / 8 (see
// run_pass)
template <typename C>
__device__ __forceinline__ Lane lane_consts(const Pass& P, float scale) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float s = P.scaled ? scale : 1.0f;
  Lane L;
  L.a[0] = coef2<C>(P, g, 2 * t, s);
  L.a[1] = coef2<C>(P, g + 8, 2 * t, s);
  L.a[2] = coef2<C>(P, g, 2 * t + 8, s);
  L.a[3] = coef2<C>(P, g + 8, 2 * t + 8, s);
  L.pb = phys(dep(P.kbits, 2 * t) | dep(P.nbits, g));
  L.c_lo = dep(P.kbits, g) | dep(P.nbits, 2 * t);
  L.pc = phys(L.c_lo);
  L.pk1 = phys(1 << P.kbits[0]);
  L.pk8 = phys(1 << P.kbits[3]);
  L.pn1 = phys(1 << P.nbits[0]);
  const int j = lane & 7, hi = (lane >> 3) & 1;
  L.prow = P.mode == kKRows ? phys(dep(P.nbits, j)) + hi * L.pk8
                            : phys(dep(P.kbits, j + 8 * hi));
#pragma unroll
  for (int i = 0; i < 8; ++i) L.proff[i] = P.proff[i];
  return L;
}

// One pass over the block's values in sm (compute-dtype bits, padded
// layout), in place, with the lane's constants L of the pass. With kAmax
// on the last pass, each row's absmax of the rounded values goes into
// amax[row] (f32 bits; atomicMax, so the caller zeroes it first). The
// caller synchronises after.
//
// Element offsets are ORs of disjoint bits, and phys() is additive over
// them, so each fragment's shared index is a sum of per-lane constants
// and the host's per-register ones. The task body has no branch: a task
// of fewer than 8 mmas runs all 8, the extra registers on copies of the
// real ones (the host repeats their offsets), which compute and store the
// same values to the same places.
//
// kMode kKRows / kNRows: ldmatrix gives the B fragments of two mmas (tiles
// 0 / 1: k 0-7 / 8-15 of mma i, 2 / 3 of mma i + 1) and stmatrix stores
// the C fragments (tiles: m 0-7 / 8-15 of mma i, then of i + 1); a tile's
// rows run along k (kKRows: ldmatrix plain, stmatrix transposed; lane
// row j is the n index j) or along n (kNRows: the other way; row j is the
// k / m index j). Both use the same row offsets.
template <typename C, bool kAmax, int kMode>
__device__ __forceinline__ void run_pass(uint16_t* sm, const Plan& plan, const Pass& P,
                                         const Lane& L, bool last, int* amax) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int second = lane >> 4;
  const uint32_t(&a)[4] = L.a;
  const int pb = L.pb, c_lo = L.c_lo, pc = L.pc, pk1 = L.pk1, pk8 = L.pk8, pn1 = L.pn1;
  const int prow = L.prow;
  int proff[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) proff[i] = L.proff[i];
  // the warp's tasks: task bits stepped by the warp count inside the task
  // mask (carries ripple through the bits outside it)
  const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int tmask = P.tmask, tstep = P.tstep;
  const bool padded = plan.n < 16;
  int base = P.tbase[warp & 7];
  if (kAmax && last) stamp(3);
  for (int task = warp; task < P.ntask; task += nwarps) {
    uint16_t* qb = sm + phys(base);
    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; i += 2) {
      if (kMode == kScalar) {
#pragma unroll
        for (int d = 0; d < 2; ++d) {
          const uint16_t* q = qb + pb + proff[i + d];
          const uint32_t b0 = (uint32_t)q[0] | ((uint32_t)q[pk1] << 16);
          const uint32_t b1 = (uint32_t)q[pk8] | ((uint32_t)q[pk8 + pk1] << 16);
          mma<C>(acc[i + d], a, b0, b1);
        }
      } else {
        uint32_t r[4];
        ldsm(r, qb + prow + (second ? proff[i + 1] : proff[i]), kMode == kNRows);
        mma<C>(acc[i], a, r[0], r[1]);
        mma<C>(acc[i + 1], a, r[2], r[3]);
      }
    }
    if (P.nb > 0) butterfly<1>(acc);
    if (P.nb > 1) butterfly<2>(acc);
    if (P.nb > 2) butterfly<4>(acc);
#pragma unroll
    for (int i = 0; i < 8; i += 2) {
      uint32_t w[4];      // (g, 2t | 2t + 1), (g + 8, ...) of mma i, then of i + 1
#pragma unroll
      for (int d = 0; d < 2; ++d) {
        w[2 * d] = pack2<C>(acc[i + d][0], acc[i + d][1]);
        w[2 * d + 1] = pack2<C>(acc[i + d][2], acc[i + d][3]);
      }
      if (kMode == kScalar) {
#pragma unroll
        for (int d = 0; d < 2; ++d) {
          uint16_t* q = qb + pc + proff[i + d];
          q[0] = (uint16_t)w[2 * d];
          q[pn1] = (uint16_t)(w[2 * d] >> 16);
          q[pk8] = (uint16_t)w[2 * d + 1];
          q[pk8 + pn1] = (uint16_t)(w[2 * d + 1] >> 16);
        }
      } else {
        stsm(qb + prow + (second ? proff[i + 1] : proff[i]), w[0], w[1], w[2], w[3],
             kMode == kKRows);
      }
    }
    if (kAmax && last) stamp(4);
    if (kAmax && last) {
      // |value| as f32 bits of this lane's columns n = 2t (m0) and 2t + 1
      // (m1), before rounding: rounding is monotone, so the rounded max is
      // the max of the rounded values; a NaN's bits beat every number's.
      // Copies of a register change no max.
      int m0 = 0, m1 = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (padded && (g + 8 * (c >> 1)) >= plan.n) continue;   // a padding column
          const int av = __float_as_int(acc[i][c]) & 0x7fffffff;
          if (c & 1) m1 = max(m1, av); else m0 = max(m0, av);
        }
      }
      // lanes of one t hold one row per column (g walks the k axis)
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        m0 = max(m0, __shfl_xor_sync(0xffffffffu, m0, o));
        m1 = max(m1, __shfl_xor_sync(0xffffffffu, m1, o));
      }
      const bool t0_in = P.nbits[1] < plan.lg_pitch, t1_in = P.nbits[2] < plan.lg_pitch;
      const bool c_in = P.nbits[0] < plan.lg_pitch;
      if (t0_in) {
        m0 = max(m0, __shfl_xor_sync(0xffffffffu, m0, 1));
        m1 = max(m1, __shfl_xor_sync(0xffffffffu, m1, 1));
      }
      if (t1_in) {
        m0 = max(m0, __shfl_xor_sync(0xffffffffu, m0, 2));
        m1 = max(m1, __shfl_xor_sync(0xffffffffu, m1, 2));
      }
      if (c_in) m0 = m1 = max(m0, m1);
      if (g == 0 && !(t0_in && (t & 1)) && !(t1_in && (t & 2))) {
        const int r0 = __float_as_int(bits_to_float<C>(round_bits<C>(__int_as_float(m0))));
        atomicMax(&amax[(base | c_lo) >> plan.lg_pitch], r0 < 0 ? 0x7fffffff : r0);
        if (!c_in) {
          const int r1 = __float_as_int(bits_to_float<C>(round_bits<C>(__int_as_float(m1))));
          atomicMax(&amax[(base | c_lo | (1 << P.nbits[0])) >> plan.lg_pitch],
                    r1 < 0 ? 0x7fffffff : r1);
        }
      }
    }
    if (kAmax && last) stamp(5);
    base = ((base | ~tmask) + tstep) & tmask;
  }
}

// The plan in the block's shared memory (read at fixed offsets by every
// pass, without a constant-cache miss per field on each SM). Visible after
// the caller's next __syncthreads.
__device__ __forceinline__ const Plan& stage_plan(const Plan& plan) {
  __shared__ Plan sp;
  for (int i = threadIdx.x; i < (int)(sizeof(Plan) / sizeof(int)); i += blockDim.x)
    reinterpret_cast<int*>(&sp)[i] = reinterpret_cast<const int*>(&plan)[i];
  return sp;
}

// Every pass of the plan on the block's values; ends synchronised. The
// caller synchronises after filling sm (and zeroing amax for kAmax), and
// gives the first pass's lane constants. The passes unroll, so each reads
// its fields at fixed offsets.
template <typename C, bool kAmax>
__device__ __forceinline__ void rotate(uint16_t* sm, const Plan& plan, float scale, int* amax,
                                       const Lane& first) {
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    if (p < plan.npass) {
      const Pass& P = plan.passes[p];
      const bool last = p == plan.npass - 1;
      const Lane L = p == 0 ? first : lane_consts<C>(P, scale);
      if (P.mode == kKRows)
        run_pass<C, kAmax, kKRows>(sm, plan, P, L, last, amax);
      else if (P.mode == kNRows)
        run_pass<C, kAmax, kNRows>(sm, plan, P, L, last, amax);
      else
        run_pass<C, kAmax, kScalar>(sm, plan, P, L, last, amax);
      __syncthreads();
    }
  }
}

// Rows row0 .. row0 + R - 1 of x (n values each, contiguous) into sm as
// compute-dtype bits (the reference's cast of the input), rows past `rows`
// and the padding columns (past n, to the pitch) as zeros. `vec`: 16-byte
// global accesses (n >= 16 and both pointers 16-byte aligned), kUnroll of
// them in flight per thread before any is converted. Every thread calls
// hook() once, at the same point (it may hold a barrier): with the
// first kUnroll loads in flight on the vec path.
constexpr int kUnroll = 4;

template <typename T, typename C, typename Hook>
__device__ __forceinline__ void load_rows(const T* x, uint16_t* sm, long long rows,
                                          long long row0, const Plan& plan, bool vec,
                                          Hook hook) {
  const int E = 1 << plan.lg_block, n = plan.n, lp = plan.lg_pitch;
  if (vec) {
    constexpr int V = 16 / sizeof(T);
    const int step = blockDim.x * V;
    for (int e0 = threadIdx.x * V, first = 1; first || e0 < E; e0 += step * kUnroll, first = 0) {
      uint4 raw[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int e = e0 + u * step, col = e & ((1 << lp) - 1);
        const long long row = row0 + (e >> lp);
        raw[u] = (e < E && col < n && row < rows)
                     ? *reinterpret_cast<const uint4*>(x + row * n + col)
                     : make_uint4(0, 0, 0, 0);
      }
      if (first) hook();
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int e = e0 + u * step;
        if (e >= E) break;
        if constexpr (std::is_same<T, C>::value) {
          *reinterpret_cast<uint4*>(sm + phys(e)) = raw[u];
        } else {
          const T* vals = reinterpret_cast<const T*>(&raw[u]);
          uint32_t w[V / 2];
#pragma unroll
          for (int j = 0; j < V; j += 2)
            w[j / 2] = pack2<C>(hadacore::to_float(vals[j]), hadacore::to_float(vals[j + 1]));
          if constexpr (V == 8)
            *reinterpret_cast<uint4*>(sm + phys(e)) = make_uint4(w[0], w[1], w[2], w[3]);
          else
            *reinterpret_cast<uint2*>(sm + phys(e)) = make_uint2(w[0], w[1]);
        }
      }
    }
    return;
  }
  hook();
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    const long long row = row0 + (e >> lp);
    const int col = e & ((1 << lp) - 1);
    sm[phys(e)] = (row < rows && col < n) ? round_bits<C>(hadacore::to_float(x[row * n + col]))
                                          : (uint16_t)0;
  }
}

// The rows loaded into sm (load_rows) and, while the first of those loads
// are in flight, the first pass's lane constants derived from the staged
// plan sp (stage_plan's, not yet visible: the hook synchronises first).
// Returns them; the caller synchronises before rotate.
template <typename T, typename C>
__device__ __forceinline__ Lane load_block(const T* x, uint16_t* sm, long long rows,
                                           long long row0, const Plan& plan, const Plan& sp,
                                           bool vec, float scale) {
  Lane first;
  load_rows<T, C>(x, sm, rows, row0, plan, vec, [&] {
    __syncthreads();
    first = lane_consts<C>(sp.passes[0], scale);
  });
  return first;
}

// The block's rotated rows from sm into out (the io dtype), valid rows and
// columns only.
template <typename T, typename C>
__device__ __forceinline__ void store_rows(T* out, const uint16_t* sm, long long rows,
                                           long long row0, const Plan& plan, bool vec) {
  const int E = 1 << plan.lg_block, n = plan.n, lp = plan.lg_pitch;
  if (vec) {
    constexpr int V = 16 / sizeof(T);
    for (int e = threadIdx.x * V; e < E; e += blockDim.x * V) {
      const long long row = row0 + (e >> lp);
      const int col = e & ((1 << lp) - 1);
      if (row >= rows) break;      // the block's rows are in order
      if (col >= n) continue;
      uint4 raw;
      if constexpr (std::is_same<T, C>::value) {
        raw = *reinterpret_cast<const uint4*>(sm + phys(e));
      } else {
        uint32_t w[4];
        if constexpr (V == 8) {
          const uint4 v = *reinterpret_cast<const uint4*>(sm + phys(e));
          w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
        } else {
          const uint2 v = *reinterpret_cast<const uint2*>(sm + phys(e));
          w[0] = v.x, w[1] = v.y;
        }
        T* vals = reinterpret_cast<T*>(&raw);
#pragma unroll
        for (int j = 0; j < V; ++j)
          vals[j] = hadacore::from_float<T>(
              bits_to_float<C>((j & 1) ? w[j / 2] >> 16 : w[j / 2] & 0xffffu));
      }
      *reinterpret_cast<uint4*>(out + row * n + col) = raw;
    }
    return;
  }
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    const long long row = row0 + (e >> lp);
    const int col = e & ((1 << lp) - 1);
    if (row < rows && col < n)
      out[row * n + col] = hadacore::from_float<T>(bits_to_float<C>(sm[phys(e)]));
  }
}

// The launch's checks and geometry; returns cudaSuccess or an error code.
template <typename Kernel>
__host__ int prepare(Kernel kernel, const Plan* plan, int n, long long rows, size_t smem,
                     long long* blocks) {
  if (plan == nullptr || plan->n != n || plan->npass < 1 || plan->npass > 3 ||
      plan->lg_block < 10 || plan->lg_block > 15 || plan->lg_pitch > plan->lg_block ||
      plan->threads < 32 || plan->threads > 256 || plan->threads % 32)
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long rpb = 1ll << (plan->lg_block - plan->lg_pitch);
  *blocks = (rows + rpb - 1) / rpb;
  return (int)cudaSuccess;
}

// Dynamic shared memory of a block: the values (2 bytes, 8 of padding per
// 128) and one int per row (K2 / K3's absmax). Mirrors hadacore.py
// tc_shared_bytes.
__host__ __device__ inline size_t shared_bytes(const Plan& plan) {
  const size_t e = (size_t)1 << plan.lg_block;
  return 2 * (e + e / 16) + 4 * (e >> plan.lg_pitch);
}

// Whether the rows can move in 16-byte pieces.
__host__ inline bool vec_ok(const void* a, const void* b, int n) {
  return n >= 16 && ((uintptr_t)a % 16 == 0) && ((uintptr_t)b % 16 == 0);
}

}  // namespace hadacore_tc
