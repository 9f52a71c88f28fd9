// The cell group kernels (B1, B4 and B7 in both state modes, B8, and B2
// up to the largest instance) and their (G, R) instances, for the units
// that hold them (sw_cell_unit.cu, one a slice of CELL_SHAPES) and the
// dispatch in sw_tiles.cu.  The kernels are templates: a unit instantiates
// those of its slice only.
#pragma once

#include "sw_common.cuh"

// The (G, R) instances of the cell kernels: a group of G lanes scores one
// subject (int32 lanes) or two (s16x2 lanes), lane k holding the subject
// columns [k R, k R + R).  ops/sw_cell.py CELL_SHAPES is the table that
// picks one for each L (the least G x R >= L, then the least G); the two
// lists agree (a CUDA test reads this one through sw_cell_shapes).  G = 8
// up to L = 256, G = 16 up to 576, G = 32 above: every multiple of 16 up
// to 768 is G x R, or 16 short of it past 576.  Chosen on the H100 with
// kernel_ab.py (PERF.md): at L = 320-576, G = 16 with twice the registers
// a lane ran 4-8% faster than G = 32 (a shorter fill and drain of the
// wavefront, half the per-step overhead a cell); at L = 128-256, G = 8 as
// fast as or faster than 16 and 32; a one-tile bucket at L = 64 gains a
// little from larger groups (more threads).  Past R = 36 an instance
// needs more than 168 registers (cell_min_blocks), two blocks an SM
// without spills, and at L = 640, G = 32 (R = 20) ran 5% faster than
// G = 16 (R = 40).
#define CELL_SHAPES_0(X)                                                  \
  X(8, 2) X(8, 4) X(8, 6) X(8, 8) X(8, 10) X(8, 12) X(8, 14) X(8, 16)     \
  X(8, 18) X(8, 20)
#define CELL_SHAPES_1(X) X(8, 22) X(8, 24) X(8, 26) X(8, 28)
#define CELL_SHAPES_2(X) X(8, 30) X(8, 32) X(16, 17) X(16, 18)
#define CELL_SHAPES_3(X) \
  X(16, 19) X(16, 20) X(16, 21) X(16, 22) X(16, 23) X(16, 24)
#define CELL_SHAPES_4(X) X(16, 25) X(16, 26) X(16, 27) X(16, 28)
#define CELL_SHAPES_5(X) X(16, 29) X(16, 30) X(16, 31) X(16, 32)
#define CELL_SHAPES_6(X) X(16, 33) X(16, 34) X(16, 35) X(16, 36)
#define CELL_SHAPES_7(X) \
  X(32, 19) X(32, 20) X(32, 21) X(32, 22) X(32, 23) X(32, 24)
#define CELL_SHAPES(X)                                                    \
  CELL_SHAPES_0(X) CELL_SHAPES_1(X) CELL_SHAPES_2(X) CELL_SHAPES_3(X)     \
  CELL_SHAPES_4(X) CELL_SHAPES_5(X) CELL_SHAPES_6(X) CELL_SHAPES_7(X)
// The slices: the library's cell units, one a slice (sw_cell_unit.cu),
// which ops/cuda_lib.py CELL_SLICES compiles in parallel.  Each holds
// about an eighth of the instances' registers (the sum of R), which the
// compile time follows.
#define CELL_SLICES(X) X(0) X(1) X(2) X(3) X(4) X(5) X(6) X(7)

namespace sw {

// A unit's launchers: the cell launch at an instance (G, R) of its slice,
// the row launch (B2's cell route) and the tool launch (B7, B8) at one;
// kNotHere for another instance.
#define CELL_UNIT_DECL(s)                                    \
  int cell_unit_##s(const CellArgs& a, int G, int R);        \
  int row_unit_##s(const RowArgs& a, int G, int R);          \
  int tool_unit_##s(const ToolArgs& a, int G, int R);
CELL_SLICES(CELL_UNIT_DECL)
#undef CELL_UNIT_DECL

}  // namespace sw

namespace {

// ------------------------- B1, B2 and B4: the single-pass cell wavefront

constexpr int kCellThreads = 128;  // threads a block of the cell kernels
// Blocks an SM that an instance's registers must allow: its state is 3 R
// registers (code, H + gop and F of the row above), and ptxas took up to
// max(3 R + 40, 4 R + 24) in all (-Xptxas -v).  Without a floor it spilled
// a few bytes in some instances (72-96 registers) rather than take the
// next register step; under a floor of 3 R + 40 it spilled at R = 39-42
// (three blocks an SM, which ran 13% faster at R = 40 than two without
// spills).
template <int R>
constexpr int cell_min_blocks() {
  return 65536 / (kCellThreads * (((R < 16 ? 3 * R + 40 : 4 * R + 24) + 7) / 8 * 8));
}
// The -inf stand-in of s16x2 lanes: it survives adding a gap penalty.
constexpr int kNeg16 = -(1 << 14);

// The lane arithmetic of cell_group.  V: a lane's DP value; code(): the
// column's code at byte offset o of the subject (the -inf column A past
// L); sub(): the shifted substitution score of the column in the query
// row's table row.
//
// Exact int32 lanes: one subject a group.
struct LaneS32 {
  using V = int;
  static constexpr int kNegInf = kNeg;
  __device__ static V splat(int v) { return v; }
  __device__ static int code(const int8_t* x, size_t o, bool in, int A) {
    return in ? x[o] : A;
  }
  __device__ static V sub(const int* srow, int c) { return srow[c]; }
  __device__ static V addmax(V a, V b, V c) { return __viaddmax_s32(a, b, c); }
  __device__ static V cell(V dg, V sb, V e, V f) {
    return __vimax3_s32_relu(dg + sb, e, f);
  }
  __device__ static V plus(V a, V b) { return a + b; }
  __device__ static V vmax(V a, V b) { return max(a, b); }
};

// s16x2 lanes: the tile's subjects s (low halfword) and s + 1 (high) in
// one value, two cells an operation.  A column's code is the index of its
// code pair, c0 (A + 1) + c1, in the pairwise table, whose entries hold
// both shifted scores: one lookup a column pair.  (Two lookups in the
// [A][A + 1] table joined by a byte permute, with two codes a column in
// registers, took 1.34 times as long at [12, 640] x 464; PERF.md.)
struct LaneS16 {
  using V = unsigned;
  static constexpr int kNegInf = kNeg16;
  __device__ static V splat(int v) { return ((unsigned)v & 0xffffu) * 0x10001u; }
  __device__ static int code(const int8_t* x, size_t o, bool in, int A) {
    if (!in) return A * (A + 1) + A;
    const unsigned w = *reinterpret_cast<const uint16_t*>(x + o);
    return (int)(w & 0xffu) * (A + 1) + (int)(w >> 8);
  }
  __device__ static V sub(const int* srow, int c) { return srow[c]; }
  __device__ static V addmax(V a, V b, V c) { return __viaddmax_s16x2(a, b, c); }
  __device__ static V cell(V dg, V sb, V e, V f) {
    return __vimax_s16x2_relu(__viaddmax_s16x2(dg, sb, e), f);
  }
  // a + b, as max(a + b, -inf): the DPX add of s16x2 lanes.
  __device__ static V plus(V a, V b) {
    return __viaddmax_s16x2(a, b, splat(kNeg16));
  }
  __device__ static V vmax(V a, V b) { return __vimax_s16x2_relu(a, b); }
};


// A group of G lanes sweeps query rows q[0, nrows) over one subject (x:
// its codes, stride apart: 4096 in a cell tile, NS in a row tile; two
// subjects for s16x2 lanes) of L <= G x R columns in one pass.  Lane k holds columns [k R, k R + R) in registers
// (code, H + gop and F of the row above) and scores row i at step i + k,
// taking H + gop and E of its left column from lane k - 1 with a width-G
// shuffle and the value it took a step earlier as its diagonal; lane 0's
// left column is the matrix edge (H = 0, E = -inf) at every row.  tab:
// the substitution table, qstride entries a query code.  Returns the
// group's max H, on every lane of the group.
template <int G, int R, class P>
__device__ __forceinline__ typename P::V cell_group(
    const int8_t* __restrict__ x, int L, int stride,
    const int32_t* __restrict__ q, int nrows, const int* tab, int qstride,
    int A, int gop, int gex) {
  using V = typename P::V;
  const int k = threadIdx.x & (G - 1);
  const V vgop = P::splat(gop), vgex = P::splat(gex);
  const V vneg = P::splat(P::kNegInf);
  int c[R];
  V hg[R], f[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int j = k * R + r;
    c[r] = P::code(x, (size_t)j * stride, j < L, A);
    hg[r] = vgop;
    f[r] = vneg;
  }
  V prev = vgop, oh = vgop, oe = vneg, m = P::splat(0);
  int qc = k == 0 && nrows > 0 ? q[0] * qstride : 0;  // this row's tab row
  for (int s = 0; s < nrows + G - 1; ++s) {
    const int i = s - k;
    V rh = __shfl_up_sync(kWarpAll, oh, 1, G);
    V re = __shfl_up_sync(kWarpAll, oe, 1, G);
    if (k == 0) {
      rh = vgop;
      re = vneg;
    }
    V dg = prev;
    prev = rh;
    const int qn =
        (unsigned)(i + 1) < (unsigned)nrows ? q[i + 1] * qstride : 0;
    if ((unsigned)i < (unsigned)nrows) {
      const int* srow = tab + qc;
      V e = re, hl = rh;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        e = P::addmax(e, vgex, hl);
        f[r] = P::addmax(f[r], vgex, hg[r]);
        const V h = P::cell(dg, P::sub(srow, c[r]), e, f[r]);
        m = P::vmax(m, h);
        dg = hg[r];
        hl = P::plus(h, vgop);
        hg[r] = hl;
      }
      oh = hl;
      oe = e;
    }
    qc = qn;
  }
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) {
    m = P::vmax(m, __shfl_xor_sync(kWarpAll, m, o, G));
  }
  return m;
}

// The largest substitution score with which s16x2 lanes cannot wrap: every
// H is at most min(L, nrows) x max B <= 32767, and with gop, gex in
// [-8192, 0] and every score >= -8192 no sum falls below -32768.  Below
// -8192 (no matrix fits) when the gaps are out of that range.
__device__ __forceinline__ int cell16_bmax(int L, int nrows, int gop,
                                           int gex) {
  if (gop > 0 || gex > 0 || gop < -8192 || gex < -8192) return -8193;
  const int n = L < nrows ? L : nrows;
  const int b = 32767 / (n > 1 ? n : 1);
  return b < 16383 ? b : 16383;
}

// B1 and B4 in s16x2 lanes, in both state modes: group g of the grid's x
// axis scores the subject pair (2 (g % 2048), + 1) of tile g / 2048
// against slot blockIdx.y: rows[slot] rows of queries[slot] (all W rows
// of the one query when rows is null, B1); out: the slot's scores
// [T, 4096].  In a cell bucket no H passes min(L, nrows) x max B, so the
// lanes never wrap and the scores are exact (which meets the SAT rule at
// any SAT).  Each block takes the largest substitution score for which
// its slot's rows provably fit (cell16_bmax; ops/cuda_lib.py
// cell16_fits is the host's copy, which counts the slots); a matrix with
// a larger score, or one below -8192, runs the pair through the int32
// routine, one subject after the other.  The dynamic shared memory holds the pairwise table (40.7 KB at
// A = 21, 75.8 KB at A = 26), which is larger than the int32 routine's.
template <int G, int R>
__global__ void
__launch_bounds__(kCellThreads, cell_min_blocks<R>()) sw_cell16_kernel(
    const int8_t* tiles, const int32_t* queries, const int32_t* rows,
    const int32_t* mat, int A, int T, int L, int W, int gop, int gex,
    float* out) {
  extern __shared__ int tab[];
  const int slot = blockIdx.y;
  const int nrows = rows ? rows[slot] : W;
  const int32_t* query = queries + (size_t)slot * W;
  const int bmax = cell16_bmax(L, nrows, gop, gex);
  out += (size_t)slot * T * kCellNS;
  int fits = 1;
  for (int k = threadIdx.x; k < A * A; k += blockDim.x) {
    fits &= mat[k] >= -8192 && mat[k] <= bmax;
  }
  fits = __syncthreads_and(fits);
  if (fits) {
    load_cell_table<true>(tab, mat, A, gop, kNeg16);
  } else {
    load_cell_table<false>(tab, mat, A, gop, kNeg);
  }
  __syncthreads();
  const size_t g = ((size_t)blockIdx.x * kCellThreads + threadIdx.x) / G;
  const size_t o = g / (kCellNS / 2) * kCellNS + g % (kCellNS / 2) * 2;
  const int8_t* x = tiles + o / kCellNS * L * kCellNS + o % kCellNS;
  int m0, m1;
  if (fits) {
    const unsigned m = cell_group<G, R, LaneS16>(
        x, L, kCellNS, query, nrows, tab, (A + 1) * (A + 1), A, gop, gex);
    m0 = (int16_t)(m & 0xffffu);
    m1 = (int16_t)(m >> 16);
  } else {
    m0 = cell_group<G, R, LaneS32>(x, L, kCellNS, query, nrows, tab, A + 1, A,
                                   gop, gex);
    m1 = cell_group<G, R, LaneS32>(x + 1, L, kCellNS, query, nrows, tab, A + 1,
                                   A, gop, gex);
  }
  if ((threadIdx.x & (G - 1)) == 0) {
    out[o] = (float)m0;
    out[o + 1] = (float)m1;
  }
}

// B2 up to the largest instance: group g scores subject g % NS of row tile
// g / NS (codes NS apart) against query rows q[0, nrows) and writes out[g],
// the [T, NS] scores.  A group past the last subject (T x NS need not fill
// the last block) scores the last subject again and writes nothing, so
// that every lane of its warp reaches the full-mask shuffles.
template <int G, int R>
__global__ void
__launch_bounds__(kCellThreads, cell_min_blocks<R>()) sw_row_kernel(
    const int8_t* tiles, const int32_t* query, const int32_t* mat, int A,
    int T, int L, int NS, int nrows, int gop, int gex, float* out) {
  __shared__ int tab[kMaxAlphabet * (kMaxAlphabet + 1)];
  load_cell_table<false>(tab, mat, A, gop, kNeg);
  __syncthreads();
  const size_t n = (size_t)T * NS;
  const size_t g = ((size_t)blockIdx.x * kCellThreads + threadIdx.x) / G;
  const size_t gs = g < n ? g : n - 1;
  const int m = cell_group<G, R, LaneS32>(tiles + gs / NS * L * NS + gs % NS,
                                          L, NS, query, nrows, tab, A + 1, A,
                                          gop, gex);
  if (g < n && (threadIdx.x & (G - 1)) == 0) out[g] = (float)m;
}

// ----------------------------- B7 and B8: the tool kernels on cell_group

// B8: group g of the grid's x axis scores subject g % 4096 of the P tiles
// (g / 4096) P, .. + P - 1, one after the other, each from the top of the
// DP matrix, in int32 lanes.  The shifted table is loaded once a block for
// its P tiles: the fixed cost that the JAX experiment amortises.
template <int G, int R>
__global__ void
__launch_bounds__(kCellThreads, cell_min_blocks<R>()) sw_pair_kernel(
    const int8_t* tiles, const int32_t* query, const int32_t* mat, int A,
    int L, int nrows, int gop, int gex, int P, float* out) {
  __shared__ int tab[kMaxAlphabet * (kMaxAlphabet + 1)];
  load_cell_table<false>(tab, mat, A, gop, kNeg);
  __syncthreads();
  const size_t g = ((size_t)blockIdx.x * kCellThreads + threadIdx.x) / G;
  const size_t s = g % kCellNS, t0 = g / kCellNS * P;
  for (size_t t = t0; t < t0 + P; ++t) {
    const int m = cell_group<G, R, LaneS32>(tiles + t * L * kCellNS + s, L,
                                            kCellNS, query, nrows, tab, A + 1,
                                            A, gop, gex);
    if ((threadIdx.x & (G - 1)) == 0) out[t * kCellNS + s] = (float)m;
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// B7's unit of subjects: a block's groups score kRound subjects at once
// (one a group in int32 lanes, two in s16x2 lanes); a unit is kWidth >=
// kRound of them, so that each position of it is whole 16-byte copies
// (cp.async.cg moves 16 bytes), swept in kWidth / kRound rounds.
template <int G, bool k16>
struct ManualUnit {
  static constexpr int kRound = kCellThreads / G * (k16 ? 2 : 1);
  static constexpr int kWidth = kRound > 16 ? kRound : 16;
};

// Ints of B7's table in dynamic shared memory, before its ring: [A][A + 1]
// shifted scores, or for s16x2 lanes the pairwise [A][(A + 1)^2]; a
// multiple of 4, so the ring starts 16-byte aligned.
__host__ __device__ __forceinline__ int manual_table_ints(int A, bool k16) {
  return (A * (A + 1) * (k16 ? A + 1 : 1) + 3) / 4 * 4;
}

// Start the copies of unit u's codes into dst, [L][W] bytes: subjects
// (u % (4096 / W)) W, .. + W - 1 of tile u / (4096 / W), as one group.
template <int W>
__device__ __forceinline__ void stage_unit(int8_t* dst,
                                           const int8_t* __restrict__ tiles,
                                           size_t u, int L) {
  constexpr int kParts = W / 16;
  const int8_t* src = tiles + u / (kCellNS / W) * L * kCellNS +
                      u % (kCellNS / W) * W;
  for (int i = threadIdx.x; i < L * kParts; i += kCellThreads) {
    const int j = i / kParts, part = i % kParts * 16;
    cp_async16(dst + j * W + part, src + (size_t)j * kCellNS + part);
  }
  cp_async_commit();
}

// B7, B1's contract with the tiles staged by hand: a persistent grid whose
// blocks walk the units u = blockIdx.x, + gridDim.x, ... (ManualUnit).  A
// unit's codes go through a 2-deep ring in dynamic shared memory (smem,
// after the table) by cp.async, the next unit's copy started before the
// current one is swept; the groups then run cell_group on the ring's codes
// (stride W), kWidth / kRound rounds a unit.  In int32 lanes (k16 false)
// the scores are exact.  In s16x2 lanes (k16) each block tests the fit
// of sw_cell16_kernel (cell16_bmax) and otherwise runs each subject pair
// through the int32 routine: exact scores either way, which meets the SAT
// rule.  No scratch: the DP lives in registers.
template <int G, int R, bool k16>
__device__ __forceinline__ void manual_body(
    int* smem, const int8_t* __restrict__ tiles, const int32_t* query,
    const int32_t* __restrict__ mat, int A, int T, int L, int nrows, int gop,
    int gex, float* __restrict__ out) {
  using Unit = ManualUnit<G, k16>;
  constexpr int W = Unit::kWidth;
  int* tab = smem;
  int8_t* ring = reinterpret_cast<int8_t*>(smem + manual_table_ints(A, k16));
  const size_t units = (size_t)T * (kCellNS / W);
  if (blockIdx.x < units) stage_unit<W>(ring, tiles, blockIdx.x, L);
  int fits = 0;
  if constexpr (k16) {
    const int bmax = cell16_bmax(L, nrows, gop, gex);
    fits = 1;
    for (int k = threadIdx.x; k < A * A; k += blockDim.x) {
      fits &= mat[k] >= -8192 && mat[k] <= bmax;
    }
    fits = __syncthreads_and(fits);
  }
  if (fits) {
    load_cell_table<true>(tab, mat, A, gop, kNeg16);
  } else {
    load_cell_table<false>(tab, mat, A, gop, kNeg);
  }
  const int grp = threadIdx.x / G;
  const bool lead = (threadIdx.x & (G - 1)) == 0;
  int slot = 0;
  for (size_t u = blockIdx.x; u < units; u += gridDim.x) {
    __syncthreads();  // nobody still reads the slot the next copy fills
    if (u + gridDim.x < units) {
      stage_unit<W>(ring + (slot ^ 1) * L * W, tiles, u + gridDim.x, L);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // unit u and the table are in, for every thread
    const int8_t* xs = ring + slot * L * W;
    float* o = out + u / (kCellNS / W) * kCellNS + u % (kCellNS / W) * W;
    for (int r0 = 0; r0 < W; r0 += Unit::kRound) {
      if constexpr (k16) {
        const int sub = r0 + 2 * grp;
        int m0, m1;
        if (fits) {
          const unsigned m = cell_group<G, R, LaneS16>(
              xs + sub, L, W, query, nrows, tab, (A + 1) * (A + 1), A, gop,
              gex);
          m0 = (int16_t)(m & 0xffffu);
          m1 = (int16_t)(m >> 16);
        } else {
          m0 = cell_group<G, R, LaneS32>(xs + sub, L, W, query, nrows, tab,
                                         A + 1, A, gop, gex);
          m1 = cell_group<G, R, LaneS32>(xs + sub + 1, L, W, query, nrows,
                                         tab, A + 1, A, gop, gex);
        }
        if (lead) {
          o[sub] = (float)m0;
          o[sub + 1] = (float)m1;
        }
      } else {
        const int sub = r0 + grp;
        const int m = cell_group<G, R, LaneS32>(xs + sub, L, W, query, nrows,
                                                tab, A + 1, A, gop, gex);
        if (lead) o[sub] = (float)m;
      }
    }
    slot ^= 1;
  }
}

template <int G, int R>
__global__ void
__launch_bounds__(kCellThreads, cell_min_blocks<R>()) sw_manual_kernel(
    const int8_t* tiles, const int32_t* query, const int32_t* mat, int A,
    int T, int L, int nrows, int gop, int gex, float* out) {
  extern __shared__ int4 manual_smem[];
  manual_body<G, R, false>(reinterpret_cast<int*>(manual_smem), tiles, query,
                           mat, A, T, L, nrows, gop, gex, out);
}

template <int G, int R>
__global__ void
__launch_bounds__(kCellThreads, cell_min_blocks<R>()) sw_manual16_kernel(
    const int8_t* tiles, const int32_t* query, const int32_t* mat, int A,
    int T, int L, int nrows, int gop, int gex, float* out) {
  extern __shared__ int4 manual_smem[];
  manual_body<G, R, true>(reinterpret_cast<int*>(manual_smem), tiles, query,
                          mat, A, T, L, nrows, gop, gex, out);
}

using ManualKernel = void (*)(const int8_t*, const int32_t*, const int32_t*,
                              int, int, int, int, int, int, float*);

// B7's launch: as many blocks as fit on the card at once (at most one a
// unit), each with the table and a ring of 2 x L x W bytes.
inline int manual_launch(ManualKernel kernel, int W, bool k16,
                         const sw::ToolArgs& a) {
  const int smem = 4 * manual_table_ints(a.A, k16) + 2 * a.L * W;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kCellThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long units = (long long)a.T * (kCellNS / W);
  const long long resident = (long long)per_sm * sms;
  kernel<<<(unsigned)(units < resident ? units : resident), kCellThreads, smem,
           a.stream>>>(a.tiles, a.query, a.mat, a.A, a.T, a.L, a.nrows, a.gop,
                       a.gex, a.out);
  return (int)cudaGetLastError();
}

template <int G, int R>
int tool_launch_at(const sw::ToolArgs& a) {
  if (a.P) {
    const long long threads = (long long)(a.T / a.P) * kCellNS * G;
    sw_pair_kernel<G, R>
        <<<(unsigned)(threads / kCellThreads), kCellThreads, 0, a.stream>>>(
            a.tiles, a.query, a.mat, a.A, a.L, a.nrows, a.gop, a.gex, a.P,
            a.out);
    return (int)cudaGetLastError();
  }
  if (a.sat) {
    return manual_launch(sw_manual16_kernel<G, R>,
                         ManualUnit<G, true>::kWidth, true, a);
  }
  return manual_launch(sw_manual_kernel<G, R>, ManualUnit<G, false>::kWidth,
                       false, a);
}

template <int G, int R>
int cell_launch_at(const sw::CellArgs& a) {
  const long long threads = (long long)a.T * kCellNS * G;
  const int A1 = a.A + 1, smem = a.A * A1 * A1 * 4;
  const cudaError_t err = cudaFuncSetAttribute(
      sw_cell16_kernel<G, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(threads / 2 / kCellThreads), (unsigned)a.S);
  sw_cell16_kernel<G, R><<<grid, kCellThreads, smem, a.stream>>>(
      a.tiles, a.queries, a.rows, a.mat, a.A, a.T, a.L, a.W, a.gop, a.gex,
      a.out);
  return (int)cudaGetLastError();
}

template <int G, int R>
int row_launch_at(const sw::RowArgs& a) {
  const long long threads = (long long)a.T * a.NS * G;
  sw_row_kernel<G, R>
      <<<(unsigned)((threads + kCellThreads - 1) / kCellThreads), kCellThreads,
         0, a.stream>>>(a.tiles, a.query, a.mat, a.A, a.T, a.L, a.NS, a.nrows,
                        a.gop, a.gex, a.out);
  return (int)cudaGetLastError();
}

}  // namespace
