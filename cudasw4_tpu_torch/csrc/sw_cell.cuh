// The cell group kernels (B1 in both state modes, B4, and B2 up to the
// largest instance) and their (G, R) instances, for the units that hold
// them (sw_cell_unit.cu, one a slice of CELL_SHAPES) and the dispatch in
// sw_tiles.cu.  The kernels are templates: a unit instantiates those of its
// slice only.
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
// and the row launch (B2's cell route) at one; kNotHere for another
// instance.
#define CELL_UNIT_DECL(s)                                    \
  int cell_unit_##s(const CellArgs& a, int G, int R);        \
  int row_unit_##s(const RowArgs& a, int G, int R);
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

// B1 and B4: group g of the grid's x axis scores subject g % 4096 of tile
// g / 4096 against query rows q[0, nrows), in int32 lanes; out: the
// slot's scores [T, 4096].
template <int G, int R>
__device__ __forceinline__ void cell_body(
    const int8_t* __restrict__ tiles, const int32_t* __restrict__ q,
    int nrows, const int32_t* __restrict__ mat, int A, int L, int gop,
    int gex, float* __restrict__ out) {
  __shared__ int tab[kMaxAlphabet * (kMaxAlphabet + 1)];
  load_cell_table<false>(tab, mat, A, gop, kNeg);
  __syncthreads();
  const size_t g = ((size_t)blockIdx.x * kCellThreads + threadIdx.x) / G;
  const int m = cell_group<G, R, LaneS32>(
      tiles + g / kCellNS * L * kCellNS + g % kCellNS, L, kCellNS, q, nrows,
      tab, A + 1, A, gop, gex);
  if ((threadIdx.x & (G - 1)) == 0) out[g] = (float)m;
}

template <int G, int R>
__global__ void
__launch_bounds__(kCellThreads, cell_min_blocks<R>()) sw_cell_kernel(
    const int8_t* tiles, const int32_t* query, const int32_t* mat, int A,
    int L, int nrows, int gop, int gex, float* out) {
  cell_body<G, R>(tiles, query, nrows, mat, A, L, gop, gex, out);
}

// B4: slot blockIdx.y runs its nrows[slot] rows of queries[slot]; a slot
// of 0 rows scores 0.
template <int G, int R>
__global__ void
__launch_bounds__(kCellThreads, cell_min_blocks<R>()) sw_cell_batch_kernel(
    const int8_t* tiles, const int32_t* queries, const int32_t* nrows,
    const int32_t* mat, int A, int T, int L, int W, int gop, int gex,
    float* out) {
  const int slot = blockIdx.y;
  cell_body<G, R>(tiles, queries + (size_t)slot * W, nrows[slot], mat, A, L,
                  gop, gex, out + (size_t)slot * T * kCellNS);
}

// B1 int16: group g scores the subject pair (2 (g % 2048), + 1) of tile
// g / 2048 in s16x2 lanes.  In a cell bucket no H passes
// min(L, nrows) x max B, so the lanes never wrap and the scores are exact
// (which meets the SAT rule at any SAT).  bmax: the largest substitution
// score for which the launcher proved that (cell16_bmax); a matrix with a
// larger score, or one below -8192, runs the pair through the int32
// routine, one subject after the other.  The dynamic shared memory holds
// the pairwise table (40.7 KB at A = 21, 75.8 KB at A = 26), which is
// larger than the int32 routine's.
template <int G, int R>
__global__ void
__launch_bounds__(kCellThreads, cell_min_blocks<R>()) sw_cell16_kernel(
    const int8_t* tiles, const int32_t* query, const int32_t* mat, int A,
    int L, int nrows, int gop, int gex, int bmax, float* out) {
  extern __shared__ int tab[];
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

// The largest substitution score with which s16x2 lanes cannot wrap: every
// H is at most min(L, nrows) x max B <= 32767, and with gop, gex in
// [-8192, 0] and every score >= -8192 no sum falls below -32768.  Below
// -8192 (no matrix fits) when the gaps are out of that range.
int cell16_bmax(int L, int nrows, int gop, int gex) {
  if (gop > 0 || gex > 0 || gop < -8192 || gex < -8192) return -8193;
  const int n = L < nrows ? L : nrows;
  const int b = 32767 / (n > 1 ? n : 1);
  return b < 16383 ? b : 16383;
}

template <int G, int R>
int cell_launch_at(const sw::CellArgs& a) {
  const long long threads = (long long)a.T * kCellNS * G;
  if (a.rows) {
    const dim3 grid((unsigned)(threads / kCellThreads), (unsigned)a.S);
    sw_cell_batch_kernel<G, R><<<grid, kCellThreads, 0, a.stream>>>(
        a.tiles, a.queries, a.rows, a.mat, a.A, a.T, a.L, a.W, a.gop, a.gex,
        a.out);
  } else if (a.sat) {
    const int A1 = a.A + 1, smem = a.A * A1 * A1 * 4;
    const cudaError_t err = cudaFuncSetAttribute(
        sw_cell16_kernel<G, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    sw_cell16_kernel<G, R>
        <<<(unsigned)(threads / 2 / kCellThreads), kCellThreads, smem,
           a.stream>>>(a.tiles, a.queries, a.mat, a.A, a.L, a.W, a.gop,
                       a.gex, cell16_bmax(a.L, a.W, a.gop, a.gex), a.out);
  } else {
    sw_cell_kernel<G, R>
        <<<(unsigned)(threads / kCellThreads), kCellThreads, 0, a.stream>>>(
            a.tiles, a.queries, a.mat, a.A, a.L, a.W, a.gop, a.gex, a.out);
  }
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
