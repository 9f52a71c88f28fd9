// The col wavefront kernels (B3 in both state modes, B5, B6, and B2 past
// the largest cell instance) and the col launch: one unit of the kernel
// library (sw_tiles.cu gives the design).
#include "sw_common.cuh"

namespace {

// ------------------------------- B3, B5 and B6: the col wavefront
// An int32 value of St state as the int32 carry keeps it: as it is, or
// clamped at sat when St is int16 (no narrowing: F may still be -inf).
template <typename St>
__device__ __forceinline__ int clamp_state(int v, int sat) {
  if constexpr (std::is_same<St, int32_t>::value) {
    return v;
  } else {
    return min(v, sat);
  }
}

// One warp scores one subject (x: its codes, stride apart: 4096 in a cell
// tile, NS in a row tile) against query rows q[0, nrows).  smat:
// [A][A + 1], B - gop and a -inf column A.  hin/fin, hout/fout: the
// subject's carry in and out (the same stride), or null.  th/te: the warp's boundary column of nrows rows (St, clamped at
// sat for int16), or null when L fits one pass.  Returns the subject's
// max H, on every lane.
template <typename St>
__device__ __forceinline__ int col_warp(
    const int8_t* __restrict__ x, int L, int stride,
    const int32_t* __restrict__ q, int nrows, const int* smat, int A, int gop,
    int gex, const int32_t* __restrict__ hin, const int32_t* __restrict__ fin,
    int32_t* hout, int32_t* fout, St* th, St* te, int sat) {
  const int lane = threadIdx.x & 31;
  const int A1 = A + 1;
  const int npass = (L + kColPass - 1) / kColPass;
  int m = 0;
  for (int p = 0; p < npass; ++p) {
    const bool rd = p > 0, wr = p + 1 < npass;
    const int jl = p * kColPass + lane * kColRegs;  // the lane's first column
    int c[kColRegs], hg[kColRegs], f[kColRegs];
#pragma unroll
    for (int r = 0; r < kColRegs; ++r) {
      const int j = jl + r;
      const size_t o = (size_t)j * stride;
      const bool in = j < L;
      c[r] = in ? x[o] : A;
      hg[r] = (in && hin ? hin[o] : 0) + gop;
      f[r] = in && fin ? fin[o] : kNeg;
    }
    // H + gop of the row above at the pass's left column: lane 0's first
    // diagonal.  Later rows' diagonals are the values taken a step before.
    int prev = gop;
    if (lane == 0 && rd && hin) prev += hin[(size_t)(jl - 1) * stride];
    int oh = hg[kColRegs - 1], oe = kNeg;  // passed right: H + gop and E
    int bh = 0, be = kNeg, nh = 0, ne = kNeg;  // boundary groups: now, next
    int wh = 0, we = 0;  // lane (i & 31) keeps lane 31's row i to store it
    if (rd && lane < nrows) {
      nh = th[lane];
      ne = te[lane];
    }
    int qc = lane == 0 && nrows > 0 ? q[0] * A1 : 0;  // this row's smat row
    for (int s = 0; s < nrows + 31; ++s) {
      const int i = s - lane;
      if (rd && (s & 31) == 0) {
        bh = nh;
        be = ne;
        const int r = s + 32 + lane;
        if (r < nrows) {
          nh = th[r];
          ne = te[r];
        }
      }
      int rh = __shfl_up_sync(kWarpAll, oh, 1);
      int re = __shfl_up_sync(kWarpAll, oe, 1);
      int lh = 0, le = kNeg;
      if (rd) {
        lh = __shfl_sync(kWarpAll, bh, s & 31);
        le = __shfl_sync(kWarpAll, be, s & 31);
      }
      if (lane == 0) {
        rh = lh + gop;
        re = le;
      }
      int dg = prev;
      prev = rh;
      const int qn = (unsigned)(i + 1) < (unsigned)nrows ? q[i + 1] * A1 : 0;
      if ((unsigned)i < (unsigned)nrows) {
        const int* srow = smat + qc;
        int e = re, hl = rh;
#pragma unroll
        for (int r = 0; r < kColRegs; ++r) {
          const int t = dg + srow[c[r]];
          e = __viaddmax_s32(e, gex, hl);
          f[r] = __viaddmax_s32(f[r], gex, hg[r]);
          const int h = __vimax3_s32_relu(t, e, f[r]);
          m = max(m, h);
          dg = hg[r];
          hl = h + gop;
          hg[r] = hl;
        }
        oh = hl;
        oe = e;
      }
      qc = qn;
      if (wr) {
        const int gh = __shfl_sync(kWarpAll, oh, 31);
        const int ge = __shfl_sync(kWarpAll, oe, 31);
        const int iw = s - 31;  // the row lane 31 has just scored
        if (iw >= 0) {
          if (lane == (iw & 31)) {
            wh = gh;
            we = ge;
          }
          if ((iw & 31) == 31 || iw == nrows - 1) {
            const int r = (iw & ~31) + lane;
            if (r <= iw) {
              th[r] = to_state<St>(wh - gop, sat);
              te[r] = to_state<St>(we, sat);
            }
          }
        }
      }
    }
    if (hout) {
#pragma unroll
      for (int r = 0; r < kColRegs; ++r) {
        const int j = jl + r;
        if (j < L) {
          hout[(size_t)j * stride] = clamp_state<St>(hg[r] - gop, sat);
          fout[(size_t)j * stride] = clamp_state<St>(f[r], sat);
        }
      }
    }
    __syncwarp();  // this pass's boundary stores, before the next's loads
  }
  return __reduce_max_sync(kWarpAll, m);
}

// Warp w of the grid's x axis scores subject w % 4096 of tile w / 4096
// against slot blockIdx.y: rows[slot] rows of queries[slot] (all W rows
// when rows is null), its boundary column at rows offs[slot] .. (0 when
// null) of the warp's rtot-row pool.  With kStarts, offs holds the slots'
// gapless starts [S + 1] and slot s runs offs[s + 1] - offs[s] rows.
// Writes out[slot, t, s].
template <typename St, bool kStarts = false>
__device__ __forceinline__ void sw_col_body(
    const int8_t* __restrict__ tiles, const int32_t* __restrict__ queries,
    const int32_t* __restrict__ rows, const int32_t* __restrict__ offs,
    const int32_t* __restrict__ mat, int A, int T, int L, int W, int rtot,
    int gop, int gex, const int32_t* hin, const int32_t* fin, int32_t* hout,
    int32_t* fout, St* th, St* te, float* __restrict__ out, int sat) {
  __shared__ int smat[kMaxAlphabet * (kMaxAlphabet + 1)];
  const int A1 = A + 1;
  for (int k = threadIdx.x; k < A * A1; k += blockDim.x) {
    const int c = k % A1;
    smat[k] = c < A ? mat[k / A1 * A + c] - gop : kNeg;
  }
  __syncthreads();
  const int w = blockIdx.x * kColWarps + (threadIdx.x >> 5);
  const int t = w / kCellNS, s = w % kCellNS;
  const int slot = blockIdx.y;
  const size_t base = (size_t)t * L * kCellNS + s;
  const size_t col = (size_t)w * rtot + (offs ? offs[slot] : 0);
  const int m = col_warp<St>(
      tiles + base, L, kCellNS, queries + (size_t)slot * W,
      kStarts ? offs[slot + 1] - offs[slot] : rows ? rows[slot] : W, smat,
      A, gop, gex, hin ? hin + base : nullptr, fin ? fin + base : nullptr,
      hout ? hout + base : nullptr, fout ? fout + base : nullptr,
      th ? th + col : nullptr, te ? te + col : nullptr, sat);
  if ((threadIdx.x & 31) == 0) {
    out[((size_t)slot * T + t) * kCellNS + s] = (float)m;
  }
}

__global__ void __launch_bounds__(kColWarps * 32, kColMinBlocks) sw_col_kernel(
    const int8_t* tiles, const int32_t* query, const int32_t* mat, int A,
    int T, int L, int nrows, int gop, int gex, const int32_t* hin,
    const int32_t* fin, int32_t* hout, int32_t* fout, int32_t* th,
    int32_t* te, float* out) {
  sw_col_body<int32_t>(tiles, query, nullptr, nullptr, mat, A, T, L, nrows,
                       nrows, gop, gex, hin, fin, hout, fout, th, te, out, 0);
}

__global__ void __launch_bounds__(kColWarps * 32, kColMinBlocks) sw_col16_kernel(
    const int8_t* tiles, const int32_t* query, const int32_t* mat, int A,
    int T, int L, int nrows, int gop, int gex, const int32_t* hin,
    const int32_t* fin, int32_t* hout, int32_t* fout, int16_t* th,
    int16_t* te, float* out, int sat) {
  sw_col_body<int16_t>(tiles, query, nullptr, nullptr, mat, A, T, L, nrows,
                       nrows, gop, gex, hin, fin, hout, fout, th, te, out,
                       sat);
}

__global__ void __launch_bounds__(kColWarps * 32, kColMinBlocks) sw_col_flat_kernel(
    const int8_t* tiles, const int32_t* queries, const int32_t* rows,
    const int32_t* offs, const int32_t* mat, int A, int T, int L, int W,
    int rtot, int gop, int gex, int32_t* th, int32_t* te, float* out) {
  sw_col_body<int32_t>(tiles, queries, rows, offs, mat, A, T, L, W, rtot, gop,
                       gex, nullptr, nullptr, nullptr, nullptr, th, te, out,
                       0);
}

// B6: col flat with the slots' pool rows packed without gaps, starts[s] ..
// starts[s + 1] being slot s's.  Each (slot, subject) warp starts at the
// top of the DP matrix, so the slots' boundaries need not fall anywhere in
// particular: a slot's reads and writes of the pool stay inside its rows.
__global__ void __launch_bounds__(kColWarps * 32, kColMinBlocks) sw_col_fused_kernel(
    const int8_t* tiles, const int32_t* queries, const int32_t* starts,
    const int32_t* mat, int A, int T, int L, int W, int rtot, int gop,
    int gex, int32_t* th, int32_t* te, float* out) {
  sw_col_body<int32_t, true>(tiles, queries, nullptr, starts, mat, A, T, L, W,
                             rtot, gop, gex, nullptr, nullptr, nullptr,
                             nullptr, th, te, out, 0);
}

// B2 past the largest cell instance: warp w scores subject w % NS of row
// tile w / NS in col passes (codes NS apart), its boundary column at pool
// rows w * nrows .. of th/te, and writes out[w].  A warp past the last
// subject leaves as a whole after the block's one barrier.
__global__ void __launch_bounds__(kColWarps * 32, kColMinBlocks) sw_row_col_kernel(
    const int8_t* tiles, const int32_t* query, const int32_t* mat, int A,
    int T, int L, int NS, int nrows, int gop, int gex, int32_t* th,
    int32_t* te, float* out) {
  __shared__ int smat[kMaxAlphabet * (kMaxAlphabet + 1)];
  load_cell_table<false>(smat, mat, A, gop, kNeg);
  __syncthreads();
  const size_t w = (size_t)blockIdx.x * kColWarps + (threadIdx.x >> 5);
  if (w >= (size_t)T * NS) return;
  const size_t col = w * nrows;
  const int m = col_warp<int32_t>(
      tiles + w / NS * L * NS + w % NS, L, NS, query, nrows, smat, A, gop, gex,
      nullptr, nullptr, nullptr, nullptr, th ? th + col : nullptr,
      te ? te + col : nullptr, 0);
  if ((threadIdx.x & 31) == 0) out[w] = (float)m;
}

}  // namespace

namespace sw {

int row_col_launch(const RowArgs& a, void* th, void* te) {
  const long long warps = (long long)a.T * a.NS;
  sw_row_col_kernel<<<(unsigned)((warps + kColWarps - 1) / kColWarps),
                      kColWarps * 32, 0, a.stream>>>(
      a.tiles, a.query, a.mat, a.A, a.T, a.L, a.NS, a.nrows, a.gop, a.gex,
      (int32_t*)th, (int32_t*)te, a.out);
  return (int)cudaGetLastError();
}

}  // namespace sw

extern "C" {

// The col launch has a signature of its own.  tiles: int8 [T, L, 32, 128];
// queries: int32 [S, W].  With rows non-null it launches col flat (B5):
// rows, offs are int32 [S], the slots' row counts and the first rows of
// their boundary columns in a pool of rtot rows, with no carry, exact
// only.  With rows null and offs non-null it launches col fused (B6): offs
// is int32 [S + 1], the slots' gapless starts in a pool of rtot =
// offs[S] rows, slot s running offs[s + 1] - offs[s] <= W rows; no carry,
// exact only.  With both null it launches col (B3): one slot of W = rtot
// rows, and hin, fin (the int32 carry in) and hout, fout (the int32 carry
// out), each shaped as the tiles or null, in pairs; sat as above.  th, te:
// the boundary columns [T * 4096, rtot], int32 (int16 when sat > 0), null
// allowed when L <= sw_col_pass_columns() or rtot is 0; out: f32
// [S, T, 4096].
int sw_col_launch(const void* tiles, const void* queries, const void* rows,
                  const void* offs, const void* mat, int A, int T, int L,
                  int S, int W, int rtot, int gop, int gex, const void* hin,
                  const void* fin, void* hout, void* fout, void* th, void* te,
                  void* out, int sat, void* stream) {
  const bool carry_ok = !hin == !fin && !hout == !fout;
  const bool slots_ok =
      rows || offs ? offs && !hin && !hout && !sat && (!rows || W <= rtot)
                   : S == 1 && W == rtot;
  if (!carry_ok || !slots_ok || !sat_ok(sat) || S < 1 || S > 65535 ||
      W < 0 || (L > kColPass && rtot > 0 && !(th && te))) {
    return (int)cudaErrorInvalidValue;
  }
  if (T == 0) return 0;
  const dim3 grid((unsigned)((long long)T * kCellNS / kColWarps), (unsigned)S);
  const cudaStream_t st = (cudaStream_t)stream;
  if (rows) {
    sw_col_flat_kernel<<<grid, kColWarps * 32, 0, st>>>(
        (const int8_t*)tiles, (const int32_t*)queries, (const int32_t*)rows,
        (const int32_t*)offs, (const int32_t*)mat, A, T, L, W, rtot, gop, gex,
        (int32_t*)th, (int32_t*)te, (float*)out);
  } else if (offs) {
    sw_col_fused_kernel<<<grid, kColWarps * 32, 0, st>>>(
        (const int8_t*)tiles, (const int32_t*)queries, (const int32_t*)offs,
        (const int32_t*)mat, A, T, L, W, rtot, gop, gex, (int32_t*)th,
        (int32_t*)te, (float*)out);
  } else if (sat) {
    sw_col16_kernel<<<grid, kColWarps * 32, 0, st>>>(
        (const int8_t*)tiles, (const int32_t*)queries, (const int32_t*)mat, A,
        T, L, W, gop, gex, (const int32_t*)hin, (const int32_t*)fin,
        (int32_t*)hout, (int32_t*)fout, (int16_t*)th, (int16_t*)te,
        (float*)out, sat);
  } else {
    sw_col_kernel<<<grid, kColWarps * 32, 0, st>>>(
        (const int8_t*)tiles, (const int32_t*)queries, (const int32_t*)mat, A,
        T, L, W, gop, gex, (const int32_t*)hin, (const int32_t*)fin,
        (int32_t*)hout, (int32_t*)fout, (int32_t*)th, (int32_t*)te,
        (float*)out);
  }
  return (int)cudaGetLastError();
}

// Subject columns per col pass: a col launch over L > this needs the
// boundary columns.
int sw_col_pass_columns() { return kColPass; }

}  // extern "C"
