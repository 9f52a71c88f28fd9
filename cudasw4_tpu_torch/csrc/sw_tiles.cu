// Affine-gap Smith-Waterman over packed subject tiles, for Hopper (sm_90a).
//
// Replaces the eight TPU kernels of the JAX package, all computing the same
// recurrence over int8 subject codes and an int32 AxA substitution matrix
// (A = 21 classic, 26 full-blosum):
//
//   E[i][j] = max(E[i][j-1] + gex, H[i][j-1] + gop)
//   F[i][j] = max(F[i-1][j] + gex, H[i-1][j] + gop)
//   H[i][j] = max(0, H[i-1][j-1] + B[q_i, s_j], E[i][j], F[i][j])
//   score   = max over i, j of H[i][j]
//
// * sw_cell_launch replaces cudasw4_tpu/ops/sw_pallas_cell.py
//   score_bucket_pallas_cell (_sw_cell_kernel, _run_query_sweeps): one
//   query against cell tiles [T, L, 32, 128], a pure reshape of
//   [T, L, 4096].  Exact int32 state (sw_cell_kernel) or, with sat > 0,
//   the int16 contract (sw_cell16_kernel, whose scores are exact).
// * sw_row_launch replaces cudasw4_tpu/ops/sw_pallas.py score_bucket_pallas
//   (_sw_kernel): one query against row tiles [T, L, NS], int32 only; up
//   to the largest cell instance (L <= 768) on the cell group routine
//   (sw_row_kernel), past it on the col wavefront (sw_row_col_kernel).
// * sw_col_launch replaces cudasw4_tpu/ops/sw_pallas_col.py
//   score_bucket_pallas_col (_sw_col_kernel): one query chunk against the
//   cell layout at long L, with the optional int32 H/F carry in and out
//   between query chunks; int32 state (sw_col_kernel) or int16
//   (sw_col16_kernel).
// * sw_cell_launch with rows non-null replaces
//   cudasw4_tpu/ops/sw_pallas_cell.py score_bucket_pallas_cell_batch
//   (_sw_cell_batch_kernel): QB queries [QB, W] against cell tiles in one
//   launch, out [QB, T, 4096] (sw_cell_batch_kernel).
// * sw_col_launch with slots (rows non-null) replaces
//   cudasw4_tpu/ops/sw_pallas_col.py
//   score_bucket_pallas_col_flat (_sw_col_flat_kernel): S query slots of
//   nqp rows each against col tiles in one launch.  As the TPU kernel
//   gives each slot a row range of one VMEM state pool, each slot's
//   boundary columns take rows [off, off + nqp) of one pool of rtot rows.
// * sw_col_launch with gapless starts (rows null, offs non-null) replaces
//   cudasw4_tpu/ops/sw_pallas_col.py score_bucket_pallas_col_flat_fused
//   (_sw_col_flat_fused_kernel): the same slots packed without gaps, the
//   DP restarting at each slot (sw_col_fused_kernel).  The TPU kernel
//   walks the packed rows as one run; here each (slot, subject) warp runs
//   its slot's rows from the top of the matrix, its boundary columns at
//   the slot's pool rows [starts[s], starts[s + 1]).
// * sw_cell_manual_launch replaces cudasw4_tpu/ops/sw_pallas_cell.py
//   score_bucket_pallas_cell_manual (_sw_cell_kernel_manual): B1's
//   contract with the tiles staged by hand through a 2-deep ring in shared
//   memory (int32 or int16 state).
// * sw_cell_pair_launch replaces tools/pairbench.py score_pair
//   (_kernel_pair): B1's contract, exact, P consecutive tiles per block.
//
// The cell kernels (sw_cell_kernel, sw_cell16_kernel, sw_cell_batch_kernel,
// and the row kernel up to L = 768) are single-pass register-tiled group wavefronts, the shape of the
// reference CUDASW++4.0's short-subject kernels.  A cell tile's L is at
// most CELL_MAX_L = 768, so a group of G lanes (8, 16 or 32 of a warp)
// holds a whole subject in registers: lane k keeps R consecutive columns
// (code, H + gop and F of the row above), G x R >= L, picked per L from
// the instances of CELL_SHAPES (ops/sw_cell.py cell_shape).  The query
// streams through the group as through a col warp: lane k scores row i
// at step i + k, taking H + gop and E of its left column from lane k - 1
// by a width-G __shfl_up_sync and the value it took a step earlier as the
// diagonal; lane 0's left column is the matrix edge.  There is no pass
// boundary, no carry and no scratch: a cell kernel reads each tile byte
// once and writes its scores.  Columns past L read the -inf column A of
// the shifted table, so no column mask is needed.  The arithmetic is the
// col kernel's (below): 5.5 DPX operations a cell plus one shared-memory
// lookup.  B4 runs the same routine with slots on the grid's y axis, each
// slot its own row count; B1 int16 runs two subjects a group in s16x2
// lanes (the tile's subjects s and s + 1, one 16-bit load a column), with
// __viaddmax_s16x2 and __vimax_s16x2_relu and one lookup a column pair in
// a pairwise table [A][(A + 1)^2] of both shifted scores.  In a cell
// bucket no H passes min(L, nq) x max B (11,520 at L = 768 and max B =
// 15), so those lanes never wrap and the int16 scores are exact, which
// meets the SAT rule at any SAT; where the launcher cannot prove the fit
// for the matrix and gaps, the kernel runs the int32 routine.  Tiles with
// L beyond the largest instance go to the col kernels (ops/sw_cell.py).
// The row kernel (sw_row_kernel) is B1's routine at a code stride of NS
// in place of 4096: group g scores subject g % NS of row tile g / NS.
//
// The two tool kernels (manual staging, pair) are the first slice's simple
// design: one thread per subject, neighbouring threads owning neighbouring
// subjects, so each load of x[t, j, :] and of the H/F row is coalesced.
// The query streams in blocks of kRows rows; each thread keeps E and
// H[i][j-1] of its kRows rows in registers and sweeps j over the whole
// subject.  The H and F of the row above each block live in a scratch row
// [T, L, 4096] in device memory (read, then overwritten with the block's
// bottom row), so neither the subject length nor the query length is
// capped.  The substitution scores of a block's kRows rows sit in shared
// memory as a query profile prof[c][r] = B[q_{i0+r}, c], one 32-byte read
// per column.  Padded query rows and subject positions carry the pad code,
// whose matrix row is all negative, so they never raise the max.
//
// int16 state (the JAX kernels' exact=False) in the manual-staging and col
// kernels: the arithmetic stays int32 in registers; only the stored state
// is int16, and every store of it clamps H, E and F at sat (<= 32767).
// The TPU kernel clamps H after each query row, which keeps its F below
// sat; here many cells live in registers between stores, so an unclamped
// H can feed F and E, and those are clamped too.  The contract holds per
// subject: a value is clamped only where the cell's own H (>= its E and
// F) reached sat, and the running max tracks the unclamped registers, so
// a subject whose true score is below sat is exact, and one whose score
// reaches sat returns >= sat.
//
// Bound on the H100 SXM (3.35 TB/s; int32 at 132 SMs x 64 lanes x clock,
// 16.7 Tops/s at 1.98 GHz): with the DPX instructions a cell update is 5.5
// int32 operations (below; two cells an operation in s16x2 lanes), and
// the inputs are about one byte per subject position, so every contract
// is bound by operations, by a factor of ~nrows over bytes.  The
// one-thread-per-subject tool kernels move 16 bytes of scratch per kRows
// cells besides (2 B/cell at kRows = 8; 1 B/cell with int16 state), spend
// 11 operations a cell, and leave small buckets without enough warps to
// hide latency.
//
// The col kernels (sw_col_kernel, sw_col16_kernel, sw_col_flat_kernel,
// sw_col_fused_kernel, and the row kernel past L = 768, sw_row_col_kernel,
// at a code stride of NS) are a warp per (slot, subject) register-tiled
// wavefront, the shape of the reference CUDASW++4.0's DPX-s32 multi-pass
// kernels.  What bounds the
// one-thread design at long L is parallelism and scratch: a col tile is
// 4096 subjects, 32 blocks of one thread each, on 132 SMs, and every 8
// rows re-read and re-wrote the L-long H/F row.  Here the parallelism
// comes from the subject's length (> 768 aa in a col bucket), not from the
// query's (which can be 8 rows): a tile is 4096 warps.  Lane k holds
// kColRegs consecutive subject columns in registers (code, H + gop and F
// of the row above); a pass covers kColPass = 32 x kColRegs columns, and a
// subject of L columns takes ceil(L / kColPass) passes.  Inside a pass the
// query streams through the warp: lane k scores row i at step i + k,
// taking H + gop and E of its left column at row i from lane k - 1 by
// __shfl_up_sync, and the value it took one step earlier as the diagonal.
// Lane 0 takes the previous pass's boundary column (H, E at the column
// left of the pass) for row i, and lane 31 produces this pass's: both go
// through a per-warp column of rows in device memory, one buffer updated
// in place (the rows are read in 32-row groups one group ahead, before
// lane 31 rewrites them, and written in 32-row groups gathered from lane
// 31 by shuffles).  Its traffic is 16 bytes a row per kColPass columns,
// 0.03 B a cell at kColRegs = 16, against 2 B a cell in the one-thread
// design; the top col tile at 464 rows needs a 15.2 MB column pair, which
// L2 holds.  The col carry maps onto the registers: state_in is each
// column's initial H and F (else H = 0, F = -inf), and emit_state stores
// them after the pass's last row.  With the substitution matrix in shared
// memory shifted by -gop (smat[q][c] = B[q][c] - gop, so the diagonal
// H + gop plus it is H + B), a cell is 5.5 operations: E =
// __viaddmax_s32(E, gex, Hleft + gop), F = __viaddmax_s32(F, gex,
// Hup + gop), H = __vimax3_s32_relu(diag + sub, E, F) (two: the add fused
// into a max with E, then a max with F), H + gop (shared by the next
// column's E and the next row's F), and the running max, which nvcc takes
// over two cells in one 3-input max (VIMNMX3); plus the shared-memory
// lookup.  Columns past L (a partial last pass) take
// substitution column A, which is -inf: every H there stays below an H
// of the warp's real cells, so no column mask is needed in the inner
// loop.  int16 state clamps the boundary column and the emitted carry
// (int32, clamped) at sat.  kColRegs, kColWarps and kColMinBlocks were
// chosen on the H100: see their definitions.
//
// The manual-staging kernel is the Hopper form of the TPU kernel's copy of
// tile t+1 started before tile t's compute: a persistent grid (as
// many blocks as fit on the card at once) whose blocks each walk 128-
// subject stripes k = blockIdx.x, + gridDim.x, ...  A stripe is L x 128
// bytes; the block stages it through a 2-deep ring of CH-column chunks
// in dynamic shared memory with cp.async (16 B a copy, commit/wait_group)
// and starts the next chunk's copy before it sweeps the current one.
// The wrapper passes CH = min(64, L): the chunks of a longer stripe
// stream again for every 8-row block, 2 x 8 KB a block; a stripe of
// L <= 64 is one chunk, copied once and held for all its query rows.  (A
// whole-stripe ring at L = 640 takes 160 KB, one block per SM, and ran at
// about 1.9 times the chunked ring's time.)  The pair kernel gives each
// block 128 lanes of P consecutive tiles and scores them one after
// another: T / P x 32 blocks.  The JAX tool's unroll has no counterpart:
// the register block is kRows.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kNeg = -(1 << 24);  // -inf stand-in, safe from int32 underflow
constexpr int kMaxAlphabet = 26;
constexpr int kRows = 8;      // query rows per register block
constexpr int kCols = 8;      // subject positions loaded ahead per step
constexpr int kThreads = 128; // subjects per block
constexpr int kCellNS = 4096; // subjects per cell tile: [T, L, 32, 128]

// A stored state value: int32 as it is; int16 clamped at sat.
template <typename St>
__device__ __forceinline__ St to_state(int v, int sat) {
  if constexpr (std::is_same<St, int32_t>::value) {
    return v;
  } else {
    return (St)min(v, sat);
  }
}

// The kRows cells of one subject column j: prof[c * kRows + r] =
// B[q_r, c] for the column's code c; hup/fup: H and F of the row above,
// replaced by the block's bottom row; diag_next: H[i0 - 1][j - 1] in,
// H[i0 - 1][j] out; e/hl: each row's E and H[j - 1], carried in j.
template <bool kFull>
__device__ __forceinline__ void update_column(
    const int* prof, int c, int& hup, int& fup, int& diag_next,
    int (&e)[kRows], int (&hl)[kRows], int nr, int gop, int gex, int& m) {
  const int4* p4 = reinterpret_cast<const int4*>(prof + c * kRows);
  const int4 lo = p4[0], hi = p4[1];
  const int sub[kRows] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  int diag = diag_next;
  diag_next = hup;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (kFull || r < nr) {
      const int ee = max(e[r] + gex, hl[r] + gop);
      const int ff = max(fup + gex, hup + gop);
      const int h = max(max(diag + sub[r], max(ee, ff)), 0);
      m = max(m, h);
      diag = hl[r];
      hl[r] = h;
      e[r] = ee;
      hup = h;
      fup = ff;
    }
  }
}

// Sweep query rows [i0, i0 + nr) over all L positions of one subject.
// hsrc/fsrc: the row above (may alias hs/fs); from_zero: the row above is
// the top of the DP matrix (H = 0, F = -inf).  St: the scratch row's type.
template <bool kFull, typename St = int32_t>
__device__ __forceinline__ void sweep_block(
    const int8_t* __restrict__ x, const St* hsrc, const St* fsrc,
    bool from_zero, St* hs, St* fs, const int* prof, int L, int NS, int nr,
    int gop, int gex, int& m, int sat = 0) {
  int e[kRows], hl[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    e[r] = kNeg;
    hl[r] = 0;
  }
  int diag_next = 0;  // H[i0 - 1][j - 1]; column -1 is all zeros
  for (int j0 = 0; j0 < L; j0 += kCols) {
    int hv[kCols], fv[kCols], cv[kCols];
#pragma unroll
    for (int jj = 0; jj < kCols; ++jj) {
      if (j0 + jj < L) {
        const size_t o = (size_t)(j0 + jj) * NS;
        hv[jj] = from_zero ? 0 : hsrc[o];
        fv[jj] = from_zero ? kNeg : fsrc[o];
        cv[jj] = x[o];
      }
    }
#pragma unroll
    for (int jj = 0; jj < kCols; ++jj) {
      if (j0 + jj < L) {
        update_column<kFull>(prof, cv[jj], hv[jj], fv[jj], diag_next, e, hl,
                             nr, gop, gex, m);
      }
    }
#pragma unroll
    for (int jj = 0; jj < kCols; ++jj) {
      if (j0 + jj < L) {
        const size_t o = (size_t)(j0 + jj) * NS;
        hs[o] = to_state<St>(hv[jj], sat);
        fs[o] = to_state<St>(fv[jj], sat);
      }
    }
  }
}

// sweep_block at the block's row count: the full kRows or a ragged tail.
template <typename St>
__device__ __forceinline__ void sweep_rows(
    const int8_t* __restrict__ x, const St* hsrc, const St* fsrc,
    bool from_zero, St* hs, St* fs, const int* prof, int L, int NS, int nr,
    int gop, int gex, int& m, int sat) {
  if (nr == kRows) {
    sweep_block<true, St>(x, hsrc, fsrc, from_zero, hs, fs, prof, L, NS, nr,
                          gop, gex, m, sat);
  } else {
    sweep_block<false, St>(x, hsrc, fsrc, from_zero, hs, fs, prof, L, NS, nr,
                           gop, gex, m, sat);
  }
}

// Fill prof[c * kRows + r] = B[q[r], c] for the rows r < nr (0 past them).
// Every thread of the block calls it: it synchronises before (smat is
// loaded, the previous profile is consumed) and after.
__device__ __forceinline__ void build_profile(const int32_t* __restrict__ q,
                                              int nr, const int* smat,
                                              int* prof, int A) {
  __syncthreads();
  for (int k = threadIdx.x; k < A * kRows; k += blockDim.x) {
    const int c = k / kRows, r = k % kRows;
    prof[k] = r < nr ? smat[q[r] * A + c] : 0;
  }
  __syncthreads();
}

// Build the substitution profile of the query rows q[0, nr) and sweep them
// over this thread's subject.  Every thread of the block calls it: it
// synchronises.  hsrc/fsrc: the row above; from_zero: that row is the top
// of the DP matrix (H = 0, F = -inf).
__device__ __forceinline__ void run_rows(
    const int32_t* __restrict__ q, int nr, const int* smat, int* prof, int A,
    const int8_t* __restrict__ x, const int32_t* hsrc, const int32_t* fsrc,
    bool from_zero, int32_t* hs, int32_t* fs, int L, int NS, int gop, int gex,
    int& m) {
  build_profile(q, nr, smat, prof, A);
  sweep_rows<int32_t>(x, hsrc, fsrc, from_zero, hs, fs, prof, L, NS, nr, gop,
                      gex, m, 0);
}

// ------------------------------- B3, B5 and B6: the col wavefront

// The constants below were chosen by timing variants against each other
// with cudasw4_tpu_torch/tools/kernel_ab.py on an H100 (PERF.md).
//
// Subject columns a lane holds in registers (R): a pass is 32 x R
// columns.  The register cost is 3 x R (code, H + gop, F), and the warp's
// per-step overhead (shuffles, query and boundary traffic) is shared by R
// cells.  R = 16 divides LC = 128, and 512 divides the top col bucket's
// L = 5632 and L = 1024.  R = 8 was 10-25% slower; R = 12 as fast on the
// top col tile and 14% slower at L = 1024; R = 20 (a 640-column pass) 9%
// faster on the top tile and 12% slower at L = 1024 with uncapped
// registers, and spills under the cap below.
constexpr int kColRegs = 16;
constexpr int kColPass = 32 * kColRegs;
// Warps (subjects) per block, sharing the shifted substitution matrix: 2
// and 8 timed within 3% of 4, and 8 was 9% slower on col flat.
constexpr int kColWarps = 4;
// Blocks per SM that the col kernels' registers must allow (ptxas caps
// them at 65536 / (kColMinBlocks x kColWarps x 32) a thread, 102): 20
// warps an SM to hide the wavefront's dependent chain, 5-13% faster than
// the 108 registers (16 warps) the compiler takes uncapped; 6 spills and
// is slower.
constexpr int kColMinBlocks = 5;
constexpr unsigned kWarpAll = 0xffffffffu;

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

// ------------------------------------------------ B8: P tiles per block

// Block b owns lanes (b % 32) * 128 .. + 127 of tiles (b / 32) * P .. + P - 1
// and scores them one after another, each from the top of the DP matrix.
__global__ void __launch_bounds__(kThreads) sw_pair_kernel(
    const int8_t* tiles, const int32_t* query, const int32_t* mat, int A,
    int L, int nrows, int gop, int gex, int P, int32_t* hs, int32_t* fs,
    float* out) {
  __shared__ int smat[kMaxAlphabet * kMaxAlphabet];
  __shared__ __align__(16) int prof[kMaxAlphabet * kRows];
  const int s = (blockIdx.x % (kCellNS / kThreads)) * kThreads + threadIdx.x;
  const int t0 = blockIdx.x / (kCellNS / kThreads) * P;
  for (int k = threadIdx.x; k < A * A; k += blockDim.x) smat[k] = mat[k];
  for (int t = t0; t < t0 + P; ++t) {
    const size_t base = (size_t)t * L * kCellNS + s;
    int m = 0;
    for (int i0 = 0; i0 < nrows; i0 += kRows) {
      run_rows(query + i0, min(kRows, nrows - i0), smat, prof, A, tiles + base,
               hs + base, fs + base, i0 == 0, hs + base, fs + base, L,
               kCellNS, gop, gex, m);
    }
    out[(size_t)t * kCellNS + s] = (float)m;
  }
}

// ------------------------------------- B7: manual staging of the tiles

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

// Start the copies of columns [j0, j0 + ncols) of stripe k (tile k / 32,
// lanes (k % 32) * 128 ..) into dst, 128 bytes a column, as one group.
__device__ __forceinline__ void stage_chunk(int8_t* dst,
                                            const int8_t* __restrict__ tiles,
                                            int k, int j0, int ncols, int L) {
  const int8_t* src =
      tiles + ((size_t)(k >> 5) * L + j0) * kCellNS + (k & 31) * kThreads;
  for (int i = threadIdx.x; i < ncols * 8; i += blockDim.x) {
    const int j = i >> 3, part = (i & 7) * 16;
    cp_async16(dst + j * kThreads + part, src + (size_t)j * kCellNS + part);
  }
  cp_async_commit();
}

// Columns [j_begin, j_end) of one subject for the query rows of the
// current profile, with the subject's codes xs[(j - j_begin) * 128] in
// shared memory and the row carry (e, hl, diag_next) in registers.
template <bool kFull, typename St>
__device__ __forceinline__ void sweep_span(
    const int8_t* xs, St* hs, St* fs, bool from_zero, const int* prof,
    int j_begin, int j_end, int nr, int gop, int gex, int sat,
    int (&e)[kRows], int (&hl)[kRows], int& diag_next, int& m) {
  for (int j0 = j_begin; j0 < j_end; j0 += kCols) {
    int hv[kCols], fv[kCols], cv[kCols];
#pragma unroll
    for (int jj = 0; jj < kCols; ++jj) {
      if (j0 + jj < j_end) {
        const size_t o = (size_t)(j0 + jj) * kCellNS;
        hv[jj] = from_zero ? 0 : hs[o];
        fv[jj] = from_zero ? kNeg : fs[o];
        cv[jj] = xs[(j0 + jj - j_begin) * kThreads];
      }
    }
#pragma unroll
    for (int jj = 0; jj < kCols; ++jj) {
      if (j0 + jj < j_end) {
        update_column<kFull>(prof, cv[jj], hv[jj], fv[jj], diag_next, e, hl,
                             nr, gop, gex, m);
      }
    }
#pragma unroll
    for (int jj = 0; jj < kCols; ++jj) {
      if (j0 + jj < j_end) {
        const size_t o = (size_t)(j0 + jj) * kCellNS;
        hs[o] = to_state<St>(hv[jj], sat);
        fs[o] = to_state<St>(fv[jj], sat);
      }
    }
  }
}

// Persistent grid over the T x 32 stripes of 128 subjects.  The ring:
// two slots of CH columns x 128 bytes in dynamic shared memory.  With
// CH == L a stripe is one chunk, copied once and kept for all its row
// blocks; otherwise every (row block, chunk) of a stripe is a copy.  The
// next copy in this block's order starts before the current chunk is
// swept, so it overlaps the sweep.
template <typename St>
__global__ void __launch_bounds__(kThreads) sw_manual_kernel(
    const int8_t* tiles, const int32_t* query, const int32_t* mat, int A,
    int T, int L, int nrows, int gop, int gex, int CH, St* hs, St* fs,
    float* out, int sat) {
  extern __shared__ __align__(16) int8_t ring[];
  __shared__ int smat[kMaxAlphabet * kMaxAlphabet];
  __shared__ __align__(16) int prof[kMaxAlphabet * kRows];
  const int nstripes = T * (kCellNS / kThreads);
  const int nch = (L + CH - 1) / CH;
  const int rbs = max(1, (nrows + kRows - 1) / kRows);  // row blocks walked
  for (int k = threadIdx.x; k < A * A; k += blockDim.x) smat[k] = mat[k];
  int slot = 0, cur = 0;
  if ((int)blockIdx.x < nstripes) {
    stage_chunk(ring, tiles, blockIdx.x, 0, min(CH, L), L);
  }
  for (int k = blockIdx.x; k < nstripes; k += gridDim.x) {
    const size_t base = (size_t)(k >> 5) * L * kCellNS + (k & 31) * kThreads +
                        threadIdx.x;
    int m = 0;
    for (int rb = 0; rb < rbs; ++rb) {
      const int i0 = rb * kRows;
      const int nr = min(kRows, nrows - i0);  // <= 0 for an empty query
      build_profile(query + i0, max(nr, 0), smat, prof, A);
      int e[kRows], hl[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        e[r] = kNeg;
        hl[r] = 0;
      }
      int diag_next = 0;
      for (int c = 0; c < nch; ++c) {
        if (nch > 1 || rb == 0) {
          // The copy after this one, in this block's order.
          int nk = k, nc = c + 1;
          if (nch == 1 || (nc == nch && rb + 1 == rbs)) {
            nk = k + gridDim.x;
            nc = 0;
          } else if (nc == nch) {
            nc = 0;
          }
          __syncthreads();  // nobody still reads the slot it overwrites
          if (nk < nstripes) {
            stage_chunk(ring + (slot ^ 1) * CH * kThreads, tiles, nk, nc * CH,
                        min(CH, L - nc * CH), L);
            cp_async_wait<1>();
          } else {
            cp_async_wait<0>();
          }
          __syncthreads();  // the current chunk is in, for every thread
          cur = slot;
          slot ^= 1;
        }
        if (nr <= 0) continue;
        const int j_begin = c * CH, j_end = min(L, j_begin + CH);
        const int8_t* xs = ring + cur * CH * kThreads + threadIdx.x;
        if (nr == kRows) {
          sweep_span<true, St>(xs, hs + base, fs + base, rb == 0, prof,
                               j_begin, j_end, nr, gop, gex, sat, e, hl,
                               diag_next, m);
        } else {
          sweep_span<false, St>(xs, hs + base, fs + base, rb == 0, prof,
                                j_begin, j_end, nr, gop, gex, sat, e, hl,
                                diag_next, m);
        }
      }
    }
    out[(size_t)(k >> 5) * kCellNS + (k & 31) * kThreads + threadIdx.x] =
        (float)m;
  }
}

template <typename St>
int manual_launch(const void* tiles, const void* query, const void* mat,
                  int A, int T, int L, int nrows, int gop, int gex, int sat,
                  int CH, void* hs, void* fs, void* out, cudaStream_t stream) {
  const size_t ring = (size_t)2 * CH * kThreads;
  cudaError_t err = cudaFuncSetAttribute(
      sw_manual_kernel<St>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)ring);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, sw_manual_kernel<St>, kThreads, ring);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long stripes = (long long)T * (kCellNS / kThreads);
  const long long resident = (long long)per_sm * sms;
  const unsigned grid = (unsigned)(stripes < resident ? stripes : resident);
  sw_manual_kernel<St><<<grid, kThreads, ring, stream>>>(
      (const int8_t*)tiles, (const int32_t*)query, (const int32_t*)mat, A, T,
      L, nrows, gop, gex, CH, (St*)hs, (St*)fs, (float*)out, sat);
  return (int)cudaGetLastError();
}

// sat: 0 for exact int32 state, else the int16 state's ceiling.
bool sat_ok(int sat) { return sat >= 0 && sat <= 32767; }

// ------------------------- B1, B2 and B4: the single-pass cell wavefront

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
#define CELL_SHAPES(X)                                                    \
  X(8, 2) X(8, 4) X(8, 6) X(8, 8) X(8, 10) X(8, 12) X(8, 14) X(8, 16)     \
  X(8, 18) X(8, 20) X(8, 22) X(8, 24) X(8, 26) X(8, 28) X(8, 30)          \
  X(8, 32) X(16, 17) X(16, 18) X(16, 19) X(16, 20) X(16, 21) X(16, 22)    \
  X(16, 23) X(16, 24) X(16, 25) X(16, 26) X(16, 27) X(16, 28) X(16, 29)   \
  X(16, 30) X(16, 31) X(16, 32) X(16, 33) X(16, 34) X(16, 35) X(16, 36)   \
  X(32, 19) X(32, 20) X(32, 21) X(32, 22) X(32, 23) X(32, 24)

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

// The shifted substitution score B[q][c] - gop, neg in column A.
__device__ __forceinline__ int shifted(const int32_t* __restrict__ mat, int A,
                                       int q, int c, int gop, int neg) {
  return c < A ? mat[q * A + c] - gop : neg;
}

// Fill tab, every thread of the block: [A][A + 1] shifted scores, or with
// kPair the pairwise table [A][(A + 1)^2] of both halfwords.
template <bool kPair>
__device__ __forceinline__ void load_cell_table(
    int* tab, const int32_t* __restrict__ mat, int A, int gop, int neg) {
  const int A1 = A + 1, row = kPair ? A1 * A1 : A1;
  for (int k = threadIdx.x; k < A * row; k += blockDim.x) {
    const int q = k / row, c = k % row;
    if (kPair) {
      const unsigned lo = shifted(mat, A, q, c / A1, gop, neg);
      const unsigned hi = shifted(mat, A, q, c % A1, gop, neg);
      tab[k] = (int)((lo & 0xffffu) | (hi << 16));
    } else {
      tab[k] = shifted(mat, A, q, c, gop, neg);
    }
  }
}

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

struct CellArgs {
  const int8_t* tiles;
  const int32_t* queries;
  const int32_t* rows;
  const int32_t* mat;
  int A, T, L, S, W, gop, gex, sat;
  float* out;
  cudaStream_t stream;
};

template <int G, int R>
int cell_launch_at(const CellArgs& a) {
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

// The instance that scores L columns in one pass, as ops/sw_cell.py
// cell_shape picks it: the least G x R >= L, then the least G.  False past
// the largest instance.
bool cell_pick(int L, int& G, int& R) {
  G = R = 0;
#define CELL_PICK(g, r)                                                   \
  if (g * r >= L && (!G || g * r < G * R || (g * r == G * R && g < G))) { \
    G = g;                                                                \
    R = r;                                                                \
  }
  CELL_SHAPES(CELL_PICK)
#undef CELL_PICK
  return G != 0;
}

struct RowArgs {
  const int8_t* tiles;
  const int32_t* query;
  const int32_t* mat;
  int A, T, L, NS, nrows, gop, gex;
  float* out;
  cudaStream_t stream;
};

template <int G, int R>
int row_launch_at(const RowArgs& a) {
  const long long threads = (long long)a.T * a.NS * G;
  sw_row_kernel<G, R>
      <<<(unsigned)((threads + kCellThreads - 1) / kCellThreads), kCellThreads,
         0, a.stream>>>(a.tiles, a.query, a.mat, a.A, a.T, a.L, a.NS, a.nrows,
                        a.gop, a.gex, a.out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each launch function returns cudaGetLastError() after the launch (0 on
// success), or cudaErrorInvalidValue for arguments outside its contract.
// Pointers are device pointers; stream is a cudaStream_t.  Query and tile
// codes must lie in [0, A), A <= 26; sat = 0 is exact int32 state, and
// 0 < sat <= 32767 int16 state.
//
// The cell launch (B1 in both state modes, B4).  tiles: int8
// [T, L, 32, 128]; queries: int32 [S, W]; out: f32 [S, T, 4096]; (G, R):
// an instance of CELL_SHAPES with G x R >= L.  With rows null it launches
// B1: one query of W rows (S = 1), sw_cell_kernel, or sw_cell16_kernel
// for sat > 0.  With rows non-null it launches B4, sw_cell_batch_kernel:
// rows int32 [S], the slots' row counts (each <= W), exact only.  No
// scratch: the cell kernels keep the whole DP row in registers.
int sw_cell_launch(const void* tiles, const void* queries, const void* rows,
                   const void* mat, int A, int T, int L, int S, int W,
                   int gop, int gex, int G, int R, int sat, void* out,
                   void* stream) {
  if (!sat_ok(sat) || (rows ? sat != 0 : S != 1) || S < 1 || S > 65535 ||
      W < 0 || L < 0 || G * R < L) {
    return (int)cudaErrorInvalidValue;
  }
  if (T == 0) return 0;
  const CellArgs a{(const int8_t*)tiles, (const int32_t*)queries,
                   (const int32_t*)rows, (const int32_t*)mat, A, T, L, S, W,
                   gop, gex, sat, (float*)out, (cudaStream_t)stream};
#define CELL_CASE(g, r) \
  if (G == g && R == r) return cell_launch_at<g, r>(a);
  CELL_SHAPES(CELL_CASE)
#undef CELL_CASE
  return (int)cudaErrorInvalidValue;  // not an instance
}

// The cell kernels' (G, R) instances: writes up to cap / 2 pairs to out
// and returns their count.
int sw_cell_shapes(int* out, int cap) {
  int n = 0;
#define CELL_PUT(g, r)      \
  if (2 * n + 1 < cap) {    \
    out[2 * n] = g;         \
    out[2 * n + 1] = r;     \
  }                         \
  ++n;
  CELL_SHAPES(CELL_PUT)
#undef CELL_PUT
  return n;
}

// The row launch (B2): row tiles [T, L, NS], out f32 [T, NS]; exact only.
// Up to the largest cell instance it launches sw_row_kernel at the
// instance for L (cell_pick), with no scratch; past it sw_row_col_kernel,
// whose boundary columns th, te are int32 [T * NS, nrows] (null allowed
// when L <= sw_col_pass_columns() or nrows is 0).
int sw_row_launch(const void* tiles, const void* query, const void* mat,
                  int A, int T, int L, int NS, int nrows, int gop, int gex,
                  void* th, void* te, void* out, int sat, void* stream) {
  if (sat || T < 0 || L < 0 || NS < 1 || nrows < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (T == 0) return 0;
  const RowArgs a{(const int8_t*)tiles, (const int32_t*)query,
                  (const int32_t*)mat, A, T, L, NS, nrows, gop, gex,
                  (float*)out, (cudaStream_t)stream};
  int G, R;
  if (cell_pick(L, G, R)) {
#define ROW_CASE(g, r) \
  if (G == g && R == r) return row_launch_at<g, r>(a);
    CELL_SHAPES(ROW_CASE)
#undef ROW_CASE
  }
  if (L > kColPass && nrows > 0 && !(th && te)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long warps = (long long)T * NS;
  sw_row_col_kernel<<<(unsigned)((warps + kColWarps - 1) / kColWarps),
                      kColWarps * 32, 0, a.stream>>>(
      a.tiles, a.query, a.mat, A, T, L, NS, nrows, gop, gex, (int32_t*)th,
      (int32_t*)te, a.out);
  return (int)cudaGetLastError();
}

// The two tool kernels share a third signature: cell tiles [T, L, 32, 128],
// scratch hs/fs shaped as the tiles (int16 when sat > 0), out f32
// [T, 4096]; arg is the ring's chunk columns CH (manual; 1 <= CH <= L, and
// 2 x CH x 128 bytes of shared memory must fit a block) or the tiles per
// block P (pair; exact only, T % P == 0).

int sw_cell_manual_launch(const void* tiles, const void* query,
                          const void* mat, int A, int T, int L, int nrows,
                          int gop, int gex, int sat, int arg, void* hs,
                          void* fs, void* out, void* stream) {
  if (!sat_ok(sat) || arg < 1) return (int)cudaErrorInvalidValue;
  if (T == 0) return 0;
  if (sat) {
    return manual_launch<int16_t>(tiles, query, mat, A, T, L, nrows, gop, gex,
                                  sat, arg, hs, fs, out,
                                  (cudaStream_t)stream);
  }
  return manual_launch<int32_t>(tiles, query, mat, A, T, L, nrows, gop, gex,
                                0, arg, hs, fs, out, (cudaStream_t)stream);
}

int sw_cell_pair_launch(const void* tiles, const void* query, const void* mat,
                        int A, int T, int L, int nrows, int gop, int gex,
                        int sat, int arg, void* hs, void* fs, void* out,
                        void* stream) {
  if (sat || arg < 1 || T % arg) return (int)cudaErrorInvalidValue;
  if (T == 0) return 0;
  const unsigned grid = (unsigned)((long long)(T / arg) * (kCellNS / kThreads));
  sw_pair_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)tiles, (const int32_t*)query, (const int32_t*)mat, A, L,
      nrows, gop, gex, arg, (int32_t*)hs, (int32_t*)fs, (float*)out);
  return (int)cudaGetLastError();
}

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

const char* sw_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
