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
//   int16 state saturating at sat (sw_cell16_kernel).
// * sw_row_launch replaces cudasw4_tpu/ops/sw_pallas.py score_bucket_pallas
//   (_sw_kernel): one query against row tiles [T, L, NS], int32 only.
// * sw_col_launch replaces cudasw4_tpu/ops/sw_pallas_col.py
//   score_bucket_pallas_col (_sw_col_kernel): one query chunk against the
//   cell layout at long L, with the optional int32 H/F carry in and out
//   between query chunks; int32 state (sw_col_kernel) or int16
//   (sw_col16_kernel).
// * sw_cell_batch_launch replaces cudasw4_tpu/ops/sw_pallas_cell.py
//   score_bucket_pallas_cell_batch (_sw_cell_batch_kernel): QB queries
//   [QB, W] against cell tiles in one launch, out [QB, T, 4096].
// * sw_col_launch with slots (rows non-null) replaces
//   cudasw4_tpu/ops/sw_pallas_col.py
//   score_bucket_pallas_col_flat (_sw_col_flat_kernel): S query slots of
//   nqp rows each against col tiles in one launch.  As the TPU kernel
//   gives each slot a row range of one VMEM state pool, each slot's
//   boundary columns take rows [off, off + nqp) of one pool of rtot rows.
// * sw_col_fused_launch replaces cudasw4_tpu/ops/sw_pallas_col.py
//   score_bucket_pallas_col_flat_fused (_sw_col_flat_fused_kernel): the
//   same slots walked as one gapless run of rows, with the DP reset to the
//   top of the matrix at each slot boundary and the slot's max flushed.
// * sw_cell_manual_launch replaces cudasw4_tpu/ops/sw_pallas_cell.py
//   score_bucket_pallas_cell_manual (_sw_cell_kernel_manual): B1's
//   contract with the tiles staged by hand through a 2-deep ring in shared
//   memory (int32 or int16 state).
// * sw_cell_pair_launch replaces tools/pairbench.py score_pair
//   (_kernel_pair): B1's contract, exact, P consecutive tiles per block.
//
// Design of the cell, row, batch and tool kernels (simple and right
// first; speed is later work).  One thread per subject: neighbouring
// threads own neighbouring subjects, so each load of x[t, j, :] and of the
// H/F row is coalesced.  The query streams in blocks of kRows rows; each
// thread keeps E and H[i][j-1] of its kRows rows in registers and sweeps j
// over the whole subject.  The H and F of the row above each block live in
// a scratch row [T, L, NS] in device memory (read, then overwritten with
// the block's bottom row), so neither the subject length nor the query
// length is capped.  The substitution scores of a block's kRows rows sit
// in shared memory as a query profile prof[c][r] = B[q_{i0+r}, c], one
// 32-byte read per column.  Padded query rows and subject positions carry
// the pad code, whose matrix row is all negative, so they never raise the
// max.
//
// int16 state (the JAX kernels' exact=False): the arithmetic stays int32
// in registers; only the stored state is int16, and every store of it
// clamps H, E and F at sat (<= 32767).  The TPU kernel clamps H after
// each query row, which keeps its F below sat; here many cells live in
// registers between stores, so an unclamped H can feed F and E, and those
// are clamped too.  The contract holds per subject: a value is clamped
// only where the cell's own H (>= its E and F) reached sat, and the
// running max tracks the unclamped registers, so a subject whose true
// score is below sat is exact, and one whose score reaches sat returns
// >= sat.
//
// Bound on the H100 SXM (3.35 TB/s; int32 at 132 SMs x 64 lanes x clock,
// 16.7 Tops/s at 1.98 GHz): with the DPX instructions a cell update is 5.5
// int32 operations (below), and the inputs are about one byte per subject
// position, so every contract is bound by operations, by a factor of
// ~nrows over bytes.  The one-thread-per-subject kernels move 16 bytes of
// scratch per kRows cells besides (2 B/cell at kRows = 8; 1 B/cell with
// int16 state), spend 11 operations a cell, and leave small buckets
// without enough warps to hide latency.
//
// The batch kernels have the same bound: 5.5 operations per cell of every
// slot, while the tiles are read once per call.  Cell batch puts slots on
// the grid's y axis: blockIdx.y picks one of P scratch planes (P = slots,
// capped by the wrapper's scratch budget) and scores slots y, y + P, ...
// on it, so a launch fills P times the blocks of a single query and takes
// P x 8 bytes per tile char of scratch (the top Swiss-Prot-scale cell
// bucket [12, 640, 32, 128]: 251.7 MB a plane).  The fused col kernel
// walks its slots one after another on one plane: the blocks and scratch
// of a single query, for S queries' rows.
//
// The col kernels (sw_col_kernel, sw_col16_kernel, sw_col_flat_kernel)
// are a warp per (slot, subject) register-tiled wavefront, the shape of
// the reference CUDASW++4.0's DPX-s32 multi-pass kernels.  What bounds the
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

// One block = kThreads subjects of one tile; the grid is flat over
// (tile, subject block).  Writes out[t, s] = max H as float.  St: the
// scratch rows' type (int16 saturates at sat).
template <typename St>
__device__ __forceinline__ void sw_tiles_body(
    const int8_t* __restrict__ tiles, const int32_t* __restrict__ query,
    const int32_t* __restrict__ mat, int A, int L, int NS, int nrows,
    int gop, int gex, St* hs, St* fs, float* __restrict__ out, int sat) {
  __shared__ int smat[kMaxAlphabet * kMaxAlphabet];
  __shared__ __align__(16) int prof[kMaxAlphabet * kRows];
  const int blocks_per_tile = (NS + kThreads - 1) / kThreads;
  const int t = blockIdx.x / blocks_per_tile;
  const int s = (blockIdx.x % blocks_per_tile) * kThreads + threadIdx.x;
  const bool live = s < NS;
  const size_t base = (size_t)t * L * NS + s;
  for (int k = threadIdx.x; k < A * A; k += blockDim.x) smat[k] = mat[k];
  int m = 0;
  for (int i0 = 0; i0 < nrows; i0 += kRows) {
    const int nr = min(kRows, nrows - i0);
    __syncthreads();  // smat is loaded; the previous profile is consumed
    for (int k = threadIdx.x; k < A * kRows; k += blockDim.x) {
      const int c = k / kRows, r = k % kRows;
      prof[k] = r < nr ? smat[query[i0 + r] * A + c] : 0;
    }
    __syncthreads();
    if (live) {
      sweep_rows<St>(tiles + base, hs + base, fs + base, i0 == 0, hs + base,
                     fs + base, prof, L, NS, nr, gop, gex, m, sat);
    }
  }
  if (live) out[(size_t)t * NS + s] = (float)m;
}

// Build the substitution profile of the query rows q[0, nr) and sweep them
// over this thread's subject.  Every thread of the block calls it: it
// synchronises.  hsrc/fsrc: the row above; from_zero: that row is the top
// of the DP matrix (H = 0, F = -inf).
__device__ __forceinline__ void run_rows(
    const int32_t* __restrict__ q, int nr, const int* smat, int* prof, int A,
    bool live, const int8_t* __restrict__ x, const int32_t* hsrc,
    const int32_t* fsrc, bool from_zero, int32_t* hs, int32_t* fs, int L,
    int NS, int gop, int gex, int& m) {
  build_profile(q, nr, smat, prof, A);
  if (!live) return;
  sweep_rows<int32_t>(x, hsrc, fsrc, from_zero, hs, fs, prof, L, NS, nr, gop,
                      gex, m, 0);
}

// Batch bodies over cell-layout tiles [T, L, 4096] and a query block
// [S, W]; out is [S, T, 4096].  A block owns kThreads subjects of one tile
// (blockIdx.x) and one H/F scratch plane (blockIdx.y) of [T, L, 4096].
constexpr int kCellNS = 4096;

struct BatchBlock {
  int t, s;
  size_t base;  // offset of this thread's subject in a [T, L, 4096] array
  int32_t* h;   // this thread's column of its block's scratch plane
  int32_t* f;
};

__device__ __forceinline__ BatchBlock batch_block(int T, int L, int32_t* hs,
                                                  int32_t* fs) {
  BatchBlock b;
  b.t = blockIdx.x / (kCellNS / kThreads);
  b.s = (blockIdx.x % (kCellNS / kThreads)) * kThreads + threadIdx.x;
  b.base = (size_t)b.t * L * kCellNS + b.s;
  const size_t plane = (size_t)blockIdx.y * T * L * kCellNS;
  b.h = hs + plane + b.base;
  b.f = fs + plane + b.base;
  return b;
}

// B4: slot q runs its nrows[q] rows from the top of the DP matrix.
// The block scores slots blockIdx.y, blockIdx.y + gridDim.y, ... one after
// another on its plane, so a launch of P planes fills P times the blocks of
// a single-query launch and takes P scratch planes.
__device__ __forceinline__ void sw_batch_body(
    const int8_t* __restrict__ tiles, const int32_t* __restrict__ queries,
    const int32_t* __restrict__ nrows, const int32_t* __restrict__ mat,
    int A, int T, int L, int S, int W, int gop, int gex, int32_t* hs,
    int32_t* fs, float* __restrict__ out) {
  __shared__ int smat[kMaxAlphabet * kMaxAlphabet];
  __shared__ __align__(16) int prof[kMaxAlphabet * kRows];
  const BatchBlock b = batch_block(T, L, hs, fs);
  for (int k = threadIdx.x; k < A * A; k += blockDim.x) smat[k] = mat[k];
  for (int q = blockIdx.y; q < S; q += gridDim.y) {
    const int32_t* qrow = queries + (size_t)q * W;
    const int n = nrows[q];
    int m = 0;
    for (int i0 = 0; i0 < n; i0 += kRows) {
      run_rows(qrow + i0, min(kRows, n - i0), smat, prof, A, true,
               tiles + b.base, b.h, b.f, i0 == 0, b.h, b.f, L, kCellNS, gop,
               gex, m);
    }
    out[((size_t)q * T + b.t) * kCellNS + b.s] = (float)m;
  }
}

// B6: one scratch plane; the block walks the slots' rows concatenated
// without gaps, rows [starts[q], starts[q + 1]) being slot q's.  At a slot's
// first row the row above is reset to H = 0, F = -inf (from_zero); where a
// slot ends its maximum is flushed to out and the running max restarts.
// Slot boundaries must fall on kRows-row block starts: every slot's row
// count is a multiple of kRows (the wrapper checks it).
__device__ __forceinline__ void sw_fused_body(
    const int8_t* __restrict__ tiles, const int32_t* __restrict__ queries,
    const int32_t* __restrict__ starts, const int32_t* __restrict__ mat,
    int A, int T, int L, int S, int W, int gop, int gex, int32_t* hs,
    int32_t* fs, float* __restrict__ out) {
  __shared__ int smat[kMaxAlphabet * kMaxAlphabet];
  __shared__ __align__(16) int prof[kMaxAlphabet * kRows];
  const BatchBlock b = batch_block(T, L, hs, fs);
  for (int k = threadIdx.x; k < A * A; k += blockDim.x) smat[k] = mat[k];
  const int total = starts[S];
  int q = 0, m = 0;
  for (int i = 0; i < total; i += kRows) {
    while (i >= starts[q + 1]) {  // slot q (maybe empty) ends here
      out[((size_t)q * T + b.t) * kCellNS + b.s] = (float)m;
      m = 0;
      ++q;
    }
    const int r = i - starts[q];  // row within slot q
    run_rows(queries + (size_t)q * W + r, min(kRows, starts[q + 1] - i), smat,
             prof, A, true, tiles + b.base, b.h, b.f, r == 0, b.h, b.f, L,
             kCellNS, gop, gex, m);
  }
  for (; q < S; ++q) {
    out[((size_t)q * T + b.t) * kCellNS + b.s] = (float)m;
    m = 0;
  }
}

__global__ void __launch_bounds__(kThreads) sw_cell_kernel(
    const int8_t* tiles, const int32_t* query, const int32_t* mat, int A,
    int L, int nrows, int gop, int gex, int32_t* hs, int32_t* fs,
    float* out) {
  sw_tiles_body<int32_t>(tiles, query, mat, A, L, 4096, nrows, gop, gex, hs,
                         fs, out, 0);
}

__global__ void __launch_bounds__(kThreads) sw_cell16_kernel(
    const int8_t* tiles, const int32_t* query, const int32_t* mat, int A,
    int L, int nrows, int gop, int gex, int16_t* hs, int16_t* fs, float* out,
    int sat) {
  sw_tiles_body<int16_t>(tiles, query, mat, A, L, 4096, nrows, gop, gex, hs,
                         fs, out, sat);
}

__global__ void __launch_bounds__(kThreads) sw_row_kernel(
    const int8_t* tiles, const int32_t* query, const int32_t* mat, int A,
    int L, int NS, int nrows, int gop, int gex, int32_t* hs, int32_t* fs,
    float* out) {
  sw_tiles_body<int32_t>(tiles, query, mat, A, L, NS, nrows, gop, gex, hs, fs,
                         out, 0);
}

// ------------------------------------ B3 and B5: the col wavefront

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

// One warp scores one subject (x: its codes, stride kCellNS) against query
// rows q[0, nrows).  smat: [A][A + 1], B - gop and a -inf column A.
// hin/fin, hout/fout: the subject's carry in and out (stride kCellNS), or
// null.  th/te: the warp's boundary column of nrows rows (St, clamped at
// sat for int16), or null when L fits one pass.  Returns the subject's
// max H, on every lane.
template <typename St>
__device__ __forceinline__ int col_warp(
    const int8_t* __restrict__ x, int L, const int32_t* __restrict__ q,
    int nrows, const int* smat, int A, int gop, int gex,
    const int32_t* __restrict__ hin, const int32_t* __restrict__ fin,
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
      const size_t o = (size_t)j * kCellNS;
      const bool in = j < L;
      c[r] = in ? x[o] : A;
      hg[r] = (in && hin ? hin[o] : 0) + gop;
      f[r] = in && fin ? fin[o] : kNeg;
    }
    // H + gop of the row above at the pass's left column: lane 0's first
    // diagonal.  Later rows' diagonals are the values taken a step before.
    int prev = gop;
    if (lane == 0 && rd && hin) prev += hin[(size_t)(jl - 1) * kCellNS];
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
          hout[(size_t)j * kCellNS] = clamp_state<St>(hg[r] - gop, sat);
          fout[(size_t)j * kCellNS] = clamp_state<St>(f[r], sat);
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
// null) of the warp's rtot-row pool.  Writes out[slot, t, s].
template <typename St>
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
      tiles + base, L, queries + (size_t)slot * W, rows ? rows[slot] : W, smat,
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
      run_rows(query + i0, min(kRows, nrows - i0), smat, prof, A, true,
               tiles + base, hs + base, fs + base, i0 == 0, hs + base,
               fs + base, L, kCellNS, gop, gex, m);
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

unsigned grid_for(int T, int NS) {
  return (unsigned)((long long)T * ((NS + kThreads - 1) / kThreads));
}

// sat: 0 for exact int32 state, else the int16 state's ceiling.
bool sat_ok(int sat) { return sat >= 0 && sat <= 32767; }

__global__ void __launch_bounds__(kThreads) sw_cell_batch_kernel(
    const int8_t* tiles, const int32_t* queries, const int32_t* nrows,
    const int32_t* mat, int A, int T, int L, int S, int W, int gop, int gex,
    int32_t* hs, int32_t* fs, float* out) {
  sw_batch_body(tiles, queries, nrows, mat, A, T, L, S, W, gop, gex, hs, fs,
                out);
}

__global__ void __launch_bounds__(kThreads) sw_col_fused_kernel(
    const int8_t* tiles, const int32_t* queries, const int32_t* starts,
    const int32_t* mat, int A, int T, int L, int S, int W, int gop, int gex,
    int32_t* hs, int32_t* fs, float* out) {
  sw_fused_body(tiles, queries, starts, mat, A, T, L, S, W, gop, gex, hs, fs,
                out);
}

typedef void (*BatchKernel)(const int8_t*, const int32_t*, const int32_t*,
                            const int32_t*, int, int, int, int, int, int, int,
                            int32_t*, int32_t*, float*);

int batch_launch(BatchKernel kernel, const void* tiles, const void* queries,
                 const void* rows, const void* mat, int A, int T, int L,
                 int S, int W, int planes, int gop, int gex, void* hs,
                 void* fs, void* out, void* stream) {
  if (T == 0 || S == 0) return 0;
  if (planes < 1 || planes > S || planes > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid(grid_for(T, kCellNS), (unsigned)planes);
  kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)tiles, (const int32_t*)queries, (const int32_t*)rows,
      (const int32_t*)mat, A, T, L, S, W, gop, gex, (int32_t*)hs,
      (int32_t*)fs, (float*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The cell and row launches share one signature.  Each returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for arguments outside its contract: NS = 4096 for
// cell tiles, and sat = 0 (exact int32 state) or 0 < sat <= 32767 (int16
// state, cell only; hs and fs are then int16).  Pointers are device pointers; stream is a cudaStream_t.  Query
// and tile codes must lie in [0, A), A <= 26.

int sw_cell_launch(const void* tiles, const void* query, const void* mat,
                   int A, int T, int L, int NS, int nrows, int gop, int gex,
                   void* hs, void* fs, void* out, int sat, void* stream) {
  if (NS != 4096 || !sat_ok(sat)) return (int)cudaErrorInvalidValue;
  if (T == 0) return 0;
  const unsigned grid = grid_for(T, 4096);
  if (sat) {
    sw_cell16_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const int8_t*)tiles, (const int32_t*)query, (const int32_t*)mat, A,
        L, nrows, gop, gex, (int16_t*)hs, (int16_t*)fs, (float*)out, sat);
  } else {
    sw_cell_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const int8_t*)tiles, (const int32_t*)query, (const int32_t*)mat, A,
        L, nrows, gop, gex, (int32_t*)hs, (int32_t*)fs, (float*)out);
  }
  return (int)cudaGetLastError();
}

int sw_row_launch(const void* tiles, const void* query, const void* mat,
                  int A, int T, int L, int NS, int nrows, int gop, int gex,
                  void* hs, void* fs, void* out, int sat, void* stream) {
  if (sat) return (int)cudaErrorInvalidValue;
  if (T == 0) return 0;
  sw_row_kernel<<<grid_for(T, NS), kThreads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)tiles, (const int32_t*)query, (const int32_t*)mat, A, L,
      NS, nrows, gop, gex, (int32_t*)hs, (int32_t*)fs, (float*)out);
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

// The two batch launches share a second signature.  tiles: int8
// [T, L, 32, 128]; queries: int32 [S, W]; rows: int32, the slots' row
// counts [S] (cell batch) or the slots' first rows and the total [S + 1]
// (col fused); hs, fs: int32 scratch of planes x [T, L, 32, 128]; out:
// f32 [S, T, 4096].  planes: 1..S, and 1 for the fused kernel.

int sw_cell_batch_launch(const void* tiles, const void* queries,
                         const void* rows, const void* mat, int A, int T,
                         int L, int S, int W, int planes, int gop, int gex,
                         void* hs, void* fs, void* out, void* stream) {
  return batch_launch(sw_cell_batch_kernel, tiles, queries, rows, mat, A, T,
                      L, S, W, planes, gop, gex, hs, fs, out, stream);
}

int sw_col_fused_launch(const void* tiles, const void* queries,
                        const void* rows, const void* mat, int A, int T,
                        int L, int S, int W, int planes, int gop, int gex,
                        void* hs, void* fs, void* out, void* stream) {
  if (planes != 1) return (int)cudaErrorInvalidValue;
  return batch_launch(sw_col_fused_kernel, tiles, queries, rows, mat, A, T, L,
                      S, W, planes, gop, gex, hs, fs, out, stream);
}

// The col launch has a signature of its own.  tiles: int8 [T, L, 32, 128];
// queries: int32 [S, W].  With rows non-null it launches col flat (B5):
// rows, offs are int32 [S], the slots' row counts and the first rows of
// their boundary columns in a pool of rtot rows, with no carry, exact
// only.  With rows null it launches col (B3): one slot of W = rtot rows,
// offs null, and hin, fin (the int32 carry in) and hout, fout (the int32
// carry out), each shaped as the tiles or null, in pairs; sat as above.
// th, te: the boundary columns [T * 4096, rtot], int32 (int16 when
// sat > 0), null allowed when L <= sw_col_pass_columns(); out: f32
// [S, T, 4096].
int sw_col_launch(const void* tiles, const void* queries, const void* rows,
                  const void* offs, const void* mat, int A, int T, int L,
                  int S, int W, int rtot, int gop, int gex, const void* hin,
                  const void* fin, void* hout, void* fout, void* th, void* te,
                  void* out, int sat, void* stream) {
  const bool flat = rows != nullptr;
  const bool carry_ok = !hin == !fin && !hout == !fout;
  const bool slots_ok =
      flat ? offs && !hin && !hout && !sat && W <= rtot
           : !offs && S == 1 && W == rtot;
  if (!carry_ok || !slots_ok || !sat_ok(sat) || S < 1 || S > 65535 ||
      W < 0 || (L > kColPass && rtot > 0 && !(th && te))) {
    return (int)cudaErrorInvalidValue;
  }
  if (T == 0) return 0;
  const dim3 grid((unsigned)((long long)T * kCellNS / kColWarps), (unsigned)S);
  const cudaStream_t st = (cudaStream_t)stream;
  if (flat) {
    sw_col_flat_kernel<<<grid, kColWarps * 32, 0, st>>>(
        (const int8_t*)tiles, (const int32_t*)queries, (const int32_t*)rows,
        (const int32_t*)offs, (const int32_t*)mat, A, T, L, W, rtot, gop, gex,
        (int32_t*)th, (int32_t*)te, (float*)out);
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

// Query rows per register block (kRows): the fused kernel's slot
// boundaries must fall on multiples of it.
int sw_kernel_rows() { return kRows; }

// Subject columns per col pass: a col launch over L > this needs the
// boundary columns.
int sw_col_pass_columns() { return kColPass; }

const char* sw_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
