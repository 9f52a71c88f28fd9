// Affine-gap Smith-Waterman over packed subject tiles, for Hopper (sm_90a).
//
// The library is several units, which ops/cuda_lib.py compiles in
// parallel and links once: this file (the exported cell, row and tool
// launches, dispatching to the units that hold each (G, R) instance),
// sw_col.cu (the col wavefront kernels and their launch) and
// sw_cell_unit.cu, once a slice of CELL_SHAPES (the cell group kernels'
// instances of that slice).  sw_common.cuh holds what they share,
// sw_cell.cuh the cell group kernels.
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
//   [T, L, 4096], in int32 lanes (sw_cell_kernel) or, with k16 != 0,
//   s16x2 lanes (sw_cell16_kernel).  Both give exact scores, which meet
//   the int16 contract too.
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
//   launch, out [QB, T, 4096] (sw_cell_batch_kernel), or with k16 != 0 in
//   s16x2 lanes (sw_cell16_kernel with its slot axis), exact scores both.
// * sw_col_launch with slots (rows non-null) replaces
//   cudasw4_tpu/ops/sw_pallas_col.py
//   score_bucket_pallas_col_flat (_sw_col_flat_kernel): S query slots of
//   nqp rows each against col tiles in one launch.  As the TPU kernel
//   gives each slot a row range of one VMEM state pool, each slot's
//   boundary columns take rows [off, off + nqp) of one pool of rtot rows
//   (sw_col_flat_kernel; sw_col_flat16_kernel for int16 state, whose pool
//   is int16).
// * sw_col_launch with gapless starts (rows null, offs non-null) replaces
//   cudasw4_tpu/ops/sw_pallas_col.py score_bucket_pallas_col_flat_fused
//   (_sw_col_flat_fused_kernel): the same slots packed without gaps, the
//   DP restarting at each slot (sw_col_fused_kernel).  The TPU kernel
//   walks the packed rows as one run; here each (slot, subject) warp runs
//   its slot's rows from the top of the matrix, its boundary columns at
//   the slot's pool rows [starts[s], starts[s + 1]) (sw_col_fused16_kernel
//   for int16 state).
// * sw_cell_manual_launch replaces cudasw4_tpu/ops/sw_pallas_cell.py
//   score_bucket_pallas_cell_manual (_sw_cell_kernel_manual): B1's
//   contract with the tiles staged by hand through a 2-deep ring in shared
//   memory (sw_manual_kernel, or sw_manual16_kernel for sat > 0, whose
//   scores are exact).
// * sw_cell_pair_launch replaces tools/pairbench.py score_pair
//   (_kernel_pair): B1's contract, exact, P consecutive tiles per block
//   (sw_pair_kernel).
//
// The cell kernels (sw_cell_kernel, sw_cell16_kernel, sw_cell_batch_kernel,
// the tool kernels sw_manual_kernel, sw_manual16_kernel and sw_pair_kernel,
// and the row kernel up to L = 768) are single-pass register-tiled group
// wavefronts, the shape of the
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
// slot its own row count; B1 and B4 int16 (one kernel, the slot on the
// grid's y axis, B1 its one-slot case) run two subjects a group in s16x2
// lanes (the tile's subjects s and s + 1, one 16-bit load a column), with
// __viaddmax_s16x2 and __vimax_s16x2_relu and one lookup a column pair in
// a pairwise table [A][(A + 1)^2] of both shifted scores.  In a cell
// bucket no H passes min(L, nq) x max B (11,520 at L = 768 and max B =
// 15), so those lanes never wrap and the int16 scores are exact, which
// meets the SAT rule at any SAT; where the launcher cannot prove the fit
// for the matrix, the gaps and the block's slot, the block runs the int32
// routine.  Tiles with
// L beyond the largest instance go to the col kernels (ops/sw_cell.py),
// those of the tool kernels too.  The row kernel (sw_row_kernel) is B1's
// routine at a code stride of NS in place of 4096: group g scores subject
// g % NS of row tile g / NS.  The pair kernel is B1's routine over P
// consecutive tiles a group, the shifted table loaded once a block.  The
// manual-staging kernels (below) feed the same routine from shared memory.
// Padded query rows and subject positions carry the pad code, whose matrix
// row is all negative, so they never raise the max.
//
// int16 state (the JAX kernels' exact=False) in the col kernels: the
// arithmetic stays int32 in registers; only the stored state
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
// is bound by operations, by a factor of ~nrows over bytes.  No cell group
// kernel, the tool kernels included, moves any scratch.
//
// The col kernels (sw_col_kernel, sw_col16_kernel, sw_col_flat_kernel,
// sw_col_fused_kernel, their int16 instances sw_col_flat16_kernel and
// sw_col_fused16_kernel, and the row kernel past L = 768, sw_row_col_kernel,
// at a code stride of NS) are a warp per (slot, subject) register-tiled
// wavefront, the shape of the reference CUDASW++4.0's DPX-s32 multi-pass
// kernels.  What bounds a
// one-thread-per-subject design at long L is parallelism and scratch: a
// col tile is 4096 subjects, 32 blocks of 128 threads, on 132 SMs, and
// every 8 rows re-read and re-wrote the L-long H/F row.  Here the
// parallelism
// comes from the subject's length (> 768 aa in a col bucket), not from the
// query's (which can be 8 rows): a tile is 4096 warps.  Lane k holds
// kColRegs consecutive subject columns in registers (code, H + gop and F
// of the row above); a pass covers kColPass = 32 x kColRegs columns, and a
// subject of L columns takes ceil(L / kColPass) passes.  Given the tiles'
// subject lengths, a warp runs only its own subject's ceil(len / kColPass)
// passes (none for a padding lane), and the blocks take the grid's warps
// from its end, longest subjects first.  Inside a pass the
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
// The manual-staging kernels are the Hopper form of the TPU kernel's copy
// of tile t+1 started before tile t's compute: a persistent grid (as many
// blocks as fit on the card at once) whose blocks each walk units of W
// subjects, u = blockIdx.x, + gridDim.x, ...  A unit is L x W bytes, W the
// block's groups' subjects (one a group, two in s16x2 lanes), at least 16
// so that a position is whole 16-byte cp.async copies; the block stages
// each unit whole through a 2-deep ring in dynamic shared memory, after
// the table (commit/wait_group), and starts the next unit's copy before
// its groups sweep the current one from the ring: each code byte is copied
// once and read once a subject, as B1 reads it from device memory, so the
// staging stays off the wavefront's path.  The ring is 2 x L x W bytes (24
// KB at L = 768, W = 16) beside a table of up to 75.8 KB (the int16
// pairwise one at A = 26); the launcher takes the blocks an SM that the
// registers and this shared memory allow.  The JAX tool's unroll has no
// counterpart: a lane's register block is R columns.

#include "sw_cell.cuh"

namespace {

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

#define CELL_UNIT_REF(s) sw::cell_unit_##s,
#define ROW_UNIT_REF(s) sw::row_unit_##s,
#define TOOL_UNIT_REF(s) sw::tool_unit_##s,
int (*const kCellUnits[])(const sw::CellArgs&, int, int) = {
    CELL_SLICES(CELL_UNIT_REF)};
int (*const kRowUnits[])(const sw::RowArgs&, int, int) = {
    CELL_SLICES(ROW_UNIT_REF)};
int (*const kToolUnits[])(const sw::ToolArgs&, int, int) = {
    CELL_SLICES(TOOL_UNIT_REF)};
#undef CELL_UNIT_REF
#undef ROW_UNIT_REF
#undef TOOL_UNIT_REF

// A tool launch at the instance (G, R), through the unit that holds it.
int tool_launch(const sw::ToolArgs& a, int G, int R) {
  for (auto unit : kToolUnits) {
    const int rc = unit(a, G, R);
    if (rc != sw::kNotHere) return rc;
  }
  return (int)cudaErrorInvalidValue;  // not an instance
}

}  // namespace

extern "C" {

// Each launch function returns cudaGetLastError() after the launch (0 on
// success), or cudaErrorInvalidValue for arguments outside its contract.
// Pointers are device pointers; stream is a cudaStream_t.  Query and tile
// codes must lie in [0, A), A <= 26; sat = 0 is exact int32 state, and
// 0 < sat <= 32767 int16 state.
//
// The cell launch (B1 and B4 in both state modes).  tiles: int8
// [T, L, 32, 128]; queries: int32 [S, W]; out: f32 [S, T, 4096]; (G, R):
// an instance of CELL_SHAPES with G x R >= L.  With rows null it launches
// B1: one query of W rows (S = 1), sw_cell_kernel, or sw_cell16_kernel
// for k16 != 0.  With rows non-null it launches B4: rows int32 [S], the
// slots' row counts (each <= W), sw_cell_batch_kernel, or
// sw_cell16_kernel for k16 != 0.  Every kernel of them returns exact
// scores (sw_cell16_kernel proves each block's fit, or runs it in int32
// lanes), so the state mode does not choose the kernel: k16 (>= 0) does.
// The caller passes the int16 state's sat there, or 1 for an exact launch
// in s16x2 lanes.  No scratch: the cell kernels keep the whole DP row in
// registers.
int sw_cell_launch(const void* tiles, const void* queries, const void* rows,
                   const void* mat, int A, int T, int L, int S, int W,
                   int gop, int gex, int G, int R, int k16, void* out,
                   void* stream) {
  if (k16 < 0 || (!rows && S != 1) || S < 1 || S > 65535 ||
      W < 0 || L < 0 || G * R < L) {
    return (int)cudaErrorInvalidValue;
  }
  if (T == 0) return 0;
  const sw::CellArgs a{(const int8_t*)tiles, (const int32_t*)queries,
                       (const int32_t*)rows, (const int32_t*)mat, A, T, L, S, W,
                       gop, gex, k16, (float*)out, (cudaStream_t)stream};
  for (auto unit : kCellUnits) {
    const int rc = unit(a, G, R);
    if (rc != sw::kNotHere) return rc;
  }
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
  const sw::RowArgs a{(const int8_t*)tiles, (const int32_t*)query,
                      (const int32_t*)mat, A, T, L, NS, nrows, gop, gex,
                      (float*)out, (cudaStream_t)stream};
  int G, R;
  if (cell_pick(L, G, R)) {
    for (auto unit : kRowUnits) {
      const int rc = unit(a, G, R);
      if (rc != sw::kNotHere) return rc;
    }
  }
  if (L > kColPass && nrows > 0 && !(th && te)) {
    return (int)cudaErrorInvalidValue;
  }
  return sw::row_col_launch(a, th, te);
}

// The tool launches (B7, B8) share a third signature: cell tiles
// [T, L, 32, 128], one query of nrows rows, out f32 [T, 4096], (G, R) an
// instance of CELL_SHAPES with G x R >= L; arg is the pair kernel's tiles a
// block P (exact only, T % P == 0) and 0 for the manual kernel.  No
// scratch.  The manual launch runs sw_manual_kernel, or sw_manual16_kernel
// for sat > 0; its tiles must be 16-byte aligned (cp.async).
int sw_cell_manual_launch(const void* tiles, const void* query,
                          const void* mat, int A, int T, int L, int nrows,
                          int gop, int gex, int G, int R, int sat, int arg,
                          void* out, void* stream) {
  if (!sat_ok(sat) || arg || L < 0 || nrows < 0 || G * R < L ||
      (uintptr_t)tiles % 16) {
    return (int)cudaErrorInvalidValue;
  }
  if (T == 0) return 0;
  return tool_launch({(const int8_t*)tiles, (const int32_t*)query,
                      (const int32_t*)mat, A, T, L, nrows, gop, gex, sat, 0,
                      (float*)out, (cudaStream_t)stream},
                     G, R);
}

int sw_cell_pair_launch(const void* tiles, const void* query, const void* mat,
                        int A, int T, int L, int nrows, int gop, int gex,
                        int G, int R, int sat, int arg, void* out,
                        void* stream) {
  if (sat || arg < 1 || T % arg || L < 0 || nrows < 0 || G * R < L) {
    return (int)cudaErrorInvalidValue;
  }
  if (T == 0) return 0;
  return tool_launch({(const int8_t*)tiles, (const int32_t*)query,
                      (const int32_t*)mat, A, T, L, nrows, gop, gex, 0, arg,
                      (float*)out, (cudaStream_t)stream},
                     G, R);
}

const char* sw_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
