// The device code that the units of the kernel library share: constants,
// the int16 state store, the shifted substitution table, and the launch
// arguments that cross units.  Each unit (sw_tiles.cu, sw_col.cu, and
// sw_cell_unit.cu once a slice of CELL_SHAPES) includes it;
// ops/cuda_lib.py compiles the units in parallel and links them into one
// library.  No device function crosses units: each kernel and every device
// function it calls live in its own unit, so no relocatable device code is
// needed.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kNeg = -(1 << 24);  // -inf stand-in, safe from int32 underflow
constexpr int kMaxAlphabet = 26;
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

// sat: 0 for exact int32 state, else the int16 state's ceiling.
bool sat_ok(int sat) { return sat >= 0 && sat <= 32767; }

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

}  // namespace

namespace sw {

// The arguments of one cell launch (sw_cell_launch), one row launch
// (sw_row_launch) and one tool launch (sw_cell_manual_launch,
// sw_cell_pair_launch), as the units that hold the kernels' instances take
// them.
struct CellArgs {
  const int8_t* tiles;
  const int32_t* queries;
  const int32_t* rows;
  const int32_t* mat;
  int A, T, L, S, W, gop, gex;
  float* out;
  cudaStream_t stream;
};

struct RowArgs {
  const int8_t* tiles;
  const int32_t* query;
  const int32_t* mat;
  int A, T, L, NS, nrows, gop, gex;
  float* out;
  cudaStream_t stream;
};

struct ToolArgs {
  const int8_t* tiles;
  const int32_t* query;
  const int32_t* mat;
  int A, T, L, nrows, gop, gex, sat;
  int P;  // B8: tiles a block; 0 for B7
  float* out;
  cudaStream_t stream;
};

// What a unit's launcher returns for an instance that it does not hold.
constexpr int kNotHere = -1;

// B2 past the largest cell instance (sw_col.cu): sw_row_col_kernel, with
// the boundary columns th, te.
int row_col_launch(const RowArgs& a, void* th, void* te);

}  // namespace sw
