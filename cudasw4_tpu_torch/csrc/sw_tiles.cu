// Affine-gap Smith-Waterman over packed subject tiles, for Hopper (sm_90a).
//
// Replaces three TPU kernels of the JAX package, one entry point each, all
// computing the same recurrence over int8 subject codes and an int32 AxA
// substitution matrix (A = 21 classic, 26 full-blosum):
//
//   E[i][j] = max(E[i][j-1] + gex, H[i][j-1] + gop)
//   F[i][j] = max(F[i-1][j] + gex, H[i-1][j] + gop)
//   H[i][j] = max(0, H[i-1][j-1] + B[q_i, s_j], E[i][j], F[i][j])
//   score   = max over i, j of H[i][j]                 (exact int32 state)
//
// * sw_cell_launch replaces cudasw4_tpu/ops/sw_pallas_cell.py
//   score_bucket_pallas_cell (_sw_cell_kernel, _run_query_sweeps): one
//   query against cell tiles [T, L, 32, 128], a pure reshape of
//   [T, L, 4096].
// * sw_row_launch replaces cudasw4_tpu/ops/sw_pallas.py score_bucket_pallas
//   (_sw_kernel): one query against row tiles [T, L, NS].
// * sw_col_launch replaces cudasw4_tpu/ops/sw_pallas_col.py
//   score_bucket_pallas_col (_sw_col_kernel): one query chunk against the
//   cell layout at long L, with the optional H/F carry in and out between
//   query chunks.
//
// Design (simple and right first; speed is later work).  One thread per
// subject: neighbouring threads own neighbouring subjects, so each load of
// x[t, j, :] and of the H/F row is coalesced.  The query streams in blocks
// of kRows rows; each thread keeps E and H[i][j-1] of its kRows rows in
// registers and sweeps j over the whole subject.  The H and F of the row
// above each block live in a scratch row int32 [T, L, NS] in device memory
// (read, then overwritten with the block's bottom row), so neither the
// subject length nor the query length is capped.  That scratch row is
// exactly the col contract's boundary carry: take_init reads the first
// block's row above from state_in, and emit_state returns the scratch.
// The substitution scores of a block's kRows rows sit in shared memory as a
// query profile prof[c][r] = B[q_{i0+r}, c], one 32-byte read per column.
// Padded query rows and subject positions carry the pad code, whose matrix
// row is all negative, so they never raise the max.
//
// Bound on the H100 SXM (3.35 TB/s; int32 at 132 SMs x 64 lanes x clock,
// 16.7 Tops/s at 1.98 GHz): a cell update is 11 int32 operations (3 for E,
// 3 for F, 4 for H, 1 for the running max) and the inputs are about one
// byte per subject position, so every contract is bound by operations,
// by a factor of ~nrows/2 over bytes.  This design moves 16 bytes of
// scratch per kRows cells (2 B/cell at kRows = 8) besides, and one thread
// per subject leaves small buckets without enough warps to hide latency;
// register-tiled wavefronts with DPX instructions (__viaddmax_s32,
// __vimax3_s32_relu) are the known way to the bound.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNeg = -(1 << 24);  // -inf stand-in, safe from int32 underflow
constexpr int kMaxAlphabet = 26;
constexpr int kRows = 8;      // query rows per register block
constexpr int kCols = 8;      // subject positions loaded ahead per step
constexpr int kThreads = 128; // subjects per block

// Sweep query rows [i0, i0 + nr) over all L positions of one subject.
// hsrc/fsrc: the row above (may alias hs/fs); from_zero: the row above is
// the top of the DP matrix (H = 0, F = -inf).
template <bool kFull>
__device__ __forceinline__ void sweep_block(
    const int8_t* __restrict__ x, const int32_t* hsrc, const int32_t* fsrc,
    bool from_zero, int32_t* hs, int32_t* fs, const int* prof, int L,
    int NS, int nr, int gop, int gex, int& m) {
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
        const int4* p4 = reinterpret_cast<const int4*>(prof + cv[jj] * kRows);
        const int4 lo = p4[0], hi = p4[1];
        const int sub[kRows] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
        int hup = hv[jj], fup = fv[jj];
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
        hv[jj] = hup;
        fv[jj] = fup;
      }
    }
#pragma unroll
    for (int jj = 0; jj < kCols; ++jj) {
      if (j0 + jj < L) {
        const size_t o = (size_t)(j0 + jj) * NS;
        hs[o] = hv[jj];
        fs[o] = fv[jj];
      }
    }
  }
}

// One block = kThreads subjects of one tile; the grid is flat over
// (tile, subject block).  Writes out[t, s] = max H as float.
__device__ __forceinline__ void sw_tiles_body(
    const int8_t* __restrict__ tiles, const int32_t* __restrict__ query,
    const int32_t* __restrict__ mat, int A, int L, int NS, int nrows,
    int gop, int gex, const int32_t* hin, const int32_t* fin, int32_t* hs,
    int32_t* fs, float* __restrict__ out) {
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
      const bool first = i0 == 0;
      const bool from_zero = first && hin == nullptr;
      const int32_t* hsrc = first && hin ? hin + base : hs + base;
      const int32_t* fsrc = first && fin ? fin + base : fs + base;
      if (nr == kRows) {
        sweep_block<true>(tiles + base, hsrc, fsrc, from_zero, hs + base,
                          fs + base, prof, L, NS, nr, gop, gex, m);
      } else {
        sweep_block<false>(tiles + base, hsrc, fsrc, from_zero, hs + base,
                           fs + base, prof, L, NS, nr, gop, gex, m);
      }
    }
  }
  if (live) out[(size_t)t * NS + s] = (float)m;
}

__global__ void __launch_bounds__(kThreads) sw_cell_kernel(
    const int8_t* tiles, const int32_t* query, const int32_t* mat, int A,
    int L, int nrows, int gop, int gex, int32_t* hs, int32_t* fs,
    float* out) {
  sw_tiles_body(tiles, query, mat, A, L, 4096, nrows, gop, gex, nullptr,
                nullptr, hs, fs, out);
}

__global__ void __launch_bounds__(kThreads) sw_row_kernel(
    const int8_t* tiles, const int32_t* query, const int32_t* mat, int A,
    int L, int NS, int nrows, int gop, int gex, int32_t* hs, int32_t* fs,
    float* out) {
  sw_tiles_body(tiles, query, mat, A, L, NS, nrows, gop, gex, nullptr,
                nullptr, hs, fs, out);
}

__global__ void __launch_bounds__(kThreads) sw_col_kernel(
    const int8_t* tiles, const int32_t* query, const int32_t* mat, int A,
    int L, int nrows, int gop, int gex, const int32_t* hin,
    const int32_t* fin, int32_t* hs, int32_t* fs, float* out) {
  sw_tiles_body(tiles, query, mat, A, L, 4096, nrows, gop, gex, hin, fin,
                hs, fs, out);
}

unsigned grid_for(int T, int NS) {
  return (unsigned)((long long)T * ((NS + kThreads - 1) / kThreads));
}

}  // namespace

extern "C" {

// The three launch functions share one signature.  Each returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for arguments outside its contract: NS = 4096 for
// cell and col tiles, and a carry (hin, fin) for the col kernel only.
// Pointers are device pointers; stream is a cudaStream_t.  Query and tile
// codes must lie in [0, A), A <= 26.

int sw_cell_launch(const void* tiles, const void* query, const void* mat,
                   int A, int T, int L, int NS, int nrows, int gop, int gex,
                   const void* hin, const void* fin, void* hs, void* fs,
                   void* out, void* stream) {
  if (NS != 4096 || hin || fin) return (int)cudaErrorInvalidValue;
  if (T == 0) return 0;
  sw_cell_kernel<<<grid_for(T, 4096), kThreads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)tiles, (const int32_t*)query, (const int32_t*)mat, A, L,
      nrows, gop, gex, (int32_t*)hs, (int32_t*)fs, (float*)out);
  return (int)cudaGetLastError();
}

int sw_row_launch(const void* tiles, const void* query, const void* mat,
                  int A, int T, int L, int NS, int nrows, int gop, int gex,
                  const void* hin, const void* fin, void* hs, void* fs,
                  void* out, void* stream) {
  if (hin || fin) return (int)cudaErrorInvalidValue;
  if (T == 0) return 0;
  sw_row_kernel<<<grid_for(T, NS), kThreads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)tiles, (const int32_t*)query, (const int32_t*)mat, A, L,
      NS, nrows, gop, gex, (int32_t*)hs, (int32_t*)fs, (float*)out);
  return (int)cudaGetLastError();
}

int sw_col_launch(const void* tiles, const void* query, const void* mat,
                  int A, int T, int L, int NS, int nrows, int gop, int gex,
                  const void* hin, const void* fin, void* hs, void* fs,
                  void* out, void* stream) {
  if (NS != 4096) return (int)cudaErrorInvalidValue;
  if (T == 0) return 0;
  sw_col_kernel<<<grid_for(T, 4096), kThreads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)tiles, (const int32_t*)query, (const int32_t*)mat, A, L,
      nrows, gop, gex, (const int32_t*)hin, (const int32_t*)fin,
      (int32_t*)hs, (int32_t*)fs, (float*)out);
  return (int)cudaGetLastError();
}

const char* sw_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
