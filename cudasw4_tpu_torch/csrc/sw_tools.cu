// The one-thread-per-subject tool kernels (B7 manual staging, B8 pair)
// and their launches: one unit of the kernel library (sw_tiles.cu gives
// the design).
#include "sw_common.cuh"

namespace {

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

}  // namespace

extern "C" {

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

}  // extern "C"
