// One unit of the cell group kernels' instances: B1 (both state modes),
// B4 and B2's cell route at the (G, R) instances of slice SW_SLICE of
// CELL_SHAPES (sw_cell.cuh).  ops/cuda_lib.py compiles this file once a
// slice, with -DSW_SLICE=<slice>, all slices in parallel.
#include "sw_cell.cuh"

#ifndef SW_SLICE
#error "compile with -DSW_SLICE=<a slice of CELL_SLICES>"
#endif

#define SW_CAT2(a, b) a##b
#define SW_CAT(a, b) SW_CAT2(a, b)
#define SW_SLICE_SHAPES SW_CAT(CELL_SHAPES_, SW_SLICE)

namespace sw {

int SW_CAT(cell_unit_, SW_SLICE)(const CellArgs& a, int G, int R) {
#define CELL_CASE(g, r) \
  if (G == g && R == r) return cell_launch_at<g, r>(a);
  SW_SLICE_SHAPES(CELL_CASE)
#undef CELL_CASE
  return kNotHere;
}

int SW_CAT(row_unit_, SW_SLICE)(const RowArgs& a, int G, int R) {
#define ROW_CASE(g, r) \
  if (G == g && R == r) return row_launch_at<g, r>(a);
  SW_SLICE_SHAPES(ROW_CASE)
#undef ROW_CASE
  return kNotHere;
}

}  // namespace sw
