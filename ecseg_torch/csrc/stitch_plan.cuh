// The overlap stitch's copy plan as per-row and per-column descriptors,
// read by kernels B1 (stitch.cu) and B8b (cc_count.cu).
//
// The plan (ecseg_torch/ops/tiling.py stitch_plan) copies rectangles of the
// (N, 256, 256) patch stack onto the canvas, later copies over earlier ones.
// On every pixel a copy reaches, the flat patch-stack index of the last one
// is additively separable, src = R[y] + C[x]; the pixels no copy reaches
// are those where a row's bits and a column's bits share one (one bit per
// distinct set of unreached columns; none on non-square plans, one 25-px
// rectangle on square ones).  The host derives the descriptors once per
// geometry and checks that they reproduce the replayed plan pixel for
// pixel before any kernel reads them (ops/cc_kernels.py
// stitch_descriptors).  Layout, int32: W columns of {C, bits, run, 0}, then
// H rows of {R, bits}; `run` is how many columns from this one on continue
// it (C one more each, the same bits), so a run of pixels of one row is one
// copy's consecutive patch bytes, or all unreached.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace ecseg {

struct StitchPlan {
  const int4* cols;  // (W,) {C, bits, run, 0}
  const int2* rows;  // (H,) {R, bits}

  __device__ __forceinline__ int4 col(int x) const { return __ldg(cols + x); }
  __device__ __forceinline__ int2 row(int y) const { return __ldg(rows + y); }
  // flat index into the patch stack of the last copy onto (y, x), -1 where
  // no copy lands
  __device__ __forceinline__ int src(int y, int x) const {
    const int2 r = row(y);
    const int4 c = col(x);
    return (r.y & c.y) ? -1 : r.x + c.x;
  }
};

inline StitchPlan stitch_plan(const int32_t* desc, int w) {
  return {reinterpret_cast<const int4*>(desc), reinterpret_cast<const int2*>(desc + 4 * w)};
}

}  // namespace ecseg
