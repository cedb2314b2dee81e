// Kernels B3 (flood from the border), B4 (flood from seeds), B6 (seeded
// flood of a class map) and B9 (labels and seeded flood of one mask).
//
// Replaces: ecseg_tpu/ops/cc_pallas.py flood_from_border_pallas and
// flood_from_seeds_pallas (_flood_kernel, seeded False/True), and for maps
// past the TPU's VMEM gate ecseg_tpu/ops/cc_pallas_banded.py flood_banded;
// flood_multiclass_pallas (_flood_mc_kernel) for B6 and
// label_and_flood_pallas (_label_flood_kernel) for B9.
// Contract: the traversable pixels connected (4-conn for the border flood,
// 4- or 8-conn for the seeded one) to a seed through traversable pixels.
// Border seeds are the pixels of row 0, row H-1, column 0 and column W-1;
// seeds off the traversable mask are ignored.  B6: the traversable map is a
// uint8 class map (0 = not traversable) and the flood runs 8-connected
// through pixels of the seed's own class only.  B9: B4's flood plus the B2
// labels of the same mask.
//
// Bound on an H100: memory.  The least traffic is the masks read once and
// the outputs written once (B3 2, B4/B6 3, B9 7 bytes/pixel: 8-29 MB at
// 2048^2, 3-9 us at 3.35 TB/s).
//
// Design: label the traversable mask with the B2 union-find (cc_label.cuh;
// B6 with its equal-class merge, as B5), mark the component of every seeded
// pixel (flag[label] = 1, an idempotent plain store), then gather out =
// traversable && flag[label].  The Pallas flood iterated max-sweeps to a
// fixpoint, one step per pixel of geodesic distance at worst; labeling first
// makes the cost independent of it.  B4 and B6 get the int32 label map and
// the uint8 flag array from the wrapper as scratch; B9 is the same sequence
// with the label map as its second output, so the mask is labeled once
// where B4 + B2 labeled it twice.

#include "cc_label.cuh"

namespace {

__global__ void mark_seeds(const uint8_t* __restrict__ trav,
                           const uint8_t* __restrict__ seeds,
                           const int* __restrict__ labels,
                           uint8_t* flag, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n && trav[i] && seeds[i]) flag[labels[i]] = 1;
}

// One thread per position on the image's perimeter (2W + 2H, corners twice).
__global__ void mark_border(const uint8_t* __restrict__ trav,
                            const int* __restrict__ labels, uint8_t* flag,
                            int h, int w) {
  int k = blockIdx.x * blockDim.x + threadIdx.x;
  int r, c;
  if (k < w) {
    r = 0;
    c = k;
  } else if (k < 2 * w) {
    r = h - 1;
    c = k - w;
  } else if (k < 2 * w + h) {
    r = k - 2 * w;
    c = 0;
  } else if (k < 2 * w + 2 * h) {
    r = k - 2 * w - h;
    c = w - 1;
  } else {
    return;
  }
  int i = r * w + c;
  if (trav[i]) flag[labels[i]] = 1;
}

__global__ void gather_flags(const uint8_t* __restrict__ trav,
                             const int* __restrict__ labels,
                             const uint8_t* __restrict__ flag, uint8_t* out,
                             int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = trav[i] ? flag[labels[i]] : 0;
}

}  // namespace

namespace ecseg {

// labels: (h, w) int32 (scratch, or B9's output); flag: (h*w) uint8
// scratch; out: (h, w) bool.  seeds == nullptr seeds from the border.
template <bool kSameClass>
int flood_launch(const uint8_t* trav, const uint8_t* seeds, int32_t* labels,
                 uint8_t* flag, uint8_t* out, int h, int w, int connectivity,
                 cudaStream_t s) {
  int n = h * w;
  int blocks = (n + kThreads - 1) / kThreads;
  label_launch<kSameClass>(trav, labels, h, w, connectivity, s);
  cudaMemsetAsync(flag, 0, static_cast<size_t>(n), s);
  if (seeds == nullptr) {
    int m = 2 * (h + w);
    mark_border<<<(m + kThreads - 1) / kThreads, kThreads, 0, s>>>(trav, labels,
                                                                   flag, h, w);
  } else {
    mark_seeds<<<blocks, kThreads, 0, s>>>(trav, seeds, labels, flag, n);
  }
  gather_flags<<<blocks, kThreads, 0, s>>>(trav, labels, flag, out, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ecseg

// B3 (seeds == nullptr: seed from the image border) and B4.
extern "C" int ecseg_flood(const uint8_t* trav, const uint8_t* seeds,
                           int32_t* labels, uint8_t* flag, uint8_t* out, int h,
                           int w, int connectivity, void* stream) {
  return ecseg::flood_launch<false>(trav, seeds, labels, flag, out, h, w,
                                    connectivity,
                                    static_cast<cudaStream_t>(stream));
}

// B6: `cls` is the uint8 class map, 8-connectivity.
extern "C" int ecseg_flood_mc(const uint8_t* cls, const uint8_t* seeds,
                              int32_t* labels, uint8_t* flag, uint8_t* out,
                              int h, int w, void* stream) {
  return ecseg::flood_launch<true>(cls, seeds, labels, flag, out, h, w, 2,
                                   static_cast<cudaStream_t>(stream));
}

// B9: `labels` is an output, the canonical labels of `mask`.
extern "C" int ecseg_label_flood(const uint8_t* mask, const uint8_t* seeds,
                                 int32_t* labels, uint8_t* flag, uint8_t* out,
                                 int h, int w, int connectivity, void* stream) {
  return ecseg::flood_launch<false>(mask, seeds, labels, flag, out, h, w,
                                    connectivity,
                                    static_cast<cudaStream_t>(stream));
}
