// Kernels B3 (flood from the border) and B4 (flood from seeds).
//
// Replaces: ecseg_tpu/ops/cc_pallas.py flood_from_border_pallas and
// flood_from_seeds_pallas (_flood_kernel, seeded False/True), and for maps
// past the TPU's VMEM gate ecseg_tpu/ops/cc_pallas_banded.py flood_banded.
// Contract: the traversable pixels connected (4-conn for the border flood,
// 4- or 8-conn for the seeded one) to a seed through traversable pixels.
// Border seeds are the pixels of row 0, row H-1, column 0 and column W-1;
// seeds off the traversable mask are ignored.
//
// Bound on an H100: memory.  The least traffic is the masks read once and
// the bool output written once (2-3 bytes/pixel, 8-13 MB at 2048^2, 3-4 us at
// 3.35 TB/s).
//
// Design: label the traversable mask with the B2 union-find (cc_label.cuh),
// mark the component of every seeded pixel (flag[label] = 1, an idempotent
// plain store), then gather out = traversable && flag[label].  The Pallas
// flood iterated max-sweeps to a fixpoint, one step per pixel of geodesic
// distance at worst; labeling first makes the cost independent of it.  The
// wrapper passes the int32 label map and the uint8 flag array as scratch.

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

// seeds == nullptr: seed from the image border (B3), else from `seeds` (B4).
// labels: (h, w) int32 scratch; flag: (h*w) uint8 scratch; out: (h, w) bool.
extern "C" int ecseg_flood(const uint8_t* trav, const uint8_t* seeds,
                           int32_t* labels, uint8_t* flag, uint8_t* out, int h,
                           int w, int connectivity, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int n = h * w;
  int blocks = (n + ecseg::kThreads - 1) / ecseg::kThreads;
  ecseg::label_launch(trav, labels, h, w, connectivity, s);
  cudaMemsetAsync(flag, 0, static_cast<size_t>(n), s);
  if (seeds == nullptr) {
    int m = 2 * (h + w);
    mark_border<<<(m + ecseg::kThreads - 1) / ecseg::kThreads, ecseg::kThreads,
                  0, s>>>(trav, labels, flag, h, w);
  } else {
    mark_seeds<<<blocks, ecseg::kThreads, 0, s>>>(trav, seeds, labels, flag, n);
  }
  gather_flags<<<blocks, ecseg::kThreads, 0, s>>>(trav, labels, flag, out, n);
  return static_cast<int>(cudaGetLastError());
}
