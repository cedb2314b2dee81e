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
// Design, B6/B9: label the traversable mask with the three-pass union-find
// (label_launch in cc_label.cuh; B6 with its equal-class merge), mark the
// component of every seeded pixel (flag[label] = 1, an idempotent plain
// store), then gather out = traversable && flag[label].  The Pallas flood
// iterated max-sweeps to a fixpoint, one step per pixel of geodesic
// distance at worst; labeling first makes the cost independent of it.  B6
// gets the int32 label map and the uint8 flag array from the wrapper as
// scratch; B9 is the same sequence with the label map as its second output,
// so the mask is labeled once where B4 + B2 labeled it twice.
//
// Design, B3 and B4 (ecseg_flood_border, ecseg_flood): on the three passes
// millions of merging threads met at one root in device memory when the
// traversable mask was one giant component (B3's input, a class's
// background: 0.85 ms on an H100 at 2048^2, against 2.5 us of bytes), and
// the merge, memset, mark and gather were six launches (B4: 0.11 ms at the
// main path's input).  Both build the tiled forest instead (uf_tiles_launch:
// each 32x32 tile united in shared memory, then one union per run crossing
// a tile edge), so a giant component makes about two global unions a tile,
// and run four launches.
// Their labels are scratch, so they never flatten them.  The tile pass
// writes the flags (no memset), and the compress pass marks flag[root]: B3
// for the perimeter's pixels; B4 for the pixels of every tile-local piece
// that holds a seed, which the tile pass flagged from its shared-memory
// forest, so the marking costs no launch and no walk of its own, and dense
// seeds (a whole class) cost what sparse ones do.  The gather reads
// flag[root(parent[i])], mostly one hop that a warp shares.  B4 is
// templated on the same-class predicate, so B6 can take it.

#include "cc_label.cuh"

namespace {

__global__ void mark_seeds(const uint8_t* __restrict__ trav,
                           const uint8_t* __restrict__ seeds,
                           const int* __restrict__ labels,
                           uint8_t* flag, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n && trav[i] && seeds[i]) flag[labels[i]] = 1;
}

// B3, B4: out = traversable && the pixel's root is flagged (background has
// parent -1).  `flag` may be `out` itself: flags are read only at roots,
// and a root's output is its own flag, so no read sees a changed value.
__global__ void gather_roots(int* parent, const uint8_t* flag, uint8_t* out,
                             int n) {
  constexpr int kPixels = ecseg::kPixelsPerThread;
  const int base = blockIdx.x * blockDim.x * kPixels + threadIdx.x;
  int p[kPixels];
#pragma unroll
  for (int j = 0; j < kPixels; ++j) {
    const int i = base + j * blockDim.x;
    p[j] = i < n ? parent[i] : -1;
  }
#pragma unroll
  for (int j = 0; j < kPixels; ++j) {
    const int i = base + j * blockDim.x;
    const int x = ecseg::uf_walk_from(i, p[j]);
    const int r = ecseg::uf_find_warp<true>(parent, x);  // every lane calls it
    const int root = x < 0 ? p[j] : r;
    if (i < n) out[i] = root >= 0 ? flag[root] : 0;
  }
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
// scratch; out: (h, w) bool.
template <bool kSameClass>
int flood_launch(const uint8_t* trav, const uint8_t* seeds, int32_t* labels,
                 uint8_t* flag, uint8_t* out, int h, int w, int connectivity,
                 cudaStream_t s) {
  int n = h * w;
  int blocks = (n + kThreads - 1) / kThreads;
  label_launch<kSameClass>(trav, labels, h, w, connectivity, s);
  cudaMemsetAsync(flag, 0, static_cast<size_t>(n), s);
  mark_seeds<<<blocks, kThreads, 0, s>>>(trav, seeds, labels, flag, n);
  gather_flags<<<blocks, kThreads, 0, s>>>(trav, labels, flag, out, n);
  return static_cast<int>(cudaGetLastError());
}

// B3 on the tiled forest; `parent` and `flag` are scratch (`flag` may be
// `out`).
inline int flood_border_launch(const uint8_t* trav, int32_t* parent,
                               uint8_t* flag, uint8_t* out, int h, int w,
                               cudaStream_t s) {
  int n = h * w;
  uf_tiles_launch(trav, parent, h, w, 1, s, flag);  // marks the perimeter's roots
  gather_roots<<<pixel_blocks(n), kThreads, 0, s>>>(parent, flag, out, n);
  return static_cast<int>(cudaGetLastError());
}

// B4 on the tiled forest; `parent` and `flag` are scratch (`flag` may be
// `out`).
template <bool kSameClass>
int flood_seeds_launch(const uint8_t* trav, const uint8_t* seeds,
                       int32_t* parent, uint8_t* flag, uint8_t* out, int h,
                       int w, int connectivity, cudaStream_t s) {
  int n = h * w;
  uf_tiles_launch<kSameClass>(trav, parent, h, w, connectivity, s, flag, seeds);  // marks the seeds' roots
  gather_roots<<<pixel_blocks(n), kThreads, 0, s>>>(parent, flag, out, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ecseg

// B3: traversable pixels 4-connected to the image border.
extern "C" int ecseg_flood_border(const uint8_t* trav, int32_t* labels,
                                  uint8_t* flag, uint8_t* out, int h, int w,
                                  void* stream) {
  return ecseg::flood_border_launch(trav, labels, flag, out, h, w,
                                    static_cast<cudaStream_t>(stream));
}

// B4: traversable pixels connected to a seed.
extern "C" int ecseg_flood(const uint8_t* trav, const uint8_t* seeds,
                           int32_t* labels, uint8_t* flag, uint8_t* out, int h,
                           int w, int connectivity, void* stream) {
  return ecseg::flood_seeds_launch<false>(trav, seeds, labels, flag, out, h,
                                          w, connectivity,
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
