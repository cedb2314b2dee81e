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
// Design: every entry builds the tiled union-find forest of cc_label.cuh
// (uf_tiles_launch: each 32x32 tile united in shared memory, then one union
// per run crossing a tile edge, then a compress pass from every tile
// border) and gathers each pixel's root's flag: four launches, no memset.
// The Pallas floods iterated max-sweeps to a fixpoint, one step per pixel
// of geodesic distance at worst; labeling first makes the cost independent
// of it; the tiles keep a giant component (B3's input, a class's
// background) from meeting at one root in device memory (cc_label.cuh).
//
//   B3 (ecseg_flood_border)  the compress pass marks flag[root] for the
//        pixels on the map's perimeter.
//   B4 (ecseg_flood), B6 (ecseg_flood_mc)  the tile pass flags the pixels
//        of every tile-local piece that holds a seed, from its
//        shared-memory forest, and the compress pass marks those pieces'
//        roots, so the marking costs no launch and no walk of its own and
//        dense seeds (a whole class) cost what sparse ones do.  B6 is B4
//        with the equal-class predicate (flood_seeds_launch<true>, 8-conn):
//        a seed on class 0 lies on no piece and is ignored.
//   B9 (ecseg_label_flood)  B4's forest, whose labels are the caller's
//        output: the last pass writes each pixel's root as its label and
//        its root's flag as its flood in one walk, so the mask is labeled
//        once where B2 + B4 labeled it twice.
// B3, B4 and B6 never flatten their forest (their labels are scratch).
// The gather reads flag[root(parent[i])], mostly one hop that a warp
// shares.  Flags are read only at roots, and a root's output is its own
// flag, so every entry's output may serve as its flag array.

#include "cc_label.cuh"

namespace {

// out = traversable && the pixel's root is flagged (background has parent
// -1).  `flag` may be `out` itself: flags are read only at roots, and a
// root's output is its own flag, so no read sees a changed value.  With
// kFlatten (B9) every parent also becomes its root, as uf_resolve does: a
// walk that reads a parent before or after that write finds an ancestor
// either way.
template <bool kFlatten>
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
    if (kFlatten && root != p[j]) parent[i] = root;
    if (i < n) out[i] = root >= 0 ? flag[root] : 0;
  }
}

}  // namespace

namespace ecseg {

// B3 on the tiled forest; `parent` and `flag` are scratch (`flag` may be
// `out`).
inline int flood_border_launch(const uint8_t* trav, int32_t* parent,
                               uint8_t* flag, uint8_t* out, int h, int w,
                               cudaStream_t s) {
  int n = h * w;
  uf_tiles_launch(trav, parent, h, w, 1, s, flag);  // marks the perimeter's roots
  gather_roots<false><<<pixel_blocks(n), kThreads, 0, s>>>(parent, flag, out, n);
  return static_cast<int>(cudaGetLastError());
}

// B4 (kSameClass false), B6 (true) and, with kFlatten, B9 on the tiled
// forest; `flag` is scratch (it may be `out`), and so is `parent` unless
// kFlatten, which makes it the canonical labels.
template <bool kSameClass, bool kFlatten = false>
int flood_seeds_launch(const uint8_t* trav, const uint8_t* seeds,
                       int32_t* parent, uint8_t* flag, uint8_t* out, int h,
                       int w, int connectivity, cudaStream_t s) {
  int n = h * w;
  uf_tiles_launch<kSameClass>(trav, parent, h, w, connectivity, s, flag, seeds);  // marks the seeds' roots
  gather_roots<kFlatten><<<pixel_blocks(n), kThreads, 0, s>>>(parent, flag, out, n);
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
  return ecseg::flood_seeds_launch<true>(cls, seeds, labels, flag, out, h, w,
                                         2, static_cast<cudaStream_t>(stream));
}

// B9: `labels` is an output, the canonical labels of `mask`.
extern "C" int ecseg_label_flood(const uint8_t* mask, const uint8_t* seeds,
                                 int32_t* labels, uint8_t* flag, uint8_t* out,
                                 int h, int w, int connectivity, void* stream) {
  return ecseg::flood_seeds_launch<false, true>(
      mask, seeds, labels, flag, out, h, w, connectivity,
      static_cast<cudaStream_t>(stream));
}
