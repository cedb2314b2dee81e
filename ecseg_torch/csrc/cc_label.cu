// Kernels B2 (canonical connected-component labeling) and B5 (the same per
// class of a class map).
//
// Replaces: ecseg_tpu/ops/cc_pallas.py label_pallas (_label_kernel,
// _cc_fixpoint), and for maps past the TPU's VMEM gate
// ecseg_tpu/ops/cc_pallas_banded.py label_banded -- this kernel has no size
// gate, so it serves both contracts.  B5 replaces
// ecseg_tpu/ops/cc_pallas.py label_multiclass_pallas (_label_mc_kernel,
// _mc_fixpoint): each nonzero pixel of a uint8 class map gets the min flat
// index of its SAME-class 8-connected component, class 0 gets -1.
//
// Bound on an H100: memory.  The work is O(1) per pixel; the least traffic
// is the uint8 mask read once and the int32 labels written once
// (5 bytes/pixel, 21 MB at 2048^2, ~6 us at 3.35 TB/s).  The Pallas kernel's
// shape (a VMEM-resident fixpoint of 3x3 min sweeps and 256-step
// Hillis-Steele scans) came from TPU limits that do not exist here.
//
// Design: union-find (cc_label.cuh), whose cost does not grow with a
// component's geodesic length, so snakes and spirals take no more passes
// than blobs.  The parent array is the output itself, so the kernel
// allocates nothing.
//
// B2 and B5 run the tiled form (label_tiled_launch): what bounded the three
// global passes was not bytes but the device-memory atomics and the
// repeated reads of parent[] (every fg pixel made 2-4 global unions, each a
// walk of volatile loads).  Now a block labels its 32x32 tile in shared
// memory (row runs from one ballot, unions with the row above only where a
// run starts touching it), writes each pixel's tile-local root as its
// global parent (this is the init pass), a second kernel unites across
// tile edges only (one union per run that crosses an edge), and a third
// flattens: about the mask read once, the labels written once and read
// once more.
//
// B5 instantiates it with the merge predicate "equal class" (the template
// argument kSameClass of uf_tile and uf_tile_edges): one labeling covers
// every class, where the per-class form ran B2 once per class.  Its row
// runs and skip rules hold unchanged, since "equal nonzero class" is an
// equivalence like "both foreground".

#include "cc_label.cuh"

extern "C" int ecseg_label(const uint8_t* mask, int32_t* labels, int h, int w,
                           int connectivity, void* stream) {
  ecseg::label_tiled_launch(mask, labels, h, w, connectivity,
                            static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ecseg_label_mc(const uint8_t* cls, int32_t* labels, int h, int w,
                              void* stream) {
  ecseg::label_tiled_launch<true>(cls, labels, h, w, 2,
                                  static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
