// Kernel B2: canonical connected-component labeling.
//
// Replaces: ecseg_tpu/ops/cc_pallas.py label_pallas (_label_kernel,
// _cc_fixpoint), and for maps past the TPU's VMEM gate
// ecseg_tpu/ops/cc_pallas_banded.py label_banded -- this kernel has no size
// gate, so it serves both contracts.
//
// Bound on an H100: memory.  The work is O(1) per pixel; the least traffic
// is the uint8 mask read once and the int32 labels written once
// (5 bytes/pixel, 21 MB at 2048^2, ~6 us at 3.35 TB/s).  The Pallas kernel's
// shape (a VMEM-resident fixpoint of 3x3 min sweeps and 256-step
// Hillis-Steele scans) came from TPU limits that do not exist here.
//
// Design: union-find in three passes (cc_label.cuh) whose cost does not
// grow with a component's geodesic length, so snakes and spirals take no
// more passes than blobs.  The parent array is the output itself, so the
// kernel allocates nothing.  Not yet done (a later change): a block-local
// union-find in shared memory before the global merge, which would cut the
// global atomics and the extra reads of parent[] the three passes make.

#include "cc_label.cuh"

extern "C" int ecseg_label(const uint8_t* mask, int32_t* labels, int h, int w,
                           int connectivity, void* stream) {
  ecseg::label_launch(mask, labels, h, w, connectivity,
                      static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
