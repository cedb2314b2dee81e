// Kernel B1: overlap stitch of per-patch labels into the image canvas.
//
// Replaces: ecseg_tpu/ops/cc_pallas.py stitch_labels_pallas
// (_stitch_labels_kernel), which ran the copy plan of
// ecseg_tpu/ops/tiling.py _stitch_plan rectangle by rectangle in VMEM.
//
// The plan's rectangles overlap: rim copies are overwritten by the interior
// copies that follow them, and the plan's order (including the reference's
// replicated `:242` axis quirk) decides the winner.  Run as parallel blocks
// the copies would race.  So the wrapper reduces the plan once per geometry
// to per-row and per-column descriptors (stitch_plan.cuh: the last copy's
// source is R[y] + C[x], a few KB where a per-pixel source map is 4 bytes a
// pixel), and this kernel writes each canvas pixel once.
//
// Bound on an H100: memory.  The least traffic is the uint8 patch bytes that
// land on the canvas read once and the int32 canvas written once (4.15 +
// 16.8 MB at 2048^2 with 100 patches, ~6.2 us at 3.35 TB/s; the overlap
// margins that later copies overwrite need not be read).
//
// Design: a thread writes quads, four consecutive pixels of one row, with
// one 16-byte store; a warp's 32 quads are 512 contiguous bytes.  Where the
// column descriptor says the next four columns continue one copy (`run`),
// the quad's bytes are consecutive in the patch stack: one aligned 32-bit
// load, or two funnel-shifted where the bytes straddle a word, and no read
// at all on unreached pixels (0).  A quad across a row's end or a patch
// seam takes its four pixels one by one.

#include "stitch_plan.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kQuads = 2;  // quads a thread, kThreads apart

// patches[0..3] widened to int32, from the aligned words that hold them
__device__ __forceinline__ int4 quad_bytes(const uint8_t* patches) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(patches);
  const uint32_t* p = reinterpret_cast<const uint32_t*>(addr & ~uintptr_t{3});
  const int s = static_cast<int>(addr & 3);
  const uint32_t lo = __ldg(p);
  const uint32_t hi = s ? __ldg(p + 1) : 0u;  // byte 3 is in the next word
  const uint32_t b = __funnelshift_r(lo, hi, 8 * s);
  return make_int4(b & 0xff, (b >> 8) & 0xff, (b >> 16) & 0xff, b >> 24);
}

__global__ void __launch_bounds__(kThreads)
    stitch_quads(const uint8_t* __restrict__ patches, ecseg::StitchPlan plan,
                 int32_t* __restrict__ out, int h, int w) {
  const int n = h * w;
  const int quads = (n + 3) / 4;
  const int first = blockIdx.x * kThreads * kQuads + threadIdx.x;
#pragma unroll
  for (int j = 0; j < kQuads; ++j) {
    const int q = first + j * kThreads;
    if (q >= quads) return;
    const int i = 4 * q;
    const int y = i / w;
    const int x = i - y * w;
    if (x + 4 <= w) {
      const int2 row = plan.row(y);
      const int4 col = plan.col(x);
      if (col.z >= 4) {
        *reinterpret_cast<int4*>(out + i) =
            (row.y & col.y) ? make_int4(0, 0, 0, 0) : quad_bytes(patches + row.x + col.x);
        continue;
      }
    }
    for (int k = i; k < i + 4 && k < n; ++k) {  // across a row's end or a seam
      const int yk = k / w;
      const int s = plan.src(yk, k - yk * w);
      out[k] = s < 0 ? 0 : patches[s];
    }
  }
}

}  // namespace

// `plan`: the descriptors of an (h, w) canvas (stitch_plan.cuh); `out`
// (h, w) int32, 16-byte aligned.
extern "C" int ecseg_stitch(const uint8_t* patches, const int32_t* plan,
                            int32_t* out, int h, int w, void* stream) {
  const int quads = (h * w + 3) / 4;
  const int per_block = kThreads * kQuads;
  stitch_quads<<<(quads + per_block - 1) / per_block, kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(patches, ecseg::stitch_plan(plan, w), out, h, w);
  return static_cast<int>(cudaGetLastError());
}
