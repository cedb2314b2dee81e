// Kernel B8: (number of connected components, number of foreground pixels)
// of a binary map, in two forms.
//
// Replaces: ecseg_tpu/ops/cc_pallas.py count_cc_pallas (_count_kernel; B8a,
// ecseg_count) and count_cc_from_patches (_count_from_patches_kernel; B8b,
// ecseg_count_patches).  B8b runs the overlap stitch, the `== class_id`
// mask and the count in one call, for a batch of T tiles: the stitched
// canvas and the label map are never written out.  As in the Pallas
// kernel, a canvas pixel that no copy of the plan reaches is background
// whatever class_id is (the 25-px right rim of square geometries at
// class_id 0).
//
// Bound on an H100: memory.  The least traffic is the input read once and
// two int32 per tile written: B8a 1 byte/pixel (4.2 MB at 2048^2, 1.3 us at
// 3.35 TB/s); B8b the patch bytes that land on the canvases (26.2 MB for 32
// 1024^2 tiles of uint8 labels, 7.8 us).  This design also writes and
// re-reads an int32 parent array and reads B1's int32 source map.
//
// Design: B2's union-find (cc_label.cuh) without its flatten pass.  A
// component's root is its minimum flat index and the only pixel whose
// parent is itself, so once every union has landed the count is the
// number of pixels with parent[i] == i and the foreground is parent[i] >= 0.
//   init   B8a: parent[i] = mask[i] ? i : -1 (uf_init);  B8b: the source
//          map (last writer of the copy plan, per canvas pixel; the same
//          map kernel B1 gathers with) picks each pixel's patch byte, and
//          parent[i] = (src >= 0 && byte == class_id) ? i : -1
//   merge  each foreground pixel unites with its already-scanned foreground
//          neighbours; foreground is read off the sign of parent[], which
//          never changes, so no mask array is kept
//   count  a grid-stride loop per tile, a block reduction, two atomics per
//          block into the tile's (count, px)
// Tiles are the grid's y dimension and never unite: a neighbour is taken
// only inside the same tile, and all flat indices of a tile share its
// offset, so each root is still its component's minimum.

#include "cc_label.cuh"

namespace {

using ecseg::kThreads;

template <typename P>
__global__ void init_from_patches(const P* __restrict__ patches,
                                  const int32_t* __restrict__ src,
                                  int class_id, int* parent, int hw,
                                  long long patches_per_tile) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= hw) return;
  int t = blockIdx.y;
  int s = src[i];
  bool fg = s >= 0 &&
            static_cast<int>(patches[t * patches_per_tile + s]) == class_id;
  long long g = static_cast<long long>(t) * hw + i;
  parent[g] = fg ? static_cast<int>(g) : -1;
}

__global__ void merge_tiles(int* parent, int h, int w, int connectivity) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= h * w) return;
  int g = blockIdx.y * h * w + i;
  if (parent[g] < 0) return;
  int r = i / w;
  int c = i - r * w;
  if (c > 0 && parent[g - 1] >= 0) ecseg::uf_union(parent, g, g - 1);
  if (r > 0) {
    int u = g - w;
    if (parent[u] >= 0) ecseg::uf_union(parent, g, u);
    if (connectivity == 2) {
      if (c > 0 && parent[u - 1] >= 0) ecseg::uf_union(parent, g, u - 1);
      if (c < w - 1 && parent[u + 1] >= 0) ecseg::uf_union(parent, g, u + 1);
    }
  }
}

// out[2t] += roots of tile t, out[2t + 1] += its foreground pixels.
__global__ void count_tiles(const int* __restrict__ parent, int hw,
                            int* out) {
  int t = blockIdx.y;
  const int* p = parent + static_cast<long long>(t) * hw;
  int base = t * hw;
  int roots = 0, px = 0;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < hw;
       i += gridDim.x * blockDim.x) {
    int v = p[i];
    px += v >= 0;
    roots += v == base + i;
  }
  for (int o = 16; o > 0; o >>= 1) {
    roots += __shfl_down_sync(0xffffffffu, roots, o);
    px += __shfl_down_sync(0xffffffffu, px, o);
  }
  __shared__ int part[2][kThreads / 32];
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    part[0][warp] = roots;
    part[1][warp] = px;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int k = 1; k < kThreads / 32; ++k) {
      roots += part[0][k];
      px += part[1][k];
    }
    if (roots) atomicAdd(out + 2 * t, roots);
    if (px) atomicAdd(out + 2 * t + 1, px);
  }
}

// merge + count of T tiles of (h, w) whose parent[] is initialised.
int merge_and_count(int* parent, int t, int h, int w, int connectivity,
                    int32_t* out, cudaStream_t s) {
  int hw = h * w;
  cudaMemsetAsync(out, 0, 2 * sizeof(int32_t) * t, s);
  dim3 grid((hw + kThreads - 1) / kThreads, t);
  merge_tiles<<<grid, kThreads, 0, s>>>(parent, h, w, connectivity);
  // enough blocks to fill the card, at least 8 pixels a thread
  int per_tile = (hw + 8 * kThreads - 1) / (8 * kThreads);
  int cap = 1024 / t > 1 ? 1024 / t : 1;
  dim3 cgrid(per_tile < cap ? per_tile : cap, t);
  count_tiles<<<cgrid, kThreads, 0, s>>>(parent, hw, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// B8a: `mask` (h, w) bool; `parent` (h, w) int32 scratch; `out` int32[2].
extern "C" int ecseg_count(const uint8_t* mask, int32_t* parent, int h, int w,
                           int connectivity, int32_t* out, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  int n = h * w;
  ecseg::uf_init<<<(n + kThreads - 1) / kThreads, kThreads, 0, s>>>(mask, parent, n);
  return merge_and_count(parent, 1, h, w, connectivity, out, s);
}

// B8b: `patches` (t, n, 256, 256) uint8 (`wide` 0) or int32 (`wide` 1);
// `src` (h, w) int32, flat index into one tile's patch stack or -1;
// `parent` (t, h, w) int32 scratch; `out` int32[2t].
extern "C" int ecseg_count_patches(const void* patches, int wide,
                                   const int32_t* src, int t,
                                   long long patches_per_tile, int h, int w,
                                   int class_id, int connectivity,
                                   int32_t* parent, int32_t* out,
                                   void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  dim3 grid((h * w + kThreads - 1) / kThreads, t);
  if (wide) {
    init_from_patches<int32_t><<<grid, kThreads, 0, s>>>(
        static_cast<const int32_t*>(patches), src, class_id, parent, h * w,
        patches_per_tile);
  } else {
    init_from_patches<uint8_t><<<grid, kThreads, 0, s>>>(
        static_cast<const uint8_t*>(patches), src, class_id, parent, h * w,
        patches_per_tile);
  }
  return merge_and_count(parent, t, h, w, connectivity, out, s);
}
