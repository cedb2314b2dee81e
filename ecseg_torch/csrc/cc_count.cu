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
// two int32 per map written: B8a 1 byte/pixel (4.2 MB at 2048^2, 1.3 us at
// 3.35 TB/s); B8b the patch bytes that land on the canvases (32.9 MB for 32
// 1024^2 tiles of uint8 labels, 9.8 us).
//
// Both forms count on the tiled forest of cc_label.cuh, as it is built,
// with no per-pixel array at all.  They differ only in where a pixel's 0/1
// comes from: B8a reads its bool mask row-major, B8b the class bytes of its
// patch stack through the plan's descriptors (stitch_plan.cuh; no source
// map).  Three launches: a memset of the counts, then
//   tile   one block per strip of four 32x32 tiles side by side of each
//          map: 16 pixels a thread.  B8a loads them with one 16-byte load
//          where the row segment is aligned, else with two aligned ones
//          and a funnel shift (byte by byte only past the map's right
//          edge); B8b with one descriptor and two aligned 16-byte loads
//          where the 16 are one copy's consecutive labels, as four quads
//          where they cross a patch seam.  A tile with no foreground costs
//          nothing more; the others unite in shared memory (uf_tile_local)
//          one by one and add their foreground pixels and tile-local
//          pieces to the map's (count, px), one atomic each a tile, and a
//          byte a strip records which tiles those were.  Only a tile's
//          border pixels can meet another tile, so the global forest has a
//          node for each of them: 128 slots a tile (top row 0-31, bottom
//          row 32-63, left column 64 + y, right column 96 + y), each
//          foreground one pointing at its piece's least slot, which points
//          at itself.
//   edges  the unions across tile edges of cc_label.cuh (uf_edge_links,
//          64 threads a tile, a strip a block, each neighbour's value read
//          again from the source; a tile the strip's byte marks empty has
//          nothing to unite), as uf_link: each one that hangs a root under
//          another ends one of the forest's roots and nothing makes one, so
//          the map's count drops by the links made, whatever order they
//          land in.
// Components = tile-local pieces - links; a piece on no tile border is a
// component of its own and never linked.
// On the tile-count input (32 canvases of 1024^2, class 3 on 0.2 % of the
// pixels, 13 % of the tiles) B8b's tile pass is bound by reading the empty
// tiles.  Measured on an H100 (tile pass, us): blocks looping over tiles,
// a descriptor lookup a pixel, 110; a block a tile, a quad of four pixels
// a thread, 64 (looping 103); four tiles a block, four quads a thread 75;
// 16-pixel segments 55; eight tiles a block 64.  B8a, which once united in
// device memory from one thread a pixel (init, merge and count passes over
// an (H, W) parent array), shares these passes.

#include "cc_label.cuh"
#include "stitch_plan.cuh"

namespace {

using ecseg::kRows;
using ecseg::kTile;

constexpr int kSlots = 4 * kTile;  // a tile's border slots
constexpr int kStrip = 4;          // tiles a block of either pass, side by side

__device__ __forceinline__ bool on_border(int ly, int lx) {
  return ly == 0 || ly == kTile - 1 || lx == 0 || lx == kTile - 1;
}

__device__ __forceinline__ int border_slot(int ly, int lx) {
  return ly == 0 ? lx : ly == kTile - 1 ? kTile + lx : lx == 0 ? 2 * kTile + ly : 3 * kTile + ly;
}

// One canvas of B8b's batch: 1 where the plan's last copy holds class_id.
template <typename P>
struct PatchValues {
  const P* labels;  // this canvas's (n, 256, 256) patch labels
  ecseg::StitchPlan plan;
  int class_id;
  __device__ __forceinline__ uint8_t at(int r, int c) const {
    const int s = plan.src(r, c);
    return s >= 0 && static_cast<int>(__ldg(labels + s)) == class_id;
  }
};

// The edge pass's map: a pixel's value from `values` (PatchValues, or B8a's
// ecseg::MaskMap), its node the slot of the border pixel in its tile.
template <class V>
struct SlotMap {
  V values;
  int tiles_x;
  int node0;  // this map's first slot
  __device__ __forceinline__ uint8_t at(int r, int c) const { return values.at(r, c); }
  __device__ __forceinline__ int node(int r, int c) const {
    return node0 + ((r / kTile) * tiles_x + c / kTile) * kSlots + border_slot(r % kTile, c % kTile);
  }
};

// 1 in byte k where labels[k] == class_id, k = 0..3 (consecutive labels)
__device__ __forceinline__ uint32_t match4(const uint8_t* labels, int class_id) {
  if (class_id < 0 || class_id > 255) return 0;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(labels);
  const uint32_t* word = reinterpret_cast<const uint32_t*>(addr & ~uintptr_t{3});
  const int shift = static_cast<int>(addr & 3);
  const uint32_t lo = __ldg(word);
  const uint32_t hi = shift ? __ldg(word + 1) : 0u;  // label 3 is in the next word
  return __vcmpeq4(__funnelshift_r(lo, hi, 8 * shift), 0x01010101u * class_id) & 0x01010101u;
}

__device__ __forceinline__ uint32_t match4(const int32_t* labels, int class_id) {
  uint32_t m = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) m |= static_cast<uint32_t>(__ldg(labels + k) == class_id) << (8 * k);
  return m;
}

// Sixteen consecutive labels from the aligned 16-byte words that hold them
// (the offset is the same along a copy's columns, so a warp mostly takes
// one branch of `match`), loaded by `fetch`, compared by `match`: byte i of
// the result is 1 where label i == class_id.
template <typename P>
struct Seg16;

template <int Q>
__device__ __forceinline__ uint4 shift_words(const uint32_t (&w)[8], int r) {
  return make_uint4(__funnelshift_r(w[Q], w[Q + 1], r), __funnelshift_r(w[Q + 1], w[Q + 2], r),
                    __funnelshift_r(w[Q + 2], w[Q + 3], r), __funnelshift_r(w[Q + 3], w[Q + 4], r));
}

template <>
struct Seg16<uint8_t> {
  uint4 a, b;
  int off = 0;  // byte offset of the first label in `a`
  __device__ __forceinline__ void fetch(const uint8_t* p) {
    const uintptr_t addr = reinterpret_cast<uintptr_t>(p);
    const uint4* base = reinterpret_cast<const uint4*>(addr & ~uintptr_t{15});
    off = static_cast<int>(addr & 15);
    a = __ldg(base);
    b = off ? __ldg(base + 1) : make_uint4(0, 0, 0, 0);  // label 15 is in the next word
  }
  __device__ __forceinline__ uint4 match(int class_id) const {
    if (class_id < 0 || class_id > 255) return make_uint4(0, 0, 0, 0);
    const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    const int r = 8 * (off & 3);
    uint4 v;
    switch (off >> 2) {
      case 0: v = shift_words<0>(w, r); break;
      case 1: v = shift_words<1>(w, r); break;
      case 2: v = shift_words<2>(w, r); break;
      default: v = shift_words<3>(w, r); break;
    }
    const uint32_t c = 0x01010101u * class_id;
    return make_uint4(__vcmpeq4(v.x, c) & 0x01010101u, __vcmpeq4(v.y, c) & 0x01010101u,
                      __vcmpeq4(v.z, c) & 0x01010101u, __vcmpeq4(v.w, c) & 0x01010101u);
  }
};

template <>
struct Seg16<int32_t> {
  int4 v[5];
  int off = 0;  // label offset of the first label in v[0]
  __device__ __forceinline__ void fetch(const int32_t* p) {
    const uintptr_t addr = reinterpret_cast<uintptr_t>(p);
    const int4* base = reinterpret_cast<const int4*>(addr & ~uintptr_t{15});
    off = static_cast<int>((addr & 15) >> 2);
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = __ldg(base + k);
    v[4] = off ? __ldg(base + 4) : make_int4(0, 0, 0, 0);
  }
  __device__ __forceinline__ uint4 match(int class_id) const {
    int l[20];
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      l[4 * k] = v[k].x;
      l[4 * k + 1] = v[k].y;
      l[4 * k + 2] = v[k].z;
      l[4 * k + 3] = v[k].w;
    }
    uint32_t m[4] = {0, 0, 0, 0};
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int x = off == 0 ? l[i] : off == 1 ? l[i + 1] : off == 2 ? l[i + 2] : l[i + 3];
      m[i >> 2] |= static_cast<uint32_t>(x == class_id) << (8 * (i & 3));
    }
    return make_uint4(m[0], m[1], m[2], m[3]);
  }
};

// Byte i: pixel (y, x + i) of B8b's canvas holds the class (y < h, x < w).
// One descriptor and two 16-byte loads where the 16 are one copy's
// consecutive labels (else as four quads).
template <typename P>
__device__ __forceinline__ uint4 seg16(const PatchValues<P>& v, int y, int x, int w) {
  const int2 row = v.plan.row(y);
  const int4 col = v.plan.col(x);
  if (x + 16 <= w && col.z >= 16) {  // one copy's consecutive labels, or all unreached
    if (row.y & col.y) return make_uint4(0, 0, 0, 0);
    Seg16<P> sl;
    sl.fetch(v.labels + row.x + col.x);
    return sl.match(v.class_id);
  }
  // across a patch seam or the map's right edge: four quads
  uint32_t quad[4] = {0, 0, 0, 0};
  for (int k = 0; k < 4; ++k) {
    const int xk = x + 4 * k;
    if (xk >= w) break;
    const int4 ck = v.plan.col(xk);
    if (xk + 4 <= w && ck.z >= 4) {
      if (!(row.y & ck.y)) quad[k] = match4(v.labels + row.x + ck.x, v.class_id);
    } else {
      for (int i = 0; i < 4 && xk + i < w; ++i) {
        const int s = v.plan.src(y, xk + i);
        quad[k] |= static_cast<uint32_t>(s >= 0 && static_cast<int>(v.labels[s]) == v.class_id) << (8 * i);
      }
    }
  }
  return make_uint4(quad[0], quad[1], quad[2], quad[3]);
}

// Byte i: pixel (y, x + i) of B8a's bool mask is set (y < h, x < w).  The
// mask's bytes are 0 or 1, so they are the result as loaded: one 16-byte
// load where the segment is aligned (every row when w % 16 == 0), two
// aligned ones shifted together where it is not, byte loads only past the
// right edge.
__device__ __forceinline__ uint4 seg16(const ecseg::MaskMap& m, int y, int x, int w) {
  const uint8_t* p = m.mask + y * w + x;
  if (x + 16 <= w) {
    Seg16<uint8_t> sl;
    sl.fetch(p);
    return sl.match(1);
  }
  uint32_t q[4] = {0, 0, 0, 0};
  for (int i = 0; x + i < w; ++i) q[i >> 2] |= static_cast<uint32_t>(__ldg(p + i) != 0) << (8 * (i & 3));
  return make_uint4(q[0], q[1], q[2], q[3]);
}

// One tile with foreground, its 0/1 values in `val`, united in shared
// memory by the block: its pieces and foreground pixels added to `out`
// (its map's count and px), its foreground border pixels' slots from
// `tile` * 128 on pointed at their piece's least slot.
__device__ __forceinline__ void count_tile(uint8_t (*val)[kTile], int tile, int connectivity, int* local,
                                           int* least, int* sums, int* __restrict__ parent, int* out) {
  const int lane = threadIdx.x & 31;
  const int band = (threadIdx.x >> 5) * kRows;
  uint8_t own[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) own[j] = val[band + j][lane];
  if (threadIdx.x < 2) sums[threadIdx.x] = 0;  // read after uf_tile_local's barriers
  ecseg::uf_tile_local<false>(own, val, local, lane, band, connectivity);

  int fg = 0, pieces = 0;
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int k = (band + j) * kTile + lane;
    const int r = local[k];
    fg += r >= 0;
    pieces += r == k;
    least[k] = kSlots;
  }
  fg = __reduce_add_sync(0xffffffffu, fg);
  pieces = __reduce_add_sync(0xffffffffu, pieces);
  if (lane == 0) {
    atomicAdd(&sums[0], pieces);
    atomicAdd(&sums[1], fg);
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int ly = band + j;
    const int r = local[ly * kTile + lane];
    if (r >= 0 && on_border(ly, lane)) atomicMin(&least[r], border_slot(ly, lane));
  }
  __syncthreads();
  const int node0 = tile * kSlots;
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int ly = band + j;
    const int r = local[ly * kTile + lane];
    if (r >= 0 && on_border(ly, lane)) parent[node0 + border_slot(ly, lane)] = node0 + least[r];
  }
  if (threadIdx.x == 0) {
    if (sums[0]) atomicAdd(out, sums[0]);
    if (sums[1]) atomicAdd(out + 1, sums[1]);
  }
  __syncthreads();  // the next tile reuses the shared arrays
}

// Tile pass of map t (blockIdx.x the strip of kStrip tiles side by side):
// thread q loads the 16 pixels 16(q % 8)..+15 of strip row q / 8 from
// `values` (seg16), so each warp loads the rows of its own band in every
// tile of the strip; the tiles with foreground are then united one by
// one, and the strip's byte in `occupied` says which they were (the edge
// pass reads it).
template <class V>
__device__ __forceinline__ void tile_pass(const V& values, int t, int h, int w, int tiles_x, int strips_x,
                                          int connectivity, int* __restrict__ parent,
                                          uint8_t* __restrict__ occupied, int* __restrict__ out) {
  __shared__ __align__(16) uint8_t val[kStrip][kTile][kTile];
  __shared__ int local[kTile * kTile];
  __shared__ int least[kTile * kTile];  // at a local root: its piece's least border slot
  __shared__ int sums[2];               // a tile's pieces, foreground pixels
  __shared__ unsigned warp_tiles[ecseg::kTileThreads / 32];
  const int ty = blockIdx.x / strips_x;
  const int tx0 = (blockIdx.x % strips_x) * kStrip;
  const int qy = threadIdx.x >> 3;
  const int seg = threadIdx.x & 7;  // tile seg / 2, its columns 16 (seg % 2)..+15
  const int y = ty * kTile + qy;
  const int x = tx0 * kTile + 16 * seg;
  const uint4 seg16s = y < h && x < w ? seg16(values, y, x, w) : make_uint4(0, 0, 0, 0);
  *reinterpret_cast<uint4*>(&val[seg >> 1][qy][16 * (seg & 1)]) = seg16s;
  // which tiles hold foreground: lane l loads tile (l % 8) / 2
  const unsigned ballot = __ballot_sync(0xffffffffu, (seg16s.x | seg16s.y | seg16s.z | seg16s.w) != 0);
  if ((threadIdx.x & 31) == 0) {
    unsigned tiles = 0;
#pragma unroll
    for (int k = 0; k < kStrip; ++k) tiles |= ((ballot & (0x03030303u << (2 * k))) != 0) << k;
    warp_tiles[threadIdx.x >> 5] = tiles;
  }
  __syncthreads();
  unsigned tiles = 0;
#pragma unroll
  for (int k = 0; k < ecseg::kTileThreads / 32; ++k) tiles |= warp_tiles[k];
  if (threadIdx.x == 0) occupied[t * gridDim.x + blockIdx.x] = static_cast<uint8_t>(tiles);
  const int tile0 = (t * ((h + kTile - 1) / kTile) + ty) * tiles_x + tx0;
  for (int k = 0; k < kStrip; ++k) {
    if (tiles >> k & 1) count_tile(val[k], tile0 + k, connectivity, local, least, sums, parent, out + 2 * t);
  }
}

// Edge pass of map t: 64 threads a tile (uf_edge_links), a block per strip
// of kStrip tiles as in the tile pass; a tile with no foreground (its bit
// in the strip's `occupied` byte clear) has none on its top row or left
// column to unite.
template <class V>
__device__ __forceinline__ void edge_pass(const V& values, int t, int h, int w, int tiles_x, int strips_x,
                                          int connectivity, int* parent, const uint8_t* __restrict__ occupied,
                                          int* out) {
  const int ty = blockIdx.x / strips_x;
  const int k = threadIdx.x >> 6;
  const int tx = (blockIdx.x % strips_x) * kStrip + k;
  const int tiles = tiles_x * ((h + kTile - 1) / kTile);
  const SlotMap<V> m{values, tiles_x, t * tiles * kSlots};
  const bool here = occupied[t * gridDim.x + blockIdx.x] >> k & 1;
  int links = here ? ecseg::uf_edge_links<false, true>(m, parent, h, w, ty * kTile, tx * kTile, connectivity,
                                                       threadIdx.x & 63)
                   : 0;
  links = __reduce_add_sync(0xffffffffu, links);
  if ((threadIdx.x & 31) == 0 && links) atomicSub(out + 2 * t, links);
}

// B8a's passes over its one mask.
__global__ void __launch_bounds__(ecseg::kTileThreads)
    count_mask_tiles(const uint8_t* __restrict__ mask, int h, int w, int tiles_x, int strips_x, int connectivity,
                     int* __restrict__ parent, uint8_t* __restrict__ occupied, int* __restrict__ out) {
  tile_pass(ecseg::MaskMap{mask, w}, 0, h, w, tiles_x, strips_x, connectivity, parent, occupied, out);
}

__global__ void __launch_bounds__(64 * kStrip)
    count_mask_edges(const uint8_t* __restrict__ mask, int h, int w, int tiles_x, int strips_x, int connectivity,
                     int* parent, const uint8_t* __restrict__ occupied, int* out) {
  edge_pass(ecseg::MaskMap{mask, w}, 0, h, w, tiles_x, strips_x, connectivity, parent, occupied, out);
}

// B8b's passes, canvas blockIdx.y of the batch.
template <typename P>
__global__ void __launch_bounds__(ecseg::kTileThreads)
    count_patch_tiles(const P* __restrict__ patches, long long per_tile, ecseg::StitchPlan plan, int class_id,
                      int h, int w, int tiles_x, int strips_x, int connectivity, int* __restrict__ parent,
                      uint8_t* __restrict__ occupied, int* __restrict__ out) {
  const int t = blockIdx.y;
  tile_pass(PatchValues<P>{patches + t * per_tile, plan, class_id}, t, h, w, tiles_x, strips_x, connectivity,
            parent, occupied, out);
}

template <typename P>
__global__ void __launch_bounds__(64 * kStrip)
    count_patch_edges(const P* __restrict__ patches, long long per_tile, ecseg::StitchPlan plan, int class_id,
                      int h, int w, int tiles_x, int strips_x, int connectivity, int* parent,
                      const uint8_t* __restrict__ occupied, int* out) {
  const int t = blockIdx.y;
  edge_pass(PatchValues<P>{patches + t * per_tile, plan, class_id}, t, h, w, tiles_x, strips_x, connectivity,
            parent, occupied, out);
}

// The passes' grid and the strips' bytes, which follow the t maps' slots
// in `parent`.
struct Layout {
  int tiles_x, strips_x;
  dim3 grid;
  uint8_t* occupied;
  Layout(int t, int h, int w, int* parent) {
    tiles_x = (w + kTile - 1) / kTile;
    const int tiles_y = (h + kTile - 1) / kTile;
    strips_x = (tiles_x + kStrip - 1) / kStrip;
    grid = dim3(strips_x * tiles_y, t);
    occupied = reinterpret_cast<uint8_t*>(parent + static_cast<long long>(t) * tiles_x * tiles_y * kSlots);
  }
};

template <typename P>
void count_patches_launch(const P* patches, long long per_tile, ecseg::StitchPlan plan, int t, int h, int w,
                          int class_id, int connectivity, int* parent, int* out, cudaStream_t s) {
  const Layout l(t, h, w, parent);
  count_patch_tiles<P><<<l.grid, ecseg::kTileThreads, 0, s>>>(patches, per_tile, plan, class_id, h, w, l.tiles_x,
                                                             l.strips_x, connectivity, parent, l.occupied, out);
  count_patch_edges<P><<<l.grid, 64 * kStrip, 0, s>>>(patches, per_tile, plan, class_id, h, w, l.tiles_x,
                                                      l.strips_x, connectivity, parent, l.occupied, out);
}

}  // namespace

// B8a: `mask` (h, w) bool; `parent` int32 scratch: 128 per 32x32 tile,
// then a byte per strip of four tiles; `out` int32[2].
extern "C" int ecseg_count(const uint8_t* mask, int32_t* parent, int h, int w,
                           int connectivity, int32_t* out, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  cudaMemsetAsync(out, 0, 2 * sizeof(int32_t), s);
  const Layout l(1, h, w, parent);
  count_mask_tiles<<<l.grid, ecseg::kTileThreads, 0, s>>>(mask, h, w, l.tiles_x, l.strips_x, connectivity, parent,
                                                         l.occupied, out);
  count_mask_edges<<<l.grid, 64 * kStrip, 0, s>>>(mask, h, w, l.tiles_x, l.strips_x, connectivity, parent,
                                                  l.occupied, out);
  return static_cast<int>(cudaGetLastError());
}

// B8b: `patches` (t, n, 256, 256) uint8 (`wide` 0) or int32 (`wide` 1);
// `plan` the descriptors of the (h, w) canvas (stitch_plan.cuh);
// `parent` int32 scratch: 128 per 32x32 tile per canvas, then a byte per
// strip of four tiles per canvas; `out` int32[2t].
extern "C" int ecseg_count_patches(const void* patches, int wide,
                                   const int32_t* plan, int t,
                                   long long patches_per_tile, int h, int w,
                                   int class_id, int connectivity,
                                   int32_t* parent, int32_t* out,
                                   void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  cudaMemsetAsync(out, 0, 2 * sizeof(int32_t) * t, s);
  const ecseg::StitchPlan sp = ecseg::stitch_plan(plan, w);
  if (wide) {
    count_patches_launch(static_cast<const int32_t*>(patches), patches_per_tile, sp, t, h, w, class_id,
                         connectivity, parent, out, s);
  } else {
    count_patches_launch(static_cast<const uint8_t*>(patches), patches_per_tile, sp, t, h, w, class_id,
                         connectivity, parent, out, s);
  }
  return static_cast<int>(cudaGetLastError());
}
