// Union-find connected-component labeling shared by kernels B2/B5
// (cc_label.cu), B3/B4/B6/B9 (cc_flood.cu) and B8 (cc_count.cu).
//
// Contract (ecseg_tpu/ops/cc_pallas.py label_pallas): every foreground pixel
// gets the smallest flat index r*W+c of its component, background gets -1;
// connectivity 1 (4-neighbour) or 2 (8-neighbour).  With kSameClass (B5,
// label_multiclass_pallas) the map holds class ids, 0 is background, and
// two neighbours join only when their classes are equal; the choice is a
// template argument, so B2's merge loop carries no extra test.
//
// Linking hangs the larger root under the smaller one with atomicMin and
// retries when another thread got there first (Playne & Hawick 2018;
// Allegretti et al. 2019).  Every write to a parent array is an atomicMin (or
// a root of the writer's own tree), so a parent only ever moves to a smaller
// index of the same component: parent[x] <= x holds throughout, the root of
// every tree is its component's minimum flat index, and the result is
// canonical and identical from run to run whatever order the atomics land
// in.  finds halve the path they walk (also by atomicMin) so chains built by
// racing unions shrink as they are read.  The same uf_find/uf_union serve a
// parent array in device memory and one in shared memory.
//
// Two launches build the forest:
//
// label_launch (B4, B5, B6, B8, B9): three passes over the (H, W) map, one
// thread per pixel, all state in the int32 output itself (the parent array):
//   init     parent[i] = fg ? i : -1
//   merge    each fg pixel unites with its already-scanned fg neighbours
//            (left and up; up-left and up-right for 8-conn)
//   flatten  parent[i] = find(i)
// On a map that is one giant component (B3's input: a class's background,
// nearly the whole canvas) millions of merging threads meet at one root in
// device memory, and the merge builds row-long chains that flatten walks
// again: B3 took 0.85 ms on an H100 at 2048^2 where its bytes need
// 2.5 us.
//
// uf_tiles_launch (B2, B3): a block-local union-find in shared memory before
// a global merge that touches only the tiles' edges.
//   tile     one block per 32x32 tile (5 KB of shared memory, 8 blocks an
//            SM), each warp a band of 4 rows.  A row's runs come from one
//            ballot (each pixel's parent is its run's first pixel); each
//            pixel unites in shared memory with the row above only where
//            its left neighbour does not already reach the same pixels (a
//            full tile makes 31 unions, not 2048), inside each band top
//            down, then band to band.  The tile is flattened by pointer
//            jumping (all nodes to their grandparents at once, in rounds),
//            not by one walk per pixel.  Each pixel's global parent is then
//            the flat index of its tile-local root: the tile's row-major
//            order is the global order restricted to the tile, so that root
//            is the minimum of the piece and parent[x] <= x holds.  This is
//            the init pass too.
//   edges    one thread per pixel of a tile's top row and left column
//            unites with its neighbours in the tiles above and to the left
//            (at 8-conn the diagonals, the corner pixel's into a third
//            tile, and the left column's down-left one), skipping pairs
//            its predecessor along the edge already joined through the
//            tile-local sets: one union per run crossing an edge.
//   compress a walker from every pixel of every tile's border to its root,
//            all at once, so path halving collapses the chains of tile
//            roots that concurrent unions built (pointer jumping); each
//            walk then points its nodes at the root.
// The forest is then settled: no union is in flight, so no node becomes or
// stops being a root, and the last pass walks it with plain loads that L1
// may serve (uf_root; a stale parent is still an ancestor), mostly one hop,
// and a pixel that is its own root does not walk at all.  Walked with the
// volatile device-memory finds, that pass was half of B2's time on an H100,
// bound by the latency of dependent L2 loads.
// label_tiled_launch flattens the forest (B2); B3 marks the roots of the
// perimeter in the compress pass and gathers each pixel's root's flag
// without flattening (cc_flood.cu).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace ecseg {

constexpr int kThreads = 256;

__device__ __forceinline__ int uf_load(const int* parent, int i) {
  // volatile: parents change under concurrent atomics; never reuse a
  // register or L1 copy
  return *(reinterpret_cast<const volatile int*>(parent) + i);
}

__device__ __forceinline__ int uf_find(int* parent, int x) {
  int y = uf_load(parent, x);
  while (y != x) {
    int z = uf_load(parent, y);
    if (z == y) return y;
    atomicMin(parent + x, z);  // path halving: x -> its grandparent
    x = z;
    y = uf_load(parent, x);
  }
  return x;
}

// The root of x in a settled forest (no union in flight, so no node becomes
// or stops being a root): plain loads that L1 may serve -- a stale parent
// is still an ancestor -- and no writes.
__device__ __forceinline__ int uf_root(const int* parent, int x) {
  int y = __ldca(parent + x);
  while (y != x) {
    x = y;
    y = __ldca(parent + x);
  }
  return x;
}

// A find for a whole warp: the lanes that start from the same node walk its
// path once (the lowest of them; the rest take its root by shuffle), so a
// warp over one tile's piece makes one walk, not 32.  kSettled walks with
// uf_root, else with uf_find.  Every lane of the warp must call it; x < 0
// (no node) comes back unchanged.
template <bool kSettled = false>
__device__ __forceinline__ int uf_find_warp(int* parent, int x) {
  const unsigned same = __match_any_sync(0xffffffffu, x);
  const int leader = __ffs(same) - 1;
  int r = x;
  if (x >= 0 && static_cast<int>(threadIdx.x & 31) == leader) {
    r = kSettled ? uf_root(parent, x) : uf_find(parent, x);
  }
  return __shfl_sync(0xffffffffu, r, leader);
}

__device__ __forceinline__ void uf_union(int* parent, int a, int b) {
  while (true) {
    a = uf_find(parent, a);
    b = uf_find(parent, b);
    if (a == b) return;
    if (a < b) {
      int t = a;
      a = b;
      b = t;
    }
    int old = atomicMin(parent + a, b);  // hang root a under the smaller b
    if (old == a) return;
    a = old;  // a stopped being a root meanwhile: unite from its new parent
  }
}

__global__ void uf_init(const uint8_t* __restrict__ mask, int* parent, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) parent[i] = mask[i] ? i : -1;
}

// Does neighbour value `nb` join a pixel of (nonzero) value `own`?
template <bool kSameClass>
__device__ __forceinline__ bool uf_joins(uint8_t nb, uint8_t own) {
  if constexpr (kSameClass) {
    return nb == own;
  } else {
    return nb != 0;
  }
}

template <bool kSameClass>
__global__ void uf_merge(const uint8_t* __restrict__ mask, int* parent, int h,
                         int w, int connectivity) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= h * w) return;
  const uint8_t own = mask[i];
  if (!own) return;
  int r = i / w;
  int c = i - r * w;
  if (c > 0 && uf_joins<kSameClass>(mask[i - 1], own)) uf_union(parent, i, i - 1);
  if (r > 0) {
    int u = i - w;
    if (uf_joins<kSameClass>(mask[u], own)) uf_union(parent, i, u);
    if (connectivity == 2) {
      if (c > 0 && uf_joins<kSameClass>(mask[u - 1], own)) uf_union(parent, i, u - 1);
      if (c < w - 1 && uf_joins<kSameClass>(mask[u + 1], own)) uf_union(parent, i, u + 1);
    }
  }
}

__global__ void uf_flatten(const uint8_t* __restrict__ mask, int* parent, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n && mask[i]) parent[i] = uf_find(parent, i);
}

// Enqueue the three passes on `stream`; `labels` is (h, w) int32.
template <bool kSameClass = false>
inline void label_launch(const uint8_t* mask, int* labels, int h, int w,
                         int connectivity, cudaStream_t stream) {
  int n = h * w;
  int blocks = (n + kThreads - 1) / kThreads;
  uf_init<<<blocks, kThreads, 0, stream>>>(mask, labels, n);
  uf_merge<kSameClass><<<blocks, kThreads, 0, stream>>>(mask, labels, h, w, connectivity);
  uf_flatten<<<blocks, kThreads, 0, stream>>>(mask, labels, n);
}

// ---- the tiled form ------------------------------------------------------

constexpr int kTile = 32;  // tile side: a warp spans a tile row
constexpr int kTileThreads = 256;

// Stage 1: one block per tile (tiles row-major, `tiles_x` per tile row).
// Pixels past the map's right or bottom edge are background.
// `clear`, when given, is zeroed at every pixel of the tile (B3's flags).
template <bool kSameClass>
__global__ void __launch_bounds__(kTileThreads)
    uf_tile(const uint8_t* __restrict__ mask, int* __restrict__ parent,
            uint8_t* __restrict__ clear, int h, int w, int tiles_x,
            int connectivity) {
  __shared__ uint8_t val[kTile][kTile];
  __shared__ int local[kTile * kTile];  // tile-local parents, -1 background
  const int y0 = (blockIdx.x / tiles_x) * kTile;
  const int x0 = (blockIdx.x % tiles_x) * kTile;
  const int lane = threadIdx.x & 31;
  const int x = x0 + lane;
  constexpr int kRows = kTile / (kTileThreads / 32);  // warp w: rows 4w..4w+3
  const int band = (threadIdx.x >> 5) * kRows;

  uint8_t own[kRows];  // all loads in flight before any is used
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int y = y0 + band + j;
    own[j] = (y < h && x < w) ? mask[y * w + x] : 0;
  }
  // runs of each row: a pixel's parent is the first pixel of its run
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int ly = band + j;
    val[ly][lane] = own[j];
    const uint8_t left = static_cast<uint8_t>(__shfl_up_sync(0xffffffffu, static_cast<int>(own[j]), 1));
    const bool joins_left = own[j] && lane > 0 && uf_joins<kSameClass>(left, own[j]);
    const unsigned runs = __ballot_sync(0xffffffffu, joins_left);
    const unsigned upto = lane == 31 ? 0xffffffffu : (2u << lane) - 1u;
    const int start = 31 - __clz(~runs & upto);  // bit 0 of ~runs is set
    local[ly * kTile + lane] = own[j] ? ly * kTile + start : -1;
  }
  __syncwarp();

  // each row joined to the row above, first inside the warp's band (top
  // down, so each union finds the band's roots one hop away), then, after
  // the barrier, each band's first row to the band above (a chain of at
  // most 8 band roots).  4-conn: skip when the left neighbour and the
  // up-left one join (the left pixel reached the up-left one, which is in
  // the up pixel's run).  8-conn: the left neighbour already reached
  // up-left and up; up-left and up-right are in up's run when up joins.
  auto join_up = [&](int ly, uint8_t o) {
    if (ly == 0 || !o) return;
    const int k = ly * kTile + lane;
    const bool jl = lane > 0 && uf_joins<kSameClass>(val[ly][lane - 1], o);
    const bool ju = uf_joins<kSameClass>(val[ly - 1][lane], o);
    const bool jul = lane > 0 && uf_joins<kSameClass>(val[ly - 1][lane - 1], o);
    if (connectivity == 1) {
      if (ju && !(jl && jul)) uf_union(local, k, k - kTile);
    } else {
      const bool jur = lane < 31 && uf_joins<kSameClass>(val[ly - 1][lane + 1], o);
      if (ju && !jl) uf_union(local, k, k - kTile);
      if (jul && !jl && !ju) uf_union(local, k, k - kTile - 1);
      if (jur && !ju) uf_union(local, k, k - kTile + 1);
    }
  };
#pragma unroll
  for (int j = 1; j < kRows; ++j) {
    join_up(band + j, own[j]);
    __syncwarp();
  }
  __syncthreads();
  join_up(band, own[0]);
  __syncthreads();

  // flatten locally by pointer jumping: every node to its grandparent, all
  // at once, in rounds until none moves (a few: the trees are shallow);
  // a racing read sees a parent or a grandparent, both ancestors
  bool moved;
  do {
    moved = false;
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int k = (band + j) * kTile + lane;
      const int p = local[k];
      if (p < 0) continue;
      const int q = local[p];
      if (q != p) {
        local[k] = q;
        moved = true;
      }
    }
  } while (__syncthreads_or(moved));

  // the global parent is the flat index of the local root
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int ly = band + j;
    const int r = local[ly * kTile + lane];
    const int y = y0 + ly;
    if (y < h && x < w) {
      parent[y * w + x] = r < 0 ? -1 : (y0 + r / kTile) * w + x0 + r % kTile;
      if (clear != nullptr) clear[y * w + x] = 0;
    }
  }
}

// Stage 2: 64 threads a tile, 0-31 its top row and 32-63 its left column.
// Each pixel unites with its neighbours in the tiles above (top row: up;
// at 8-conn up-left and up-right) and to the left (left column: left; at
// 8-conn up-left and down-left), except where its predecessor along the
// edge (left pixel on the top row, upper pixel on the left column), which
// joins it inside the tile, has already reached the same pixels or they
// share a tile-local set with one it reached.  Together the two roles
// cover every pair of neighbours in different tiles.
template <bool kSameClass>
__global__ void __launch_bounds__(64)
    uf_tile_edges(const uint8_t* __restrict__ mask, int* parent, int h, int w,
                  int tiles_x, int connectivity) {
  const int y0 = (blockIdx.x / tiles_x) * kTile;
  const int x0 = (blockIdx.x % tiles_x) * kTile;
  const int t = threadIdx.x & 31;
  if (threadIdx.x < 32) {  // top row, neighbours in row y0 - 1
    const int c = x0 + t;
    if (y0 == 0 || c >= w) return;
    const int i = y0 * w + c;
    const uint8_t own = mask[i];
    if (!own) return;
    const int u = i - w;
    const bool ju = uf_joins<kSameClass>(mask[u], own);
    const bool jl = t > 0 && uf_joins<kSameClass>(mask[i - 1], own);
    const bool jul = c > 0 && uf_joins<kSameClass>(mask[u - 1], own);
    if (connectivity == 1) {
      if (ju && !(jl && jul)) uf_union(parent, i, u);
    } else {
      const bool jur = c < w - 1 && uf_joins<kSameClass>(mask[u + 1], own);
      if (ju && !jl) uf_union(parent, i, u);
      if (jul && !(t > 0 && (jl || ju))) uf_union(parent, i, u - 1);
      if (jur && !(ju && t < 31)) uf_union(parent, i, u + 1);
    }
  } else {  // left column, neighbours in column x0 - 1
    const int r = y0 + t;
    if (x0 == 0 || r >= h) return;
    const int i = r * w + x0;
    const uint8_t own = mask[i];
    if (!own) return;
    const bool jleft = uf_joins<kSameClass>(mask[i - 1], own);
    const bool jp = t > 0 && uf_joins<kSameClass>(mask[i - w], own);
    const bool jul = r > 0 && uf_joins<kSameClass>(mask[i - w - 1], own);
    if (connectivity == 1) {
      if (jleft && !(jp && jul)) uf_union(parent, i, i - 1);
    } else {
      const bool jdl = r < h - 1 && uf_joins<kSameClass>(mask[i + w - 1], own);
      if (jleft && !jp) uf_union(parent, i, i - 1);
      if (jul && !(t > 0 && (jp || jleft))) uf_union(parent, i, i - w - 1);
      if (jdl && !(jleft && t < 31)) uf_union(parent, i, i + w - 1);
    }
  }
}

// Stage 2b: 128 threads a tile, a walker from each pixel of its border (top
// and bottom rows, left and right columns; the last ones clamped into a
// ragged tile) to its root.  Started at once at every tile root the edge
// pass linked, the walks' path halving acts as pointer jumping, so the
// chains of tile roots that concurrent unions built collapse in a few
// rounds; each walk then points every node it passed at the root, so the
// per-pixel pass finds most roots in one hop.  `border_flag`, when given,
// gets flag[root] = 1 for each fg pixel on the map's own perimeter (B3).
__global__ void __launch_bounds__(128)
    uf_compress_tiles(int* parent, uint8_t* border_flag, int h, int w,
                      int tiles_x) {
  const int y0 = (blockIdx.x / tiles_x) * kTile;
  const int x0 = (blockIdx.x % tiles_x) * kTile;
  const int t = threadIdx.x & 31;
  const int side = threadIdx.x >> 5;
  const int r = side == 0 ? y0 : side == 1 ? min(y0 + kTile - 1, h - 1) : y0 + t;
  const int c = side == 2 ? x0 : side == 3 ? min(x0 + kTile - 1, w - 1) : x0 + t;
  const bool in = r < h && c < w;
  const int p = in ? uf_load(parent, r * w + c) : -1;
  const bool leader = (threadIdx.x & 31) == __ffs(__match_any_sync(0xffffffffu, p)) - 1;
  const int root = uf_find_warp(parent, p);
  if (p < 0) return;
  for (int x = p; leader && x != root;) {  // the walk's nodes straight to the root
    const int next = uf_load(parent, x);
    atomicMin(parent + x, root);
    x = next;
  }
  if (border_flag != nullptr && (r == 0 || r == h - 1 || c == 0 || c == w - 1)) {
    border_flag[root] = 1;
  }
}

constexpr int kPixelsPerThread = 4;  // of the per-pixel passes, blockDim apart

// The node to walk from in a settled forest for pixel i with parent p: none
// (-1) for background and for a root, which is its own answer.
__device__ __forceinline__ int uf_walk_from(int i, int p) { return p == i ? -1 : p; }

// Stage 3 of B2: every pixel's parent to its root.  Pixels hold tile-local
// roots, so the walk starts one hop up, once per warp and root.  Only this
// thread writes parent[i], so its first load needs no volatile.
__global__ void uf_resolve(int* parent, int n) {
  const int base = blockIdx.x * blockDim.x * kPixelsPerThread + threadIdx.x;
  int p[kPixelsPerThread];
#pragma unroll
  for (int j = 0; j < kPixelsPerThread; ++j) {
    const int i = base + j * blockDim.x;
    p[j] = i < n ? parent[i] : -1;
  }
#pragma unroll
  for (int j = 0; j < kPixelsPerThread; ++j) {
    const int i = base + j * blockDim.x;
    const int r = uf_find_warp<true>(parent, uf_walk_from(i, p[j]));
    if (r >= 0 && r != p[j]) parent[i] = r;
  }
}

inline int pixel_blocks(int n) {
  return (n + kThreads * kPixelsPerThread - 1) / (kThreads * kPixelsPerThread);
}

// Stages 1 and 2 on `stream`: `parent` (h, w) int32 becomes a forest whose
// roots are the components' minimum flat indices, -1 on background, with
// most nodes one hop from their root.  `border_flag`, when given, is an
// (h*w) uint8 array that ends up 1 at the root of every component touching
// the map's perimeter and 0 elsewhere.
template <bool kSameClass = false>
inline void uf_tiles_launch(const uint8_t* mask, int* parent, int h, int w,
                            int connectivity, cudaStream_t stream,
                            uint8_t* border_flag = nullptr) {
  const int tiles_x = (w + kTile - 1) / kTile;
  const int tiles = tiles_x * ((h + kTile - 1) / kTile);
  uf_tile<kSameClass><<<tiles, kTileThreads, 0, stream>>>(mask, parent, border_flag, h, w, tiles_x, connectivity);
  uf_tile_edges<kSameClass><<<tiles, 64, 0, stream>>>(mask, parent, h, w, tiles_x, connectivity);
  uf_compress_tiles<<<tiles, 128, 0, stream>>>(parent, border_flag, h, w, tiles_x);
}

// The tiled labeling: the forest, then every parent flattened to its root.
template <bool kSameClass = false>
inline void label_tiled_launch(const uint8_t* mask, int* labels, int h, int w,
                               int connectivity, cudaStream_t stream) {
  const int n = h * w;
  uf_tiles_launch<kSameClass>(mask, labels, h, w, connectivity, stream);
  uf_resolve<<<pixel_blocks(n), kThreads, 0, stream>>>(labels, n);
}

}  // namespace ecseg
