// Union-find connected-component labeling shared by kernels B2/B5
// (cc_label.cu) and B3/B4/B6/B9 (cc_flood.cu).
//
// Contract (ecseg_tpu/ops/cc_pallas.py label_pallas): every foreground pixel
// gets the smallest flat index r*W+c of its component, background gets -1;
// connectivity 1 (4-neighbour) or 2 (8-neighbour).  With kSameClass (B5,
// label_multiclass_pallas) the map holds class ids, 0 is background, and
// two neighbours join only when their classes are equal; the choice is a
// template argument, so B2's merge loop carries no extra test.
//
// Three passes over the (H, W) map, one thread per pixel, all state in the
// int32 output itself (the parent array):
//   init     parent[i] = fg ? i : -1
//   merge    each fg pixel unites with its already-scanned fg neighbours
//            (left and up; up-left and up-right for 8-conn)
//   flatten  parent[i] = find(i)
// Linking hangs the larger root under the smaller one with atomicMin and
// retries when another thread got there first (Playne & Hawick 2018;
// Allegretti et al. 2019).  Every write to parent[] is an atomicMin (or, in
// flatten, the root itself), so a parent only ever moves to a smaller index
// of the same component: parent[x] <= x holds throughout, the root of every
// tree is its component's minimum flat index, and the result is canonical
// and identical from run to run whatever order the atomics land in.  finds
// halve the path they walk (also by atomicMin) so chains built by racing
// unions shrink as they are read.

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

}  // namespace ecseg
