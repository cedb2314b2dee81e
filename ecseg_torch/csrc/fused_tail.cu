// Kernel B10: the level-1 decoder tail of the metaseg U-Net fused per
// 256x256 patch: dec1_1 (3x3 SAME conv + bias + ReLU) -> dec1_2 (the same)
// -> 1x1 head -> softmax -> exact uint8 quantize -> argmax, NHWC in, int32
// class labels out.
//
// Replaces: ecseg_tpu/ops/fused_tail.py fused_dec1_head (_tail_kernel).
// Numerics follow it: each conv sums in float32 from inputs and weights in
// the input's dtype (bf16 or float32), adds the float32 bias, applies the
// ReLU and rounds the result to the input's dtype; the head sums in float32
// and adds a float32 bias; the softmax subtracts the max and divides (IEEE
// expf and division: this file must be compiled without --use_fast_math);
// the quantize is rint(p * 255) of the exact float64 product (round half to
// even, as np.rint), and the argmax takes the first maximum.  The TPU
// kernel's padding of every channel dimension to 128 lanes is not carried
// over: its padded classes (bias -inf) never win.
//
// Bound on an H100: operations.  Per patch 2 * 256^2 * (9 c1 c2 + 9 c2^2 +
// ncls c2) FLOPs (3.6 GFLOP at c1/c2 = 64/32, 14.5 at 128/64) against
// 0.26 us of input bytes at c1 = 64 (bf16): at the bf16 tensor-core peak of
// 989 TFLOP/s a patch needs 3.7 us.
//
// Two forms, chosen by the input's dtype:
//
// bf16 (fused_tail_mma, the tile-count path's form): both convs are
// implicit GEMMs on the tensor cores (wgmma.mma_async m64nNk16, N = c2's
// n-group of up to 64 channels: A, the pixels' channels, from registers
// loaded by ldmatrix; B, the weights, from shared memory by descriptor;
// float32 sums in registers).  A persistent grid (as many blocks as fit on
// the SMs: two at the default widths, one at XL) walks the 16x16 output
// tiles of all patches (8x8 or 4x4 where 16x16 does not fit shared
// memory).  Per
// tile the block holds the input with a 2-pixel halo (20x20 x c1p, zero
// outside the patch and in the channels past c1), dec1_1 over a 1-pixel
// halo (18x18 x c2p, 0 outside the patch, as dec1_2's SAME padding reads
// it) and dec1_2's output (16x16 x c2p).  GEMM rows are pixels (a warp's
// 16 rows are 16 consecutive pixels of the tile, one tap's shift applied
// to the ldmatrix row addresses; the two warpgroups of a block take m64
// tiles in turn), columns output channels, K is (tap, input channel).  The
// weights, prepacked by the wrapper into wgmma's canonical layout, stream
// through a two-stage shared ring by cp.async, one step (up to 128
// channels of K: one tap of dec1_1, two of dec1_2 at both widths) at a
// time; the next tile's input is copied in slices during dec1_2's steps,
// when the input tile is dead, so the HBM stream overlaps the MMAs.
// dec1_1 recomputes its 1-pixel halo (324 rows for 256 outputs, 384 with
// the last m64 tile's padding).  The head, softmax, quantize and argmax
// run one thread per pixel on the CUDA cores (0.5 % of the FLOPs); only
// the labels reach device memory.
//
// float32 (tests and exact integer checks; tensor cores would take float32
// only as TF32): fused_tail_f32, scalar FMAs on the CUDA cores, one block
// of 256 threads per output tile, each thread 4 pixels x 8 output channels
// of sums, weights read through L1; 8x8 tiles at c1 = 128.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPatch = 256;
constexpr int kPix = 4;               // pixels per thread in the float32 convs
constexpr int kCo = 8;                // output channels per thread there
constexpr int kMaxClasses = 16;

// 8 consecutive weights as floats (16-byte aligned: c2 % 8 == 0).
__device__ __forceinline__ void load8(const float* p, float* w) {
  float4 a = __ldg(reinterpret_cast<const float4*>(p));
  float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
  w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
}

// The softmax, quantize and argmax of one pixel's head sums (the bias not
// yet added); returns the class.
__device__ int classify(float (&logit)[kMaxClasses], const float* __restrict__ bh, int ncls) {
  float m = __int_as_float(0xff800000);  // -inf
  for (int k = 0; k < ncls; ++k) {
    logit[k] += bh[k];
    m = fmaxf(m, logit[k]);
  }
  float s = 0.f;
  for (int k = 0; k < ncls; ++k) {
    logit[k] = expf(logit[k] - m);
    s += logit[k];
  }
  int best = 0;
  double best_q = -1.0;
  for (int k = 0; k < ncls; ++k) {
    double qk = rint(static_cast<double>(logit[k] / s) * 255.0);
    if (qk > best_q) {
      best_q = qk;
      best = k;
    }
  }
  return best;
}

// ---------------------------------------------------------------- float32

// One 3x3 SAME conv + bias + ReLU over a (side x side) output grid read
// from a ((side + 2) x (side + 2)) source grid, both pixel-major with the
// given pitches (elements).  `inside(q)` says whether output pixel q lies in
// the patch; outside pixels are stored as 0.
template <typename Inside>
__device__ void conv3x3_f32(const float* src, int src_pitch, int src_side, int cin,
                            const float* __restrict__ wt, const float* __restrict__ bias,
                            int cout, float* dst, int dst_pitch, int side,
                            Inside inside) {
  const int groups = cout / kCo;
  const int chunks = side * side / kPix;
  for (int item = threadIdx.x; item < chunks * groups; item += kThreads) {
    const int chunk = item / groups;
    const int co0 = (item - chunk * groups) * kCo;
    int off[kPix];
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
      int q = chunk * kPix + j;
      int qy = q / side, qx = q - qy * side;
      off[j] = (qy * src_side + qx) * src_pitch;
    }
    float acc[kPix][kCo];
#pragma unroll
    for (int j = 0; j < kPix; ++j)
#pragma unroll
      for (int k = 0; k < kCo; ++k) acc[j][k] = 0.f;
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3, kx = tap - 3 * (tap / 3);
      const int toff = (ky * src_side + kx) * src_pitch;
      const float* wrow = wt + static_cast<long long>(tap) * cin * cout + co0;
      for (int ci = 0; ci < cin; ++ci) {
        float w[kCo];
        load8(wrow + static_cast<long long>(ci) * cout, w);
#pragma unroll
        for (int j = 0; j < kPix; ++j) {
          float xv = src[off[j] + toff + ci];
#pragma unroll
          for (int k = 0; k < kCo; ++k) acc[j][k] = fmaf(xv, w[k], acc[j][k]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
      int q = chunk * kPix + j;
      bool in = inside(q);
#pragma unroll
      for (int k = 0; k < kCo; ++k) {
        float v = fmaxf(acc[j][k] + bias[co0 + k], 0.f);
        dst[q * dst_pitch + co0 + k] = in ? v : 0.f;
      }
    }
  }
}

// kTile: the output tile's side, 16 (or 8 where a 16x16 tile's shared
// memory exceeds a block's, as at c1 = 128).
template <int kTile>
__global__ void __launch_bounds__(kThreads)
fused_tail_f32(const float* __restrict__ x, const float* __restrict__ w1,
               const float* __restrict__ b1, const float* __restrict__ w2,
               const float* __restrict__ b2, const float* __restrict__ wh,
               const float* __restrict__ bh, int32_t* __restrict__ out, int c1,
               int c2, int ncls) {
  constexpr int kMid = kTile + 2;  // dec1_1 tile side (1-pixel halo)
  constexpr int kIn = kTile + 4;   // input tile side (2-pixel halo)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int p1 = c1 + 1, p2 = c2 + 1;  // one word of padding: no bank conflicts
  int a_elems = kIn * kIn * p1;
  if (kTile * kTile * p2 > a_elems) a_elems = kTile * kTile * p2;
  float* xin = reinterpret_cast<float*>(smem_raw);  // later dec1_2's output
  float* mid = xin + a_elems;

  const int n = blockIdx.z;
  const int y0 = blockIdx.y * kTile, x0 = blockIdx.x * kTile;
  const float* xn = x + static_cast<long long>(n) * kPatch * kPatch * c1;

  for (int e = threadIdx.x; e < kIn * kIn * c1; e += kThreads) {
    int p = e / c1, ci = e - p * c1;
    int gy = y0 - 2 + p / kIn, gx = x0 - 2 + p % kIn;
    float v = 0.f;
    if (gy >= 0 && gy < kPatch && gx >= 0 && gx < kPatch)
      v = xn[(static_cast<long long>(gy) * kPatch + gx) * c1 + ci];
    xin[p * p1 + ci] = v;
  }
  __syncthreads();
  conv3x3_f32(xin, p1, kIn, c1, w1, b1, c2, mid, p2, kMid, [&](int q) {
    int gy = y0 - 1 + q / kMid, gx = x0 - 1 + q % kMid;
    return gy >= 0 && gy < kPatch && gx >= 0 && gx < kPatch;
  });
  __syncthreads();
  float* x3 = xin;
  conv3x3_f32(mid, p2, kMid, c2, w2, b2, c2, x3, p2, kTile,
              [](int) { return true; });
  __syncthreads();

  for (int q = threadIdx.x; q < kTile * kTile; q += kThreads) {
    float logit[kMaxClasses];
    for (int k = 0; k < ncls; ++k) logit[k] = 0.f;
    for (int c = 0; c < c2; ++c) {
      float v = x3[q * p2 + c];
      for (int k = 0; k < ncls; ++k) logit[k] = fmaf(v, wh[c * ncls + k], logit[k]);
    }
    int gy = y0 + q / kTile, gx = x0 + q % kTile;
    out[(static_cast<long long>(n) * kPatch + gy) * kPatch + gx] = classify(logit, bh, ncls);
  }
}

template <int kTile>
int launch_f32(const void* x, const void* w1, const float* b1, const void* w2,
               const float* b2, const void* wh, const float* bh, int32_t* out,
               int n, int c1, int c2, int ncls, int smem, cudaStream_t s) {
  auto kernel = fused_tail_f32<kTile>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(kPatch / kTile, kPatch / kTile, n);
  kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(w1), b1,
      static_cast<const float*>(w2), b2, static_cast<const float*>(wh), bh,
      out, c1, c2, ncls);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------------- bf16

// The channel plan the wrapper computed (ops/fused_tail.mma_plan): c1p,
// c2p the padded channel counts (multiples of 16; c2p of nc), nc the
// output channels of one n-group (16..64, kNT = nc / 8 n-tiles).  A conv's
// K runs over units of (tap, kc input channels), tap-major; a weight step
// is u consecutive units (the last step of an n-group may have fewer), at
// most max(kc1, kc2) channels, so dec1_2's steps span several taps.  vec:
// x's rows are 16-byte aligned (c1 % 8 == 0), so the input tile is staged
// by cp.async.
struct Plan {
  int c1, c1p, c2p, kc1, kc2, u1, u2, ncls, vec;
};

// One conv's steps: `units` (tap, k-chunk) units of `kc` channels, `per`
// steps of up to `u` units for each n-group, `full` bf16 elements in a
// step of u units, `group` in an n-group's steps.
struct Steps {
  int kc, kch, units, u, per, full, group;
  __device__ Steps(int cp, int kc_, int u_, int nc) : kc(kc_), kch(cp / kc_), units(9 * (cp / kc_)), u(u_) {
    per = (units + u - 1) / u;
    full = nc * u * kc;
    group = (per - 1) * full + nc * (units - (per - 1) * u) * kc;
  }
  __device__ int n_units(int j) const { return j == per - 1 ? units - (per - 1) * u : u; }
};

// A block's 8 warps are 2 warpgroups; the GEMM rows are cut into m64
// tiles, tile id = warpgroup + 2 r for the warpgroup's r-th tile, and warp
// i of the warpgroup holds rows 16 i..16 i + 15 of each of its tiles.
template <int kTile, int kNT>
struct Tail {
  static constexpr int kMid = kTile + 2, kIn = kTile + 4;
  static constexpr int kM1 = kMid * kMid, kM2 = kTile * kTile;  // GEMM rows
  static constexpr int kTiles1 = (kM1 + 63) / 64, kTiles2 = (kM2 + 63) / 64;
  static constexpr int kMT1 = (kTiles1 + 1) / 2, kMT2 = (kTiles2 + 1) / 2;  // m64 tiles per warpgroup
  static constexpr int kNc = 8 * kNT;
};

// Copy input units [u0, u1) of tile (patch, y0, x0) into xin: unit u is 8
// channels of one pixel of the 2-pixel-halo tile, zero outside the patch
// and past c1.
template <int kIn>
__device__ __forceinline__ void stage_input(bf16* xin, const bf16* __restrict__ x,
                                            const Plan& p, long long patch, int y0,
                                            int x0, int u0, int u1) {
  const int per_px = p.c1p / 8, p1 = p.c1p + 8;
  const bf16* xn = x + patch * kPatch * kPatch * p.c1;
  for (int u = u0 + static_cast<int>(threadIdx.x); u < u1; u += kThreads) {
    const int px = u / per_px, c8 = (u - px * per_px) * 8;
    const int gy = y0 - 2 + px / kIn, gx = x0 - 2 + px % kIn;
    const bool in = gy >= 0 && gy < kPatch && gx >= 0 && gx < kPatch;
    bf16* dst = xin + px * p1 + c8;
    const bf16* src = xn + (static_cast<long long>(gy) * kPatch + gx) * p.c1 + c8;
    if (p.vec) {
      const bool ok = in && c8 < p.c1;
      mma::cp_async16(dst, ok ? src : x, ok ? 16 : 0);
    } else {
      for (int e = 0; e < 8; ++e)
        dst[e] = in && c8 + e < p.c1 ? src[e] : __float2bfloat16_rn(0.f);
    }
  }
}

__device__ __forceinline__ void stage_weights(bf16* dst, const bf16* __restrict__ src, int elems) {
  for (int u = threadIdx.x; u < elems / 8; u += kThreads) mma::cp_async16(dst + 8 * u, src + 8 * u, 16);
}

// One unit of K (one tap, kss k16 slices) on the tensor cores:
// acc[r] += A_r * B for each of the warpgroup's m64 tiles (a tile past the
// GEMM's rows computes its clamped last row, which the epilogue drops: a
// wgmma under a branch the compiler cannot prove warp-uniform serializes
// every wgmma of the kernel).  A's slice
// i: this lane's ldmatrix row at shared address a + rows[r] + 32 i; B's:
// the step's weights in the canonical layout from shared address b, the
// slice's two 8-channel core-matrix rows at b + 2 i lbo and b + (2 i + 1)
// lbo, successive groups of 8 output channels 128 bytes apart.  Each
// slice's A fragments load into one of two register sets while the other
// slice's wgmma group may still run (kKss > 0: kss fixed at compile time;
// 0: any kss, one set, each group awaited).  Returns with every wgmma of
// the unit complete.
template <int kKss, int kMT, int kNT>
__device__ __forceinline__ void conv_unit(float (&acc)[kMT][kNT][4], uint32_t a, const int (&rows)[kMT],
                                          uint32_t b, uint32_t lbo, int kss) {
  if (kKss > 0) {
    uint32_t af[2][kMT][4];
#pragma unroll
    for (int i = 0; i < kKss; ++i) {
#pragma unroll
      for (int r = 0; r < kMT; ++r) mma::ldmatrix_x4(af[i & 1][r], a + rows[r] + 32 * i);
      mma::wgmma_fence();
      const uint64_t desc = mma::wgmma_desc(b + 2 * i * lbo, lbo, 128);
#pragma unroll
      for (int r = 0; r < kMT; ++r) mma::wgmma_m64k16<8 * kNT>(&acc[r][0][0], af[i & 1][r], desc);
      mma::wgmma_commit();
      mma::wgmma_wait<1>();  // slice i - 1's group is done: its A set may be reloaded
      if (i > 0)
#pragma unroll
        for (int r = 0; r < kMT; ++r) mma::keep(af[(i - 1) & 1][r]);
    }
    mma::wgmma_wait<0>();
#pragma unroll
    for (int r = 0; r < kMT; ++r) mma::keep(af[(kKss - 1) & 1][r]);
    return;
  }
  for (int i = 0; i < kss; ++i) {
    uint32_t af[kMT][4];
#pragma unroll
    for (int r = 0; r < kMT; ++r) mma::ldmatrix_x4(af[r], a + rows[r] + 32 * i);
    mma::wgmma_fence();
    const uint64_t desc = mma::wgmma_desc(b + 2 * i * lbo, lbo, 128);
#pragma unroll
    for (int r = 0; r < kMT; ++r) mma::wgmma_m64k16<8 * kNT>(&acc[r][0][0], af[r], desc);
    mma::wgmma_commit();
    mma::wgmma_wait<0>();
#pragma unroll
    for (int r = 0; r < kMT; ++r) mma::keep(af[r]);
  }
}

// One weight step of a 3x3 conv from `src` (a grid of `side` pixels a
// row, `pitch` bf16 a pixel): the units u0..u0+nu-1 of K, unit u being tap
// u / kch's input channels kc (u % kch)..+kc; the step's weights, (n, k)
// with k = (u - u0) kc + channel, at `ws` in the canonical layout (core
// matrix (k / 8, n / 8) at ((k / 8) * kNT + n / 8) * 128 bytes).  `rows[r]`
// is this lane's row of the warpgroup's m64 tile r as a byte offset in
// `src`.  Returns with every wgmma of the step complete, so that the next
// step may refill the stage.
template <int kMT, int kNT>
__device__ __forceinline__ void conv_step(float (&acc)[kMT][kNT][4], const bf16* src, int side,
                                          int pitch, const int (&rows)[kMT], const bf16* ws,
                                          int u0, int nu, int kch, int kc) {
  const int lane = threadIdx.x & 31;
  const uint32_t sa = mma::smem_addr(src) + (lane >> 4) * 16;
  const uint32_t lbo = kNT * 128;  // bytes between the core-matrix rows of 8 k
  const uint32_t sb = mma::smem_addr(ws);
  const int kss = kc / 16;
  for (int v = 0; v < nu; ++v) {
    const int u = u0 + v, tap = u / kch, ch = (u - tap * kch) * kc;
    const uint32_t a = sa + ((tap / 3 * side + tap % 3) * pitch + ch) * 2, b = sb + v * kss * 2 * lbo;
    switch (kss) {
      case 2: conv_unit<2>(acc, a, rows, b, lbo, kss); break;
      case 4: conv_unit<4>(acc, a, rows, b, lbo, kss); break;
      case 8: conv_unit<8>(acc, a, rows, b, lbo, kss); break;
      default: conv_unit<0>(acc, a, rows, b, lbo, kss);
    }
  }
#pragma unroll
  for (int r = 0; r < kMT; ++r)
#pragma unroll
    for (int j = 0; j < kNT; ++j) mma::keep(acc[r][j]);
}

// Bias + ReLU + bf16 round of the sums of one n-group (first channel n0)
// into `dst` (pitch p2); rows past `rows_total` are dropped and rows for
// which inside(q) is false are stored as 0.  Resets the sums.
template <int kMT, int kNT, typename Inside>
__device__ __forceinline__ void conv_epilogue(float (&acc)[kMT][kNT][4], bf16* dst, int p2,
                                              const float* __restrict__ bias, int n0,
                                              int rows_total, Inside inside) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < kMT; ++r) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = ((warp >> 2) + 2 * r) * 64 + (warp & 3) * 16 + g + 8 * h;
      const bool keep = q < rows_total, in = keep && inside(q);
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int n = n0 + j * 8 + 2 * t;
        if (keep)
          *reinterpret_cast<uint32_t*>(dst + q * p2 + n) =
              in ? mma::relu_bf16x2(acc[r][j][2 * h] + bias[n], acc[r][j][2 * h + 1] + bias[n + 1]) : 0u;
        acc[r][j][2 * h] = acc[r][j][2 * h + 1] = 0.f;
      }
    }
  }
}

// The head of one pixel from its dec1_2 output `v` (c2p bf16 channels,
// 16-byte aligned) and the head weights `wht` (ceil(ncls / 4) * 4, c2p)
// float32 (bf16 values, zero rows past ncls), four classes at a time, each
// sum over the channels in ascending order; then classify.
__device__ int head_bf16(const bf16* v, const float* __restrict__ wht,
                         const float* __restrict__ bh, int c2p, int ncls) {
  float logit[kMaxClasses];
  for (int k0 = 0; k0 < ncls; k0 += 4) {
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    for (int c = 0; c < c2p; c += 8) {
      const uint4 u = *reinterpret_cast<const uint4*>(v + c);
      const __nv_bfloat162* hv = reinterpret_cast<const __nv_bfloat162*>(&u);
      float xv[8];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(hv[e]);
        xv[2 * e] = f.x;
        xv[2 * e + 1] = f.y;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4* w4 = reinterpret_cast<const float4*>(wht + (k0 + kk) * c2p + c);
        const float4 wa = __ldg(w4), wb = __ldg(w4 + 1);
        const float w[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
        for (int e = 0; e < 8; ++e) s[kk] = fmaf(xv[e], w[e], s[kk]);
      }
    }
    for (int kk = 0; kk < 4 && k0 + kk < ncls; ++kk) logit[k0 + kk] = s[kk];
  }
  return classify(logit, bh, ncls);
}

template <int kTile, int kNT>
__global__ void __launch_bounds__(kThreads, kNT <= 4 ? 2 : 1)
fused_tail_mma(const bf16* __restrict__ x, const bf16* __restrict__ wpk,
               const float* __restrict__ b1, const float* __restrict__ b2,
               const float* __restrict__ wht, const float* __restrict__ bh,
               int32_t* __restrict__ out, int n, Plan p) {
  using S = Tail<kTile, kNT>;
  constexpr int kMid = S::kMid, kIn = S::kIn, kNc = S::kNc;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int p1 = p.c1p + 8, p2 = p.c2p + 8;
  const Steps st1(p.c1p, p.kc1, p.u1, kNc), st2(p.c2p, p.kc2, p.u2, kNc);
  const int wstage = st1.full > st2.full ? st1.full : st2.full;  // elements of a ring stage
  bf16* xin = reinterpret_cast<bf16*>(smem_raw);
  bf16* mid = xin + kIn * kIn * p1;
  bf16* o2 = mid + kMid * kMid * p2;
  bf16* wst = reinterpret_cast<bf16*>((reinterpret_cast<uintptr_t>(o2 + kTile * kTile * p2) + 127) & ~uintptr_t{127});

  const int groups = p.c2p / kNc;
  const int steps1 = groups * st1.per, steps = steps1 + groups * st2.per;
  const int units = kIn * kIn * (p.c1p / 8);  // input tile, 16-byte units
  const int slices = groups * st2.per;         // input slices, one per dec1_2 step
  // step s of the whole sequence: its weights in wpk and their element count
  auto step_src = [&](int s, int& elems) {
    const Steps& st = s < steps1 ? st1 : st2;
    const int r = s < steps1 ? s : s - steps1, g = r / st.per, j = r - g * st.per;
    elems = kNc * st.n_units(j) * st.kc;
    return wpk + (s < steps1 ? 0LL : static_cast<long long>(groups) * st1.group) +
           static_cast<long long>(g) * st.group + static_cast<long long>(j) * st.full;
  };

  constexpr int kTilesPerRow = kPatch / kTile, kTilesPerPatch = kTilesPerRow * kTilesPerRow;
  const long long tiles = static_cast<long long>(n) * kTilesPerPatch;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // this lane's ldmatrix row of each of the warpgroup's m64 tiles, as a
  // byte offset of its pixel in the source grid (rows past the GEMM read
  // its last row)
  const int wg = warp >> 2, row16 = (warp & 3) * 16 + (lane & 15);
  int rows1[S::kMT1], rows2[S::kMT2];
#pragma unroll
  for (int r = 0; r < S::kMT1; ++r) {
    int q = (wg + 2 * r) * 64 + row16;
    q = q < S::kM1 ? q : S::kM1 - 1;
    rows1[r] = (q / kMid * kIn + q % kMid) * p1 * 2;
  }
#pragma unroll
  for (int r = 0; r < S::kMT2; ++r) {
    int q = (wg + 2 * r) * 64 + row16;
    q = q < S::kM2 ? q : S::kM2 - 1;
    rows2[r] = (q / kTile * kMid + q % kTile) * p2 * 2;
  }

  auto origin = [&](long long t, long long& patch, int& y0, int& x0) {
    patch = t / kTilesPerPatch;
    const int w = static_cast<int>(t - patch * kTilesPerPatch);
    y0 = w / kTilesPerRow * kTile;
    x0 = w % kTilesPerRow * kTile;
  };

  long long t = blockIdx.x, patch;
  int y0, x0, elems;
  origin(t, patch, y0, x0);
  stage_input<kIn>(xin, x, p, patch, y0, x0, 0, units);
  const bf16* w0 = step_src(0, elems);
  stage_weights(wst, w0, elems);
  mma::cp_async_commit();
  int stage = 0;
  for (; t < tiles; t += gridDim.x) {
    const long long tn = t + gridDim.x;
    const bool more = tn < tiles;
    long long npatch = 0;
    int ny0 = 0, nx0 = 0;
    if (more) origin(tn, npatch, ny0, nx0);
    // Wait for step s's weights (at s = 0 for the whole input tile too),
    // let every warp finish step s-1, start the copy of step s+1 (the next
    // tile's step 0 after the last) into the other stage, then, during
    // dec1_2 (the input tile is dead), one slice of the next tile's input
    // as a group of its own, which the next step does not wait for; returns
    // step s's stage.
    auto begin_step = [&](int s) {
      if (s == 0)
        mma::cp_async_wait<0>();
      else
        mma::cp_async_wait<1>();
      mma::fence_proxy_async();  // the weights are read by wgmma
      __syncthreads();
      if (s + 1 < steps || more) {
        int ne;
        const bf16* src = step_src(s + 1 < steps ? s + 1 : 0, ne);
        stage_weights(wst + (stage ^ 1) * wstage, src, ne);
      }
      mma::cp_async_commit();
      if (s >= steps1 && more) {
        const int k = s - steps1;
        stage_input<kIn>(xin, x, p, npatch, ny0, nx0, k * units / slices, (k + 1) * units / slices);
      }
      mma::cp_async_commit();
      const bf16* ws = wst + stage * wstage;
      stage ^= 1;
      return ws;
    };
    {  // dec1_1: input tile -> mid
      float acc[S::kMT1][kNT][4] = {};
      for (int s = 0; s < steps1; ++s) {
        const bf16* ws = begin_step(s);
        const int g = s / st1.per, j = s - g * st1.per;
        conv_step(acc, xin, kIn, p1, rows1, ws, j * st1.u, st1.n_units(j), st1.kch, st1.kc);
        if (j == st1.per - 1)
          conv_epilogue(acc, mid, p2, b1, g * kNc, S::kM1, [&](int q) {
            const int gy = y0 - 1 + q / kMid, gx = x0 - 1 + q % kMid;
            return gy >= 0 && gy < kPatch && gx >= 0 && gx < kPatch;
          });
      }
    }
    {  // dec1_2: mid -> o2
      float acc[S::kMT2][kNT][4] = {};
      for (int s = steps1; s < steps; ++s) {
        const bf16* ws = begin_step(s);
        const int g = (s - steps1) / st2.per, j = s - steps1 - g * st2.per;
        conv_step(acc, mid, kMid, p2, rows2, ws, j * st2.u, st2.n_units(j), st2.kch, st2.kc);
        if (j == st2.per - 1) conv_epilogue(acc, o2, p2, b2, g * kNc, S::kM2, [](int) { return true; });
      }
    }
    __syncthreads();  // dec1_2's output complete
    for (int q = threadIdx.x; q < kTile * kTile; q += kThreads) {
      const int gy = y0 + q / kTile, gx = x0 + q % kTile;
      out[(patch * kPatch + gy) * kPatch + gx] = head_bf16(o2 + q * p2, wht, bh, p.c2p, p.ncls);
    }
    patch = npatch;
    y0 = ny0;
    x0 = nx0;
  }
  mma::cp_async_wait<0>();
}

template <int kTile, int kNT>
int launch_mma(const void* x, const void* wpk, const float* b1, const float* b2,
               const void* wh, const float* bh, int32_t* out, int n,
               const Plan& p, int smem, cudaStream_t s) {
  auto kernel = fused_tail_mma<kTile, kNT>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(e);
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(e);
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem)) != cudaSuccess)
    return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long tiles = static_cast<long long>(n) * (kPatch / kTile) * (kPatch / kTile);
  const long long blocks = tiles < static_cast<long long>(sms) * per_sm ? tiles : static_cast<long long>(sms) * per_sm;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wpk), b1, b2,
      static_cast<const float*>(wh), bh, out, n, p);
  return static_cast<int>(cudaGetLastError());
}

template <int kTile>
int launch_mma_nt(int nt, const void* x, const void* wpk, const float* b1,
                  const float* b2, const void* wh, const float* bh,
                  int32_t* out, int n, const Plan& p, int smem, cudaStream_t s) {
  switch (nt) {
    case 2: return launch_mma<kTile, 2>(x, wpk, b1, b2, wh, bh, out, n, p, smem, s);
    case 4: return launch_mma<kTile, 4>(x, wpk, b1, b2, wh, bh, out, n, p, smem, s);
    case 6: return launch_mma<kTile, 6>(x, wpk, b1, b2, wh, bh, out, n, p, smem, s);
    case 8: return launch_mma<kTile, 8>(x, wpk, b1, b2, wh, bh, out, n, p, smem, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// float32: x (n, 256, 256, c1), w1 (3, 3, c1, c2), w2 (3, 3, c2, c2), wh
// (c2, ncls), biases, all float32 and contiguous; out (n, 256, 256) int32.
// c2 % 8 == 0, ncls <= 16; `tile` 16 or 8 and `smem` (its dynamic shared
// memory) as the wrapper chose them.
extern "C" int ecseg_fused_tail(const void* x, const void* w1, const float* b1,
                                const void* w2, const float* b2, const void* wh,
                                const float* bh, int32_t* out, int n, int c1,
                                int c2, int ncls, int tile, int smem,
                                void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return tile == 16 ? launch_f32<16>(x, w1, b1, w2, b2, wh, bh, out, n, c1, c2, ncls, smem, s)
                    : launch_f32<8>(x, w1, b1, w2, b2, wh, bh, out, n, c1, c2, ncls, smem, s);
}

// bf16: x (n, 256, 256, c1) contiguous; wpk the dec1_1 then dec1_2 weight
// steps packed by ops/fused_tail.pack_mma_weights (bf16); b1, b2 float32
// (c2p); wh the head weights (ceil(ncls / 4) * 4, c2p) float32 of bf16 values,
// zero past ncls and c2; bh float32 (ncls); out (n, 256, 256) int32.
// The plan (c1p, c2p, nc, kc1, kc2, u1, u2), `tile` (16, 8 or 4) and `smem` as
// ops/fused_tail.mma_plan chose them; `vec` 1 when x's rows are 16-byte
// aligned.
extern "C" int ecseg_fused_tail_mma(const void* x, const void* wpk, const float* b1,
                                    const float* b2, const void* wh,
                                    const float* bh, int32_t* out, int n, int c1,
                                    int c1p, int c2p, int nc, int kc1, int kc2,
                                    int u1, int u2, int ncls, int vec, int tile, int smem,
                                    void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const Plan p{c1, c1p, c2p, kc1, kc2, u1, u2, ncls, vec};
  switch (tile) {
    case 16: return launch_mma_nt<16>(nc / 8, x, wpk, b1, b2, wh, bh, out, n, p, smem, s);
    case 8: return launch_mma_nt<8>(nc / 8, x, wpk, b1, b2, wh, bh, out, n, p, smem, s);
    case 4: return launch_mma_nt<4>(nc / 8, x, wpk, b1, b2, wh, bh, out, n, p, smem, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
