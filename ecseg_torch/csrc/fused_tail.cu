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
// ncls c2) multiply-adds' worth of FLOPs (3.6 GFLOP at c1/c2 = 64/32, 14.5
// at 128/64) against 0.26 us of input bytes at c1 = 64 (bf16): at the bf16
// tensor-core peak of 989 TFLOP/s a patch needs 3.7 us, at the 67 TFLOP/s of
// float32 FMA on the CUDA cores 54 us.
//
// Design, the simple form first: one block of 256 threads per 16x16 output
// tile of one patch (8x8 where 16x16 needs more shared memory than a block
// has: float32 input at c1 = 128).  The tile's input with a 2-pixel halo (20x20xc1) and
// dec1_1 over a 1-pixel halo (18x18xc2, zero outside the patch, as dec1_2's
// SAME padding reads it) stay in shared memory; dec1_2's 16x16xc2 output
// reuses the input's space; the head, softmax, quantize and argmax run one
// thread per pixel.  The convs are scalar float32 FMAs on the CUDA cores:
// each thread holds 4 pixels x 8 output channels of sums and reads the
// weights through L1 (one 8-channel vector per input channel and tap).  Only
// the labels reach device memory.  Not yet done (a later change): the
// convs on the tensor cores (mma/wgmma on bf16 tiles).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPatch = 256;
constexpr int kPix = 4;               // pixels per thread in the convs
constexpr int kCo = 8;                // output channels per thread
constexpr int kMaxClasses = 16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// 8 consecutive weights as floats (16-byte aligned: c2 % 8 == 0).
__device__ __forceinline__ void load8(const float* p, float* w) {
  float4 a = __ldg(reinterpret_cast<const float4*>(p));
  float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
  w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* w) {
  uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float2 f = __bfloat1622float2(h[k]);
    w[2 * k] = f.x;
    w[2 * k + 1] = f.y;
  }
}

// One 3x3 SAME conv + bias + ReLU over a (side x side) output grid read
// from a ((side + 2) x (side + 2)) source grid, both pixel-major with the
// given pitches (elements).  `inside(q)` says whether output pixel q lies in
// the patch; outside pixels are stored as 0.
template <typename T, typename Inside>
__device__ void conv3x3(const T* src, int src_pitch, int src_side, int cin,
                        const T* __restrict__ wt, const float* __restrict__ bias,
                        int cout, T* dst, int dst_pitch, int side,
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
      const T* wrow = wt + static_cast<long long>(tap) * cin * cout + co0;
      for (int ci = 0; ci < cin; ++ci) {
        float w[kCo];
        load8(wrow + static_cast<long long>(ci) * cout, w);
#pragma unroll
        for (int j = 0; j < kPix; ++j) {
          float xv = to_f(src[off[j] + toff + ci]);
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
        dst[q * dst_pitch + co0 + k] = from_f<T>(in ? v : 0.f);
      }
    }
  }
}

// kTile: the output tile's side, 16 (or 8 where a 16x16 tile's shared
// memory exceeds a block's, as float32 at c1 = 128 does).
template <typename T, int kTile>
__global__ void __launch_bounds__(kThreads)
fused_tail(const T* __restrict__ x, const T* __restrict__ w1,
           const float* __restrict__ b1, const T* __restrict__ w2,
           const float* __restrict__ b2, const T* __restrict__ wh,
           const float* __restrict__ bh, int32_t* __restrict__ out, int c1,
           int c2, int ncls) {
  constexpr int kMid = kTile + 2;  // dec1_1 tile side (1-pixel halo)
  constexpr int kIn = kTile + 4;   // input tile side (2-pixel halo)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int pad = 4 / static_cast<int>(sizeof(T));  // one 32-bit word: no bank conflicts
  const int p1 = c1 + pad, p2 = c2 + pad;
  int a_elems = kIn * kIn * p1;
  if (kTile * kTile * p2 > a_elems) a_elems = kTile * kTile * p2;
  T* xin = reinterpret_cast<T*>(smem_raw);  // later dec1_2's output
  T* mid = xin + a_elems;

  const int n = blockIdx.z;
  const int y0 = blockIdx.y * kTile, x0 = blockIdx.x * kTile;
  const T* xn = x + static_cast<long long>(n) * kPatch * kPatch * c1;

  for (int e = threadIdx.x; e < kIn * kIn * c1; e += kThreads) {
    int p = e / c1, ci = e - p * c1;
    int gy = y0 - 2 + p / kIn, gx = x0 - 2 + p % kIn;
    T v = from_f<T>(0.f);
    if (gy >= 0 && gy < kPatch && gx >= 0 && gx < kPatch)
      v = xn[(static_cast<long long>(gy) * kPatch + gx) * c1 + ci];
    xin[p * p1 + ci] = v;
  }
  __syncthreads();
  conv3x3<T>(xin, p1, kIn, c1, w1, b1, c2, mid, p2, kMid, [&](int q) {
    int gy = y0 - 1 + q / kMid, gx = x0 - 1 + q % kMid;
    return gy >= 0 && gy < kPatch && gx >= 0 && gx < kPatch;
  });
  __syncthreads();
  T* x3 = xin;
  conv3x3<T>(mid, p2, kMid, c2, w2, b2, c2, x3, p2, kTile,
             [](int) { return true; });
  __syncthreads();

  for (int q = threadIdx.x; q < kTile * kTile; q += kThreads) {
    float logit[kMaxClasses];
    for (int k = 0; k < ncls; ++k) logit[k] = 0.f;
    for (int c = 0; c < c2; ++c) {
      float v = to_f(x3[q * p2 + c]);
      for (int k = 0; k < ncls; ++k) logit[k] = fmaf(v, to_f(wh[c * ncls + k]), logit[k]);
    }
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
    int gy = y0 + q / kTile, gx = x0 + q % kTile;
    out[(static_cast<long long>(n) * kPatch + gy) * kPatch + gx] = best;
  }
}

template <typename T, int kTile>
int launch(const void* x, const void* w1, const float* b1, const void* w2,
           const float* b2, const void* wh, const float* bh, int32_t* out,
           int n, int c1, int c2, int ncls, int smem, cudaStream_t s) {
  auto kernel = fused_tail<T, kTile>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(kPatch / kTile, kPatch / kTile, n);
  kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), b1,
      static_cast<const T*>(w2), b2, static_cast<const T*>(wh), bh, out, c1,
      c2, ncls);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (n, 256, 256, c1), w1 (3, 3, c1, c2), w2 (3, 3, c2, c2), wh (c2, ncls):
// all in the input's dtype (`bf16` 1: __nv_bfloat16, 0: float), contiguous;
// biases float32; out (n, 256, 256) int32.  c2 % 8 == 0, ncls <= 16; `tile`
// 16 or 8 and `smem` (its dynamic shared memory) as the wrapper chose them.
extern "C" int ecseg_fused_tail(const void* x, int bf16, const void* w1,
                                const float* b1, const void* w2,
                                const float* b2, const void* wh,
                                const float* bh, int32_t* out, int n, int c1,
                                int c2, int ncls, int tile, int smem,
                                void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return tile == 16 ? launch<__nv_bfloat16, 16>(x, w1, b1, w2, b2, wh, bh, out, n, c1, c2, ncls, smem, s)
                      : launch<__nv_bfloat16, 8>(x, w1, b1, w2, b2, wh, bh, out, n, c1, c2, ncls, smem, s);
  return tile == 16 ? launch<float, 16>(x, w1, b1, w2, b2, wh, bh, out, n, c1, c2, ncls, smem, s)
                    : launch<float, 8>(x, w1, b1, w2, b2, wh, bh, out, n, c1, c2, ncls, smem, s);
}
