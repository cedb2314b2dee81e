// Kernel B11: 3x3 stride-2 'SAME' transpose convolution (TF semantics) with
// bias and ReLU, NHWC input, HWIO kernel, output (N, 2h, 2w, cout) in the
// input's dtype.
//
// Replaces: ecseg_tpu/ops/convt_pallas.py conv2d_transpose_packed (_kernel),
// which packs the four output parities of a 2x2 input window into one
// lane-dense matmul.  Its contract, kept here: out[2i + a, 2j + b] sums,
// over the taps that reach parity (a, b), x[i - 1 + u, j - 1 + v] times the
// kernel tap (pack_weights, convt_pallas.py:59-82); in kernel coordinates
// k[ky][kx] (no flip):
//   (0, 0): x[i][j] k[0][0] + x[i][j-1] k[0][2] + x[i-1][j] k[2][0]
//           + x[i-1][j-1] k[2][2]
//   (0, 1): x[i][j] k[0][1] + x[i-1][j] k[2][1]
//   (1, 0): x[i][j] k[1][0] + x[i][j-1] k[1][2]
//   (1, 1): x[i][j] k[1][1]
// with x = 0 outside the input; sums in float32 from values in the input's
// dtype, then the float32 bias and the ReLU, then one rounding to the
// input's dtype.  The TPU's packed lane layout is not carried over.
//
// Bound on an H100: operations.  9 multiply-adds per 2x2 output quad, per
// input and output channel: 2 * N * h * w * cin * cout * 9 FLOPs (241 GFLOP
// at the XL up1 level for 100 patches: 0.24 ms at the bf16 tensor-core peak
// of 989 TFLOP/s) against N*h*w*cin + 4*N*h*w*cout elements of traffic.
//
// Design, the simple form first: one thread per input pixel (i, j) and 4
// output channels computes the 2x2 output quad (16 float32 sums) with
// scalar FMAs on the CUDA cores.  Per input channel it reads the 4 window
// values (shared by the threads of the same pixel, served by L1) and the 9
// taps' 4-channel weight vectors (one 8- or 16-byte load each, coalesced
// across the pixel's threads).  Not yet done (a later change): the
// per-parity products on the tensor cores.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// 4 consecutive weights as floats (aligned: cout % 4 == 0).
__device__ __forceinline__ void load4(const float* p, float* w) {
  float4 a = __ldg(reinterpret_cast<const float4*>(p));
  w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* w) {
  uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  w[0] = a.x; w[1] = a.y; w[2] = b.x; w[3] = b.y;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
convt_quad(const T* __restrict__ x, const T* __restrict__ k,
           const float* __restrict__ bias, T* __restrict__ out, int n, int h,
           int w, int cin, int cout) {
  const int groups = cout / 4;
  long long idx = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= static_cast<long long>(n) * h * w * groups) return;
  const int g = static_cast<int>(idx % groups);
  long long pix = idx / groups;
  const int j = static_cast<int>(pix % w);
  const int i = static_cast<int>((pix / w) % h);
  const long long b = pix / (static_cast<long long>(w) * h);
  const int c0 = 4 * g;
  const bool up = i > 0, left = j > 0;
  const T* x11 = x + ((b * h + i) * w + j) * cin;  // x[i][j]
  const long long row = static_cast<long long>(w) * cin;

  // acc[parity a * 2 + b][channel]
  float acc[4][4];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[p][c] = 0.f;
  for (int ci = 0; ci < cin; ++ci) {
    const float v11 = to_f(x11[ci]);
    const float v10 = left ? to_f(x11[ci - cin]) : 0.f;        // x[i][j-1]
    const float v01 = up ? to_f(x11[ci - row]) : 0.f;          // x[i-1][j]
    const float v00 = up && left ? to_f(x11[ci - row - cin]) : 0.f;  // x[i-1][j-1]
    float kw[9][4];
#pragma unroll
    for (int tap = 0; tap < 9; ++tap)
      load4(k + (static_cast<long long>(tap) * cin + ci) * cout + c0, kw[tap]);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      // kw[ky * 3 + kx]
      acc[0][c] = fmaf(v11, kw[0][c], acc[0][c]);
      acc[0][c] = fmaf(v10, kw[2][c], acc[0][c]);
      acc[0][c] = fmaf(v01, kw[6][c], acc[0][c]);
      acc[0][c] = fmaf(v00, kw[8][c], acc[0][c]);
      acc[1][c] = fmaf(v11, kw[1][c], acc[1][c]);
      acc[1][c] = fmaf(v01, kw[7][c], acc[1][c]);
      acc[2][c] = fmaf(v11, kw[3][c], acc[2][c]);
      acc[2][c] = fmaf(v10, kw[5][c], acc[2][c]);
      acc[3][c] = fmaf(v11, kw[4][c], acc[3][c]);
    }
  }
  const int wo = 2 * w;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int oy = 2 * i + (p >> 1), ox = 2 * j + (p & 1);
    T* o = out + ((b * 2 * h + oy) * wo + ox) * cout + c0;
#pragma unroll
    for (int c = 0; c < 4; ++c) store(o + c, fmaxf(acc[p][c] + bias[c0 + c], 0.f));
  }
}

template <typename T>
int launch(const void* x, const void* k, const float* bias, void* out, int n,
           int h, int w, int cin, int cout, cudaStream_t s) {
  long long threads = static_cast<long long>(n) * h * w * (cout / 4);
  long long blocks = (threads + kThreads - 1) / kThreads;
  convt_quad<T><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(k), bias,
      static_cast<T*>(out), n, h, w, cin, cout);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (n, h, w, cin), k (3, 3, cin, cout), out (n, 2h, 2w, cout): contiguous,
// in the input's dtype (`bf16` 1: __nv_bfloat16, 0: float); bias float32
// (cout), zeros for none.  cout % 4 == 0.
extern "C" int ecseg_convt(const void* x, int bf16, const void* k,
                           const float* bias, void* out, int n, int h, int w,
                           int cin, int cout, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (bf16) return launch<__nv_bfloat16>(x, k, bias, out, n, h, w, cin, cout, s);
  return launch<float>(x, k, bias, out, n, h, w, cin, cout, s);
}
