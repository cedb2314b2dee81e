// The float32 3x3 stride-1 'SAME' convolution of the metaseg and NuSeT
// U-Nets' forwards, with bias and an optional ReLU, on the CUDA cores:
//
//   y[n, p, co] = relu(bias[co] + sum_{ci, tap} x[n, p + tap, ci] w[co, ci, tap])
//
// (no relu where the template flag RELU is false: the linear transpose
// convs, run as 3x3 convs of their zero-spread input), with x = 0 outside
// the plane.  x is channels-last (NHWC); it may come in
// two halves, a (ca channels) then b (cb channels), read in place as the
// concat [a, b] of a decoder's skip and upsampled halves (metaseg's dec*_1,
// NuSeT's conv{3,2,1}-3).  Output (n, h, w, cout) NHWC, float32.
//
// Replaces no TPU kernel: the JAX package leaves these convs to XLA
// (ecseg_tpu/models/metaseg_unet.py, lax.conv_general_dilated at
// Precision.HIGHEST), and the port ran them on cuDNN, whose heuristic at
// TF32 off and deterministic algorithms picks FFT tiling (≈ 35,000 complex
// GEMMs an XL forward).
//
// Bound on an H100: operations.  2 * 9 * cin * cout FLOPs an output pixel
// against 4 * (cin + cout) bytes of traffic: 288 FLOP/B at 64 -> 64, over
// the card's 20 FLOP/B float32 ridge (67 TFLOP/s outside the tensor cores,
// 3.35 TB/s).  Every product is a float32 FMA (no TF32, no Winograd, no
// FFT), so the bound is the FMA rate, and the design keeps the issue slots
// on FFMA:
//
// - an implicit GEMM: M = output pixels of an 8 x 16 tile, N = BN output
//   channels (64 for cout <= 64, else 128), K = (input channel, tap);
// - per chunk of BK input channels the block stages the 10 x 18 input tile
//   (the 1-pixel halo, zeros outside the plane and past cin) and the
//   chunk's 9 * BK * BN weights (prepacked K-major by the wrapper) in a
//   two-stage shared ring by cp.async, the next chunk in flight while the
//   current one is summed; every tap reads the one staged tile;
// - a thread holds 8 pixels of one tile row x 8 output channels (64 sums);
//   per (input channel, kernel row) it loads the 10 input values its 8
//   pixels see across the three taps of that row once, and per tap two
//   float4 of weights: 16 shared loads for 192 FMAs;
// - a warp's four pixel rows lie in four banks (row pitch 18 * BK + 4
//   floats), its eight channel groups in 128 contiguous bytes;
// - one block of 256 threads an SM at BN = 128 (two of 128 at BN = 64), so
//   a thread may hold up to 255 registers and the loop over a chunk's
//   channels unrolls by two with no spills (at two blocks of 256 threads
//   an SM the 128-register cap spilled and ran 6-9 % slower).
//
// Sum order, fixed: over the input channels (a's, then b's), per channel the
// taps in row-major order (ky, kx), each an FMA into the float32 sum; then
// the bias, then the ReLU (where RELU).  No split-K, no atomics: the bytes
// are the same from run to run and do not depend on how many images the
// call holds.
//
// BK (input channels a chunk), by the channel counts: 16 when they are
// multiples of 4 (16-byte copies) and a's is a multiple of 16 or b is
// absent, else 1 (element copies; enc1_1's cin = 1).

#include <cstdint>
#include <cuda_runtime.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kTh = 8, kTw = 16;               // output pixels of a block: rows x columns
constexpr int kInH = kTh + 2, kInW = kTw + 2;  // the input tile with its 1-pixel halo
constexpr int kStages = 2;

template <int BN, int BK>
struct Cfg {
  static constexpr int kThreads = 2 * BN;                     // 16 pixel groups x BN / 8 channel groups
  static constexpr int kRow = kInW * BK + (BK % 4 == 0 ? 4 : 0);  // floats between input tile rows
  static constexpr int kIn = kInH * kRow;                     // floats of the input tile
  static constexpr int kW = 9 * BK * BN;                      // floats of a chunk's weights
  static constexpr int kStage = kIn + kW;
  static constexpr int kSmem = kStages * kStage * 4;          // bytes
  static constexpr int kMinBlocks = BN == 128 ? 1 : 2;        // 8 warps an SM, up to 255 registers a thread
};

// four sums, then their biases, then the ReLU where `relu`
__device__ __forceinline__ float4 epilogue(float a0, float a1, float a2, float a3, float4 b, bool relu) {
  const float4 y = make_float4(a0 + b.x, a1 + b.y, a2 + b.z, a3 + b.w);
  return relu ? make_float4(fmaxf(y.x, 0.f), fmaxf(y.y, 0.f), fmaxf(y.z, 0.f), fmaxf(y.w, 0.f)) : y;
}

template <int BN, int BK, bool RELU>
__global__ void __launch_bounds__(Cfg<BN, BK>::kThreads, Cfg<BN, BK>::kMinBlocks)
conv3x3_f32(const float* __restrict__ xa, const float* __restrict__ xb,
            const float* __restrict__ wpk, const float* __restrict__ bias,
            float* __restrict__ out, int h, int w, int ca, int cb, int cout,
            int chunks, int vec) {
  using C = Cfg<BN, BK>;
  extern __shared__ __align__(16) float smem[];
  const int tiles_w = (w + kTw - 1) / kTw, tiles = tiles_w * ((h + kTh - 1) / kTh);
  const int tile = static_cast<int>(blockIdx.x % tiles);
  const long long img = blockIdx.x / tiles;
  const int i0 = tile / tiles_w * kTh, j0 = tile % tiles_w * kTw;
  const long long plane = static_cast<long long>(h) * w;
  const float* xan = xa + img * plane * ca;
  const float* xbn = cb ? xb + img * plane * cb : nullptr;
  const float* wb = wpk + static_cast<long long>(blockIdx.y) * chunks * C::kW;

  // chunk c (concat channels c*BK .. c*BK+BK-1, all in a or all in b) ->
  // stage: the input tile [row][col][channel], then the weights
  // [channel][tap][BN]
  auto load = [&](int c, int stage) {
    float* in = smem + stage * C::kStage;
    const int ch0 = c * BK;
    const bool in_a = ch0 < ca;
    const float* src = in_a ? xan : xbn;
    const int cs = in_a ? ca : cb, cc = in_a ? ch0 : ch0 - ca;
    if (BK % 4 == 0 && vec) {
      for (int u = threadIdx.x; u < kInH * kInW * (BK / 4); u += C::kThreads) {
        constexpr int kQ = BK / 4 > 0 ? BK / 4 : 1;
        const int px = u / kQ, q = u % kQ * 4;
        const int r = px / kInW, col = px % kInW;
        const int gi = i0 - 1 + r, gj = j0 - 1 + col;
        const bool ok = gi >= 0 && gi < h && gj >= 0 && gj < w && cc + q < cs;
        const float* s = ok ? src + (static_cast<long long>(gi) * w + gj) * cs + cc + q : xa;
        mma::cp_async16(in + r * C::kRow + col * BK + q, s, ok ? 16 : 0);
      }
    } else {
      for (int u = threadIdx.x; u < kInH * kInW * BK; u += C::kThreads) {
        const int px = u / BK, q = u % BK;
        const int r = px / kInW, col = px % kInW;
        const int gi = i0 - 1 + r, gj = j0 - 1 + col;
        const bool ok = gi >= 0 && gi < h && gj >= 0 && gj < w && cc + q < cs;
        in[r * C::kRow + col * BK + q] = ok ? src[(static_cast<long long>(gi) * w + gj) * cs + cc + q] : 0.f;
      }
    }
    const float* ws = wb + static_cast<long long>(c) * C::kW;
    float* wd = in + C::kIn;
    for (int u = threadIdx.x; u < C::kW / 4; u += C::kThreads) mma::cp_async16(wd + 4 * u, ws + 4 * u, 16);
  };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m = (warp & 3) * 4 + (lane >> 3);  // pixel group: a warp's four are four rows of one half
  const int row = m & 7, half = m >> 3;        // this thread's pixels: tile row `row`, columns half*8..+7
  const int ncol = (warp >> 2) * 64 + (lane & 7) * 4;  // its channels: ncol..+3 and ncol+32..+35 of the block's BN

  float acc[8][8];
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[p][q] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < chunks) load(s, s);
    mma::cp_async_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    mma::cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk c has landed, and every thread is done with chunk c - 1's stage
    if (c + kStages - 1 < chunks) load(c + kStages - 1, (c + kStages - 1) % kStages);
    mma::cp_async_commit();
    const float* in = smem + (c % kStages) * C::kStage;
    const float* wt = in + C::kIn + ncol;
#pragma unroll 2
    for (int ci = 0; ci < BK; ++ci) {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const float* ap = in + (row + dy) * C::kRow + half * 8 * BK + ci;
        float a[10];
#pragma unroll
        for (int t = 0; t < 10; ++t) a[t] = ap[t * BK];
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float* bp = wt + (ci * 9 + dy * 3 + dx) * BN;
          const float4 b0 = *reinterpret_cast<const float4*>(bp);
          const float4 b1 = *reinterpret_cast<const float4*>(bp + 32);
#pragma unroll
          for (int p = 0; p < 8; ++p) {
            const float v = a[p + dx];
            acc[p][0] = fmaf(v, b0.x, acc[p][0]);
            acc[p][1] = fmaf(v, b0.y, acc[p][1]);
            acc[p][2] = fmaf(v, b0.z, acc[p][2]);
            acc[p][3] = fmaf(v, b0.w, acc[p][3]);
            acc[p][4] = fmaf(v, b1.x, acc[p][4]);
            acc[p][5] = fmaf(v, b1.y, acc[p][5]);
            acc[p][6] = fmaf(v, b1.z, acc[p][6]);
            acc[p][7] = fmaf(v, b1.w, acc[p][7]);
          }
        }
      }
    }
  }

  const int i = i0 + row;
  if (i >= h) return;
  const int co0 = blockIdx.y * BN + ncol, co1 = co0 + 32;  // bias is padded to the blocks' BN
  const float4 bb0 = *reinterpret_cast<const float4*>(bias + co0);
  const float4 bb1 = *reinterpret_cast<const float4*>(bias + co1);
  float* orow = out + (img * h + i) * static_cast<long long>(w) * cout;
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const int j = j0 + half * 8 + p;
    if (j >= w) break;
    float* o = orow + static_cast<long long>(j) * cout;
    if (co0 < cout) *reinterpret_cast<float4*>(o + co0) = epilogue(acc[p][0], acc[p][1], acc[p][2], acc[p][3], bb0, RELU);
    if (co1 < cout) *reinterpret_cast<float4*>(o + co1) = epilogue(acc[p][4], acc[p][5], acc[p][6], acc[p][7], bb1, RELU);
  }
}

template <int BN, int BK, bool RELU>
int launch(const void* xa, const void* xb, const void* wpk, const void* bias, void* out, int n,
           int h, int w, int ca, int cb, int cout, int vec, cudaStream_t stream) {
  using C = Cfg<BN, BK>;
  cudaError_t e = cudaFuncSetAttribute(conv3x3_f32<BN, BK, RELU>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int chunks = (ca + cb + BK - 1) / BK;
  const long long mblocks = static_cast<long long>(n) * ((h + kTh - 1) / kTh) * ((w + kTw - 1) / kTw);
  dim3 grid(static_cast<unsigned>(mblocks), (cout + BN - 1) / BN);
  conv3x3_f32<BN, BK, RELU><<<grid, C::kThreads, C::kSmem, stream>>>(
      static_cast<const float*>(xa), static_cast<const float*>(xb), static_cast<const float*>(wpk),
      static_cast<const float*>(bias), static_cast<float*>(out), h, w, ca, cb, cout, chunks, vec);
  return static_cast<int>(cudaGetLastError());
}

template <bool RELU>
int dispatch(const void* xa, const void* xb, const void* wpk, const void* bias, void* out, int n,
             int h, int w, int ca, int cb, int cout, int bn, int bk, int vec, cudaStream_t s) {
  if (bn == 64 && bk == 16) return launch<64, 16, RELU>(xa, xb, wpk, bias, out, n, h, w, ca, cb, cout, vec, s);
  if (bn == 128 && bk == 16) return launch<128, 16, RELU>(xa, xb, wpk, bias, out, n, h, w, ca, cb, cout, vec, s);
  if (bn == 64 && bk == 1) return launch<64, 1, RELU>(xa, xb, wpk, bias, out, n, h, w, ca, cb, cout, 0, s);
  if (bn == 128 && bk == 1) return launch<128, 1, RELU>(xa, xb, wpk, bias, out, n, h, w, ca, cb, cout, 0, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// xa (n, h, w, ca) and xb (n, h, w, cb) float32 contiguous NHWC (xb null when
// cb is 0; ca % bk == 0 when it is not); wpk the weights packed by
// ops/conv3x3.pack_weights for (bn, bk); bias float32 padded to a multiple
// of bn; out (n, h, w, cout) float32.  cout % 4 == 0; bn 64 or 128; bk 16
// or 1; `vec` 1 when bk is 16, ca and cb are multiples of 4 and xa, xb are
// 16-byte aligned; `relu` 1 for the ReLU, 0 for none.
extern "C" int ecseg_conv3x3(const void* xa, const void* xb, const void* wpk, const void* bias,
                             void* out, int n, int h, int w, int ca, int cb, int cout, int bn,
                             int bk, int vec, int relu, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return relu ? dispatch<true>(xa, xb, wpk, bias, out, n, h, w, ca, cb, cout, bn, bk, vec, s)
              : dispatch<false>(xa, xb, wpk, bias, out, n, h, w, ca, cb, cout, bn, bk, vec, s);
}
