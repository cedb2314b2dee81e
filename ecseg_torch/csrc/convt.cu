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
// Bound on an H100: 2 * N * h * w * cin * cout * 9 FLOPs (241 GFLOP per
// 100 patches at every decoder level: 0.24 ms at the bf16 tensor-core peak
// of 989 TFLOP/s) against N*h*w*cin + 4*N*h*w*cout elements of traffic:
// bytes bound at the XL up1 level (1.26 GB in bf16, 0.376 ms), operations
// bound at up4 (16x16 inputs, cin 1024).
//
// Two forms, chosen by the input's dtype:
//
// bf16 (convt_mma): per output parity a GEMM with M = input pixels, N =
// cout and K = taps x cin, on the tensor cores (wgmma.mma_async m64n64k16:
// A, a window of the input, from registers loaded by ldmatrix; B, a tap's
// weights, from shared memory by descriptor; float32 sums in registers).
// A block takes 8 x 16 input pixels (a warpgroup's m64 tile is 4 input
// rows) and 64 output channels.  Per 32-channel chunk of cin, a 9 x 17
// input tile (a 1-pixel top/left halo, zero outside the input and past
// cin) and the chunk's 9 taps x 64 x 32 weights (prepacked by the wrapper
// in wgmma's canonical layout) arrive in a three-stage shared ring by
// cp.async, two chunks ahead of the MMAs.  For each k16 slice a warp loads
// the four window fragments (i,j), (i,j-1), (i-1,j), (i-1,j-1) of its input
// row and its warpgroup issues 9 wgmma, one per tap, into the four parity
// accumulators (the table above): the TPU kernel's 16 -> 9 saving without
// its zero taps.  Each thread holds 4 parities x 32 sums.  The epilogue
// adds the bias, applies the ReLU and rounds into a 16 x 32 x 64 output
// tile in shared memory (the pixel shuffle), then writes each output row
// as contiguous 16-byte vectors over (2j + b, cout).
//
// float32 (tests and exact integer checks; tensor cores would take float32
// only as TF32): convt_quad, one thread per input pixel and 4 output
// channels, the 2x2 quad's 16 float32 sums by scalar FMAs on the CUDA
// cores.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;

// ---------------------------------------------------------------- float32

// 4 consecutive weights (aligned: cout % 4 == 0).
__device__ __forceinline__ void load4(const float* p, float* w) {
  float4 a = __ldg(reinterpret_cast<const float4*>(p));
  w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
}

__global__ void __launch_bounds__(kThreads)
convt_quad(const float* __restrict__ x, const float* __restrict__ k,
           const float* __restrict__ bias, float* __restrict__ out, int n, int h,
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
  const float* x11 = x + ((b * h + i) * w + j) * cin;  // x[i][j]
  const long long row = static_cast<long long>(w) * cin;

  // acc[parity a * 2 + b][channel]
  float acc[4][4];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[p][c] = 0.f;
  for (int ci = 0; ci < cin; ++ci) {
    const float v11 = x11[ci];
    const float v10 = left ? x11[ci - cin] : 0.f;        // x[i][j-1]
    const float v01 = up ? x11[ci - row] : 0.f;          // x[i-1][j]
    const float v00 = up && left ? x11[ci - row - cin] : 0.f;  // x[i-1][j-1]
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
    float* o = out + ((b * 2 * h + oy) * wo + ox) * cout + c0;
#pragma unroll
    for (int c = 0; c < 4; ++c) o[c] = fmaxf(acc[p][c] + bias[c0 + c], 0.f);
  }
}

// ------------------------------------------------------------------- bf16

constexpr int kTh = 8, kTw = 16;     // input pixels of a block: rows x columns
constexpr int kNc = 64, kKc = 32;    // output channels of a block, cin per chunk
constexpr int kStages = 3;
constexpr int kInW = kTw + 1;                     // input tile columns (1-pixel left halo)
constexpr int kInPx = (kTh + 1) * kInW;           // input tile pixels (1-pixel top halo)
constexpr int kPk = kKc + 8;                      // pitch of an input pixel, bf16
constexpr int kTapElems = kNc * kKc;              // one tap's weights of a chunk
constexpr int kInElems = (kInPx * kPk + 63) / 64 * 64;  // the weights start 128-byte aligned
constexpr int kStageElems = kInElems + 9 * kTapElems;
constexpr int kOutP = kNc + 8;                    // pitch of an output pixel, bf16
constexpr int kSmem = kStages * kStageElems * 2;  // bytes
constexpr uint32_t kLbo = kNc / 8 * 128;          // bytes between a tap's core-matrix rows of 8 k
static_assert(2 * kTh * 2 * kTw * kOutP <= kStages * kStageElems, "output tile fits the ring");

// tap ky * 3 + kx -> the window it reads (0: x[i][j], 1: x[i][j-1],
// 2: x[i-1][j], 3: x[i-1][j-1]) and the parity a * 2 + b it feeds
__host__ __device__ constexpr int win_of(int tap) { return tap == 2 || tap == 5 ? 1 : tap == 6 || tap == 7 ? 2 : tap == 8 ? 3 : 0; }
__host__ __device__ constexpr int par_of(int tap) { return tap == 1 || tap == 7 ? 1 : tap == 3 || tap == 5 ? 2 : tap == 4 ? 3 : 0; }

__global__ void __launch_bounds__(kThreads, 1)
convt_mma(const bf16* __restrict__ x, const bf16* __restrict__ wpk,
          const float* __restrict__ bias, bf16* __restrict__ out, int h, int w,
          int cin, int cout, int chunks, int vec) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  const int tiles_w = (w + kTw - 1) / kTw, tiles_h = (h + kTh - 1) / kTh;
  const int tile = static_cast<int>(blockIdx.x % (tiles_w * tiles_h));
  const long long img = blockIdx.x / (tiles_w * tiles_h);
  const int i0 = tile / tiles_w * kTh, j0 = tile % tiles_w * kTw;
  const int nb = blockIdx.y;
  const bf16* xn = x + img * h * w * cin;
  const bf16* wb = wpk + static_cast<long long>(nb) * chunks * 9 * kTapElems;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = warp;  // this warp's input row: warpgroup warp / 4 holds rows 4 (warp / 4)..+3

  // chunk c (cin c*32..c*32+31) -> stage: the 9 x 17 input tile, then the
  // 9 taps' 64 x 32 weights in wgmma's canonical layout
  auto load = [&](int c, int stage) {
    bf16* in = ring + stage * kStageElems;
    for (int u = threadIdx.x; u < kInPx * (kKc / 8); u += kThreads) {
      const int px = u >> 2, c8 = (u & 3) * 8;
      const int gi = i0 - 1 + px / kInW, gj = j0 - 1 + px % kInW, ch = c * kKc + c8;
      const bool inb = gi >= 0 && gi < h && gj >= 0 && gj < w;
      const bf16* src = xn + (static_cast<long long>(gi) * w + gj) * cin + ch;
      bf16* dst = in + px * kPk + c8;
      if (vec) {
        const bool ok = inb && ch < cin;
        mma::cp_async16(dst, ok ? src : x, ok ? 16 : 0);
      } else {
        for (int e = 0; e < 8; ++e) dst[e] = inb && ch + e < cin ? src[e] : __float2bfloat16_rn(0.f);
      }
    }
    bf16* wd = in + kInElems;
    const bf16* ws = wb + static_cast<long long>(c) * 9 * kTapElems;
    for (int u = threadIdx.x; u < 9 * kTapElems / 8; u += kThreads) mma::cp_async16(wd + 8 * u, ws + 8 * u, 16);
  };

  // this lane's ldmatrix row in the input tile for window v, in bytes
  int arow[4];
  {
    const int jl = lane & 15;
    arow[0] = ((row + 1) * kInW + jl + 1) * kPk * 2;  // x[i][j]
    arow[1] = ((row + 1) * kInW + jl) * kPk * 2;      // x[i][j-1]
    arow[2] = (row * kInW + jl + 1) * kPk * 2;        // x[i-1][j]
    arow[3] = (row * kInW + jl) * kPk * 2;            // x[i-1][j-1]
  }
  const uint32_t acol = (lane >> 4) * 16;

  float acc[4][8][4] = {};  // [parity][8 output channels][wgmma D fragment]
  load(0, 0);
  mma::cp_async_commit();
  if (chunks > 1) load(1, 1);
  mma::cp_async_commit();
  for (int c = 0; c < chunks; ++c) {
    mma::cp_async_wait<1>();
    mma::fence_proxy_async();  // the weights are read by wgmma
    __syncthreads();  // chunk c landed; every warpgroup is done with chunk c - 1
    if (c + 2 < chunks) load(c + 2, (c + 2) % kStages);
    mma::cp_async_commit();
    const uint32_t in = mma::smem_addr(ring + (c % kStages) * kStageElems) + acol;
    const uint32_t wt = mma::smem_addr(ring + (c % kStages) * kStageElems + kInElems);
    uint32_t a[2][4][4];  // [k16 slice][window][fragment]
#pragma unroll
    for (int ks = 0; ks < kKc / 16; ++ks) {
#pragma unroll
      for (int v = 0; v < 4; ++v) mma::ldmatrix_x4(a[ks][v], in + arow[v] + 32 * ks);
      mma::wgmma_fence();
#pragma unroll
      for (int tap = 0; tap < 9; ++tap)
        mma::wgmma_m64k16<kNc>(&acc[par_of(tap)][0][0], a[ks][win_of(tap)],
                               mma::wgmma_desc(wt + tap * kTapElems * 2 + 2 * ks * kLbo, kLbo, 128));
      mma::wgmma_commit();
    }
    mma::wgmma_wait<0>();  // the stage may be refilled after the next barrier
#pragma unroll
    for (int ks = 0; ks < kKc / 16; ++ks)
#pragma unroll
      for (int v = 0; v < 4; ++v) mma::keep(a[ks][v]);
  }
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int j = 0; j < 8; ++j) mma::keep(acc[p][j]);
  mma::cp_async_wait<0>();
  __syncthreads();  // the ring is free: it becomes the output tile

  // bias, ReLU, bf16 round into the (2 kTh) x (2 kTw) x 64 output tile
  bf16* ot = ring;
  const int g = lane >> 2, t = lane & 3;
  const float* bn = bias + nb * kNc;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int oy = 2 * row + (p >> 1), ox = 2 * (g + 8 * hh) + (p & 1);
        const int n = j * 8 + 2 * t;
        *reinterpret_cast<uint32_t*>(ot + (oy * 2 * kTw + ox) * kOutP + n) =
            mma::relu_bf16x2(acc[p][j][2 * hh] + bn[n], acc[p][j][2 * hh + 1] + bn[n + 1]);
      }
  __syncthreads();

  // the pixel shuffle's store: output rows 2i + a as vectors over (2j + b, cout)
  const int n0 = nb * kNc, wo = 2 * w;
  const int v = cout % 8 == 0 ? 8 : 4;  // bf16 per vector (cout % 4 == 0)
  const int per_px = kNc / v;
  for (int u = threadIdx.x; u < 2 * kTh * 2 * kTw * per_px; u += kThreads) {
    const int px = u / per_px, c = (u - px * per_px) * v;
    const int oy = 2 * i0 + px / (2 * kTw), ox = 2 * j0 + px % (2 * kTw);
    if (oy >= 2 * h || ox >= wo || n0 + c >= cout) continue;
    const bf16* src = ot + px * kOutP + c;
    bf16* dst = out + ((img * 2 * h + oy) * wo + ox) * cout + n0 + c;
    if (v == 8)
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    else
      *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
  }
}

}  // namespace

// float32: x (n, h, w, cin), k (3, 3, cin, cout), out (n, 2h, 2w, cout),
// bias (cout, zeros for none), all float32 and contiguous.  cout % 4 == 0.
extern "C" int ecseg_convt(const void* x, const void* k, const float* bias,
                           void* out, int n, int h, int w, int cin, int cout,
                           void* stream) {
  long long threads = static_cast<long long>(n) * h * w * (cout / 4);
  long long blocks = (threads + kThreads - 1) / kThreads;
  convt_quad<<<static_cast<unsigned>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(k), bias,
      static_cast<float*>(out), n, h, w, cin, cout);
  return static_cast<int>(cudaGetLastError());
}

// bf16: x (n, h, w, cin) contiguous; wpk the weights packed by
// ops/convt.pack_mma_weights ((cout + 63) / 64 n-blocks x `chunks` 32-channel
// chunks x 9 taps x a 64 x 32 matrix in wgmma's canonical layout, bf16); bias float32 padded to the n-blocks;
// out (n, 2h, 2w, cout) bf16.  cout % 4 == 0; `vec` 1 when x's rows are
// 16-byte aligned (cin % 8 == 0).
extern "C" int ecseg_convt_mma(const void* x, const void* wpk, const float* bias,
                               void* out, int n, int h, int w, int cin, int cout,
                               int chunks, int vec, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(convt_mma, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long mblocks = static_cast<long long>(n) * ((h + kTh - 1) / kTh) * ((w + kTw - 1) / kTw);
  dim3 grid(static_cast<unsigned>(mblocks), (cout + kNc - 1) / kNc);
  convt_mma<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wpk), bias,
      static_cast<bf16*>(out), h, w, cin, cout, chunks, vec);
  return static_cast<int>(cudaGetLastError());
}
