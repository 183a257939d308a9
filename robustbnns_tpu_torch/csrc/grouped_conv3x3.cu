// ResNet-20's residual 3x3 convolutions, grouped by draw: the forward and the
// input gradient, one launch each for all S draws. For each draw s, image b,
// output channel o and output pixel (y, x), with padding 1 (zeros read outside
// the input) and stride st in {1, 2},
//   out[b, s*Co + o, y, x] = bias[s, o]
//       + sum_{ky, kx < 3} sum_{c < Ci} in[b, s*Ci + c, st*y + ky - 1, st*x + kx - 1] * w[s, ky, kx, c, o]
// on stacked HWIO weights (S, 3, 3, Ci, Co), read as they are (no permute),
// and the input gradient of that sum,
//   dx[b, s*Ci + c, i, j] = sum over (ky, kx, o) with st | i + 1 - ky and st | j + 1 - kx of
//       g[b, s*Co + o, (i + 1 - ky) / st, (j + 1 - kx) / st] * w[s, ky, kx, c, o].
// Input, output and gradients are contiguous NCHW, as the trunk holds them.
// (Ci, Co, st) is one of ResNet-20's at width 16, on the sides its 32 x 32
// inputs give: (16, 16, 1) on 32 x 32, (16, 32, 2) on 32 x 32, (32, 32, 1) on
// 16 x 16, (32, 64, 2) on 16 x 16, (64, 64, 1) on 8 x 8; any B >= 1, S >= 1.
//
// Replaces no Pallas kernel: the JAX package has no ResNet. It stands in for
// cuDNN's grouped engine, which runs these convs group by group (about 150
// kernels a conv each way: implicit_convolve_sgemm forward, dgrad2d_alg1_1
// backward) and took 218.5 ms of a 249 ms PGD iteration for the 18 grouped
// convs, forward and input gradient, at B 128, S 100.
//
// What bounds it on the H100. A stride-1 conv does 2*9*Ci*Co*side^2 = 4.719
// MFLOP an image and draw at every stage (the channels double as the sides
// halve), 60.4 GFLOP at B 128, S 100: 0.90 ms on the FFMA pipe at 67 TFLOP/s.
// Exact f32 rules out the tensor cores (TF32 fails the f32 reference's
// check). Its bytes, each activation read and written once, take 0.50 ms in
// stage 1 and 0.13 ms in stage 3; a stride-2 conv costs half. So the FFMA pipe
// bounds it: 15.3 ms a direction for the 18 convs of an iteration.
//
// The input gradient is a 3x3 conv too: at stride 1 of g with padding 1, tap
// (ky, kx) at offset (1 - ky, 1 - kx), over the Co channels, into Ci, with
// each tap's weights transposed. At stride 2 the rows of dx split by parity:
// even rows take tap row 1 of g's row i, odd rows tap rows 0 (g's row i + 1)
// and 2 (row i); columns likewise, so a pixel's parity class takes 1, 2, 2 or
// 4 taps. One kernel template serves all of them; only the tap offsets and
// the way a weight tile is read change.
//
// Design: an implicit GEMM per draw on the FFMA pipe (M = pixels, N = output
// channels, K = taps x summed channels).
// - A block of 256 threads owns one draw, all N output channels and whole
//   images: 16,384 outputs (1 image in stage 1, 2 in stage 2, 4 in stage 3
//   forward). Each thread holds 8 neighbouring outputs of one output row by
//   8 channels (4cg .. 4cg+3 and N/2 + 4cg .. N/2 + 4cg + 3) in registers.
// - Per summed channel and tap row the thread reads its input window along
//   the row once (10 floats, 17 at stride 2: two or four aligned float4 and
//   the halo) and uses it for that row's three taps, each with two float4 of
//   the tap's weights: 192 FFMA for 10 shared-memory reads.
// - A stride-2 input gradient's block owns the dx rows of one parity (2 or
//   4 images): a thread's 8 outputs are 4 even and 4 odd columns, read from a
//   window of 5 columns of g, even columns with tap column 1, odd ones with
//   taps 0 and 2; even rows take 3 taps, odd rows 6. Each block stores whole
//   rows (float4), and within it every thread takes the same taps, so no warp
//   diverges. (One block per pixel class, 1 to 4 taps and every other column
//   stored, took 2.3-3.0x as long.)
// - The summed channels go in chunks of 8 (4 where the patch is large). A
//   chunk's input patch (whole planes of the block's images, in a frame of
//   zeros written once: the one-pixel halo) and its weight tile (9 taps x
//   chunk x N, rows padded by 4 floats) land in one of two shared-memory
//   stages by cp.async while the other stage is in use: 16-byte copies for
//   the patch and the forward's weight rows, 4-byte copies for the input
//   gradient's weights, which they transpose on the way (rows (tap, o),
//   columns c). One __syncthreads a chunk; 60-100 KB of shared memory and
//   128 registers a thread: two blocks an SM.
// - Grid (image groups, S), image groups fastest (a stride-2 input gradient's
//   two row parities fastest of all), so the blocks of one draw run together
//   and that draw's weights stay in L2.
// - The epilogue adds the bias (forward) and stores float4 along the row.
// - Every output is one thread's fixed-order sum (chunk by chunk, channel by
//   channel, tap row by tap row, tap by tap; then the bias): no atomics,
//   bit-identical from call to call. Images past B are zero-filled and not
//   stored.
// - Measured at B 128, S 100 (H100 80GB HBM3, 700 W): 58-66% of
//   the bound at stride 1, 43-53% for the stride-2 forwards and 39-40% for
//   the stride-2 input gradients; the 36 passes of an iteration 50.5-51.0 ms
//   against 30.6, where cuDNN took 218.5. Chunks of 2, 4 or 8 channels, the
//   channel loop unrolled twice, one block an SM without a register cap, and
//   the lanes along pixels rather than channels all measured no faster.
#include "sampled_dense_common.cuh"

namespace grouped_conv3x3 {
namespace {

using sampled_dense::cp_async16;
using sampled_dense::cp_async4;
using sampled_dense::cp_async_commit;
using sampled_dense::cp_async_wait_pending;

constexpr int kThreads = 256;
constexpr int kSmemLimit = 113 * 1024;  // two blocks an SM

enum Mode { kForward, kForwardStride2, kInputGrad, kInputGradStride2 };

// One launch's geometry. kIn: the channels a sum runs over (Ci forward, Co
// for the input gradient); kN: the output channels (Co forward, Ci for the
// input gradient); kSide: the side of the planes read (x's forward, g's for
// the input gradient). A thread owns 8 neighbouring outputs of one output
// row; a stride-2 input gradient's block owns the rows of one parity.
template <int kMode, int kIn, int kN, int kSide>
struct Conv {
  static constexpr bool kInputGradient = kMode == kInputGrad || kMode == kInputGradStride2;
  static constexpr bool kParity = kMode == kInputGradStride2;
  static constexpr int kStep = kMode == kForwardStride2 ? 2 : 1;  // input columns from one output to the next
  static constexpr int kOutSide = kParity ? 2 * kSide : kSide / kStep;  // the output plane's side
  static constexpr int kRows = kParity ? kSide : kOutSide;  // output rows a block computes an image
  static constexpr int kGroups = kN / 8;       // a thread's 8 channels
  static constexpr int kHalf = kN / 2;         // ... 4 of them from each half of the N outputs
  static constexpr int kTiles = kThreads / kGroups;  // 8-output row tiles a block
  static constexpr int kTilesPerRow = kOutSide / 8;
  static constexpr int kImages = kTiles / (kRows * kTilesPerRow);
  static constexpr int kRow = kSide + 8;  // a patch row: 3 unused, the left halo, the plane's row, the right halo, 3 unused
  static constexpr int kPlane = (kSide + 2) * kRow;  // with the top and bottom halo rows
  static constexpr int kWRow = kN + 4;  // a weight row (a tap and a summed channel), padded
  static constexpr int kChunk = 2 * 8 * (kImages * kPlane + 9 * kWRow) * 4 <= kSmemLimit ? 8 : 4;
  static constexpr int kPatch = kImages * kChunk * kPlane;  // one stage's patch: [image][channel][row][column]
  static constexpr int kWTile = 9 * kChunk * kWRow;         // one stage's weights: [tap][channel][output]
  static constexpr int kSmemBytes = 2 * (kPatch + kWTile) * 4;
  // a thread's input columns in a row: from the column left of its first
  // output's, 10 (17 at stride 2); a parity block's 5, from its first output's half
  static constexpr int kWindow = kParity ? 5 : kStep == 2 ? 17 : 10;
  static_assert(kN % 8 == 0 && kOutSide % 8 == 0 && kImages >= 1 && kImages * kRows * kTilesPerRow == kTiles,
                "whole images a block");
  static_assert(kIn % kChunk == 0 && kSmemBytes <= kSmemLimit, "two stages, two blocks an SM");
};

// Whether tap row ky feeds the output rows of parity p, and the offset of the
// input row it reads from the output's, on the plane read: ky - 1 forward,
// 1 - ky for the input gradient at stride 1; for a stride-2 input gradient,
// output row 2i + p reads g's row i + (p + 1 - ky) / 2 where p + 1 - ky is
// even (even rows tap 1 alone, odd ones 0 and 2), and columns alike.
template <int kMode>
__device__ __forceinline__ bool tap_in(int k, int p) {
  return kMode != kInputGradStride2 || ((p + 1 - k) & 1) == 0;
}
template <int kMode>
__device__ __forceinline__ int tap_offset(int k, int p) {
  return kMode == kInputGradStride2 ? (p + 1 - k) / 2 : kMode == kInputGrad ? 1 - k : k - 1;
}

// One stage's FFMAs: every summed channel of the chunk, tap row by tap row,
// tap by tap. `window` is this thread's window at channel 0 and row offset 0:
// the patch at its image and its outputs' row, at the window's first column.
// kPy: the block's row parity (a stride-2 input gradient's).
template <class C, int kMode, int kPy>
__device__ __forceinline__ void fma_chunk(const float* window, const float* wt, int cg, float (&acc)[8][8]) {
#pragma unroll 1
  for (int c = 0; c < C::kChunk; ++c) {
#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
      if (!tap_in<kMode>(ky, kPy)) continue;
      const float* src = window + c * C::kPlane + tap_offset<kMode>(ky, kPy) * C::kRow;
      float a[C::kWindow];
      if (C::kParity) {  // columns X0 .. X0 + 4 of g for outputs 2 X0 .. 2 X0 + 7
        const float4 v = *reinterpret_cast<const float4*>(src);
        a[0] = v.x;
        a[1] = v.y;
        a[2] = v.z;
        a[3] = v.w;
        a[4] = src[4];
      } else {  // the column left of the first output's input, then aligned quads
        a[0] = src[0];
#pragma unroll
        for (int q = 0; q < (C::kWindow - 1) / 4; ++q) {
          const float4 v = *reinterpret_cast<const float4*>(src + 1 + 4 * q);
          a[1 + 4 * q] = v.x;
          a[2 + 4 * q] = v.y;
          a[3 + 4 * q] = v.z;
          a[4 + 4 * q] = v.w;
        }
        if (C::kWindow == 10) a[9] = src[9];
      }
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        const float* wr = wt + ((ky * 3 + kx) * C::kChunk + c) * C::kWRow + 4 * cg;
        const float4 lo = *reinterpret_cast<const float4*>(wr);
        const float4 hi = *reinterpret_cast<const float4*>(wr + C::kHalf);
        const float wv[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
        for (int p = 0; p < 8; ++p) {
          // output p's input column in the window: p + kx (forward), 2p + kx (stride 2),
          // p + 2 - kx (input gradient); (p + 1 - kx) / 2 where even (stride-2 input gradient)
          if (C::kParity && ((p + 1 - kx) & 1)) continue;
          const int col = C::kParity ? (p + 1 - kx) / 2 : C::kStep * p + tap_offset<kMode>(kx, 0) + 1;
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[p][j] = fmaf(a[col], wv[j], acc[p][j]);
        }
      }
    }
  }
}

// src: x (B, S*kIn, kSide, kSide) forward, g for the input gradient; w (S, 3,
// 3, Ci, Co); bias (S, Co), forward only; out (B, S*kN, kOutSide, kOutSide).
template <int kMode, int kIn, int kN, int kSide>
__global__ void __launch_bounds__(kThreads, 2) conv3x3_kernel(
    const float* __restrict__ src, const float* __restrict__ w, const float* __restrict__ bias,
    float* __restrict__ out, int B, int S) {
  using C = Conv<kMode, kIn, kN, kSide>;
  extern __shared__ __align__(16) float smem[];
  float* patches = smem;                      // [2][kPatch]
  float* w_tiles = smem + 2 * C::kPatch;      // [2][kWTile]

  const int tid = threadIdx.x, s = blockIdx.y;
  const int py = C::kParity ? (int)blockIdx.x % 2 : 0;  // the output rows' parity
  const int b0 = (C::kParity ? (int)blockIdx.x / 2 : (int)blockIdx.x) * C::kImages;

  // Zeros around both stages' planes, once: the top and bottom rows whole,
  // and the quads left and right of every row (the halo columns 3 and kSide +
  // 4 among them). cp.async fills the columns between at every chunk; the
  // first chunk's barrier orders these stores before any read.
  {
    constexpr int kRowQuads = C::kRow / 4, kPlaneQuads = (kSide + 2) * 2 + 2 * (kRowQuads - 2);
    for (int f = tid; f < 2 * C::kImages * C::kChunk * kPlaneQuads; f += kThreads) {
      const int plane = f / kPlaneQuads, e = f % kPlaneQuads;
      int row, quad;
      if (e < 2 * (kSide + 2)) {  // the edge quads of every row
        row = e / 2;
        quad = e % 2 ? kRowQuads - 1 : 0;
      } else {  // the inner quads of the top and bottom rows
        row = (e - 2 * (kSide + 2)) / (kRowQuads - 2) ? kSide + 1 : 0;
        quad = 1 + (e - 2 * (kSide + 2)) % (kRowQuads - 2);
      }
      reinterpret_cast<float4*>(patches + plane * C::kPlane + row * C::kRow)[quad] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }

  // Chunk k's planes of the block's images (zeros for an image past B) and
  // its weight tile into stage buf.
  auto fetch = [&](int k, int buf) {
    const int k0 = k * C::kChunk;
    float* patch = patches + buf * C::kPatch;
    constexpr int kQuads = kSide / 4;
    constexpr int kCopies = C::kImages * C::kChunk * kSide * kQuads;
#pragma unroll
    for (int j = 0; j < (kCopies + kThreads - 1) / kThreads; ++j) {
      const int f = tid + j * kThreads;
      if (kCopies % kThreads != 0 && f >= kCopies) break;
      const int q = f % kQuads, row = f / kQuads % kSide, c = f / (kQuads * kSide) % C::kChunk;
      const int i = f / (kQuads * kSide * C::kChunk), b = b0 + i;
      const float* from = src + ((((size_t)min(b, B - 1) * S + s) * kIn + k0 + c) * kSide + row) * kSide + 4 * q;
      cp_async16(patch + ((i * C::kChunk + c) * (kSide + 2) + row + 1) * C::kRow + 4 + 4 * q, from, b < B);
    }
    float* wt = w_tiles + buf * C::kWTile;
    if (!C::kInputGradient) {  // rows (tap, c) of w[s] as they are: kN contiguous outputs
      constexpr int kRowQuads = kN / 4, kCopiesW = 9 * C::kChunk * kRowQuads;
#pragma unroll
      for (int j = 0; j < (kCopiesW + kThreads - 1) / kThreads; ++j) {
        const int f = tid + j * kThreads;
        if (kCopiesW % kThreads != 0 && f >= kCopiesW) break;
        const int q = f % kRowQuads, c = f / kRowQuads % C::kChunk, tap = f / (kRowQuads * C::kChunk);
        cp_async16(wt + (tap * C::kChunk + c) * C::kWRow + 4 * q,
                   w + (((size_t)s * 9 + tap) * kIn + k0 + c) * kN + 4 * q, true);
      }
    } else {  // w[s, tap, n, o] read along o (the summed channels), written along n
      constexpr int kCopiesW = 9 * C::kChunk * kN;
#pragma unroll 4
      for (int j = 0; j < (kCopiesW + kThreads - 1) / kThreads; ++j) {
        const int f = tid + j * kThreads;
        if (kCopiesW % kThreads != 0 && f >= kCopiesW) break;
        const int o = f % C::kChunk, n = f / C::kChunk % kN, tap = f / (C::kChunk * kN);
        cp_async4(wt + (tap * C::kChunk + o) * C::kWRow + n, w + (((size_t)s * 9 + tap) * kN + n) * kIn + k0 + o);
      }
    }
  };

  // This thread's outputs: channels of group cg; outputs ox0 .. ox0 + 7 of
  // output row oy (of parity py: row 2 oy + py) of image img.
  const int cg = tid % C::kGroups, tile = tid / C::kGroups;
  const int img = tile / (C::kRows * C::kTilesPerRow), oy = tile / C::kTilesPerRow % C::kRows;
  const int ox0 = tile % C::kTilesPerRow * 8;
  const int window = img * C::kChunk * C::kPlane + (C::kStep * oy + 1) * C::kRow +
                     (C::kParity ? 4 + ox0 / 2 : 3 + C::kStep * ox0);
  float acc[8][8] = {};  // [output][channel]

  constexpr int kChunks = kIn / C::kChunk;
  fetch(0, 0);
  cp_async_commit();
  for (int k = 0; k < kChunks; ++k) {
    cp_async_wait_pending<0>();  // this thread's copies of chunk k have landed
    __syncthreads();             // ... everyone's; everyone is done with chunk k - 1's stage
    if (k + 1 < kChunks) {
      fetch(k + 1, (k + 1) & 1);
      cp_async_commit();
    }
    const float* patch = patches + (k & 1) * C::kPatch + window;
    const float* wt = w_tiles + (k & 1) * C::kWTile;
    if (py == 0)
      fma_chunk<C, kMode, 0>(patch, wt, cg, acc);
    else
      fma_chunk<C, kMode, 1>(patch, wt, cg, acc);
  }

  const int b = b0 + img;
  if (b >= B) return;
  constexpr int kOutPlane = C::kOutSide * C::kOutSide;
  float* dst = out + ((size_t)b * S + s) * kN * kOutPlane + (C::kParity ? 2 * oy + py : oy) * C::kOutSide + ox0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = j < 4 ? 4 * cg + j : C::kHalf + 4 * cg + j - 4;
    const float bj = C::kInputGradient ? 0.f : bias[(size_t)s * kN + n];
    float* plane = dst + (size_t)n * kOutPlane;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float4 v = make_float4(acc[4 * h][j], acc[4 * h + 1][j], acc[4 * h + 2][j], acc[4 * h + 3][j]);
      if (!C::kInputGradient) v = make_float4(v.x + bj, v.y + bj, v.z + bj, v.w + bj);
      *reinterpret_cast<float4*>(plane + 4 * h) = v;
    }
  }
}

template <int kMode, int kIn, int kN, int kSide>
int launch(const float* src, const float* w, const float* bias, float* out, int B, int S, void* stream) {
  using C = Conv<kMode, kIn, kN, kSide>;
  const long long groups = (B + (long long)C::kImages - 1) / C::kImages;
  const long long blocks_x = groups * (C::kParity ? 2 : 1);
  if (B < 1 || S < 1 || S > 65535 || blocks_x > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  // above the 48 KB a block gets without asking; set once, before any graph capture
  static const cudaError_t attr = cudaFuncSetAttribute(conv3x3_kernel<kMode, kIn, kN, kSide>,
                                                       cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((unsigned)blocks_x, S);
  const cudaStream_t on = static_cast<cudaStream_t>(stream);
  conv3x3_kernel<kMode, kIn, kN, kSide><<<grid, kThreads, C::kSmemBytes, on>>>(src, w, bias, out, B, S);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace grouped_conv3x3

// out (B, S*c_out, side/stride, side/stride) = the grouped 3x3 conv (padding
// 1) of x (B, S*c_in, side, side) with w (S, 3, 3, c_in, c_out), plus bias
// (S, c_out); all contiguous, every pointer 16-byte aligned. (c_in, c_out,
// stride, side) one of the five ResNet-20 shapes above.
extern "C" int grouped_conv3x3_fwd(const float* x, const float* w, const float* bias, float* out, int B, int S,
                                   int c_in, int c_out, int stride, int side, void* stream) {
  using namespace grouped_conv3x3;
  if (c_in == 16 && c_out == 16 && stride == 1 && side == 32)
    return launch<kForward, 16, 16, 32>(x, w, bias, out, B, S, stream);
  if (c_in == 16 && c_out == 32 && stride == 2 && side == 32)
    return launch<kForwardStride2, 16, 32, 32>(x, w, bias, out, B, S, stream);
  if (c_in == 32 && c_out == 32 && stride == 1 && side == 16)
    return launch<kForward, 32, 32, 16>(x, w, bias, out, B, S, stream);
  if (c_in == 32 && c_out == 64 && stride == 2 && side == 16)
    return launch<kForwardStride2, 32, 64, 16>(x, w, bias, out, B, S, stream);
  if (c_in == 64 && c_out == 64 && stride == 1 && side == 8)
    return launch<kForward, 64, 64, 8>(x, w, bias, out, B, S, stream);
  return (int)cudaErrorInvalidValue;
}

// dx (B, S*c_in, side, side) = the input gradient of that conv from g (B,
// S*c_out, side/stride, side/stride); same shapes and conditions.
extern "C" int grouped_conv3x3_dgrad(const float* g, const float* w, float* dx, int B, int S, int c_in,
                                     int c_out, int stride, int side, void* stream) {
  using namespace grouped_conv3x3;
  if (c_in == 16 && c_out == 16 && stride == 1 && side == 32)
    return launch<kInputGrad, 16, 16, 32>(g, w, nullptr, dx, B, S, stream);
  if (c_in == 16 && c_out == 32 && stride == 2 && side == 32)
    return launch<kInputGradStride2, 32, 16, 16>(g, w, nullptr, dx, B, S, stream);
  if (c_in == 32 && c_out == 32 && stride == 1 && side == 16)
    return launch<kInputGrad, 32, 32, 16>(g, w, nullptr, dx, B, S, stream);
  if (c_in == 32 && c_out == 64 && stride == 2 && side == 16)
    return launch<kInputGradStride2, 64, 32, 8>(g, w, nullptr, dx, B, S, stream);
  if (c_in == 64 && c_out == 64 && stride == 1 && side == 8)
    return launch<kInputGrad, 64, 64, 8>(g, w, nullptr, dx, B, S, stream);
  return (int)cudaErrorInvalidValue;
}
