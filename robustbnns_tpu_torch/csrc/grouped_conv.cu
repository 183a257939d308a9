// The conv trunk's second convolution, grouped by draw: the forward here, its
// input gradient further down (namespace grouped_conv_dx). For each draw s,
// image b, output channel o < N and output pixel (y, x) < 8 x 8,
//   out[b, s*N + o, y, x] = bias[s, o]
//       + sum_{ky, kx < 5} sum_{c < 32} in[b, s*32 + c, y + ky, x + kx] * w[s, ky, kx, c, o]
// on a 12 x 12 input and stacked HWIO weights (S, 5, 5, 32, N), read as they
// are (no permute of the weights). Input and output share one memory layout,
// NCHW or channels-last (NHWC), as F.conv2d's do: the trunk's first conv
// hands over its output channels-last (cuDNN's choice for a one-channel
// image), and the backward's library convolutions then see the layouts they
// saw before this kernel.
//
// Replaces no Pallas kernel: the JAX package leaves this convolution to XLA
// (robustbnns_tpu/models/architectures.py, _conv2d_valid). It stands in for
// cuDNN's grouped forward engine, which ran this shape at 9% of its bound.
//
// What bounds it on the H100. Per draw it is a GEMM of M = B*64 output
// pixels, N output channels and K = 25*32 = 800: 2*B*S*64*N*800 FLOP,
// 671 GFLOP at model_0's B = 128, S = 100, N = 512, or 10.0 ms on the FFMA
// pipe at 67 TFLOP/s. Exact f32 rules out the tensor cores (TF32 fails the
// f32 reference's check). The bytes (the input 236 MB, the weights 164 MB,
// the output 1.68 GB) take 0.6 ms at HBM's rate: the FFMA pipe bounds it.
//
// Design: an implicit GEMM per draw, on the FFMA pipe.
// - A block of 256 threads owns 2 images x 64 pixels (M = 128) by 128 output
//   channels (N) of one draw; 8 warps of 64 x 32, each thread an 8 x 8
//   register tile of outer products: per k it reads two float4 of the A
//   column and two of the W row from shared memory for 64 FFMA.
// - The block's input, 2 images x 32 channels x 12 x 12, lands once in
//   shared memory by cp.async: NCHW, an image's 18 KB are contiguous; NHWC,
//   each pixel's 32 channels are one 128-byte line, kept 144 bytes apart in
//   shared memory so that 8 neighbouring pixels' float4 fall in 8 bank groups.
// - K walks the 25 taps (ky, kx), 32 channels each. The weights of a tap
//   (32 rows of 128 contiguous outputs, 16 KB) stream through a two-stage
//   cp.async ring, fetched two taps ahead. Per tap the threads gather the
//   next tap's A tile (32 channels x 128 pixels, 16 KB) from the input patch
//   into the other of two buffers after their FFMAs (16 values a thread
//   against 2,048 FFMA): the shifted windows are never 16-byte aligned, the
//   gathered tile always is. One __syncthreads a tap. 105 KB of shared
//   memory and 128 registers a thread: two blocks an SM.
// - Measured at model_0's shapes (H100, 700 W, the SM clock held at 1980
//   MHz): 13.9 ms, 72% of the bound; bit-identical to cuDNN's channels-last
//   engine, which sums in the same (ky, kx, c) order, at 67 ms.
// - Grid (B/2 * N/128, S), the output-channel tiles fastest: the tiles of
//   one image pair read its patch back to back, and the blocks of one draw
//   run together, so that draw's weights (1.6 MB at N = 512) stay in L2.
// - The epilogue adds the bias and stores float4: along pixels in NCHW (a
//   warp store writes whole 128-byte lines), along channels in NHWC (whole
//   32-byte sectors).
// - Every output is one thread's fixed-order sum (tap by tap, channel by
//   channel, then the bias): no atomics, bit-identical from call to call.
// - B need not be even (a missing second image is zero-filled and not
//   stored); N must be a multiple of 128 (the wrapper sends other widths to
//   the library).
#include "sampled_dense_common.cuh"

namespace grouped_conv {
namespace {

using sampled_dense::cp_async16;
using sampled_dense::cp_async_commit;
using sampled_dense::cp_async_wait_pending;

constexpr int kC = 32;            // input channels a group
constexpr int kTaps = 25;         // 5 x 5
constexpr int kSide = 12;         // input side
constexpr int kOutSide = 8;       // output side
constexpr int kPix = 64;          // output pixels an image
constexpr int kImages = 2;        // images a block
constexpr int kM = kImages * kPix;  // 128 output pixels a block
constexpr int kN = 128;           // output channels a block
constexpr int kThreads = 256;     // 8 warps: 2 (images) x 4 (32-channel slices)
constexpr int kInPix = kSide * kSide;  // 144 input pixels an image
constexpr int kPatch = kC * kInPix;   // 4608 input floats an image, as NCHW holds them
constexpr int kPixStride = kC + 4;    // floats between two pixels of an NHWC patch (144 bytes)
constexpr int kPatchFloats = kImages * kInPix * kPixStride;  // the larger of the two layouts
constexpr int kTile = kC * kM;        // 4096 floats: an A tile, or a W tile (kC x kN)
constexpr int kSmemFloats = kPatchFloats + 4 * kTile;  // patch, two A tiles, two W tiles
constexpr int kSmemBytes = kSmemFloats * 4;  // 107,008
static_assert(kN * kC == kTile, "the W tile is as large as the A tile");
static_assert(kImages * kPatch <= kPatchFloats, "the NCHW patch fits");

// kChannelsLast: x (B, 12, 12, S*32) and out (B, 8, 8, S*N) in memory; else
// x (B, S*32, 12, 12) and out (B, S*N, 8, 8).
template <bool kChannelsLast>
__global__ void __launch_bounds__(kThreads, 2) fwd_kernel(
    const float* __restrict__ x, const float* __restrict__ w,  // w (S, 5, 5, 32, N)
    const float* __restrict__ bias,                           // (S, N)
    float* __restrict__ out, int B, int S, int N) {
  extern __shared__ __align__(16) float smem[];
  float* patch = smem;                     // [kImages][kC][12][12], or [kImages][144][kPixStride]
  float* a_tiles = smem + kPatchFloats;    // [2][kC][kM]
  float* w_tiles = a_tiles + 2 * kTile;    // [2][kC][kN]

  const int tid = threadIdx.x;
  const int n_tiles = N / kN;
  const int n0 = ((int)blockIdx.x % n_tiles) * kN;
  const int b0 = ((int)blockIdx.x / n_tiles) * kImages;
  const int s = blockIdx.y;
  const float* w_s = w + (size_t)s * kTaps * kC * N + n0;  // row (tap, c) at (tap * kC + c) * N

  // The weights of tap t, rows c < 32 and outputs n0 .. n0 + 127, into W buffer buf.
  auto fetch_w = [&](int t, int buf) {
    float* dst = w_tiles + buf * kTile;
    const float* src = w_s + (size_t)t * kC * N;
#pragma unroll
    for (int j = 0; j < kTile / 4 / kThreads; ++j) {
      const int f = tid + j * kThreads, c = f / (kN / 4), q = f % (kN / 4);
      cp_async16(dst + c * kN + 4 * q, src + (size_t)c * N + 4 * q, true);
    }
  };

  // The patch of images b0, b0 + 1 (zeros for an image past B): NCHW, kPatch
  // contiguous floats at channel s*32 of an image; NHWC, 32 contiguous floats
  // at channel s*32 of each pixel.
#pragma unroll
  for (int j = 0; j < kImages * kPatch / 4 / kThreads; ++j) {
    const int f = tid + j * kThreads, i = f / (kPatch / 4), q = f % (kPatch / 4), b = b0 + i;
    const size_t image = (size_t)min(b, B - 1);
    if (kChannelsLast) {
      const int p = q / (kC / 4), c4 = q % (kC / 4);
      cp_async16(patch + (i * kInPix + p) * kPixStride + 4 * c4,
                 x + ((image * kInPix + p) * S + s) * kC + 4 * c4, b < B);
    } else {
      cp_async16(patch + i * kPatch + 4 * q, x + (image * S + s) * kPatch + 4 * q, b < B);
    }
  }
  fetch_w(0, 0);
  cp_async_commit();
  fetch_w(1, 1);
  cp_async_commit();

  // Gather a[c][m] = in[image, c, y + ky, x + kx] of tap t: thread tid writes
  // pixel m = tid % 128, NCHW of channels c0, c0 + 2, ..., c0 + 30 (one load
  // each), NHWC of channel quads c0, c0 + 2, c0 + 4, c0 + 6 (one float4 each).
  const int m = tid % kM, c0 = tid / kM, image = m / kPix;
  const int corner = (m % kPix / kOutSide) * kSide + m % kOutSide;  // the window's input pixel at tap 0
  const float* gather_src = kChannelsLast ? patch + (image * kInPix + corner) * kPixStride + 4 * c0
                                          : patch + image * kPatch + c0 * kInPix + corner;
  auto gather_a = [&](int t, int buf) {
    const int shift = (t / 5) * kSide + t % 5;
    float* dst = a_tiles + buf * kTile + m;
    if (kChannelsLast) {
      const float* src = gather_src + shift * kPixStride;
#pragma unroll
      for (int i = 0; i < kC / 8; ++i) {
        const float4 v = *reinterpret_cast<const float4*>(src + 8 * i);
        const int c = 4 * (c0 + 2 * i);
        dst[c * kM] = v.x;
        dst[(c + 1) * kM] = v.y;
        dst[(c + 2) * kM] = v.z;
        dst[(c + 3) * kM] = v.w;
      }
    } else {
      const float* src = gather_src + shift;
#pragma unroll
      for (int i = 0; i < kC / 2; ++i) dst[(c0 + 2 * i) * kM] = src[2 * i * kInPix];
    }
  };

  cp_async_wait_pending<1>();  // this thread's patch and tap 0 have landed; tap 1 may be in flight
  __syncthreads();
  gather_a(0, 0);
  __syncthreads();

  // FFMA: warp (wm, wn) owns pixels 64 wm .. 64 wm + 63 (image wm) and
  // channels 32 wn .. 32 wn + 31; lane (tm, tn) rows 4tm .. 4tm+3 and
  // 32+4tm .. 32+4tm+3 of them, columns 4tn .. 4tn+3 and 16+4tn .. 16+4tn+3,
  // so a warp's float4 reads touch 8 (A) and 4 (W) distinct addresses.
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp % kImages, wn = warp / kImages;
  const int tm = lane / 4, tn = lane % 4;
  const int row0 = wm * kPix + 4 * tm, col0 = 32 * wn + 4 * tn;
  float acc[8][8] = {};
  for (int t = 0; t < kTaps; ++t) {
    const int buf = t & 1;
    const float* a_t = a_tiles + buf * kTile;
    const float* w_t = w_tiles + buf * kTile;
#pragma unroll 16  // full unrolling costs registers and time (measured)
    for (int k = 0; k < kC; ++k) {
      const float4 a_lo = *reinterpret_cast<const float4*>(a_t + k * kM + row0);
      const float4 a_hi = *reinterpret_cast<const float4*>(a_t + k * kM + row0 + 32);
      const float4 w_lo = *reinterpret_cast<const float4*>(w_t + k * kN + col0);
      const float4 w_hi = *reinterpret_cast<const float4*>(w_t + k * kN + col0 + 16);
      const float av[8] = {a_lo.x, a_lo.y, a_lo.z, a_lo.w, a_hi.x, a_hi.y, a_hi.z, a_hi.w};
      const float wv[8] = {w_lo.x, w_lo.y, w_lo.z, w_lo.w, w_hi.x, w_hi.y, w_hi.z, w_hi.w};
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[r][j] = fmaf(av[r], wv[j], acc[r][j]);
    }
    // Tap t + 1's A tile into the other buffer, whose last readers passed the
    // previous barrier; after the FFMAs, so its loads do not hold them up.
    if (t + 1 < kTaps) gather_a(t + 1, buf ^ 1);
    cp_async_wait_pending<0>();  // tap t + 1's weights (this thread's) have landed
    __syncthreads();             // ... everyone's; tap t's buffers are free; tap t + 1's A tile is gathered
    if (t + 2 < kTaps) {
      fetch_w(t + 2, buf);
      cp_async_commit();
    }
  }

  const int b = b0 + wm;
  if (b >= B) return;
  const float4 bias_lo = *reinterpret_cast<const float4*>(bias + (size_t)s * N + n0 + col0);
  const float4 bias_hi = *reinterpret_cast<const float4*>(bias + (size_t)s * N + n0 + col0 + 16);
  const float bv[8] = {bias_lo.x, bias_lo.y, bias_lo.z, bias_lo.w, bias_hi.x, bias_hi.y, bias_hi.z, bias_hi.w};
  if (kChannelsLast) {  // out[b, pixel, s*N + n0 + n]: rows r < 4 are pixels 4tm + r, the others 28 + 4tm + r
    float* dst = out + (size_t)b * kPix * S * N + (size_t)s * N + n0 + col0;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      float* row = dst + (size_t)(4 * tm + (r < 4 ? r : 28 + r)) * S * N;
      *reinterpret_cast<float4*>(row) =
          make_float4(acc[r][0] + bv[0], acc[r][1] + bv[1], acc[r][2] + bv[2], acc[r][3] + bv[3]);
      *reinterpret_cast<float4*>(row + 16) =
          make_float4(acc[r][4] + bv[4], acc[r][5] + bv[5], acc[r][6] + bv[6], acc[r][7] + bv[7]);
    }
  } else {  // out[b, s*N + n0 + n, pixel]: columns j < 4 are n = col0 + j, the others col0 + 12 + j
    float* dst = out + ((size_t)b * S + s) * N * kPix + (size_t)n0 * kPix;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float* plane = dst + (size_t)(col0 + (j < 4 ? j : 12 + j)) * kPix + 4 * tm;
#pragma unroll
      for (int h = 0; h < 2; ++h)  // rows 4h .. 4h+3: pixels 4tm + 32h .. 4tm + 32h + 3
        *reinterpret_cast<float4*>(plane + 32 * h) = make_float4(
            acc[4 * h][j] + bv[j], acc[4 * h + 1][j] + bv[j], acc[4 * h + 2][j] + bv[j], acc[4 * h + 3][j] + bv[j]);
    }
  }
}

}  // namespace
}  // namespace grouped_conv

// out (B, S*N, 8, 8) = the grouped convolution of x (B, S*32, 12, 12) with
// w (S, 5, 5, 32, N), plus bias (S, N); x and out NCHW, or both channels-last
// (channels_last != 0). N a multiple of 128; every pointer 16-byte aligned.
extern "C" int grouped_conv_fwd(const float* x, const float* w, const float* bias, float* out, int B, int S,
                                int N, int channels_last, void* stream) {
  using namespace grouped_conv;
  const long long blocks_x = (long long)((B + kImages - 1) / kImages) * (N / kN);
  if (B < 1 || S < 1 || S > 65535 || N < kN || N % kN != 0 || blocks_x > 0x7FFFFFFF)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks_x, S);
  const cudaStream_t on = static_cast<cudaStream_t>(stream);
  // above the 48 KB a block gets without asking; set once, before any graph capture
  if (channels_last) {
    static const cudaError_t attr =
        cudaFuncSetAttribute(fwd_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (attr != cudaSuccess) return (int)attr;
    fwd_kernel<true><<<grid, kThreads, kSmemBytes, on>>>(x, w, bias, out, B, S, N);
  } else {
    static const cudaError_t attr =
        cudaFuncSetAttribute(fwd_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (attr != cudaSuccess) return (int)attr;
    fwd_kernel<false><<<grid, kThreads, kSmemBytes, on>>>(x, w, bias, out, B, S, N);
  }
  return (int)cudaGetLastError();
}

// The input gradient of the same convolution: for each draw s, image b, input
// channel c < 32 and input pixel (i, j) < 12 x 12,
//   dx[b, s*32 + c, i, j] = sum_{ky, kx < 5, 0 <= i - ky < 8, 0 <= j - kx < 8}
//       sum_{o < N} g[b, s*N + o, i - ky, j - kx] * w[s, ky, kx, c, o]
// from the output gradient g (B, S*N, 8, 8), NCHW or channels-last, read in
// place, into dx (B, S*32, 12, 12) in g's layout, with the stacked HWIO
// weights read as they are: their last axis, o, is the sum's.
//
// Replaces no Pallas kernel: the JAX package leaves this gradient to XLA. It
// stands in for cuDNN's FFT input gradient (seven kernels a draw: two
// fft2d_r2c passes, a complex GEMM, fft2d_c2r and three layout changes),
// which took 54.8 ms of a PGD iteration at model_0's B = 128, S = 100,
// N = 512: 18% of the bound below.
//
// What bounds it on the H100. The useful work is the forward's: 2*B*S*64*N*800
// FLOP, 671 GFLOP at model_0's shapes, 10.0 ms on the FFMA pipe at 67 TFLOP/s
// (exact f32 rules out the tensor cores). The bytes (g 1.68 GB, dx 236 MB,
// the weights 164 MB) take 0.6 ms at HBM's rate. An implicit GEMM over dx's
// 144 pixels x 25 taps would do 2.25x that work (only 1,600 of its 3,600
// (pixel, tap) pairs fall inside g); this design does none of the rest.
//
// Design: per draw, the GEMM Y[p, (tap, c)] = sum_o g[p, o] * w[tap, c, o]
// over g's pixels p (M = B*64, N' = 25*32 = 800, K = N): exactly the useful
// FLOP, with the col2im dx[p + tap, c] += Y[p, tap, c] in the epilogue.
// - A block of 128 threads an image owns whole images of one draw: two, or
//   one where two-image blocks would not fill every SM twice over. dx's tile,
//   12 x 12 x 32 floats an image, stays in shared memory for the whole sum.
// - Thread (image, output row y, channel pair) holds Y for the 8 pixels of
//   row y, the 5 taps of one tap row ky and its 2 channels: an 8 x 10 register
//   tile of outer products, 80 FFMA a k for two float4 of g and three float4
//   of w (a pair's 10 columns, padded to 12) from shared memory.
// - The stages walk the tap rows ky = 0 .. 4, and within each the sum's N
//   channels 16 an image at a time: g's tile, (16 x images) o by (images x
//   64) pixels (16-byte copies NCHW, 4-byte copies that transpose it
//   channels-last), and w's tile of tap row ky, o by 160 (c, kx) (4-byte
//   copies that transpose it), land by cp.async in a ring of three stages,
//   two ahead. One __syncthreads a stage; a block reads its images' g once a
//   tap row, from L2 or HBM.
// - After a tap row, the col2im from registers: dx row y + ky, column j gets
//   the thread's Y at pixel j - kx and tap kx, summed over kx in order, for
//   its 2 channels. Within a tap row no other thread writes that row; the
//   thread of row y - 1 writes it a tap row later, a barrier a stage on.
// - Grid (image groups, S), image groups fastest, so the blocks of one draw
//   run together and its weights (1.6 MB at N = 512) stay in L2.
// - Every dx element is one fixed-order sum from zero: tap row by tap row,
//   tap by tap, each tap's N products in order. No atomics: bit-identical
//   from call to call.
// - Two-image blocks: 160 KB of shared memory and about 200 registers a
//   thread, one block an SM; one-image blocks: 68 KB and about 250, two. (A
//   cap of 128 registers, two two-image blocks an SM with stages of 16 o,
//   spilled and took 18.0 ms at model_0's shapes against 16.9; stages of 32 o
//   for one-image blocks, 0.38 ms at S = 1 against 0.25.)
// - Measured at model_0's B = 128, S = 100, N = 512 (H100, 700 W): 16.9 ms
//   channels-last, 15.9 ms NCHW, 59-63% of the bound; 2.8x faster than
//   cuDNN's FFT input gradient channels-last (47.1 ms), 5.2x NCHW (83.1).
// - B need not be even (a missing second image reads the last image's g and
//   is not stored); N must be a multiple of 32.
namespace grouped_conv_dx {
namespace {

using sampled_dense::cp_async16;
using sampled_dense::cp_async4;
using sampled_dense::cp_async_commit;
using sampled_dense::cp_async_wait_pending;

constexpr int kC = 32;          // dx's channels a draw
constexpr int kK = 5;           // the filter's side
constexpr int kSide = 12;       // dx's side
constexpr int kOutSide = 8;     // g's side
constexpr int kPix = kOutSide * kOutSide;
constexpr int kInPix = kSide * kSide;
constexpr int kStages = 3;
constexpr int kPairCols = 12;  // a channel pair's columns in w's tile: c1 * 5 + kx, then 2 unused
constexpr int kWRow = kC / 2 * kPairCols + 4;  // w's tile row (one o), padded
constexpr int kDxRow = kSide * kC + 16;  // dx's tile row: [j][c], padded
constexpr int kDxImage = kSide * kDxRow;

template <int kImages>
struct Tile {
  static constexpr int kThreads = 128 * kImages;  // (image, output row, channel pair)
  static constexpr int kStep = 16 * kImages;      // the sum's channels a stage
  static constexpr int kM = kImages * kPix;       // g's pixels a block
  static constexpr int kARow = kM + 4;            // g's tile row (one o), padded
  static constexpr int kStage = kStep * (kARow + kWRow);
  static constexpr int kSmemBytes = (kStages * kStage + kImages * kDxImage) * 4;  // 164,352 for two images
  // g's 4-byte copies, 8 o by 4 pixels, hit 32 banks; a warp's float2
  // updates of dx's tile (8 channel pairs by 2 rows a half) none twice
  static_assert(kARow % 32 == 4 && kWRow % 32 == 4 && kDxRow % 32 == 16, "bank spreads");
};

// kChannelsLast: g (B, 8, 8, S*N) and dx (B, 12, 12, S*32) in memory; else
// g (B, S*N, 8, 8) and dx (B, S*32, 12, 12).
template <int kImages, bool kChannelsLast>
__global__ void __launch_bounds__(Tile<kImages>::kThreads, 2 / kImages) dgrad_kernel(
    const float* __restrict__ g, const float* __restrict__ w,  // w (S, 5, 5, 32, N)
    float* __restrict__ dx, int B, int S, int N) {
  using T = Tile<kImages>;
  constexpr int kThreads = T::kThreads, kStep = T::kStep, kRowLanes = kThreads / 8;
  extern __shared__ __align__(16) float smem[];
  float* dx_tile = smem + kStages * T::kStage;  // [image][i][j * 32 + c], rows kDxRow apart

  const int tid = threadIdx.x, s = blockIdx.y;
  const int b0 = (int)blockIdx.x * kImages;
  const int row_steps = N / kStep, steps = kK * row_steps;

  // Stage t: tap row t / row_steps, the sum's channels o0 .. o0 + kStep - 1,
  // into buffer buf: g's tile [o][image * 64 + pixel] and w's [o][pair * 12 +
  // c1 * 5 + kx] for channel c = 2 pair + c1. The
  // transposing 4-byte copies take 8 o by kThreads / 8 rows, so a warp reads
  // 32-byte runs of o.
  const int o_lane = tid % 8, row_lane = tid / 8;
  auto fetch = [&](int t, int buf) {
    const int ky = t / row_steps, o0 = (t % row_steps) * kStep;
    float* a = smem + buf * T::kStage;
    float* wt = a + kStep * T::kARow;
    if (kChannelsLast) {  // g[b, pixel, s*N + o]
#pragma unroll
      for (int h = 0; h < kStep / 8; ++h)
#pragma unroll
        for (int q = 0; q < T::kM / kRowLanes; ++q) {
          const int m = row_lane + kRowLanes * q, image = kImages == 2 ? q / 2 : 0;
          const size_t b = (size_t)min(b0 + image, B - 1);
          cp_async4(a + (8 * h + o_lane) * T::kARow + m,
                    g + ((b * kPix + m - kPix * image) * S + s) * N + o0 + 8 * h + o_lane);
        }
    } else {  // g[b, s*N + o, pixel]: an image's 64 pixels of one o are contiguous
      constexpr int kCopies = kStep * kImages * kPix / 4;
#pragma unroll
      for (int j = 0; j < kCopies / kThreads; ++j) {
        const int f = tid + j * kThreads, q = f % (kPix / 4), image = f / (kPix / 4) % kImages;
        const int o = f / (kPix / 4 * kImages);
        const size_t b = (size_t)min(b0 + image, B - 1);
        cp_async16(a + o * T::kARow + image * kPix + 4 * q, g + ((b * S + s) * N + o0 + o) * kPix + 4 * q, true);
      }
    }
    // w[s, ky, kx, c, o]: row (kx, c) of tap row ky
    const float* w_ky = w + ((size_t)s * kK + ky) * kK * kC * N + o0 + o_lane;
#pragma unroll
    for (int h = 0; h < kStep / 8; ++h)
#pragma unroll
      for (int q = 0; q < kC / kRowLanes; ++q)
#pragma unroll
        for (int kx = 0; kx < kK; ++kx) {
          const int c = row_lane + kRowLanes * q;
          cp_async4(wt + (8 * h + o_lane) * kWRow + c / 2 * kPairCols + c % 2 * kK + kx,
                    w_ky + (size_t)(kx * kC + c) * N + 8 * h);
        }
  };

  // This thread's Y: image img, output row y, channels 2 cp and 2 cp + 1. A
  // warp holds 8 channel pairs of 4 rows: its float4 reads of g touch 4
  // addresses and those of w 8, on distinct banks.
  const int warp = tid / 32, lane = tid % 32;
  const int cp = (warp % 2) * 8 + lane % 8, y = (warp / 2 % 2) * 4 + lane / 8, img = warp / 4;

  for (int f = tid; f < kImages * kDxImage / 4; f += kThreads)
    reinterpret_cast<float4*>(dx_tile)[f] = make_float4(0.f, 0.f, 0.f, 0.f);
  fetch(0, 0);
  cp_async_commit();
  fetch(1, 1);  // steps >= 5
  cp_async_commit();

  float acc[8][10] = {};  // [pixel of row y][c1 * 5 + kx] for channel 2 cp + c1
  for (int t = 0; t < steps; ++t) {
    cp_async_wait_pending<1>();  // this thread's copies of stage t have landed; t + 1's may be in flight
    __syncthreads();             // ... everyone's; everyone is done with stage t - 1's buffer
    if (t + 2 < steps) fetch(t + 2, (t + 2) % kStages);
    cp_async_commit();  // one group a stage, empty at the end
    const float* a = smem + (t % kStages) * T::kStage + img * kPix + y * 8;
    const float* wt = smem + (t % kStages) * T::kStage + kStep * T::kARow + kPairCols * cp;
#pragma unroll
    for (int k = 0; k < kStep; ++k) {
      const float4 a_lo = *reinterpret_cast<const float4*>(a + k * T::kARow);
      const float4 a_hi = *reinterpret_cast<const float4*>(a + k * T::kARow + 4);
      const float av[8] = {a_lo.x, a_lo.y, a_lo.z, a_lo.w, a_hi.x, a_hi.y, a_hi.z, a_hi.w};
      float wv[kPairCols];
#pragma unroll
      for (int u = 0; u < kPairCols / 4; ++u) {
        const float4 v = *reinterpret_cast<const float4*>(wt + k * kWRow + 4 * u);
        wv[4 * u] = v.x;
        wv[4 * u + 1] = v.y;
        wv[4 * u + 2] = v.z;
        wv[4 * u + 3] = v.w;
      }
#pragma unroll
      for (int x = 0; x < 8; ++x)
#pragma unroll
        for (int r = 0; r < 10; ++r) acc[x][r] = fmaf(av[x], wv[r], acc[x][r]);
    }
    if ((t + 1) % row_steps == 0) {  // tap row ky summed: its col2im into dx row y + ky, then a fresh sum
      float* dst = dx_tile + img * kDxImage + (y + t / row_steps) * kDxRow + 2 * cp;
#pragma unroll
      for (int j = 0; j < kSide; ++j) {
        float lo = 0.f, hi = 0.f;
#pragma unroll
        for (int kx = 0; kx < kK; ++kx) {
          if (j - kx < 0 || j - kx >= kOutSide) continue;
          lo += acc[j - kx][kx];
          hi += acc[j - kx][kK + kx];
        }
        float2* cell = reinterpret_cast<float2*>(dst + j * kC);
        const float2 v = *cell;
        *cell = make_float2(v.x + lo, v.y + hi);
      }
#pragma unroll
      for (int x = 0; x < 8; ++x)
#pragma unroll
        for (int r = 0; r < 10; ++r) acc[x][r] = 0.f;
    }
  }
  __syncthreads();  // every tap row's col2im is in dx's tile

  if (kChannelsLast) {  // dx[b, pixel, s*32 + c]: a pixel's 32 channels, 8 float4
    for (int f = tid; f < kImages * kInPix * (kC / 4); f += kThreads) {
      const int q = f % (kC / 4), pixel = f / (kC / 4) % kInPix, image = f / (kC / 4 * kInPix);
      const size_t b = (size_t)(b0 + image);
      if (b0 + image >= B) break;
      const float* src = dx_tile + image * kDxImage + pixel / kSide * kDxRow + pixel % kSide * kC + 4 * q;
      *reinterpret_cast<float4*>(dx + ((b * kInPix + pixel) * S + s) * kC + 4 * q) =
          *reinterpret_cast<const float4*>(src);
    }
  } else {  // dx[b, s*32 + c, i, j]: a channel's plane, float4 along j
    for (int f = tid; f < kImages * kC * kInPix / 4; f += kThreads) {
      const int q = f % (kInPix / 4), c = f / (kInPix / 4) % kC, image = f / (kInPix / 4 * kC);
      const size_t b = (size_t)(b0 + image);
      if (b0 + image >= B) break;
      const float* src = dx_tile + image * kDxImage + q / 3 * kDxRow + 4 * (q % 3) * kC + c;
      *reinterpret_cast<float4*>(dx + ((b * S + s) * kC + c) * kInPix + 4 * q) =
          make_float4(src[0], src[kC], src[2 * kC], src[3 * kC]);
    }
  }
}

template <int kImages, bool kChannelsLast>
int launch(const float* g, const float* w, float* dx, int B, int S, int N, cudaStream_t on) {
  using T = Tile<kImages>;
  // above the 48 KB a block gets without asking; set once, before any graph capture
  static const cudaError_t attr = cudaFuncSetAttribute(dgrad_kernel<kImages, kChannelsLast>,
                                                       cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((unsigned)((B + kImages - 1) / kImages), S);
  dgrad_kernel<kImages, kChannelsLast><<<grid, T::kThreads, T::kSmemBytes, on>>>(g, w, dx, B, S, N);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace grouped_conv_dx

// dx (B, S*32, 12, 12) = the input gradient of that convolution from g (B,
// S*N, 8, 8) and w (S, 5, 5, 32, N); g and dx NCHW, or both channels-last
// (channels_last != 0). N a multiple of 32; every pointer 16-byte aligned.
// sms: the card's SMs; blocks take two images where that gives each SM two
// blocks, else one.
extern "C" int grouped_conv_dgrad(const float* g, const float* w, float* dx, int B, int S, int N,
                                  int channels_last, int sms, void* stream) {
  using namespace grouped_conv_dx;
  if (B < 1 || S < 1 || S > 65535 || N < 32 || N % 32 != 0 || sms < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t on = static_cast<cudaStream_t>(stream);
  if ((long long)((B + 1) / 2) * S >= 2LL * sms)
    return channels_last ? launch<2, true>(g, w, dx, B, S, N, on) : launch<2, false>(g, w, dx, B, S, N, on);
  return channels_last ? launch<1, true>(g, w, dx, B, S, N, on) : launch<1, false>(g, w, dx, B, S, N, on);
}
