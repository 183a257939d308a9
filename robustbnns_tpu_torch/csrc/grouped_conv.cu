// The conv trunk's second convolution, grouped by draw: for each draw s,
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
