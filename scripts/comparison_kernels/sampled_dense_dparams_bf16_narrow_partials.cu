// The earlier design of the narrow (O <= 16) bf16 parameter-gradient
// kernels, the 10-class head of _bwd_xs_dparams_kernel and
// _bwd_dparams_kernel (robustbnns_tpu/ops/sampled_dense.py:383, :137) under
// Precision.DEFAULT, kept only to time the current one
// (robustbnns_tpu_torch/csrc/sampled_dense_dparams_bf16.cu) against it in one
// process: chip_smoke.py's [precision] and scripts/torch_dx_probe.py
// --dparams-bf16-head build it with the port's nvcc flags and
// -I robustbnns_tpu_torch/csrc. No entry point of the port reaches it. On
// dparams_plan's narrow geometry:
// - a block of 64 threads (2 warps) owns 32 inputs and a run of samples; warp
//   w the m16 tile of inputs 16w .. 16w+15 against the two n8 tiles of outputs
//   0 .. 15 (mma.sync.m16n8k16; M the inputs, N the outputs, K the batch
//   rows);
// - per 32-row chunk it rounds x_s and g_s to bf16 and transposes them into
//   shared memory (batch-contiguous rows of 40 bf16) with plain loads, two
//   barriers a chunk; after each sample a lane pair shares each Philox quad
//   through __shfl_xor_sync; running sums in registers;
// - its runs write partial planes (bias in row I) that the f32 kernel's
//   second pass sums in the order 0 .. n_split-1 (sampled_dense_passes.cuh);
//   with one run a block writes the outputs itself;
// - the bias: input block 0 also stages g in f32, and thread q < ceil(O / 4)
//   sums outputs 4q .. 4q+3 in row order and draws their quad once.
#include "sampled_dense_mma.cuh"
#include "sampled_dense_passes.cuh"

namespace sampled_dense {
namespace {

constexpr int kDepth = 32;            // batch rows a chunk
constexpr int kStride = kDepth + 8;   // bf16 a staged row
constexpr int kNarrowO = 16;          // the narrow path takes O <= kNarrowO
constexpr int kNarrowThreads = 64;    // 2 warps of 16 inputs each
constexpr int kNarrowCols = 32;       // inputs i of a narrow block

__device__ __forceinline__ void run_samples(int S, int run, int n_split, int& s_begin, int& s_end) {
  s_begin = (int)((long long)S * run / n_split);
  s_end = (int)((long long)S * (run + 1) / n_split);
}

// Rows b0 .. b0+kDepth-1, columns c0 .. c0+kCols-1 of a row-major (B, n)
// matrix, rounded to bf16 and transposed into dst[column][row - b0] (stride
// kStride), zero past B and n; where f32_rows is given, also unrounded into
// f32_rows[row - b0][column] (stride kCols + 4). Item f: the rows 2p, 2p + 1
// of column quad q.
template <int kCols, int kThreadsHere>
__device__ __forceinline__ void stage_t(uint16_t* __restrict__ dst, float* __restrict__ f32_rows,
                                        const float* __restrict__ src, int B, int n, int b0, int c0) {
  constexpr int kRowPairs = kDepth / 2, kQuads = kCols / 4;
  const bool vec = (n & 3) == 0;
  for (int f = threadIdx.x; f < kRowPairs * kQuads; f += kThreadsHere) {
    const int p = f % kRowPairs, q = f / kRowPairs, b = b0 + 2 * p, c = c0 + 4 * q;
    float4 v[2] = {make_float4(0.f, 0.f, 0.f, 0.f), make_float4(0.f, 0.f, 0.f, 0.f)};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (b + h >= B) continue;
      const float* row = src + (size_t)(b + h) * n;
      if (vec) {
        if (c < n) v[h] = *reinterpret_cast<const float4*>(row + c);
      } else {
        v[h] = load4(row, c, n);
      }
    }
    uint32_t* out = reinterpret_cast<uint32_t*>(dst + 4 * q * kStride + 2 * p);
    out[0] = pack_bf16(v[0].x, v[1].x);
    out[kStride / 2] = pack_bf16(v[0].y, v[1].y);
    out[kStride] = pack_bf16(v[0].z, v[1].z);
    out[3 * kStride / 2] = pack_bf16(v[0].w, v[1].w);
    if (f32_rows) {
      *reinterpret_cast<float4*>(f32_rows + 2 * p * (kCols + 4) + 4 * q) = v[0];
      *reinterpret_cast<float4*>(f32_rows + (2 * p + 1) * (kCols + 4) + 4 * q) = v[1];
    }
  }
}

// eps for the accumulator pair of n8 tiles (2m, 2m + 1) of one row i, for a
// lane whose tile columns start at o_base + 2tq: e[t] holds the two normals of
// tile 2m + t. Lane tq draws the quad of tile 2m + (tq & 1) and trades halves
// with lane tq ^ 1, so each quad is drawn once. Every lane of the warp calls it.
__device__ __forceinline__ void noise_pair(uint32_t seed, int s, int i, int q_base, int m, int tq, float2 (&e)[2]) {
  const bool odd = tq & 1;
  const float4 z = normal4(seed, s, i, q_base + 2 * (2 * m + odd) + (tq >> 1));
  const float r0 = __shfl_xor_sync(0xffffffffu, odd ? z.x : z.z, 1);
  const float r1 = __shfl_xor_sync(0xffffffffu, odd ? z.y : z.w, 1);
  e[0] = odd ? make_float2(r0, r1) : make_float2(z.x, z.y);
  e[1] = odd ? make_float2(z.z, z.w) : make_float2(r0, r1);
}

// O <= 16: a block owns 32 inputs and a run of samples; warp w the inputs
// 16w .. 16w+15 of dW_s against outputs 0 .. 15 (two n8 tiles). Block x is the
// input block, y the run.
template <bool kPerSampleX>
__global__ void __launch_bounds__(kNarrowThreads) dparams_bf16_narrow_kernel(
    const float* __restrict__ g, const float* __restrict__ x, const float* __restrict__ rho,
    const float* __restrict__ brho, float* __restrict__ partials, float* __restrict__ dloc,
    float* __restrict__ drho, float* __restrict__ dbloc, float* __restrict__ dbrho, int S, int B,
    int I, int O, uint32_t seed, int n_split) {
  __shared__ __align__(16) uint16_t as[kNarrowCols * kStride];  // xs[s] rows, k = b
  __shared__ __align__(16) uint16_t bs[kNarrowO * kStride];     // g[s] rows, k = b
  __shared__ __align__(16) float gf_rows[kDepth * (kNarrowO + 4)];  // g[s] in f32, input block 0

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32, gq = lane / 4, tq = lane % 4;
  const int i0 = blockIdx.x * kNarrowCols, run = blockIdx.y;
  int s_begin, s_end;
  run_samples(S, run, n_split, s_begin, s_end);
  const int C = (B + kDepth - 1) / kDepth;
  const bool bias = blockIdx.x == 0 && 4 * tid < O;  // outputs 4 tid .. 4 tid + 3 of the bias row

  // sum_loc[t][2h + j]: input 16 warp + 8h + gq, output 8t + 2tq + j
  float sum_loc[2][4] = {}, sum_rho[2][4] = {}, bias_loc[4] = {}, bias_rho[4] = {};
  for (int s = s_begin; s < s_end; ++s) {
    const float* xs = kPerSampleX ? x + (size_t)s * B * I : x;
    const float* gs = g + (size_t)s * B * O;
    float acc[2][4] = {}, db[4] = {};
    for (int c = 0; c < C; ++c) {
      const int b0 = c * kDepth;
      __syncthreads();  // the previous chunk is consumed
      stage_t<kNarrowCols, kNarrowThreads>(as, nullptr, xs, B, I, b0, i0);
      stage_t<kNarrowO, kNarrowThreads>(bs, blockIdx.x == 0 ? gf_rows : nullptr, gs, B, O, b0, 0);
      __syncthreads();
#pragma unroll
      for (int k0 = 0; k0 < kDepth; k0 += 16) {
        const uint16_t* pa = as + (16 * warp + gq) * kStride + k0 + 2 * tq;
        const uint32_t a[4] = {smem_word(pa), smem_word(pa + 8 * kStride), smem_word(pa + 8),
                               smem_word(pa + 8 * kStride + 8)};
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const uint16_t* pb = bs + (8 * nt + gq) * kStride + k0 + 2 * tq;
          const uint32_t b[2] = {smem_word(pb), smem_word(pb + 8)};
          mma_bf16_16816(acc[nt], a, b);
        }
      }
      if (bias) {
        const int rows = min(kDepth, B - b0);
        for (int k = 0; k < rows; ++k) {
          const float* row = gf_rows + k * (kNarrowO + 4);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (4 * tid + j < O) db[j] += row[4 * tid + j];
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float2 e[2];
      noise_pair(seed, s, i0 + 16 * warp + 8 * h + gq, 0, 0, tq, e);
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const float d0 = acc[t][2 * h], d1 = acc[t][2 * h + 1];
        sum_loc[t][2 * h] += d0, sum_loc[t][2 * h + 1] += d1;
        sum_rho[t][2 * h] += d0 * e[t].x, sum_rho[t][2 * h + 1] += d1 * e[t].y;
      }
    }
    if (bias) {
      const float4 z = normal4(seed, s, I, tid);
      const float e[4] = {z.x, z.y, z.z, z.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        bias_loc[j] += db[j];
        bias_rho[j] += db[j] * e[j];
      }
    }
  }

  const bool split = n_split > 1;
  const size_t plane = (size_t)(I + 1) * O;
  float* out_loc = split ? partials + 2 * run * plane : dloc;
  float* out_rho = split ? out_loc + plane : drho;
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = i0 + 16 * warp + 8 * (k / 2) + gq, o = 8 * t + 2 * tq + k % 2;
      if (i >= I || o >= O) continue;
      const size_t at = (size_t)i * O + o;
      out_loc[at] = sum_loc[t][k];
      out_rho[at] = split ? sum_rho[t][k] : sum_rho[t][k] * sigmoid(rho[at]);
    }
  if (bias) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = 4 * tid + j;
      if (o >= O) continue;
      if (split) {
        out_loc[(size_t)I * O + o] = bias_loc[j];
        out_rho[(size_t)I * O + o] = bias_rho[j];
      } else {
        dbloc[o] = bias_loc[j];
        dbrho[o] = bias_rho[j] * sigmoid(brho[o]);
      }
    }
  }
}

// The narrow kernel with n_split runs of samples per input block and, when
// n_split > 1, the fixed-order sum of its partials into the four outputs.
template <bool kPerSampleX>
int launch_narrow(const float* g, const float* x, const float* rho, const float* brho, float* partials,
                  float* dloc, float* drho, float* dbloc, float* dbrho, int S, int B, int I, int O, uint32_t seed,
                  int n_split, cudaStream_t stream) {
  if (S < 1 || B < 1 || I < 1 || O < 1 || O > kNarrowO || n_split < 1 || n_split > S || n_split > 65535 ||
      (n_split > 1 && !partials))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((I + kNarrowCols - 1) / kNarrowCols, n_split);
  dparams_bf16_narrow_kernel<kPerSampleX><<<grid, kNarrowThreads, 0, stream>>>(
      g, x, rho, brho, partials, dloc, drho, dbloc, dbrho, S, B, I, O, seed, n_split);
  if (n_split > 1) {
    const long long n = (long long)(I + 1) * O;
    sum_dparams_kernel<<<elementwise_blocks(n), 256, 0, stream>>>(partials, rho, brho, dloc, drho, dbloc,
                                                                  dbrho, I, O, n_split);
  }
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace sampled_dense

// Shared input x (B, I), O <= 16, on dparams_plan's narrow geometry.
// partials: an (n_split, 2, I + 1, O) scratch when n_split > 1.
extern "C" int sampled_dense_dparams_bf16_partials(const float* g, const float* x, const float* rho,
                                                   const float* brho, float* partials, float* dloc, float* drho,
                                                   float* dbloc, float* dbrho, int S, int B, int I, int O,
                                                   uint32_t seed, int n_split, void* stream) {
  return sampled_dense::launch_narrow<false>(g, x, rho, brho, partials, dloc, drho, dbloc, dbrho, S, B, I, O, seed,
                                             n_split, static_cast<cudaStream_t>(stream));
}

// Per-sample input xs (S, B, I). As sampled_dense_dparams_bf16_partials.
extern "C" int sampled_dense_xs_dparams_bf16_partials(const float* g, const float* xs, const float* rho,
                                                      const float* brho, float* partials, float* dloc,
                                                      float* drho, float* dbloc, float* dbrho, int S, int B, int I,
                                                      int O, uint32_t seed, int n_split, void* stream) {
  return sampled_dense::launch_narrow<true>(g, xs, rho, brho, partials, dloc, drho, dbloc, dbrho, S, B, I, O, seed,
                                            n_split, static_cast<cudaStream_t>(stream));
}
