// The earlier design of the wide (O > 16) bf16 parameter-gradient kernel,
// kept only to time the current one (robustbnns_tpu_torch/csrc/
// sampled_dense_dparams_bf16.cu) against it in one process: chip_smoke.py's
// [precision] and scripts/torch_dx_probe.py --dparams-bf16 build it with the
// port's nvcc flags and -I robustbnns_tpu_torch/csrc. No entry point of the
// port reaches it. It computes what the current kernel computes, on the same
// plan (dparams_bf16_plan, wide path):
// - a block of 128 threads (4 warps) owns a 128-input x 64-output tile and
//   walks a run of samples; per 32-row chunk of the batch it loads x_s and g_s
//   with plain loads and stores them rounded to bf16 and transposed
//   (batch-contiguous) into shared memory, two barriers a chunk, then
//   mma.sync.m16n8k16 (M the inputs, N the outputs, K the batch rows);
// - after a sample's last chunk each lane draws the Philox quads of its
//   outputs (a lane pair shares a quad through __shfl_xor_sync) and adds dW_s
//   and dW_s * eps_s into running sums in shared memory (64 KB of the block's
//   88 KB: two blocks an SM);
// - the bias from the blocks of input tile 0 on the unrounded g, in row order;
// - the runs of a tile one cluster, summed in the order 0 .. n_split-1
//   through distributed shared memory, sigmoid applied at the store.
#include <cooperative_groups.h>

#include "sampled_dense_common.cuh"
#include "sampled_dense_mma.cuh"

namespace sampled_dense {
namespace {

constexpr int kDepth = 32;            // batch rows a chunk
constexpr int kStride = kDepth + 8;   // bf16 a staged row
constexpr int kWideRows = 128;        // inputs i of a wide block
constexpr int kWideCols = 64;         // outputs o of a wide block
constexpr int kWideThreads = kMmaThreads;
constexpr int kMaxRuns = 8;           // runs of a tile, one cluster: the portable cluster size
constexpr int kPairs = 2 * 2 * 8;     // (m tile, row half, n tile) accumulator pairs of a wide thread
constexpr int kSumFloats = 2 * 2 * kPairs * kWideThreads;  // dloc's and drho's float2 running sums
constexpr int kBiasFloats = 2 * kWideCols;
constexpr int kGfStride = kWideCols + 4;  // floats a row of the f32 g chunk
constexpr int kGfFloats = kDepth * kGfStride;
constexpr int kStageFloats = (kWideRows + kWideCols) * kStride / 2;
constexpr int kWideSmemBytes = (kSumFloats + kBiasFloats + kGfFloats + kStageFloats) * (int)sizeof(float);

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

// One 128-input x 64-output tile over a run of samples. Block x is the output
// tile, y the input tile, z the run; the n_split runs of a tile are one
// thread-block cluster, and rank r of it is run r.
template <bool kPerSampleX>
__global__ void __launch_bounds__(kWideThreads, 2) dparams_bf16_wide_kernel(
    const float* __restrict__ g,     // (S, B, O)
    const float* __restrict__ x,     // (B, I), or (S, B, I) with kPerSampleX
    const float* __restrict__ rho,   // (I, O)
    const float* __restrict__ brho,  // (O,)
    float* __restrict__ dloc, float* __restrict__ drho, float* __restrict__ dbloc,
    float* __restrict__ dbrho, int S, int B, int I, int O, uint32_t seed, int n_split) {
  // All of it dynamic (kWideSmemBytes): the running sums, thread t's float2
  // pair p at [p * kWideThreads + t] (p < kPairs dloc's, then drho's); the
  // bias sums of the run; the f32 g chunk of input tile 0's blocks; the
  // staged chunk, As[i][b] then Bs[o][b].
  extern __shared__ __align__(16) float dyn[];
  float2* const sums = reinterpret_cast<float2*>(dyn) + threadIdx.x;
  float* const bias_sums = dyn + kSumFloats;  // [2][kWideCols]
  float* const gf = blockIdx.y == 0 ? bias_sums + kBiasFloats : nullptr;  // [kDepth][kGfStride]
  uint16_t* const as = reinterpret_cast<uint16_t*>(dyn + kSumFloats + kBiasFloats + kGfFloats);
  uint16_t* const bs = as + kWideRows * kStride;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32, gq = lane / 4, tq = lane % 4;
  const int o0 = blockIdx.x * kWideCols, i0 = blockIdx.y * kWideRows, run = blockIdx.z;
  int s_begin, s_end;
  run_samples(S, run, n_split, s_begin, s_end);
  const int C = (B + kDepth - 1) / kDepth;  // chunks of one sample
  const bool bias = blockIdx.y == 0 && tid < kWideCols && o0 + tid < O;  // column o0 + tid of the bias row

#pragma unroll 1
  for (int p = 0; p < 2 * kPairs; ++p) sums[p * kWideThreads] = make_float2(0.f, 0.f);

  float acc[2][kWideCols / 8][4] = {};
  float bias_loc = 0.f, bias_rho = 0.f;
  for (int s = s_begin; s < s_end; ++s) {
    const float* xs = kPerSampleX ? x + (size_t)s * B * I : x;
    const float* gs = g + (size_t)s * B * O;
    float db = 0.f;
    for (int c = 0; c < C; ++c) {
      const int b0 = c * kDepth;
      __syncthreads();  // the previous chunk is consumed
      stage_t<kWideRows, kWideThreads>(as, nullptr, xs, B, I, b0, i0);
      stage_t<kWideCols, kWideThreads>(bs, gf, gs, B, O, b0, o0);
      __syncthreads();
      mma_chunk<kWideCols, kDepth>(as, bs, acc);
      if (bias) {
        const int rows = min(kDepth, B - b0);
        for (int k = 0; k < rows; ++k) db += gf[k * kGfStride + tid];
      }
    }
    // dW_s and dW_s * eps_s into the running sums, accumulator row r = 2 m
    // tile + row half (inputs 8r + gq of the warp's 32) a step; the rows then
    // shift up by one. Past I or O, dW_s is zero and the sums are never stored.
#pragma unroll 1
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + warp * kMmaWarpRows + 8 * r + gq;
#pragma unroll
      for (int m = 0; m < kWideCols / 16; ++m) {
        float2 e[2];
        noise_pair(seed, s, i, o0 >> 2, m, tq, e);
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int n = 2 * m + t;
          float2& l = sums[(8 * r + n) * kWideThreads];
          float2& v = sums[(kPairs + 8 * r + n) * kWideThreads];
          const float d0 = acc[0][n][0], d1 = acc[0][n][1];
          l.x += d0, l.y += d1;
          v.x += d0 * e[t].x, v.y += d1 * e[t].y;
        }
      }
#pragma unroll
      for (int n = 0; n < kWideCols / 8; ++n) {
        acc[0][n][0] = acc[0][n][2], acc[0][n][1] = acc[0][n][3];
        acc[0][n][2] = acc[1][n][0], acc[0][n][3] = acc[1][n][1];
        acc[1][n][0] = acc[1][n][2], acc[1][n][1] = acc[1][n][3];
        acc[1][n][2] = 0.f, acc[1][n][3] = 0.f;
      }
    }
    if (bias) {
      const int o = o0 + tid;
      bias_loc += db;
      bias_rho += db * component(normal4(seed, s, I, o >> 2), o & 3);
    }
  }

  // The runs of the tile are one cluster: after they all end, rank r sums
  // pairs [kPairs r / n_split, kPairs (r + 1) / n_split) of every thread's
  // running sums over the ranks in the order 0 .. n_split-1 through
  // distributed shared memory, scales drho by sigmoid(rho) and stores; rank 0
  // also the bias. The second cluster barrier keeps each block's shared memory
  // alive until the others have read it.
  if (bias) bias_sums[tid] = bias_loc, bias_sums[kWideCols + tid] = bias_rho;
  const cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  cluster.sync();
#pragma unroll 1
  for (int p = kPairs * run / n_split; p < kPairs * (run + 1) / n_split; ++p) {
    const float2* const first = cluster.map_shared_rank(sums, 0);
    float2 l = first[p * kWideThreads], v = first[(kPairs + p) * kWideThreads];
    for (int k = 1; k < n_split; ++k) {
      const float2* const peer = cluster.map_shared_rank(sums, k);
      const float2 lp = peer[p * kWideThreads], vp = peer[(kPairs + p) * kWideThreads];
      l.x += lp.x, l.y += lp.y;
      v.x += vp.x, v.y += vp.y;
    }
    const int i = i0 + warp * kMmaWarpRows + 8 * (p / 8) + gq, o = o0 + 8 * (p % 8) + 2 * tq;
    if (i >= I) continue;
    const size_t at = (size_t)i * O + o;
    if (o < O) dloc[at] = l.x, drho[at] = v.x * sigmoid(rho[at]);
    if (o + 1 < O) dloc[at + 1] = l.y, drho[at + 1] = v.y * sigmoid(rho[at + 1]);
  }
  if (run == 0 && bias) {
    float l = bias_sums[tid], v = bias_sums[kWideCols + tid];  // rank 0's own
    for (int k = 1; k < n_split; ++k) {
      const float* const peer = cluster.map_shared_rank(bias_sums, k);
      l += peer[tid], v += peer[kWideCols + tid];
    }
    dbloc[o0 + tid] = l;
    dbrho[o0 + tid] = v * sigmoid(brho[o0 + tid]);
  }
  cluster.sync();
}


template <bool kPerSampleX>
int launch_wide(const float* g, const float* x, const float* rho, const float* brho, float* dloc, float* drho,
                float* dbloc, float* dbrho, int S, int B, int I, int O, uint32_t seed, int n_split,
                cudaStream_t stream) {
  const int tiles_x = (O + kWideCols - 1) / kWideCols, tiles_y = (I + kWideRows - 1) / kWideRows;
  if (S < 1 || B < 1 || I < 1 || O <= 16 || n_split < 1 || n_split > S || tiles_y > 65535 || n_split > kMaxRuns)
    return (int)cudaErrorInvalidValue;
  // above the 48 KB a block gets without asking; set once, before any graph capture
  static const cudaError_t attr = cudaFuncSetAttribute(
      dparams_bf16_wide_kernel<kPerSampleX>, cudaFuncAttributeMaxDynamicSharedMemorySize, kWideSmemBytes);
  if (attr != cudaSuccess) return (int)attr;
  cudaLaunchAttribute cluster_dims;
  cluster_dims.id = cudaLaunchAttributeClusterDimension;
  cluster_dims.val.clusterDim.x = 1, cluster_dims.val.clusterDim.y = 1, cluster_dims.val.clusterDim.z = n_split;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(tiles_x, tiles_y, n_split);
  config.blockDim = dim3(kWideThreads);
  config.dynamicSmemBytes = kWideSmemBytes;
  config.stream = stream;
  config.attrs = &cluster_dims;
  config.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&config, dparams_bf16_wide_kernel<kPerSampleX>, g, x, rho, brho,
                                             dloc, drho, dbloc, dbrho, S, B, I, O, seed, n_split);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

}  // namespace
}  // namespace sampled_dense

// As sampled_dense_dparams_bf16 (csrc/sampled_dense_dparams_bf16.cu) for O > 16; partials unused.
extern "C" int sampled_dense_dparams_bf16_shared_sums(const float* g, const float* x, const float* rho,
                                                      const float* brho, float* partials, float* dloc, float* drho,
                                                      float* dbloc, float* dbrho, int S, int B, int I, int O,
                                                      uint32_t seed, int n_split, void* stream) {
  (void)partials;
  return sampled_dense::launch_wide<false>(g, x, rho, brho, dloc, drho, dbloc, dbrho, S, B, I, O, seed, n_split,
                                           static_cast<cudaStream_t>(stream));
}

// As sampled_dense_xs_dparams_bf16 for O > 16; partials unused.
extern "C" int sampled_dense_xs_dparams_bf16_shared_sums(const float* g, const float* xs, const float* rho,
                                                         const float* brho, float* partials, float* dloc,
                                                         float* drho, float* dbloc, float* dbrho, int S, int B,
                                                         int I, int O, uint32_t seed, int n_split, void* stream) {
  (void)partials;
  return sampled_dense::launch_wide<true>(g, xs, rho, brho, dloc, drho, dbloc, dbrho, S, B, I, O, seed, n_split,
                                          static_cast<cudaStream_t>(stream));
}
