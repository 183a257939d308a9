// bf16 tensor-core variants of the parameter-gradient sampled-dense kernels,
// for ROBUSTBNNS_KERNEL_PRECISION=default. For the output cotangent g (S, B, O)
// and the layer input, x (B, I) shared by every sample or xs (S, B, I) per
// sample, with eps regenerated from the forward's own noise:
//
//   dW_s  = bf16(x_s)^T bf16(g_s), each product exact in f32, summed in f32
//   dloc  = sum_s dW_s
//   drho  = sigmoid(rho) * sum_s dW_s * eps_s
//   dbloc = sum_s sum_b g_s                       (the unrounded g)
//   dbrho = sigmoid(brho) * sum_s (sum_b g_s) * eps[s, I]
//
// Replaces the Pallas kernels _bwd_dparams_kernel and _bwd_xs_dparams_kernel
// (robustbnns_tpu/ops/sampled_dense.py:137, :383) under Precision.DEFAULT
// (_dot, :61-65): dW = _dot(x.T, g) (:154, :401) is a single-pass bf16 MXU
// product there, while db = jnp.sum(g, axis=0) (:155, :402) is no _dot, so the
// bias cotangents are f32 in both precisions.
//
// What bounds them on the H100. At the main path's shapes (B = 128, S = 10)
// the wide layers do 2*S*B*I*O = 2.06 and 2.68 GFLOP, 2.1 and 2.7 us at the
// 989 TFLOP/s bf16 tensor-core peak; moving their inputs and outputs once
// (15.3 and 23.1 MB) takes 4.6 and 6.9 us at 3.35 TB/s (the bytes bound). Each
// call also draws S*I*O normals (8.0 and 10.5 M) on the FP32 pipe, which set
// the practical floor, as in the other bf16 kernels. The 10-class head reads
// xs (5.2 MB).
//
// Design: the f32 kernels' plan (ops/sampled_dense.py dparams_plan) and
// structure (sampled_dense_dparams.cu), with the FFMA contraction over the
// batch replaced by mma.sync.m16n8k16 (sampled_dense_mma.cuh: M the inputs, N
// the outputs, K the batch rows), and without cp.async double buffering (a
// simple kernel first):
// - Staging. x_s and g_s are row-major along I and O; the MMA wants both
//   operands batch-contiguous. Per 32-row chunk of the batch, each thread
//   loads rows b and b + 1 of a 4-wide column quad and stores the four
//   (b, b + 1) pairs rounded to bf16 as one 32-bit word each into As[i][b]
//   and Bs[o][b], at a row stride of 40 bf16: the stores of a warp and the
//   fragment reads each hit 32 distinct banks.
// - Wide path (O > 16). A block of 128 threads (4 warps) owns a 128-input x
//   64-output tile of dloc/drho and walks a run of samples; warp w keeps
//   inputs 32w .. 32w+31 of dW_s as 2 x 8 m16n8 tiles in f32 registers.
// - The noise. After a sample's last chunk a lane holds, for each of its rows
//   and n8 tiles, two adjacent outputs 2tq, 2tq+1; a Philox draw gives a quad
//   of four, so lanes tq and tq ^ 1 share it. Of each pair of n8 tiles, the
//   even lane draws the quad of the first tile and the odd lane that of the
//   second, and each passes the other the half it needs with
//   __shfl_xor_sync: every normal is drawn once. dW_s and dW_s * eps_s go into
//   running sums in shared memory (each thread its own float2 column, 64 KB a
//   block, 88 KB with the staging: two blocks an SM), one accumulator row a
//   step of a rolled loop (the rows shift up, so the registers stay indexed by
//   constants); sigmoid(rho) is applied once at the end.
// - Bias: the f32 kernel's path on the unrounded g. The blocks of input tile 0
//   also stage each g chunk in f32 (row stride 68: 2-way store conflicts at
//   most), and thread tid < 64 sums its column o0 + tid in row order and takes
//   eps from row i = I, so dbloc and dbrho get the f32 kernel's sums.
// - Runs: as the f32 kernel. While the tiles fill less than one wave, each
//   tile's samples are split into n_split <= 8 runs, one thread-block cluster
//   that sums the runs' running sums on chip through distributed shared
//   memory in the order 0 .. n_split-1; no atomics, so the result is
//   bit-identical from call to call.
// - Narrow path (O <= 16, the 10-class head). A block of 64 threads (2 warps)
//   owns 32 inputs and a run of samples; warp w the m16 tile of inputs
//   16w .. 16w+15 against the two n8 tiles of outputs 0 .. 15, the same
//   staging and noise pairs, running sums in registers. Its runs write partial
//   planes (bias in row I) that the f32 kernel's second pass sums in the order
//   0 .. n_split-1 (sampled_dense_passes.cuh); with one run a block writes the
//   outputs itself. The bias: input block 0 also stages g in f32, and thread
//   q < ceil(O / 4) sums outputs 4q .. 4q+3 in row order and draws their quad
//   once.
// - Any B, I, O and S: ragged edges are zero-filled in shared memory and
//   masked at the store; vector loads only where the row length is a multiple
//   of 4. All shared memory of the wide kernel is dynamic.
#include <cooperative_groups.h>

#include "sampled_dense_mma.cuh"
#include "sampled_dense_passes.cuh"

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

// O <= kNarrowO: the narrow kernel with n_split runs of samples per input
// block and, when n_split > 1, the fixed-order sum of its partials into the
// four outputs. Else the wide kernel, its n_split runs of a tile one cluster
// that sums them on chip.
template <bool kPerSampleX>
int launch(const float* g, const float* x, const float* rho, const float* brho, float* partials,
           float* dloc, float* drho, float* dbloc, float* dbrho, int S, int B, int I, int O,
           uint32_t seed, int n_split, cudaStream_t stream) {
  const bool narrow = O <= kNarrowO;
  const int tiles_x = narrow ? (I + kNarrowCols - 1) / kNarrowCols : (O + kWideCols - 1) / kWideCols;
  const int tiles_y = narrow ? n_split : (I + kWideRows - 1) / kWideRows;
  if (S < 1 || B < 1 || I < 1 || O < 1 || n_split < 1 || n_split > S || tiles_y > 65535 ||
      (narrow && n_split > 1 && !partials) || (!narrow && n_split > kMaxRuns))
    return (int)cudaErrorInvalidValue;
  if (narrow) {
    const dim3 grid(tiles_x, tiles_y);
    dparams_bf16_narrow_kernel<kPerSampleX><<<grid, kNarrowThreads, 0, stream>>>(
        g, x, rho, brho, partials, dloc, drho, dbloc, dbrho, S, B, I, O, seed, n_split);
    if (n_split > 1) {
      const long long n = (long long)(I + 1) * O;
      sum_dparams_kernel<<<elementwise_blocks(n), 256, 0, stream>>>(partials, rho, brho, dloc, drho, dbloc,
                                                                    dbrho, I, O, n_split);
    }
    return (int)cudaGetLastError();
  }
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

// Shared input x (B, I). partials: an (n_split, 2, I + 1, O) scratch when
// O <= 16 and n_split > 1, else unused.
extern "C" int sampled_dense_dparams_bf16(const float* g, const float* x, const float* rho, const float* brho,
                                          float* partials, float* dloc, float* drho, float* dbloc, float* dbrho,
                                          int S, int B, int I, int O, uint32_t seed, int n_split, void* stream) {
  return sampled_dense::launch<false>(g, x, rho, brho, partials, dloc, drho, dbloc, dbrho, S, B, I, O, seed,
                                      n_split, static_cast<cudaStream_t>(stream));
}

// Per-sample input xs (S, B, I). As sampled_dense_dparams_bf16.
extern "C" int sampled_dense_xs_dparams_bf16(const float* g, const float* xs, const float* rho, const float* brho,
                                             float* partials, float* dloc, float* drho, float* dbloc,
                                             float* dbrho, int S, int B, int I, int O, uint32_t seed, int n_split,
                                             void* stream) {
  return sampled_dense::launch<true>(g, xs, rho, brho, partials, dloc, drho, dbloc, dbrho, S, B, I, O, seed,
                                     n_split, static_cast<cudaStream_t>(stream));
}
