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
// call also draws S*I*O normals (8.0 and 10.5 M) on the FP32 and integer
// pipes, about 20 and 25 us for a kernel that does nothing else
// (chip_smoke.NOISE_FLOOR_CU): the noise sets the practical floor. The
// 10-class head reads xs (5.2 MB).
//
// Wide path (O > 16; ops/sampled_dense.py dparams_bf16_plan). The earlier
// design (scripts/comparison_kernels/sampled_dense_dparams_bf16_shared_sums.cu)
// held its running sums in 64 KB of shared memory, two blocks of 4 warps an
// SM, transposed each chunk through registers with plain loads, and drew the
// noise after a sample's last chunk with no load in flight. This one:
// - A block of 256 threads (8 warps) owns a 128-input x 64-output tile of
//   dloc/drho and walks a run of samples, the contraction over the batch in
//   32-row chunks (M the inputs, N the outputs, K the batch rows of
//   mma.sync.m16n8k16). Warp w keeps inputs 32 (w % 4) .. +31 x outputs
//   32 (w / 4) .. +31 as 2 x 4 m16n8 tiles: dW_s, and the running sums of dW_s
//   and dW_s * eps_s, all in registers (at most 128 a thread: two blocks an
//   SM, 16 warps).
// - Staging: every chunk of x_s (32 x 128 floats) and g_s (32 x 64) is copied
//   as it lies, row-major f32, by cp.async into three stages, two chunks
//   ahead; the pipeline runs on across the samples of the run, so sample
//   s + 1's first chunks load during sample s's last products and epilogue.
//   One barrier a chunk. The tiles' fragment rows and columns are permuted
//   (fragment row gq is input 2 gq, row gq + 8 input 2 gq + 1; likewise the
//   columns of a pair of n8 tiles), so each pair of fragment registers is one
//   float2 read of a staged row, rounded to a bf16 pair as read (row strides
//   132 and 68 floats: a half-warp's reads hit 32 banks). The bias reads the
//   same f32 g rows.
// - The noise: with that order a lane's accumulators hold whole Philox quads
//   (4 outputs of one input), 8 a sample, so each lane draws its own eps
//   (every normal once) into its slots of the warp's region of shared memory,
//   a share of them with each chunk of the sample, before that chunk's
//   products (the draw reads nothing staged; 2-4% faster than after them);
//   after the sample's last chunk it adds dW_s and dW_s * eps_s into its
//   running sums.
// - Bias: the f32 kernel's sums on the unrounded g. In the blocks of input
//   tile 0 (launched first, so their extra work does not trail the grid; the
//   last tile ran 8% slower at 1024 -> 1024), thread tid < 64 sums column
//   o0 + tid of each staged g chunk in row order and takes eps from row
//   i = I, so dbloc and dbrho get the f32 kernel's sums, bit for bit (the
//   plans split the samples alike).
// - Runs: while the tiles fill less than one wave, each tile's samples are
//   split into n_split <= 8 runs, one thread-block cluster. After the last
//   chunk each block parks its sums over the stages; rank r sums rows
//   [128 r / n_split, 128 (r + 1) / n_split) over the ranks in the order
//   0 .. n_split-1 through distributed shared memory, applies sigmoid(rho)
//   and stores whole float4s: no atomics, bit-identical from call to call.
//   One run launches without the cluster attribute.
// Narrow path (O <= 16, the 10-class head; dparams_bf16_plan). It reads xs
// (5.2 MB at model_7) and draws 0.1 M normals: bound by the bytes (1.6 us)
// and by latency. The earlier design
// (scripts/comparison_kernels/sampled_dense_dparams_bf16_narrow_partials.cu)
// staged each chunk by plain loads with a transpose through registers, two
// barriers a chunk, and wrote partial planes that a second launch summed.
// This one:
// - A block of 64 threads (2 warps) owns 32 inputs against the O <= 16
//   outputs and walks a run of samples, 64 batch rows a chunk; warp w keeps
//   the m16 tile of inputs 16w .. 16w+15 as two n8 tiles. Each chunk's x_s and
//   g_s rows go by cp.async, as they lie, into three stages, two chunks ahead
//   (a model_7 sample's two chunks at once); one barrier a chunk. The wide
//   kernel's fragment order (below) makes each pair of fragment registers one
//   float2 of a staged row and a lane's accumulators two whole Philox quads:
//   each lane draws its own eps.
// - Runs: the n_split runs of dparams_plan (the bias's, for bit-equality
//   with the f32 kernel) are grouped into min(n_split, kHeadMaxRanks) ranks
//   of one cluster along z (non-portable above 8), rank k holding runs
//   [n_split k / ranks, n_split (k + 1) / ranks) and their samples; ranks sum
//   dloc and drho on chip in the order 0 .. ranks-1, sigmoid applied at the
//   store. One launch a call.
// - Bias: one more block x (its own cluster of ranks) stages each of its
//   samples' g rows and thread o < O sums column o in row order, a sample at
//   a time, into the subtotals of its run (the f32 kernel's sums); rank 0 adds
//   the runs' subtotals in run order from the ranks' shared memory, so dbloc
//   and dbrho equal the f32 kernel's bit for bit at every split. Off the input
//   blocks' path (in input block 0 it cost 2.1 us of 12.4 at model_7). Each
//   sample's noise is drawn before its first chunk is waited for, and the rho
//   of the epilogue is read before the loop.
// Any B, I, O and S: ragged edges are zero-filled in shared memory and masked
// at the store; cp.async and vector loads only where the row length is a
// multiple of 4. All shared memory is dynamic.
#include <cooperative_groups.h>

#include "sampled_dense_common.cuh"
#include "sampled_dense_mma.cuh"

namespace sampled_dense {
namespace {

constexpr int kDepth = 32;            // batch rows a chunk of the wide path
constexpr int kMaxRuns = 8;           // runs of a tile, one cluster: the portable cluster size
constexpr int kNarrowO = 16;          // the narrow path takes O <= kNarrowO

// The head's (narrow path's) geometry and shared memory, in floats:
// kHeadStages stages of a chunk (x rows, then g rows, f32 as copied), reused
// after the last chunk for the two parked planes of running sums; then each
// rank's bias subtotals, two floats a run and output.
constexpr int kHeadWarps = 2;                      // warps of 16 inputs each
constexpr int kHeadThreads = 32 * kHeadWarps;
constexpr int kHeadCols = 16 * kHeadWarps;         // inputs i of a head block (dparams_plan's 32)
constexpr int kHeadDepth = 64;                     // batch rows a chunk
constexpr int kHeadStages = 3;                     // the chunk in use and two in flight
constexpr int kHeadMaxRanks = 16;                  // blocks of a cluster: the non-portable maximum
constexpr int kHeadXStride = kHeadCols + 4;        // floats a staged x row
constexpr int kHeadGStride = kNarrowO + 4;         // floats a staged g row
constexpr int kHeadStage = kHeadDepth * (kHeadXStride + kHeadGStride);
constexpr int kHeadRegion = kHeadStages * kHeadStage;
constexpr int kHeadParkStride = kNarrowO + 4;      // floats a parked row
static_assert(2 * kHeadCols * kHeadParkStride <= kHeadRegion, "the parked sums fit over the stages");

// The wide kernel's shared memory, in floats: kWideStages stages of a chunk
// (x rows, then g rows, f32 as copied), reused after the last chunk for the
// two parked planes of running sums; the warps' eps regions; the bias sums.
constexpr int kWideRows = 128;                  // inputs i of a wide block
constexpr int kWideCols = 64;                   // outputs o of a wide block
constexpr int kWideThreads = 256;               // 8 warps of 32 x 32
constexpr int kWideStages = 3;                  // the chunk in use and two in flight
constexpr int kXStride = kWideRows + 4;         // floats a staged x row
constexpr int kGStride = kWideCols + 4;         // floats a staged g row
constexpr int kStageFloats = kDepth * (kXStride + kGStride);
constexpr int kParkStride = kWideCols + 8;      // floats a parked row
constexpr int kRegionFloats = kWideStages * kStageFloats;
constexpr int kEpsQuads = 8;                    // Philox quads of a lane's eps, a sample
constexpr int kEpsFloats = 32 * 4 * kEpsQuads;  // a warp's eps, 32 inputs x 32 outputs
constexpr int kWideFloats = kRegionFloats + (kWideThreads / 32) * kEpsFloats + 2 * kWideCols;
constexpr int kWideSmemBytes = kWideFloats * (int)sizeof(float);
static_assert(2 * kWideRows * kParkStride <= kRegionFloats, "the parked sums fit over the stages");

__device__ __forceinline__ void run_samples(int S, int run, int n_split, int& s_begin, int& s_end) {
  s_begin = (int)((long long)S * run / n_split);
  s_end = (int)((long long)S * (run + 1) / n_split);
}

// Unit u of a run (sample s_begin + u / C, batch rows (u % C) * 32 ..) into a
// stage: x_s rows x columns i0 .. i0+127, then g_s rows x columns o0 .. o0+63,
// as they lie, zero past B, I and O. cp.async where the row length is a
// multiple of 4, else plain loads. Commits no group.
template <bool kPerSampleX>
__device__ __forceinline__ void fetch_unit(float* __restrict__ stage, const float* __restrict__ g,
                                           const float* __restrict__ x, int B, int I, int O, int s, int b0, int i0,
                                           int o0) {
  const float* xs = kPerSampleX ? x + (size_t)s * B * I : x;
  const float* gs = g + (size_t)s * B * O;
  const bool vec_x = (I & 3) == 0, vec_g = (O & 3) == 0;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int k = 0; k < kDepth * kWideRows / 4 / kWideThreads; ++k) {
    const int f = threadIdx.x + k * kWideThreads, r = f / (kWideRows / 4), i = i0 + 4 * (f % (kWideRows / 4));
    const int b = b0 + r;
    float* dst = stage + r * kXStride + 4 * (f % (kWideRows / 4));
    if (vec_x) {
      const bool valid = b < B && i < I;
      cp_async16(dst, valid ? xs + (size_t)b * I + i : xs, valid);
    } else {
      *reinterpret_cast<float4*>(dst) = b < B ? load4(xs + (size_t)b * I, i, I) : zero;
    }
  }
#pragma unroll
  for (int k = 0; k < kDepth * kWideCols / 4 / kWideThreads; ++k) {
    const int f = threadIdx.x + k * kWideThreads, r = f / (kWideCols / 4), o = o0 + 4 * (f % (kWideCols / 4));
    const int b = b0 + r;
    float* dst = stage + kDepth * kXStride + r * kGStride + 4 * (f % (kWideCols / 4));
    if (vec_g) {
      const bool valid = b < B && o < O;
      cp_async16(dst, valid ? gs + (size_t)b * O + o : gs, valid);
    } else {
      *reinterpret_cast<float4*>(dst) = b < B ? load4(gs + (size_t)b * O, o, O) : zero;
    }
  }
}

// The warp tile's fragment order. Warp w owns inputs 32 (w % 4) .. +31 and
// outputs 32 (w / 4) .. +31. Its m16 tile mt maps fragment row gq to input
// 16 mt + 2 gq and row gq + 8 to 16 mt + 2 gq + 1; its n8 tiles 2p and 2p + 1
// map fragment column c to outputs 16p + 2c and 16p + 2c + 1. So each
// fragment register pair is one float2 read of a staged row, and a lane's
// accumulators hold whole quads: for (mt, h, p), the outputs 16p + 4tq .. +3
// of input 16 mt + 2 gq + h, value j in acc[mt][2p + (j & 1)][2h + (j >> 1)].

// One staged chunk of a warp's products (x and g rows, f32, rounded to bf16
// pairs of adjacent batch rows as read) into acc[m tile][n tile].
__device__ __forceinline__ void mma_unit(const float* __restrict__ stage, int wm, int wn, float (&acc)[2][4][4]) {
  const int lane = threadIdx.x % 32, gq = lane / 4, tq = lane % 4;
#pragma unroll
  for (int k0 = 0; k0 < kDepth; k0 += 16) {
    uint32_t a[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const float* pa = stage + (k0 + 2 * tq) * kXStride + 32 * wm + 16 * mt + 2 * gq;
      const float2 v0 = *reinterpret_cast<const float2*>(pa), v1 = *reinterpret_cast<const float2*>(pa + kXStride);
      const float2 v2 = *reinterpret_cast<const float2*>(pa + 8 * kXStride);
      const float2 v3 = *reinterpret_cast<const float2*>(pa + 9 * kXStride);
      a[mt][0] = pack_bf16(v0.x, v1.x), a[mt][1] = pack_bf16(v0.y, v1.y);
      a[mt][2] = pack_bf16(v2.x, v3.x), a[mt][3] = pack_bf16(v2.y, v3.y);
    }
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const float* pb = stage + kDepth * kXStride + (k0 + 2 * tq) * kGStride + 32 * wn + 16 * p + 2 * gq;
      const float2 w0 = *reinterpret_cast<const float2*>(pb), w1 = *reinterpret_cast<const float2*>(pb + kGStride);
      const float2 w2 = *reinterpret_cast<const float2*>(pb + 8 * kGStride);
      const float2 w3 = *reinterpret_cast<const float2*>(pb + 9 * kGStride);
      const uint32_t b0[2] = {pack_bf16(w0.x, w1.x), pack_bf16(w2.x, w3.x)};
      const uint32_t b1[2] = {pack_bf16(w0.y, w1.y), pack_bf16(w2.y, w3.y)};
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        mma_bf16_16816(acc[mt][2 * p], a[mt], b0);
        mma_bf16_16816(acc[mt][2 * p + 1], a[mt], b1);
      }
    }
  }
}

// Quad k (0 .. 7) of a lane's eps for sample s, k = 4 mt + 2 h + p: the
// normals of outputs o_w + 16p + 4tq .. +3 of input i_w + 16 mt + 2 gq + h,
// zero past I and O, stored at the lane's slot k of the warp's region (the
// lanes of a quad slot consecutive).
__device__ __forceinline__ void draw_eps(float* __restrict__ eps, uint32_t seed, int s, int I, int O, int i_w,
                                         int o_w, int k) {
  const int lane = threadIdx.x % 32, gq = lane / 4, tq = lane % 4;
  const int i = i_w + 16 * (k >> 2) + 2 * gq + ((k >> 1) & 1), o = o_w + 16 * (k & 1) + 4 * tq;
  const float4 z = i < I && o < O ? normal4(seed, s, i, o >> 2) : make_float4(0.f, 0.f, 0.f, 0.f);
  *reinterpret_cast<float4*>(eps + 4 * (32 * k + lane)) = z;
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
  extern __shared__ __align__(16) float dyn[];
  float* const stages = dyn;  // [kWideStages][kStageFloats]; after the last chunk the parked sums
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32, gq = lane / 4, tq = lane % 4;
  const int wm = warp % 4, wn = warp / 4;
  float* const eps = dyn + kRegionFloats + warp * kEpsFloats;  // this warp's
  float* const bias_sums = dyn + kRegionFloats + (kWideThreads / 32) * kEpsFloats;  // [2][kWideCols]
  const int o0 = blockIdx.x * kWideCols, i0 = blockIdx.y * kWideRows, run = blockIdx.z;
  const int i_w = i0 + 32 * wm, o_w = o0 + 32 * wn;
  int s_begin, s_end;
  run_samples(S, run, n_split, s_begin, s_end);
  const int C = (B + kDepth - 1) / kDepth;  // chunks of one sample
  const int U = (s_end - s_begin) * C;      // units of the run
  // column o0 + tid of the bias row, in the first input tile: its blocks launch first
  const bool bias = blockIdx.y == 0 && tid < kWideCols && o0 + tid < O;

  // Unit u's chunk goes to stage u % 3, copied two units ahead; an iteration
  // waits for its own unit, and after one barrier (unit u - 1 consumed by
  // all) copies unit u + 2, multiplies unit u and draws the unit's share of
  // the sample's eps.
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    if (j < U)
      fetch_unit<kPerSampleX>(stages + j * kStageFloats, g, x, B, I, O, s_begin + j / C, (j % C) * kDepth, i0, o0);
    cp_async_commit();
  }
  float acc[2][4][4] = {}, sum_loc[2][2][2][4] = {}, sum_rho[2][2][2][4] = {};
  float db = 0.f, bias_loc = 0.f, bias_rho = 0.f;
  for (int u = 0; u < U; ++u) {
    const int s = s_begin + u / C, c = u % C;
    cp_async_wait_pending<1>();
    __syncthreads();  // unit u landed for all; unit u - 1 consumed
    if (u + 2 < U)
      fetch_unit<kPerSampleX>(stages + (u + 2) % kWideStages * kStageFloats, g, x, B, I, O, s_begin + (u + 2) / C,
                              (u + 2) % C * kDepth, i0, o0);
    cp_async_commit();
    // quads k in [8 c / C, 8 (c + 1) / C): each of the lane's 8 quads once a sample
    for (int k = kEpsQuads * c / C; k < kEpsQuads * (c + 1) / C; ++k) draw_eps(eps, seed, s, I, O, i_w, o_w, k);
    const float* stage = stages + u % kWideStages * kStageFloats;
    mma_unit(stage, wm, wn, acc);
    if (bias) {  // column o0 + tid of the chunk's g rows, in row order
      const float* col = stage + kDepth * kXStride + tid;
      if (B - c * kDepth >= kDepth) {
#pragma unroll
        for (int k = 0; k < kDepth; ++k) db += col[k * kGStride];
      } else {
        for (int k = 0; k < B - c * kDepth; ++k) db += col[k * kGStride];
      }
    }
    if (c == C - 1) {  // the sample's last chunk: dW_s and dW_s * eps_s into the running sums
#pragma unroll
      for (int k = 0; k < kEpsQuads; ++k) {
        const int mt = k >> 2, h = (k >> 1) & 1, p = k & 1;
        const float4 e4 = *reinterpret_cast<const float4*>(eps + 4 * (32 * k + lane));
        const float e[4] = {e4.x, e4.y, e4.z, e4.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float& d = acc[mt][2 * p + (j & 1)][2 * h + (j >> 1)];
          sum_loc[mt][h][p][j] += d;
          sum_rho[mt][h][p][j] += d * e[j];
          d = 0.f;
        }
      }
      if (bias) {
        const int o = o0 + tid;
        bias_loc += db;
        bias_rho += db * component(normal4(seed, s, I, o >> 2), o & 3);
        db = 0.f;
      }
    }
  }
  cp_async_wait_pending<0>();
  __syncthreads();  // every product done: the stages take the parked sums

  // Park the sums (plane 0 dloc's, plane 1 drho's) over the stages, a quad a store.
  float* const park = stages;
#pragma unroll
  for (int k = 0; k < kEpsQuads; ++k) {
    const int mt = k >> 2, h = (k >> 1) & 1, p = k & 1;
    const int at = (32 * wm + 16 * mt + 2 * gq + h) * kParkStride + 32 * wn + 16 * p + 4 * tq;
    const float* l = sum_loc[mt][h][p];
    const float* v = sum_rho[mt][h][p];
    *reinterpret_cast<float4*>(park + at) = make_float4(l[0], l[1], l[2], l[3]);
    *reinterpret_cast<float4*>(park + kWideRows * kParkStride + at) = make_float4(v[0], v[1], v[2], v[3]);
  }
  if (bias) bias_sums[tid] = bias_loc, bias_sums[kWideCols + tid] = bias_rho;

  // The runs of the tile are one cluster (one block when n_split = 1): after
  // they all park, rank r sums its rows over ranks 0 .. n_split-1 in that
  // order, scales drho by sigmoid(rho) and stores; rank 0 also the bias. The
  // second cluster barrier keeps each block's shared memory alive until the
  // others have read it.
  const cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  cluster.sync();
  const int r_begin = kWideRows * run / n_split, r_end = kWideRows * (run + 1) / n_split;
  const bool vec = (O & 3) == 0;
  for (int f = tid; f < (r_end - r_begin) * (kWideCols / 4); f += kWideThreads) {
    const int r = r_begin + f / (kWideCols / 4), q = f % (kWideCols / 4), i = i0 + r, o = o0 + 4 * q;
    if (i >= I || o >= O) continue;
    const int at = r * kParkStride + 4 * q;
    const float* first = cluster.map_shared_rank(park, 0);
    float4 l = *reinterpret_cast<const float4*>(first + at);
    float4 v = *reinterpret_cast<const float4*>(first + kWideRows * kParkStride + at);
    for (int k = 1; k < n_split; ++k) {
      const float* peer = cluster.map_shared_rank(park, k);
      const float4 lp = *reinterpret_cast<const float4*>(peer + at);
      const float4 vp = *reinterpret_cast<const float4*>(peer + kWideRows * kParkStride + at);
      l.x += lp.x, l.y += lp.y, l.z += lp.z, l.w += lp.w;
      v.x += vp.x, v.y += vp.y, v.z += vp.z, v.w += vp.w;
    }
    const size_t row = (size_t)i * O;
    const float ls[4] = {l.x, l.y, l.z, l.w}, vs[4] = {v.x, v.y, v.z, v.w};
    float d[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) d[t] = o + t < O ? vs[t] * sigmoid(rho[row + o + t]) : 0.f;
    if (vec) {
      *reinterpret_cast<float4*>(dloc + row + o) = l;
      *reinterpret_cast<float4*>(drho + row + o) = make_float4(d[0], d[1], d[2], d[3]);
    } else {
#pragma unroll
      for (int t = 0; t < 4; ++t)
        if (o + t < O) dloc[row + o + t] = ls[t], drho[row + o + t] = d[t];
    }
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

// Rank k of n_ranks holds the bias runs [n_split k / n_ranks, n_split (k + 1)
// / n_ranks) of dparams_plan and their samples.
__device__ __forceinline__ void rank_runs(int n_split, int n_ranks, int rank, int& r_begin, int& r_end) {
  r_begin = n_split * rank / n_ranks;  // n_split <= S < 2^16 and rank < 16: no overflow
  r_end = n_split * (rank + 1) / n_ranks;
}

// Chunk u of a head block's run (sample s_begin + u / C, batch rows (u % C) *
// kHeadDepth ..) into a stage: x_s rows x columns i0 .. i0+kHeadCols-1, then
// g_s rows x outputs 0 .. 15, as they lie, zero past B, I and O. cp.async
// where the row length is a multiple of 4, else plain loads. Commits no group.
template <bool kPerSampleX>
__device__ __forceinline__ void fetch_head(float* __restrict__ stage, const float* __restrict__ g,
                                           const float* __restrict__ x, int B, int I, int O, int s, int b0, int i0) {
  const float* xs = kPerSampleX ? x + (size_t)s * B * I : x;
  const float* gs = g + (size_t)s * B * O;
  const bool vec_x = (I & 3) == 0, vec_g = (O & 3) == 0;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  constexpr int kXQuads = kHeadCols / 4, kGQuads = kNarrowO / 4;
  for (int f = threadIdx.x; f < kHeadDepth * kXQuads; f += kHeadThreads) {
    const int r = f / kXQuads, i = i0 + 4 * (f % kXQuads), b = b0 + r;
    float* dst = stage + r * kHeadXStride + 4 * (f % kXQuads);
    if (vec_x) {
      const bool valid = b < B && i < I;
      cp_async16(dst, valid ? xs + (size_t)b * I + i : xs, valid);
    } else {
      *reinterpret_cast<float4*>(dst) = b < B ? load4(xs + (size_t)b * I, i, I) : zero;
    }
  }
  for (int f = threadIdx.x; f < kHeadDepth * kGQuads; f += kHeadThreads) {
    const int r = f / kGQuads, o = 4 * (f % kGQuads), b = b0 + r;
    float* dst = stage + kHeadDepth * kHeadXStride + r * kHeadGStride + o;
    if (vec_g) {
      const bool valid = b < B && o < O;
      cp_async16(dst, valid ? gs + (size_t)b * O + o : gs, valid);
    } else {
      *reinterpret_cast<float4*>(dst) = b < B ? load4(gs + (size_t)b * O, o, O) : zero;
    }
  }
}

// One staged chunk of a head warp's products, in the wide kernel's fragment
// order: fragment row gq is input 16w + 2gq, row gq + 8 input 16w + 2gq + 1;
// column gq of n8 tile t is output 2gq + t. acc[t][2h + j'] then holds output
// 4tq + t + 2j' of input 16w + 2gq + h.
__device__ __forceinline__ void mma_head(const float* __restrict__ stage, int warp, float (&acc)[2][4]) {
  const int lane = threadIdx.x % 32, gq = lane / 4, tq = lane % 4;
#pragma unroll
  for (int k0 = 0; k0 < kHeadDepth; k0 += 16) {
    const float* pa = stage + (k0 + 2 * tq) * kHeadXStride + 16 * warp + 2 * gq;
    const float2 v0 = *reinterpret_cast<const float2*>(pa), v1 = *reinterpret_cast<const float2*>(pa + kHeadXStride);
    const float2 v2 = *reinterpret_cast<const float2*>(pa + 8 * kHeadXStride);
    const float2 v3 = *reinterpret_cast<const float2*>(pa + 9 * kHeadXStride);
    const uint32_t a[4] = {pack_bf16(v0.x, v1.x), pack_bf16(v0.y, v1.y), pack_bf16(v2.x, v3.x),
                           pack_bf16(v2.y, v3.y)};
    const float* pb = stage + kHeadDepth * kHeadXStride + (k0 + 2 * tq) * kHeadGStride + 2 * gq;
    const float2 w0 = *reinterpret_cast<const float2*>(pb), w1 = *reinterpret_cast<const float2*>(pb + kHeadGStride);
    const float2 w2 = *reinterpret_cast<const float2*>(pb + 8 * kHeadGStride);
    const float2 w3 = *reinterpret_cast<const float2*>(pb + 9 * kHeadGStride);
    const uint32_t b0[2] = {pack_bf16(w0.x, w1.x), pack_bf16(w2.x, w3.x)};
    const uint32_t b1[2] = {pack_bf16(w0.y, w1.y), pack_bf16(w2.y, w3.y)};
    mma_bf16_16816(acc[0], a, b0);
    mma_bf16_16816(acc[1], a, b1);
  }
}

// The bias row of the head: for each sample of the rank, its g rows staged
// (flat, as they lie) by all threads, then thread o < O sums column o in row
// order, as the f32 kernel does; the subtotals of each run into the rank's
// slots. Every thread of the block calls it.
__device__ __forceinline__ void head_bias(float* __restrict__ rows_smem, float* __restrict__ subtotals,
                                          const float* __restrict__ g, int S, int B, int I, int O, uint32_t seed,
                                          int n_split, int r_begin, int s_begin, int s_end) {
  constexpr int kRows = kHeadRegion / kNarrowO;  // rows of g a pass stages
  const int tid = threadIdx.x;
  float bias_loc = 0.f, bias_rho = 0.f;
  int run = r_begin, run_end = (int)((long long)S * (r_begin + 1) / n_split);
  for (int s = s_begin; s < s_end; ++s) {
    const float* gs = g + (size_t)s * B * O;
    float db = 0.f;
    for (int b0 = 0; b0 < B; b0 += kRows) {
      const int rows = min(kRows, B - b0);
      __syncthreads();  // the previous rows are summed
      for (int k = tid; k < rows * O; k += kHeadThreads) rows_smem[k] = gs[(size_t)b0 * O + k];
      __syncthreads();
      if (tid < O) {
#pragma unroll 8
        for (int k = 0; k < rows; ++k) db += rows_smem[k * O + tid];
      }
    }
    if (tid < O) {
      bias_loc += db;
      bias_rho += db * component(normal4(seed, s, I, tid >> 2), tid & 3);
      if (s + 1 == run_end) {  // the run's last sample: its subtotals, in the rank's slot of the run
        subtotals[(run - r_begin) * 2 * kNarrowO + tid] = bias_loc;
        subtotals[(run - r_begin) * 2 * kNarrowO + kNarrowO + tid] = bias_rho;
        bias_loc = bias_rho = 0.f;
      }
    }
    if (s + 1 == run_end) {
      ++run;
      run_end = (int)((long long)S * (run + 1) / n_split);
    }
  }
}

// O <= 16: block x < gridDim.x - 1 owns kHeadCols inputs, the last block x
// the bias row; each over the samples of its rank's runs. z is the rank; the
// n_ranks ranks of an input block (or of the bias) are one cluster along z.
template <bool kPerSampleX>
__global__ void __launch_bounds__(kHeadThreads) dparams_bf16_head_kernel(
    const float* __restrict__ g, const float* __restrict__ x, const float* __restrict__ rho,
    const float* __restrict__ brho, float* __restrict__ dloc, float* __restrict__ drho, float* __restrict__ dbloc,
    float* __restrict__ dbrho, int S, int B, int I, int O, uint32_t seed, int n_split, int n_ranks) {
  extern __shared__ __align__(16) float dyn[];
  float* const stages = dyn;                      // [kHeadStages][kHeadStage]; then the parked sums
  float* const subtotals = dyn + kHeadRegion;     // [run - r_begin][2][kNarrowO], the bias block's
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32, gq = lane / 4, tq = lane % 4;
  const int i0 = blockIdx.x * kHeadCols, rank = blockIdx.z;
  const bool bias_block = blockIdx.x == gridDim.x - 1;
  int r_begin, r_end;
  rank_runs(n_split, n_ranks, rank, r_begin, r_end);
  const int s_begin = (int)((long long)S * r_begin / n_split), s_end = (int)((long long)S * r_end / n_split);

  // rho of this thread's items of the epilogue (rows [kHeadCols r / n_ranks, ..) of
  // the rank, a quad of outputs each), read now: their latency hides behind the loop.
  constexpr int kQuads = kNarrowO / 4, kItems = (kHeadCols * kQuads + kHeadThreads - 1) / kHeadThreads;
  const int row_begin = kHeadCols * rank / n_ranks, row_end = kHeadCols * (rank + 1) / n_ranks;
  float4 rho_q[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int f = tid + j * kHeadThreads, r = row_begin + f / kQuads, i = i0 + r, o = 4 * (f % kQuads);
    rho_q[j] = !bias_block && f < (row_end - row_begin) * kQuads && i < I && o < O
                   ? load4(rho + (size_t)i * O, o, O) : make_float4(0.f, 0.f, 0.f, 0.f);
  }

  float sum_loc[2][4] = {}, sum_rho[2][4] = {};
  if (bias_block) {
    head_bias(stages, subtotals, g, S, B, I, O, seed, n_split, r_begin, s_begin, s_end);
  } else {
    const int C = (B + kHeadDepth - 1) / kHeadDepth;  // chunks of one sample
    const int U = (s_end - s_begin) * C;              // units of the rank
    // Unit u's chunk goes to stage u % 3, copied two units ahead; an
    // iteration waits for its own unit and, after one barrier (unit u - 1
    // consumed by all), copies unit u + 2 and multiplies unit u.
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (j < U)
        fetch_head<kPerSampleX>(stages + j * kHeadStage, g, x, B, I, O, s_begin + j / C, (j % C) * kHeadDepth, i0);
      cp_async_commit();
    }
    float acc[2][4] = {};
    float4 eps[2];  // the lane's Philox quads of the current sample: inputs 16w + 2gq + h, outputs 4tq ..
    for (int u = 0; u < U; ++u) {
      const int s = s_begin + u / C, c = u % C;
      if (c == 0) {  // the sample's noise, drawn while its first chunk may still be in flight
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = i0 + 16 * warp + 2 * gq + h;
          eps[h] = i < I && 4 * tq < O ? normal4(seed, s, i, tq) : make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
      cp_async_wait_pending<1>();
      __syncthreads();  // unit u landed for all; unit u - 1 consumed
      if (u + 2 < U)
        fetch_head<kPerSampleX>(stages + (u + 2) % kHeadStages * kHeadStage, g, x, B, I, O, s_begin + (u + 2) / C,
                                (u + 2) % C * kHeadDepth, i0);
      cp_async_commit();
      mma_head(stages + u % kHeadStages * kHeadStage, warp, acc);
      if (c == C - 1) {  // the sample's last chunk: dW_s and dW_s * eps_s into the running sums
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float e[4] = {eps[h].x, eps[h].y, eps[h].z, eps[h].w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float& d = acc[j & 1][2 * h + (j >> 1)];
            sum_loc[h][j] += d;
            sum_rho[h][j] += d * e[j];
            d = 0.f;
          }
        }
      }
    }
    cp_async_wait_pending<0>();
  }
  __syncthreads();  // every product done: the stages take the parked sums

  // Park the sums (plane 0 dloc's, plane 1 drho's), a quad a store: row 16w + 2gq + h, outputs 4tq ..
  float* const park = stages;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int at = (16 * warp + 2 * gq + h) * kHeadParkStride + 4 * tq;
    *reinterpret_cast<float4*>(park + at) = make_float4(sum_loc[h][0], sum_loc[h][1], sum_loc[h][2], sum_loc[h][3]);
    *reinterpret_cast<float4*>(park + kHeadCols * kHeadParkStride + at) =
        make_float4(sum_rho[h][0], sum_rho[h][1], sum_rho[h][2], sum_rho[h][3]);
  }

  // The ranks are one cluster (one block when n_ranks = 1): after they all
  // park, rank k sums its inputs over ranks 0 .. n_ranks-1 in that order,
  // scales drho by sigmoid(rho) and stores; rank 0 of the bias block adds the
  // runs' subtotals in run order. The second cluster barrier keeps each
  // block's shared memory alive until the others have read it.
  const cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  cluster.sync();
  if (!bias_block) {
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int f = tid + j * kHeadThreads, r = row_begin + f / kQuads, i = i0 + r, o = 4 * (f % kQuads);
      if (f >= (row_end - row_begin) * kQuads || i >= I || o >= O) continue;
      const int at = r * kHeadParkStride + o;
      float4 l = *reinterpret_cast<const float4*>(cluster.map_shared_rank(park, 0) + at);
      float4 v = *reinterpret_cast<const float4*>(cluster.map_shared_rank(park, 0) + kHeadCols * kHeadParkStride + at);
#pragma unroll 4
      for (int k = 1; k < n_ranks; ++k) {  // unrolled: the peers' reads overlap
        const float* peer = cluster.map_shared_rank(park, k);
        const float4 lp = *reinterpret_cast<const float4*>(peer + at);
        const float4 vp = *reinterpret_cast<const float4*>(peer + kHeadCols * kHeadParkStride + at);
        l.x += lp.x, l.y += lp.y, l.z += lp.z, l.w += lp.w;
        v.x += vp.x, v.y += vp.y, v.z += vp.z, v.w += vp.w;
      }
      const size_t row = (size_t)i * O;
      const float ls[4] = {l.x, l.y, l.z, l.w}, vs[4] = {v.x, v.y, v.z, v.w};
      const float rs[4] = {rho_q[j].x, rho_q[j].y, rho_q[j].z, rho_q[j].w};
#pragma unroll
      for (int t = 0; t < 4; ++t)
        if (o + t < O) dloc[row + o + t] = ls[t], drho[row + o + t] = vs[t] * sigmoid(rs[t]);
    }
  } else if (rank == 0 && tid < O) {
    // Each rank's first run's subtotals read at once, then all runs added in
    // run order: rank k's runs follow rank k - 1's.
    float first_l[kHeadMaxRanks], first_v[kHeadMaxRanks];
#pragma unroll
    for (int k = 0; k < kHeadMaxRanks; ++k) {
      const float* peer = cluster.map_shared_rank(subtotals, k < n_ranks ? k : 0);
      first_l[k] = peer[tid], first_v[k] = peer[kNarrowO + tid];
    }
    float l = first_l[0], v = first_v[0];
#pragma unroll
    for (int k = 0; k < kHeadMaxRanks; ++k) {
      if (k >= n_ranks) break;
      if (k > 0) l += first_l[k], v += first_v[k];
      int kb, ke;
      rank_runs(n_split, n_ranks, k, kb, ke);
      const float* peer = cluster.map_shared_rank(subtotals, k);
      for (int r = kb + 1; r < ke; ++r)
        l += peer[(r - kb) * 2 * kNarrowO + tid], v += peer[(r - kb) * 2 * kNarrowO + kNarrowO + tid];
    }
    dbloc[tid] = l;
    dbrho[tid] = v * sigmoid(brho[tid]);
  }
  cluster.sync();
}

// The ranks of the head's bias runs: at most kHeadMaxRanks, one cluster.
int head_ranks(int n_split) { return n_split < kHeadMaxRanks ? n_split : kHeadMaxRanks; }

// O <= kNarrowO: the head kernel, dparams_plan's n_split runs in
// head_ranks(n_split) ranks of one cluster an input block; one launch. Else
// the wide kernel, its n_split runs of a tile one cluster that sums them on
// chip.
template <bool kPerSampleX>
int launch(const float* g, const float* x, const float* rho, const float* brho, float* dloc, float* drho,
           float* dbloc, float* dbrho, int S, int B, int I, int O, uint32_t seed, int n_split, cudaStream_t stream) {
  const bool narrow = O <= kNarrowO;
  // the head's input blocks and its bias block; the wide kernel's output tiles
  const int tiles_x = narrow ? (I + kHeadCols - 1) / kHeadCols + 1 : (O + kWideCols - 1) / kWideCols;
  const int tiles_y = narrow ? 1 : (I + kWideRows - 1) / kWideRows;
  if (S < 1 || B < 1 || I < 1 || O < 1 || n_split < 1 || n_split > S || tiles_y > 65535 ||
      (!narrow && n_split > kMaxRuns))
    return (int)cudaErrorInvalidValue;
  if (narrow) {
    const int n_ranks = head_ranks(n_split);
    const int slots = (n_split + n_ranks - 1) / n_ranks;  // bias runs a rank holds, at most
    const int bytes = (kHeadRegion + slots * 2 * kNarrowO) * (int)sizeof(float);
    // clusters above the portable 8 blocks and shared memory above 48 KB; set once, before any graph capture
    constexpr int kMaxBytes = 227 * 1024;
    static const cudaError_t portable = cudaFuncSetAttribute(dparams_bf16_head_kernel<kPerSampleX>,
                                                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    static const cudaError_t large = cudaFuncSetAttribute(dparams_bf16_head_kernel<kPerSampleX>,
                                                          cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxBytes);
    if (portable != cudaSuccess) return (int)portable;
    if (large != cudaSuccess) return (int)large;
    if (bytes > kMaxBytes) return (int)cudaErrorInvalidValue;
    const dim3 grid(tiles_x, 1, n_ranks);
    if (n_ranks == 1) {  // no cluster attribute: a block is its own cluster, and launches sooner
      dparams_bf16_head_kernel<kPerSampleX><<<grid, kHeadThreads, bytes, stream>>>(
          g, x, rho, brho, dloc, drho, dbloc, dbrho, S, B, I, O, seed, n_split, n_ranks);
      return (int)cudaGetLastError();
    }
    cudaLaunchAttribute cluster_dims;
    cluster_dims.id = cudaLaunchAttributeClusterDimension;
    cluster_dims.val.clusterDim.x = 1, cluster_dims.val.clusterDim.y = 1, cluster_dims.val.clusterDim.z = n_ranks;
    cudaLaunchConfig_t config = {};
    config.gridDim = grid;
    config.blockDim = dim3(kHeadThreads);
    config.dynamicSmemBytes = bytes;
    config.stream = stream;
    config.attrs = &cluster_dims;
    config.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(&config, dparams_bf16_head_kernel<kPerSampleX>, g, x, rho, brho, dloc,
                                               drho, dbloc, dbrho, S, B, I, O, seed, n_split, n_ranks);
    return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
  }
  // above the 48 KB a block gets without asking; set once, before any graph capture
  static const cudaError_t attr = cudaFuncSetAttribute(
      dparams_bf16_wide_kernel<kPerSampleX>, cudaFuncAttributeMaxDynamicSharedMemorySize, kWideSmemBytes);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid(tiles_x, tiles_y, n_split);
  if (n_split == 1) {  // no cluster attribute: a block is its own cluster, and launches sooner
    dparams_bf16_wide_kernel<kPerSampleX><<<grid, kWideThreads, kWideSmemBytes, stream>>>(
        g, x, rho, brho, dloc, drho, dbloc, dbrho, S, B, I, O, seed, n_split);
    return (int)cudaGetLastError();
  }
  cudaLaunchAttribute cluster_dims;
  cluster_dims.id = cudaLaunchAttributeClusterDimension;
  cluster_dims.val.clusterDim.x = 1, cluster_dims.val.clusterDim.y = 1, cluster_dims.val.clusterDim.z = n_split;
  cudaLaunchConfig_t config = {};
  config.gridDim = grid;
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

// Shared input x (B, I). partials: unused (the runs sum in their cluster).
extern "C" int sampled_dense_dparams_bf16(const float* g, const float* x, const float* rho, const float* brho,
                                          float* partials, float* dloc, float* drho, float* dbloc, float* dbrho,
                                          int S, int B, int I, int O, uint32_t seed, int n_split, void* stream) {
  (void)partials;
  return sampled_dense::launch<false>(g, x, rho, brho, dloc, drho, dbloc, dbrho, S, B, I, O, seed, n_split,
                                      static_cast<cudaStream_t>(stream));
}

// Per-sample input xs (S, B, I). As sampled_dense_dparams_bf16.
extern "C" int sampled_dense_xs_dparams_bf16(const float* g, const float* xs, const float* rho, const float* brho,
                                             float* partials, float* dloc, float* drho, float* dbloc,
                                             float* dbrho, int S, int B, int I, int O, uint32_t seed, int n_split,
                                             void* stream) {
  (void)partials;
  return sampled_dense::launch<true>(g, xs, rho, brho, dloc, drho, dbloc, dbrho, S, B, I, O, seed, n_split,
                                     static_cast<cudaStream_t>(stream));
}
