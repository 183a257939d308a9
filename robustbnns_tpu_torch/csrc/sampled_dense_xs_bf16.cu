// bf16 tensor-core kernels of the per-sample sampled-dense layers and of the
// shared-input forward, for ROBUSTBNNS_KERNEL_PRECISION=default: out[s] =
// bf16(xs[s]) bf16(W_s) + b_s, out[s] = bf16(x) bf16(W_s) + b_s and dxs[s] =
// bf16(g_s) bf16(W_s)^T, every product exact in f32 and summed in f32 into an
// f32 result. W_s = loc + softplus(rho) * eps_s is drawn in f32 from the
// f32 kernels' noise (sampled_dense_common.cuh) and rounded to bf16 only as it
// enters shared memory; the bias row and its noise stay f32 and are added in
// f32.
//
// Replaces the Pallas kernels _fwd_kernel_xs, _bwd_xs_dx_kernel and
// _fwd_kernel (robustbnns_tpu/ops/sampled_dense.py:347, :362, :99) under
// Precision.DEFAULT (_dot, :61-65): single-pass bf16 MXU products there. The
// shared-input forward is the per-sample one with x's sample stride 0
// (kSharedA): every sample's blocks read the same x (B, I), which stays in L2
// (about 0.4 MB at model_7's first layer).
//
// What bounds them on the H100. At model_7's hidden layer (B = 128, S = 10,
// 1024 -> 1024) a call does 2*S*B*I*O = 2.7 GFLOP (2.7 us at the 989 TFLOP/s
// bf16 peak) and moves 18.9 MB once (5.6 us at 3.35 TB/s), but draws S*I*O =
// 10.5 M normals of about 57 FP32-pipe instructions each: 25.5 us for a kernel
// that does nothing else (chip_smoke.NOISE_FLOOR_CU on the H100). The noise
// sets the floor. The partials design ran at 4x that floor: a block waited, chunk
// after chunk, for its loads, then its noise, then its products
// (scripts/torch_dx_probe.py --xs-bf16, PERF.md). The 10-class heads draw
// 0.1 M normals and are bound by moving xs or dxs (5.2 MB) and their launch.
//
// Design (ops/sampled_dense.py xs_bf16_plan):
// - A block of 256 threads (8 warps) owns 128 batch rows x kCols columns of
//   one sample's output (fwd: outputs o; dx: inputs i) and walks a run of
//   kDepth-deep chunks of the contraction (fwd: I; dx: O). Warp w keeps rows
//   16w .. 16w+15 as kCols/8 m16n8 f32 accumulator tiles. At most 80
//   registers a thread and 64 KB of shared memory: three blocks an SM (the
//   noise hides its latency behind 24 warps; two blocks an SM ran 1.2x
//   slower).
// - Every operand goes through shared memory by cp.async, two chunks ahead,
//   in three stages: a chunk's rows of xs (or g) in f32, and the loc and
//   softplus(rho) quads that its W_s needs (no registers held across the
//   loop). One barrier a chunk: then each thread draws its one Philox quad of
//   chunk c+1's W_s from the stage (rounded to bf16 into the other of two Bs
//   buffers) while the warps' mma.sync of chunk c run, so the FP32 and the
//   tensor pipes overlap.
// - Operands. A (xs or g) stays f32 in shared memory, rows at a stride of
//   kDepth + 8 floats, and is rounded to bf16 pairs as each fragment is read
//   (conflict-free 8-byte reads). W_s: each thread draws a whole quad (4
//   consecutive o) and stores it as one 8-byte word. In the forward the quad
//   runs along the MMA's n, so W_s is stored k-major (Bs[i][o], stride kCols +
//   8) and its B fragments are read transposed by ldmatrix.x4.trans, two n8
//   tiles a call; in dx the quad runs along k, so W_s is stored as it is
//   (Bs[i][o], stride kDepth + 8) and each B fragment register is one 32-bit
//   read.
// - Runs. While the tiles fill less than the card's block slots, each tile's
//   chunks are split into n_split <= 8 runs, one thread-block cluster. After
//   the last chunk each block parks its f32 tile in shared memory; rank r sums
//   rows [128 r / n_split, 128 (r + 1) / n_split) over the ranks in the order
//   0 .. n_split-1 through distributed shared memory, adds the bias in the
//   forward, and stores whole float4s: no partials, no second pass, no
//   atomics (bit-identical from call to call). One run launches without the
//   cluster attribute (a block is its own cluster; it launches sooner).
// - softplus(rho): the wide path (O > 16) reads it from an (I, O) scratch that
//   one elementwise pass fills per call (each value serves S samples; inline it
//   cost more than the pass); the heads (O <= 16) compute it inline, one
//   launch a call: the forward head as 128 x 16 tiles over runs of 64-deep
//   chunks of I, the dx head as 128 x 64 tiles of one 16-deep chunk of O.
// - Any B, I, O and S: ragged edges are zero-filled in shared memory and
//   masked at the store; cp.async only where the row length is a multiple of
//   4, plain loads else. All shared memory is dynamic.
#include <cooperative_groups.h>

#include "sampled_dense_mma.cuh"
#include "sampled_dense_passes.cuh"

namespace sampled_dense {
namespace {

constexpr int kXsThreads = 256;  // 8 warps of 16 rows
constexpr int kXsRows = 128;     // batch rows of a tile
constexpr int kXsStages = 3;     // chunks in shared memory: the one in use and two in flight
constexpr int kXsMaxRuns = 8;    // runs of a tile, one cluster: the portable cluster size
constexpr int kXsNarrowO = 16;   // O <= kXsNarrowO takes the heads' instances

// The shared-memory layout of one instance, in floats: kXsStages stages of a
// chunk's f32 operands as copied (A rows, then the loc and scale blocks of
// W_s's quads, item f's quad at 4f), reused after the last chunk for the
// parked tile; the chunk's W_s in bf16 (Bs); the bias of the tile's columns.
template <bool kFwd, int kCols, int kDepth>
struct XsLayout {
  static constexpr int kAStride = kDepth + 8;             // floats a row of A
  static constexpr int kItems = kDepth * kCols / 4;       // W_s quads a chunk
  static constexpr int kStage = kXsRows * kAStride + 2 * 4 * kItems;
  static constexpr int kParkStride = kCols + 8;           // floats a row of the parked tile
  static constexpr int kRegion = kXsStages * kStage > kXsRows * kParkStride ? kXsStages * kStage
                                                                            : kXsRows * kParkStride;
  static constexpr int kBStride = kFwd ? kCols + 8 : kDepth + 8;  // bf16 a row of Bs
  static constexpr int kBHalves = (kFwd ? kDepth : kCols) * kBStride;  // bf16 of one Bs buffer
  static constexpr int kFloats = kRegion + kBHalves + kCols;  // two Bs buffers
  static constexpr int kBytes = kFloats * (int)sizeof(float);
  static_assert(kItems <= kXsThreads, "one W_s quad a thread at most");
};

// The W_s quad of item f of a chunk: its input i and first output o.
template <bool kFwd, int kCols, int kDepth>
__device__ __forceinline__ void item_at(int f, int n0, int k0, int& i, int& o) {
  if (kFwd) {  // quads along the columns o: item f = (row k, quad q)
    i = k0 + f / (kCols / 4), o = n0 + 4 * (f % (kCols / 4));
  } else {  // quads along the contraction o: item f = (column n, quad q)
    i = n0 + f / (kDepth / 4), o = k0 + 4 * (f % (kDepth / 4));
  }
}

// One chunk's f32 operands into a stage: rows b0 .. b0+127, columns k0 ..
// k0+kDepth-1 of A (row-major (B, K), zero past B and K), and item f's quads
// of loc and the scale (zero past I and O) at 4f. cp.async where the row
// lengths are multiples of 4, else plain loads. Commits no group.
template <bool kFwd, int kCols, int kDepth>
__device__ __forceinline__ void fetch(float* __restrict__ stage, const float* __restrict__ a,
                                      const float* __restrict__ loc, const float* __restrict__ scale, int B,
                                      int I, int O, int b0, int n0, int k0) {
  using L = XsLayout<kFwd, kCols, kDepth>;
  constexpr int kQuads = kDepth / 4;
  const int K = kFwd ? I : O;
  const bool vec_a = (K & 3) == 0, vec_w = (O & 3) == 0;
  for (int f = threadIdx.x; f < kXsRows * kQuads; f += kXsThreads) {
    const int r = f / kQuads, k = 4 * (f % kQuads), b = b0 + r, c = k0 + k;
    float* dst = stage + r * L::kAStride + k;
    if (vec_a) {
      const bool valid = b < B && c < K;
      cp_async16(dst, valid ? a + (size_t)b * K + c : a, valid);
    } else {
      *reinterpret_cast<float4*>(dst) = b < B ? load4(a + (size_t)b * K, c, K) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  const int f = threadIdx.x;
  if (f < L::kItems) {
    int i, o;
    item_at<kFwd, kCols, kDepth>(f, n0, k0, i, o);
    float* dst = stage + kXsRows * L::kAStride + 4 * f;
    const bool valid = i < I && o < O;
    const size_t at = valid ? (size_t)i * O : 0;
    if (vec_w) {
      cp_async16(dst, loc + at + (valid ? o : 0), valid);
      cp_async16(dst + 4 * L::kItems, scale + at + (valid ? o : 0), valid);
    } else {
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(dst) = valid ? load4(loc + at, o, O) : zero;
      *reinterpret_cast<float4*>(dst + 4 * L::kItems) = valid ? load4(scale + at, o, O) : zero;
    }
  }
}

// This thread's quad of W_s for a chunk, drawn in f32 from the stage's loc and
// scale (zero past I and O), rounded to bf16 and stored as one 8-byte word
// into Bs (forward: Bs[k][q], row k = f / (kCols / 4); dx: Bs[n][q], row n =
// f / (kDepth / 4)).
template <bool kFwd, int kCols, int kDepth, bool kInlineSoftplus>
__device__ __forceinline__ void draw_w(uint16_t* __restrict__ bs, const float* __restrict__ stage, uint32_t seed,
                                       int s, int I, int O, int n0, int k0) {
  using L = XsLayout<kFwd, kCols, kDepth>;
  const int f = threadIdx.x;
  if (f >= L::kItems) return;
  int i, o;
  item_at<kFwd, kCols, kDepth>(f, n0, k0, i, o);
  float w[4] = {0.f, 0.f, 0.f, 0.f};
  if (i < I && o < O) {
    const float4 z = normal4(seed, s, i, o >> 2);
    const float4 lv = *reinterpret_cast<const float4*>(stage + kXsRows * L::kAStride + 4 * f);
    const float4 sv = *reinterpret_cast<const float4*>(stage + kXsRows * L::kAStride + 4 * L::kItems + 4 * f);
    const float zs[4] = {z.x, z.y, z.z, z.w}, ls[4] = {lv.x, lv.y, lv.z, lv.w}, ss[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
    for (int t = 0; t < 4; ++t)
      if (o + t < O) w[t] = draw(ls[t], kInlineSoftplus ? softplus(ss[t]) : ss[t], zs[t]);
  }
  const int per_row = kFwd ? kCols / 4 : kDepth / 4;
  uint16_t* dst = bs + (f / per_row) * L::kBStride + 4 * (f % per_row);
  *reinterpret_cast<uint2*>(dst) = make_uint2(pack_bf16(w[0], w[1]), pack_bf16(w[2], w[3]));
}

// One chunk of a warp's products: rows 16w .. 16w+15 of a stage's A (f32,
// rounded to bf16 pairs as read) times the kCols columns of Bs.
template <bool kFwd, int kCols, int kDepth>
__device__ __forceinline__ void mma_stage(const float* __restrict__ as, const uint16_t* __restrict__ bs,
                                          float (&acc)[kCols / 8][4]) {
  using L = XsLayout<kFwd, kCols, kDepth>;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, gq = lane / 4, tq = lane % 4;
#pragma unroll
  for (int k0 = 0; k0 < kDepth; k0 += 16) {
    const float* pa = as + (16 * warp + gq) * L::kAStride + k0 + 2 * tq;
    const float2 a0 = *reinterpret_cast<const float2*>(pa);
    const float2 a1 = *reinterpret_cast<const float2*>(pa + 8 * L::kAStride);
    const float2 a2 = *reinterpret_cast<const float2*>(pa + 8);
    const float2 a3 = *reinterpret_cast<const float2*>(pa + 8 * L::kAStride + 8);
    const uint32_t a[4] = {pack_bf16(a0.x, a0.y), pack_bf16(a1.x, a1.y), pack_bf16(a2.x, a2.y),
                           pack_bf16(a3.x, a3.y)};
#pragma unroll
    for (int p = 0; p < kCols / 16; ++p) {  // n8 tiles 2p and 2p + 1
      uint32_t b[4];
      if (kFwd) {
        // lane 8j + r: row k0 + r + 8 (j & 1) of matrix j, columns 8 (2p + (j >> 1)) ..
        const int row = k0 + (lane & 7) + 8 * ((lane >> 3) & 1);
        ldmatrix_x4_trans(b, bs + row * L::kBStride + 8 * (2 * p + (lane >> 4)));
      } else {
        const uint16_t* pb = bs + (16 * p + gq) * L::kBStride + k0 + 2 * tq;
        b[0] = smem_word(pb), b[1] = smem_word(pb + 8);
        b[2] = smem_word(pb + 8 * L::kBStride), b[3] = smem_word(pb + 8 * L::kBStride + 8);
      }
      const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
      mma_bf16_16816(acc[2 * p], a, b0);
      mma_bf16_16816(acc[2 * p + 1], a, b1);
    }
  }
}

// One 128-row x kCols-column tile of sample s over a run of the chunks of the
// contraction. Block x: the column tile; y: the sample; z: row tile * n_split
// + run. The n_split runs of a tile are one cluster along z, rank r run r.
// kSharedA (forward only): a is x (B, I), the same for every sample.
template <bool kFwd, int kCols, int kDepth, bool kInlineSoftplus, bool kSharedA = false>
__global__ void __launch_bounds__(kXsThreads, 3) xs_bf16_kernel(
    const float* __restrict__ a,      // xs (S, B, I) or g (S, B, O); x (B, I) with kSharedA
    const float* __restrict__ loc,    // (I, O)
    const float* __restrict__ scale,  // (I, O): softplus(rho), or rho with kInlineSoftplus
    const float* __restrict__ bloc,   // (O,), forward only
    const float* __restrict__ brho,   // (O,), forward only
    float* __restrict__ out,          // (S, B, O) or (S, B, I)
    int S, int B, int I, int O, uint32_t seed, int n_split) {
  using L = XsLayout<kFwd, kCols, kDepth>;
  extern __shared__ __align__(16) float dyn[];
  float* const stages = dyn;  // [kXsStages][kStage]; after the last chunk the parked tile
  uint16_t* const bs = reinterpret_cast<uint16_t*>(dyn + L::kRegion);
  float* const bias = dyn + L::kRegion + L::kBHalves;  // [kCols]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32, gq = lane / 4, tq = lane % 4;
  const int K = kFwd ? I : O, N = kFwd ? O : I;
  const int n0 = blockIdx.x * kCols, s = blockIdx.y;
  const int run = (int)blockIdx.z % n_split, b0 = (int)blockIdx.z / n_split * kXsRows;
  const int C = (K + kDepth - 1) / kDepth;
  const int c_begin = (int)((long long)C * run / n_split), c_end = (int)((long long)C * (run + 1) / n_split);
  const float* a_s = kSharedA ? a : a + (size_t)s * B * K;

  if (kFwd && tid < kCols / 4) {  // b_s of columns n0 + 4 tid .. +3, zero past O
    const int o = n0 + 4 * tid;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (o < O) {
      const float4 z = normal4(seed, s, I, o >> 2);
      const float zs[4] = {z.x, z.y, z.z, z.w};
#pragma unroll
      for (int t = 0; t < 4; ++t)
        if (o + t < O) v[t] = draw(bloc[o + t], softplus(brho[o + t]), zs[t]);
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) bias[4 * tid + t] = v[t];
  }

  // Chunk c's operands go to stage (c - c_begin) % 3, copied two chunks
  // ahead; its W_s is drawn one chunk ahead into Bs[(c - c_begin) % 2]. An
  // iteration waits for chunk c + 1's copies and, after one barrier (chunk c
  // - 1 consumed by all), copies chunk c + 2, multiplies chunk c and draws
  // chunk c + 1's W_s: the products and the noise of two chunks interleave.
  float acc[kCols / 8][4] = {};
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    if (c_begin + j < c_end)
      fetch<kFwd, kCols, kDepth>(stages + j * L::kStage, a_s, loc, scale, B, I, O, b0, n0, (c_begin + j) * kDepth);
    cp_async_commit();
  }
  if (c_begin < c_end) {
    cp_async_wait_pending<1>();
    __syncthreads();  // chunk c_begin landed for all
    draw_w<kFwd, kCols, kDepth, kInlineSoftplus>(bs, stages, seed, s, I, O, n0, c_begin * kDepth);
  }
  for (int c = c_begin; c < c_end; ++c) {
    const int it = c - c_begin;
    cp_async_wait_pending<0>();
    __syncthreads();  // chunk c + 1 landed and W_s of chunk c drawn, for all; chunk c - 1 consumed
    if (c + 2 < c_end)
      fetch<kFwd, kCols, kDepth>(stages + (it + 2) % kXsStages * L::kStage, a_s, loc, scale, B, I, O, b0, n0,
                                 (c + 2) * kDepth);
    cp_async_commit();
    // The products first: the draw's shared-memory accesses may not pass an
    // ldmatrix, its arithmetic may fill the gaps between the mma.sync.
    mma_stage<kFwd, kCols, kDepth>(stages + it % kXsStages * L::kStage, bs + it % 2 * L::kBHalves, acc);
    if (c + 1 < c_end) {
      const float* next = stages + (it + 1) % kXsStages * L::kStage;
      draw_w<kFwd, kCols, kDepth, kInlineSoftplus>(bs + (it + 1) % 2 * L::kBHalves, next, seed, s, I, O, n0,
                                                   (c + 1) * kDepth);
    }
  }
  cp_async_wait_pending<0>();
  __syncthreads();  // every product done: the stages take the parked tile

  // Park the tile (row 16w + gq + 8h, columns 8t + 2tq ..) over the stages.
  float* const park = stages;
#pragma unroll
  for (int t = 0; t < kCols / 8; ++t)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(park + (16 * warp + gq + 8 * h) * L::kParkStride + 8 * t + 2 * tq) =
          make_float2(acc[t][2 * h], acc[t][2 * h + 1]);

  // The runs of the tile are one cluster (one block when n_split = 1): after
  // they all park, rank r sums its rows over ranks 0 .. n_split-1 in that
  // order, adds the bias (forward) and stores. The second cluster barrier
  // keeps each block's shared memory alive until the others have read it.
  const cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  cluster.sync();
  const int r_begin = kXsRows * run / n_split, r_end = kXsRows * (run + 1) / n_split;
  constexpr int kQuads = kCols / 4;
  const bool vec = (N & 3) == 0;
  float* const out_s = out + (size_t)s * B * N;
  for (int f = tid; f < (r_end - r_begin) * kQuads; f += kXsThreads) {
    const int r = r_begin + f / kQuads, q = f % kQuads, b = b0 + r, col = n0 + 4 * q;
    if (b >= B || col >= N) continue;
    const int at = r * L::kParkStride + 4 * q;
    float4 v = *reinterpret_cast<const float4*>(cluster.map_shared_rank(park, 0) + at);
    for (int k = 1; k < n_split; ++k) {
      const float4 p = *reinterpret_cast<const float4*>(cluster.map_shared_rank(park, k) + at);
      v.x += p.x, v.y += p.y, v.z += p.z, v.w += p.w;
    }
    if (kFwd) v.x += bias[4 * q], v.y += bias[4 * q + 1], v.z += bias[4 * q + 2], v.w += bias[4 * q + 3];
    float* row = out_s + (size_t)b * N;
    if (vec) {
      *reinterpret_cast<float4*>(row + col) = v;
    } else {
      const float vs[4] = {v.x, v.y, v.z, v.w};
      for (int t = 0; t < 4; ++t)
        if (col + t < N) row[col + t] = vs[t];
    }
  }
  cluster.sync();
}

template <bool kFwd, int kCols, int kDepth, bool kInlineSoftplus, bool kSharedA>
int launch_tiles(const float* a, const float* loc, const float* scale, const float* bloc, const float* brho,
                 float* out, int S, int B, int I, int O, uint32_t seed, int n_split, cudaStream_t stream) {
  using L = XsLayout<kFwd, kCols, kDepth>;
  // above the 48 KB a block gets without asking; set once, before any graph capture
  static const cudaError_t attr =
      cudaFuncSetAttribute(xs_bf16_kernel<kFwd, kCols, kDepth, kInlineSoftplus, kSharedA>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (attr != cudaSuccess) return (int)attr;
  const int N = kFwd ? O : I;
  const dim3 grid((N + kCols - 1) / kCols, S, (B + kXsRows - 1) / kXsRows * n_split);
  if (n_split == 1) {  // no cluster attribute: a block is its own cluster, and launches sooner
    xs_bf16_kernel<kFwd, kCols, kDepth, kInlineSoftplus, kSharedA><<<grid, kXsThreads, L::kBytes, stream>>>(
        a, loc, scale, bloc, brho, out, S, B, I, O, seed, n_split);
    return (int)cudaGetLastError();
  }
  cudaLaunchAttribute cluster_dims;
  cluster_dims.id = cudaLaunchAttributeClusterDimension;
  cluster_dims.val.clusterDim.x = 1, cluster_dims.val.clusterDim.y = 1, cluster_dims.val.clusterDim.z = n_split;
  cudaLaunchConfig_t config = {};
  config.gridDim = grid;
  config.blockDim = dim3(kXsThreads);
  config.dynamicSmemBytes = L::kBytes;
  config.stream = stream;
  config.attrs = &cluster_dims;
  config.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&config, xs_bf16_kernel<kFwd, kCols, kDepth, kInlineSoftplus, kSharedA>,
                                             a, loc, scale, bloc, brho, out, S, B, I, O, seed, n_split);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// The kernel on xs_bf16_plan's geometry: O > 16 after the softplus pass into
// sp, O <= 16 with softplus inline in one launch.
template <bool kFwd, bool kSharedA>
int launch_xs(const float* a, const float* loc, const float* rho, const float* bloc, const float* brho, float* sp,
              float* out, int S, int B, int I, int O, uint32_t seed, int n_split, cudaStream_t stream) {
  const bool narrow = O <= kXsNarrowO;
  const int K = kFwd ? I : O, depth = narrow && kFwd ? 64 : 16;
  const long long row_blocks = (long long)(B + kXsRows - 1) / kXsRows * n_split;
  if (S < 1 || B < 1 || I < 1 || O < 1 || n_split < 1 || n_split > kXsMaxRuns ||
      n_split > (K + depth - 1) / depth || S > 65535 || row_blocks > 65535 || (!narrow && !sp))
    return (int)cudaErrorInvalidValue;
  if (narrow) {
    return kFwd ? launch_tiles<kFwd, 16, 64, true, kSharedA>(a, loc, rho, bloc, brho, out, S, B, I, O, seed, n_split,
                                                             stream)
                : launch_tiles<kFwd, 64, 16, true, kSharedA>(a, loc, rho, bloc, brho, out, S, B, I, O, seed, n_split,
                                                             stream);
  }
  const long long n_params = (long long)I * O;
  softplus_kernel<<<elementwise_blocks(n_params), 256, 0, stream>>>(rho, sp, n_params);
  return launch_tiles<kFwd, 64, 16, false, kSharedA>(a, loc, sp, bloc, brho, out, S, B, I, O, seed, n_split, stream);
}

}  // namespace
}  // namespace sampled_dense

// out[s] = bf16(xs[s]) bf16(W_s) + b_s, f32 sums. sp: an (I, O) scratch for
// softplus(rho) when O > 16; partials: unused (the runs sum in their cluster).
extern "C" int sampled_dense_xs_fwd_bf16(const float* xs, const float* loc, const float* rho, const float* bloc,
                                         const float* brho, float* sp, float* partials, float* out, int S, int B,
                                         int I, int O, uint32_t seed, int n_split, void* stream) {
  (void)partials;
  return sampled_dense::launch_xs<true, false>(xs, loc, rho, bloc, brho, sp, out, S, B, I, O, seed, n_split,
                                        static_cast<cudaStream_t>(stream));
}

// dxs[s] = bf16(g_s) bf16(W_s)^T, f32 sums. As sampled_dense_xs_fwd_bf16.
extern "C" int sampled_dense_xs_dx_bf16(const float* g, const float* loc, const float* rho, float* sp,
                                        float* partials, float* dxs, int S, int B, int I, int O, uint32_t seed,
                                        int n_split, void* stream) {
  (void)partials;
  return sampled_dense::launch_xs<false, false>(g, loc, rho, nullptr, nullptr, sp, dxs, S, B, I, O, seed, n_split,
                                         static_cast<cudaStream_t>(stream));
}

// out[s] = bf16(x) bf16(W_s) + b_s for a shared x (B, I), f32 sums. As
// sampled_dense_xs_fwd_bf16.
extern "C" int sampled_dense_fwd_bf16(const float* x, const float* loc, const float* rho, const float* bloc,
                                      const float* brho, float* sp, float* partials, float* out, int S, int B, int I,
                                      int O, uint32_t seed, int n_split, void* stream) {
  (void)partials;
  return sampled_dense::launch_xs<true, true>(x, loc, rho, bloc, brho, sp, out, S, B, I, O, seed, n_split,
                                              static_cast<cudaStream_t>(stream));
}
