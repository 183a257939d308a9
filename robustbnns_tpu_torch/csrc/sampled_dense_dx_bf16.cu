// The bf16 tensor-core input gradient summed over the samples, for
// ROBUSTBNNS_KERNEL_PRECISION=default: dx = sum_s bf16(g_s) bf16(W_s)^T, every
// product exact in f32 and summed in f32 into an f32 result. W_s = loc +
// softplus(rho) * eps_s is drawn in f32 from the f32 kernels' noise
// (sampled_dense_common.cuh) and rounded to bf16 only as it enters shared
// memory.
//
// Replaces the Pallas kernel _bwd_dx_kernel
// (robustbnns_tpu/ops/sampled_dense.py:114) under Precision.DEFAULT (_dot,
// :61-65): a single-pass bf16 MXU product there. The earlier design (128
// threads, plain loads, two barriers a chunk, 40 partial planes at model_7)
// is scripts/comparison_kernels/sampled_dense_bf16_partials.cu.
//
// What bounds it on the H100. At model_7's first layer (B = 128, S = 10,
// 784 -> 1024) a call does 2*S*B*I*O = 2.06 GFLOP (2.1 us at the 989 TFLOP/s
// bf16 peak) and moves its inputs and output once in 3.6 us at 3.35 TB/s, but
// draws S*I*O = 8.03 M normals of about 57 FP32-pipe instructions each: 0.0203
// ms for a kernel that does nothing else (chip_smoke.NOISE_FLOOR_CU on the
// H100). The noise sets the floor. The designs before this one ran their
// loads, their noise and their products one after another in every warp, so
// the three added up (PERF.md §6, scripts/torch_dx_probe.py --xs-bf16 and
// --dparams-bf16).
//
// Design (ops/sampled_dense.py dx_bf16_plan): warp-specialised.
// - A block owns 128 batch rows x kCols = 64 inputs of dx and walks a run of
//   work units (chunk c of O, 64 deep (16 when O <= 16; 32 deep ran 1.15x
//   slower: twice the hand-overs); sample s), the tile's C * S units in the
//   order u = c * S + s split into n_split runs (the input tiles read each g
//   chunk at about the same time, from L2; starting each tile at another
//   sample measured slower). 4 MMA warps keep
//   rows 32w .. 32w+31 as 2 x 8 m16n8 f32 accumulator tiles across the run;
//   16 draw warps do everything else. One block an SM (640 threads, 184 KB
//   of shared memory in four stages).
// - The draw warps copy each unit's g rows (f32, as they lie) by cp.async
//   into a ring of kDxStages stages, kDxAhead units ahead. Each draw thread
//   owns two Philox quads of W_s a unit (4 consecutive o of one input) and
//   holds their loc and softplus(rho) in registers across the S samples of a
//   chunk, loading the next chunk's while it draws this one's (softplus
//   applied once a chunk, in the kernel: no softplus pass, and loc and rho
//   are read once a run's chunk instead of once a unit: at model_7 the
//   s-major order read 64 MB of them from L2 against 6.4 MB). It draws its
//   quads and stores each as one 8-byte bf16 word into the stage's
//   Bs[i][o] (the MMA's B operand, k = o contiguous). Nothing in that loop
//   waits on the products: the FP32 pipe draws without pause.
// - The MMA warps read each stage's g rows as A (rounded to bf16 pairs as
//   read: conflict-free 8-byte reads at a row stride of kDepth + 8 floats) and
//   Bs as B (one 32-bit read a fragment register).
// - Hand-over through named barriers: a stage's "full" barrier (the draw
//   warps bar.arrive once their copies have landed and their W_s is stored;
//   the MMA warps bar.sync) and its "empty" barrier (the MMA warps bar.arrive
//   after their products; the draw warps bar.sync before they copy into the
//   stage again). No __syncthreads in the loop.
// - Runs: the n_split runs of a tile form clusters of the largest divisor of
//   n_split up to kDxMaxCluster = 2 blocks along z (at one block an SM the
//   H100's GPCs hold 66 pairs at once but only 22 clusters of 5 and 15 of 8:
//   larger clusters ran model_7's 26 in two waves). After the last unit
//   each block parks its f32 tile in shared memory; rank r sums rows
//   [128 r / c, 128 (r + 1) / c) over the c ranks in the order 0 .. c-1
//   through distributed shared memory and stores whole float4s. With one
//   cluster a tile that is dx; with p > 1 clusters a tile each writes one
//   partial tile and a short pass sums the p of them in the order 0 .. p-1.
//   No atomics: bit-identical from call to call.
// - Any B, I, O and S: ragged edges are zero-filled in shared memory and
//   masked at the store; cp.async and vector loads only where the row length
//   is a multiple of 4, plain loads else. All shared memory is dynamic.
// Measured at model_7 (PERF.md §6; H100 80GB HBM3, 700 W): 0.0512 ms against
// 0.0701 for the earlier design, 2.5x the noise floor; without the noise
// 0.0289, without the products 0.0436, with neither (copies and hand-overs
// alone) 0.0240.
#include <cooperative_groups.h>

#include "sampled_dense_mma.cuh"
#include "sampled_dense_passes.cuh"

namespace sampled_dense {
namespace {

constexpr int kDxRows = 128;       // batch rows of a tile
constexpr int kDxDrawWarps = 16;   // warps that copy and draw (8 ran 1.19x slower)
constexpr int kDxStages = 4;       // the ring of units in shared memory
constexpr int kDxAhead = 2;        // units a stage's copies are issued ahead of its draw
constexpr int kDxMaxCluster = 2;   // blocks of a cluster: pairs fill the H100's GPCs at one block an SM
constexpr int kDxMaxSplit = 64;    // runs of a tile
constexpr int kDxNarrowO = 16;     // O <= kDxNarrowO takes 16-deep units
static_assert(kDxAhead >= 1 && kDxAhead < kDxStages && 1 + 2 * kDxStages <= 16, "ring and barrier ids");

// The geometry of one instance: kCols inputs of a tile, kDepth outputs a unit.
template <int kCols, int kDepth>
struct DxLayout {
  static constexpr int kMmaWarps = kCols / 16;                 // 4 warps of 32 rows, or 8 of 16
  static constexpr int kMTiles = kDxRows / 16 / kMmaWarps;     // m16 tiles a warp
  static constexpr int kMmaThreads = 32 * kMmaWarps;
  static constexpr int kDrawThreads = 32 * kDxDrawWarps;
  static constexpr int kThreads = kMmaThreads + kDrawThreads;
  static constexpr int kAStride = kDepth + 8;                  // floats a staged g row
  static constexpr int kBStride = kDepth + 8;                  // bf16 a row of Bs
  static constexpr int kAFloats = kDxRows * kAStride;
  static constexpr int kStage = kAFloats + kCols * kBStride / 2;  // floats: g rows, then Bs
  static constexpr int kItems = kCols * kDepth / 4;            // W_s quads a unit
  static constexpr int kPer = (kItems + kDrawThreads - 1) / kDrawThreads;  // quads a draw thread
  static constexpr int kParkStride = kCols + 8;                // floats a row of the parked tile
  static constexpr int kFloats = kDxStages * kStage;
  static constexpr int kBytes = kFloats * (int)sizeof(float);
  static_assert(kDxRows * kParkStride <= kFloats, "the parked tile fits over the stages");
  static_assert(kStage % 4 == 0 && kAFloats % 4 == 0, "16-byte aligned stages");
};

// The named barriers of a stage: "full" (draw warps arrive, MMA warps wait) and "empty" (the reverse).
__device__ __forceinline__ int full_barrier(int slot) { return 1 + slot; }
__device__ __forceinline__ int empty_barrier(int slot) { return 1 + kDxStages + slot; }

// Item f of a chunk: input i0 + f / (kDepth / 4), outputs o0 + 4 (f % (kDepth / 4)) .. +3.
template <int kDepth>
__device__ __forceinline__ void dx_item(int f, int i0, int o0, int& i, int& o) {
  i = i0 + f / (kDepth / 4);
  o = o0 + 4 * (f % (kDepth / 4));
}

// Unit u's g rows b0 .. b0+127, columns o0 .. o0+kDepth-1 into a stage (row
// stride kAStride), zero past B and O, by the draw thread dt. cp.async where
// O is a multiple of 4, plain loads else. Commits no group.
template <int kCols, int kDepth>
__device__ __forceinline__ void fetch_g(float* __restrict__ stage, const float* __restrict__ g_s, int B, int O,
                                        int b0, int o0, int dt) {
  using L = DxLayout<kCols, kDepth>;
  constexpr int kQuads = kDepth / 4;
  const bool vec = (O & 3) == 0;
  for (int f = dt; f < kDxRows * kQuads; f += L::kDrawThreads) {
    const int r = f / kQuads, k = 4 * (f % kQuads), b = b0 + r, c = o0 + k;
    float* dst = stage + r * L::kAStride + k;
    if (vec) {
      const bool valid = b < B && c < O;
      cp_async16(dst, valid ? g_s + (size_t)b * O + c : g_s, valid);
    } else {
      *reinterpret_cast<float4*>(dst) = b < B ? load4(g_s + (size_t)b * O, c, O) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// The loc and rho quads of this draw thread's items of a chunk, zero past I
// and O, into registers (plain loads: their latency hides behind a chunk's
// draws).
template <int kCols, int kDepth>
__device__ __forceinline__ void load_chunk(float4 (&lv)[DxLayout<kCols, kDepth>::kPer],
                                           float4 (&rv)[DxLayout<kCols, kDepth>::kPer],
                                           const float* __restrict__ loc, const float* __restrict__ rho, int I,
                                           int O, int i0, int o0, int dt) {
  using L = DxLayout<kCols, kDepth>;
  const bool vec = (O & 3) == 0;
#pragma unroll
  for (int j = 0; j < L::kPer; ++j) {
    const int f = dt + j * L::kDrawThreads;
    int i, o;
    dx_item<kDepth>(f, i0, o0, i, o);
    lv[j] = rv[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (f < L::kItems && i < I && o < O) {
      const size_t at = (size_t)i * O;
      if (vec) {
        lv[j] = *reinterpret_cast<const float4*>(loc + at + o);
        rv[j] = *reinterpret_cast<const float4*>(rho + at + o);
      } else {
        lv[j] = load4(loc + at, o, O);
        rv[j] = load4(rho + at, o, O);
      }
    }
  }
}

__device__ __forceinline__ float4 softplus4(const float4& v) {
  return make_float4(softplus(v.x), softplus(v.y), softplus(v.z), softplus(v.w));
}

// This draw thread's quads of W_s for unit (chunk at o0, sample s), drawn in
// f32 from its chunk's loc and softplus(rho) quads (lv, sv), rounded to bf16
// and stored as 8-byte words into the stage's Bs[n][4q]. The kPer Philox
// quads come first, unconditionally and in straight-line code, so that their
// chains interleave; past I and O the draw is masked to zero.
template <int kCols, int kDepth>
__device__ __forceinline__ void draw_quads(float* __restrict__ stage, const float4 (&lv)[DxLayout<kCols, kDepth>::kPer],
                                           const float4 (&sv)[DxLayout<kCols, kDepth>::kPer], uint32_t seed, int s,
                                           int I, int O, int i0, int o0, int dt) {
  using L = DxLayout<kCols, kDepth>;
  uint16_t* bs = reinterpret_cast<uint16_t*>(stage + L::kAFloats);
  float4 z[L::kPer];
#pragma unroll
  for (int j = 0; j < L::kPer; ++j) {
    int i, o;
    dx_item<kDepth>(dt + j * L::kDrawThreads, i0, o0, i, o);
    z[j] = normal4(seed, s, i, o >> 2);
  }
#pragma unroll
  for (int j = 0; j < L::kPer; ++j) {
    const int f = dt + j * L::kDrawThreads;
    if (f >= L::kItems) break;
    int i, o;
    dx_item<kDepth>(f, i0, o0, i, o);
    const float zs[4] = {z[j].x, z[j].y, z[j].z, z[j].w}, ls[4] = {lv[j].x, lv[j].y, lv[j].z, lv[j].w};
    const float ss[4] = {sv[j].x, sv[j].y, sv[j].z, sv[j].w};
    float w[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) w[t] = i < I && o + t < O ? draw(ls[t], ss[t], zs[t]) : 0.f;
    uint16_t* dst = bs + (f / (kDepth / 4)) * L::kBStride + 4 * (f % (kDepth / 4));
    *reinterpret_cast<uint2*>(dst) = make_uint2(pack_bf16(w[0], w[1]), pack_bf16(w[2], w[3]));
  }
}

// One unit of an MMA warp's products: rows 32w .. (16w .. with 8 MMA warps)
// of the stage's g (f32, rounded to bf16 pairs as read) times the kCols
// columns of Bs.
template <int kCols, int kDepth>
__device__ __forceinline__ void mma_unit_dx(const float* __restrict__ stage, int mw,
                                            float (&acc)[DxLayout<kCols, kDepth>::kMTiles][kCols / 8][4]) {
  using L = DxLayout<kCols, kDepth>;
  const uint16_t* bs = reinterpret_cast<const uint16_t*>(stage + L::kAFloats);
  const int lane = threadIdx.x % 32, gq = lane / 4, tq = lane % 4;
#pragma unroll
  for (int k0 = 0; k0 < kDepth; k0 += 16) {
    uint32_t a[L::kMTiles][4];
#pragma unroll
    for (int mt = 0; mt < L::kMTiles; ++mt) {
      const float* pa = stage + (16 * (L::kMTiles * mw + mt) + gq) * L::kAStride + k0 + 2 * tq;
      const float2 a0 = *reinterpret_cast<const float2*>(pa);
      const float2 a1 = *reinterpret_cast<const float2*>(pa + 8 * L::kAStride);
      const float2 a2 = *reinterpret_cast<const float2*>(pa + 8);
      const float2 a3 = *reinterpret_cast<const float2*>(pa + 8 * L::kAStride + 8);
      a[mt][0] = pack_bf16(a0.x, a0.y), a[mt][1] = pack_bf16(a1.x, a1.y);
      a[mt][2] = pack_bf16(a2.x, a2.y), a[mt][3] = pack_bf16(a3.x, a3.y);
    }
#pragma unroll
    for (int nt = 0; nt < kCols / 8; ++nt) {
      const uint16_t* pb = bs + (8 * nt + gq) * L::kBStride + k0 + 2 * tq;
      const uint32_t b[2] = {smem_word(pb), smem_word(pb + 8)};
#pragma unroll
      for (int mt = 0; mt < L::kMTiles; ++mt) mma_bf16_16816(acc[mt][nt], a[mt], b);
    }
  }
}

// One 128-row x kCols-input tile of dx over a run of units u = c * S + s.
// Block x: the input tile; y: the row tile; z: the run. The runs of a tile
// form n_split / cluster clusters of `cluster` blocks along z; cluster q
// stores its sum into dst + q * B * I (dst: dx, or the partials).
template <int kCols, int kDepth>
__global__ void __launch_bounds__(DxLayout<kCols, kDepth>::kThreads, 1) dx_bf16_ws_kernel(
    const float* __restrict__ g,    // (S, B, O)
    const float* __restrict__ loc,  // (I, O)
    const float* __restrict__ rho,  // (I, O)
    float* __restrict__ dst,        // (B, I), or (n_split / cluster, B, I)
    int S, int B, int I, int O, uint32_t seed, int n_split, int cluster_size) {
  using L = DxLayout<kCols, kDepth>;
  extern __shared__ __align__(16) float dyn[];
  float* const stages = dyn;  // [kDxStages][kStage]; after the last unit the parked tile

  const int tid = threadIdx.x;
  const int i0 = blockIdx.x * kCols, b0 = blockIdx.y * kDxRows, run = blockIdx.z;
  const int C = (O + kDepth - 1) / kDepth;
  const long long total = (long long)S * C;
  const long long u_begin = total * run / n_split;
  const int U = (int)(total * (run + 1) / n_split - u_begin);  // units of this run

  float acc[L::kMTiles][kCols / 8][4] = {};
  if (tid < L::kMmaThreads) {
    // MMA warps: wait for a stage, multiply it, hand it back (unless no
    // draw thread waits for it again).
    const int mw = tid / 32;
    for (int u = 0; u < U; ++u) {
      const int slot = u % kDxStages;
      named_barrier_sync(full_barrier(slot), L::kThreads);
      mma_unit_dx<kCols, kDepth>(stages + slot * L::kStage, mw, acc);
      if (u + kDxStages < U) named_barrier_arrive(empty_barrier(slot), L::kThreads);
    }
  } else {
    // Draw warps: keep the copies kDxAhead units ahead, draw each unit's W_s
    // into its stage, and hand the stage over (its g rows landed for this
    // thread, its Bs stored).
    const int dt = tid - L::kMmaThreads;
    auto fetch = [&](int u) {
      const long long v = u_begin + u;
      const int c = (int)(v / S), s = (int)(v % S);
      fetch_g<kCols, kDepth>(stages + u % kDxStages * L::kStage, g + (size_t)s * B * O, B, O, b0, c * kDepth, dt);
    };
#pragma unroll
    for (int j = 0; j < kDxAhead; ++j) {
      if (j < U) fetch(j);
      cp_async_commit();
    }
    // loc and softplus(rho) of the current chunk (lv, sv), loc and rho of the next (nl, nr)
    float4 lv[L::kPer], sv[L::kPer], nl[L::kPer], nr[L::kPer];
    const int c_first = (int)(u_begin / S), c_last = U > 0 ? (int)((u_begin + U - 1) / S) : c_first;
    int c_cur = c_first;
    if (U > 0) {
      load_chunk<kCols, kDepth>(lv, nr, loc, rho, I, O, i0, c_first * kDepth, dt);
#pragma unroll
      for (int j = 0; j < L::kPer; ++j) sv[j] = softplus4(nr[j]);
      if (c_first < c_last) load_chunk<kCols, kDepth>(nl, nr, loc, rho, I, O, i0, (c_first + 1) * kDepth, dt);
    }
    for (int u = 0; u < U; ++u) {
      const int slot = u % kDxStages, ahead = u + kDxAhead;
      if (ahead < U) {
        // the products of unit ahead - kDxStages, the stage's last, are done
        if (ahead >= kDxStages) named_barrier_sync(empty_barrier(ahead % kDxStages), L::kThreads);
        fetch(ahead);
      }
      cp_async_commit();
      const long long v = u_begin + u;
      const int c = (int)(v / S), s = (int)(v % S);
      if (c != c_cur) {  // the next chunk: its quads were loaded during this one's draws
#pragma unroll
        for (int j = 0; j < L::kPer; ++j) lv[j] = nl[j], sv[j] = softplus4(nr[j]);
        c_cur = c;
        if (c < c_last) load_chunk<kCols, kDepth>(nl, nr, loc, rho, I, O, i0, (c + 1) * kDepth, dt);
      }
      cp_async_wait_pending<kDxAhead>();  // this thread's copies of unit u have landed
      draw_quads<kCols, kDepth>(stages + slot * L::kStage, lv, sv, seed, s, I, O, i0, c * kDepth, dt);
      named_barrier_arrive(full_barrier(slot), L::kThreads);
    }
    cp_async_wait_pending<0>();
  }
  __syncthreads();  // every product done: the stages take the parked tile

  // Park the tile (row 16 (kMTiles w + mt) + gq + 8h, columns 8t + 2tq ..) over the stages.
  float* const park = stages;
  if (tid < L::kMmaThreads) {
    const int mw = tid / 32, lane = tid % 32, gq = lane / 4, tq = lane % 4;
#pragma unroll
    for (int mt = 0; mt < L::kMTiles; ++mt)
#pragma unroll
      for (int t = 0; t < kCols / 8; ++t)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(park + (16 * (L::kMTiles * mw + mt) + gq + 8 * h) * L::kParkStride + 8 * t +
                                     2 * tq) = make_float2(acc[mt][t][2 * h], acc[mt][t][2 * h + 1]);
  }

  // The cluster's runs (one block when cluster_size = 1): after they all
  // park, rank r sums its rows over ranks 0 .. cluster_size-1 in that order
  // and stores. The second cluster barrier keeps each block's shared memory
  // alive until the others have read it.
  const cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  cluster.sync();
  const int rank = run % cluster_size;
  const int r_begin = kDxRows * rank / cluster_size, r_end = kDxRows * (rank + 1) / cluster_size;
  constexpr int kQuads = kCols / 4;
  const bool vec = (I & 3) == 0;
  float* const out = dst + (size_t)(run / cluster_size) * B * I;
  for (int f = tid; f < (r_end - r_begin) * kQuads; f += L::kThreads) {
    const int r = r_begin + f / kQuads, q = f % kQuads, b = b0 + r, col = i0 + 4 * q;
    if (b >= B || col >= I) continue;
    const int at = r * L::kParkStride + 4 * q;
    float4 v = *reinterpret_cast<const float4*>(cluster.map_shared_rank(park, 0) + at);
    for (int k = 1; k < cluster_size; ++k) {
      const float4 p = *reinterpret_cast<const float4*>(cluster.map_shared_rank(park, k) + at);
      v.x += p.x, v.y += p.y, v.z += p.z, v.w += p.w;
    }
    float* row = out + (size_t)b * I;
    if (vec) {
      *reinterpret_cast<float4*>(row + col) = v;
    } else {
      const float vs[4] = {v.x, v.y, v.z, v.w};
      for (int t = 0; t < 4; ++t)
        if (col + t < I) row[col + t] = vs[t];
    }
  }
  cluster.sync();
}

// The largest divisor of n_split up to kDxMaxCluster: the blocks of a cluster.
int dx_cluster(int n_split) {
  int c = kDxMaxCluster < n_split ? kDxMaxCluster : n_split;
  while (n_split % c) --c;
  return c;
}

template <int kCols, int kDepth>
int launch_dx_tiles(const float* g, const float* loc, const float* rho, float* dst, int S, int B, int I, int O,
                    uint32_t seed, int n_split, int cluster_size, cudaStream_t stream) {
  using L = DxLayout<kCols, kDepth>;
  // above the 48 KB a block gets without asking; set once, before any graph capture
  static const cudaError_t attr = cudaFuncSetAttribute(dx_bf16_ws_kernel<kCols, kDepth>,
                                                       cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((I + kCols - 1) / kCols, (B + kDxRows - 1) / kDxRows, n_split);
  if (cluster_size == 1) {  // no cluster attribute: a block is its own cluster, and launches sooner
    dx_bf16_ws_kernel<kCols, kDepth><<<grid, L::kThreads, L::kBytes, stream>>>(g, loc, rho, dst, S, B, I, O, seed,
                                                                              n_split, cluster_size);
    return (int)cudaGetLastError();
  }
  cudaLaunchAttribute cluster_dims;
  cluster_dims.id = cudaLaunchAttributeClusterDimension;
  cluster_dims.val.clusterDim.x = 1, cluster_dims.val.clusterDim.y = 1, cluster_dims.val.clusterDim.z = cluster_size;
  cudaLaunchConfig_t config = {};
  config.gridDim = grid;
  config.blockDim = dim3(L::kThreads);
  config.dynamicSmemBytes = L::kBytes;
  config.stream = stream;
  config.attrs = &cluster_dims;
  config.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&config, dx_bf16_ws_kernel<kCols, kDepth>, g, loc, rho, dst, S, B, I, O,
                                             seed, n_split, cluster_size);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// The kernel on dx_bf16_plan's geometry, softplus(rho) inline (one launch);
// when the runs of a tile form more than one cluster, the fixed-order sum of
// their partial tiles into dx.
template <int kCols>
int launch_dx_bf16(const float* g, const float* loc, const float* rho, float* partials, float* dx, int S, int B,
                   int I, int O, uint32_t seed, int n_split, cudaStream_t stream) {
  const bool narrow = O <= kDxNarrowO;
  const int depth = narrow ? 16 : 64;
  const long long units = (long long)S * ((O + depth - 1) / depth);
  if (S < 1 || B < 1 || I < 1 || O < 1 || n_split < 1 || n_split > kDxMaxSplit || n_split > units ||
      (B + kDxRows - 1) / kDxRows > 65535)
    return (int)cudaErrorInvalidValue;
  const int cluster_size = dx_cluster(n_split), clusters = n_split / cluster_size;
  if (clusters > 1 && !partials) return (int)cudaErrorInvalidValue;
  float* dst = clusters > 1 ? partials : dx;
  const int err = narrow ? launch_dx_tiles<kCols, 16>(g, loc, rho, dst, S, B, I, O, seed, n_split, cluster_size, stream)
                         : launch_dx_tiles<kCols, 64>(g, loc, rho, dst, S, B, I, O, seed, n_split, cluster_size, stream);
  if (err != cudaSuccess || clusters == 1) return err;
  const long long n = (long long)B * I;
  sum_partials_kernel<<<elementwise_blocks(n), 256, 0, stream>>>(partials, dx, n, clusters);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace sampled_dense

// dx = sum_s bf16(g_s) bf16(W_s)^T, f32 sums. sp: unused (softplus(rho) is
// computed in the kernel); partials: a (clusters, B, I) scratch when the
// plan's runs of a tile form more than one cluster, else unused.
extern "C" int sampled_dense_dx_bf16(const float* g, const float* loc, const float* rho, float* sp,
                                     float* partials, float* dx, int S, int B, int I, int O, uint32_t seed,
                                     int n_split, void* stream) {
  (void)sp;
  return sampled_dense::launch_dx_bf16<64>(g, loc, rho, partials, dx, S, B, I, O, seed, n_split,
                                           static_cast<cudaStream_t>(stream));
}
