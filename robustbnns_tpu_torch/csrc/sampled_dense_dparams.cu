// Parameter-gradient sampled-dense kernels. For the output cotangent g (S, B, O)
// and the layer input, x (B, I) shared by every sample or xs (S, B, I) per
// sample, with eps regenerated from the forward's own noise:
//
//   dW_s  = x_s^T g_s
//   dloc  = sum_s dW_s
//   drho  = sigmoid(rho) * sum_s dW_s * eps_s
//   dbloc = sum_s sum_b g_s
//   dbrho = sigmoid(brho) * sum_s (sum_b g_s) * eps[s, I]
//
// Replaces the Pallas kernels _bwd_dparams_kernel and _bwd_xs_dparams_kernel
// (robustbnns_tpu/ops/sampled_dense.py:137 and :383). Both variants are one
// templated kernel; the shared-input one reads x with no sample offset.
//
// What bounds them on the H100. At the main path's shapes (B = 128, S = 10;
// 784 -> 1024 for dparams, 1024 -> 1024 and 1024 -> 10 for xs_dparams) the
// wide layers do S*B*I*O exact-f32 FMAs (1.03 and 1.34 G: 31 and 40 us at the
// H100 SXM's 67 TFLOP/s FP32 peak) on the FFMA pipe, which also issues the
// S*I*O normals (8.0 and 10.5 M, each feeding only B = 128 FMAs). The 10-class
// head is bound by reading xs (5.2 MB).
//
// Design:
// - Wide path (O > 16). A block of 128 threads owns a 128-input x 64-output
//   tile of dloc/drho and walks a run of samples; per sample, the contraction
//   over the batch runs in 16-deep chunks of batch rows. x_s (16 rows x 512
//   contiguous bytes) and g_s (16 rows x 256 bytes) are row-major along the
//   tile's own axes, so each chunk is a plain copy: cp.async into a double
//   buffer while the previous chunk's FFMAs run, one __syncthreads a chunk,
//   the pipeline running on across the samples of the run. Each thread
//   accumulates 8 inputs x 8 outputs of dW_s from float4 shared-memory reads
//   (4 loads per 64 FFMA). After a sample's last chunk each thread draws the
//   Philox quads of its own outputs (8 rows x 2 quads) and adds dW_s and
//   dW_s * eps_s into its running sums; sigmoid(rho) is applied once at the
//   end. The running sums (128 floats a thread) live in shared memory, each
//   thread in its own float4 column (64 KB a block, 88.5 KB with the staging,
//   two blocks an SM), so the registers hold only dW_s and the operands.
// - Bias: the blocks of input tile 0 sum the g chunk they already staged,
//   one column a thread in the first two warps, and take eps from row i = I.
// - Filling the card (ops/sampled_dense.py dparams_plan): tiles do not grow
//   with S or B (112 at 784 -> 1024, 128 at 1024 -> 1024), so while they fill
//   less than one wave of block slots each tile's S samples are split into
//   n_split <= 8 contiguous runs. The runs of a tile are one thread-block
//   cluster: at the end they sum their running sums on chip, through
//   distributed shared memory, in the order 0 .. n_split-1, scale by sigmoid
//   and store dloc, drho, dbloc and dbrho; no scratch, no second pass, no
//   atomics, so the result is bit-identical from call to call.
// - Narrow path (O <= 16, the 10-class head). A block owns 32 inputs and a
//   run of samples: per sample it stages 128-row slices of xs[s] (each row a
//   128-byte line) and g[s], and thread (k, q) accumulates input k's outputs
//   4q .. 4q+3 over the batch and draws exactly one quad. Its runs (up to one
//   a sample) write partial planes, bias row included, to a scratch
//   (n_split, 2, I + 1, O) that a second pass sums in the order
//   0 .. n_split-1 and scales by sigmoid (sampled_dense_passes.cuh); with one
//   run a block writes the outputs itself.
// - Any B, I, O and S: ragged edges are masked; cp.async and vector loads only
//   where the row length is a multiple of 4 (else plain masked loads), so
//   O < 4 and I < 4 are safe. No shared memory grows with B, I, O or S.
#include <cooperative_groups.h>

#include "sampled_dense_passes.cuh"

namespace sampled_dense {
namespace {

constexpr int kDpRows = 128;     // inputs i of a wide block
constexpr int kDpCols = 64;      // outputs o of a wide block
constexpr int kDpDepth = 16;     // batch rows per chunk
constexpr int kDpThreads = 128;  // 16 input groups x 8 output groups, 8 x 8 each
constexpr int kDpMaxRuns = 8;    // runs of a tile, one cluster: the portable cluster size
constexpr int kDpXFloats = 2 * kDpDepth * kDpRows, kDpGFloats = 2 * kDpDepth * kDpCols;
constexpr int kDpSumsFloats = 2 * 64 * kDpThreads, kDpBiasFloats = 2 * kDpCols;
constexpr int kDpSmemBytes = (kDpXFloats + kDpGFloats + kDpSumsFloats + kDpBiasFloats) * (int)sizeof(float);
constexpr int kNarrowO = 16;         // the narrow path takes O <= kNarrowO
constexpr int kNarrowThreads = 128;  // 32 inputs x 4 quads
constexpr int kNarrowCols = 32;      // inputs i of a narrow block
constexpr int kNarrowRows = 128;     // batch rows per narrow stage

// v into row[o .. o+3], masked at n; one float4 store where n % 4 == 0.
__device__ __forceinline__ void store4(float* __restrict__ row, int o, int n, float4 v) {
  if ((n & 3) == 0) {
    *reinterpret_cast<float4*>(row + o) = v;
  } else {
    const float* vp = &v.x;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (o + j < n) row[o + j] = vp[j];
  }
}

// v[j] * sigmoid(rho_row[o + j]) for o + j < n.
__device__ __forceinline__ float4 scale4(float4 v, const float* __restrict__ rho_row, int o, int n) {
  float* vp = &v.x;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (o + j < n) vp[j] *= sigmoid(rho_row[o + j]);
  return v;
}

// The samples [s_begin, s_end) of run `run` of n_split.
__device__ __forceinline__ void run_samples(int S, int run, int n_split, int& s_begin, int& s_end) {
  s_begin = (int)((long long)S * run / n_split);
  s_end = (int)((long long)S * (run + 1) / n_split);
}

// One 128-input x 64-output tile over a run of samples. Block x is the output
// tile, y the input tile, z the run; the n_split runs of a tile are one
// thread-block cluster, and rank r of it is run r.
template <bool kPerSampleX>
__global__ void __launch_bounds__(kDpThreads, 2) dparams_wide_kernel(
    const float* __restrict__ g,     // (S, B, O)
    const float* __restrict__ x,     // (B, I), or (S, B, I) with kPerSampleX
    const float* __restrict__ rho,   // (I, O)
    const float* __restrict__ brho,  // (O,)
    float* __restrict__ dloc, float* __restrict__ drho, float* __restrict__ dbloc,
    float* __restrict__ dbrho, int S, int B, int I, int O, uint32_t seed, int n_split) {
  // All of it dynamic (kDpSmemBytes): the chunks of x_s and g_s, double
  // buffered; the running sums, thread t's float4 q at [q * kDpThreads + t];
  // the bias sums of the run.
  extern __shared__ __align__(16) float dyn[];
  const auto xsm = reinterpret_cast<float (*)[kDpDepth][kDpRows]>(dyn);
  const auto gsm = reinterpret_cast<float (*)[kDpDepth][kDpCols]>(dyn + kDpXFloats);
  float* const bias_sums = dyn + kDpXFloats + kDpGFloats + kDpSumsFloats;  // [2][kDpCols]

  const int tid = threadIdx.x;
  const int o0 = blockIdx.x * kDpCols, i0 = blockIdx.y * kDpRows, run = blockIdx.z;
  int s_begin, s_end;
  run_samples(S, run, n_split, s_begin, s_end);
  const int C = (B + kDpDepth - 1) / kDpDepth;  // chunks of one sample
  const bool vec_i = (I & 3) == 0, vec_o = (O & 3) == 0;
  const bool bias = blockIdx.y == 0 && tid < kDpCols;  // column o0 + tid of the bias row

  // FFMA: inputs 8tr .. 8tr+7, outputs 4tc .. 4tc+3 and 32+4tc .. 32+4tc+3, so a
  // quarter warp reads one broadcast of x and 128 contiguous bytes of g.
  const int tr = tid / 8, tc = tid % 8;

  // Running sums, a float4 per Philox quad: q < 16 is dloc's outputs
  // (r, 4h .. 4h+3) at q = 2r + h, 16 + q drho's.
  float4* const sums = reinterpret_cast<float4*>(dyn + kDpXFloats + kDpGFloats) + tid;
  auto sum4 = [&](int q) -> float4& { return sums[q * kDpThreads]; };
#pragma unroll
  for (int q = 0; q < 32; ++q) sum4(q) = make_float4(0.f, 0.f, 0.f, 0.f);

  // Thread t stages column 4 (t % 32) of x rows t / 32 + 4j and column
  // 4 (t % 16) of g rows t / 16 + 8j of each chunk.
  constexpr int kXLoads = kDpDepth * kDpRows / 4 / kDpThreads, kGLoads = kDpDepth * kDpCols / 4 / kDpThreads;
  const int xr = tid / 32, xc = 4 * (tid % 32), gr = tid / 16, gc = 4 * (tid % 16);
  const bool x_in = i0 + xc < I, g_in = o0 + gc < O;
  const int x_col = vec_i ? min(i0 + xc, I - 4) : i0 + xc, g_col = vec_o ? min(o0 + gc, O - 4) : o0 + gc;
  auto fetch = [&](long long u, int buf) {
    const int s = (int)(u / C), b0 = (int)(u % C) * kDpDepth;
    const float* xs = (kPerSampleX ? x + (size_t)s * B * I : x) + x_col;
    const float* gs = g + (size_t)s * B * O + g_col;
#pragma unroll
    for (int j = 0; j < kXLoads; ++j) {
      const int r = xr + 4 * j, b = b0 + r;
      const float* src = xs + (size_t)min(b, B - 1) * I;
      if (vec_i) {
        cp_async16(&xsm[buf][r][xc], src, b < B && x_in);
      } else {
        *reinterpret_cast<float4*>(&xsm[buf][r][xc]) =
            b < B ? load4(src - x_col, i0 + xc, I) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
#pragma unroll
    for (int j = 0; j < kGLoads; ++j) {
      const int r = gr + 8 * j, b = b0 + r;
      const float* src = gs + (size_t)min(b, B - 1) * O;
      if (vec_o) {
        cp_async16(&gsm[buf][r][gc], src, b < B && g_in);
      } else {
        *reinterpret_cast<float4*>(&gsm[buf][r][gc]) =
            b < B ? load4(src - g_col, o0 + gc, O) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    cp_async_commit();
  };

  float dw[8][8] = {};
  float db = 0.f, bias_loc = 0.f, bias_rho = 0.f;
  // After sample s's last chunk: dW_s and dW_s * eps_s into the running sums,
  // one row of the register tile an iteration: its two Philox quads, then the
  // rows shift up by one. The loop stays rolled on purpose: 16 inlined quads
  // are some 8,000 instructions, which stream through the instruction cache
  // at every sample and stall the warps on fetches. Past I or O, dW_s is zero
  // and the sums are never stored.
  auto finish_sample = [&](int s) {
#pragma unroll 1
    for (int r = 0; r < 8; ++r) {
      const int i = i0 + 8 * tr + r;
      const float4 za = normal4(seed, s, i, (o0 + 4 * tc) >> 2);
      const float4 zb = normal4(seed, s, i, (o0 + 32 + 4 * tc) >> 2);
      const float e[8] = {za.x, za.y, za.z, za.w, zb.x, zb.y, zb.z, zb.w};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* d = &dw[0][4 * h];
        float4 l = sum4(2 * r + h), v = sum4(16 + 2 * r + h);
        l.x += d[0], l.y += d[1], l.z += d[2], l.w += d[3];
        v.x += d[0] * e[4 * h], v.y += d[1] * e[4 * h + 1], v.z += d[2] * e[4 * h + 2], v.w += d[3] * e[4 * h + 3];
        sum4(2 * r + h) = l, sum4(16 + 2 * r + h) = v;
      }
#pragma unroll
      for (int c = 0; c < 8; ++c) {
#pragma unroll
        for (int k = 0; k < 7; ++k) dw[k][c] = dw[k + 1][c];
        dw[7][c] = 0.f;
      }
    }
    if (bias && o0 + tid < O) {
      const int o = o0 + tid;
      bias_loc += db;
      bias_rho += db * component(normal4(seed, s, I, o >> 2), o & 3);
    }
    db = 0.f;
  };

  const long long u_begin = (long long)s_begin * C, u_end = (long long)s_end * C;
  if (u_begin < u_end) fetch(u_begin, 0);
  int buf = 0;
  for (long long u = u_begin; u < u_end; ++u) {
    cp_async_wait_all();
    __syncthreads();  // chunk u has landed; every thread is done with the other buffer
    if (u + 1 < u_end) fetch(u + 1, buf ^ 1);
#pragma unroll
    for (int k = 0; k < kDpDepth; ++k) {
      const float4 xa = *reinterpret_cast<const float4*>(&xsm[buf][k][8 * tr]);
      const float4 xb = *reinterpret_cast<const float4*>(&xsm[buf][k][8 * tr + 4]);
      const float4 ga = *reinterpret_cast<const float4*>(&gsm[buf][k][4 * tc]);
      const float4 gb = *reinterpret_cast<const float4*>(&gsm[buf][k][32 + 4 * tc]);
      const float xv[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
      const float gv[8] = {ga.x, ga.y, ga.z, ga.w, gb.x, gb.y, gb.z, gb.w};
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) dw[r][c] = fmaf(xv[r], gv[c], dw[r][c]);
    }
    if (bias) {
#pragma unroll
      for (int k = 0; k < kDpDepth; ++k) db += gsm[buf][k][tid];
    }
    if ((u + 1) % C == 0) finish_sample((int)(u / C));
    buf ^= 1;
  }

  // The runs of the tile are one cluster: after they all end, rank r sums
  // quads [16r / n_split, 16(r + 1) / n_split) of every thread's running sums
  // over the ranks in the order 0 .. n_split-1 through distributed shared
  // memory, scales drho by sigmoid(rho) and stores; rank 0 also the bias. No
  // atomics: the same bits at every call. The second cluster barrier keeps
  // each block's shared memory alive until the others have read it.
  if (bias) bias_sums[tid] = bias_loc, bias_sums[kDpCols + tid] = bias_rho;
  const cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  cluster.sync();
#pragma unroll 1
  for (int q = 16 * run / n_split; q < 16 * (run + 1) / n_split; ++q) {
    const float4* const first = cluster.map_shared_rank(sums, 0);
    float4 l = first[q * kDpThreads], v = first[(16 + q) * kDpThreads];
    for (int p = 1; p < n_split; ++p) {
      const float4* const peer = cluster.map_shared_rank(sums, p);
      const float4 lp = peer[q * kDpThreads], vp = peer[(16 + q) * kDpThreads];
      l.x += lp.x, l.y += lp.y, l.z += lp.z, l.w += lp.w;
      v.x += vp.x, v.y += vp.y, v.z += vp.z, v.w += vp.w;
    }
    const int i = i0 + 8 * tr + q / 2, o = o0 + 32 * (q % 2) + 4 * tc;
    if (i < I && o < O) {
      store4(dloc + (size_t)i * O, o, O, l);
      store4(drho + (size_t)i * O, o, O, scale4(v, rho + (size_t)i * O, o, O));
    }
  }
  if (run == 0 && bias && o0 + tid < O) {
    float l = bias_sums[tid], v = bias_sums[kDpCols + tid];  // rank 0's own
    for (int p = 1; p < n_split; ++p) {
      const float* const peer = cluster.map_shared_rank(bias_sums, p);
      l += peer[tid], v += peer[kDpCols + tid];
    }
    dbloc[o0 + tid] = l;
    dbrho[o0 + tid] = v * sigmoid(brho[o0 + tid]);
  }
  cluster.sync();
}

// O <= 16: a block owns 32 inputs and a run of samples. Per sample it stages
// 128-row slices of xs[s] and g[s]; thread (k, q) accumulates input i0 + k's
// outputs 4q .. 4q+3 over the batch (g read as warp broadcasts) and draws one
// Philox quad. Threads k = 0 of input block 0 also sum g for the bias. Block
// x is the input block, y the run.
template <bool kPerSampleX>
__global__ void __launch_bounds__(kNarrowThreads) dparams_narrow_kernel(
    const float* __restrict__ g, const float* __restrict__ x, const float* __restrict__ rho,
    const float* __restrict__ brho, float* __restrict__ partials, float* __restrict__ dloc,
    float* __restrict__ drho, float* __restrict__ dbloc, float* __restrict__ dbrho, int S, int B,
    int I, int O, uint32_t seed, int n_split) {
  __shared__ __align__(16) float xsm[kNarrowRows][kNarrowCols];
  __shared__ __align__(16) float gsm[kNarrowRows][kNarrowO];  // zero past O and B

  const int tid = threadIdx.x, k = tid % kNarrowCols, q = tid / kNarrowCols;
  const int i0 = blockIdx.x * kNarrowCols, i = i0 + k, run = blockIdx.y;
  int s_begin, s_end;
  run_samples(S, run, n_split, s_begin, s_end);
  const bool vec_i = (I & 3) == 0;
  const bool bias = blockIdx.x == 0 && k == 0;
  const bool mine = i < I && 4 * q < O;

  float sum_loc[4] = {}, sum_rho[4] = {}, bias_loc[4] = {}, bias_rho[4] = {};
  for (int s = s_begin; s < s_end; ++s) {
    const float* xs = kPerSampleX ? x + (size_t)s * B * I : x;
    float dw[4] = {}, db[4] = {};
    for (int b0 = 0; b0 < B; b0 += kNarrowRows) {
      __syncthreads();  // the previous stage is consumed
      constexpr int kQuadsPerRow = kNarrowCols / 4;
#pragma unroll
      for (int j = 0; j < kNarrowRows * kQuadsPerRow / kNarrowThreads; ++j) {
        const int f = tid + j * kNarrowThreads, r = f / kQuadsPerRow, c = 4 * (f % kQuadsPerRow);
        const int b = b0 + r, ic = i0 + c;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (b < B) {
          const float* row = xs + (size_t)b * I;
          if (vec_i) {
            if (ic < I) v = *reinterpret_cast<const float4*>(row + ic);
          } else {
            v = load4(row, ic, I);
          }
        }
        *reinterpret_cast<float4*>(&xsm[r][c]) = v;
      }
      for (int f = tid; f < kNarrowRows * kNarrowO; f += kNarrowThreads) {
        const int r = f / kNarrowO, o = f % kNarrowO, b = b0 + r;
        gsm[r][o] = (b < B && o < O) ? g[((size_t)s * B + b) * O + o] : 0.f;
      }
      __syncthreads();
      const int rows = min(kNarrowRows, B - b0);
#pragma unroll 4
      for (int r = 0; r < rows; ++r) {
        const float a = xsm[r][k];
        const float4 v = *reinterpret_cast<const float4*>(&gsm[r][4 * q]);
        dw[0] = fmaf(a, v.x, dw[0]);
        dw[1] = fmaf(a, v.y, dw[1]);
        dw[2] = fmaf(a, v.z, dw[2]);
        dw[3] = fmaf(a, v.w, dw[3]);
        if (bias) {
          db[0] += v.x;
          db[1] += v.y;
          db[2] += v.z;
          db[3] += v.w;
        }
      }
    }
    if (mine) {
      const float4 z = normal4(seed, s, i, q);
      const float e[4] = {z.x, z.y, z.z, z.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sum_loc[j] += dw[j];
        sum_rho[j] += dw[j] * e[j];
      }
    }
    if (bias && 4 * q < O) {
      const float4 z = normal4(seed, s, I, q);
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
  for (int j = 0; j < 4; ++j) {
    const int o = 4 * q + j;
    if (!mine || o >= O) continue;
    const size_t at = (size_t)i * O + o;
    out_loc[at] = sum_loc[j];
    out_rho[at] = split ? sum_rho[j] : sum_rho[j] * sigmoid(rho[at]);
  }
  if (bias) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = 4 * q + j;
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
  const int tiles_x = narrow ? (I + kNarrowCols - 1) / kNarrowCols : (O + kDpCols - 1) / kDpCols;
  const int tiles_y = narrow ? n_split : (I + kDpRows - 1) / kDpRows;
  if (S < 1 || B < 1 || I < 1 || O < 1 || n_split < 1 || n_split > S || tiles_y > 65535 ||
      (narrow && n_split > 1 && !partials) || (!narrow && n_split > kDpMaxRuns))
    return (int)cudaErrorInvalidValue;
  if (narrow) {
    const dim3 grid(tiles_x, tiles_y);
    dparams_narrow_kernel<kPerSampleX><<<grid, kNarrowThreads, 0, stream>>>(
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
      dparams_wide_kernel<kPerSampleX>, cudaFuncAttributeMaxDynamicSharedMemorySize, kDpSmemBytes);
  if (attr != cudaSuccess) return (int)attr;
  cudaLaunchAttribute cluster_dims;
  cluster_dims.id = cudaLaunchAttributeClusterDimension;
  cluster_dims.val.clusterDim.x = 1, cluster_dims.val.clusterDim.y = 1, cluster_dims.val.clusterDim.z = n_split;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(tiles_x, tiles_y, n_split);
  config.blockDim = dim3(kDpThreads);
  config.dynamicSmemBytes = kDpSmemBytes;
  config.stream = stream;
  config.attrs = &cluster_dims;
  config.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&config, dparams_wide_kernel<kPerSampleX>, g, x, rho, brho, dloc,
                                             drho, dbloc, dbrho, S, B, I, O, seed, n_split);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

}  // namespace
}  // namespace sampled_dense

// Shared input x (B, I). partials: an (n_split, 2, I + 1, O) scratch when
// O <= 16 and n_split > 1, else unused.
extern "C" int sampled_dense_dparams(const float* g, const float* x, const float* rho, const float* brho,
                                     float* partials, float* dloc, float* drho, float* dbloc, float* dbrho,
                                     int S, int B, int I, int O, uint32_t seed, int n_split, void* stream) {
  return sampled_dense::launch<false>(g, x, rho, brho, partials, dloc, drho, dbloc, dbrho, S, B, I, O, seed,
                                      n_split, static_cast<cudaStream_t>(stream));
}

// Per-sample input xs (S, B, I). As sampled_dense_dparams.
extern "C" int sampled_dense_xs_dparams(const float* g, const float* xs, const float* rho, const float* brho,
                                        float* partials, float* dloc, float* drho, float* dbloc, float* dbrho,
                                        int S, int B, int I, int O, uint32_t seed, int n_split, void* stream) {
  return sampled_dense::launch<true>(g, xs, rho, brho, partials, dloc, drho, dbloc, dbrho, S, B, I, O, seed,
                                     n_split, static_cast<cudaStream_t>(stream));
}
