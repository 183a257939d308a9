// The earlier (partials) design of the bf16 sampled-dense forward and
// input-gradient kernels, kept only to time the current ones
// (robustbnns_tpu_torch/csrc/sampled_dense_dx_bf16.cu and
// sampled_dense_xs_bf16.cu) against it in one process: chip_smoke.py's
// [precision] and scripts/torch_dx_probe.py build it with the port's nvcc
// flags and -I robustbnns_tpu_torch/csrc, with chip_smoke.PARTIALS_BF16
// appended for the forwards and the per-sample dx. No entry point of the
// port calls it. It computes out[s] = x W_s + b_s and dx = sum_s g_s W_s^T,
// where every product takes operands rounded to bf16 (x or g, and W_s) and
// sums in f32 into an f32 result. W_s = loc + softplus(rho) * eps_s is drawn
// in f32 from the f32 kernels' noise (sampled_dense_common.cuh) and rounded
// to bf16 only as it enters shared memory; the bias row and its noise stay
// f32 and are added in f32, as in the f32 kernels.
//
// Replaces the Pallas kernel _bwd_dx_kernel
// (robustbnns_tpu/ops/sampled_dense.py:114) under Precision.DEFAULT (_dot,
// :61-65): single-pass bf16 MXU products there. It was the port's design of
// _bwd_dx_kernel until sampled_dense_dx_bf16.cu replaced it; its forward
// template was that of _fwd_kernel and, in its per-sample instances, of
// _fwd_kernel_xs, and the dx template's per-sample instances that of
// _bwd_xs_dx_kernel, all three replaced by sampled_dense_xs_bf16.cu. This
// source exports sampled_dense_dx_bf16_partials; chip_smoke.PARTIALS_BF16
// adds the other three.
//
// What bounds them on the H100. At the main path's shapes (B = 128, S = 10)
// the wide layers do 2*S*B*I*O = 2.06 and 2.68 GFLOP, 2.1 and 2.7 us at the
// 989 TFLOP/s bf16 tensor-core peak; moving their inputs and outputs once
// takes longer (the bytes bound). But each call also draws S*I*O normals
// (8.0 and 10.5 M, about 57 FP32-pipe instructions each), which the tensor
// cores cannot take over: the noise, not the products, sets the floor, as
// it takes about a third of the f32 kernels' time.
//
// Design: the f32 kernels' tiling and plans (ops/sampled_dense.py fwd_plan,
// dx_plan), with the FFMA loop replaced by mma.sync.m16n8k16 (bf16 in, f32
// accumulate) and without the cp.async double buffering (a simple kernel
// first; wgmma, TMA and pipelining are later work):
// - A block of 128 threads (4 warps) owns 128 batch rows x kCols columns of
//   one output tile; warp w computes rows 32w .. 32w+31 of it as 2 x kCols/8
//   m16n8 tiles, kept in f32 registers across the whole run.
// - Per chunk (kDepth deep along the contraction) the block rounds its slice
//   of x (or g) to bf16 into As[row][k], and draws the W_s chunk in f32 and
//   rounds it to bf16 into Bs[col][k]: both with k contiguous, so every A and
//   B fragment register is one 32-bit shared-memory read, and a row stride of
//   kDepth + 8 bf16 puts the 8 rows a fragment read touches on 8 distinct
//   bank groups. The forward stores W_s transposed (Bs[o][i]); dx needs W_s^T
//   as the B operand of g W_s^T, which is W_s itself (Bs[i][o]).
// - Forward: kCols = 64, kDepth = 16 (O > 16) or kCols = 16, kDepth = 32
//   (the 10-class head); dx: units of 16 outputs, kCols = 64 inputs (O > 16)
//   or 32 (O <= 16). Runs and partials as in the f32 kernels: each run writes
//   its partial tile, and the f32 sources' second pass sums them in a fixed
//   order (bit-identical from call to call). softplus(rho) is computed once
//   per call into a scratch on both paths.
// - Any B, I, O and S: ragged edges are zero-filled in shared memory and
//   masked at the store; vector loads only where the row length is a multiple
//   of 4.
#include "sampled_dense_mma.cuh"
#include "sampled_dense_passes.cuh"

// Shared-memory tiles hold bf16 bit patterns as uint16_t.
namespace sampled_dense {
namespace {

constexpr int kRows = 128;             // batch rows of a block
constexpr int kThreads = kMmaThreads;  // 4 warps of 32 rows each
constexpr int kNarrowO = 16;           // O <= kNarrowO takes the narrow tiles

// Rows b0 .. b0+127, columns k0 .. k0+kDepth-1 of a row-major (B, n) matrix,
// rounded to bf16 into As[row][k] (stride kDepth + 8), zero past B and n.
template <int kDepth>
__device__ __forceinline__ void stage_a(uint16_t* __restrict__ as, const float* __restrict__ src, int B,
                                        int n, int b0, int k0) {
  constexpr int kQuads = kDepth / 4, kStride = kDepth + 8;
  const bool vec = (n & 3) == 0;
  for (int f = threadIdx.x; f < kRows * kQuads; f += kThreads) {
    const int r = f / kQuads, k = 4 * (f % kQuads), b = b0 + r, c = k0 + k;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (b < B) {
      const float* row = src + (size_t)b * n;
      if (vec) {
        if (c < n) v = *reinterpret_cast<const float4*>(row + c);
      } else {
        v = load4(row, c, n);
      }
    }
    *reinterpret_cast<uint2*>(as + r * kStride + k) = make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
  }
}

// The accumulators of rows b0 + 32w + .., columns c0 + .. into dst (row
// length n), plus add[column - c0] where add is given; masked at B and n.
template <int kCols>
__device__ __forceinline__ void store_acc(float* __restrict__ dst, const float (&acc)[2][kCols / 8][4],
                                          const float* add, int B, int n, int b0, int c0) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int gq = lane / 4, tq = lane % 4;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int b = b0 + warp * kMmaWarpRows + 16 * mt + gq + 8 * h;
      if (b >= B) continue;
#pragma unroll
      for (int nt = 0; nt < kCols / 8; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = 8 * nt + 2 * tq + j;
          if (c0 + col < n) dst[(size_t)b * n + c0 + col] = acc[mt][nt][2 * h + j] + (add ? add[col] : 0.f);
        }
    }
}

// Forward: one 128-row x kCols-output tile of sample s over the chunks of I
// of its run. Block x is s * n_split + run; y the output tile; z the row
// tile. With n_split > 1 the tile goes to partials[run] (+ s * B * O); run 0
// adds the bias.
template <bool kPerSampleX, int kCols, int kDepth>
__global__ void __launch_bounds__(kThreads) fwd_bf16_kernel(
    const float* __restrict__ x,     // (B, I), or (S, B, I) with kPerSampleX
    const float* __restrict__ loc,   // (I, O)
    const float* __restrict__ sp,    // (I, O) softplus(rho)
    const float* __restrict__ bloc,  // (O,)
    const float* __restrict__ brho,  // (O,)
    float* __restrict__ out,         // (S, B, O); the partials when n_split > 1
    int S, int B, int I, int O, uint32_t seed, int n_split) {
  constexpr int kStride = kDepth + 8, kQuads = kCols / 4;
  __shared__ __align__(16) uint16_t as[kRows * kStride];  // x rows, k = i
  __shared__ __align__(16) uint16_t bs[kCols * kStride];  // W_s^T rows, k = i
  __shared__ float bias[kCols];

  const int tid = threadIdx.x;
  const int run = (int)blockIdx.x % n_split, s = (int)blockIdx.x / n_split;
  const int o0 = blockIdx.y * kCols, b0 = blockIdx.z * kRows;
  const int C = (I + kDepth - 1) / kDepth;
  const int c_begin = (int)((long long)C * run / n_split), c_end = (int)((long long)C * (run + 1) / n_split);
  const float* xs = kPerSampleX ? x + (size_t)s * B * I : x;

  if (tid < kCols) {
    const int o = o0 + tid;
    float v = 0.f;
    if (run == 0 && o < O) v = draw(bloc[o], softplus(brho[o]), component(normal4(seed, s, I, o >> 2), o & 3));
    bias[tid] = v;
  }
  float acc[2][kCols / 8][4] = {};
  for (int c = c_begin; c < c_end; ++c) {
    const int i0 = c * kDepth;
    __syncthreads();  // the previous chunk is consumed
    stage_a<kDepth>(as, xs, B, I, b0, i0);
    // Thread f draws quad q = f / kDepth of input i0 + f % kDepth: a warp's
    // transposed 2-byte stores then land on distinct banks.
    for (int f = tid; f < kDepth * kQuads; f += kThreads) {
      const int k = f % kDepth, q = f / kDepth, i = i0 + k, o = o0 + 4 * q;
      float w[4] = {0.f, 0.f, 0.f, 0.f};
      if (i < I && o < O) {
        const float4 lv = load4(loc + (size_t)i * O, o, O), sv = load4(sp + (size_t)i * O, o, O);
        const float4 z = normal4(seed, s, i, o >> 2);
        w[0] = draw(lv.x, sv.x, z.x), w[1] = draw(lv.y, sv.y, z.y);
        w[2] = draw(lv.z, sv.z, z.z), w[3] = draw(lv.w, sv.w, z.w);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) bs[(4 * q + j) * kStride + k] = __bfloat16_as_ushort(__float2bfloat16_rn(w[j]));
    }
    __syncthreads();
    mma_chunk<kCols, kDepth>(as, bs, acc);
  }
  __syncthreads();  // the bias is staged even when the run is empty
  const size_t plane = (size_t)B * O;
  store_acc<kCols>(out + (n_split > 1 ? run * S * plane : 0) + s * plane, acc, bias, B, O, b0, o0);
}

// dx: one 128-row x kCols-input tile over a run of work units u = s * C + c
// (c: the 16-deep chunk of O). kSum: block row y is run y of the tile's
// S * C units. Else: block row y is sample y / n_split, chunks run
// y % n_split of its C. With n_split > 1 the tile goes to partials[run]
// (dxs: + s * B * I).
template <bool kSum, int kCols>
__global__ void __launch_bounds__(kThreads) dx_bf16_kernel(
    const float* __restrict__ g,    // (S, B, O)
    const float* __restrict__ loc,  // (I, O)
    const float* __restrict__ sp,   // (I, O) softplus(rho)
    float* __restrict__ out,        // dx (B, I) or dxs (S, B, I); the partials when n_split > 1
    int S, int B, int I, int O, uint32_t seed, int n_split) {
  constexpr int kDepth = 16, kStride = kDepth + 8, kQuads = kDepth / 4;
  __shared__ __align__(16) uint16_t as[kRows * kStride];  // g rows, k = o
  __shared__ __align__(16) uint16_t bs[kCols * kStride];  // W_s rows, k = o

  const int tid = threadIdx.x;
  const int i0 = blockIdx.x * kCols, b0 = blockIdx.z * kRows;
  const int C = (O + kDepth - 1) / kDepth;
  int run, s_out;
  long long u_begin, u_end;
  if (kSum) {
    run = blockIdx.y, s_out = 0;
    const long long total = (long long)S * C;
    u_begin = total * run / n_split;
    u_end = total * (run + 1) / n_split;
  } else {
    run = blockIdx.y % n_split, s_out = blockIdx.y / n_split;
    u_begin = (long long)s_out * C + (long long)C * run / n_split;
    u_end = (long long)s_out * C + (long long)C * (run + 1) / n_split;
  }

  float acc[2][kCols / 8][4] = {};
  for (long long u = u_begin; u < u_end; ++u) {
    const int s = (int)(u / C), o0 = (int)(u % C) * kDepth;
    __syncthreads();  // the previous unit is consumed
    stage_a<kDepth>(as, g + (size_t)s * B * O, B, O, b0, o0);
    // Thread f draws quad q of input i0 + n (zero past O, where loc and sp read as zero).
    for (int f = tid; f < kCols * kQuads; f += kThreads) {
      const int n = f / kQuads, q = f % kQuads, i = i0 + n, o = o0 + 4 * q;
      float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < I && o < O) {
        const float4 lv = load4(loc + (size_t)i * O, o, O), sv = load4(sp + (size_t)i * O, o, O);
        const float4 z = normal4(seed, s, i, o >> 2);
        w = make_float4(draw(lv.x, sv.x, z.x), draw(lv.y, sv.y, z.y), draw(lv.z, sv.z, z.z),
                        draw(lv.w, sv.w, z.w));
      }
      *reinterpret_cast<uint2*>(bs + n * kStride + 4 * q) = make_uint2(pack_bf16(w.x, w.y), pack_bf16(w.z, w.w));
    }
    __syncthreads();
    mma_chunk<kCols, kDepth>(as, bs, acc);
  }
  const size_t plane = (size_t)B * I;
  float* dst = out + (n_split > 1 ? run * (kSum ? plane : S * plane) : 0) + s_out * plane;
  store_acc<kCols>(dst, acc, nullptr, B, I, b0, i0);
}

// softplus(rho) into sp; the forward kernel with n_split runs of the chunks
// of I per tile (fwd_plan); when n_split > 1, the fixed-order sum of the
// partials into out.
template <bool kPerSampleX>
int launch_fwd(const float* x, const float* loc, const float* rho, const float* bloc, const float* brho,
               float* sp, float* partials, float* out, int S, int B, int I, int O, uint32_t seed, int n_split,
               cudaStream_t stream) {
  const bool narrow = O <= kNarrowO;
  const int depth = narrow ? 32 : 16, cols = narrow ? 16 : 64;
  const int C = (I + depth - 1) / depth;
  const long long blocks_x = (long long)S * n_split;
  const int o_tiles = (O + cols - 1) / cols, b_tiles = (B + kRows - 1) / kRows;
  if (S < 1 || B < 1 || I < 1 || O < 1 || n_split < 1 || n_split > C || (n_split > 1 && !partials) || !sp ||
      blocks_x > 0x7FFFFFFF || o_tiles > 65535 || b_tiles > 65535)
    return (int)cudaErrorInvalidValue;
  const long long n_params = (long long)I * O;
  softplus_kernel<<<elementwise_blocks(n_params), 256, 0, stream>>>(rho, sp, n_params);
  float* dst = n_split > 1 ? partials : out;
  const dim3 grid((unsigned)blocks_x, o_tiles, b_tiles);
  if (narrow) {
    fwd_bf16_kernel<kPerSampleX, 16, 32><<<grid, kThreads, 0, stream>>>(x, loc, sp, bloc, brho, dst, S, B, I,
                                                                        O, seed, n_split);
  } else {
    fwd_bf16_kernel<kPerSampleX, 64, 16><<<grid, kThreads, 0, stream>>>(x, loc, sp, bloc, brho, dst, S, B, I,
                                                                        O, seed, n_split);
  }
  if (n_split > 1) {
    const long long n = (long long)S * B * O;
    sum_partials_kernel<<<elementwise_blocks(n), 256, 0, stream>>>(partials, out, n, n_split);
  }
  return (int)cudaGetLastError();
}

// softplus(rho) into sp; the dx kernel with n_split runs per tile (dx) or
// chunk runs per sample (dxs) (dx_plan); when n_split > 1, the fixed-order
// sum of the partials into out.
template <bool kSum>
int launch_dx(const float* g, const float* loc, const float* rho, float* sp, float* partials, float* out,
              int S, int B, int I, int O, uint32_t seed, int n_split, cudaStream_t stream) {
  const bool narrow = O <= kNarrowO;
  const int cols = narrow ? 32 : 64;
  if (S < 1 || B < 1 || I < 1 || O < 1 || n_split < 1 || (n_split > 1 && (!partials || narrow)) || !sp ||
      (!kSum && (long long)S * n_split > 65535))
    return (int)cudaErrorInvalidValue;
  const long long n_params = (long long)I * O;
  softplus_kernel<<<elementwise_blocks(n_params), 256, 0, stream>>>(rho, sp, n_params);
  const dim3 grid((I + cols - 1) / cols, kSum ? n_split : S * n_split, (B + kRows - 1) / kRows);
  float* dst = n_split > 1 ? partials : out;
  if (narrow) {
    dx_bf16_kernel<kSum, 32><<<grid, kThreads, 0, stream>>>(g, loc, sp, dst, S, B, I, O, seed, n_split);
  } else {
    dx_bf16_kernel<kSum, 64><<<grid, kThreads, 0, stream>>>(g, loc, sp, dst, S, B, I, O, seed, n_split);
  }
  if (n_split > 1) {
    const long long n = (long long)B * I * (kSum ? 1 : S);
    sum_partials_kernel<<<elementwise_blocks(n), 256, 0, stream>>>(partials, out, n, n_split);
  }
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace sampled_dense

// dx = sum_s bf16(g_s) bf16(W_s)^T, f32 sums, on dx_plan's geometry. sp: an
// (I, O) scratch for softplus(rho); partials: an (n_split, B, I) scratch when
// n_split > 1.
extern "C" int sampled_dense_dx_bf16_partials(const float* g, const float* loc, const float* rho, float* sp,
                                              float* partials, float* dx, int S, int B, int I, int O,
                                              uint32_t seed, int n_split, void* stream) {
  return sampled_dense::launch_dx<true>(g, loc, rho, sp, partials, dx, S, B, I, O, seed, n_split,
                                        static_cast<cudaStream_t>(stream));
}
