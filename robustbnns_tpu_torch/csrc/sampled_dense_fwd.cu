// Forward sampled-dense kernels: out[s] = x @ W_s + b_s for a shared input,
// and out[s] = xs[s] @ W_s + b_s for the per-sample-input variant, with
// W_s = loc + softplus(rho) * eps_s and b_s = bloc + softplus(brho) * eps[s, I],
// eps drawn inside the kernel (sampled_dense_common.cuh); the sampled weights
// never reach device memory.
//
// Replaces the Pallas kernels _fwd_kernel and _fwd_kernel_xs
// (robustbnns_tpu/ops/sampled_dense.py:99 and :347).
//
// What bounds them on the H100. At the main path's shapes (B = 128, S = 10;
// 784 -> 1024 for fwd, 1024 -> 1024 and 1024 -> 10 for xs_fwd) the wide layers
// do S*B*I*O exact-f32 FMAs (1.03 and 1.34 G: 31 and 40 us at the H100 SXM's
// 67 TFLOP/s FP32 peak) on the FFMA pipe, which also issues the S*I*O normals
// (each feeds only B = 128 FMAs and costs about 57 instructions). The 10-class
// head is bound by reading xs (5.2 MB).
//
// Design, the dx kernels' (sampled_dense_dx.cu) with i and o swapped:
// - Wide path (O > 16). A block of 128 threads owns a 128-row x 64-output
//   tile of one sample and walks a run of 16-deep chunks of I (16 rows x 16
//   Philox quads of W_s, so a quad is never split and at B <= 128 every eps
//   is drawn once per call). Each thread accumulates 8 rows x 8 outputs from
//   float4 shared-memory reads: 4 loads per 64 FFMA. The x^T and W_s tiles
//   are double-buffered with one __syncthreads per chunk: the next chunk's x
//   tile (128 rows x 64 contiguous bytes) and its loc and softplus(rho) tiles
//   (16 rows x 256 contiguous bytes) arrive by cp.async during this chunk's
//   FFMAs, then each thread transposes its own x float4s and draws two quads
//   of W_s. Shared memory does not grow with I.
// - softplus(rho) is computed once per call into a scratch (I, O).
// - Filling the card: there is no sum over S to split, so each tile's chunks
//   of I are split into n_split runs, one block each (ops/sampled_dense.py
//   fwd_plan: 16 tiles x 10 samples x 3 runs = 480 blocks at both wide layers
//   of the main path, four blocks an SM). Each run writes its partial tile to
//   a scratch and a second pass sums the partials in the order 0 .. n_split-1:
//   no atomics, bit-identical from call to call. Run 0 adds the bias, so it
//   is added once. With one run a block writes its tile to the output itself.
// - Narrow path (O <= 16, the 10-class head). A block of 128 threads owns one
//   sample, 128 rows and a run of 32-deep chunks of I, so that the grid is
//   samples x runs and not bounded by S: per chunk it reads its 128 x 32 slice
//   of x once, coalesced, and each thread draws one Philox quad of W_s
//   (softplus inline); then each thread takes one row and all 16 outputs, with
//   W_s read as broadcasts. Partials are summed as above.
// - Any B, I, O and S: ragged edges are masked; cp.async only where the row
//   length is a multiple of 4 (else plain masked loads), so O < 4 is safe.
#include "sampled_dense_passes.cuh"

namespace sampled_dense {
namespace {

constexpr int kFwdRows = 128;     // batch rows of a wide block
constexpr int kFwdCols = 64;      // outputs o of a wide block
constexpr int kFwdDepth = 16;     // inputs i per chunk (one Philox quad row each)
constexpr int kFwdThreads = 128;  // 16 row groups x 8 output groups, 8 x 8 outputs each
constexpr int kNarrowO = 16;         // the narrow path takes O <= kNarrowO
constexpr int kNarrowThreads = 128;  // one batch row each
constexpr int kNarrowRows = 128;     // batch rows of a narrow block
constexpr int kNarrowDepth = 32;     // inputs i per narrow chunk: one quad per (i, quad) thread

// The bias of outputs o0 .. o0 + n - 1 of sample s into dst, zero past O;
// zero everywhere unless this block's run is the one that adds it.
__device__ __forceinline__ void stage_bias(float* dst, int n, bool adds, const float* __restrict__ bloc,
                                           const float* __restrict__ brho, int s, int I, int o0,
                                           int O, uint32_t seed) {
  const int q = threadIdx.x;
  if (q >= n / 4) return;
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  const int o = o0 + 4 * q;
  if (adds && o < O) {
    const float4 z = normal4(seed, s, I, o >> 2);
    float* vp = &v.x;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (o + j < O) vp[j] = draw(bloc[o + j], softplus(brho[o + j]), component(z, j));
  }
  *reinterpret_cast<float4*>(dst + 4 * q) = v;
}

// One 128-row x 64-output tile of sample s over chunks [c_begin, c_end) of
// I. Block x is s * n_split + run; y the output tile; z the row tile.
// With n_split > 1 the tile goes to partials[run] (+ s * B * O).
template <bool kPerSampleX>
__global__ void __launch_bounds__(kFwdThreads, 4) fwd_wide_kernel(
    const float* __restrict__ x,     // (B, I), or (S, B, I) with kPerSampleX
    const float* __restrict__ loc,   // (I, O)
    const float* __restrict__ sp,    // (I, O) softplus(rho)
    const float* __restrict__ bloc,  // (O,)
    const float* __restrict__ brho,  // (O,)
    float* __restrict__ out,         // (S, B, O); the partials when n_split > 1
    int S, int B, int I, int O, uint32_t seed, int n_split) {
  constexpr int kXStride = kFwdRows + 4;  // padded rows: fewer bank conflicts on the transposed stores
  __shared__ __align__(16) float xt[2][kFwdDepth][kXStride];  // x^T of a chunk
  __shared__ __align__(16) float wt[2][kFwdDepth][kFwdCols];  // W_s of a chunk
  __shared__ __align__(16) float bias[kFwdCols];

  const int tid = threadIdx.x;
  const int run = (int)blockIdx.x % n_split, s = (int)blockIdx.x / n_split;
  const int o0 = blockIdx.y * kFwdCols, b0 = blockIdx.z * kFwdRows;
  const int C = (I + kFwdDepth - 1) / kFwdDepth;
  const int c_begin = (int)((long long)C * run / n_split), c_end = (int)((long long)C * (run + 1) / n_split);
  const float* xs = kPerSampleX ? x + (size_t)s * B * I : x;
  const bool vec_i = (I & 3) == 0, vec_o = (O & 3) == 0;

  // FFMA: rows 8tr .. 8tr+7, outputs 4tc .. 4tc+3 and 32+4tc .. 32+4tc+3, so a
  // quarter warp reads one broadcast of x^T and 128 contiguous bytes of W_s.
  const int tr = tid / 8, tc = tid % 8;
  const int wq = tid % 16, wk = tid / 16;  // draws quad wq of chunk rows wk and wk + 8

  // The next chunk's x, loc and softplus(rho) tiles land here (cp.async where
  // the row length is a multiple of 4) while the FFMAs run; each thread stages
  // only the float4s it fetched itself, so no barrier guards these buffers.
  __shared__ __align__(16) float xraw[kFwdRows][kFwdDepth];
  __shared__ __align__(16) float lraw[kFwdDepth][kFwdCols];
  __shared__ __align__(16) float sraw[kFwdDepth][kFwdCols];
  auto fetch = [&](int c) {
    const int i0 = c * kFwdDepth;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int f = tid + j * kFwdThreads, r = f / 4, k = 4 * (f % 4), b = b0 + r;
      const float* src = xs + (size_t)min(b, B - 1) * I;
      if (vec_i) {
        cp_async16(&xraw[r][k], src + min(i0 + k, I - 4), b < B && i0 + k < I);
      } else {
        *reinterpret_cast<float4*>(&xraw[r][k]) =
            b < B ? load4(src, i0 + k, I) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    const int o = o0 + 4 * wq;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = wk + 8 * h, i = i0 + k;
      const size_t row = (size_t)min(i, I - 1) * O;
      if (vec_o) {
        cp_async16(&lraw[k][4 * wq], loc + row + min(o, O - 4), i < I && o < O);
        cp_async16(&sraw[k][4 * wq], sp + row + min(o, O - 4), i < I && o < O);
      } else {
        const bool in = i < I;
        *reinterpret_cast<float4*>(&lraw[k][4 * wq]) =
            in ? load4(loc + row, o, O) : make_float4(0.f, 0.f, 0.f, 0.f);
        *reinterpret_cast<float4*>(&sraw[k][4 * wq]) =
            in ? load4(sp + row, o, O) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    cp_async_commit();
  };
  auto stage = [&](int c, int buf) {
    const int i0 = c * kFwdDepth, o = o0 + 4 * wq;
    cp_async_wait_all();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int f = tid + j * kFwdThreads, r = f / 4, k = 4 * (f % 4);
      const float4 v = *reinterpret_cast<const float4*>(&xraw[r][k]);
      xt[buf][k + 0][r] = v.x;
      xt[buf][k + 1][r] = v.y;
      xt[buf][k + 2][r] = v.z;
      xt[buf][k + 3][r] = v.w;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = wk + 8 * h, i = i0 + k;
      float4 w = make_float4(0.f, 0.f, 0.f, 0.f);  // zero past I and O, where loc and sp are zero
      if (i < I && o < O) {
        const float4 lv = *reinterpret_cast<const float4*>(&lraw[k][4 * wq]);
        const float4 sv = *reinterpret_cast<const float4*>(&sraw[k][4 * wq]);
        const float4 z = normal4(seed, s, i, o >> 2);
        w = make_float4(draw(lv.x, sv.x, z.x), draw(lv.y, sv.y, z.y), draw(lv.z, sv.z, z.z),
                        draw(lv.w, sv.w, z.w));
      }
      *reinterpret_cast<float4*>(&wt[buf][k][4 * wq]) = w;
    }
  };

  stage_bias(bias, kFwdCols, run == 0, bloc, brho, s, I, o0, O, seed);
  float acc[8][8] = {};
  if (c_begin < c_end) {
    fetch(c_begin);
    stage(c_begin, 0);
  }
  __syncthreads();
  int buf = 0;
  for (int c = c_begin; c < c_end; ++c) {
    const bool more = c + 1 < c_end;
    if (more) fetch(c + 1);
#pragma unroll
    for (int k = 0; k < kFwdDepth; ++k) {
      const float4 xa = *reinterpret_cast<const float4*>(&xt[buf][k][8 * tr]);
      const float4 xb = *reinterpret_cast<const float4*>(&xt[buf][k][8 * tr + 4]);
      const float4 wa = *reinterpret_cast<const float4*>(&wt[buf][k][4 * tc]);
      const float4 wb = *reinterpret_cast<const float4*>(&wt[buf][k][32 + 4 * tc]);
      const float xv[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
      const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[r][j] = fmaf(xv[r], wv[j], acc[r][j]);
    }
    if (more) stage(c + 1, buf ^ 1);
    __syncthreads();
    buf ^= 1;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float bj = bias[(j < 4 ? 4 * tc : 28 + 4 * tc) + j];
#pragma unroll
    for (int r = 0; r < 8; ++r) acc[r][j] += bj;
  }
  const size_t plane = (size_t)B * O;
  float* dst = out + (n_split > 1 ? run * S * plane : 0) + s * plane;
  store_tile(dst, acc, 0, B, O, b0 + 8 * tr, o0 + 4 * tc);
  store_tile(dst, acc, 4, B, O, b0 + 8 * tr, o0 + 32 + 4 * tc);
}

// O <= 16: a block owns sample s, 128 rows and chunks [c_begin, c_end) of
// 32 inputs. Per chunk it stages its 128 x 32 slice of x (each row 128
// contiguous bytes) and thread (k, q) draws quad q of input k of W_s; then
// thread t takes row t and all 16 outputs, W_s read as broadcasts. Block x is
// s * n_split + run; z the row tile.
template <bool kPerSampleX>
__global__ void __launch_bounds__(kNarrowThreads) fwd_narrow_kernel(
    const float* __restrict__ x, const float* __restrict__ loc, const float* __restrict__ rho,
    const float* __restrict__ bloc, const float* __restrict__ brho,
    float* __restrict__ out,  // (S, B, O); the partials when n_split > 1
    int S, int B, int I, int O, uint32_t seed, int n_split) {
  constexpr int kXStride = kNarrowDepth + 4;  // float4 row reads by 8 threads hit 8 bank groups
  __shared__ __align__(16) float xsm[kNarrowRows][kXStride];
  __shared__ __align__(16) float ws[kNarrowDepth][kNarrowO];  // W_s rows, zero past O and I
  __shared__ __align__(16) float bias[kNarrowO];

  const int tid = threadIdx.x;
  const int run = (int)blockIdx.x % n_split, s = (int)blockIdx.x / n_split;
  const int b0 = blockIdx.z * kNarrowRows;
  const int C = (I + kNarrowDepth - 1) / kNarrowDepth;
  const int c_begin = (int)((long long)C * run / n_split), c_end = (int)((long long)C * (run + 1) / n_split);
  const float* xs = kPerSampleX ? x + (size_t)s * B * I : x;
  const bool vec_i = (I & 3) == 0;

  stage_bias(bias, kNarrowO, run == 0, bloc, brho, s, I, 0, O, seed);
  float acc[kNarrowO] = {};
  for (int c = c_begin; c < c_end; ++c) {
    const int i0 = c * kNarrowDepth;
    __syncthreads();  // the previous chunk is consumed
    constexpr int kQuadsPerRow = kNarrowDepth / 4;
#pragma unroll
    for (int j = 0; j < kNarrowRows * kQuadsPerRow / kNarrowThreads; ++j) {
      const int f = tid + j * kNarrowThreads, r = f / kQuadsPerRow, k = 4 * (f % kQuadsPerRow);
      const int b = b0 + r, i = i0 + k;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (b < B) {
        const float* row = xs + (size_t)b * I;
        if (vec_i) {
          if (i < I) v = *reinterpret_cast<const float4*>(row + i);
        } else {
          v = load4(row, i, I);
        }
      }
      *reinterpret_cast<float4*>(&xsm[r][k]) = v;
    }
    {  // thread (k, q) draws quad q of input i0 + k
      const int k = tid % kNarrowDepth, q = tid / kNarrowDepth, i = i0 + k;
      float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < I && 4 * q < O) {
        const float4 z = normal4(seed, s, i, q);
        float* wp = &w.x;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int o = 4 * q + j;
          if (o < O) {
            const size_t at = (size_t)i * O + o;
            wp[j] = draw(loc[at], softplus(rho[at]), component(z, j));
          }
        }
      }
      *reinterpret_cast<float4*>(&ws[k][4 * q]) = w;
    }
    __syncthreads();
#pragma unroll 2
    for (int k = 0; k < kNarrowDepth; k += 4) {
      const float4 xv4 = *reinterpret_cast<const float4*>(&xsm[tid][k]);
      const float xv[4] = {xv4.x, xv4.y, xv4.z, xv4.w};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int q = 0; q < kNarrowO / 4; ++q) {
          const float4 w = *reinterpret_cast<const float4*>(&ws[k + kk][4 * q]);
          acc[4 * q + 0] = fmaf(xv[kk], w.x, acc[4 * q + 0]);
          acc[4 * q + 1] = fmaf(xv[kk], w.y, acc[4 * q + 1]);
          acc[4 * q + 2] = fmaf(xv[kk], w.z, acc[4 * q + 2]);
          acc[4 * q + 3] = fmaf(xv[kk], w.w, acc[4 * q + 3]);
        }
      }
    }
  }
  __syncthreads();  // the bias is staged even when the run is empty
  const int b = b0 + tid;
  if (b >= B) return;
  float* dst = out + (n_split > 1 ? run * S * (size_t)B * O : 0) + ((size_t)s * B + b) * O;
#pragma unroll
  for (int o = 0; o < kNarrowO; ++o)
    if (o < O) dst[o] = acc[o] + bias[o];
}

// O <= kNarrowO: the narrow kernel; else softplus(rho) into sp and the wide
// kernel. Each with n_split runs of the chunks of I per tile and, when
// n_split > 1, the fixed-order sum of the partials into out.
template <bool kPerSampleX>
int launch(const float* x, const float* loc, const float* rho, const float* bloc, const float* brho,
           float* sp, float* partials, float* out, int S, int B, int I, int O, uint32_t seed, int n_split,
           cudaStream_t stream) {
  const bool narrow = O <= kNarrowO;
  const int C = (I + (narrow ? kNarrowDepth : kFwdDepth) - 1) / (narrow ? kNarrowDepth : kFwdDepth);
  const long long blocks_x = (long long)S * n_split;
  const int o_tiles = narrow ? 1 : (O + kFwdCols - 1) / kFwdCols;
  const int b_tiles = (B + kFwdRows - 1) / kFwdRows;
  if (S < 1 || B < 1 || I < 1 || O < 1 || n_split < 1 || n_split > C || (n_split > 1 && !partials) ||
      (!narrow && !sp) || blocks_x > 0x7FFFFFFF || o_tiles > 65535 || b_tiles > 65535)
    return (int)cudaErrorInvalidValue;
  float* dst = n_split > 1 ? partials : out;
  const dim3 grid((unsigned)blocks_x, o_tiles, b_tiles);
  if (narrow) {
    fwd_narrow_kernel<kPerSampleX><<<grid, kNarrowThreads, 0, stream>>>(x, loc, rho, bloc, brho, dst, S,
                                                                       B, I, O, seed, n_split);
  } else {
    const long long n_params = (long long)I * O;
    softplus_kernel<<<elementwise_blocks(n_params), 256, 0, stream>>>(rho, sp, n_params);
    fwd_wide_kernel<kPerSampleX><<<grid, kFwdThreads, 0, stream>>>(x, loc, sp, bloc, brho, dst, S, B, I,
                                                                  O, seed, n_split);
  }
  if (n_split > 1) {
    const long long n = (long long)S * B * O;
    sum_partials_kernel<<<elementwise_blocks(n), 256, 0, stream>>>(partials, out, n, n_split);
  }
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace sampled_dense

// out[s] = x W_s + b_s. sp: an (I, O) scratch for softplus(rho) (O > 16);
// partials: an (n_split, S, B, O) scratch when n_split > 1, else unused.
extern "C" int sampled_dense_fwd(const float* x, const float* loc, const float* rho, const float* bloc,
                                 const float* brho, float* sp, float* partials, float* out, int S, int B,
                                 int I, int O, uint32_t seed, int n_split, void* stream) {
  return sampled_dense::launch<false>(x, loc, rho, bloc, brho, sp, partials, out, S, B, I, O, seed, n_split,
                                      static_cast<cudaStream_t>(stream));
}

// out[s] = xs[s] W_s + b_s. As sampled_dense_fwd.
extern "C" int sampled_dense_xs_fwd(const float* xs, const float* loc, const float* rho, const float* bloc,
                                    const float* brho, float* sp, float* partials, float* out, int S, int B,
                                    int I, int O, uint32_t seed, int n_split, void* stream) {
  return sampled_dense::launch<true>(xs, loc, rho, bloc, brho, sp, partials, out, S, B, I, O, seed, n_split,
                                     static_cast<cudaStream_t>(stream));
}
