// Forward sampled-dense kernels: out[s] = x @ W_s + b_s, and the per-sample-input
// variant out[s] = xs[s] @ W_s + b_s, with W_s = loc + softplus(rho) * eps_s and
// b_s = bloc + softplus(brho) * eps_{b,s}, eps drawn inside the kernel.
//
// Replaces the Pallas kernels _fwd_kernel and _fwd_kernel_xs
// (robustbnns_tpu/ops/sampled_dense.py:99 and :347).
//
// Bound on the H100: at the main path's shapes (B = 128, S = 10, I x O of
// 784 x 1024, 1024 x 1024, 1024 x 10) the work is S*B*I*O exact-f32 FMAs plus
// S*(I+1)*O normals, against S*B*(I+O) + 2*I*O floats of traffic, so the FP32
// FFMA pipe bounds it, not memory. Design: one block owns a 128-row x 16-column
// output tile for a run of samples. softplus(rho) for the block's I x 16 slice
// is computed once into shared memory and reused for every sample (the TPU
// kernel's S-innermost VMEM residency, sampled_dense.py:12-15). Per sample, the
// contraction runs in 64-deep chunks: each thread draws one Philox quad of the
// chunk's sampled weights into shared memory, the x chunk is staged transposed,
// and each thread accumulates a 4-row x 2-column register tile with FFMA. The
// sampled weights never reach device memory. Ragged O (the 10-class head) and
// ragged I are masked.
#include "sampled_dense_common.cuh"

namespace sampled_dense {
namespace {

template <bool kPerSampleX>
__global__ void __launch_bounds__(kThreads) fwd_kernel(
    const float* __restrict__ x,     // (B, I), or (S, B, I) with kPerSampleX
    const float* __restrict__ loc,   // (I, O)
    const float* __restrict__ rho,   // (I, O)
    const float* __restrict__ bloc,  // (O,)
    const float* __restrict__ brho,  // (O,)
    float* __restrict__ out,         // (S, B, O)
    int S, int B, int I, int O, uint32_t seed, int s_per_block) {
  extern __shared__ __align__(16) float smem[];
  float* sp = smem;                  // [I][kCols]     softplus(rho) of this tile
  float* xt = sp + I * kCols;        // [kChunk][kRows] x chunk, transposed
  float* w = xt + kChunk * kRows;    // [kChunk][kCols] sampled weights

  const int tid = threadIdx.x;
  const int o0 = blockIdx.x * kCols;
  const int s_begin = blockIdx.y * s_per_block;
  const int s_end = min(S, s_begin + s_per_block);
  const int b0 = blockIdx.z * kRows;

  for (int idx = tid; idx < I * kCols; idx += kThreads) {
    const int i = idx / kCols, o = o0 + idx % kCols;
    sp[idx] = o < O ? softplus(rho[(size_t)i * O + o]) : 0.0f;
  }

  const int tr = tid / 8, tc = tid % 8;   // accumulate rows 4tr..4tr+3, cols 2tc, 2tc+1
  const int gk = tid / 4, gq = tid % 4;   // draw row gk, columns 4gq..4gq+3 of a chunk
  const bool vec_x = (I % 4) == 0, vec_o = (O % 4) == 0;

  for (int s = s_begin; s < s_end; ++s) {
    const float* xs = kPerSampleX ? x + (size_t)s * B * I : x;
    float acc[4][2] = {};
    for (int k0 = 0; k0 < I; k0 += kChunk) {
      __syncthreads();  // the previous chunk is consumed (and sp is ready)
      {
        const int i = k0 + gk, o = o0 + 4 * gq;
        float4 wv = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (i < I && o < O) {
          const float4 z = normal4(seed, s, i, o >> 2);
          const float4 sv = *reinterpret_cast<const float4*>(&sp[i * kCols + 4 * gq]);
          const float* lp = loc + (size_t)i * O + o;
          float4 lv = make_float4(0.0f, 0.0f, 0.0f, 0.0f);  // zero past O, where sp is zero too
          if (vec_o) {
            lv = *reinterpret_cast<const float4*>(lp);
          } else {
            lv.x = lp[0];
            if (o + 1 < O) lv.y = lp[1];
            if (o + 2 < O) lv.z = lp[2];
            if (o + 3 < O) lv.w = lp[3];
          }
          wv = make_float4(draw(lv.x, sv.x, z.x), draw(lv.y, sv.y, z.y),
                           draw(lv.z, sv.z, z.z), draw(lv.w, sv.w, z.w));
        }
        *reinterpret_cast<float4*>(&w[gk * kCols + 4 * gq]) = wv;
      }
      // x chunk: thread reads 4 consecutive inputs of one row, writes them transposed
      for (int idx = tid; idx < kRows * (kChunk / 4); idx += kThreads) {
        const int r = idx % kRows, k = 4 * (idx / kRows);
        const int b = b0 + r, i = k0 + k;
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (b < B) {
          const float* row = xs + (size_t)b * I;
          if (vec_x) {
            if (i < I) v = *reinterpret_cast<const float4*>(row + i);
          } else {
            float* vp = &v.x;
#pragma unroll
            for (int j = 0; j < 4; ++j) vp[j] = i + j < I ? row[i + j] : 0.0f;
          }
        }
        xt[(k + 0) * kRows + r] = v.x;
        xt[(k + 1) * kRows + r] = v.y;
        xt[(k + 2) * kRows + r] = v.z;
        xt[(k + 3) * kRows + r] = v.w;
      }
      __syncthreads();
      float part[4][2] = {};  // this chunk's partial sums, added to acc after it
#pragma unroll 8
      for (int k = 0; k < kChunk; ++k) {
        const float4 xv = *reinterpret_cast<const float4*>(&xt[k * kRows + 4 * tr]);
        const float2 wv = *reinterpret_cast<const float2*>(&w[k * kCols + 2 * tc]);
        part[0][0] = fmaf(xv.x, wv.x, part[0][0]);
        part[0][1] = fmaf(xv.x, wv.y, part[0][1]);
        part[1][0] = fmaf(xv.y, wv.x, part[1][0]);
        part[1][1] = fmaf(xv.y, wv.y, part[1][1]);
        part[2][0] = fmaf(xv.z, wv.x, part[2][0]);
        part[2][1] = fmaf(xv.z, wv.y, part[2][1]);
        part[3][0] = fmaf(xv.w, wv.x, part[3][0]);
        part[3][1] = fmaf(xv.w, wv.y, part[3][1]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        acc[r][0] += part[r][0];
        acc[r][1] += part[r][1];
      }
    }
    // bias row i = I: columns 2tc, 2tc+1 sit in quad (o0 + 2tc) / 4
    const float4 zb = normal4(seed, s, I, (o0 >> 2) + tc / 2);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int o = o0 + 2 * tc + c;
      if (o >= O) continue;
      const float bias = draw(bloc[o], softplus(brho[o]), component(zb, (2 * tc + c) % 4));
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int b = b0 + 4 * tr + r;
        if (b < B) out[((size_t)s * B + b) * O + o] = acc[r][c] + bias;
      }
    }
  }
}

template <bool kPerSampleX>
int launch(const float* x, const float* loc, const float* rho, const float* bloc,
           const float* brho, float* out, int S, int B, int I, int O, uint32_t seed,
           int s_per_block, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)I * kCols + kChunk * kRows + kChunk * kCols);
  cudaError_t err = cudaFuncSetAttribute(
      fwd_kernel<kPerSampleX>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, or the next launch's check reports it
    return (int)err;
  }
  const dim3 grid((O + kCols - 1) / kCols, sample_groups(S, s_per_block), (B + kRows - 1) / kRows);
  fwd_kernel<kPerSampleX><<<grid, kThreads, smem, stream>>>(
      x, loc, rho, bloc, brho, out, S, B, I, O, seed, s_per_block);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace sampled_dense

extern "C" int sampled_dense_fwd(const float* x, const float* loc, const float* rho,
                                 const float* bloc, const float* brho, float* out, int S,
                                 int B, int I, int O, uint32_t seed, int s_per_block,
                                 void* stream) {
  return sampled_dense::launch<false>(x, loc, rho, bloc, brho, out, S, B, I, O, seed,
                                      s_per_block, static_cast<cudaStream_t>(stream));
}

extern "C" int sampled_dense_xs_fwd(const float* xs, const float* loc, const float* rho,
                                    const float* bloc, const float* brho, float* out, int S,
                                    int B, int I, int O, uint32_t seed, int s_per_block,
                                    void* stream) {
  return sampled_dense::launch<true>(xs, loc, rho, bloc, brho, out, S, B, I, O, seed,
                                     s_per_block, static_cast<cudaStream_t>(stream));
}
