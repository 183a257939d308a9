// Input-gradient sampled-dense kernels: dx = sum_s g_s @ W_s^T for a shared
// input, and dxs[s] = g_s @ W_s^T for the per-sample-input variant, with W_s
// regenerated from the same counter-based noise as the forward kernels.
//
// Replaces the Pallas kernels _bwd_dx_kernel and _bwd_xs_dx_kernel
// (robustbnns_tpu/ops/sampled_dense.py:114 and :362).
//
// Bound on the H100: at the main path's shapes the work is S*B*I*O exact-f32
// FMAs plus S*I*O normals against S*B*O + 2*I*O + (S)*B*I floats of traffic, so
// the FP32 FFMA pipe bounds it, not memory. Design: one block owns a 128-row x
// 16-input output tile. softplus(rho) for the block's 16 x O slice is computed
// once into shared memory and reused for every sample. The contraction over O
// runs in 64-deep chunks: each thread draws one Philox quad of the chunk's
// sampled weights into shared memory, the g chunk is staged transposed, and each
// thread accumulates a 4-row x 2-column register tile with FFMA. The sum over
// samples of the shared-input gradient is a loop inside the block, in a fixed
// order, so the result is deterministic (no atomics); that variant therefore
// runs one block per output tile, while the per-sample variant also spreads
// samples over blocks.
#include "sampled_dense_common.cuh"

namespace sampled_dense {
namespace {

template <bool kSumSamples>
__global__ void __launch_bounds__(kThreads) dx_kernel(
    const float* __restrict__ g,    // (S, B, O)
    const float* __restrict__ loc,  // (I, O)
    const float* __restrict__ rho,  // (I, O)
    float* __restrict__ dx,         // (B, I) with kSumSamples, else (S, B, I)
    int S, int B, int I, int O, uint32_t seed, int s_per_block) {
  extern __shared__ __align__(16) float smem[];
  float* sp = smem;                  // [O][kCols]     softplus(rho) of this tile, transposed
  float* gt = sp + O * kCols;        // [kChunk][kRows] g chunk, transposed
  float* w = gt + kChunk * kRows;    // [kChunk][kCols] sampled weights W^T

  const int tid = threadIdx.x;
  const int i0 = blockIdx.x * kCols;
  const int s_begin = blockIdx.y * s_per_block;
  const int s_end = min(S, s_begin + s_per_block);
  const int b0 = blockIdx.z * kRows;

  for (int idx = tid; idx < O * kCols; idx += kThreads) {
    const int o = idx % O, c = idx / O, i = i0 + c;
    sp[o * kCols + c] = i < I ? softplus(rho[(size_t)i * O + o]) : 0.0f;
  }

  const int tr = tid / 8, tc = tid % 8;   // accumulate rows 4tr..4tr+3, inputs 2tc, 2tc+1
  const int gc = tid % kCols, gq = tid / kCols;  // draw input gc, outputs 4gq..4gq+3 of a chunk
  const bool vec_g = (O % 4) == 0;

  float acc[4][2] = {};
  for (int s = s_begin; s < s_end; ++s) {
    const float* gs = g + (size_t)s * B * O;
    for (int k0 = 0; k0 < O; k0 += kChunk) {
      __syncthreads();  // the previous chunk is consumed (and sp is ready)
      {
        const int i = i0 + gc;
        float z[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (i < I && k0 + 4 * gq < O) {
          const float4 n = normal4(seed, s, i, (k0 >> 2) + gq);
          z[0] = n.x; z[1] = n.y; z[2] = n.z; z[3] = n.w;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k = 4 * gq + j, o = k0 + k;
          w[k * kCols + gc] =
              (i < I && o < O) ? draw(loc[(size_t)i * O + o], sp[o * kCols + gc], z[j]) : 0.0f;
        }
      }
      // g chunk: thread reads 4 consecutive outputs of one row, writes them transposed
      for (int idx = tid; idx < kRows * (kChunk / 4); idx += kThreads) {
        const int r = idx % kRows, k = 4 * (idx / kRows);
        const int b = b0 + r, o = k0 + k;
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (b < B) {
          const float* row = gs + (size_t)b * O;
          if (vec_g) {
            if (o < O) v = *reinterpret_cast<const float4*>(row + o);
          } else {
            float* vp = &v.x;
#pragma unroll
            for (int j = 0; j < 4; ++j) vp[j] = o + j < O ? row[o + j] : 0.0f;
          }
        }
        gt[(k + 0) * kRows + r] = v.x;
        gt[(k + 1) * kRows + r] = v.y;
        gt[(k + 2) * kRows + r] = v.z;
        gt[(k + 3) * kRows + r] = v.w;
      }
      __syncthreads();
      float part[4][2] = {};  // this chunk's partial sums, added to acc after it
#pragma unroll 8
      for (int k = 0; k < kChunk; ++k) {
        const float4 gv = *reinterpret_cast<const float4*>(&gt[k * kRows + 4 * tr]);
        const float2 wv = *reinterpret_cast<const float2*>(&w[k * kCols + 2 * tc]);
        part[0][0] = fmaf(gv.x, wv.x, part[0][0]);
        part[0][1] = fmaf(gv.x, wv.y, part[0][1]);
        part[1][0] = fmaf(gv.y, wv.x, part[1][0]);
        part[1][1] = fmaf(gv.y, wv.y, part[1][1]);
        part[2][0] = fmaf(gv.z, wv.x, part[2][0]);
        part[2][1] = fmaf(gv.z, wv.y, part[2][1]);
        part[3][0] = fmaf(gv.w, wv.x, part[3][0]);
        part[3][1] = fmaf(gv.w, wv.y, part[3][1]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        acc[r][0] += part[r][0];
        acc[r][1] += part[r][1];
      }
    }
    if (!kSumSamples || s + 1 == s_end) {
      float* dst = kSumSamples ? dx : dx + (size_t)s * B * I;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int b = b0 + 4 * tr + r;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int i = i0 + 2 * tc + c;
          if (b < B && i < I) dst[(size_t)b * I + i] = acc[r][c];
          acc[r][c] = 0.0f;
        }
      }
    }
  }
}

template <bool kSumSamples>
int launch(const float* g, const float* loc, const float* rho, float* dx, int S, int B,
           int I, int O, uint32_t seed, int s_per_block, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)O * kCols + kChunk * kRows + kChunk * kCols);
  cudaError_t err = cudaFuncSetAttribute(
      dx_kernel<kSumSamples>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, or the next launch's check reports it
    return (int)err;
  }
  const dim3 grid((I + kCols - 1) / kCols, sample_groups(S, s_per_block), (B + kRows - 1) / kRows);
  dx_kernel<kSumSamples><<<grid, kThreads, smem, stream>>>(g, loc, rho, dx, S, B, I, O, seed,
                                                           s_per_block);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace sampled_dense

// dx = sum_s g_s W_s^T over all S samples in one block per tile (s_per_block = S).
extern "C" int sampled_dense_dx(const float* g, const float* loc, const float* rho, float* dx,
                                int S, int B, int I, int O, uint32_t seed, void* stream) {
  return sampled_dense::launch<true>(g, loc, rho, dx, S, B, I, O, seed, S,
                                     static_cast<cudaStream_t>(stream));
}

extern "C" int sampled_dense_xs_dx(const float* g, const float* loc, const float* rho,
                                   float* dxs, int S, int B, int I, int O, uint32_t seed,
                                   int s_per_block, void* stream) {
  return sampled_dense::launch<false>(g, loc, rho, dxs, S, B, I, O, seed, s_per_block,
                                      static_cast<cudaStream_t>(stream));
}
