// Parameter-gradient sampled-dense kernels. For the output cotangent g (S, B, O)
// and the layer input, x (B, I) shared by every sample or xs (S, B, I) per
// sample, with eps regenerated from the forward's own noise:
//
//   dW_s  = x_s^T g_s
//   dloc  = sum_s dW_s
//   drho  = sum_s dW_s * eps_s * sigmoid(rho)
//   dbloc = sum_s sum_b g_s
//   dbrho = sum_s (sum_b g_s) * eps_{b,s} * sigmoid(brho)
//
// Replaces the Pallas kernels _bwd_dparams_kernel and _bwd_xs_dparams_kernel
// (robustbnns_tpu/ops/sampled_dense.py:137 and :383). Both variants are one
// templated kernel; the shared-input one reads x with a sample stride of 0.
//
// Bound on the H100: 2*S*B*I*O FLOP of exact-f32 FFMA (the contraction over the
// batch) against S*B*O + B*I (or S*B*I) + I*O + O floats read and 2*I*O + 2*O
// written. At model_7's shapes (B = 128, S = 10) the FP32 pipe bounds the wide
// layers (0.0307 ms at 784 x 1024, 0.0401 ms at 1024 x 1024) and the bytes of
// xs bound the 10-class head (0.0016 ms).
//
// Design: one block owns a tile of dloc/drho, 64 x 64, or 16 x 16 when O <= 16
// so that the head (1024 x 10) still gives the card 64 blocks. sigmoid(rho) of
// the tile is computed once into registers. The block loops over the samples
// itself, so the sum over S is deterministic with no atomics (the TPU
// accumulated it across its sequential grid, sampled_dense.py:157-167, which
// Hopper does not have). Per sample, the contraction over B runs in 32-row
// shared-memory stages of x_s and g_s, and each of the 16 x 16 threads
// accumulates a 4 x 4 (or 1 x 1) register tile of dW_s with FFMA. Then each
// thread regenerates eps[s, i, o] for its own outputs (one Philox quad per row
// of a 4 x 4 tile) and adds dW_s and dW_s * eps * sigmoid(rho) into its
// register accumulators. The threads of the first row of the first I-tile also
// sum g_s over the batch for the bias gradients, with eps from row i = I.
// Ragged I, O and B are masked; loads are 16-byte vectors where the row length
// is a multiple of 4.
#include "sampled_dense_common.cuh"

namespace sampled_dense {
namespace {

constexpr int kDpThreads = 256;  // 16 x 16 threads
constexpr int kDpSide = 16;
constexpr int kStage = 32;       // batch rows per shared-memory stage

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// Rows [b0, b0 + kStage) and columns [c0, c0 + kCols) of a row-major (B, ld)
// matrix into dst, zero outside the matrix.
template <int kCols>
__device__ __forceinline__ void stage(float (*dst)[kCols], const float* __restrict__ src, int B,
                                      int ld, int b0, int c0, bool vec) {
  constexpr int kQuads = kCols / 4;
  for (int idx = threadIdx.x; idx < kStage * kQuads; idx += kDpThreads) {
    const int r = idx / kQuads, c = 4 * (idx % kQuads);
    const int b = b0 + r, col = c0 + c;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (b < B && col < ld) {
      const float* p = src + (size_t)b * ld + col;
      if (vec) {
        v = *reinterpret_cast<const float4*>(p);
      } else {
        float* vp = &v.x;
#pragma unroll
        for (int j = 0; j < 4; ++j) vp[j] = col + j < ld ? p[j] : 0.0f;
      }
    }
    *reinterpret_cast<float4*>(&dst[r][c]) = v;
  }
}

// eps[s, i, o] for the kTo columns o0 .. o0 + kTo - 1 of row i (o0 % 4 == 0 when kTo == 4).
template <int kTo>
__device__ __forceinline__ void row_noise(float (&e)[kTo], uint32_t seed, int s, int i, int o0) {
  if constexpr (kTo == 4) {
    const float4 z = normal4(seed, s, i, o0 >> 2);
    e[0] = z.x; e[1] = z.y; e[2] = z.z; e[3] = z.w;
  } else {
#pragma unroll
    for (int c = 0; c < kTo; ++c) e[c] = component(normal4(seed, s, i, (o0 + c) >> 2), (o0 + c) & 3);
  }
}

template <int kTi, int kTo>
__global__ void __launch_bounds__(kDpThreads) dparams_kernel(
    const float* __restrict__ g,     // (S, B, O)
    const float* __restrict__ x,     // (B, I) with x_stride 0, else (S, B, I)
    const float* __restrict__ rho,   // (I, O)
    const float* __restrict__ brho,  // (O,)
    float* __restrict__ dloc,        // (I, O)
    float* __restrict__ drho,        // (I, O)
    float* __restrict__ dbloc,       // (O,)
    float* __restrict__ dbrho,       // (O,)
    int S, int B, int I, int O, size_t x_stride, uint32_t seed) {
  constexpr int kTileI = kDpSide * kTi, kTileO = kDpSide * kTo;
  __shared__ __align__(16) float xsm[kStage][kTileI];
  __shared__ __align__(16) float gsm[kStage][kTileO];

  const int tx = threadIdx.x % kDpSide, ty = threadIdx.x / kDpSide;
  const int o0 = blockIdx.x * kTileO, i0 = blockIdx.y * kTileI;
  const int ob = o0 + tx * kTo, ib = i0 + ty * kTi;  // this thread's first output
  const bool bias = blockIdx.y == 0 && ty == 0;      // 16 threads cover the O-tile
  const bool vec_x = (I % 4) == 0, vec_g = (O % 4) == 0;

  float sig[kTi][kTo], bsig[kTo];
#pragma unroll
  for (int r = 0; r < kTi; ++r) {
#pragma unroll
    for (int c = 0; c < kTo; ++c) {
      const int i = ib + r, o = ob + c;
      sig[r][c] = (i < I && o < O) ? sigmoid(rho[(size_t)i * O + o]) : 0.0f;
    }
  }
#pragma unroll
  for (int c = 0; c < kTo; ++c) bsig[c] = (bias && ob + c < O) ? sigmoid(brho[ob + c]) : 0.0f;

  float acc_loc[kTi][kTo] = {}, acc_rho[kTi][kTo] = {};
  float acc_bloc[kTo] = {}, acc_brho[kTo] = {};
  for (int s = 0; s < S; ++s) {
    const float* xs = x + s * x_stride;
    const float* gs = g + (size_t)s * B * O;
    float dw[kTi][kTo] = {};
    float db[kTo] = {};
    for (int b0 = 0; b0 < B; b0 += kStage) {
      __syncthreads();  // the previous stage is consumed
      stage<kTileI>(xsm, xs, B, I, b0, i0, vec_x);
      stage<kTileO>(gsm, gs, B, O, b0, o0, vec_g);
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < kStage; ++k) {
        float a[kTi], v[kTo];
#pragma unroll
        for (int r = 0; r < kTi; ++r) a[r] = xsm[k][ty * kTi + r];
#pragma unroll
        for (int c = 0; c < kTo; ++c) v[c] = gsm[k][tx * kTo + c];
#pragma unroll
        for (int r = 0; r < kTi; ++r) {
#pragma unroll
          for (int c = 0; c < kTo; ++c) dw[r][c] = fmaf(a[r], v[c], dw[r][c]);
        }
        if (bias) {
#pragma unroll
          for (int c = 0; c < kTo; ++c) db[c] += v[c];
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kTi; ++r) {
      if (ib + r >= I || ob >= O) continue;
      float e[kTo];
      row_noise<kTo>(e, seed, s, ib + r, ob);
#pragma unroll
      for (int c = 0; c < kTo; ++c) {
        acc_loc[r][c] += dw[r][c];
        acc_rho[r][c] += dw[r][c] * e[c] * sig[r][c];
      }
    }
    if (bias && ob < O) {
      float e[kTo];
      row_noise<kTo>(e, seed, s, I, ob);
#pragma unroll
      for (int c = 0; c < kTo; ++c) {
        acc_bloc[c] += db[c];
        acc_brho[c] += db[c] * e[c] * bsig[c];
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kTi; ++r) {
#pragma unroll
    for (int c = 0; c < kTo; ++c) {
      const int i = ib + r, o = ob + c;
      if (i < I && o < O) {
        dloc[(size_t)i * O + o] = acc_loc[r][c];
        drho[(size_t)i * O + o] = acc_rho[r][c];
      }
    }
  }
  if (bias) {
#pragma unroll
    for (int c = 0; c < kTo; ++c) {
      if (ob + c < O) {
        dbloc[ob + c] = acc_bloc[c];
        dbrho[ob + c] = acc_brho[c];
      }
    }
  }
}

template <int kTi, int kTo>
int launch_tile(const float* g, const float* x, const float* rho, const float* brho, float* dloc,
                float* drho, float* dbloc, float* dbrho, int S, int B, int I, int O,
                size_t x_stride, uint32_t seed, cudaStream_t stream) {
  constexpr int kTileI = kDpSide * kTi, kTileO = kDpSide * kTo;
  const dim3 grid((O + kTileO - 1) / kTileO, (I + kTileI - 1) / kTileI);
  dparams_kernel<kTi, kTo><<<grid, kDpThreads, 0, stream>>>(
      g, x, rho, brho, dloc, drho, dbloc, dbrho, S, B, I, O, x_stride, seed);
  return (int)cudaGetLastError();
}

int launch(const float* g, const float* x, const float* rho, const float* brho, float* dloc,
           float* drho, float* dbloc, float* dbrho, int S, int B, int I, int O, size_t x_stride,
           uint32_t seed, cudaStream_t stream) {
  if (O <= kDpSide) {
    return launch_tile<1, 1>(g, x, rho, brho, dloc, drho, dbloc, dbrho, S, B, I, O, x_stride,
                             seed, stream);
  }
  return launch_tile<4, 4>(g, x, rho, brho, dloc, drho, dbloc, dbrho, S, B, I, O, x_stride, seed,
                           stream);
}

}  // namespace
}  // namespace sampled_dense

// Shared input x (B, I): every sample reads the same rows.
extern "C" int sampled_dense_dparams(const float* g, const float* x, const float* rho,
                                     const float* brho, float* dloc, float* drho, float* dbloc,
                                     float* dbrho, int S, int B, int I, int O, uint32_t seed,
                                     void* stream) {
  return sampled_dense::launch(g, x, rho, brho, dloc, drho, dbloc, dbrho, S, B, I, O, 0, seed,
                               static_cast<cudaStream_t>(stream));
}

// Per-sample input xs (S, B, I).
extern "C" int sampled_dense_xs_dparams(const float* g, const float* xs, const float* rho,
                                        const float* brho, float* dloc, float* drho,
                                        float* dbloc, float* dbrho, int S, int B, int I, int O,
                                        uint32_t seed, void* stream) {
  return sampled_dense::launch(g, xs, rho, brho, dloc, drho, dbloc, dbrho, S, B, I, O,
                               (size_t)B * I, seed, static_cast<cudaStream_t>(stream));
}
