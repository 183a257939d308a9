// The elementwise passes around the sampled-dense kernels: softplus(rho) once
// per call into a scratch, and the fixed-order sums of the partial tiles.
// Kept out of sampled_dense_common.cuh, so that a source which includes that
// header for the noise alone compiles no kernel it does not launch.
#pragma once

#include <algorithm>

#include "sampled_dense_common.cuh"

namespace sampled_dense {
namespace {

__global__ void softplus_kernel(const float* __restrict__ rho, float* __restrict__ sp, long long n) {
  for (long long k = blockIdx.x * (long long)blockDim.x + threadIdx.x; k < n;
       k += (long long)gridDim.x * blockDim.x)
    sp[k] = softplus(rho[k]);
}

// out[k] = sum_p partials[p, k], p = 0 .. n_split-1 in order.
__global__ void sum_partials_kernel(const float* __restrict__ partials, float* __restrict__ out,
                                    long long n, int n_split) {
  for (long long k = blockIdx.x * (long long)blockDim.x + threadIdx.x; k < n;
       k += (long long)gridDim.x * blockDim.x) {
    float acc = partials[k];
    for (int p = 1; p < n_split; ++p) acc += partials[p * n + k];
    out[k] = acc;
  }
}

// The dparams runs' partials, (n_split, 2, I + 1, O): plane 0 of run p holds
// its sum over its samples of dW_s, plane 1 of dW_s * eps_s, with the bias in
// row I. Summed over p = 0 .. n_split-1 in order; plane 1 is then scaled by
// sigmoid(rho), or sigmoid(brho) in row I.
__global__ void sum_dparams_kernel(const float* __restrict__ partials, const float* __restrict__ rho,
                                   const float* __restrict__ brho, float* __restrict__ dloc,
                                   float* __restrict__ drho, float* __restrict__ dbloc,
                                   float* __restrict__ dbrho, int I, int O, int n_split) {
  const long long weights = (long long)I * O, plane = weights + O;
  for (long long k = blockIdx.x * (long long)blockDim.x + threadIdx.x; k < plane;
       k += (long long)gridDim.x * blockDim.x) {
    float l = partials[k], r = partials[plane + k];
    for (int p = 1; p < n_split; ++p) {
      l += partials[2 * p * plane + k];
      r += partials[(2 * p + 1) * plane + k];
    }
    if (k < weights) {
      dloc[k] = l;
      drho[k] = r * sigmoid(rho[k]);
    } else {
      dbloc[k - weights] = l;
      dbrho[k - weights] = r * sigmoid(brho[k - weights]);
    }
  }
}

int elementwise_blocks(long long n) {
  return (int)std::min<long long>((n + 255) / 256, 4096);
}

}  // namespace
}  // namespace sampled_dense
