// The elementwise passes around the forward and dx kernels: softplus(rho) once
// per call into a scratch, and the fixed-order sum of the partial tiles.
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

int elementwise_blocks(long long n) {
  return (int)std::min<long long>((n + 255) / 256, 4096);
}

}  // namespace
}  // namespace sampled_dense
