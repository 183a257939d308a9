// Shared pieces of the sampled-dense kernels: the counter-based noise, the
// cp.async helpers and the tile store.
//
// eps[s, i, o] is a pure function of (seed, s, i, o): Philox4x32-10 with
// key = (seed, 0) and counter = (o >> 2, i, s, 0) gives four 32-bit words, which
// turn into the four normals of o = 4q .. 4q+3 by the JAX kernel's mantissa
// splice (sampled_dense.py:86-88) and a full Box-Muller pair per two words.
// Row i = I is the bias row. Because the stream does not depend on the tiling,
// the forward and the backward kernels tile differently and still regenerate
// the same eps. The plain PyTorch twin (ops/sampled_dense.py) computes the same
// words with int64 tensor arithmetic.
//
// The weight W = loc + softplus(rho) * eps is formed with __fmul_rn/__fadd_rn,
// so nvcc contracts nothing into an FMA there and the draw rounds exactly as
// the twin's two tensor operations do.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace sampled_dense {

constexpr float kTwoPi = 6.283185307179586f;

__device__ __forceinline__ void philox4x32_10(uint32_t c[4], uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * c[0];
    const uint32_t hi0 = __umulhi(0xD2511F53u, c[0]);
    const uint32_t lo1 = 0xCD9E8D57u * c[2];
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c[2]);
    c[0] = hi1 ^ c[1] ^ k0;
    c[1] = lo1;
    c[2] = hi0 ^ c[3] ^ k1;
    c[3] = lo0;
  }
}

// A float in [1, 2) from the top 23 bits of a word.
__device__ __forceinline__ float unit_from_bits(uint32_t r) {
  return __uint_as_float((r >> 9) | 0x3F800000u);
}

__device__ __forceinline__ void box_muller(uint32_t a, uint32_t b, float& z0, float& z1) {
  const float u1 = 2.0f - unit_from_bits(a);  // (0, 1]: log-safe
  const float rad = sqrtf(-2.0f * logf(u1));
  const float theta = kTwoPi * (unit_from_bits(b) - 1.0f);
  z0 = rad * cosf(theta);
  z1 = rad * sinf(theta);
}

// The four normals eps[s, i, 4q .. 4q+3].
__device__ __forceinline__ float4 normal4(uint32_t seed, uint32_t s, uint32_t i, uint32_t q) {
  uint32_t c[4] = {q, i, s, 0u};
  philox4x32_10(c, seed, 0u);
  float4 z;
  box_muller(c[0], c[1], z.x, z.y);
  box_muller(c[2], c[3], z.z, z.w);
  return z;
}

__device__ __forceinline__ float component(const float4& v, int j) {
  return j == 0 ? v.x : (j == 1 ? v.y : (j == 2 ? v.z : v.w));
}

// softplus(x) = max(x, 0) + log1p(exp(-|x|)), the form of jax.nn.softplus.
__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ float draw(float loc, float scale, float eps) {
  return __fadd_rn(loc, __fmul_rn(scale, eps));
}

// row[o .. o+3], zero past O (any alignment).
__device__ __forceinline__ float4 load4(const float* row, int o, int O) {
  return make_float4(o < O ? row[o] : 0.f, o + 1 < O ? row[o + 1] : 0.f,
                     o + 2 < O ? row[o + 2] : 0.f, o + 3 < O ? row[o + 3] : 0.f);
}

// 16 bytes global -> shared without registers; zeros where !valid.
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }
// cp.async.wait_group: all but this thread's newest kPending cp.async groups have landed.
template <int kPending>
__device__ __forceinline__ void cp_async_wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Named barriers 1 .. 15 (0 is __syncthreads), count threads a multiple of
// 32: bar.sync waits until count threads have arrived; bar.arrive counts this
// thread's arrival and goes on. Memory accesses before either are performed
// for every participant once the barrier completes (a producer's writes, then
// bar.arrive; a consumer's bar.sync, then its reads).
__device__ __forceinline__ void named_barrier_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void named_barrier_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Rows b .. b+7, columns c .. c+3 of a row-major (., n) matrix from the
// register tile's columns c0 .. c0+3, masked at B and n.
__device__ __forceinline__ void store_tile(float* __restrict__ dst, const float (&acc)[8][8], int c0,
                                           int B, int n, int b, int c) {
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    if (b + r >= B) break;
    float* row = dst + (size_t)(b + r) * n;
    if ((n & 3) == 0 && c < n) {
      *reinterpret_cast<float4*>(row + c) =
          make_float4(acc[r][c0], acc[r][c0 + 1], acc[r][c0 + 2], acc[r][c0 + 3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (c + j < n) row[c + j] = acc[r][c0 + j];
    }
  }
}

}  // namespace sampled_dense
