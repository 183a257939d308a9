// A CPU stand-in for the CUDA runtime pieces the port's kernels use, so that
// tests/test_torch_kernel_emulation.py can build a kernel source with g++ and
// run it without a card: one std::thread per CUDA thread, the blocks of a
// grid one after another, __syncthreads as a barrier, __shared__ arrays as
// statics (one block runs at a time). Build with -std=c++20 -ffp-contract=off
// so that nothing is fused that the card computes unfused.
#pragma once
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <functional>
#include <math.h>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __forceinline__ inline
#define __shared__ static
#define __restrict__
#define __align__(n) __attribute__((aligned(n)))
#define __launch_bounds__(...)

struct float4 { float x, y, z, w; };
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }

inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;
inline std::barrier<>* block_barrier = nullptr;

inline unsigned __umulhi(unsigned a, unsigned b) { return (unsigned)(((unsigned long long)a * b) >> 32); }
inline float __uint_as_float(unsigned u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline int min(int a, int b) { return a < b ? a : b; }
inline void __syncthreads() { block_barrier->arrive_and_wait(); }

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

// kernel<<<grid, threads, smem, stream>>>(args) becomes
// emulated_launch(dim3(grid), threads, [&] { kernel(args); }).
inline void emulated_launch(dim3 grid, unsigned threads, const std::function<void()>& kernel) {
  gridDim = grid;
  blockDim = dim3(threads);
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        std::barrier<> barrier(threads);
        block_barrier = &barrier;
        std::vector<std::thread> block;
        for (unsigned t = 0; t < threads; ++t)
          block.emplace_back([&, t] {
            threadIdx = dim3(t);
            blockIdx = dim3(bx, by, bz);
            kernel();
          });
        for (auto& th : block) th.join();
      }
}
