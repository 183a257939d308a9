// A CPU stand-in for the CUDA runtime pieces the port's kernels use, so that
// tests/test_torch_kernel_emulation.py can build a kernel source with g++ and
// run it without a card: one std::thread per CUDA thread, __syncthreads as a
// barrier, and the dynamic shared memory of a block as a buffer of its own,
// NaN at the block's start so that a read before a write shows. The blocks of
// a grid run one after another, so __shared__ arrays are statics; the blocks
// of a thread-block cluster (cudaLaunchKernelEx) run at once, with a cluster
// barrier and each other's dynamic shared memory (cooperative_groups.h here),
// so a kernel launched in clusters keeps all its shared memory dynamic. Build
// with -std=c++20 -ffp-contract=off so that nothing is fused that the card
// computes unfused.
#pragma once
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <deque>
#include <functional>
#include <limits>
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

struct EmulatedBlock {
  std::barrier<>* barrier;
  std::vector<float> smem;  // dynamic shared memory
};
struct EmulatedCluster {
  std::barrier<>* barrier;
  std::deque<EmulatedBlock>* blocks;  // by rank
};

inline thread_local dim3 threadIdx, blockIdx;
inline thread_local EmulatedBlock* current_block = nullptr;
inline thread_local EmulatedCluster* current_cluster = nullptr;
inline dim3 blockDim, gridDim;

inline unsigned __umulhi(unsigned a, unsigned b) { return (unsigned)(((unsigned long long)a * b) >> 32); }
inline float __uint_as_float(unsigned u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline int min(int a, int b) { return a < b ? a : b; }
inline void __syncthreads() { current_block->barrier->arrive_and_wait(); }

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
enum cudaLaunchAttributeID { cudaLaunchAttributeClusterDimension = 4 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
template <class Kernel>
inline cudaError_t cudaFuncSetAttribute(Kernel*, cudaFuncAttribute, int) { return cudaSuccess; }

// `extern __shared__ float name[];` becomes `float* name = emulated_dynamic_shared();`.
inline float* emulated_dynamic_shared() { return current_block->smem.data(); }

// The grid in clusters of cluster_z consecutive blocks along z, one cluster
// after another, the blocks of a cluster at once.
inline void run_grid(dim3 grid, unsigned threads, std::size_t smem, unsigned cluster_z,
                     const std::function<void()>& kernel) {
  gridDim = grid;
  blockDim = dim3(threads);
  for (unsigned bz = 0; bz < grid.z; bz += cluster_z)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        std::deque<std::barrier<>> barriers;
        std::deque<EmulatedBlock> blocks;
        for (unsigned k = 0; k < cluster_z; ++k) {
          barriers.emplace_back(threads);
          blocks.push_back({&barriers.back(),
                            std::vector<float>(smem / sizeof(float), std::numeric_limits<float>::quiet_NaN())});
        }
        std::barrier<> cluster_barrier(threads * cluster_z);
        EmulatedCluster cluster{&cluster_barrier, &blocks};
        std::vector<std::thread> team;
        for (unsigned k = 0; k < cluster_z; ++k)
          for (unsigned t = 0; t < threads; ++t)
            team.emplace_back([&, k, t] {
              threadIdx = dim3(t);
              blockIdx = dim3(bx, by, bz + k);
              current_block = &blocks[k];
              current_cluster = &cluster;
              kernel();
            });
        for (auto& th : team) th.join();
      }
}

// kernel<<<grid, threads, smem, stream>>>(args) becomes
// emulated_launch(dim3(grid), threads, smem, [&] { kernel(args); }).
inline void emulated_launch(dim3 grid, unsigned threads, std::size_t smem, const std::function<void()>& kernel) {
  run_grid(grid, threads, smem, 1, kernel);
}

union cudaLaunchAttributeValue {
  struct { unsigned x, y, z; } clusterDim;
};
struct cudaLaunchAttribute {
  cudaLaunchAttributeID id;
  cudaLaunchAttributeValue val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  std::size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};

// Clusters along z only (x = y = 1), as the port launches them.
template <class... Expected, class... Actual>
inline cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* config, void (*kernel)(Expected...),
                                      Actual&&... args) {
  unsigned cluster_z = 1;
  for (unsigned a = 0; a < config->numAttrs; ++a) {
    const cudaLaunchAttribute& attr = config->attrs[a];
    if (attr.id == cudaLaunchAttributeClusterDimension) {
      if (attr.val.clusterDim.x != 1 || attr.val.clusterDim.y != 1 || config->gridDim.z % attr.val.clusterDim.z)
        return cudaErrorInvalidValue;
      cluster_z = attr.val.clusterDim.z;
    }
  }
  run_grid(config->gridDim, config->blockDim.x, config->dynamicSmemBytes, cluster_z, [&] { kernel(args...); });
  return cudaSuccess;
}
