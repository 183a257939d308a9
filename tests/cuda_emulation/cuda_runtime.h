// A CPU stand-in for the CUDA runtime pieces the port's kernels use, so that
// tests/test_torch_kernel_emulation.py can build a kernel source with g++ and
// run it without a card: one std::thread per CUDA thread, __syncthreads as a
// barrier, and the dynamic shared memory of a block as a buffer of its own,
// NaN at the block's start so that a read before a write shows. The blocks of
// a grid run one after another, so __shared__ arrays are statics; the blocks
// of a thread-block cluster (cudaLaunchKernelEx) run at once, with a cluster
// barrier and each other's dynamic shared memory (cooperative_groups.h here),
// so a kernel launched in clusters keeps all its shared memory dynamic. The
// warp-wide instructions (__shfl_xor_sync here, mma.sync and ldmatrix through
// emulated_mma_m16n8k16_bf16 and emulated_ldmatrix_x4_trans) exchange the
// lanes' registers through a per-block buffer between two barriers of the
// warp's 32 threads, which stand in for the warp's convergence: a kernel
// reaches each of them with every lane of the warp (a warp-specialised kernel
// with some warps only), and each call asserts that all 32 lanes are at the
// same such call. Named barriers (bar.sync and bar.arrive with an id and a
// thread count, emulated_named_barrier) count arrivals per block and assert
// that no thread arrives twice at one instance of a barrier. Build with
// -std=c++20 -ffp-contract=off so that nothing is fused that the card
// computes unfused.
#pragma once
#include <barrier>
#include <cassert>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <condition_variable>
#include <cstring>
#include <deque>
#include <functional>
#include <limits>
#include <math.h>
#include <memory>
#include <mutex>
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
struct float2 { float x, y; };
struct uint2 { unsigned x, y; };
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline float2 make_float2(float a, float b) { return {a, b}; }
inline uint2 make_uint2(unsigned a, unsigned b) { return {a, b}; }

constexpr unsigned kEmulatedLaneWords = 10;  // the registers a lane gives a warp-wide instruction

// A named barrier (bar.sync / bar.arrive id, count): the arrivals of its
// current instance, its instances so far, and the instance each thread last
// arrived at.
struct EmulatedNamedBarrier {
  std::mutex mutex;
  std::condition_variable done;
  int count = 0, arrived = 0;
  long long instance = 0;
  std::vector<long long> last;  // by thread, -1 before its first arrival
};

struct EmulatedBlock {
  std::barrier<>* barrier;
  std::vector<float> smem;  // dynamic shared memory
  std::vector<std::uint32_t> lanes;  // kEmulatedLaneWords a thread
  std::vector<unsigned long long> warp_calls;  // the warp-wide calls each thread has made
  std::shared_ptr<std::deque<std::barrier<>>> warp_barriers;  // one of 32 threads a warp
  std::shared_ptr<std::deque<EmulatedNamedBarrier>> named;  // ids 0 .. 15
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
enum cudaFuncAttribute {
  cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
  cudaFuncAttributeNonPortableClusterSizeAllowed = 10
};
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
          auto warps = std::make_shared<std::deque<std::barrier<>>>();
          for (unsigned w = 0; w < (threads + 31) / 32; ++w) warps->emplace_back(32);
          auto named = std::make_shared<std::deque<EmulatedNamedBarrier>>(16);
          for (auto& b : *named) b.last.assign(threads, -1);
          blocks.push_back({&barriers.back(),
                            std::vector<float>(smem / sizeof(float), std::numeric_limits<float>::quiet_NaN()),
                            std::vector<std::uint32_t>(threads * kEmulatedLaneWords),
                            std::vector<unsigned long long>(threads), warps, named});
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

// The first half of a warp-wide instruction: this thread's registers are in
// its lanes slot; after the warp's barrier every lane may read every slot of
// its warp. Asserts that every lane of the warp is at the same warp-wide
// call: a lane that skipped one would have met the barrier at another call.
inline std::uint32_t* emulated_warp_gather() {
  EmulatedBlock& block = *current_block;
  const unsigned t = threadIdx.x, warp = t / 32;
  const unsigned long long call = ++block.warp_calls[t];
  (*block.warp_barriers)[warp].arrive_and_wait();
  for (unsigned u = 32 * warp; u < 32 * warp + 32; ++u)
    assert(block.warp_calls[u] == call && "a warp-wide instruction not reached by every lane of the warp");
  return block.lanes.data() + warp * 32 * kEmulatedLaneWords;  // lane 0 of this thread's warp
}

// The second half: every lane of the warp has read what it needs.
inline void emulated_warp_release() { (*current_block->warp_barriers)[threadIdx.x / 32].arrive_and_wait(); }

// bar.sync (wait) or bar.arrive (no wait) on named barrier id with count
// threads: the instance completes when count threads have arrived. Asserts a
// count that is a multiple of 32 within the block, one count an instance,
// and that no thread arrives twice at one instance (an arrival the card would
// count into the wrong instance).
inline void emulated_named_barrier(int id, int count, bool wait) {
  assert(id > 0 && id < 16 && count > 0 && count % 32 == 0 && (unsigned)count <= blockDim.x);
  EmulatedNamedBarrier& b = (*current_block->named)[id];
  std::unique_lock<std::mutex> lock(b.mutex);
  assert((b.arrived == 0 || b.count == count) && "one thread count an instance of a named barrier");
  assert(b.last[threadIdx.x] != b.instance && "a thread arrived twice at one instance of a named barrier");
  b.count = count;
  b.last[threadIdx.x] = b.instance;
  const long long instance = b.instance;
  if (++b.arrived == count) {
    b.arrived = 0;
    ++b.instance;
    b.done.notify_all();
    return;
  }
  if (wait) b.done.wait(lock, [&] { return b.instance != instance; });
}

inline std::uint32_t* emulated_lane_slot() { return current_block->lanes.data() + threadIdx.x * kEmulatedLaneWords; }

inline float __shfl_xor_sync(unsigned mask, float v, int lane_mask, int width = 32) {
  assert(mask == 0xffffffffu && width == 32);
  std::memcpy(emulated_lane_slot(), &v, 4);
  const std::uint32_t* warp = emulated_warp_gather();
  float out;
  std::memcpy(&out, warp + ((threadIdx.x % 32) ^ (unsigned)lane_mask) * kEmulatedLaneWords, 4);
  emulated_warp_release();
  return out;
}

// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 with c as both C and D:
// A (16 x 16) and B (16 x 8) put together from the 32 lanes' fragments by the
// PTX layout (sampled_dense_mma.cuh), each product exact, this lane's four
// outputs summed over k in order in f32.
inline float emulated_bf16(std::uint32_t word, int high) {
  const std::uint32_t bits = (high ? word >> 16 : word & 0xFFFFu) << 16;
  float f;
  std::memcpy(&f, &bits, 4);
  return f;
}

inline void emulated_mma_m16n8k16_bf16(float (&c)[4], const std::uint32_t (&a)[4], const std::uint32_t (&b)[2]) {
  std::uint32_t* mine = emulated_lane_slot();
  for (int r = 0; r < 4; ++r) mine[r] = a[r];
  for (int r = 0; r < 2; ++r) mine[4 + r] = b[r];
  const std::uint32_t* warp = emulated_warp_gather();
  auto A = [&](int row, int k) {  // a[0]: (gq, k < 8), a[1]: (gq + 8, k < 8), a[2]: (gq, k >= 8), a[3]: (gq + 8, k >= 8)
    const int lane = 4 * (row % 8) + (k % 8) / 2, reg = (row >= 8) + 2 * (k >= 8);
    return emulated_bf16(warp[lane * kEmulatedLaneWords + reg], k % 2);
  };
  auto B = [&](int k, int col) {  // b[0]: k < 8, b[1]: k >= 8, at lane 4 col + (k % 8) / 2
    const int lane = 4 * col + (k % 8) / 2;
    return emulated_bf16(warp[lane * kEmulatedLaneWords + 4 + (k >= 8)], k % 2);
  };
  const int gq = (threadIdx.x % 32) / 4, tq = threadIdx.x % 4;
  float d[4];
  for (int e = 0; e < 4; ++e) {
    const int row = gq + 8 * (e / 2), col = 2 * tq + e % 2;
    float sum = c[e];
    for (int k = 0; k < 16; ++k) sum += A(row, k) * B(k, col);
    d[e] = sum;
  }
  emulated_warp_release();
  for (int e = 0; e < 4; ++e) c[e] = d[e];
}

// ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16: lane 8j + r gives the
// address of row r of matrix j (8 bf16, 16-byte aligned); lane 4 gq + tq
// receives in r[j] the elements (row 2tq, column gq) and (row 2tq + 1, column
// gq) of matrix j, the first in the low half (PTX ISA, "Warp-level matrix
// load instruction: ldmatrix").
inline void emulated_ldmatrix_x4_trans(std::uint32_t (&r)[4], const std::uint16_t* row) {
  assert(reinterpret_cast<std::uintptr_t>(row) % 16 == 0 && "ldmatrix rows are 16-byte aligned");
  static_assert(sizeof row <= 2 * sizeof(std::uint32_t));
  std::memcpy(emulated_lane_slot(), &row, sizeof row);
  const std::uint32_t* warp = emulated_warp_gather();
  auto row_of = [&](int lane) {
    const std::uint16_t* p;
    std::memcpy(&p, warp + lane * kEmulatedLaneWords, sizeof p);
    return p;
  };
  const int gq = (threadIdx.x % 32) / 4, tq = threadIdx.x % 4;
  std::uint32_t out[4];
  for (int j = 0; j < 4; ++j)
    out[j] = row_of(8 * j + 2 * tq)[gq] | static_cast<std::uint32_t>(row_of(8 * j + 2 * tq + 1)[gq]) << 16;
  emulated_warp_release();
  for (int j = 0; j < 4; ++j) r[j] = out[j];
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
