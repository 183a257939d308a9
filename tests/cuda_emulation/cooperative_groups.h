// The thread-block-cluster part of cooperative_groups for the CPU stand-in of
// cuda_runtime.h: a cluster's blocks run at once there, so sync() is a
// barrier over all their threads and map_shared_rank() points into another
// block's dynamic shared memory at the same offset.
#pragma once
#include "cuda_runtime.h"

namespace cooperative_groups {

struct cluster_group {
  void sync() const { current_cluster->barrier->arrive_and_wait(); }
  unsigned block_rank() const { return blockIdx.z % num_blocks(); }
  unsigned num_blocks() const { return (unsigned)current_cluster->blocks->size(); }
  template <class T>
  T* map_shared_rank(T* addr, unsigned rank) const {
    const std::ptrdiff_t offset = reinterpret_cast<char*>(addr) - reinterpret_cast<char*>(current_block->smem.data());
    return reinterpret_cast<T*>(reinterpret_cast<char*>((*current_cluster->blocks)[rank].smem.data()) + offset);
  }
};

inline cluster_group this_cluster() { return {}; }

}  // namespace cooperative_groups
