// Stand-in for <cooperative_groups.h>: the grid barrier, and a thread block
// cluster's barrier, ranks and shared memory (map_shared_rank gives the
// address of the same offset in another block's shared memory).
#pragma once
#include "cuda_runtime.h"
namespace cooperative_groups {
struct grid_group {
    void sync() { tctx.grid_bar->arrive_and_wait(); }
};
inline grid_group this_grid() { return {}; }
struct cluster_group {
    void sync() { tctx.cluster_bar->arrive_and_wait(); }
    unsigned block_rank() const { return (unsigned)tctx.crank; }
    unsigned num_blocks() const { return (unsigned)tctx.csize; }
    template <class T>
    T* map_shared_rank(T* p, unsigned rank) const {
        const char* base = reinterpret_cast<const char*>(tctx.smem);
        char* to = reinterpret_cast<char*>(tctx.cluster_smem[rank]);
        return reinterpret_cast<T*>(to + (reinterpret_cast<const char*>(p) - base));
    }
};
inline cluster_group this_cluster() { return {}; }
}  // namespace cooperative_groups
