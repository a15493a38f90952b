// Stand-in for <cooperative_groups.h>: the grid barrier only.
#pragma once
#include "cuda_runtime.h"
namespace cooperative_groups {
struct grid_group {
    void sync() { tctx.grid_bar->arrive_and_wait(); }
};
inline grid_group this_grid() { return {}; }
}  // namespace cooperative_groups
