// The geometry the query kernels share: a plan's level layout as a launch
// sees it (WalkGeo) and the grid of a query launch.  The walk itself is
// rmq_walk_hopper.cuh, which every query kernel runs: rmq_fused.cu (B2),
// rmq_scan.cu (B4), rmq_short.cu (B5) and rmq_bulk.cu (B7).
#pragma once

#include "rmq_common.cuh"

namespace rmq {

constexpr int kMaxLevels = 32;
constexpr int kQueryThreads = 256;

struct WalkGeo {
  int32_t capacity;  // stored length of level 0
  int32_t log2c;     // c = 1 << log2c
  int32_t levels;
  int32_t top_len;    // stored length of the top level
  int32_t stage_top;  // 1: every block stages the top in shared memory
  int32_t offsets[kMaxLevels];  // level k (1 <= k < levels) at [k-1]
};

__device__ __forceinline__ int32_t ceil_shift(int32_t x, int s) {
  return (x >> s) + ((x & ((1 << s) - 1)) != 0);
}

// Grid of a query launch over m queries in 32-query tiles: as many blocks
// as fit on the card at once (each stages the top once), fewer for a small
// batch.  Sets the shared-memory ceiling first: above 48 KB a launch is
// refused otherwise.
template <typename K>
cudaError_t query_grid(K kernel, size_t smem, int64_t m, unsigned* grid) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int64_t warps_per_block = kQueryThreads / kWarp;
  const int64_t tiles = (m + kWarp - 1) / kWarp;
  return resident_grid(kernel, kQueryThreads, smem,
                       (tiles + warps_per_block - 1) / warps_per_block, grid);
}

// The stage_top field starts at 0: the launch decides it
// (hopper::stage_fits).
inline WalkGeo make_walk_geo(int capacity, int c, int levels,
                             const int* offsets, const int* padded_lens) {
  WalkGeo g{};
  g.capacity = capacity;
  g.log2c = 0;
  while ((1 << g.log2c) < c) ++g.log2c;
  g.levels = levels;
  for (int k = 0; offsets != nullptr && k + 1 < levels; ++k)
    g.offsets[k] = offsets[k];
  g.top_len = levels == 1 ? capacity : padded_lens[levels - 2];
  return g;
}

}  // namespace rmq
