// The query walk shared by rmq_fused.cu (B2), rmq_scan.cu (B4), rmq_short.cu
// (B5, a level-0-only walk) and rmq_bulk.cu (B7, from level 1 up): the
// paper's coalesced loading (CL) and warp-local queuing (WLQ), §4.2-§4.3.
//
// One warp answers one query at a time.  A warp loads the bounds of 32
// queries once, one per lane, and hands them round with __shfl_sync
// (WLQ); lane j keeps the answer of the warp's j-th query, so the answers
// leave in one coalesced store.  Per query, with r exclusive:
//  * below the top, each level contributes the left and the right partial
//    chunk, [l, min(ceil(l/c)*c, r)) and [max(floor(r/c)*c, l), r): the
//    unmasked part of the reference's two anchored c-wide windows
//    (rmq_scan/kernel.py), and nothing else, so a short span costs one
//    sweep of its own length.  The warp reads both as one lane-strided
//    sweep, so every load instruction reads neighbouring entries (CL).
//    Both parts lie inside the level, so the reference's anchor clamps
//    never come into play;
//  * the ascend is l' = ceil(l/c), r' = floor(r/c); a used-up range stays
//    empty, so the warp leaves the walk there (the paper's early exit);
//  * the top (at most c*t entries) is scanned over [l, r) only, from
//    shared memory where the block staged it (paper §5.8 keeps the upper
//    levels in cache; the middle levels are read through L2).
// A single-level plan is all top: level 0 itself, positions = indices.
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

// Points top_v / top_p at the top level: the block's shared-memory copy
// when g.stage_top, else device memory.  top_p is null where positions are
// the indices (single-level plans) or not tracked.
template <typename T, bool TRACK>
__device__ __forceinline__ void stage_top(const WalkGeo& g,
                                          const int32_t* offs, const T* base,
                                          const T* upper,
                                          const int32_t* upper_pos,
                                          unsigned char* smem, const T*& top_v,
                                          const int32_t*& top_p) {
  const bool single = g.levels == 1;
  const T* src_v = single ? base : upper + offs[g.levels - 2];
  const int32_t* src_p =
      (TRACK && !single) ? upper_pos + offs[g.levels - 2] : nullptr;
  if (!g.stage_top) {
    top_v = src_v;
    top_p = src_p;
    return;
  }
  T* sv = reinterpret_cast<T*>(smem);
  int32_t* sp = reinterpret_cast<int32_t*>(
      smem + static_cast<size_t>(g.top_len) * sizeof(T));
  for (int i = threadIdx.x; i < g.top_len; i += blockDim.x) {
    sv[i] = src_v[i];
    if (src_p != nullptr) sp[i] = src_p[i];
  }
  __syncthreads();
  top_v = sv;
  top_p = src_p != nullptr ? sp : nullptr;
}

__device__ __forceinline__ int32_t ceil_shift(int32_t x, int s) {
  return (x >> s) + ((x & ((1 << s) - 1)) != 0);
}

// The walk from level k0 up, by the whole warp: the range [lo, hi) at level
// k0 (r exclusive), merged into (v, p), then the top, then the warp
// reduction.  Every lane returns the answer in (v, p).
template <typename T, bool TRACK>
__device__ __forceinline__ void walk_levels(const WalkGeo& g,
                                            const int32_t* offs,
                                            const T* base, const T* upper,
                                            const int32_t* upper_pos,
                                            const T* top_v,
                                            const int32_t* top_p, int k0,
                                            int32_t lo, int32_t hi, int lane,
                                            T& v, int32_t& p) {
  const int s = g.log2c;
  for (int k = k0; k + 1 < g.levels; ++k) {
    if (lo >= hi) break;  // warp-uniform: the range is used up
    const T* lv = k == 0 ? base : upper + offs[k - 1];
    const int32_t* lp = (TRACK && k > 0) ? upper_pos + offs[k - 1] : nullptr;
    // Left part [lo, a_hi); right part [b_lo, hi), empty when the span
    // sits inside one chunk (the left part then covers it).
    const int32_t next_l = ceil_shift(lo, s) << s;
    const int32_t prev_r = (hi >> s) << s;
    const int32_t a_hi = next_l < hi ? next_l : hi;
    const int32_t b_lo = prev_r > a_hi ? prev_r : a_hi;
    const int32_t len_a = a_hi - lo;
    const int32_t total = len_a + (hi - b_lo);
    for (int32_t e = lane; e < total; e += kWarp) {
      const int32_t i = e < len_a ? lo + e : b_lo + (e - len_a);
      const T x = lv[i];
      if (TRACK) {
        merge(v, p, x, lp != nullptr ? lp[i] : i);
      } else {
        take_min(v, x);
      }
    }
    lo = ceil_shift(lo, s);
    hi = hi >> s;
  }

  const int32_t end = hi < g.top_len ? hi : g.top_len;
  for (int32_t i = lo + lane; i < end; i += kWarp) {
    const T x = top_v[i];
    if (TRACK) {
      merge(v, p, x, top_p != nullptr ? top_p[i] : i);
    } else {
      take_min(v, x);
    }
  }
  group_reduce<T, TRACK>(v, p, kWarp);
}

// The level-0 bounds of an inclusive query: [lo, hi) clipped to the level.
__device__ __forceinline__ void level0_range(const WalkGeo& g, int32_t l,
                                             int32_t r, int32_t& lo,
                                             int32_t& hi) {
  lo = l > 0 ? l : 0;
  const int64_t r_ex = static_cast<int64_t>(r) + 1;
  hi = static_cast<int32_t>(r_ex < g.capacity ? r_ex : g.capacity);
}

// The walk of one inclusive query (l, r), by the whole warp.  Every lane
// returns the answer.  Bounds outside [0, capacity) give an unspecified
// answer but every read stays inside the hierarchy.
template <typename T, bool TRACK>
__device__ __forceinline__ void walk_query(const WalkGeo& g,
                                           const int32_t* offs, const T* base,
                                           const T* upper,
                                           const int32_t* upper_pos,
                                           const T* top_v,
                                           const int32_t* top_p, int32_t l,
                                           int32_t r, int lane, T& out_v,
                                           int32_t& out_p) {
  T v = pos_inf<T>();
  int32_t p = kPadPos;
  int32_t lo, hi;
  level0_range(g, l, r, lo, hi);
  walk_levels<T, TRACK>(g, offs, base, upper, upper_pos, top_v, top_p, 0, lo,
                        hi, lane, v, p);
  out_v = v;
  out_p = p;
}

// The WLQ batch loop: warps stride over tiles of 32 queries.  Writes the
// value plane where out_v is not null and the position plane where out_p
// is not null.
template <typename T, bool TRACK>
__device__ __forceinline__ void answer_batch(const WalkGeo& g,
                                             const int32_t* offs,
                                             const T* base, const T* upper,
                                             const int32_t* upper_pos,
                                             const T* top_v,
                                             const int32_t* top_p,
                                             const int32_t* ls,
                                             const int32_t* rs, int64_t m,
                                             T* out_v, int32_t* out_p) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / kWarp;
  const int64_t nwarps = static_cast<int64_t>(gridDim.x) * blockDim.x / kWarp;
  const int64_t tiles = (m + kWarp - 1) / kWarp;
  for (int64_t tile = warp; tile < tiles; tile += nwarps) {
    const int64_t q = tile * kWarp + lane;
    int32_t my_l = 0, my_r = -1;
    if (q < m) {
      my_l = ls[q];
      my_r = rs[q];
    }
    const int64_t left = m - tile * kWarp;
    const int count = left < kWarp ? static_cast<int>(left) : kWarp;
    T res_v = pos_inf<T>();
    int32_t res_p = kPadPos;
    for (int j = 0; j < count; ++j) {
      const int32_t l = __shfl_sync(kFullMask, my_l, j);
      const int32_t r = __shfl_sync(kFullMask, my_r, j);
      T v;
      int32_t p;
      walk_query<T, TRACK>(g, offs, base, upper, upper_pos, top_v, top_p, l,
                           r, lane, v, p);
      if (lane == j) {
        res_v = v;
        res_p = p;
      }
    }
    if (q < m) {
      if (out_v != nullptr) out_v[q] = res_v;
      if (TRACK && out_p != nullptr) out_p[q] = res_p;
    }
  }
}

// Grid of a query launch: as many blocks as fit on the card at once
// (each stages the top once), fewer for a small batch.  Sets the
// shared-memory ceiling first: above 48 KB a launch is refused otherwise.
template <typename K>
cudaError_t query_grid(K kernel, size_t smem, int64_t m, unsigned* grid) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kQueryThreads, smem);
  if (err != cudaSuccess) return err;
  const int64_t warps_per_block = kQueryThreads / kWarp;
  const int64_t tiles = (m + kWarp - 1) / kWarp;
  const int64_t want = (tiles + warps_per_block - 1) / warps_per_block;
  const int64_t resident =
      static_cast<int64_t>(sm_count()) * (per_sm > 0 ? per_sm : 1);
  *grid = static_cast<unsigned>(want < resident ? want : resident);
  return cudaSuccess;
}

// Shared memory of a top stage (0 when the top is read in place).
template <typename T>
size_t stage_bytes(const WalkGeo& g, bool track) {
  if (!g.stage_top) return 0;
  const bool pos = track && g.levels > 1;
  return static_cast<size_t>(g.top_len) * (sizeof(T) + (pos ? 4 : 0));
}

inline WalkGeo make_walk_geo(int capacity, int c, int levels,
                             const int* offsets, const int* padded_lens,
                             int stage_top) {
  WalkGeo g{};
  g.capacity = capacity;
  g.log2c = 0;
  while ((1 << g.log2c) < c) ++g.log2c;
  g.levels = levels;
  for (int k = 0; offsets != nullptr && k + 1 < levels; ++k)
    g.offsets[k] = offsets[k];
  g.top_len = levels == 1 ? capacity : padded_lens[levels - 2];
  g.stage_top = stage_top;
  return g;
}

}  // namespace rmq
