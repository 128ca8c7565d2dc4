// The Hopper chunk-reduce core of the two builds: hierarchy_build.cu (B3,
// one level a launch) and hierarchy_fused.cu (B1, every level in one
// launch).
//
// Bound: device-memory bytes.  A build reads level 0 once and writes the
// upper levels once (about 1/(c-1) of level 0, as much again for
// positions); one comparison an entry is far below the card's operation
// rate.  So the core aims at bytes in flight: by Little's law about
// 3.35 TB/s x ~0.8 us, 20-25 KB on each SM at all times.
//
// The run layout: c = 32 V with V = run_width<T>() (16-byte vectors:
// c = 128 float32, c = 64 float64, the paper's default; 8-byte vectors of
// four bf16: c = 128 bfloat16), a source whose length is a whole number of
// vectors and whose values are aligned to the vector.
//  * Lane j of a warp holds vector j of a chunk, so one warp instruction
//    reads one whole chunk (512 bytes; 256 in bf16).
//  * A warp takes a contiguous run of run_len<T>() chunks (4 KB: eight
//    chunks, sixteen in bf16) and issues all of its loads before its first
//    reduce.  Level 0 streams past L1 with L2 evict_first.
//  * A persistent grid (the SMs times the blocks that fit on one) walks
//    the runs.  The inner loop has no bounds check and no per-entry 64-bit
//    index arithmetic; only a level's last run is masked.
//  * Each chunk is reduced by the tie rule of rmq_common.cuh: each lane's first
//    minimum among its V entries, the value minimum M by five shuffles, the
//    smallest index among the lanes holding M by one __reduce_min_sync, the
//    winner's own bits by one shuffle.  A bf16 entry is widened in registers
//    (rmq_common.cuh) and its winner narrowed back by its bits.  Lane r keeps
//    chunk r's answer, so a run's summaries (and positions) leave in one
//    coalesced store.  Level-0 positions are the index itself; above it they
//    take one gather of the carried position at the winning index.
// Every other layout takes the part-by-part reduce of rmq_common.cuh under
// the same tie rule, so the answer never depends on the path.
#pragma once

#include "hopper_ld.cuh"

namespace rmq {
namespace hopper {

constexpr int kBuildThreads = 256;
// Blocks an SM the run kernels are built for: float32 and bfloat16 a cap of
// 64 registers, so 32 warps an SM, each with up to 4 KB in flight; float64
// a cap of 80 (24 warps), since B1's float64 instances spill at 64.
template <typename T>
__host__ __device__ constexpr int build_min_blocks() {
  return sizeof(T) <= 4 ? 4 : 3;
}

// Chunks a warp's run: 4 KB of loads in flight (bf16 chunks are half as
// large, so its runs are twice as long).
template <typename T>
__host__ __device__ constexpr int run_len() {
  return sizeof(T) == 2 ? 16 : 8;
}

// Whether a level of length `len` at `src` takes the run layout.
template <typename T>
inline bool run_layout(int c, long long len, const void* src) {
  constexpr int V = run_width<T>();
  return c == kWarp * V && len % V == 0 &&
         reinterpret_cast<uintptr_t>(src) % (V * sizeof(T)) == 0;
}

// The loads of a run: chunks [first, first + R) of `src`, lane j's vector
// j of each.  MASKED (a level's last run): vectors at or past `len` read
// +inf.
template <typename T, int V, int R, bool MASKED, typename Load>
__device__ __forceinline__ void load_run(Vec<T, V> (&x)[R], const T* src,
                                         int64_t first, int64_t len,
                                         int lane, const Load& ld) {
  constexpr int c = kWarp * V;
  const T* p = src + first * c + lane * V;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (MASKED && (first + r) * c + lane * V >= len) {
      vfill_inf(x[r]);
    } else {
      ld(x[r], p + r * c);
    }
  }
}

// One chunk at the run layout (lane j holds entries [jV, jV + V)): every
// lane gets the winner's bits `val` (widened) and its index `w` in the
// chunk.
template <typename T, int V>
__device__ __forceinline__ void pick_chunk(const Vec<T, V>& x, int lane,
                                           cmp_t<T>& val, uint32_t& w) {
  cmp_t<T> v = vget(x, 0);
  uint32_t idx = lane * V;
#pragma unroll
  for (int e = 1; e < V; ++e) lane_take(v, idx, vget(x, e), lane * V + e);
  w = pick_index(v, idx, kWarp);
  val = __shfl_sync(kFullMask, v, static_cast<int>(w / V));
}

// A run's answers: lane r < R ends with chunk r's (val, w).
template <typename T, int V, int R>
__device__ __forceinline__ void pick_run(const Vec<T, V> (&x)[R], int lane,
                                         cmp_t<T>& my_v, uint32_t& my_w) {
  my_v = pos_inf<cmp_t<T>>();
  my_w = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    cmp_t<T> val;
    uint32_t w;
    pick_chunk<T, V>(x[r], lane, val, w);
    if (lane == r) {
      my_v = val;
      my_w = w;
    }
  }
}

// A run's store: lanes 0 .. R - 1 write chunks first + lane below
// out_len, the positions gathered from `src` (IndexedSrc: the index).
template <typename T, int V, int R, bool TRACK, typename Src>
__device__ __forceinline__ void store_run(const Src& src, T* out_v,
                                          int32_t* out_p, int64_t first,
                                          int64_t out_len, int lane,
                                          cmp_t<T> v, uint32_t w) {
  const int64_t chunk = first + lane;
  if (lane < R && chunk < out_len) {
    out_v[chunk] = narrow<T>(v);
    if (TRACK) out_p[chunk] = winner_pos(src, chunk * (kWarp * V) + w);
  }
}

// A whole level at the run layout, run-strided over the calling warps:
// `src` (len entries; its pos() gives positions) into out_len chunk
// minima.  Full runs first, unmasked; then the last run, masked.
template <typename T, bool TRACK, typename Src, typename Load>
__device__ __forceinline__ void reduce_level_runs(const Src& src,
                                                  const Load& ld, T* out_v,
                                                  int32_t* out_p,
                                                  int64_t out_len,
                                                  int64_t warp,
                                                  int64_t nwarps, int lane) {
  constexpr int V = run_width<T>();
  constexpr int R = run_len<T>();
  constexpr int c = kWarp * V;
  const int64_t whole = src.len / c < out_len ? src.len / c : out_len;
  const int64_t full = whole / R;
  Vec<T, V> x[R];
  cmp_t<T> v;
  uint32_t w;
  for (int64_t run = warp; run < full; run += nwarps) {
    load_run<T, V, R, false>(x, src.v, run * R, src.len, lane, ld);
    pick_run<T, V, R>(x, lane, v, w);
    store_run<T, V, R, TRACK>(src, out_v, out_p, run * R, out_len, lane, v,
                              w);
  }
  if (full * R < out_len && warp == full % nwarps) {
    load_run<T, V, R, true>(x, src.v, full * R, src.len, lane, ld);
    pick_run<T, V, R>(x, lane, v, w);
    store_run<T, V, R, TRACK>(src, out_v, out_p, full * R, out_len, lane, v,
                              w);
  }
}

// Streaming loads of level 0 (and of a level read once): past L1, L2
// evict_first.
template <typename T, int V>
struct StreamLoad {
  uint64_t pol;
  __device__ __forceinline__ void operator()(Vec<T, V>& x,
                                             const T* p) const {
    ld_stream<T, V>(x, p, pol);
  }
};

// Loads of levels that other blocks of the running launch wrote.
template <typename T, int V>
struct L2Load {
  __device__ __forceinline__ void operator()(Vec<T, V>& x,
                                             const T* p) const {
    ld_l2<T, V>(x, p);
  }
};

}  // namespace hopper
}  // namespace rmq
