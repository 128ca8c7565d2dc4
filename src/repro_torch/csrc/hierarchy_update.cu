// Re-reduce a scattered set of touched chunks of one level, in place in the
// upper buffer (table row B6).
//
// Replaces: src/repro/kernels/hierarchy_update/kernel.py, update_level,
// update_level_with_positions and update_level0_with_positions (the
// scalar-prefetch Pallas re-reduction, one chunk per grid step).
//
// Bound: device-memory bytes.  Each touched chunk reads its c source entries
// (values, plus positions above level 1) once and writes one summary; the
// chunks lie at scattered places, so every chunk costs whole 32-byte
// sectors.  A comparison per entry is far below the card's operation rate.
//
// Design: one warp re-reduces one touched chunk (c/32 entries per lane,
// lane-strided so each load instruction reads neighbouring entries), by the
// tie rule of rmq_common.cuh: the bits of the chunk's leftmost minimal
// entry, value-only or not, and one gather of its carried position.  For
// c < 32 one warp holds 32/c chunks side by side, as hierarchy_build.cu
// does.  The chunk ids come deduped (the wrapper sorts them with
// torch.unique), so every output slot has one writer.  Level-1 repairs
// synthesize positions from the index; entries at or past the source length
// read as (+inf, PAD_POS).  Results go straight to out_v[id] / out_p[id],
// where the wrapper points out_v at the level's slot of `upper`
// (plan.offsets[level-1]).
#include "rmq_common.cuh"

namespace rmq {

template <typename T, bool TRACK, typename Src>
__global__ void __launch_bounds__(256)
    update_level_kernel(Src src, const int32_t* __restrict__ ids,
                        int64_t num_ids, int c, T* out_v, int32_t* out_p) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / kWarp;
  const int64_t nwarps = static_cast<int64_t>(gridDim.x) * blockDim.x / kWarp;
  const int lanes = chunk_lanes(c);
  const int cpw = chunks_per_warp(c);
  const int per_lane = c / lanes;
  const int64_t groups = (num_ids + cpw - 1) / cpw;
  for (int64_t g = warp; g < groups; g += nwarps) {
    const int64_t slot = g * cpw + lane / lanes;
    const bool live = slot < num_ids;
    const int64_t id = live ? ids[slot] : 0;
    const int gl = lane & (lanes - 1);
    const int64_t chunk0 = id * c;
    T v = pos_inf<T>();
    uint32_t idx = gl;
    if (live) {
#pragma unroll 4
      for (int j = 0; j < per_lane; ++j) {
        const int e = gl + j * lanes;
        if (chunk0 + e < src.len) lane_take(v, idx, src.val(chunk0 + e), e);
      }
    }
    const uint32_t w = pick_index(v, idx, lanes);
    v = __shfl_sync(kFullMask, v, static_cast<int>(w) & (lanes - 1), lanes);
    if (live && gl == 0) {
      out_v[id] = v;
      if (TRACK) out_p[id] = winner_pos(src, chunk0 + w);
    }
  }
}

template <typename T>
cudaError_t launch_update_level(int track, const void* src_v,
                                const void* src_p, long long src_len, int c,
                                const void* ids, long long num_ids,
                                void* out_v, void* out_p,
                                cudaStream_t stream) {
  constexpr int kThreads = 256;
  const long long cpw = c < kWarp ? kWarp / c : 1;
  const long long warps = (num_ids + cpw - 1) / cpw;
  const long long want = (warps * kWarp + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sm_count()) * 32;
  const unsigned grid = static_cast<unsigned>(want < cap ? want : cap);
  const T* sv = static_cast<const T*>(src_v);
  const int32_t* sp = static_cast<const int32_t*>(src_p);
  const int32_t* id = static_cast<const int32_t*>(ids);
  T* ov = static_cast<T*>(out_v);
  int32_t* op = static_cast<int32_t*>(out_p);
  if (!track) {
    update_level_kernel<T, false, IndexedSrc<T>>
        <<<grid, kThreads, 0, stream>>>(IndexedSrc<T>{sv, src_len}, id,
                                         num_ids, c, ov, op);
  } else if (sp == nullptr) {
    update_level_kernel<T, true, IndexedSrc<T>>
        <<<grid, kThreads, 0, stream>>>(IndexedSrc<T>{sv, src_len}, id,
                                         num_ids, c, ov, op);
  } else {
    update_level_kernel<T, true, CarriedSrc<T>>
        <<<grid, kThreads, 0, stream>>>(CarriedSrc<T>{sv, sp, src_len},
                                         id, num_ids, c, ov, op);
  }
  return cudaGetLastError();
}

}  // namespace rmq

// dtype: 0 float32, 1 float64.  src_p == nullptr with track: the source is
// level 0 and positions are the indices.  ids: device int32, deduped.
// out_v / out_p: the level's slot of upper / upper_pos, indexed by chunk id.
extern "C" int rmq_update_level(int dtype, int track, const void* src_v,
                                const void* src_p, long long src_len, int c,
                                const void* ids, long long num_ids,
                                void* out_v, void* out_p, void* stream) {
  if (num_ids <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return rmq::launch_update_level<float>(track, src_v, src_p, src_len, c,
                                           ids, num_ids, out_v, out_p, s);
  if (dtype == 1)
    return rmq::launch_update_level<double>(track, src_v, src_p, src_len, c,
                                            ids, num_ids, out_v, out_p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
