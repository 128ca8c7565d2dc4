// A whole mixed value+index query batch in ONE launch (table row B2).
//
// Replaces: src/repro/kernels/rmq_fused/kernel.py, rmq_fused_pallas.
//
// Bound: device-memory bytes.  Each query needs its level-0 partial chunks
// (at most two c-entry windows: 1 KB at c=128 in float32), read from
// scattered places; the upper levels are about 1/c of the input and stay
// in L2.  The comparisons are far below the card's operation rate.
//
// Design: the walk of rmq_walk.cuh (one warp per query, WLQ bounds, CL
// windows, early exit, the top staged per block).  As in the TPU kernel,
// the level offsets arrive as a table on the device (there: scalar
// prefetch), which every block copies into shared memory, while the level
// sizes are fixed by the plan.  With track the one launch emits both the
// value plane and the leftmost-position plane.  Degenerate plans (one
// level, capacity < c) run here too: their top is level 0.  The grid is
// persistent: as many blocks as fit, so the top is staged once per block
// and not once per 256 queries.
#include "rmq_walk.cuh"

namespace rmq {

template <typename T, bool TRACK>
__global__ void __launch_bounds__(kQueryThreads)
    rmq_fused_kernel(WalkGeo g, const int32_t* __restrict__ offsets_table,
                     const T* __restrict__ base, const T* __restrict__ upper,
                     const int32_t* __restrict__ upper_pos,
                     const int32_t* __restrict__ ls,
                     const int32_t* __restrict__ rs, int64_t m, T* out_v,
                     int32_t* out_p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int32_t offs[kMaxLevels];
  if (threadIdx.x + 1 < static_cast<unsigned>(g.levels))
    offs[threadIdx.x] = offsets_table[threadIdx.x];
  __syncthreads();
  const T* top_v;
  const int32_t* top_p;
  stage_top<T, TRACK>(g, offs, base, upper, upper_pos, smem, top_v, top_p);
  answer_batch<T, TRACK>(g, offs, base, upper, upper_pos, top_v, top_p, ls,
                         rs, m, out_v, out_p);
}

template <typename T>
cudaError_t launch_fused_query(int track, const WalkGeo& g,
                               const void* offsets_table, const void* base,
                               const void* upper, const void* upper_pos,
                               const void* ls, const void* rs, long long m,
                               void* out_v, void* out_p,
                               cudaStream_t stream) {
  const size_t smem = stage_bytes<T>(g, track);
  auto kernel = track ? rmq_fused_kernel<T, true> : rmq_fused_kernel<T, false>;
  unsigned grid = 0;
  cudaError_t err = query_grid(kernel, smem, m, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kQueryThreads, smem, stream>>>(
      g, static_cast<const int32_t*>(offsets_table),
      static_cast<const T*>(base), static_cast<const T*>(upper),
      static_cast<const int32_t*>(upper_pos),
      static_cast<const int32_t*>(ls), static_cast<const int32_t*>(rs), m,
      static_cast<T*>(out_v), static_cast<int32_t*>(out_p));
  return cudaGetLastError();
}

}  // namespace rmq

// dtype: 0 float32, 1 float64.  padded_lens (host, levels - 1 entries);
// offsets_table (device int32, levels - 1 entries).  out_p may be null
// unless track.
extern "C" int rmq_fused_query(int dtype, int track, int capacity, int c,
                               int levels, const int* padded_lens,
                               int stage_top, const void* offsets_table,
                               const void* base, const void* upper,
                               const void* upper_pos, const void* ls,
                               const void* rs, long long m, void* out_v,
                               void* out_p, void* stream) {
  if (m <= 0) return 0;
  if (levels < 1 || levels > rmq::kMaxLevels)
    return static_cast<int>(cudaErrorInvalidValue);
  const rmq::WalkGeo g = rmq::make_walk_geo(capacity, c, levels, nullptr,
                                            padded_lens, stage_top);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return rmq::launch_fused_query<float>(track, g, offsets_table, base,
                                          upper, upper_pos, ls, rs, m, out_v,
                                          out_p, s);
  if (dtype == 1)
    return rmq::launch_fused_query<double>(track, g, offsets_table, base,
                                           upper, upper_pos, ls, rs, m,
                                           out_v, out_p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
