// Short spans answered from level 0 alone (table row B5).
//
// Replaces: src/repro/kernels/rmq_short/kernel.py, rmq_short_pallas (the
// two-chunk level-0 scan the query engine routes its short spans to).
//
// Contract (the engine routes on it): every span satisfies
// r/c - l/c <= 1, so it lies inside the two aligned chunks from floor(l/c)*c
// and never needs the hierarchy.  Positions are the level-0 indices, so a
// value-only build answers RMQ_index too.
//
// Bound: device-memory bytes.  Each query reads the 32-byte sectors of
// [l, r] (at most 2c entries), plus its bounds and answer; the comparisons
// are far below the card's operation rate.
//
// Design: the WLQ batch loop of rmq_walk.cuh on a one-level geometry whose
// "top" is level 0 itself, read in place: a warp loads the bounds of 32
// queries once (one per lane, handed round with shuffles) and answers them
// one after another; each query is one lane-strided sweep of [l, r] only
// (coalesced loads) and a shuffle reduction on (value, position) pairs, so
// ties come out leftmost.  Reading only [l, r] needs neither the reference's
// anchor clamp to capacity - 2c nor its fallback for capacity < 2c.
#include "rmq_walk.cuh"

namespace rmq {

template <typename T, bool TRACK>
__global__ void __launch_bounds__(kQueryThreads)
    rmq_short_kernel(WalkGeo g, const T* __restrict__ base,
                     const int32_t* __restrict__ ls,
                     const int32_t* __restrict__ rs, int64_t m, T* out_v,
                     int32_t* out_p) {
  answer_batch<T, TRACK>(g, nullptr, base, nullptr, nullptr, base, nullptr,
                         ls, rs, m, out_v, out_p);
}

template <typename T>
cudaError_t launch_short_query(int track, const WalkGeo& g, const void* base,
                               const void* ls, const void* rs, long long m,
                               void* out_v, void* out_p,
                               cudaStream_t stream) {
  auto kernel = track ? rmq_short_kernel<T, true> : rmq_short_kernel<T, false>;
  unsigned grid = 0;
  cudaError_t err = query_grid(kernel, 0, m, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kQueryThreads, 0, stream>>>(
      g, static_cast<const T*>(base), static_cast<const int32_t*>(ls),
      static_cast<const int32_t*>(rs), m, static_cast<T*>(out_v),
      static_cast<int32_t*>(out_p));
  return cudaGetLastError();
}

}  // namespace rmq

// dtype: 0 float32, 1 float64.  base: level 0 at its stored length
// (capacity).  track: write leftmost positions to out_p (int32); out_v
// always gets the values.
extern "C" int rmq_short_query(int dtype, int track, int capacity, int c,
                               const void* base, const void* ls,
                               const void* rs, long long m, void* out_v,
                               void* out_p, void* stream) {
  if (m <= 0) return 0;
  const rmq::WalkGeo g =
      rmq::make_walk_geo(capacity, c, 1, nullptr, nullptr, 0);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return rmq::launch_short_query<float>(track, g, base, ls, rs, m, out_v,
                                          out_p, s);
  if (dtype == 1)
    return rmq::launch_short_query<double>(track, g, base, ls, rs, m, out_v,
                                           out_p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
