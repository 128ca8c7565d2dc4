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
// Design: the Hopper walk of rmq_walk_hopper.cuh on a one-level geometry
// whose top is level 0 itself, read in place through L1 and never staged
// (a block would copy all of a small level 0 for a few spans): one warp a
// span, 32 spans a tile (WLQ bounds), 16-byte loads of only the sectors of
// [l, r], the minimum by vmin (NaN least) and the leftmost (vector, entry)
// by a key reduction, then the winning entry's own bits and its index.  So
// B5 returns the bits B2 / B4 / B7 return on the same span of a position
// build, zeros of either sign and NaNs included.  Reading only [l, r] needs neither the reference's anchor
// clamp to capacity - 2c nor its fallback for capacity < 2c.  The work a
// warp takes is sized by the batch (short_tile): the engine's buckets of
// at most 4096 spans would be 128 tiles of 32 (16 blocks of 8 warps, or 4
// with lane groups of 4 spans a warp), each answered one span after
// another; as one-span tiles they are 4096 warps, 3168 of them resident
// at once (132 SMs x 3 blocks of 8 warps), each waiting on memory once.
//
// Registers (-Xptxas -v, sm_90a): capped at 40 (kShortMinBlocks = 6
// blocks of 256 threads an SM); 39-40 by type and vector width, no
// spills, no stack.  Left to itself, the NaN rule's second walk took the
// kernel to 44-48 registers, five blocks an SM, and a call of 349526
// short spans (10923 tiles of 32) then needed three tiles from some warps
// where six blocks an SM need two.
#include "rmq_walk_hopper.cuh"

namespace rmq {

constexpr int kShortMinBlocks = 6;

template <typename T, int V>
__global__ void __launch_bounds__(kQueryThreads, kShortMinBlocks)
    rmq_short_kernel(WalkGeo g, const T* __restrict__ base,
                     const int32_t* __restrict__ ls,
                     const int32_t* __restrict__ rs, int64_t m, int tq,
                     T* out_v, int32_t* out_p) {
  hopper::Walk<T, V, true> w;
  hopper::init_walk<T, V, true>(w, g, nullptr, base, nullptr, nullptr, base,
                                0u);
  // Positions are indices (no gather), so one instance writes both planes
  // and a value launch passes out_p = null.
  hopper::answer_batch<T, true, V, false, kWarp, true>(w, ls, rs, m, out_v,
                                                       out_p, false, tq);
}

// Queries a tile: 32 while the batch gives every warp the card holds at
// once a tile, else halved until it does (down to one).  A warp answers
// its tile's queries one after another, each a load's round trip, so a
// small batch in 32-query tiles would leave most of the card idle and
// take 32 round trips; a bucket of 4096 spans runs as 4096 one-query
// tiles instead.
inline int short_tile(int64_t m) {
  const int64_t warps = static_cast<int64_t>(sm_count()) *
                        hopper::kQueryMinBlocks * (kQueryThreads / kWarp);
  int tq = kWarp;
  while (tq > 1 && (m + tq - 1) / tq < warps) tq >>= 1;
  return tq;
}

template <typename T>
struct ShortLaunch {
  WalkGeo g;
  const T* base;
  const int32_t* ls;
  const int32_t* rs;
  long long m;
  T* out_v;
  int32_t* out_p;
  cudaStream_t stream;

  // FAST is the one-chunk-a-warp layout of a multi-level walk: a
  // one-level walk has no chunk below the top.
  template <int V, bool FAST>
  cudaError_t run() const {
    note_instance(2 * V);  // a one-level walk: never the FAST walk
    auto kernel = rmq_short_kernel<T, V>;
    const int tq = short_tile(m);
    unsigned grid = 0;
    cudaError_t err =
        query_grid(kernel, 0, (m + tq - 1) / tq * kWarp, &grid);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kQueryThreads, 0, stream>>>(g, base, ls, rs, m, tq, out_v,
                                               out_p);
    return cudaGetLastError();
  }
};

}  // namespace rmq

// dtype: 0 float32, 1 float64, 2 bfloat16.  base: level 0 at its stored length
// (capacity).  track: write leftmost positions to out_p (int32); out_v always
// gets the values.
extern "C" int rmq_short_query(int dtype, int track, int capacity, int c,
                               const void* base, const void* ls,
                               const void* rs, long long m, void* out_v,
                               void* out_p, void* stream) {
  if (m <= 0) return 0;
  const rmq::WalkGeo g =
      rmq::make_walk_geo(capacity, c, 1, nullptr, nullptr);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* l = static_cast<const int32_t*>(ls);
  const auto* r = static_cast<const int32_t*>(rs);
  auto* op = track ? static_cast<int32_t*>(out_p) : nullptr;
  if (dtype == 0)
    return rmq::hopper::dispatch_width<float>(
        g, base, nullptr,
        rmq::ShortLaunch<float>{g, static_cast<const float*>(base), l, r, m,
                                static_cast<float*>(out_v), op, s});
  if (dtype == 1)
    return rmq::hopper::dispatch_width<double>(
        g, base, nullptr,
        rmq::ShortLaunch<double>{g, static_cast<const double*>(base), l, r,
                                 m, static_cast<double*>(out_v), op, s});
  if (dtype == 2)
    return rmq::hopper::dispatch_width<rmq::bf16>(
        g, base, nullptr,
        rmq::ShortLaunch<rmq::bf16>{g, static_cast<const rmq::bf16*>(base), l,
                                    r, m, static_cast<rmq::bf16*>(out_v), op,
                                    s});
  return static_cast<int>(cudaErrorInvalidValue);
}
