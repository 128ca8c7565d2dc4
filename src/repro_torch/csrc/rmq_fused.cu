// A whole mixed value+index query batch in ONE launch (table row B2).
//
// Replaces: src/repro/kernels/rmq_fused/kernel.py, rmq_fused_pallas.
//
// Bound: device-memory bytes.  Each query needs its level-0 partial chunks
// (at most two c-entry windows: 1 KB at c=128 in float32), read from
// scattered places; the upper levels are about 1/c of the input and stay
// in L2.  The comparisons are far below the card's operation rate.
//
// Design: the Hopper walk of rmq_walk_hopper.cuh (one warp per query, WLQ
// bounds, 16-byte vectors (8 bytes of four bf16), the loads of a query's levels
// below the top issued before any merge, level 0 streamed and the upper value
// planes kept in L2, one position gather per query).  As in the TPU kernel, the
// level offsets arrive as a table on the device (there: scalar prefetch), which
// every block copies into shared memory, while the level sizes are fixed by the
// plan.  With track the one launch emits both the value and the
// leftmost-position plane.  Degenerate plans (one level, capacity < c) run here
// too: their top is level 0.  The grid is persistent: as many blocks as fit, so
// the top's values are staged once per block and not once per 256 queries.
#include "rmq_walk_hopper.cuh"

namespace rmq {

template <typename T, bool TRACK, int V, bool FAST>
__global__ void __launch_bounds__(kQueryThreads, hopper::kQueryMinBlocks)
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
  hopper::Walk<T, V> w;
  const uint32_t smem_s =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  hopper::init_walk(w, g, offs, base, upper, upper_pos,
                    hopper::stage_values<T>(g, offs, base, upper, smem),
                    smem_s);
  hopper::answer_batch<T, TRACK, V, FAST>(w, ls, rs, m, out_v, out_p);
}

template <typename T, bool TRACK>
struct FusedLaunch {
  WalkGeo g;
  const int32_t* offsets_table;
  const T* base;
  const T* upper;
  const int32_t* upper_pos;
  const int32_t* ls;
  const int32_t* rs;
  long long m;
  T* out_v;
  int32_t* out_p;
  cudaStream_t stream;

  template <int V, bool FAST>
  cudaError_t run() const {
    note_instance(2 * V + (FAST ? 1 : 0));
    const size_t smem = hopper::stage_value_bytes<T>(g);
    auto kernel = rmq_fused_kernel<T, TRACK, V, FAST>;
    unsigned grid = 0;
    cudaError_t err = query_grid(kernel, smem, m, &grid);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kQueryThreads, smem, stream>>>(
        g, offsets_table, base, upper, upper_pos, ls, rs, m, out_v, out_p);
    return cudaGetLastError();
  }
};

template <typename T>
cudaError_t launch_fused_query(int track, WalkGeo g,
                               const void* offsets_table, const void* base,
                               const void* upper, const void* upper_pos,
                               const void* ls, const void* rs, long long m,
                               void* out_v, void* out_p,
                               cudaStream_t stream) {
  const auto* tab = static_cast<const int32_t*>(offsets_table);
  const auto* b = static_cast<const T*>(base);
  const auto* u = static_cast<const T*>(upper);
  const auto* up = static_cast<const int32_t*>(upper_pos);
  const auto* l = static_cast<const int32_t*>(ls);
  const auto* r = static_cast<const int32_t*>(rs);
  auto* ov = static_cast<T*>(out_v);
  auto* op = static_cast<int32_t*>(out_p);
  g.stage_top = hopper::stage_fits<T>(g);
  if (track)
    return hopper::dispatch_width<T>(
        g, base, upper,
        FusedLaunch<T, true>{g, tab, b, u, up, l, r, m, ov, op, stream});
  return hopper::dispatch_width<T>(
      g, base, upper,
      FusedLaunch<T, false>{g, tab, b, u, up, l, r, m, ov, op, stream});
}

}  // namespace rmq

// dtype: 0 float32, 1 float64, 2 bfloat16.  padded_lens (host, levels - 1
// entries); offsets_table (device int32, levels - 1 entries).  out_p may be
// null unless track.  Each block copies the top's values into shared memory
// where they fit (hopper::kStageLimit).
extern "C" int rmq_fused_query(int dtype, int track, int capacity, int c,
                               int levels, const int* padded_lens,
                               const void* offsets_table,
                               const void* base, const void* upper,
                               const void* upper_pos, const void* ls,
                               const void* rs, long long m, void* out_v,
                               void* out_p, void* stream) {
  if (m <= 0) return 0;
  if (levels < 1 || levels > rmq::kMaxLevels)
    return static_cast<int>(cudaErrorInvalidValue);
  const rmq::WalkGeo g = rmq::make_walk_geo(capacity, c, levels, nullptr,
                                            padded_lens);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return rmq::launch_fused_query<float>(track, g, offsets_table, base,
                                          upper, upper_pos, ls, rs, m, out_v,
                                          out_p, s);
  if (dtype == 1)
    return rmq::launch_fused_query<double>(track, g, offsets_table, base,
                                           upper, upper_pos, ls, rs, m,
                                           out_v, out_p, s);
  if (dtype == 2)
    return rmq::launch_fused_query<rmq::bf16>(track, g, offsets_table, base,
                                              upper, upper_pos, ls, rs, m,
                                              out_v, out_p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
