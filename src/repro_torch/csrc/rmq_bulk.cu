// The bulk query pass: one launch a bucket of an endpoint-sorted batch
// (table row B7).
//
// Replaces: src/repro/kernels/rmq_bulk/kernel.py, rmq_bulk_pallas (the
// fused query kernel whose level-0 DMA is skipped while the window anchor
// stays the same).
//
// Bound: device-memory bytes.  On a batch sorted by (chunk(l), chunk(r))
// the level-0 reads are the distinct boundary chunks the batch touches, not
// two per query; the bounds and answers add 12 (f32) or 16 (f64) bytes a
// query; the upper levels stay in L2.
//
// Design: the Hopper walk of rmq_walk_hopper.cuh, as rmq_fused.cu (B2)
// runs it, with three differences.  Each warp answers a contiguous run of
// the batch's 32-query tiles (B2 strides them over the grid), so a sorted
// run of spans that share a boundary chunk stays on one warp and one SM;
// level 0 is read through L1 (B2 streams it past), so those spans find the
// chunk's sectors there (where the TPU kernel keeps the window in VMEM and
// skips the DMA, the L1 keeps the sectors, with no copy and no barrier);
// and at the one-chunk-a-warp layout (c = 32 V) a warp walks two spans at
// once, 16 lanes each, so the per-span bounds arithmetic and the WLQ
// rounds are shared and a reduction takes 4 steps instead of 5.  The
// answers are B2's bit for bit: the same segments and tie rule on the
// same hierarchy, so the same leftmost entry and its own bits.  The grid
// is persistent, so the top's values are staged once per block.
//
// Registers (-Xptxas -v, sm_90a, cap 80 for 3 blocks an SM): the 16-lane
// instances 78 (float32) and 76 (float64), the part-by-part ones 45-55;
// no spills, no stack.  Eight lanes a span (four spans a warp) ran faster
// but spilled at the cap (PERF.md §6).
#include "rmq_walk_hopper.cuh"

namespace rmq {

// Lanes a span at the one-chunk-a-warp layout (c = 32 V): two spans a warp.
constexpr int kBulkLanes = 16;

template <typename T, bool TRACK, int V, bool FAST, int G>
__global__ void __launch_bounds__(kQueryThreads, hopper::kQueryMinBlocks)
    rmq_bulk_kernel(WalkGeo g, const int32_t* __restrict__ offsets_table,
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
  hopper::Walk<T, V, true> w;
  const uint32_t smem_s =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  hopper::init_walk(w, g, offs, base, upper, upper_pos,
                    hopper::stage_values<T>(g, offs, base, upper, smem),
                    smem_s);
  hopper::answer_batch<T, TRACK, V, FAST, G, true>(w, ls, rs, m, out_v,
                                                   out_p, true);
}

template <typename T, bool TRACK>
struct BulkLaunch {
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
    auto kernel =
        rmq_bulk_kernel<T, TRACK, V, FAST, FAST ? kBulkLanes : kWarp>;
    unsigned grid = 0;
    cudaError_t err = query_grid(kernel, smem, m, &grid);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kQueryThreads, smem, stream>>>(
        g, offsets_table, base, upper, upper_pos, ls, rs, m, out_v, out_p);
    return cudaGetLastError();
  }
};

template <typename T>
cudaError_t launch_bulk_query(int track, WalkGeo g,
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
        BulkLaunch<T, true>{g, tab, b, u, up, l, r, m, ov, op, stream});
  return hopper::dispatch_width<T>(
      g, base, upper,
      BulkLaunch<T, false>{g, tab, b, u, up, l, r, m, ov, op, stream});
}

}  // namespace rmq

// dtype: 0 float32, 1 float64, 2 bfloat16.  padded_lens (host, levels - 1
// entries); offsets_table (device int32, levels - 1 entries).  out_p may be
// null unless track.  Each block copies the top's values into shared memory
// where they fit (hopper::kStageLimit).
extern "C" int rmq_bulk_query(int dtype, int track, int capacity, int c,
                              int levels, const int* padded_lens,
                              const void* offsets_table, const void* base,
                              const void* upper, const void* upper_pos,
                              const void* ls, const void* rs, long long m,
                              void* out_v, void* out_p, void* stream) {
  if (m <= 0) return 0;
  if (levels < 1 || levels > rmq::kMaxLevels)
    return static_cast<int>(cudaErrorInvalidValue);
  const rmq::WalkGeo g = rmq::make_walk_geo(capacity, c, levels, nullptr,
                                            padded_lens);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return rmq::launch_bulk_query<float>(track, g, offsets_table, base,
                                         upper, upper_pos, ls, rs, m, out_v,
                                         out_p, s);
  if (dtype == 1)
    return rmq::launch_bulk_query<double>(track, g, offsets_table, base,
                                          upper, upper_pos, ls, rs, m,
                                          out_v, out_p, s);
  if (dtype == 2)
    return rmq::launch_bulk_query<rmq::bf16>(track, g, offsets_table, base,
                                             upper, upper_pos, ls, rs, m,
                                             out_v, out_p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
