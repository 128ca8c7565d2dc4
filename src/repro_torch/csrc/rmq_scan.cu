// The paper's batched CL+WLQ query scan, one output plane per launch
// (table row B4).
//
// Replaces: src/repro/kernels/rmq_scan/kernel.py, rmq_query_pallas.
//
// Bound: device-memory bytes, as rmq_fused.cu: the level-0 partial chunks
// of each query, read from scattered places; the upper levels stay in L2.
//
// Design: the same Hopper walk as rmq_fused.cu (rmq_walk_hopper.cuh).  As
// in the TPU kernel the level geometry, offsets included, is fixed at
// launch (kernel parameters).  A value launch writes the value plane; an
// index launch writes the position plane only, and is the only one that
// gathers positions (one per query).
#include "rmq_walk_hopper.cuh"

namespace rmq {

template <typename T, bool TRACK, int V, bool FAST>
__global__ void __launch_bounds__(kQueryThreads, hopper::kQueryMinBlocks)
    rmq_scan_kernel(WalkGeo g, const T* __restrict__ base,
                    const T* __restrict__ upper,
                    const int32_t* __restrict__ upper_pos,
                    const int32_t* __restrict__ ls,
                    const int32_t* __restrict__ rs, int64_t m, void* out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int32_t offs[kMaxLevels];
  if (threadIdx.x + 1 < static_cast<unsigned>(g.levels))
    offs[threadIdx.x] = g.offsets[threadIdx.x];
  __syncthreads();
  hopper::Walk<T, V> w;
  const uint32_t smem_s =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  hopper::init_walk(w, g, offs, base, upper, upper_pos,
                    hopper::stage_values<T>(g, offs, base, upper, smem),
                    smem_s);
  hopper::answer_batch<T, TRACK, V, FAST>(
      w, ls, rs, m, TRACK ? nullptr : static_cast<T*>(out),
      TRACK ? static_cast<int32_t*>(out) : nullptr);
}

template <typename T, bool TRACK>
struct ScanLaunch {
  WalkGeo g;
  const T* base;
  const T* upper;
  const int32_t* upper_pos;
  const int32_t* ls;
  const int32_t* rs;
  long long m;
  void* out;
  cudaStream_t stream;

  template <int V, bool FAST>
  cudaError_t run() const {
    note_instance(2 * V + (FAST ? 1 : 0));
    const size_t smem = hopper::stage_value_bytes<T>(g);
    auto kernel = rmq_scan_kernel<T, TRACK, V, FAST>;
    unsigned grid = 0;
    cudaError_t err = query_grid(kernel, smem, m, &grid);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kQueryThreads, smem, stream>>>(g, base, upper, upper_pos,
                                                  ls, rs, m, out);
    return cudaGetLastError();
  }
};

template <typename T>
cudaError_t launch_scan_query(int track, WalkGeo g, const void* base,
                              const void* upper, const void* upper_pos,
                              const void* ls, const void* rs, long long m,
                              void* out, cudaStream_t stream) {
  const auto* b = static_cast<const T*>(base);
  const auto* u = static_cast<const T*>(upper);
  const auto* up = static_cast<const int32_t*>(upper_pos);
  const auto* l = static_cast<const int32_t*>(ls);
  const auto* r = static_cast<const int32_t*>(rs);
  g.stage_top = hopper::stage_fits<T>(g);
  if (track)
    return hopper::dispatch_width<T>(
        g, base, upper, ScanLaunch<T, true>{g, b, u, up, l, r, m, out, stream});
  return hopper::dispatch_width<T>(
      g, base, upper, ScanLaunch<T, false>{g, b, u, up, l, r, m, out, stream});
}

}  // namespace rmq

// dtype: 0 float32, 1 float64, 2 bfloat16.  offsets / padded_lens: host arrays
// of levels - 1 entries.  track: write positions (int32) to `out`, else values.
// Each block copies the top's values into shared memory where they fit
// (hopper::kStageLimit).
extern "C" int rmq_scan_query(int dtype, int track, int capacity, int c,
                              int levels, const int* offsets,
                              const int* padded_lens,
                              const void* base, const void* upper,
                              const void* upper_pos, const void* ls,
                              const void* rs, long long m, void* out,
                              void* stream) {
  if (m <= 0) return 0;
  if (levels < 1 || levels > rmq::kMaxLevels)
    return static_cast<int>(cudaErrorInvalidValue);
  const rmq::WalkGeo g = rmq::make_walk_geo(capacity, c, levels, offsets,
                                            padded_lens);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return rmq::launch_scan_query<float>(track, g, base, upper, upper_pos, ls,
                                         rs, m, out, s);
  if (dtype == 1)
    return rmq::launch_scan_query<double>(track, g, base, upper, upper_pos,
                                          ls, rs, m, out, s);
  if (dtype == 2)
    return rmq::launch_scan_query<rmq::bf16>(track, g, base, upper,
                                             upper_pos, ls, rs, m, out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
