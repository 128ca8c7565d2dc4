// The paper's batched CL+WLQ query scan, one output plane per launch
// (table row B4).
//
// Replaces: src/repro/kernels/rmq_scan/kernel.py, rmq_query_pallas.
//
// Bound: device-memory bytes, as rmq_fused.cu: the level-0 partial chunks
// of each query, read from scattered places; the upper levels stay in L2.
//
// Design: the same walk (rmq_walk.cuh).  As in the TPU kernel the level
// geometry, offsets included, is fixed at launch (kernel parameters).  A
// value launch tracks no positions and writes the value plane; an index
// launch tracks positions and writes the position plane only.
#include "rmq_walk.cuh"

namespace rmq {

template <typename T, bool TRACK>
__global__ void __launch_bounds__(kQueryThreads)
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
  const T* top_v;
  const int32_t* top_p;
  stage_top<T, TRACK>(g, offs, base, upper, upper_pos, smem, top_v, top_p);
  answer_batch<T, TRACK>(g, offs, base, upper, upper_pos, top_v, top_p, ls,
                         rs, m, TRACK ? nullptr : static_cast<T*>(out),
                         TRACK ? static_cast<int32_t*>(out) : nullptr);
}

template <typename T>
cudaError_t launch_scan_query(int track, const WalkGeo& g, const void* base,
                              const void* upper, const void* upper_pos,
                              const void* ls, const void* rs, long long m,
                              void* out, cudaStream_t stream) {
  const size_t smem = stage_bytes<T>(g, track);
  auto kernel = track ? rmq_scan_kernel<T, true> : rmq_scan_kernel<T, false>;
  unsigned grid = 0;
  cudaError_t err = query_grid(kernel, smem, m, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kQueryThreads, smem, stream>>>(
      g, static_cast<const T*>(base), static_cast<const T*>(upper),
      static_cast<const int32_t*>(upper_pos),
      static_cast<const int32_t*>(ls), static_cast<const int32_t*>(rs), m,
      out);
  return cudaGetLastError();
}

}  // namespace rmq

// dtype: 0 float32, 1 float64.  offsets / padded_lens: host arrays of
// levels - 1 entries.  track: write positions (int32) to `out`, else
// values.
extern "C" int rmq_scan_query(int dtype, int track, int capacity, int c,
                              int levels, const int* offsets,
                              const int* padded_lens, int stage_top,
                              const void* base, const void* upper,
                              const void* upper_pos, const void* ls,
                              const void* rs, long long m, void* out,
                              void* stream) {
  if (m <= 0) return 0;
  if (levels < 1 || levels > rmq::kMaxLevels)
    return static_cast<int>(cudaErrorInvalidValue);
  const rmq::WalkGeo g = rmq::make_walk_geo(capacity, c, levels, offsets,
                                            padded_lens, stage_top);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return rmq::launch_scan_query<float>(track, g, base, upper, upper_pos, ls,
                                         rs, m, out, s);
  if (dtype == 1)
    return rmq::launch_scan_query<double>(track, g, base, upper, upper_pos,
                                          ls, rs, m, out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
