// One hierarchy level per launch: chunk minima, with carried leftmost
// positions (table row B3).
//
// Replaces: src/repro/kernels/hierarchy_build/kernel.py, build_level and
// build_level_with_positions (the per-level Pallas build).
//
// Bound: device-memory bytes.  A level reads its input once (level 0 is the
// whole array) and writes 1/c of it; a comparison per entry is far below
// the card's operation rate.
//
// Design (paper §4.1/§5.6): one warp reduces one chunk with warp shuffles
// (c/32 entries per lane, lane-strided so each load instruction of the warp
// reads 32 neighbouring entries); for c < 32 one warp reduces 32/c chunks
// at once.  A grid-stride loop runs over chunk groups.  Level-0 positions
// are the indices themselves, so the (capacity,) position array that the
// reference wrapper materializes is never built.
#include "rmq_common.cuh"

namespace rmq {

template <typename T, bool TRACK, bool CARRIED>
__global__ void __launch_bounds__(256)
    build_level_kernel(const T* src_v, const int32_t* src_p, int64_t src_len,
                       int c, T* out_v, int32_t* out_p, int64_t out_len) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / kWarp;
  const int64_t nwarps = static_cast<int64_t>(gridDim.x) * blockDim.x / kWarp;
  if (CARRIED) {
    reduce_level_warps<T, TRACK>(CarriedSrc<T>{src_v, src_p, src_len}, c,
                                 out_v, out_p, out_len, warp, nwarps, lane);
  } else {
    reduce_level_warps<T, TRACK>(IndexedSrc<T>{src_v, src_len}, c, out_v,
                                 out_p, out_len, warp, nwarps, lane);
  }
}

template <typename T>
cudaError_t launch_build_level(int track, const void* src_v,
                               const void* src_p, long long src_len, int c,
                               void* out_v, void* out_p, long long out_len,
                               cudaStream_t stream) {
  constexpr int kThreads = 256;
  const long long cpw = c < kWarp ? kWarp / c : 1;
  const long long warps = (out_len + cpw - 1) / cpw;
  const long long want = (warps * kWarp + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sm_count()) * 32;
  const unsigned grid = static_cast<unsigned>(want < cap ? want : cap);
  const T* sv = static_cast<const T*>(src_v);
  const int32_t* sp = static_cast<const int32_t*>(src_p);
  T* ov = static_cast<T*>(out_v);
  int32_t* op = static_cast<int32_t*>(out_p);
  if (!track) {
    build_level_kernel<T, false, false>
        <<<grid, kThreads, 0, stream>>>(sv, sp, src_len, c, ov, op, out_len);
  } else if (sp == nullptr) {
    build_level_kernel<T, true, false>
        <<<grid, kThreads, 0, stream>>>(sv, sp, src_len, c, ov, op, out_len);
  } else {
    build_level_kernel<T, true, true>
        <<<grid, kThreads, 0, stream>>>(sv, sp, src_len, c, ov, op, out_len);
  }
  return cudaGetLastError();
}

}  // namespace rmq

// dtype: 0 float32, 1 float64.  src_p == nullptr with track: level 0.
extern "C" int rmq_build_level(int dtype, int track, const void* src_v,
                               const void* src_p, long long src_len, int c,
                               void* out_v, void* out_p, long long out_len,
                               void* stream) {
  if (out_len <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return rmq::launch_build_level<float>(track, src_v, src_p, src_len, c,
                                          out_v, out_p, out_len, s);
  if (dtype == 1)
    return rmq::launch_build_level<double>(track, src_v, src_p, src_len, c,
                                           out_v, out_p, out_len, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
