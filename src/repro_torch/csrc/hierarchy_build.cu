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
// Design: the Hopper build core (build_hopper.cuh).  At the run layout
// (c = 128 float32 and bfloat16, c = 64 float64, aligned to the vector) a
// persistent grid walks runs of 4 KB (eight chunks, sixteen in bf16), one
// warp instruction a chunk, every load of a run issued before its first
// reduce.  Every other layout (sub-warp
// chunks, c = 32 float64, a misaligned or ragged source) takes the
// part-by-part reduce of rmq_common.cuh: one warp a chunk (c/32 entries a
// lane, lane-strided), or 32/c chunks a warp for c < 32, in a grid-stride
// loop.  Both follow the tie rule of rmq_common.cuh: the bits of the
// chunk's leftmost minimal entry, value-only or not.  Level-0 positions
// are the indices themselves, so the (capacity,) position array that the
// reference wrapper materializes is never built.
#include "build_hopper.cuh"

namespace rmq {

template <typename T, bool TRACK, typename Src>
__global__ void __launch_bounds__(hopper::kBuildThreads,
                                  hopper::build_min_blocks<T>())
    build_level_runs(Src src, T* out_v, int32_t* out_p, int64_t out_len) {
  constexpr int V = hopper::run_width<T>();
  const int lane = threadIdx.x & (kWarp - 1);
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / kWarp;
  const int64_t nwarps = static_cast<int64_t>(gridDim.x) * blockDim.x / kWarp;
  const hopper::StreamLoad<T, V> ld{hopper::evict_first_policy()};
  hopper::reduce_level_runs<T, TRACK>(src, ld, out_v, out_p, out_len, warp,
                                      nwarps, lane);
}

template <typename T, bool TRACK, typename Src>
__global__ void __launch_bounds__(256)
    build_level_parts(Src src, int c, T* out_v, int32_t* out_p,
                      int64_t out_len) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / kWarp;
  const int64_t nwarps = static_cast<int64_t>(gridDim.x) * blockDim.x / kWarp;
  reduce_level_warps<T, TRACK>(src, c, out_v, out_p, out_len, warp, nwarps,
                               lane);
}

template <typename T, bool TRACK, typename Src>
cudaError_t launch_level(const Src& src, int c, T* out_v, int32_t* out_p,
                         long long out_len, cudaStream_t stream) {
  if (hopper::run_layout<T>(c, src.len, src.v)) {
    note_instance(kRunsInstance);
    auto kernel = build_level_runs<T, TRACK, Src>;
    unsigned grid = 0;
    constexpr int R = hopper::run_len<T>();
    const long long runs = (out_len + R - 1) / R;
    const cudaError_t err = resident_grid(
        kernel, hopper::kBuildThreads, 0,
        (runs * kWarp + hopper::kBuildThreads - 1) / hopper::kBuildThreads,
        &grid);
    if (err != cudaSuccess) return err;
    kernel<<<grid, hopper::kBuildThreads, 0, stream>>>(src, out_v, out_p,
                                                       out_len);
    return cudaGetLastError();
  }
  note_instance(0);
  constexpr int kThreads = 256;
  const long long cpw = c < kWarp ? kWarp / c : 1;
  const long long warps = (out_len + cpw - 1) / cpw;
  const long long want = (warps * kWarp + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sm_count()) * 32;
  const unsigned grid = static_cast<unsigned>(want < cap ? want : cap);
  build_level_parts<T, TRACK, Src>
      <<<grid, kThreads, 0, stream>>>(src, c, out_v, out_p, out_len);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_build_level(int track, const void* src_v,
                               const void* src_p, long long src_len, int c,
                               void* out_v, void* out_p, long long out_len,
                               cudaStream_t stream) {
  const T* sv = static_cast<const T*>(src_v);
  const int32_t* sp = static_cast<const int32_t*>(src_p);
  T* ov = static_cast<T*>(out_v);
  int32_t* op = static_cast<int32_t*>(out_p);
  if (!track)
    return launch_level<T, false>(IndexedSrc<T>{sv, src_len}, c, ov, op,
                                  out_len, stream);
  if (sp == nullptr)
    return launch_level<T, true>(IndexedSrc<T>{sv, src_len}, c, ov, op,
                                 out_len, stream);
  return launch_level<T, true>(CarriedSrc<T>{sv, sp, src_len}, c, ov, op,
                               out_len, stream);
}

}  // namespace rmq

// dtype: 0 float32, 1 float64, 2 bfloat16.  src_p == nullptr with track:
// level 0.
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
  if (dtype == 2)
    return rmq::launch_build_level<rmq::bf16>(track, src_v, src_p, src_len,
                                              c, out_v, out_p, out_len, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
