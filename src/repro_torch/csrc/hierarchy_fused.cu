// The whole upper hierarchy in ONE launch (table row B1).
//
// Replaces: src/repro/kernels/hierarchy_fused/kernel.py, fused_build and
// fused_build_with_positions.
//
// Bound: device-memory bytes: level 0 is read once, the upper buffer
// (about 1/(c-1) of it, plus as much again for positions) written once.
//
// Design.  The TPU kernel leans on a sequential grid: it fills `upper` at
// step 0, streams level 0 through VMEM, and folds levels 2+ at the last
// step with `upper` resident all along.  Hopper blocks run in any order,
// so:
//  * the wrapper allocates `upper` / `upper_pos` already filled with
//    +inf / PAD_POS, which is every level's padding;
//  * blocks stream level 0, one tile each.  A tile is `tile1` level-1
//    entries, a multiple of c: warps reduce its level-0 chunks as
//    in hierarchy_build.cu, write level 1, and keep the tile in shared
//    memory, from which the block also reduces the tile's tile1/c level-2
//    entries.  So levels 1 and 2 both come out of the streaming phase;
//  * the last block to finish (a __threadfence then an atomicAdd on a
//    zeroed counter that the wrapper allocates) folds levels >= 3, which
//    are at most 1/c^2 of the input, reading through L2 (__ldcg).
// The build is one launch at every depth.  Where the tile does not fit in
// shared memory (very large c) level 2 joins the serial fold instead.
#include "rmq_common.cuh"

namespace rmq {

constexpr int kMaxLevels = 64;

struct FusedGeo {
  int64_t capacity;
  int32_t c;
  int32_t levels;
  int32_t tile1;      // level-1 entries per tile (a multiple of c)
  int32_t stream_l2;  // 1: level 2 comes out of the streaming phase
  int64_t level_lens[kMaxLevels];
  int64_t offsets[kMaxLevels];  // level k (k >= 1) at offsets[k-1]
};

// At most 40 registers a thread, so that 6 blocks fit on an SM: the
// position-tracking build needs the occupancy to keep loads in flight.
template <typename T, bool TRACK>
__global__ void __launch_bounds__(256, 6)
    fused_build_kernel(const T* __restrict__ base, FusedGeo g, T* upper,
                       int32_t* upper_pos, unsigned int* done) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* tile_v = reinterpret_cast<T*>(smem);
  int32_t* tile_p =
      reinterpret_cast<int32_t*>(smem + static_cast<size_t>(g.tile1) * sizeof(T));
  const int c = g.c;
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const int nw = blockDim.x / kWarp;
  const int cpw = chunks_per_warp(c);
  const int lanes = chunk_lanes(c);
  const int64_t len1 = g.level_lens[1];
  T* l1v = upper + g.offsets[0];
  int32_t* l1p = TRACK ? upper_pos + g.offsets[0] : nullptr;
  const IndexedSrc<T> level0{base, g.capacity};

  const int64_t ntiles = (len1 + g.tile1 - 1) / g.tile1;
  for (int64_t tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int64_t first = tile * g.tile1;
    for (int grp = warp; grp * cpw < g.tile1; grp += nw) {
      T v;
      int32_t p;
      reduce_chunk_group<T, TRACK>(level0, first + grp * cpw, c, lane, v, p);
      const int local = grp * cpw + lane / lanes;
      if ((lane & (lanes - 1)) == 0) {
        if (g.stream_l2) {
          tile_v[local] = v;
          if (TRACK) tile_p[local] = p;
        }
        if (first + local < len1) {
          l1v[first + local] = v;
          if (TRACK) l1p[first + local] = p;
        }
      }
    }
    if (g.stream_l2) {
      __syncthreads();
      // Entries of the tile past level 1's end came from chunks wholly
      // past `capacity`, so they already hold (+inf, PAD_POS).
      const CarriedSrc<T> tile_src{tile_v, tile_p, g.tile1};
      const int out2 = g.tile1 / c;
      const int64_t first2 = tile * out2;
      for (int grp = warp; grp * cpw < out2; grp += nw) {
        T v;
        int32_t p;
        reduce_chunk_group<T, TRACK>(tile_src, grp * cpw, c, lane, v, p);
        const int local = grp * cpw + lane / lanes;
        if ((lane & (lanes - 1)) == 0 && local < out2 &&
            first2 + local < g.level_lens[2]) {
          upper[g.offsets[1] + first2 + local] = v;
          if (TRACK) upper_pos[g.offsets[1] + first2 + local] = p;
        }
      }
      __syncthreads();  // the tile buffer is reused by the next tile
    }
  }

  const int fold_from = g.stream_l2 ? 3 : 2;
  if (g.levels <= fold_from) return;
  // Last-block-done handoff: publish this block's writes, then count it.
  __shared__ bool is_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  for (int k = fold_from; k < g.levels; ++k) {
    // Level k-1's padded extent is exactly level_lens[k] * c entries.
    const CoherentSrc<T> src{upper + g.offsets[k - 2],
                             TRACK ? upper_pos + g.offsets[k - 2] : nullptr,
                             g.level_lens[k] * c};
    reduce_level_warps<T, TRACK>(src, c, upper + g.offsets[k - 1],
                                 TRACK ? upper_pos + g.offsets[k - 1] : nullptr,
                                 g.level_lens[k], warp, nw, lane);
    __syncthreads();
  }
}

template <typename T>
cudaError_t launch_fused_build(int track, const void* base,
                               const FusedGeo& g, void* upper,
                               void* upper_pos, void* done,
                               cudaStream_t stream) {
  constexpr int kThreads = 256;
  const size_t smem =
      g.stream_l2 ? static_cast<size_t>(g.tile1) * (sizeof(T) + (track ? 4 : 0))
                  : 0;
  auto kernel = track ? fused_build_kernel<T, true> : fused_build_kernel<T, false>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  // One block per tile: blocks that finish make room for new ones, whose
  // loads hide the tile barriers of the others.
  const long long ntiles = (g.level_lens[1] + g.tile1 - 1) / g.tile1;
  const long long max_grid = 0x7fffffffLL;
  const unsigned grid = static_cast<unsigned>(ntiles < max_grid ? ntiles : max_grid);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(base), g, static_cast<T*>(upper),
      static_cast<int32_t*>(upper_pos), static_cast<unsigned int*>(done));
  return cudaGetLastError();
}

}  // namespace rmq

// dtype: 0 float32, 1 float64.  level_lens has `levels` entries, offsets
// `levels - 1`; `done` is one zeroed 32-bit word on the device.
extern "C" int rmq_fused_build(int dtype, int track, const void* base,
                               long long capacity, int c, int levels,
                               const long long* level_lens,
                               const long long* offsets, int tile1,
                               int stream_l2, void* upper, void* upper_pos,
                               void* done, void* stream) {
  if (levels < 2 || levels > rmq::kMaxLevels) return static_cast<int>(cudaErrorInvalidValue);
  rmq::FusedGeo g{};
  g.capacity = capacity;
  g.c = c;
  g.levels = levels;
  g.tile1 = tile1;
  g.stream_l2 = stream_l2 && levels >= 3;
  for (int k = 0; k < levels; ++k) g.level_lens[k] = level_lens[k];
  for (int k = 0; k + 1 < levels; ++k) g.offsets[k] = offsets[k];
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return rmq::launch_fused_build<float>(track, base, g, upper, upper_pos, done, s);
  if (dtype == 1)
    return rmq::launch_fused_build<double>(track, base, g, upper, upper_pos, done, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
