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
//  * blocks stream level 0 a tile at a time.  A tile is `tile1` level-1
//    entries, a multiple of c: its chunks are reduced into level 1 and
//    kept in shared memory, from which the block also reduces the tile's
//    tile1/c level-2 entries.  So levels 1 and 2 both come out of the
//    streaming phase;
//  * the last block to finish (a __threadfence then an atomicAdd on a
//    zeroed counter that the wrapper allocates) folds levels >= 3, which
//    are at most 1/c^2 of the input, reading through L2.
// The build is one launch at every depth.  Where the tile does not fit in
// shared memory (very large c) level 2 joins the serial fold instead.
//
// At the run layout of build_hopper.cuh (c = 128 float32, c = 64 float64,
// an aligned base) a persistent grid of blocks walks the tiles, each warp
// taking runs of eight chunks with every load of a run issued before its
// first reduce.  The tile is double-buffered in shared memory, and a warp
// issues its first run of the next tile before the tile's one barrier and
// the tile's level-2 reduce, so the barrier leaves loads in flight.  The
// fold walks runs too, with L2-only vector loads.  Every other layout keeps
// one block a tile with the part-by-part reduce of rmq_common.cuh.  Both
// follow its tie rule: the bits of the chunk's leftmost minimal entry,
// value-only or not.
//
// Rows (build_many): the grid's y dimension is a row of a (rows, capacity)
// batch, each row its own build.  A block moves its planes and its `done`
// counter to its row's (the row strides are arguments), so each row's last
// block folds that row; the persistent grid splits the resident blocks
// among the rows.  The batch is its own instance of each kernel (ROWS), so
// a single build runs the single-build code, its pointers in the
// parameter bank, and the batch's float32 run kernel trades a block an SM
// for the registers its row pointers take.
#include "build_hopper.cuh"

namespace rmq {

constexpr int kMaxLevels = 64;

struct FusedGeo {
  int64_t capacity;
  int32_t c;
  int32_t levels;
  int32_t tile1;      // level-1 entries per tile (a multiple of c)
  int32_t stream_l2;  // 1: level 2 comes out of the streaming phase
  int64_t base_stride;   // entries between two rows of base
  int64_t upper_stride;  // entries between two rows of upper / upper_pos
  int64_t level_lens[kMaxLevels];
  int64_t offsets[kMaxLevels];  // level k (k >= 1) at offsets[k-1]
};

// Levels >= fold_from, by the last block to finish: the last-block-done
// handoff publishes every block's writes, then one block folds.
template <typename T, bool TRACK, bool RUNS>
__device__ __forceinline__ void fold_levels(const FusedGeo& g, T* upper,
                                            int32_t* upper_pos,
                                            unsigned int* done,
                                            int fold_from) {
  if (g.levels <= fold_from) return;
  __shared__ bool is_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const int nw = blockDim.x / kWarp;
  for (int k = fold_from; k < g.levels; ++k) {
    // Level k-1's padded extent is exactly level_lens[k] * c entries.
    const CoherentSrc<T> src{upper + g.offsets[k - 2],
                             TRACK ? upper_pos + g.offsets[k - 2] : nullptr,
                             g.level_lens[k] * g.c};
    T* out_v = upper + g.offsets[k - 1];
    int32_t* out_p = TRACK ? upper_pos + g.offsets[k - 1] : nullptr;
    if constexpr (RUNS) {
      hopper::reduce_level_runs<T, TRACK>(
          src, hopper::L2Load<T, hopper::run_width<T>()>{}, out_v, out_p,
          g.level_lens[k], warp, nw, lane);
    } else {
      reduce_level_warps<T, TRACK>(src, g.c, out_v, out_p, g.level_lens[k],
                                   warp, nw, lane);
    }
    __syncthreads();
  }
}

// Global run r of level 0 (chunks [r * kRun, (r + 1) * kRun)): unmasked
// while it holds whole chunks only.
template <typename T, int V>
__device__ __forceinline__ void load_level0_run(
    hopper::Vec<T, V> (&x)[hopper::kRun], const T* base, int64_t capacity,
    int64_t whole_runs, int64_t r, int lane,
    const hopper::StreamLoad<T, V>& ld) {
  if (r < whole_runs) {
    hopper::load_run<T, V, false>(x, base, r * hopper::kRun, capacity, lane,
                                  ld);
  } else {
    hopper::load_run<T, V, true>(x, base, r * hopper::kRun, capacity, lane,
                                 ld);
  }
}

// A tile's level-2 entries from its level-1 copy in shared memory.
template <typename T, bool TRACK>
__device__ __forceinline__ void tile_level2(const T* tv, const int32_t* tp,
                                            int64_t tile, int out2,
                                            const FusedGeo& g, T* upper,
                                            int32_t* upper_pos, int warp,
                                            int nw, int lane) {
  constexpr int V = hopper::run_width<T>();
  constexpr int c = kWarp * V;
  for (int k = warp; k < out2; k += nw) {
    const hopper::Vec<T, V> y =
        *reinterpret_cast<const hopper::Vec<T, V>*>(tv + k * c + lane * V);
    T val;
    uint32_t w;
    hopper::pick_chunk<T, V>(y, lane, val, w);
    const int64_t o = tile * out2 + k;
    if (lane == 0 && o < g.level_lens[2]) {
      upper[g.offsets[1] + o] = val;
      if (TRACK) upper_pos[g.offsets[1] + o] = tp[k * c + w];
    }
  }
}

// Blocks an SM of the run kernel: the single build's budget; a batch's
// row pointers live in registers (a single build reads them from the
// parameter bank), so its float32 instances take the float64 budget.
template <typename T, bool ROWS>
__host__ __device__ constexpr int fused_min_blocks() {
  return ROWS ? 3 : hopper::build_min_blocks<T>();
}

template <typename T, bool TRACK, bool ROWS>
__global__ void __launch_bounds__(hopper::kBuildThreads,
                                  fused_min_blocks<T, ROWS>())
    fused_runs_kernel(const T* __restrict__ base, FusedGeo g, T* upper,
                      int32_t* upper_pos, unsigned int* done) {
  using hopper::kRun;
  if constexpr (ROWS) {
    // This block's row: its planes and its fold counter.
    const int64_t row = blockIdx.y;
    base += row * g.base_stride;
    upper += row * g.upper_stride;
    if (TRACK) upper_pos += row * g.upper_stride;
    done += row;
  }
  constexpr int V = hopper::run_width<T>();
  constexpr int c = kWarp * V;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile1 = g.tile1;
  // Two tile buffers: values, then positions.
  T* tile_v = reinterpret_cast<T*>(smem);
  int32_t* tile_p = reinterpret_cast<int32_t*>(tile_v + 2 * tile1);
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const int nw = blockDim.x / kWarp;
  const int64_t len1 = g.level_lens[1];
  const int64_t whole = g.capacity / c < len1 ? g.capacity / c : len1;
  const int64_t whole_runs = whole / kRun;
  T* l1v = upper + g.offsets[0];
  int32_t* l1p = TRACK ? upper_pos + g.offsets[0] : nullptr;
  const int runs = tile1 / kRun;  // runs a tile (at least nw)
  const int out2 = tile1 / c;     // level-2 entries a tile
  const int64_t ntiles = (len1 + tile1 - 1) / tile1;
  const hopper::StreamLoad<T, V> ld{hopper::evict_first_policy()};
  hopper::Vec<T, V> x[kRun];

  int64_t tile = blockIdx.x;
  int run = warp;
  int parity = 0;
  if (tile < ntiles)
    load_level0_run(x, base, g.capacity, whole_runs, tile * runs + run,
                    lane, ld);
  while (tile < ntiles) {
    T v;
    uint32_t w;
    hopper::pick_run<T, V>(x, lane, v, w);
    if (lane < kRun) {
      const int64_t chunk = (tile * runs + run) * kRun + lane;
      const bool live = chunk < len1;
      const int32_t pos = live ? static_cast<int32_t>(chunk * c + w) : kPadPos;
      if (live) {
        l1v[chunk] = v;
        if (TRACK) l1p[chunk] = pos;
      }
      if (g.stream_l2) {
        const int local = parity * tile1 + run * kRun + lane;
        tile_v[local] = live ? v : pos_inf<T>();
        if (TRACK) tile_p[local] = pos;
      }
    }
    run += nw;
    if (run < runs) {
      load_level0_run(x, base, g.capacity, whole_runs, tile * runs + run,
                      lane, ld);
      continue;
    }
    // This warp's share of the tile is done: its first run of the next
    // tile goes out before the tile barrier and the level-2 reduce.
    const int64_t next = tile + gridDim.x;
    if (next < ntiles)
      load_level0_run(x, base, g.capacity, whole_runs, next * runs + warp,
                      lane, ld);
    if (g.stream_l2) {
      __syncthreads();
      tile_level2<T, TRACK>(tile_v + parity * tile1, tile_p + parity * tile1,
                            tile, out2, g, upper, upper_pos, warp, nw, lane);
    }
    tile = next;
    run = warp;
    parity ^= 1;
  }
  fold_levels<T, TRACK, true>(g, upper, upper_pos, done,
                              g.stream_l2 ? 3 : 2);
}

template <typename T, bool TRACK, bool ROWS>
__global__ void __launch_bounds__(256)
    fused_parts_kernel(const T* __restrict__ base, FusedGeo g, T* upper,
                       int32_t* upper_pos, unsigned int* done) {
  if constexpr (ROWS) {
    // This block's row: its planes and its fold counter.
    const int64_t row = blockIdx.y;
    base += row * g.base_stride;
    upper += row * g.upper_stride;
    if (TRACK) upper_pos += row * g.upper_stride;
    done += row;
  }
  extern __shared__ __align__(16) unsigned char smem[];
  T* tile_v = reinterpret_cast<T*>(smem);
  int32_t* tile_p = reinterpret_cast<int32_t*>(
      smem + static_cast<size_t>(g.tile1) * sizeof(T));
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
      int64_t at;
      reduce_chunk_group<T>(level0, first + grp * cpw, c, lane, v, at);
      const int local = grp * cpw + lane / lanes;
      if ((lane & (lanes - 1)) == 0) {
        // Chunks wholly past `capacity` give (+inf, PAD_POS).
        const int32_t p = winner_pos(level0, at);
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
      const CarriedSrc<T> tile_src{tile_v, tile_p, g.tile1};
      const int out2 = g.tile1 / c;
      const int64_t first2 = tile * out2;
      for (int grp = warp; grp * cpw < out2; grp += nw) {
        T v;
        int64_t at;
        reduce_chunk_group<T>(tile_src, grp * cpw, c, lane, v, at);
        const int local = grp * cpw + lane / lanes;
        if ((lane & (lanes - 1)) == 0 && local < out2 &&
            first2 + local < g.level_lens[2]) {
          upper[g.offsets[1] + first2 + local] = v;
          if (TRACK)
            upper_pos[g.offsets[1] + first2 + local] = winner_pos(tile_src,
                                                                  at);
        }
      }
      __syncthreads();  // the tile buffer is reused by the next tile
    }
  }
  fold_levels<T, TRACK, false>(g, upper, upper_pos, done,
                               g.stream_l2 ? 3 : 2);
}

template <typename T, bool TRACK, bool RUNS, bool ROWS>
cudaError_t run_fused(const T* base, const FusedGeo& g, int rows, T* upper,
                      int32_t* upper_pos, unsigned int* done,
                      cudaStream_t stream) {
  const size_t tile_bytes =
      g.stream_l2 ? static_cast<size_t>(g.tile1) * (sizeof(T) + (TRACK ? 4 : 0))
                  : 0;
  const size_t smem = RUNS ? 2 * tile_bytes : tile_bytes;
  void (*kernel)(const T*, FusedGeo, T*, int32_t*, unsigned int*) =
      fused_parts_kernel<T, TRACK, ROWS>;
  if constexpr (RUNS) kernel = fused_runs_kernel<T, TRACK, ROWS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long ntiles = (g.level_lens[1] + g.tile1 - 1) / g.tile1;
  unsigned grid = 0;
  if (RUNS) {
    // Persistent: as many blocks as fit on the card, shared among the
    // rows (at least one a row), each walking its row's tiles.
    unsigned resident = 0;
    err = resident_grid(kernel, hopper::kBuildThreads, smem, INT64_MAX,
                        &resident);
    if (err != cudaSuccess) return err;
    const long long share = resident / rows > 0 ? resident / rows : 1;
    grid = static_cast<unsigned>(ntiles < share ? ntiles : share);
  } else {
    // One block per tile: blocks that finish make room for new ones, whose
    // loads hide the tile barriers of the others.
    const long long max_grid = 0x7fffffffLL;
    grid = static_cast<unsigned>(ntiles < max_grid ? ntiles : max_grid);
  }
  const dim3 blocks(grid, static_cast<unsigned>(rows));
  kernel<<<blocks, hopper::kBuildThreads, smem, stream>>>(base, g, upper,
                                                          upper_pos, done);
  return cudaGetLastError();
}

template <typename T, bool ROWS>
cudaError_t launch_runs(int track, bool runs, const T* b, const FusedGeo& g,
                        int rows, T* u, int32_t* up, unsigned int* d,
                        cudaStream_t stream) {
  if (runs)
    return track ? run_fused<T, true, true, ROWS>(b, g, rows, u, up, d, stream)
                 : run_fused<T, false, true, ROWS>(b, g, rows, u, up, d,
                                                   stream);
  return track ? run_fused<T, true, false, ROWS>(b, g, rows, u, up, d, stream)
               : run_fused<T, false, false, ROWS>(b, g, rows, u, up, d,
                                                  stream);
}

template <typename T>
cudaError_t launch_fused_build(int track, const void* base,
                               const FusedGeo& g, int rows, void* upper,
                               void* upper_pos, void* done,
                               cudaStream_t stream) {
  const T* b = static_cast<const T*>(base);
  T* u = static_cast<T*>(upper);
  int32_t* up = static_cast<int32_t*>(upper_pos);
  unsigned int* d = static_cast<unsigned int*>(done);
  // Every row's planes must start as aligned as row 0's.
  constexpr int V = hopper::run_width<T>();
  const bool runs =
      hopper::run_layout<T>(g.c, g.capacity, base) &&
      reinterpret_cast<uintptr_t>(upper) % 16 == 0 &&
      (rows == 1 || (g.base_stride % V == 0 && g.upper_stride % V == 0)) &&
      g.tile1 % (hopper::kRun * (hopper::kBuildThreads / kWarp)) == 0;
  if (rows > 1) return launch_runs<T, true>(track, runs, b, g, rows, u, up,
                                            d, stream);
  return launch_runs<T, false>(track, runs, b, g, rows, u, up, d, stream);
}

}  // namespace rmq

// dtype: 0 float32, 1 float64.  level_lens has `levels` entries, offsets
// `levels - 1`; `done` is `rows` zeroed 32-bit words on the device.  Row r
// reads base + r * base_stride and writes upper (upper_pos) + r *
// upper_stride.
extern "C" int rmq_fused_build(int dtype, int track, const void* base,
                               long long capacity, int c, int levels,
                               const long long* level_lens,
                               const long long* offsets, int tile1,
                               int stream_l2, void* upper, void* upper_pos,
                               void* done, int rows, long long base_stride,
                               long long upper_stride, void* stream) {
  if (levels < 2 || levels > rmq::kMaxLevels || rows < 1 || rows > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  rmq::FusedGeo g{};
  g.capacity = capacity;
  g.c = c;
  g.levels = levels;
  g.tile1 = tile1;
  g.stream_l2 = stream_l2 && levels >= 3;
  g.base_stride = base_stride;
  g.upper_stride = upper_stride;
  for (int k = 0; k < levels; ++k) g.level_lens[k] = level_lens[k];
  for (int k = 0; k + 1 < levels; ++k) g.offsets[k] = offsets[k];
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return rmq::launch_fused_build<float>(track, base, g, rows, upper,
                                          upper_pos, done, s);
  if (dtype == 1)
    return rmq::launch_fused_build<double>(track, base, g, rows, upper,
                                           upper_pos, done, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
