// The bulk query pass: an endpoint-sorted batch with level-0 chunk reuse
// (table row B7).
//
// Replaces: src/repro/kernels/rmq_bulk/kernel.py, rmq_bulk_pallas (the fused
// query kernel whose level-0 DMA is skipped while the window anchor stays
// the same).
//
// Bound: device-memory bytes.  On a batch sorted by (chunk(l), chunk(r))
// the level-0 reads are the distinct boundary chunks the batch touches, not
// two per query; the bounds and answers add 12 (f32) or 16 (f64) bytes a
// query; the upper levels stay in L2.
//
// Design: each warp takes a contiguous run of the sorted batch (tiles of 32
// queries, bounds handed round with shuffles as in WLQ) and keeps two
// level-0 chunks in shared memory: the chunk of its current left partial
// part and that of its right partial part.  A chunk is loaded (c entries,
// coalesced) only when the query's chunk differs from the one held, so a
// run of queries that share a boundary chunk reads it once.  The partial
// parts are swept from those buffers; from level 1 up the walk is
// rmq_walk.cuh's walk_levels, the code rmq_fused.cu (B2) runs, so answers
// are bit-identical to it by construction.  A single-level plan has no
// chunk to reuse and walks level 0 as its top, as B2 does.
#include "rmq_walk.cuh"

namespace rmq {

// Copy chunk `chunk` of level 0 into buf (entries past capacity read +inf).
template <typename T>
__device__ __forceinline__ void load_chunk(const T* base, int32_t capacity,
                                           int c, int32_t chunk, T* buf,
                                           int lane) {
  __syncwarp();
  const int64_t first = static_cast<int64_t>(chunk) * c;
  for (int e = lane; e < c; e += kWarp) {
    const int64_t i = first + e;
    buf[e] = i < capacity ? base[i] : pos_inf<T>();
  }
  __syncwarp();
}

template <typename T, bool TRACK>
__global__ void __launch_bounds__(kQueryThreads)
    rmq_bulk_kernel(WalkGeo g, size_t buf_offset,
                    const int32_t* __restrict__ offsets_table,
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
  const T* top_v;
  const int32_t* top_p;
  stage_top<T, TRACK>(g, offs, base, upper, upper_pos, smem, top_v, top_p);

  const int s = g.log2c;
  const int c = 1 << s;
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp_in_block = threadIdx.x / kWarp;
  T* buf_l = reinterpret_cast<T*>(smem + buf_offset) +
             static_cast<size_t>(warp_in_block) * 2 * c;
  T* buf_r = buf_l + c;
  int32_t held_l = -1, held_r = -1;

  // A contiguous run of tiles per warp keeps sorted neighbours together.
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / kWarp;
  const int64_t nwarps = static_cast<int64_t>(gridDim.x) * blockDim.x / kWarp;
  const int64_t tiles = (m + kWarp - 1) / kWarp;
  const int64_t per_warp = (tiles + nwarps - 1) / nwarps;
  const int64_t t_begin = warp * per_warp;
  const int64_t t_end =
      t_begin + per_warp < tiles ? t_begin + per_warp : tiles;
  for (int64_t tile = t_begin; tile < t_end; ++tile) {
    const int64_t q = tile * kWarp + lane;
    int32_t my_l = 0, my_r = -1;
    if (q < m) {
      my_l = ls[q];
      my_r = rs[q];
    }
    const int64_t left = m - tile * kWarp;
    const int count = left < kWarp ? static_cast<int>(left) : kWarp;
    T res_v = pos_inf<T>();
    int32_t res_p = kPadPos;
    for (int j = 0; j < count; ++j) {
      const int32_t l = __shfl_sync(kFullMask, my_l, j);
      const int32_t r = __shfl_sync(kFullMask, my_r, j);
      T v = pos_inf<T>();
      int32_t p = kPadPos;
      int32_t lo, hi;
      level0_range(g, l, r, lo, hi);
      int k0 = 0;
      if (g.levels > 1) {
        k0 = 1;
        if (lo < hi) {
          // The walk's level-0 parts (rmq_walk.cuh), from the buffers.
          const int32_t next_l = ceil_shift(lo, s) << s;
          const int32_t prev_r = (hi >> s) << s;
          const int32_t a_hi = next_l < hi ? next_l : hi;
          const int32_t b_lo = prev_r > a_hi ? prev_r : a_hi;
          const int32_t len_a = a_hi - lo;
          const int32_t total = len_a + (hi - b_lo);
          if (len_a > 0 && (lo >> s) != held_l) {
            held_l = lo >> s;
            load_chunk(base, g.capacity, c, held_l, buf_l, lane);
          }
          if (hi > b_lo && (hi >> s) != held_r) {
            held_r = hi >> s;
            load_chunk(base, g.capacity, c, held_r, buf_r, lane);
          }
          for (int32_t e = lane; e < total; e += kWarp) {
            const int32_t i = e < len_a ? lo + e : b_lo + (e - len_a);
            const T x = e < len_a ? buf_l[i - (held_l << s)]
                                  : buf_r[i - (held_r << s)];
            if (TRACK) {
              merge(v, p, x, i);
            } else {
              take_min(v, x);
            }
          }
          lo = ceil_shift(lo, s);
          hi = hi >> s;
        }
      }
      walk_levels<T, TRACK>(g, offs, base, upper, upper_pos, top_v, top_p,
                            k0, lo, hi, lane, v, p);
      if (lane == j) {
        res_v = v;
        res_p = p;
      }
    }
    if (q < m) {
      out_v[q] = res_v;
      if (TRACK) out_p[q] = res_p;
    }
  }
}

template <typename T>
cudaError_t launch_bulk_query(int track, WalkGeo g, const void* offsets_table,
                              const void* base, const void* upper,
                              const void* upper_pos, const void* ls,
                              const void* rs, long long m, void* out_v,
                              void* out_p, cudaStream_t stream) {
  constexpr size_t kLimit = 227 * 1024;
  const size_t bufs = static_cast<size_t>(kQueryThreads / kWarp) * 2 *
                      (static_cast<size_t>(1) << g.log2c) * sizeof(T);
  if (stage_bytes<T>(g, track != 0) + 16 + bufs > kLimit) g.stage_top = 0;
  const size_t top = (stage_bytes<T>(g, track != 0) + 15) / 16 * 16;
  const size_t smem = top + bufs;
  if (smem > kLimit) return cudaErrorInvalidValue;
  auto kernel = track ? rmq_bulk_kernel<T, true> : rmq_bulk_kernel<T, false>;
  unsigned grid = 0;
  cudaError_t err = query_grid(kernel, smem, m, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kQueryThreads, smem, stream>>>(
      g, top, static_cast<const int32_t*>(offsets_table),
      static_cast<const T*>(base), static_cast<const T*>(upper),
      static_cast<const int32_t*>(upper_pos),
      static_cast<const int32_t*>(ls), static_cast<const int32_t*>(rs), m,
      static_cast<T*>(out_v), static_cast<int32_t*>(out_p));
  return cudaGetLastError();
}

}  // namespace rmq

// dtype: 0 float32, 1 float64.  padded_lens (host, levels - 1 entries);
// offsets_table (device int32, levels - 1 entries).  out_p may be null
// unless track.  Returns cudaErrorInvalidValue when the per-warp chunk
// buffers do not fit in shared memory (c * sizeof(T) > 14 KB).
extern "C" int rmq_bulk_query(int dtype, int track, int capacity, int c,
                              int levels, const int* padded_lens,
                              int stage_top, const void* offsets_table,
                              const void* base, const void* upper,
                              const void* upper_pos, const void* ls,
                              const void* rs, long long m, void* out_v,
                              void* out_p, void* stream) {
  if (m <= 0) return 0;
  if (levels < 1 || levels > rmq::kMaxLevels)
    return static_cast<int>(cudaErrorInvalidValue);
  const rmq::WalkGeo g = rmq::make_walk_geo(capacity, c, levels, nullptr,
                                            padded_lens, stage_top);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return rmq::launch_bulk_query<float>(track, g, offsets_table, base,
                                         upper, upper_pos, ls, rs, m, out_v,
                                         out_p, s);
  if (dtype == 1)
    return rmq::launch_bulk_query<double>(track, g, offsets_table, base,
                                          upper, upper_pos, ls, rs, m,
                                          out_v, out_p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
