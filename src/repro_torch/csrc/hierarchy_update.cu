// Re-reduce the chunks that an update batch touched, every upper level,
// in place in the successor's planes (table row B6).
//
// Replaces: src/repro/kernels/hierarchy_update/kernel.py, update_level,
// update_level_with_positions and update_level0_with_positions (the
// scalar-prefetch Pallas re-reduction, one chunk per grid step, one launch
// a level over deduped chunk ids).
//
// What it computes: the batch comes sorted (a stable sort of the indices,
// so equal indices keep their batch order; indices outside [0, capacity)
// become `capacity` and sort to the end) with each value beside its index,
// at its static size: nothing is deduped or compacted, and the host never
// waits on the card.  The level-1 launch writes the batch into the
// successor's level 0 (the last entry of each run of equal indices wins,
// as if the batch were applied one by one) and re-reduces every level-1
// chunk the batch touches; the level-k launch (k >= 2) re-reduces every
// touched level-k chunk from level k - 1.  Summaries follow the tie rule
// and the NaN rule of rmq_common.cuh (the bits of the chunk's leftmost
// least entry, NaN least) and positions carry that entry's position, so
// the successor equals a fresh build of the mutated array bit for bit.
//
// Bound: device-memory bytes.  Each touched chunk is read once (c entries;
// level 1 also writes the batch's entries) and one summary and position
// are written; above level 1 one position sector is read for the winner.
// A comparison an entry is far below the card's operation rate.
//
// Design: a slice of 32 sorted entries, one coalesced load of their
// indices.  Chunk ids at level k (index >> k log2 c) are monotone in the
// slice, so a ballot flags the lanes whose chunk differs from the previous
// entry's: each flagged lane starts a chunk's run, and the slice whose
// entries hold a run's first entry owns that chunk (and, at level 1, its
// entries), however far the run reaches.
//  * The run layout of build_hopper.cuh (c = 32 V: c = 128 float32 and
//    bfloat16, c = 64 float64; a source whose length is a whole number of
//    vectors and whose values are aligned to the vector): four warps share a
//    slice, each taking eight of its flagged chunks (a slice flags at most 32),
//    so a 2^16-entry batch puts 8192 warps, each with up to 4 KB of loads in
//    flight (2 KB in bf16), on the card at once.  Lane j loads vector j of a
//    chunk with one 16-byte load (8 bytes in bf16), and a warp issues all its
//    loads before its first reduce.  At level 1 the warp's winning entries are
//    then laid over those registers (a byte table in shared memory names, for
//    each entry, the lane that holds its value: one table read and V shuffles a
//    lane and chunk) and stored to level 0: one read of each chunk, and no wait
//    between the stores and the loads.  The reduce is the build core's
//    pick_chunk; lane r stores chunk r's summary and gathers its winner's
//    carried position (above level 1).  The slice's last chunk, when its run
//    goes on past the slice, is read alone after its entries are stored.
//  * Every other layout: one warp a slice, part by part (reduce_chunk_at
//    of rmq_common.cuh, 32 / c chunks a warp for c < 32); its level 1
//    stores the winning entries first and reads its chunks after
//    __syncwarp (the same warp wrote them, and no other warp writes those
//    entries).
// The host entry launches every level back to back on the caller's stream
// (one call from Python, one launch a level).
#include "build_hopper.cuh"

namespace rmq {
namespace update {

constexpr int kThreads = 256;
constexpr int kRun = 8;  // flagged chunks a warp loads at once
constexpr int kParts = 4;  // run layout: warps a slice (kParts * kRun = 32)

// The chunk of index `key` at a level whose chunks span 2^sh indices.
__device__ __forceinline__ int32_t chunk_of(int32_t key, int sh) {
  return sh >= 31 ? 0 : key >> sh;
}

// A warp's slice of the sorted batch, entry q0 + lane in each lane.
template <typename T>
struct Slice {
  int32_t key;     // the index; `cap` past the batch or out of range
  int32_t next;    // the next entry's index (`cap` past the batch)
  int32_t cid;     // the chunk of `key` at this level
  unsigned first;  // lanes that start a chunk's run at this level
  unsigned owned;  // lanes from the first flagged one on
  bool win;        // level 1: the last of its run of equal indices
  T val;           // level 1: its value (stored bits)
};

template <typename T, bool LEVEL1>
__device__ __forceinline__ void load_slice(const int32_t* keys,
                                           const T* vals, int64_t count,
                                           int64_t q0, int32_t cap, int sh,
                                           int lane, Slice<T>& s) {
  const int64_t q = q0 + lane;
  s.key = q < count ? keys[q] : cap;
  int32_t prev = __shfl_up_sync(kFullMask, s.key, 1);
  if (lane == 0 && q0 > 0) prev = keys[q0 - 1];
  s.next = __shfl_down_sync(kFullMask, s.key, 1);
  if (lane == kWarp - 1) s.next = q + 1 < count ? keys[q + 1] : cap;
  const bool valid = s.key < cap;
  s.cid = chunk_of(s.key, sh);
  s.first = __ballot_sync(
      kFullMask, valid && (q == 0 || chunk_of(prev, sh) != s.cid));
  s.owned = s.first ? ~((1u << (__ffs(s.first) - 1)) - 1u) : 0u;
  s.win = false;
  s.val = T{};
  if (LEVEL1) {
    s.win = valid && s.next != s.key && ((s.owned >> lane) & 1u);
    if (s.win) s.val = vals[q];
  }
}

// Level 1: whether the run of the slice's last chunk goes on past the
// slice (its owner then walks the rest of it: spill_run).
template <typename T>
__device__ __forceinline__ bool tail_spills(const Slice<T>& s, int32_t cap,
                                            int sh) {
  const int32_t key = __shfl_sync(kFullMask, s.key, kWarp - 1);
  const int32_t next = __shfl_sync(kFullMask, s.next, kWarp - 1);
  const int32_t cid = __shfl_sync(kFullMask, s.cid, kWarp - 1);
  return s.owned != 0u && key < cap && next < cap &&
         chunk_of(next, sh) == cid;
}

// Level 1: the entries of chunk `cid`'s run from sorted position p on (past
// the owner's slice), 32 at a time until the run ends: each winning entry
// stored to level 0.
template <typename T>
__device__ __forceinline__ void spill_run(const int32_t* keys, const T* vals,
                                          int64_t count, int32_t cap,
                                          int64_t p, int32_t cid, int sh,
                                          int lane, T* base) {
  for (;; p += kWarp) {
    const int64_t q = p + lane;
    const int32_t key = q < count ? keys[q] : cap;
    const int32_t next = q + 1 < count ? keys[q + 1] : cap;
    const bool in = key < cap && chunk_of(key, sh) == cid;
    if (in && next != key) base[key] = vals[q];
    if (__ballot_sync(kFullMask, in) != kFullMask) return;
  }
}

// A chunk's vector `lane` at the run layout; +inf past the source.
template <typename T, int V, typename Src>
__device__ __forceinline__ void load_chunk(const Src& src, int32_t cid,
                                           int lane, uint64_t pol,
                                           hopper::Vec<T, V>& x) {
  const int64_t at = static_cast<int64_t>(cid) * (kWarp * V) + lane * V;
  if (at < src.len) {
    hopper::ld_stream<T, V>(x, src.v + at, pol);
  } else {
    hopper::vfill_inf(x);
  }
}

// Level 1 at the run layout: the winning entries of a group's chunks laid
// over the chunks' registers x[r], through a byte table in shared memory
// (sel[r * c + offset] = 1 + the slice lane that holds the entry), and
// stored to level 0.  Each lane then takes its V entries of chunk r by one
// table read and V shuffles from the lanes named there.
template <typename T, int V>
__device__ __forceinline__ void lay_over(hopper::Vec<T, V> (&x)[kRun],
                                         const int32_t (&ids)[kRun],
                                         const Slice<T>& s, bool mine,
                                         T* base, uint32_t* sel, int lane) {
  constexpr int c = kWarp * V;
  constexpr int words = kRun * c / 4;
#pragma unroll
  for (int i = lane; i < words; i += kWarp) sel[i] = 0u;
  __syncwarp();
  if (mine) {
    base[s.key] = s.val;
    int rw = -1;
#pragma unroll
    for (int r = 0; r < kRun; ++r)
      if (ids[r] == s.cid) rw = r;
    if (rw >= 0)
      reinterpret_cast<uint8_t*>(sel)[rw * c + (s.key & (c - 1))] =
          static_cast<uint8_t>(lane + 1);
  }
  __syncwarp();
#pragma unroll
  for (int r = 0; r < kRun; ++r) {
    uint32_t b = 0;
    if (ids[r] >= 0) {
      const uint8_t* row = reinterpret_cast<const uint8_t*>(sel) + r * c;
      if constexpr (V == 4) {
        b = reinterpret_cast<const uint32_t*>(row)[lane];
      } else {
        b = reinterpret_cast<const uint16_t*>(row)[lane];
      }
    }
    if (__any_sync(kFullMask, b != 0u)) {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const uint32_t from = (b >> (8 * e)) & 0xffu;
        const T v =
            shfl_raw(s.val, from ? static_cast<int>(from) - 1 : lane);
        if (from) hopper::vset(x[r], e, v);
      }
    }
  }
}

// The run layout: kParts warps a slice, each taking up to kRun of its
// flagged chunks (the part-th kRun of them) and their entries.  LEVEL1:
// `src` reads `base` (positions: the index); the chunks' loads go out
// before the warp's winning entries are laid over them (lay_over) and
// stored.  The slice's last chunk, when its run goes on past the slice,
// is read alone after all of its entries are stored.
template <typename T, bool TRACK, bool LEVEL1, typename Src>
__global__ void __launch_bounds__(kThreads,
                                  hopper::build_min_blocks<T>())
    update_runs_kernel(Src src, T* base, const int32_t* __restrict__ keys,
                       const T* __restrict__ vals, int64_t count,
                       int32_t cap, int sh, T* out_v, int32_t* out_p) {
  constexpr int V = hopper::run_width<T>();
  constexpr int c = kWarp * V;
  __shared__ uint32_t sel_all[LEVEL1 ? kThreads / kWarp : 1]
                             [LEVEL1 ? kRun * c / 4 : 1];
  const int lane = threadIdx.x & (kWarp - 1);
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / kWarp;
  const int64_t q0 = warp / kParts * kWarp;
  if (q0 >= count) return;
  Slice<T> s;
  load_slice<T, LEVEL1>(keys, vals, count, q0, cap, sh, lane, s);
  unsigned rest = s.first;
  for (int i = static_cast<int>(warp % kParts) * kRun; i > 0 && rest; --i)
    rest &= rest - 1;
  if (!rest) return;
  // this warp's flags, and its entries: lanes [lo, hi)
  const int lo = __ffs(rest) - 1;
  unsigned mine = rest;
  for (int i = 0; i < kRun && rest; ++i) rest &= rest - 1;
  mine &= ~rest;
  const int hi = rest ? __ffs(rest) - 1 : kWarp;
  // level 1: the slice's last chunk is this warp's and its run goes on
  const bool spill = LEVEL1 && !rest && tail_spills(s, cap, sh);
  if (spill) mine &= ~(1u << (kWarp - 1 - __clz(mine)));
  // Level 1 keeps the chunks it reads in L2 (evict_last) while its
  // stores of the winning entries land in them: 9% faster at level 1
  // than evict_first on an H100; above, a level is read once.
  const uint64_t pol = LEVEL1 ? hopper::evict_last_policy()
                              : hopper::evict_first_policy();
  hopper::Vec<T, V> x[kRun];
  int32_t ids[kRun];
#pragma unroll
  for (int r = 0; r < kRun; ++r) {
    ids[r] = -1;
    if (mine) {
      const int b = __ffs(mine) - 1;
      mine &= mine - 1;
      ids[r] = __shfl_sync(kFullMask, s.cid, b);
      load_chunk<T, V>(src, ids[r], lane, pol, x[r]);
    }
  }
  if constexpr (LEVEL1)
    lay_over<T, V>(x, ids, s, s.win && lane >= lo && lane < hi, base,
                   sel_all[threadIdx.x / kWarp], lane);
  cmp_t<T> my_v = pos_inf<cmp_t<T>>();
  uint32_t my_w = 0;
  int32_t my_id = -1;
#pragma unroll
  for (int r = 0; r < kRun; ++r) {
    if (ids[r] >= 0) {
      cmp_t<T> v;
      uint32_t w;
      hopper::pick_chunk<T, V>(x[r], lane, v, w);
      if (lane == r) {
        my_v = v;
        my_w = w;
        my_id = ids[r];
      }
    }
  }
  if (my_id >= 0) {
    out_v[my_id] = narrow<T>(my_v);
    if (TRACK)
      out_p[my_id] = winner_pos(src, static_cast<int64_t>(my_id) * c + my_w);
  }
  if (spill) {
    const int32_t cid = __shfl_sync(kFullMask, s.cid, kWarp - 1);
    spill_run<T>(keys, vals, count, cap, q0 + kWarp, cid, sh, lane, base);
    __syncwarp();  // its in-slice entries went out in lay_over
    hopper::Vec<T, V> y;
    load_chunk<T, V>(src, cid, lane, pol, y);
    cmp_t<T> v;
    uint32_t w;
    hopper::pick_chunk<T, V>(y, lane, v, w);
    if (lane == 0) {
      out_v[cid] = narrow<T>(v);
      if (TRACK)
        out_p[cid] = winner_pos(src, static_cast<int64_t>(cid) * c + w);
    }
  }
}

// Every other layout, part by part.
template <typename T, bool TRACK, bool LEVEL1, typename Src>
__global__ void __launch_bounds__(kThreads)
    update_parts_kernel(Src src, T* base, const int32_t* __restrict__ keys,
                        const T* __restrict__ vals, int64_t count,
                        int32_t cap, int sh, int c, T* out_v,
                        int32_t* out_p) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int64_t q0 =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) & ~31ll;
  if (q0 >= count) return;
  Slice<T> s;
  load_slice<T, LEVEL1>(keys, vals, count, q0, cap, sh, lane, s);
  if (LEVEL1) {
    if (s.win) base[s.key] = s.val;
    if (tail_spills(s, cap, sh))
      spill_run<T>(keys, vals, count, cap, q0 + kWarp,
                   __shfl_sync(kFullMask, s.cid, kWarp - 1), sh, lane, base);
    __syncwarp();  // the warp's own writes, before it reads its chunks
  }
  const int lanes = chunk_lanes(c);
  const int cpw = chunks_per_warp(c);
  unsigned rest = s.first;
  while (rest) {
    int32_t mine = -1;
    for (int g = 0; g < cpw && rest; ++g) {
      const int b = __ffs(rest) - 1;
      rest &= rest - 1;
      const int32_t cid = __shfl_sync(kFullMask, s.cid, b);
      if (lane / lanes == g) mine = cid;
    }
    cmp_t<T> v;
    int64_t at;
    reduce_chunk_at<T>(src, mine, c, lane, v, at);
    if ((lane & (lanes - 1)) == 0 && mine >= 0) {
      out_v[mine] = narrow<T>(v);
      if (TRACK) out_p[mine] = winner_pos(src, at);
    }
  }
}

template <typename T, bool TRACK, bool LEVEL1, typename Src>
cudaError_t launch_level(const Src& src, T* base, const int32_t* keys,
                         const T* vals, long long count, int32_t cap, int sh,
                         int c, T* out_v, int32_t* out_p,
                         cudaStream_t stream) {
  const long long slices = (count + kWarp - 1) / kWarp;
  const bool runs = hopper::run_layout<T>(c, src.len, src.v);
  note_instance(runs ? kRunsInstance : 0);
  const long long warps = runs ? slices * kParts : slices;
  const unsigned grid =
      static_cast<unsigned>((warps * kWarp + kThreads - 1) / kThreads);
  if (runs) {
    update_runs_kernel<T, TRACK, LEVEL1><<<grid, kThreads, 0, stream>>>(
        src, base, keys, vals, count, cap, sh, out_v, out_p);
  } else {
    update_parts_kernel<T, TRACK, LEVEL1><<<grid, kThreads, 0, stream>>>(
        src, base, keys, vals, count, cap, sh, c, out_v, out_p);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t update_levels(int track, void* base_v, long long capacity,
                          void* upper_v, void* upper_p,
                          const long long* offsets,
                          const long long* src_lens, int levels, int log2c,
                          const int32_t* keys, const void* vals_v,
                          long long count, int* launched,
                          cudaStream_t stream) {
  T* base = static_cast<T*>(base_v);
  T* upper = static_cast<T*>(upper_v);
  int32_t* upos = static_cast<int32_t*>(upper_p);
  const T* vals = static_cast<const T*>(vals_v);
  const int c = 1 << log2c;
  const int32_t cap = static_cast<int32_t>(capacity);
  for (int k = 1; k < levels; ++k) {
    T* ov = upper + offsets[k - 1];
    int32_t* op = track ? upos + offsets[k - 1] : nullptr;
    const int sh = k * log2c;
    cudaError_t err;
    if (k == 1) {
      const IndexedSrc<T> src{base, capacity};
      err = track ? launch_level<T, true, true>(src, base, keys, vals, count,
                                                cap, sh, c, ov, op, stream)
                  : launch_level<T, false, true>(src, base, keys, vals,
                                                 count, cap, sh, c, ov, op,
                                                 stream);
    } else {
      const T* sv = upper + offsets[k - 2];
      const long long len = src_lens[k - 1];
      if (track) {
        const CarriedSrc<T> src{sv, upos + offsets[k - 2], len};
        err = launch_level<T, true, false>(src, base, keys, vals, count, cap,
                                           sh, c, ov, op, stream);
      } else {
        const IndexedSrc<T> src{sv, len};
        err = launch_level<T, false, false>(src, base, keys, vals, count,
                                            cap, sh, c, ov, op, stream);
      }
    }
    if (err != cudaSuccess) return err;
    *launched = k;
  }
  return cudaSuccess;
}

}  // namespace update
}  // namespace rmq

// One update, every upper level: the level-k launch for k = 1 .. levels-1,
// back to back on `stream`, each checked with cudaGetLastError().
// dtype: 0 float32, 1 float64, 2 bfloat16.  base (capacity entries), upper /
// upper_pos (upper_pos null when !track): the successor's planes, written in
// place. offsets[k-1]: level k's offset in upper; src_lens[k-1]: the length of
// level k - 1 (capacity for k = 1, else its padded length).  keys: device
// int32, ascending, out-of-range indices set to capacity; vals: device, beside
// them; count: the batch's static size.  *launched: the levels launched without
// error.
extern "C" int rmq_update_levels(int dtype, int track, void* base,
                                 long long capacity, void* upper,
                                 void* upper_pos, const long long* offsets,
                                 const long long* src_lens, int levels,
                                 int log2c, const void* keys,
                                 const void* vals, long long count,
                                 int* launched, void* stream) {
  *launched = 0;
  if (count <= 0 || levels < 2) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* k = static_cast<const int32_t*>(keys);
  if (dtype == 0)
    return rmq::update::update_levels<float>(
        track, base, capacity, upper, upper_pos, offsets, src_lens, levels,
        log2c, k, vals, count, launched, s);
  if (dtype == 1)
    return rmq::update::update_levels<double>(
        track, base, capacity, upper, upper_pos, offsets, src_lens, levels,
        log2c, k, vals, count, launched, s);
  if (dtype == 2)
    return rmq::update::update_levels<rmq::bf16>(
        track, base, capacity, upper, upper_pos, offsets, src_lens, levels,
        log2c, k, vals, count, launched, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
