// The query walk of rmq_fused.cu (B2), rmq_scan.cu (B4), rmq_short.cu (B5)
// and rmq_bulk.cu (B7), designed for Hopper: the loads of a query's levels
// issued before any merge, 16-byte vectors, values only on the way up, one
// position gather per query.
//
// What it computes: per inclusive query (l, r), with r exclusive from here
// on, the left and the right partial chunk of every level below the top,
//   [lo_k, min(ceil(lo_k/c)*c, hi_k))  and  [max(floor(hi_k/c)*c, .), hi_k),
// with lo_{k+1} = ceil(lo_k/c), hi_{k+1} = floor(hi_k/c) while lo_k < hi_k,
// then the top over [lo_K, hi_K).  These segments tile [l, r] from left to
// right: L0-left, L1-left, ..., top, ..., L1-right, L0-right (ranks 0 ..
// 2K).  Positions of real entries grow strictly along a level
// (rmq_common.cuh), so the lexicographic (value, position) minimum is the
// minimum of (value, segment rank, offset in the segment), and its
// position is one gather: the index itself at level 0, upper_pos[offset_k
// + i] above.  A one-level walk (B5, and single-level plans) is all top:
// level 0 itself, positions = indices.
//
// How it runs (G lanes per query, 32 / G queries at once a warp; 32
// queries a tile as in WLQ):
//  * loads are V-wide vectors (16 bytes: float4 / double2; 8 bytes: four bf16)
//    where c, the capacity and the pointers allow it; lane j of a group covers
//    vectors j, j + G, ... of a chunk and loads only where its vector overlaps
//    the part, so only the sectors a part touches are requested.  At c = 32 V
//    (c = 128 in float32 and bfloat16, the paper's default) one warp
//    instruction covers a chunk (G = 32), and the loads of both parts of the
//    first kBatchLevels levels are all issued before the first merge: a large
//    span waits on memory about once, not once per level.  With G < 32 (lane
//    groups, same layout) each lane holds 32 / G vectors of a part and a group
//    issues one level's two parts at a time;
//  * upper levels are read as values only: the position plane is touched
//    once per query, by the gather;
//  * level 0 either streams (L1 no-allocate, L2 evict_first: B2 / B4) or
//    goes through L1 (CACHE0: B5 / B7, whose sorted or short batches read
//    neighbouring sectors again); upper-level reads are L2 evict_last
//    (paper §5.8: the upper levels stay in cache);
//  * each lane merges its vectors in rank order with vmin (min.NaN, so a
//    NaN reaches the minimum; bf16 entries widened to float32 in registers,
//    rmq_common.cuh) and keeps the first vector that lowered its
//    minimum (a strict <); a query whose minimum comes out NaN is walked
//    again with NaN as the least value (`lowered`), so a NaN-free span
//    pays one vote a round for the NaN rule (and the kernel the second
//    walk's code and registers); the group takes
//    the value minimum M by shuffles and the smallest (rank, vector) key
//    among the lanes that hold M with __reduce_min_sync.  No float is read
//    as an ordered integer: -0.0 and +0.0 compare equal and the key
//    decides;
//  * lane j keeps M and the key of the tile's query j.  At the end of the
//    tile every lane re-reads its winning vector once, takes the first
//    valid entry equal to M (its own stored bits: the value returned is the
//    winning entry's, never a min of two signed zeros) and gathers its
//    position, all 32 queries at once.  A span whose minimum is +inf (or
//    an empty one) answers (+inf, l) ((+inf, PAD_POS) when empty), the
//    leftmost entry, as the lexicographic walk does; a span that holds a
//    NaN answers its leftmost NaN, bits and position.
// So the kernels on this walk return the same bits for the same span, zeros
// of either sign and NaNs included, on any hierarchy whose upper entries
// carry the bits of their chunk's leftmost minimal entry (every build,
// value-only or with positions: build_hopper.cuh, rmq_common.cuh).
#pragma once

#include "hopper_ld.cuh"
#include "rmq_walk.cuh"

namespace rmq {
namespace hopper {

// Level 0: through L1 where CACHE0 (B5 / B7), else past it.
template <typename T, int V, bool CACHE0>
__device__ __forceinline__ void ld_level0(Vec<T, V>& v, const T* p,
                                          uint64_t pol) {
  if constexpr (CACHE0) {
    ld_keep<T, V>(v, p, pol);
  } else {
    ld_stream<T, V>(v, p, pol);
  }
}

// ---------------------------------------------------------------------------
// Launch-wide geometry
// ---------------------------------------------------------------------------
// Blocks of kQueryThreads an SM is built for: a cap of 80 registers, 24
// warps an SM (at 64 the batch spills; at 2 blocks too few warps hide
// the walk's latency).
constexpr int kQueryMinBlocks = 3;
// Levels below the top whose loads one-chunk-a-warp walks issue together
// (three: every level below the 512-entry top at n = 2^30, c = 128).
constexpr int kBatchLevels = 3;

// CACHE0: level 0 is read through L1 (see the file comment).
template <typename T, int V, bool CACHE0 = false>
struct Walk {
  const int32_t* offs;  // shared memory: level k >= 1 at offs[k - 1]
  const T* base;
  const T* upper;
  const int32_t* upper_pos;
  const T* top;     // the top level in device memory
  uint32_t top_s;   // its shared-memory copy's address, when staged
  bool staged;
  int32_t capacity;
  int32_t top_len;
  int s;         // log2 c
  int top_k;     // K = levels - 1, the top's level
  int nv;        // vectors a chunk: c / V
  int sub_bits;  // key = rank << sub_bits | vector index in the segment
};

template <typename T, int V, bool C0>
__device__ __forceinline__ void init_walk(Walk<T, V, C0>& w,
                                          const WalkGeo& g,
                                          const int32_t* offs, const T* base,
                                          const T* upper,
                                          const int32_t* upper_pos,
                                          const T* top, uint32_t top_s) {
  w.offs = offs;
  w.base = base;
  w.upper = upper;
  w.upper_pos = upper_pos;
  w.top = top;
  w.top_s = top_s;
  w.staged = g.stage_top != 0;
  w.capacity = g.capacity;
  w.top_len = g.top_len;
  w.s = g.log2c;
  w.top_k = g.levels - 1;
  w.nv = (1 << g.log2c) / V;
  // Ranks run 0 .. 2K: left parts k, the top K, right parts 2K - k.
  int rbits = 0;
  while ((1 << rbits) <= 2 * w.top_k) ++rbits;
  w.sub_bits = rbits == 0 ? 31 : 32 - rbits;
}

// Entries [i, i + V) of the top.  Where CACHE0, a one-level walk's top is
// read as level 0 is.
template <typename T, int V, bool C0>
__device__ __forceinline__ void ld_top(const Walk<T, V, C0>& w, int32_t i,
                                       uint64_t stream, uint64_t keep,
                                       Vec<T, V>& x) {
  if (w.staged) {
    ld_shared<T, V>(x, w.top_s + static_cast<uint32_t>(i) * sizeof(T));
  } else if (C0 && w.top_k == 0) {
    ld_level0<T, V, C0>(x, w.top + i, stream);
  } else {
    ld_keep<T, V>(x, w.top + i, keep);
  }
}

// The left (or right) part of level k in closed form: its chunk start cs
// and the part [cs + a, cs + b).  Empty parts have a == b.
__device__ __forceinline__ void level_part(int s, int32_t lo0, int32_t hi0,
                                           int k, bool left, int32_t& cs,
                                           int32_t& a, int32_t& b) {
  const int sh = k * s;
  const int32_t lo = ceil_shift(lo0, sh);
  const int32_t hi = hi0 >> sh;
  const int32_t c1 = (1 << s) - 1;
  const int32_t next_l = (lo + c1) & ~c1;
  const int32_t prev_r = hi & ~c1;
  if (left) {
    cs = lo & ~c1;
    a = lo - cs;
    b = (next_l < hi ? next_l : hi) - cs;
  } else {
    cs = prev_r;
    a = 0;
    b = next_l < hi ? hi - prev_r : 0;
  }
  if (lo >= hi) b = a;  // a level the walk never reaches
}

// Whether a merge lowered a lane's running minimum from `before` to v.  A
// query's first walk compares as floats (vmin still carries a NaN into v,
// but a NaN never lowers it there); a query whose minimum comes out NaN is
// walked again with NAN_LEAST, where NaN is the least value (vless of
// rmq_common.cuh).  So a NaN-free span pays only the vote on its minimum.
template <bool NAN_LEAST, typename T>
__device__ __forceinline__ bool lowered(T v, T before) {
  if constexpr (NAN_LEAST) return vless(v, before);
  return v < before;
}

// The vectors gl, gl + G, ... of one part that lane gl of a G-lane group
// holds, loaded and merged in ascending order: the strict < keeps the
// lane's leftmost minimum.
template <int G, bool LEVEL0, bool NAN_LEAST, typename T, int V, bool C0>
__device__ __forceinline__ void part_walk(const Walk<T, V, C0>& w,
                                          const T* p, int32_t cs, int32_t a,
                                          int32_t b, uint32_t rank, int gl,
                                          uint64_t pol, cmp_t<T>& v,
                                          uint32_t& best_rank,
                                          int32_t& best_sub) {
  for (int vi = gl; vi < w.nv; vi += G) {
    const int32_t st = vi * V;
    if (st + V > a && st < b) {
      Vec<T, V> x;
      if (LEVEL0) {
        ld_level0<T, V, C0>(x, p + cs + st, pol);
      } else {
        ld_keep<T, V>(x, p + cs + st, pol);
      }
      const cmp_t<T> before = v;
#pragma unroll
      for (int e = 0; e < V; ++e)
        if (st + e >= a && st + e < b) v = vmin(v, vget(x, e));
      if (lowered<NAN_LEAST>(v, before)) {
        best_rank = rank;
        best_sub = vi;
      }
    }
  }
}

template <int G, bool NAN_LEAST, typename T, int V, bool C0>
__device__ __forceinline__ void part_any(const Walk<T, V, C0>& w,
                                         int32_t lo0, int32_t hi0, int k,
                                         bool left, int gl, uint64_t stream,
                                         uint64_t keep, cmp_t<T>& v,
                                         uint32_t& best_rank,
                                         int32_t& best_sub) {
  int32_t cs, a, b;
  level_part(w.s, lo0, hi0, k, left, cs, a, b);
  const uint32_t rank = left ? k : 2 * w.top_k - k;
  if (k == 0) {
    part_walk<G, true, NAN_LEAST>(w, w.base, cs, a, b, rank, gl, stream,
                                  v, best_rank, best_sub);
  } else {
    part_walk<G, false, NAN_LEAST>(w, w.upper + w.offs[k - 1], cs, a, b,
                                   rank, gl, keep, v, best_rank, best_sub);
  }
}

// The level-0 bounds of an inclusive query: [lo, hi) clipped to the level.
__device__ __forceinline__ void bounds0(int32_t capacity, int32_t l,
                                        int32_t r, int32_t& lo,
                                        int32_t& hi) {
  lo = l > 0 ? l : 0;
  const int64_t r_ex = static_cast<int64_t>(r) + 1;
  hi = static_cast<int32_t>(r_ex < capacity ? r_ex : capacity);
}

// Levels kb.. of a walk whose range at level kb is [lo, hi): left parts
// up, the top, right parts down (levels kb and above only), by lane gl of
// a G-lane group.
template <int G, bool NAN_LEAST, typename T, int V, bool C0>
__device__ __forceinline__ void walk_from(const Walk<T, V, C0>& w,
                                          int32_t lo0, int32_t hi0,
                                          int32_t lo, int32_t hi, int kb,
                                          int gl, uint64_t stream,
                                          uint64_t keep, cmp_t<T>& v,
                                          uint32_t& best_rank,
                                          int32_t& best_sub) {
  int kp = kb;  // live levels below the top
  while (kp < w.top_k && lo < hi) {
    part_any<G, NAN_LEAST>(w, lo0, hi0, kp, true, gl, stream, keep, v,
                           best_rank, best_sub);
    lo = ceil_shift(lo, w.s);
    hi >>= w.s;
    ++kp;
  }
  // The top over [lo, hi): vector it of the lane starts at
  // (lo & ~(V-1)) + (it * G + gl) * V.
  if (kp == w.top_k) {
    const int32_t end = hi < w.top_len ? hi : w.top_len;
    int32_t it = 0;
#pragma unroll 1
    for (int32_t t0 = (lo & ~(V - 1)) + gl * V; t0 < end;
         t0 += G * V, ++it) {
      Vec<T, V> x;
      ld_top(w, t0, stream, keep, x);
      const cmp_t<T> before = v;
#pragma unroll
      for (int e = 0; e < V; ++e)
        if (t0 + e >= lo && t0 + e < end) v = vmin(v, vget(x, e));
      if (lowered<NAN_LEAST>(v, before)) {
        best_rank = w.top_k;
        best_sub = it * G + gl;
      }
    }
  }
  for (int k = kp - 1; k >= kb; --k)
    part_any<G, NAN_LEAST>(w, lo0, hi0, k, false, gl, stream, keep, v,
                           best_rank, best_sub);
}

// ---------------------------------------------------------------------------
// One-chunk-a-warp walks (c = 32 V, 16-byte vectors: each lane holds one
// vector of each part): the loads of the first kBatchLevels levels, both
// parts, are issued before the first merge.  Offsets are unsigned 32-bit
// (the capacity check keeps every coordinate below 2^31), so an address
// is one wide multiply-add.  The levels' offsets come from shared memory
// (w.offs): held in registers, they pushed B2's instances past the cap of
// 80 (8-16 bytes of spills) once the NaN second walk was added.
// ---------------------------------------------------------------------------
template <typename T, int V, bool C0>
__device__ __forceinline__ void walk_batched(const Walk<T, V, C0>& w,
                                             int32_t lo0, int32_t hi0,
                                             int lane, uint64_t stream,
                                             uint64_t keep, cmp_t<T>& v,
                                             uint32_t& key) {
  using F = cmp_t<T>;
  constexpr int UL = kBatchLevels;
  const uint32_t c1 = (1u << w.s) - 1u;
  const uint32_t st = lane * V;
  Vec<T, V> xl[UL], xr[UL];
  // Each level's parts, chunk-relative (c <= 128): left [al, bl) and
  // right [0, br) as al | bl << 8 | br << 16.
  uint32_t pk[UL];
  uint32_t lo = lo0, hi = hi0;
  int kb = 0;  // levels in the batch
#pragma unroll
  for (int k = 0; k < UL; ++k) {
    pk[k] = 0;
    if (k < w.top_k && lo < hi) {
      const uint32_t next_l = (lo + c1) & ~c1;
      const uint32_t csl = lo & ~c1;
      const uint32_t al = lo & c1;
      const uint32_t bl = (next_l < hi ? next_l : hi) - csl;
      const uint32_t br = next_l < hi ? hi & c1 : 0u;
      pk[k] = al | (bl << 8) | (br << 16);
      const T* lv =
          k == 0 ? w.base : w.upper + static_cast<uint32_t>(w.offs[k - 1]);
      if (st + V > al && st < bl) {
        if (k == 0) {
          ld_level0<T, V, C0>(xl[k], lv + (csl + st), stream);
        } else {
          ld_keep<T, V>(xl[k], lv + (csl + st), keep);
        }
      }
      if (st < br) {
        if (k == 0) {
          ld_level0<T, V, C0>(xr[k], lv + ((hi & ~c1) + st), stream);
        } else {
          ld_keep<T, V>(xr[k], lv + ((hi & ~c1) + st), keep);
        }
      }
      kb = k + 1;
      lo = next_l >> w.s;
      hi >>= w.s;
    }
  }
  v = pos_inf<F>();
  uint32_t best_rank = 0;
  int32_t best_sub = lane;
#pragma unroll
  for (int k = 0; k < UL; ++k) {
    const uint32_t al = pk[k] & 0xff;
    const uint32_t bl = (pk[k] >> 8) & 0xff;
    if (st + V > al && st < bl) {
      const F before = v;
#pragma unroll
      for (int e = 0; e < V; ++e)
        if (st + e >= al && st + e < bl) v = vmin(v, vget(xl[k], e));
      if (v < before) best_rank = k;
    }
  }
  walk_from<kWarp, false>(w, lo0, hi0, static_cast<int32_t>(lo),
                              static_cast<int32_t>(hi), kb, lane, stream,
                              keep, v, best_rank, best_sub);
#pragma unroll
  for (int k = UL - 1; k >= 0; --k) {
    const uint32_t br = pk[k] >> 16;
    if (st < br) {
      const F before = v;
#pragma unroll
      for (int e = 0; e < V; ++e)
        if (st + e < br) v = vmin(v, vget(xr[k], e));
      if (v < before) {
        best_rank = 2 * w.top_k - k;
        best_sub = lane;
      }
    }
  }
  key = (best_rank << w.sub_bits) | static_cast<uint32_t>(best_sub);
}

// The same layout in lane groups (G < 32 lanes a query): lane gl holds the
// 32 / G vectors gl, gl + G, ... of each part; a group issues both parts
// of one level, then merges them.  Right parts come bottom-up here, in
// falling rank, so they gather in an accumulator of their own (a part's
// leftmost minimum, then `<=` across parts: the smaller rank wins a tie)
// that joins the rest after the levels above and the top, whose ranks are
// all smaller.  The levels' offsets are read from shared memory (w.offs),
// not held in registers.
template <int G, typename T, int V, bool C0>
__device__ __forceinline__ void walk_grouped(const Walk<T, V, C0>& w,
                                             int32_t lo0, int32_t hi0,
                                             int gl, uint64_t stream,
                                             uint64_t keep, cmp_t<T>& v,
                                             uint32_t& key) {
  using F = cmp_t<T>;
  constexpr int UL = kBatchLevels;
  constexpr int NPL = kWarp / G;  // vectors of a part a lane holds
  const uint32_t c1 = (1u << w.s) - 1u;
  v = pos_inf<F>();
  uint32_t best_rank = 0;
  int32_t best_sub = gl;
  F vr = pos_inf<F>();  // the right parts' accumulator
  uint32_t rr = 0;
  int32_t rsub = 0;
  uint32_t lo = lo0, hi = hi0;
  int kb = 0;  // levels walked here
#pragma unroll
  for (int k = 0; k < UL; ++k) {
    if (k < w.top_k && lo < hi) {
      const uint32_t next_l = (lo + c1) & ~c1;
      const uint32_t csl = lo & ~c1;
      const uint32_t csr = hi & ~c1;
      const uint32_t al = lo & c1;
      const uint32_t bl = (next_l < hi ? next_l : hi) - csl;
      const uint32_t br = next_l < hi ? hi & c1 : 0u;
      const T* lv = k == 0 ? w.base : w.upper + w.offs[k - 1];
      Vec<T, V> xl[NPL], xr[NPL];
#pragma unroll
      for (int j = 0; j < NPL; ++j) {
        const uint32_t st = (gl + j * G) * V;
        if (st + V > al && st < bl) {
          if (k == 0) {
            ld_level0<T, V, C0>(xl[j], lv + (csl + st), stream);
          } else {
            ld_keep<T, V>(xl[j], lv + (csl + st), keep);
          }
        }
        if (st < br) {
          if (k == 0) {
            ld_level0<T, V, C0>(xr[j], lv + (csr + st), stream);
          } else {
            ld_keep<T, V>(xr[j], lv + (csr + st), keep);
          }
        }
      }
      F pm = pos_inf<F>();
      int32_t ps = 0;
#pragma unroll
      for (int j = 0; j < NPL; ++j) {
        const uint32_t st = (gl + j * G) * V;
        if (st + V > al && st < bl) {
          const F before = v;
#pragma unroll
          for (int e = 0; e < V; ++e)
            if (st + e >= al && st + e < bl) v = vmin(v, vget(xl[j], e));
          if (v < before) {
            best_rank = k;
            best_sub = gl + j * G;
          }
        }
        if (st < br) {
          const F before = pm;
#pragma unroll
          for (int e = 0; e < V; ++e)
            if (st + e < br) pm = vmin(pm, vget(xr[j], e));
          if (pm < before) ps = gl + j * G;
        }
      }
      // vmin: a NaN part still reaches v, so the query is walked again
      if (pm <= vr) {
        rr = 2 * w.top_k - k;
        rsub = ps;
      }
      vr = vmin(vr, pm);
      kb = k + 1;
      lo = next_l >> w.s;
      hi >>= w.s;
    }
  }
  walk_from<G, false>(w, lo0, hi0, static_cast<int32_t>(lo),
                          static_cast<int32_t>(hi), kb, gl, stream, keep, v,
                          best_rank, best_sub);
  if (vr < v) {
    best_rank = rr;
    best_sub = rsub;
  }
  v = vmin(v, vr);
  key = (best_rank << w.sub_bits) | static_cast<uint32_t>(best_sub);
}

// The same walk part by part, G lanes a query (lane gl of the group):
// every layout's first walk where the one-chunk-a-warp layout does not
// hold, and any layout's second walk (NAN_LEAST) of a query whose minimum
// came out NaN.
template <int G, bool NAN_LEAST, typename T, int V, bool C0>
__device__ __forceinline__ void walk_plain(const Walk<T, V, C0>& w,
                                           int32_t lo0, int32_t hi0,
                                           int gl, uint64_t stream,
                                           uint64_t keep, cmp_t<T>& v,
                                           uint32_t& key) {
  v = pos_inf<cmp_t<T>>();
  uint32_t best_rank = 0;
  int32_t best_sub = gl;
  walk_from<G, NAN_LEAST>(w, lo0, hi0, lo0, hi0, 0, gl, stream, keep, v,
                          best_rank, best_sub);
  key = (best_rank << w.sub_bits) | static_cast<uint32_t>(best_sub);
}

// A group's answer to one query: the minimum M over its G lanes
// (shuffles) and the smallest key among the lanes that hold it
// (__reduce_min_sync on the group's lanes).
template <int G, bool NAN_LEAST, typename T>
__device__ __forceinline__ void group_min(T v, uint32_t key, int lane, T& m,
                                          uint32_t& kmin) {
  m = v;
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1)
    m = vmin(m, __shfl_xor_sync(kFullMask, m, o));
  unsigned mask = kFullMask;
  if constexpr (G < kWarp) mask = ((1u << G) - 1u) << (lane & ~(G - 1));
  // a first walk's NaN minimum is walked again, so its key is not used
  const bool hold = NAN_LEAST ? vsame(v, m) : v == m;
  kmin = __reduce_min_sync(mask, hold ? key : 0xffffffffu);
}

// End of a tile: lane `lane` answers its own query from (M, key): the
// winning vector re-read once, the first valid entry equal to M, and the
// one position gather.  `val` is the winning entry's stored bits.
template <typename T, int V, bool TRACK, bool C0>
__device__ __forceinline__ void answer(const Walk<T, V, C0>& w, int32_t l,
                                       int32_t r, cmp_t<T> res_m,
                                       uint32_t key, uint64_t stream,
                                       uint64_t keep, T& val,
                                       int32_t& pos) {
  int32_t lo0, hi0;
  bounds0(w.capacity, l, r, lo0, hi0);
  if (res_m == pos_inf<cmp_t<T>>()) {
    // Every entry +inf: the leftmost entry of the span, +inf.
    val = pos_inf<T>();
    pos = lo0 < hi0 ? lo0 : kPadPos;
    return;
  }
  const uint32_t rank = key >> w.sub_bits;
  const int32_t sub = static_cast<int32_t>(key & ((1u << w.sub_bits) - 1u));
  int k;
  int32_t a, b, start;
  Vec<T, V> x;
  if (rank == static_cast<uint32_t>(w.top_k)) {
    k = w.top_k;
    const int sh = k * w.s;
    a = ceil_shift(lo0, sh);
    b = hi0 >> sh;
    if (b > w.top_len) b = w.top_len;
    start = (a & ~(V - 1)) + sub * V;
    ld_top(w, start, stream, keep, x);
  } else {
    const bool left = rank < static_cast<uint32_t>(w.top_k);
    k = left ? static_cast<int>(rank) : 2 * w.top_k - static_cast<int>(rank);
    int32_t cs;
    level_part(w.s, lo0, hi0, k, left, cs, a, b);
    a += cs;
    b += cs;
    start = cs + sub * V;
    if (k == 0) {
      ld_level0<T, V, C0>(x, w.base + start, stream);
    } else {
      ld_keep<T, V>(x, w.upper + w.offs[k - 1] + start, keep);
    }
  }
  int e_win = V - 1;
#pragma unroll
  for (int e = V - 1; e >= 0; --e)
    if (start + e >= a && start + e < b && vsame(vget(x, e), res_m))
      e_win = e;
  T got = vraw(x, 0);
#pragma unroll
  for (int e = 1; e < V; ++e)
    if (e == e_win) got = vraw(x, e);
  val = got;
  const int32_t i = start + e_win;
  pos = i;
  if (TRACK && k > 0) pos = w.upper_pos[w.offs[k - 1] + i];
}

// The WLQ batch loop over tiles of tq queries (32, or fewer for a small
// batch: B5), G lanes a query: warps stride over the tiles (B2 / B4 / B5),
// or each takes a contiguous run of them (`runs`: a sorted batch's
// neighbours stay on one warp, B7).  A group answers the queries of its
// own lanes, one a round.  Lane groups keep the tile's bounds and answers
// in shared memory, not in registers across the rounds: their walk needs
// those registers (held there, they spilled at the cap of 80).
// Writes the value plane where out_v is not null and the position plane
// where out_p is not null (TRACK).
template <typename T, bool TRACK, int V, bool FAST, int G = kWarp,
          bool C0 = false>
__device__ __forceinline__ void answer_batch(const Walk<T, V, C0>& w,
                                             const int32_t* ls,
                                             const int32_t* rs, int64_t m,
                                             T* out_v, int32_t* out_p,
                                             bool runs = false,
                                             int tq = kWarp) {
  static_assert(G == kWarp || FAST,
                "lane groups need the one-chunk-a-warp layout");
  using F = cmp_t<T>;
  const int lane = threadIdx.x & (kWarp - 1);
  const int gl = lane & (G - 1);
  // Tile counters fit 32 bits: 2^31 tiles of bounds would not fit a card.
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) / kWarp;
  const int nwarps = gridDim.x * blockDim.x / kWarp;
  const int tiles = static_cast<int>((m + tq - 1) / tq);
  int first = warp, end = tiles, step = nwarps;
  if (runs) {  // runs of tiles / nwarps tiles, one more for the first ones
    const int per = tiles / nwarps, rest = tiles % nwarps;
    first = warp * per + (warp < rest ? warp : rest);
    end = first + per + (warp < rest ? 1 : 0);
    step = 1;
  }
  const uint64_t stream = evict_first_policy();
  const uint64_t keep = evict_last_policy();
  // Lane groups: the tile's bounds and answers, one entry a thread (a
  // whole warp parks its own there around a second walk).
  __shared__ int32_t tile_l[kQueryThreads];
  __shared__ int32_t tile_r[kQueryThreads];
  __shared__ F tile_m[kQueryThreads];
  __shared__ uint32_t tile_k[kQueryThreads];
  for (int tile = first; tile < end; tile += step) {
    const int64_t qi = static_cast<int64_t>(tile) * tq + lane;
    const bool mine = lane < tq && qi < m;
    int32_t my_l = 0, my_r = -1;
    if (mine) {
      my_l = ls[qi];
      my_r = rs[qi];
    }
    const int64_t left = m - static_cast<int64_t>(tile) * tq;
    const int count = left < tq ? static_cast<int>(left) : tq;
    const int rounds = G == kWarp ? count : G;
    F res_m = pos_inf<F>();
    uint32_t res_key = 0;
    if constexpr (G < kWarp) {
      __syncwarp();
      tile_l[threadIdx.x] = my_l;
      tile_r[threadIdx.x] = my_r;
      __syncwarp();
    }
    for (int j = 0; j < rounds; ++j) {
      F v, mm;
      uint32_t key, kmin;
      {
        int32_t lo0, hi0;
        if constexpr (G < kWarp) {
          const int t = (threadIdx.x & ~(G - 1)) | j;
          bounds0(w.capacity, tile_l[t], tile_r[t], lo0, hi0);
        } else {
          bounds0(w.capacity, __shfl_sync(kFullMask, my_l, j),
                  __shfl_sync(kFullMask, my_r, j), lo0, hi0);
        }
        if constexpr (!FAST) {
          walk_plain<kWarp, false>(w, lo0, hi0, lane, stream, keep, v, key);
        } else if constexpr (G == kWarp) {
          walk_batched(w, lo0, hi0, lane, stream, keep, v, key);
        } else {
          walk_grouped<G>(w, lo0, hi0, gl, stream, keep, v, key);
        }
      }
      group_min<G, false>(v, key, lane, mm, kmin);
      if constexpr (G == kWarp) {
        if (__any_sync(kFullMask, mm != mm)) {
          // A NaN in this round's span: walk it again, NaN least.  What
          // the rounds keep in registers waits in shared memory meanwhile
          // (volatile: really stored), so this rare path needs no more of
          // them than the first walks.
          volatile int32_t* park_l = tile_l;
          volatile int32_t* park_r = tile_r;
          volatile F* park_m = tile_m;
          volatile uint32_t* park_k = tile_k;
          __syncwarp();
          park_l[threadIdx.x] = my_l;
          park_r[threadIdx.x] = my_r;
          park_m[threadIdx.x] = res_m;
          park_k[threadIdx.x] = res_key;
          __syncwarp();
          int32_t lo0, hi0;
          const int t = (threadIdx.x & ~(kWarp - 1)) | j;
          bounds0(w.capacity, park_l[t], park_r[t], lo0, hi0);
          walk_plain<G, true>(w, lo0, hi0, gl, stream, keep, v, key);
          group_min<G, true>(v, key, lane, mm, kmin);
          my_l = park_l[threadIdx.x];
          my_r = park_r[threadIdx.x];
          res_m = park_m[threadIdx.x];
          res_key = park_k[threadIdx.x];
        }
      }
      if (gl == j) {
        if constexpr (G < kWarp) {
          tile_m[threadIdx.x] = mm;
          tile_k[threadIdx.x] = kmin;
        } else {
          res_m = mm;
          res_key = kmin;
        }
      }
    }
    if constexpr (G < kWarp) {
      // Lane groups: the tile's queries whose minimum came out NaN are
      // walked again, NaN least, after its rounds (one vote a tile).
      if (__any_sync(kFullMask,
                     tile_m[threadIdx.x] != tile_m[threadIdx.x])) {
        __syncwarp();  // every lane's answers, before lanes read others
        for (int j = 0; j < rounds; ++j) {
          const int t = (threadIdx.x & ~(G - 1)) | j;
          const F mj = tile_m[t];
          if (__any_sync(kFullMask, mj != mj)) {
            int32_t lo0, hi0;
            bounds0(w.capacity, tile_l[t], tile_r[t], lo0, hi0);
            F v, mm;
            uint32_t key, kmin;
            walk_plain<G, true>(w, lo0, hi0, gl, stream, keep, v, key);
            group_min<G, true>(v, key, lane, mm, kmin);
            if (gl == j) {
              tile_m[threadIdx.x] = mm;
              tile_k[threadIdx.x] = kmin;
            }
          }
        }
      }
      my_l = tile_l[threadIdx.x];
      my_r = tile_r[threadIdx.x];
      res_m = tile_m[threadIdx.x];
      res_key = tile_k[threadIdx.x];
    }
    if (mine) {
      T val;
      int32_t pos;
      answer<T, V, TRACK>(w, my_l, my_r, res_m, res_key, stream, keep, val,
                          pos);
      if (out_v != nullptr) out_v[qi] = val;
      if (TRACK && out_p != nullptr) out_p[qi] = pos;
    }
  }
}

// The top level in device memory; its values (not its positions) are
// copied to `smem` when g.stage_top.
template <typename T>
__device__ __forceinline__ const T* stage_values(const WalkGeo& g,
                                                 const int32_t* offs,
                                                 const T* base,
                                                 const T* upper,
                                                 unsigned char* smem) {
  const T* src = g.levels == 1 ? base : upper + offs[g.levels - 2];
  if (g.stage_top) {
    T* sv = reinterpret_cast<T*>(smem);
    for (int i = threadIdx.x; i < g.top_len; i += blockDim.x) sv[i] = src[i];
    __syncthreads();
  }
  return src;
}

// Shared memory a block may spend on its copy of the top's values.  The
// largest top at the default geometry (c*t = 8192 entries) takes 32 KB in
// float32 and 64 KB in float64.
constexpr size_t kStageLimit = 112 * 1024;

// 1 if every block copies the top's values into shared memory.
template <typename T>
int32_t stage_fits(const WalkGeo& g) {
  return static_cast<size_t>(g.top_len) * sizeof(T) <= kStageLimit;
}

// Shared memory of a value-only top stage, rounded up to 16 bytes.
template <typename T>
__host__ __device__ __forceinline__ size_t stage_value_bytes(
    const WalkGeo& g) {
  const size_t b =
      g.stage_top ? static_cast<size_t>(g.top_len) * sizeof(T) : 0;
  return (b + 15) & ~static_cast<size_t>(15);
}



// The widest vector (elements) that divides c and the capacity and to
// which both level planes are aligned: run_width<T>() (16 bytes; four bf16)
// where possible.
template <typename T>
int vector_width(const WalkGeo& g, const void* base, const void* upper) {
  int v = run_width<T>();
  const int c = 1 << g.log2c;
  while (v > 1) {
    const uintptr_t bytes = static_cast<uintptr_t>(v) * sizeof(T);
    const bool ok = c % v == 0 && g.capacity % v == 0 &&
                    reinterpret_cast<uintptr_t>(base) % bytes == 0 &&
                    (upper == nullptr ||
                     reinterpret_cast<uintptr_t>(upper) % bytes == 0);
    if (ok) break;
    v >>= 1;
  }
  return v;
}

// Calls f.template run<V, FAST>() for the launch's vector width; FAST is
// the one-chunk-a-warp-instruction layout (c == 32 V: c = 128 in float32
// and bfloat16, c = 64 in float64).  Each run() notes the instance it
// launches (note_instance(2 V + FAST)).
template <typename T, typename F>
cudaError_t dispatch_width(const WalkGeo& g, const void* base,
                           const void* upper, const F& f) {
  constexpr int kMax = run_width<T>();
  const int v = vector_width<T>(g, base, upper);
  const int c = 1 << g.log2c;
  if (v == kMax) {
    if (c == kWarp * kMax) return f.template run<kMax, true>();
    return f.template run<kMax, false>();
  }
  if constexpr (kMax == 4) {
    if (v == 2) return f.template run<2, false>();
  }
  return f.template run<1, false>();
}

}  // namespace hopper
}  // namespace rmq
