// Device code shared by the port's kernels: the tie rule of a chunk reduce,
// and the part-by-part chunk reduce of the builds (hierarchy_build.cu,
// hierarchy_fused.cu) and the update (hierarchy_update.cu) for the layouts
// that the Hopper build core (build_hopper.cuh) does not take.  Paper
// §4.1/§5.6: "a group of g adjacent threads reduces a chunk of c adjacent
// entries via warp reductions to a single summary".
//
// NaN is the least value: a chunk that holds a NaN answers its leftmost
// NaN, bits and position, as the plain build's torch.argmin does.
//
// Ties: a chunk's summary is the bits of its leftmost minimal entry, and
// its position is that entry's (the index itself at level 0, the carried
// position above), in value-only builds as in position builds, zeros of
// either sign included.  That is the plain build's rule (torch.argmin, then
// a gather) and the reference's jnp build's.  Each lane scans its entries
// in index order and keeps the first index of its own minimum (a strict <);
// the lanes of a chunk take the value minimum M by shuffles (-0.0 == +0.0
// there: no float is read as an ordered integer), then the smallest index
// among the lanes that hold M, and the winning lane's own value is the
// answer.  Positions then take one gather at the winning index; carried
// positions grow along a level, so this is the lexicographic (value,
// position) minimum.  Entries at or past a level's end read +inf and never
// win: a chunk's first entry lies inside the level and is no larger.
//
// Value types: float32, float64 and bfloat16.  A value is stored in its
// own type and compared in cmp_t<T>: itself for float32 and float64,
// float32 for bfloat16.  A bf16 entry is widened in registers by a 16-bit
// shift (exact: it keeps the order, the sign of a zero and a NaN's
// payload), so one compare code (vmin / vless / vsame / pick_index) serves
// every type, and a bf16 winner is written back as the high 16 bits of its
// widened float (narrow), never rounded by a conversion.  No bf16 operator
// or implicit conversion is compiled in (the two macros below): a bf16
// value is only ever moved as bits, widened or narrowed.
#pragma once

#ifndef __CUDA_NO_BFLOAT16_OPERATORS__
#define __CUDA_NO_BFLOAT16_OPERATORS__
#endif
#ifndef __CUDA_NO_BFLOAT16_CONVERSIONS__
#define __CUDA_NO_BFLOAT16_CONVERSIONS__
#endif

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace rmq {

constexpr int32_t kPadPos = 0x7fffffff;  // PAD_POS in core/constants.py
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kWarp = 32;

using bf16 = __nv_bfloat16;

// The compare type of a stored value type.
template <typename T> struct CmpType { using type = T; };
template <> struct CmpType<bf16> { using type = float; };
template <typename T> using cmp_t = typename CmpType<T>::type;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ double widen(double x) { return x; }
__device__ __forceinline__ float widen(bf16 x) {
  return __uint_as_float(static_cast<uint32_t>(__bfloat16_as_ushort(x))
                         << 16);
}

// A widened value back in its stored type, by its bits.
template <typename T>
__device__ __forceinline__ T narrow(cmp_t<T> x) {
  return x;
}
template <>
__device__ __forceinline__ bf16 narrow<bf16>(float x) {
  return __ushort_as_bfloat16(
      static_cast<unsigned short>(__float_as_uint(x) >> 16));
}

template <typename T> __device__ __forceinline__ T pos_inf();
template <> __device__ __forceinline__ float pos_inf<float>() {
  return __int_as_float(0x7f800000);
}
template <> __device__ __forceinline__ double pos_inf<double>() {
  return __longlong_as_double(0x7ff0000000000000LL);
}
template <> __device__ __forceinline__ bf16 pos_inf<bf16>() {
  return __ushort_as_bfloat16(static_cast<unsigned short>(0x7f80));
}

// A stored value read through L2 only (ld.global.cg).
template <typename T>
__device__ __forceinline__ T ld_cg(const T* p) {
  return __ldcg(p);
}
template <>
__device__ __forceinline__ bf16 ld_cg<bf16>(const bf16* p) {
  return __ushort_as_bfloat16(
      __ldcg(reinterpret_cast<const unsigned short*>(p)));
}

// A stored value from lane `src` (moved as bits).
__device__ __forceinline__ float shfl_raw(float v, int src) {
  return __shfl_sync(kFullMask, v, src);
}
__device__ __forceinline__ double shfl_raw(double v, int src) {
  return __shfl_sync(kFullMask, v, src);
}
__device__ __forceinline__ bf16 shfl_raw(bf16 v, int src) {
  return __ushort_as_bfloat16(static_cast<unsigned short>(__shfl_sync(
      kFullMask, static_cast<unsigned>(__bfloat16_as_ushort(v)), src)));
}

// The instances the launches of a library took since the last read, one
// bit each (the host launchers set them): the builds and the update 1 <<
// kRunsInstance at the run layout, else bit 0; the query walks 1 << (2 V +
// FAST).  rmq_instances() reads and clears them.  Each library (one
// translation unit) keeps its own word: static, since an inline variable
// would be one GNU-unique symbol shared by every library in the process.
constexpr int kRunsInstance = 1;
static unsigned g_instances = 0u;
static inline void note_instance(int code) { g_instances |= 1u << code; }

// The port's order on values: NaN is the least value (two NaNs tie), as
// torch.argmin has it.  vmin returns a NaN (not necessarily the entry's
// bits) when either operand is one: min.NaN is one instruction, as fminf
// is; float64 has no such instruction.  Answers never take vmin's bits:
// they are the winning entry's, found by its index.
__device__ __forceinline__ float vmin(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ double vmin(double a, double b) {
  return a != a ? a : (b != b ? b : fmin(a, b));
}

// a < b in that order.
template <typename T>
__device__ __forceinline__ bool vless(T a, T b) {
  return !(a >= b) && b == b;
}

// a and b tie in that order (-0.0 and +0.0 tie too).
template <typename T>
__device__ __forceinline__ bool vsame(T a, T b) {
  return a == b || (a != a && b != b);
}

// One step of a lane's scan in index order: entry `i` of value x.
template <typename T>
__device__ __forceinline__ void lane_take(T& v, uint32_t& idx, T x,
                                          uint32_t i) {
  if (vless(x, v)) {
    v = x;
    idx = i;
  }
}

// The tie rule across aligned groups of `width` lanes (a power of two
// <= 32; all 32 lanes call it).  Each lane brings its minimum v and the
// index idx of its first occurrence; every lane of a group gets the
// smallest index among the group's lanes that hold the group's value
// minimum.
template <typename T>
__device__ __forceinline__ uint32_t pick_index(T v, uint32_t idx,
                                               int width) {
  T m = v;
  for (int o = width >> 1; o > 0; o >>= 1)
    m = vmin(m, __shfl_xor_sync(kFullMask, m, o));
  uint32_t key = vsame(v, m) ? idx : 0xffffffffu;
  if (width == kWarp) return __reduce_min_sync(kFullMask, key);
  for (int o = width >> 1; o > 0; o >>= 1)
    key = min(key, __shfl_xor_sync(kFullMask, key, o));
  return key;
}

// Sources of a chunk reduce: values, and the position of entry i.
// Level 0: the position of an entry is its index.
template <typename T>
struct IndexedSrc {
  const T* v;
  int64_t len;
  __device__ __forceinline__ cmp_t<T> val(int64_t i) const {
    return widen(v[i]);
  }
  __device__ __forceinline__ int32_t pos(int64_t i) const {
    return static_cast<int32_t>(i);
  }
};

// Upper levels (global or shared memory): carried positions.
template <typename T>
struct CarriedSrc {
  const T* v;
  const int32_t* p;
  int64_t len;
  __device__ __forceinline__ cmp_t<T> val(int64_t i) const {
    return widen(v[i]);
  }
  __device__ __forceinline__ int32_t pos(int64_t i) const { return p[i]; }
};

// Upper levels written by other blocks of the running launch: read through
// L2 only, never from a possibly stale L1 line.
template <typename T>
struct CoherentSrc {
  const T* v;
  const int32_t* p;
  int64_t len;
  __device__ __forceinline__ cmp_t<T> val(int64_t i) const {
    return widen(ld_cg(v + i));
  }
  __device__ __forceinline__ int32_t pos(int64_t i) const {
    return __ldcg(p + i);
  }
};

// The position of a chunk's winner, entry i of the source.
template <typename Src>
__device__ __forceinline__ int32_t winner_pos(const Src& src, int64_t i) {
  return i < src.len ? src.pos(i) : kPadPos;
}

// Lanes that share one chunk, and chunks one warp reduces at a time.
__device__ __forceinline__ int chunk_lanes(int c) { return c < kWarp ? c : kWarp; }
__device__ __forceinline__ int chunks_per_warp(int c) {
  return c < kWarp ? kWarp / c : 1;
}

// One warp reduces up to chunks_per_warp(c) chunks, one for each group of
// chunk_lanes(c) lanes: `chunk` is the calling lane's group's chunk (-1:
// none; entries [chunk*c, (chunk+1)*c)).  For c >= 32 each lane covers c/32
// entries of the one chunk, lane-strided so that every load instruction of
// the warp reads 32 neighbouring entries; for c < 32 the warp holds 32/c
// chunks side by side.  Every lane returns its own group's winning value
// (widened: its stored type is T) and the winner's index in the source.
template <typename T, typename Src>
__device__ __forceinline__ void reduce_chunk_at(const Src& src, int64_t chunk,
                                                int c, int lane,
                                                cmp_t<T>& v, int64_t& at) {
  const int lanes = chunk_lanes(c);
  const int per_lane = c / lanes;
  const int gl = lane & (lanes - 1);
  const int64_t chunk0 = chunk * c;
  v = pos_inf<cmp_t<T>>();
  uint32_t idx = gl;
  if (chunk >= 0) {
#pragma unroll 4
    for (int j = 0; j < per_lane; ++j) {
      const int e = gl + j * lanes;
      if (chunk0 + e < src.len) lane_take(v, idx, src.val(chunk0 + e), e);
    }
  }
  const uint32_t w = pick_index(v, idx, lanes);
  v = __shfl_sync(kFullMask, v, static_cast<int>(w) & (lanes - 1), lanes);
  at = chunk0 + w;
}

// The chunks_per_warp(c) consecutive chunks from chunk `first`.
template <typename T, typename Src>
__device__ __forceinline__ void reduce_chunk_group(const Src& src,
                                                   int64_t first, int c,
                                                   int lane, cmp_t<T>& v,
                                                   int64_t& at) {
  reduce_chunk_at<T>(src, first + lane / chunk_lanes(c), c, lane, v, at);
}

// A whole level, warp-strided: the warps warp, warp + nwarps, ... of the
// caller reduce `src` into out_len chunk minima (and positions).
template <typename T, bool TRACK, typename Src>
__device__ __forceinline__ void reduce_level_warps(const Src& src, int c,
                                                   T* out_v, int32_t* out_p,
                                                   int64_t out_len,
                                                   int64_t warp,
                                                   int64_t nwarps, int lane) {
  const int cpw = chunks_per_warp(c);
  const int lanes = chunk_lanes(c);
  const int64_t groups = (out_len + cpw - 1) / cpw;
  for (int64_t g = warp; g < groups; g += nwarps) {
    cmp_t<T> v;
    int64_t at;
    reduce_chunk_group<T>(src, g * cpw, c, lane, v, at);
    const int64_t chunk = g * cpw + lane / lanes;
    if ((lane & (lanes - 1)) == 0 && chunk < out_len) {
      out_v[chunk] = narrow<T>(v);
      if (TRACK) out_p[chunk] = winner_pos(src, at);
    }
  }
}

inline int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

// A persistent grid: as many blocks of `threads` as fit on the card at
// once, fewer where `want` blocks do the work.
template <typename K>
cudaError_t resident_grid(K kernel, int threads, size_t smem, int64_t want,
                          unsigned* grid) {
  int per_sm = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  const int64_t resident =
      static_cast<int64_t>(sm_count()) * (per_sm > 0 ? per_sm : 1);
  const int64_t g = want < resident ? want : resident;
  *grid = static_cast<unsigned>(g > 0 ? g : 1);
  return cudaSuccess;
}

}  // namespace rmq

// The text of a CUDA error code, for the Python wrappers' messages.  Each
// source is built into a library of its own, so each defines it once.
extern "C" const char* rmq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The instances launched since the last call (rmq::note_instance), cleared.
extern "C" int rmq_instances() {
  const unsigned got = rmq::g_instances;
  rmq::g_instances = 0u;
  return static_cast<int>(got);
}
