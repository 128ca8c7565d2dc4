// Device code shared by the port's kernels: the (value, leftmost position)
// merge, warp reductions over it, and the chunk reduce of the two builds
// (hierarchy_build.cu, hierarchy_fused.cu).  Paper §4.1/§5.6: "a group of
// g adjacent threads reduces a chunk of c adjacent entries via warp
// reductions to a single summary".
//
// Ties: every merge is lexicographic on (value, position).  Positions of
// real entries grow strictly along a level and padding holds
// (+inf, PAD_POS), so the lexicographic minimum is the leftmost argmin that
// the plain PyTorch build (torch.argmin, first occurrence) picks.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace rmq {

constexpr int32_t kPadPos = 0x7fffffff;  // PAD_POS in core/constants.py
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kWarp = 32;

template <typename T> __device__ __forceinline__ T pos_inf();
template <> __device__ __forceinline__ float pos_inf<float>() {
  return __int_as_float(0x7f800000);
}
template <> __device__ __forceinline__ double pos_inf<double>() {
  return __longlong_as_double(0x7ff0000000000000LL);
}

// Keep (v2, p2) where it is lexicographically smaller than (v, p).
template <typename T>
__device__ __forceinline__ void merge(T& v, int32_t& p, T v2, int32_t p2) {
  if (v2 < v || (v2 == v && p2 < p)) {
    v = v2;
    p = p2;
  }
}

template <typename T>
__device__ __forceinline__ void take_min(T& v, T v2) {
  if (v2 < v) v = v2;
}

// Butterfly over aligned groups of `width` lanes (a power of two <= 32):
// afterwards every lane holds its group's minimum.  All 32 lanes call it.
template <typename T, bool TRACK>
__device__ __forceinline__ void group_reduce(T& v, int32_t& p, int width) {
  for (int o = width >> 1; o > 0; o >>= 1) {
    const T v2 = __shfl_xor_sync(kFullMask, v, o);
    if (TRACK) {
      const int32_t p2 = __shfl_xor_sync(kFullMask, p, o);
      merge(v, p, v2, p2);
    } else {
      take_min(v, v2);
    }
  }
}

// Sources of a chunk reduce.  Entries at or past `len` read as padding.
// Level 0: the position of an entry is its index.
template <typename T>
struct IndexedSrc {
  const T* v;
  int64_t len;
  __device__ __forceinline__ T val(int64_t i) const { return v[i]; }
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
  __device__ __forceinline__ T val(int64_t i) const { return v[i]; }
  __device__ __forceinline__ int32_t pos(int64_t i) const { return p[i]; }
};

// Upper levels written by other blocks of the running launch: read through
// L2 only, never from a possibly stale L1 line.
template <typename T>
struct CoherentSrc {
  const T* v;
  const int32_t* p;
  int64_t len;
  __device__ __forceinline__ T val(int64_t i) const { return __ldcg(v + i); }
  __device__ __forceinline__ int32_t pos(int64_t i) const {
    return __ldcg(p + i);
  }
};

// Lanes that share one chunk, and chunks one warp reduces at a time.
__device__ __forceinline__ int chunk_lanes(int c) { return c < kWarp ? c : kWarp; }
__device__ __forceinline__ int chunks_per_warp(int c) {
  return c < kWarp ? kWarp / c : 1;
}

// One warp reduces the chunks_per_warp(c) chunks that start at chunk
// `first` (chunk j is entries [j*c, (j+1)*c)).  For c >= 32 each lane
// covers c/32 entries of the one chunk, lane-strided so that every load
// instruction of the warp reads 32 neighbouring entries; for c < 32 the
// warp holds 32/c chunks side by side.  Every lane returns the result of
// its own chunk.
template <typename T, bool TRACK, typename Src>
__device__ __forceinline__ void reduce_chunk_group(const Src& src,
                                                   int64_t first, int c,
                                                   int lane, T& v,
                                                   int32_t& p) {
  const int lanes = chunk_lanes(c);
  const int per_lane = c / lanes;
  const int64_t start = (first + lane / lanes) * c + (lane & (lanes - 1));
  v = pos_inf<T>();
  p = kPadPos;
#pragma unroll 4
  for (int j = 0; j < per_lane; ++j) {
    const int64_t i = start + static_cast<int64_t>(j) * lanes;
    if (i < src.len) {
      const T x = src.val(i);
      if (TRACK) {
        merge(v, p, x, src.pos(i));
      } else {
        take_min(v, x);
      }
    }
  }
  group_reduce<T, TRACK>(v, p, lanes);
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
    T v;
    int32_t p;
    reduce_chunk_group<T, TRACK>(src, g * cpw, c, lane, v, p);
    const int64_t chunk = g * cpw + lane / lanes;
    if ((lane & (lanes - 1)) == 0 && chunk < out_len) {
      out_v[chunk] = v;
      if (TRACK) out_p[chunk] = p;
    }
  }
}

inline int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

}  // namespace rmq

// The text of a CUDA error code, for the Python wrappers' messages.  Each
// source is built into a library of its own, so each defines it once.
extern "C" const char* rmq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
