// V-wide loads with cache hints, shared by the
// Hopper query walk (rmq_walk_hopper.cuh: B2, B4, B5, B7) and the Hopper
// build core (build_hopper.cuh: B1, B3).
//
// A vector of V stored values, Vec<T, V>, is read through its accessors:
// vget (entry e widened to cmp_t<T>), vraw (entry e's stored bits), vset
// and vfill_inf.  bfloat16 vectors hold their entries as 32-bit words (two
// entries a word, entry 0 in the low half), so a vector of four takes two
// registers and one 8-byte load: PTX has no .bf16 vector load, so bf16 is
// loaded as .b16 / .b32 bits.
#pragma once

#include "rmq_common.cuh"

namespace rmq {
namespace hopper {

// ---------------------------------------------------------------------------
// V-wide loads with L2 cache policies
// ---------------------------------------------------------------------------
// The widest vector a lane loads (the run layout of the builds, the
// one-chunk-a-warp layout of the walk): 16 bytes, but four bf16 (8 bytes),
// so that bf16 takes those layouts at c = 128 as float32 does.
template <typename T>
__host__ __device__ constexpr int run_width() {
  return sizeof(T) == 2 ? 4 : static_cast<int>(16 / sizeof(T));
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T x[V];
};
template <int V>
struct alignas(2 * V) Vec<bf16, V> {
  static_assert(V == 2 || V == 4, "bf16 vectors hold whole words");
  uint32_t w[V / 2];
};
template <>
struct alignas(2) Vec<bf16, 1> {
  unsigned short h;
};

// Entry e, widened.
template <typename T, int V>
__device__ __forceinline__ cmp_t<T> vget(const Vec<T, V>& x, int e) {
  return x.x[e];
}
template <int V>
__device__ __forceinline__ float vget(const Vec<bf16, V>& x, int e) {
  if constexpr (V == 1) {
    return __uint_as_float(static_cast<uint32_t>(x.h) << 16);
  } else {
    const uint32_t word = x.w[e >> 1];
    return __uint_as_float((e & 1) ? word & 0xffff0000u : word << 16);
  }
}

// Entry e's stored bits.
template <typename T, int V>
__device__ __forceinline__ T vraw(const Vec<T, V>& x, int e) {
  return x.x[e];
}
template <int V>
__device__ __forceinline__ bf16 vraw(const Vec<bf16, V>& x, int e) {
  if constexpr (V == 1) {
    return __ushort_as_bfloat16(x.h);
  } else {
    return __ushort_as_bfloat16(
        static_cast<unsigned short>(x.w[e >> 1] >> (16 * (e & 1))));
  }
}

// Entry e set to the stored value b.
template <typename T, int V>
__device__ __forceinline__ void vset(Vec<T, V>& x, int e, T b) {
  x.x[e] = b;
}
template <int V>
__device__ __forceinline__ void vset(Vec<bf16, V>& x, int e, bf16 b) {
  const uint32_t bits = __bfloat16_as_ushort(b);
  if constexpr (V == 1) {
    x.h = static_cast<unsigned short>(bits);
  } else {
    const int sh = 16 * (e & 1);
    x.w[e >> 1] = (x.w[e >> 1] & ~(0xffffu << sh)) | (bits << sh);
  }
}

// Every entry +inf.
template <typename T, int V>
__device__ __forceinline__ void vfill_inf(Vec<T, V>& x) {
#pragma unroll
  for (int e = 0; e < V; ++e) x.x[e] = pos_inf<T>();
}
template <int V>
__device__ __forceinline__ void vfill_inf(Vec<bf16, V>& x) {
  if constexpr (V == 1) {
    x.h = 0x7f80;
  } else {
#pragma unroll
    for (int i = 0; i < V / 2; ++i) x.w[i] = 0x7f807f80u;
  }
}

__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
               : "=l"(p));
  return p;
}

__device__ __forceinline__ uint64_t evict_last_policy() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;"
               : "=l"(p));
  return p;
}

// Past L1, with the L2 policy `pol` (level 0 of B2 / B4: evict_first).
template <typename T, int V>
__device__ __forceinline__ void ld_stream(Vec<T, V>& v, const T* p,
                                          uint64_t pol);
// Through L1, with the L2 policy `pol` (upper levels: evict_last).
template <typename T, int V>
__device__ __forceinline__ void ld_keep(Vec<T, V>& v, const T* p,
                                        uint64_t pol);

#define RMQ_F4 "=f"(v.x[0]), "=f"(v.x[1]), "=f"(v.x[2]), "=f"(v.x[3])
#define RMQ_F2 "=f"(v.x[0]), "=f"(v.x[1])
#define RMQ_F1 "=f"(v.x[0])
#define RMQ_D2 "=d"(v.x[0]), "=d"(v.x[1])
#define RMQ_D1 "=d"(v.x[0])
#define RMQ_IN "l"(p), "l"(pol)

template <>
__device__ __forceinline__ void ld_stream<float, 4>(Vec<float, 4>& v,
                                                    const float* p,
                                                    uint64_t pol) {
  asm volatile(
      "ld.global.L1::no_allocate.L2::cache_hint.v4.f32 {%0,%1,%2,%3}, [%4], "
      "%5;"
      : RMQ_F4 : RMQ_IN);
}
template <>
__device__ __forceinline__ void ld_stream<float, 2>(Vec<float, 2>& v,
                                                    const float* p,
                                                    uint64_t pol) {
  asm volatile(
      "ld.global.L1::no_allocate.L2::cache_hint.v2.f32 {%0,%1}, [%2], %3;"
      : RMQ_F2 : RMQ_IN);
}
template <>
__device__ __forceinline__ void ld_stream<float, 1>(Vec<float, 1>& v,
                                                    const float* p,
                                                    uint64_t pol) {
  asm volatile("ld.global.L1::no_allocate.L2::cache_hint.f32 %0, [%1], %2;"
               : RMQ_F1 : RMQ_IN);
}
template <>
__device__ __forceinline__ void ld_stream<double, 2>(Vec<double, 2>& v,
                                                     const double* p,
                                                     uint64_t pol) {
  asm volatile(
      "ld.global.L1::no_allocate.L2::cache_hint.v2.f64 {%0,%1}, [%2], %3;"
      : RMQ_D2 : RMQ_IN);
}
template <>
__device__ __forceinline__ void ld_stream<double, 1>(Vec<double, 1>& v,
                                                     const double* p,
                                                     uint64_t pol) {
  asm volatile("ld.global.L1::no_allocate.L2::cache_hint.f64 %0, [%1], %2;"
               : RMQ_D1 : RMQ_IN);
}
template <>
__device__ __forceinline__ void ld_keep<float, 4>(Vec<float, 4>& v,
                                                  const float* p,
                                                  uint64_t pol) {
  asm volatile("ld.global.L2::cache_hint.v4.f32 {%0,%1,%2,%3}, [%4], %5;"
               : RMQ_F4 : RMQ_IN);
}
template <>
__device__ __forceinline__ void ld_keep<float, 2>(Vec<float, 2>& v,
                                                  const float* p,
                                                  uint64_t pol) {
  asm volatile("ld.global.L2::cache_hint.v2.f32 {%0,%1}, [%2], %3;"
               : RMQ_F2 : RMQ_IN);
}
template <>
__device__ __forceinline__ void ld_keep<float, 1>(Vec<float, 1>& v,
                                                  const float* p,
                                                  uint64_t pol) {
  asm volatile("ld.global.L2::cache_hint.f32 %0, [%1], %2;"
               : RMQ_F1 : RMQ_IN);
}
template <>
__device__ __forceinline__ void ld_keep<double, 2>(Vec<double, 2>& v,
                                                   const double* p,
                                                   uint64_t pol) {
  asm volatile("ld.global.L2::cache_hint.v2.f64 {%0,%1}, [%2], %3;"
               : RMQ_D2 : RMQ_IN);
}
template <>
__device__ __forceinline__ void ld_keep<double, 1>(Vec<double, 1>& v,
                                                   const double* p,
                                                   uint64_t pol) {
  asm volatile("ld.global.L2::cache_hint.f64 %0, [%1], %2;"
               : RMQ_D1 : RMQ_IN);
}
#define RMQ_W2 "=r"(v.w[0]), "=r"(v.w[1])
#define RMQ_W1 "=r"(v.w[0])
#define RMQ_H1 "=h"(v.h)
template <>
__device__ __forceinline__ void ld_stream<bf16, 4>(Vec<bf16, 4>& v,
                                                   const bf16* p,
                                                   uint64_t pol) {
  asm volatile(
      "ld.global.L1::no_allocate.L2::cache_hint.v2.b32 {%0,%1}, [%2], %3;"
      : RMQ_W2 : RMQ_IN);
}
template <>
__device__ __forceinline__ void ld_stream<bf16, 2>(Vec<bf16, 2>& v,
                                                   const bf16* p,
                                                   uint64_t pol) {
  asm volatile("ld.global.L1::no_allocate.L2::cache_hint.b32 %0, [%1], %2;"
               : RMQ_W1 : RMQ_IN);
}
template <>
__device__ __forceinline__ void ld_stream<bf16, 1>(Vec<bf16, 1>& v,
                                                   const bf16* p,
                                                   uint64_t pol) {
  asm volatile("ld.global.L1::no_allocate.L2::cache_hint.b16 %0, [%1], %2;"
               : RMQ_H1 : RMQ_IN);
}
template <>
__device__ __forceinline__ void ld_keep<bf16, 4>(Vec<bf16, 4>& v,
                                                 const bf16* p,
                                                 uint64_t pol) {
  asm volatile("ld.global.L2::cache_hint.v2.b32 {%0,%1}, [%2], %3;"
               : RMQ_W2 : RMQ_IN);
}
template <>
__device__ __forceinline__ void ld_keep<bf16, 2>(Vec<bf16, 2>& v,
                                                 const bf16* p,
                                                 uint64_t pol) {
  asm volatile("ld.global.L2::cache_hint.b32 %0, [%1], %2;"
               : RMQ_W1 : RMQ_IN);
}
template <>
__device__ __forceinline__ void ld_keep<bf16, 1>(Vec<bf16, 1>& v,
                                                 const bf16* p,
                                                 uint64_t pol) {
  asm volatile("ld.global.L2::cache_hint.b16 %0, [%1], %2;"
               : RMQ_H1 : RMQ_IN);
}

// The staged top: shared memory, by its shared-space address.
template <typename T, int V>
__device__ __forceinline__ void ld_shared(Vec<T, V>& v, uint32_t a);
template <>
__device__ __forceinline__ void ld_shared<float, 4>(Vec<float, 4>& v,
                                                    uint32_t a) {
  asm volatile("ld.shared.v4.f32 {%0,%1,%2,%3}, [%4];" : RMQ_F4 : "r"(a));
}
template <>
__device__ __forceinline__ void ld_shared<float, 2>(Vec<float, 2>& v,
                                                    uint32_t a) {
  asm volatile("ld.shared.v2.f32 {%0,%1}, [%2];" : RMQ_F2 : "r"(a));
}
template <>
__device__ __forceinline__ void ld_shared<float, 1>(Vec<float, 1>& v,
                                                    uint32_t a) {
  asm volatile("ld.shared.f32 %0, [%1];" : RMQ_F1 : "r"(a));
}
template <>
__device__ __forceinline__ void ld_shared<double, 2>(Vec<double, 2>& v,
                                                     uint32_t a) {
  asm volatile("ld.shared.v2.f64 {%0,%1}, [%2];" : RMQ_D2 : "r"(a));
}
template <>
__device__ __forceinline__ void ld_shared<double, 1>(Vec<double, 1>& v,
                                                     uint32_t a) {
  asm volatile("ld.shared.f64 %0, [%1];" : RMQ_D1 : "r"(a));
}
template <>
__device__ __forceinline__ void ld_shared<bf16, 4>(Vec<bf16, 4>& v,
                                                   uint32_t a) {
  asm volatile("ld.shared.v2.b32 {%0,%1}, [%2];" : RMQ_W2 : "r"(a));
}
template <>
__device__ __forceinline__ void ld_shared<bf16, 2>(Vec<bf16, 2>& v,
                                                   uint32_t a) {
  asm volatile("ld.shared.b32 %0, [%1];" : RMQ_W1 : "r"(a));
}
template <>
__device__ __forceinline__ void ld_shared<bf16, 1>(Vec<bf16, 1>& v,
                                                   uint32_t a) {
  asm volatile("ld.shared.b16 %0, [%1];" : RMQ_H1 : "r"(a));
}

#undef RMQ_F4
#undef RMQ_F2
#undef RMQ_F1
#undef RMQ_D2
#undef RMQ_D1
#undef RMQ_W2
#undef RMQ_W1
#undef RMQ_H1
#undef RMQ_IN

// Through L2 only (ld.global.cg), never from a possibly stale L1 line:
// levels that other blocks of the running launch wrote (B1's fold).
template <typename T, int V>
__device__ __forceinline__ void ld_l2(Vec<T, V>& v, const T* p);
template <>
__device__ __forceinline__ void ld_l2<float, 4>(Vec<float, 4>& v,
                                                const float* p) {
  const float4 q = __ldcg(reinterpret_cast<const float4*>(p));
  v.x[0] = q.x;
  v.x[1] = q.y;
  v.x[2] = q.z;
  v.x[3] = q.w;
}
template <>
__device__ __forceinline__ void ld_l2<double, 2>(Vec<double, 2>& v,
                                                 const double* p) {
  const double2 q = __ldcg(reinterpret_cast<const double2*>(p));
  v.x[0] = q.x;
  v.x[1] = q.y;
}
template <>
__device__ __forceinline__ void ld_l2<bf16, 4>(Vec<bf16, 4>& v,
                                               const bf16* p) {
  const uint2 q = __ldcg(reinterpret_cast<const uint2*>(p));
  v.w[0] = q.x;
  v.w[1] = q.y;
}

}  // namespace hopper
}  // namespace rmq
