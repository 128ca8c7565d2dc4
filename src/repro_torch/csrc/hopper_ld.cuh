// V-wide loads with cache hints, shared by the
// Hopper query walk (rmq_walk_hopper.cuh: B2, B4, B5, B7) and the Hopper
// build core (build_hopper.cuh: B1, B3).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace rmq {
namespace hopper {

// ---------------------------------------------------------------------------
// V-wide loads with L2 cache policies
// ---------------------------------------------------------------------------
template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T x[V];
};

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

#undef RMQ_F4
#undef RMQ_F2
#undef RMQ_F1
#undef RMQ_D2
#undef RMQ_D1
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

}  // namespace hopper
}  // namespace rmq
