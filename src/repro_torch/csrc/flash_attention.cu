// Causal flash attention with GQA and an optional sliding window (B8).
//
// Replaces the Pallas TPU kernel `flash_attention`
// (src/repro/kernels/flash_attention/kernel.py:101, pallas_call :135).
// What it computes is the same:
//   * q (B, Hq, S, D), k / v (B, Hkv, S, D), float32 or bfloat16, one
//     output (B, Hq, S, D) in the input type;
//   * query head h reads KV head h / (Hq / Hkv): KV is never expanded per
//     query head;
//   * causal, and with `window` > 0 a key is visible to a query row only
//     when row - window < key <= row; hidden scores are -1e30, as in the
//     reference;
//   * online softmax with float32 running max, row sum and accumulator;
//     1 / sqrt(D) (or the caller's scale) is applied to q in float32;
//   * key tiles that lie wholly outside the causal or window range of a
//     query tile are skipped, never loaded (kernel.py:44-53); a row sum of
//     0 divides by 1 (kernel.py:91).
// Unlike the reference, which sends S % 128 != 0 to its jnp path, the
// kernel takes any S and masks the ragged tail of the last tiles.
//
// What bounds it on an H100: operations.  At llama3.2-3b's prefill shape
// (B 4, Hq 24, Hkv 8, S 2048, D 128, bf16) the visible (query, key) pairs
// need 4 * D flops each, 103 GFLOP, 0.104 ms at 989 TFLOP/s of bf16 tensor
// cores, while the bytes (q, k, v read once, o written once, 134 MB) take
// 0.040 ms at 3.35 TB/s.
//
// Design (first, simple and exact version; tensor cores, wgmma and TMA are
// later work): one block of 128 threads per (query tile of 64 rows, query
// head, batch row), query tiles scheduled longest-first.  The block stages
// its scaled q tile once, transposed, as float32 in shared memory; for each
// visited tile of 32 keys it stages k (transposed) and v, computes the
// 64 x 32 scores with float32 FMAs on CUDA cores (each thread a 4 x 4
// register tile), updates the running max / sum row by row (two threads a
// row), and accumulates p @ v into a 4 x D/8 register tile per thread.
// bfloat16 is widened to float32 on load, so both types share one code
// path and the float32 peak of the CUDA cores (67 TFLOP/s) is its ceiling.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace fa {

constexpr int kBQ = 64;       // query rows per block
constexpr int kBK = 32;       // keys per tile
constexpr int kThreads = 128;
constexpr int kQPad = kBQ + 4;  // row stride of the transposed q / p tiles
constexpr int kKPad = kBK + 4;  // row stride of the transposed k tile
constexpr float kNegInf = -1e30f;  // the reference's mask value

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(
    __nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

template <int D>
constexpr int smem_floats() {
  return D * kQPad            // qt: scaled q, transposed [D][kQPad]
         + D * kKPad          // kt: k tile, transposed [D][kKPad]
         + kBK * (D + 4)      // vs: v tile [kBK][D + 4]
         + kBK * kQPad        // pt: scores / probabilities, transposed
         + 3 * kBQ;           // running max, row sum, rescale factor
}

// Grid (ceil(S / 64), Hq, B); block 128 threads.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int hq, int hkv,
                 int s, float scale, int window) {
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;
  float* kt = qt + D * kQPad;
  float* vs = kt + D * kKPad;
  float* pt = vs + kBK * (D + 4);
  float* row_m = pt + kBK * kQPad;
  float* row_l = row_m + kBQ;
  float* row_a = row_l + kBQ;

  constexpr int kW = D >= 32 ? 4 : 2;   // output columns per vector read
  constexpr int kCols = D / 8;          // output columns per thread
  constexpr int kCB = kCols / kW;       // vector reads per thread and key

  const int n_q = gridDim.x;
  const int qi = n_q - 1 - static_cast<int>(blockIdx.x);  // longest first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (hq / hkv);
  const int tid = threadIdx.x;
  const int rg = tid >> 3;  // rows rg*4 .. rg*4+3 of the tile
  const int cg = tid & 7;   // score columns cg*4 .. cg*4+3

  const long long q_off = ((long long)(b * hq + h) * s) * D;
  const long long kv_off = ((long long)(b * hkv + kvh) * s) * D;
  const int row0 = qi * kBQ;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, d = e % D;
    const int row = row0 + r;
    qt[d * kQPad + r] =
        row < s ? to_f32(q[q_off + (long long)row * D + d]) * scale : 0.f;
  }
  if (tid < kBQ) {
    row_m[tid] = kNegInf;
    row_l[tid] = 0.f;
  }

  float acc[4][kCols];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[a][c] = 0.f;

  const int last_row = min(s, row0 + kBQ) - 1;
  const int j_hi = last_row / kBK;
  int j_lo = 0;
  if (window > 0) {
    const int lo_key = row0 - window + 1;
    j_lo = lo_key > 0 ? lo_key / kBK : 0;
  }

  for (int j = j_lo; j <= j_hi; ++j) {
    const int key0 = j * kBK;
    __syncthreads();  // the previous tile's kt / vs / pt are consumed
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int r = e / D, d = e % D;
      const int key = key0 + r;
      const bool in = key < s;
      const long long g = kv_off + (long long)key * D + d;
      kt[d * kKPad + r] = in ? to_f32(k[g]) : 0.f;
      vs[r * (D + 4) + d] = in ? to_f32(v[g]) : 0.f;
    }
    __syncthreads();

    // scores: rows rg*4+a, keys cg*4+c
    float sc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) sc[a][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(
          &qt[d * kQPad + rg * 4]);
      const float4 kb = *reinterpret_cast<const float4*>(
          &kt[d * kKPad + cg * 4]);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[4] = {kb.x, kb.y, kb.z, kb.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) sc[a][c] = fmaf(qv[a], kv[c], sc[a][c]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int row = row0 + rg * 4 + a;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = key0 + cg * 4 + c;
        bool vis = key <= row && key < s;
        if (window > 0) vis = vis && key > row - window;
        pt[(cg * 4 + c) * kQPad + rg * 4 + a] = vis ? sc[a][c] : kNegInf;
      }
    }
    __syncthreads();

    // online softmax, two threads per row, 16 keys each
    {
      const int r = tid >> 1;
      const int half = tid & 1;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < kBK / 2; ++c)
        mx = fmaxf(mx, pt[(half * (kBK / 2) + c) * kQPad + r]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_prev = row_m[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < kBK / 2; ++c) {
        float* p = &pt[(half * (kBK / 2) + c) * kQPad + r];
        const float e = expf(*p - m_new);
        *p = e;
        sum += e;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      const float alpha = expf(m_prev - m_new);
      __syncwarp();
      if (half == 0) {
        row_m[r] = m_new;
        row_l[r] = row_l[r] * alpha + sum;
        row_a[r] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p @ v; output columns cg*kW + 8*kW*i + w
    {
      const float4 al = *reinterpret_cast<const float4*>(&row_a[rg * 4]);
      const float alpha[4] = {al.x, al.y, al.z, al.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[a][c] *= alpha[a];
#pragma unroll 4
      for (int kk = 0; kk < kBK; ++kk) {
        const float4 pa = *reinterpret_cast<const float4*>(
            &pt[kk * kQPad + rg * 4]);
        const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
        float vv[kCols];
#pragma unroll
        for (int i = 0; i < kCB; ++i) {
          const float* src = &vs[kk * (D + 4) + cg * kW + 8 * kW * i];
          if constexpr (kW == 4) {
            const float4 t = *reinterpret_cast<const float4*>(src);
            vv[i * 4 + 0] = t.x;
            vv[i * 4 + 1] = t.y;
            vv[i * 4 + 2] = t.z;
            vv[i * 4 + 3] = t.w;
          } else {
            const float2 t = *reinterpret_cast<const float2*>(src);
            vv[i * 2 + 0] = t.x;
            vv[i * 2 + 1] = t.y;
          }
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < kCols; ++c)
            acc[a][c] = fmaf(pv[a], vv[c], acc[a][c]);
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = rg * 4 + a;
    const int row = row0 + r;
    if (row >= s) continue;
    const float l = row_l[r];
    const float inv = 1.f / (l == 0.f ? 1.f : l);
    T* dst = o + q_off + (long long)row * D;
#pragma unroll
    for (int i = 0; i < kCB; ++i)
#pragma unroll
      for (int w = 0; w < kW; ++w)
        dst[cg * kW + 8 * kW * i + w] = from_f32<T>(acc[a][i * kW + w] * inv);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int batch,
           int hq, int hkv, int s, float scale, int window,
           cudaStream_t stream) {
  const size_t bytes = sizeof(float) * smem_floats<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s + kBQ - 1) / kBQ, hq, batch);
  flash_fwd_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), hq, hkv, s, scale,
      window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_dim(int d, const void* q, const void* k, const void* v, void* o,
                 int batch, int hq, int hkv, int s, float scale, int window,
                 cudaStream_t stream) {
  switch (d) {
    case 16:
      return launch<T, 16>(q, k, v, o, batch, hq, hkv, s, scale, window,
                           stream);
    case 32:
      return launch<T, 32>(q, k, v, o, batch, hq, hkv, s, scale, window,
                           stream);
    case 64:
      return launch<T, 64>(q, k, v, o, batch, hq, hkv, s, scale, window,
                           stream);
    case 128:
      return launch<T, 128>(q, k, v, o, batch, hq, hkv, s, scale, window,
                            stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace fa

// dtype: 0 float32, 1 bfloat16.  window <= 0: no sliding window.
extern "C" int flash_attention_fwd(int dtype, int batch, int hq, int hkv,
                                   int s, int d, float scale, int window,
                                   const void* q, const void* k,
                                   const void* v, void* o, void* stream) {
  if (batch <= 0 || s <= 0 || hkv <= 0 || hq % hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return fa::dispatch_dim<float>(d, q, k, v, o, batch, hq, hkv, s, scale,
                                   window, st);
  if (dtype == 1)
    return fa::dispatch_dim<__nv_bfloat16>(d, q, k, v, o, batch, hq, hkv, s,
                                           scale, window, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The text of a CUDA error code, for the Python wrapper's messages.
extern "C" const char* rmq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
