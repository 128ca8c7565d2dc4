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
//   * key tiles that lie wholly outside the causal or window range of a
//     query tile are skipped, never loaded (kernel.py:44-53); a row sum of
//     0 divides by 1 (kernel.py:91).
// Unlike the reference, which sends S % 128 != 0 to its jnp path, the
// kernels take any S and mask the ragged tail of the last tiles.
//
// What bounds it on an H100: operations.  At llama3.2-3b's prefill shape
// (B 4, Hq 24, Hkv 8, S 2048, D 128, bf16) the visible (query, key) pairs
// need 4 * D flops each, 103 GFLOP, 0.104 ms at 989 TFLOP/s of bf16 tensor
// cores, while the bytes (q, k, v read once, o written once, 134 MB) take
// 0.040 ms at 3.35 TB/s.
//
// Two kernels, chosen by dtype; both are held to the plain version on the
// card.
//
// bfloat16 (`tc::flash_bf16_kernel`, the tensor cores through wgmma): one
// block of one warpgroup (4 warps, 16 rows each) per (query tile of 64
// rows, query head, batch row), query tiles scheduled longest-first over
// the whole grid, two blocks an SM.
//   * q is copied once (cp.async, 16 bytes a thread) and `ldmatrix`ed into
//     A fragments that stay in registers for the whole key loop; the bf16
//     operands enter the products unscaled;
//   * key tiles of 64 keys walk from the diagonal down.  k and v are
//     copied one tile ahead by cp.async into rings of 2 (k) and 3 (v)
//     tiles, one __syncthreads a tile; tiles are stored in the canonical
//     128 / 64 / 32-byte swizzled layout that wgmma reads by descriptor
//     (and ldmatrix without bank conflicts); 97 KB at D 128;
//   * S = q k^T by wgmma.m64n64k16 (bf16, float32 sums, A from registers,
//     k the K-major B operand as it lies); o += P v by wgmma.m64nDk16 with
//     v the N-major (transposed) B operand;
//   * software-pipelined: S_t and P_{t-1} v_{t-1} are issued together, and
//     tile t's softmax runs while the tensor cores do P_{t-1} v_{t-1};
//   * the scale, folded with log2(e), is applied to the float32 scores,
//     hidden scores become -1e30 (never -inf: a row whose first tile is all
//     hidden takes exp2(0) there, and the next tile's alpha =
//     exp2(-1e30 - m) wipes it, where -inf would give NaN); the running
//     max and sum live in registers, the max reduced over the row's four
//     threads by __shfl_xor_sync, the sum only once at the end;
//   * P is rounded to bf16 in registers (the accumulator layout of two n8
//     blocks is the A layout of one k16 step); o is a float32 register tile
//     rescaled by alpha each tile, rounded to bf16 once and written through
//     shared memory in 16-byte stores;
//   * masks are applied only on the tiles a warp's rows cross at the
//     diagonal or the window's lower edge (keys past S are above the
//     diagonal); the block's tiles are exactly those some row sees.
// ptxas serializes wgmma (C7514 / C7518) around branches it cannot prove
// uniform or waits whose group count depends on the path, so the loop has
// no branch around its wgmma and the warp index goes through a shuffle.
//
// float32 (`flash_fwd_kernel`, the CUDA cores; its card tolerance, 2e-5,
// is beyond TF32 or bf16 operands): one block of 128 threads per (query
// tile of 64 rows, query head, batch row), query tiles scheduled
// longest-first.  The block stages its scaled q tile once, transposed, in
// shared memory; for each visited tile of 32 keys it stages k (transposed)
// and v, computes the 64 x 32 scores with float32 FMAs (each thread a
// 4 x 4 register tile), updates the running max / sum row by row (two
// threads a row), and accumulates p @ v into a 4 x D/8 register tile per
// thread.  1 / sqrt(D) (or the caller's scale) is applied to q in float32.
// The float32 peak of the CUDA cores (67 TFLOP/s) is its ceiling.

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
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
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

// ---------------------------------------------------------------------------
// bfloat16 on the tensor cores
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kThreads = 128;  // one warpgroup
constexpr int kRows = 64;       // query rows per block, 16 a warp
constexpr int kKeys = 64;       // keys per tile
constexpr int kKStages = 2;     // k tiles in shared memory: t, t + 1
constexpr int kVStages = 3;     // v tiles: t - 1, t, t + 1
constexpr float kLog2e = 1.4426950408889634f;

// Tiles are [rows][D] bf16 in panels of kPanel columns: panel p holds
// columns [p * kPanel, (p + 1) * kPanel), its rows kW bytes each, and its
// 16-byte chunks XOR-swizzled by the bits of the row that the hardware's
// 128 / 64 / 32-byte swizzle uses (kW = 128 / 64 / 32).  That is the
// canonical layout wgmma reads through a descriptor, and it keeps one
// ldmatrix matrix (8 consecutive rows, one chunk) on 8 distinct bank
// groups.  Every tile starts on a 1024-byte boundary.
template <int D>
struct Layout {
  static constexpr int kPanel = D < 64 ? D : 64;  // columns a panel
  static constexpr int kW = kPanel * 2;           // bytes a panel row
  static constexpr int kCpp = kW / 16;            // chunks a panel row
  static constexpr int kSwizzle = kW == 128 ? 1 : kW == 64 ? 2 : 3;
  // byte offset of chunk c (of D / 8) of row r in a tile of `rows` rows
  static __device__ __forceinline__ int at(int rows, int r, int c) {
    return (c / kCpp) * rows * kW + r * kW +
           (((c % kCpp) ^ ((r / (8 / kCpp)) & (kCpp - 1))) * 16);
  }
};

// Dynamic shared memory: the q tile (later the o staging), the k ring and
// the v ring, plus slack to start on a 1024-byte boundary.
template <int D>
constexpr int smem_bytes() {
  return (kRows + (kKStages + kVStages) * kKeys) * D * 2 + 1024;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; zero-filled when !in.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until all of this thread's copy groups have landed.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// A wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets, swizzle mode (1: 128 B, 2: 64 B, 3: 32 B).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, int swizzle) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) |
         (static_cast<uint64_t>(swizzle) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N of this warpgroup's wgmma groups are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Ties registers to the surrounding wgmma fences / waits, so the compiler
// neither reads an accumulator before the wait nor writes an operand after
// the issue.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+f"(d[n][i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(d[n][i])::"memory");
}

// d (64 x N, float32) = a (64 x 16 bf16, registers, one m16 slice a warp)
// * B (16 x N bf16, shared memory by descriptor) + (scale_d ? d : 0);
// kTrans 1 reads B from an N-major tile.
template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  template <int kTrans>
  static __device__ __forceinline__ void run(float (&d)[2][4],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d),
          "n"(kTrans));
  }
};

template <>
struct Wgmma<32> {
  template <int kTrans>
  static __device__ __forceinline__ void run(float (&d)[4][4],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d),
          "n"(kTrans));
  }
};

template <>
struct Wgmma<64> {
  template <int kTrans>
  static __device__ __forceinline__ void run(float (&d)[8][4],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d),
          "n"(kTrans));
  }
};

template <>
struct Wgmma<128> {
  template <int kTrans>
  static __device__ __forceinline__ void run(float (&d)[16][4],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
          "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
          "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
          "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
          "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
          "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
          "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
          "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
          "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d),
          "n"(kTrans));
  }
};

// Two floats rounded to bf16 (nearest even), `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Rows [row0, row0 + ROWS) of a (S, D) matrix into a tile; rows at or
// past s are zero-filled.  A thread copies one chunk column c of rows r0,
// r0 + kStep, ...; kStep is a multiple of 8, so the swizzle is the same
// for all of them and the offsets advance by a constant.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* src, int row0,
                                          int s, int tid) {
  constexpr int kChunks = D / 8;
  constexpr int kStep = kThreads / kChunks;
  static_assert(kStep % 8 == 0 && ROWS % kStep == 0, "tile shape");
  const int c = tid % kChunks, r0 = tid / kChunks;
  const uint32_t off = dst + Layout<D>::at(ROWS, r0, c);
  const __nv_bfloat16* g = src + static_cast<long long>(row0 + r0) * D + c * 8;
#pragma unroll
  for (int i = 0; i < ROWS / kStep; ++i) {
    const bool in = row0 + r0 + i * kStep < s;
    cp_async16(off + i * kStep * Layout<D>::kW,
               in ? g + static_cast<long long>(i) * kStep * D : src, in);
  }
}

// Grid (B * Hq, ceil(S / 64)); block 128 threads, one warpgroup.
// scale_log2 is the softmax scale times log2(e).
template <int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  __nv_bfloat16* __restrict__ o, int hq, int hkv, int s,
                  float scale_log2, int window) {
  using L = Layout<D>;
  constexpr int kKSteps = D / 16;      // k16 steps of q k^T over d
  constexpr int kOBlocks = D / 8;      // n8 blocks of o
  constexpr int kSBlocks = kKeys / 8;  // n8 blocks of a score tile
  constexpr int kTile = kKeys * D * 2;  // bytes of one k or v tile
  // S is issued in n-slices of kSN keys.  Where S and P v would share one
  // wgmma shape (kKeys == D), ptxas gave P's A fragments the registers of
  // q's (wrong results from the second tile on, measured at D 64), so
  // there S takes two halves.
  constexpr int kSN = kKeys == D ? kKeys / 2 : kKeys;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t s_q = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (s_q - raw);
  const uint32_t s_k = s_q + kRows * D * 2;
  const uint32_t s_v = s_k + kKStages * kTile;

  const int qi = static_cast<int>(gridDim.y - 1 - blockIdx.y);
  const int h = static_cast<int>(blockIdx.x) % hq;
  const int b = static_cast<int>(blockIdx.x) / hq;
  const int kvh = h / (hq / hkv);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  // the warp index through a shuffle, so ptxas knows it is warp-uniform
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int g = lane >> 2, tg = lane & 3;  // fragment row / column pair
  const int mi = lane >> 3;  // the ldmatrix matrix this lane addresses

  const long long q_off = static_cast<long long>(b * hq + h) * s * D;
  const long long kv_off = static_cast<long long>(b * hkv + kvh) * s * D;
  const int row0 = qi * kRows;
  const int j_hi = (min(s, row0 + kRows) - 1) / kKeys;
  const int j_lo = window > 0 ? max(row0 - window + 1, 0) / kKeys : 0;
  const int n_tiles = j_hi - j_lo + 1;  // each visible to some row
  const int wr0 = row0 + warp * 16;     // the warp's first row
  const int ra = wr0 + g, rb = ra + 8;  // this thread's two rows

  // tile t has keys from (j_hi - t) * kKeys: k into stage t % kKStages,
  // v into t % kVStages; one copy group a tile, q with tile 0
  auto load_kv = [&](int t) {
    if (t < n_tiles) {
      const int key0 = (j_hi - t) * kKeys;
      load_tile<D, kKeys>(s_k + (t % kKStages) * kTile, k + kv_off, key0, s,
                          tid);
      load_tile<D, kKeys>(s_v + (t % kVStages) * kTile, v + kv_off, key0, s,
                          tid);
    }
    cp_async_commit();
  };
  // wait for tile t; make every thread's copies visible to wgmma (the
  // async proxy); then no warp still reads the stages that tile t + 1 takes
  auto land = [&]() {
    cp_async_wait_all();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
  };
  load_tile<D, kRows>(s_q, q + q_off, row0, s, tid);
  load_kv(0);
  land();
  load_kv(1);

  // q's A fragments, loaded once
  uint32_t qf[kKSteps][4];
  {
    const int r = warp * 16 + (lane & 7) + (mi & 1) * 8;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk)
      ldsm_x4(qf[kk], s_q + L::at(kRows, r, kk * 2 + (mi >> 1)));
  }
  float acc[kOBlocks][4];
#pragma unroll
  for (int n = 0; n < kOBlocks; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's part of each row sum
  float sc[kSBlocks][4];
  uint32_t pp[kKeys / 16][4];  // the last tile's P, bf16 A fragments

  // S_t = q k_t^T (k is the K-major B operand), one commit group
  auto issue_s = [&](int t) {
    const uint32_t sk = s_k + (t % kKStages) * kTile;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      const int c = kk * 2;  // first chunk of the k16 step
      const uint32_t addr =
          sk + (c / L::kCpp) * kKeys * L::kW + (c % L::kCpp) * 16;
#pragma unroll
      for (int part = 0; part < kKeys / kSN; ++part)
        Wgmma<kSN>::template run<0>(
            *reinterpret_cast<float(*)[kSN / 8][4]>(&sc[part * kSN / 8]),
            qf[kk],
            make_desc(addr + part * kSN * L::kW, 16, 8 * L::kW,
                      L::kSwizzle),
            kk > 0);
    }
    wgmma_commit();
  };
  // o += P_t v_t (v is the N-major B operand), one commit group
  auto issue_pv = [&](int t) {
    const uint32_t sv = s_v + (t % kVStages) * kTile;
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk)
      Wgmma<D>::template run<1>(
          acc, pp[kk],
          make_desc(sv + kk * 16 * L::kW, kKeys * L::kW, 8 * L::kW,
                    L::kSwizzle),
          1);
    wgmma_commit();
  };
  // tile t's online softmax on S_t in registers; returns alpha per row
  auto softmax = [&](int t, float (&alpha)[2]) {
    const int key0 = (j_hi - t) * kKeys;
    const bool masked =
        key0 + kKeys - 1 > wr0 || (window > 0 && key0 <= wr0 + 15 - window);
    // scale (log2 units) and mask; elements 0, 1 are row ra, 2, 3 row rb
#pragma unroll
    for (int n = 0; n < kSBlocks; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[n][i] *= scale_log2;
    if (masked) {
#pragma unroll
      for (int n = 0; n < kSBlocks; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = i < 2 ? ra : rb;
          const int key = key0 + n * 8 + tg * 2 + (i & 1);
          if (key > row || (window > 0 && key <= row - window))
            sc[n][i] = kNegInf;
        }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < kSBlocks; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(sc[n][0], sc[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(sc[n][2], sc[n][3]));
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      mx[x] = fmaxf(mx[x], __shfl_xor_sync(0xffffffffu, mx[x], 1));
      mx[x] = fmaxf(mx[x], __shfl_xor_sync(0xffffffffu, mx[x], 2));
      alpha[x] = ex2(m[x] - mx[x]);
      m[x] = mx[x];
    }
#pragma unroll
    for (int n = 0; n < kSBlocks; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        sc[n][i] = ex2(sc[n][i] - m[i >> 1]);
        rs[i >> 1] += sc[n][i];
      }
#pragma unroll
    for (int x = 0; x < 2; ++x) l[x] = l[x] * alpha[x] + rs[x];
  };
  // o, which now holds every earlier tile's P v, to tile t's max; P_t
  // rounded to bf16 as the next A operand (the accumulator layout of two
  // n8 blocks is the A layout of one k16 step)
  auto rescale_and_pack = [&](const float (&alpha)[2]) {
#pragma unroll
    for (int n = 0; n < kOBlocks; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      pp[kk][0] = pack_bf16(sc[2 * kk][0], sc[2 * kk][1]);
      pp[kk][1] = pack_bf16(sc[2 * kk][2], sc[2 * kk][3]);
      pp[kk][2] = pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
      pp[kk][3] = pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
    }
  };

  // tile 0
  float alpha[2];
#pragma unroll
  for (int n = 0; n < kSBlocks; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) sc[n][i] = 0.f;
  fence_regs(sc);
  wgmma_fence();
  issue_s(0);
  wgmma_wait<0>();
  fence_regs(sc);
  softmax(0, alpha);
  rescale_and_pack(alpha);
  // tile t: S_t and P_{t-1} v_{t-1} go to the tensor cores together, and
  // tile t's softmax runs while P_{t-1} v_{t-1} does
  for (int t = 1; t < n_tiles; ++t) {
    land();
    load_kv(t + 1);
    fence_regs(sc);
    fence_regs(acc);
    fence_regs(pp);
    wgmma_fence();
    issue_s(t);
    issue_pv(t - 1);
    wgmma_wait<1>();  // S_t is done
    fence_regs(sc);
    softmax(t, alpha);
    wgmma_wait<0>();  // P_{t-1} v_{t-1} is done
    fence_regs(acc);
    fence_regs(pp);
    rescale_and_pack(alpha);
  }
  fence_regs(acc);
  fence_regs(pp);
  wgmma_fence();
  issue_pv(n_tiles - 1);
  wgmma_wait<0>();
  fence_regs(acc);

  // o = acc / row sum, rounded to bf16 once, staged in the warp's own 16
  // rows of the q tile, then written in 16-byte stores
  float inv[2];
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    l[x] += __shfl_xor_sync(0xffffffffu, l[x], 1);
    l[x] += __shfl_xor_sync(0xffffffffu, l[x], 2);
    inv[x] = 1.f / (l[x] == 0.f ? 1.f : l[x]);
  }
  const int la = warp * 16 + g;
#pragma unroll
  for (int n = 0; n < kOBlocks; ++n) {
    *reinterpret_cast<uint32_t*>(smem + L::at(kRows, la, n) + tg * 4) =
        pack_bf16(acc[n][0] * inv[0], acc[n][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(smem + L::at(kRows, la + 8, n) + tg * 4) =
        pack_bf16(acc[n][2] * inv[1], acc[n][3] * inv[1]);
  }
  __syncwarp();
  constexpr int kChunks = D / 8;
#pragma unroll
  for (int e = lane; e < 16 * kChunks; e += 32) {
    const int r = e / kChunks, c = e % kChunks;
    if (wr0 + r < s)
      *reinterpret_cast<uint4*>(o + q_off +
                                static_cast<long long>(wr0 + r) * D + c * 8) =
          *reinterpret_cast<const uint4*>(smem +
                                          L::at(kRows, warp * 16 + r, c));
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int batch,
           int hq, int hkv, int s, float scale, int window,
           cudaStream_t stream) {
  constexpr int bytes = smem_bytes<D>();
  const int n_q = (s + kRows - 1) / kRows;
  if (static_cast<long long>(batch) * hq > 0x7fffffff || n_q > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(batch * hq, n_q);
  flash_bf16_kernel<D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      hq, hkv, s, scale * kLog2e, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

// dtype 0: the float32 kernel; 1: the bf16 tensor-core kernel.
template <int D>
int launch_dtype(int dtype, const void* q, const void* k, const void* v,
                 void* o, int batch, int hq, int hkv, int s, float scale,
                 int window, cudaStream_t stream) {
  if (dtype == 0)
    return launch<float, D>(q, k, v, o, batch, hq, hkv, s, scale, window,
                            stream);
  if (dtype == 1)
    return tc::launch<D>(q, k, v, o, batch, hq, hkv, s, scale, window,
                         stream);
  return static_cast<int>(cudaErrorInvalidValue);
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
  switch (d) {
    case 16:
      return fa::launch_dtype<16>(dtype, q, k, v, o, batch, hq, hkv, s, scale,
                                  window, st);
    case 32:
      return fa::launch_dtype<32>(dtype, q, k, v, o, batch, hq, hkv, s, scale,
                                  window, st);
    case 64:
      return fa::launch_dtype<64>(dtype, q, k, v, o, batch, hq, hkv, s, scale,
                                  window, st);
    case 128:
      return fa::launch_dtype<128>(dtype, q, k, v, o, batch, hq, hkv, s,
                                   scale, window, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The text of a CUDA error code, for the Python wrapper's messages.
extern "C" const char* rmq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
