// Mamba-2 SSD chunk scan (B9).
//
// Replaces the Pallas TPU kernel `ssd_scan`
// (src/repro/kernels/ssd_scan/kernel.py:76, pallas_call :91).  What it
// computes is the same, in float32 throughout:
//   * dtx (B, L, H, P), log_a (B, L, H), Bm / Cm (B, L, N) (ngroups = 1:
//     B and C are shared by every head), y (B, L, H, P);
//   * the recurrence S_t = exp(log_a_t) S_{t-1} + dtx_t (x) B_t,
//     y_t = S_t C_t, taken chunk by chunk (chunk Q, L % Q == 0):
//       cum   = in-chunk cumulative sum of log_a, total = cum[Q - 1];
//       y     = M dtx + exp(cum) * (C S^T), with
//       M_ij  = (C_i . B_j) exp(cum_i - cum_j) for j <= i and exactly 0
//               for j > i (the exponent is computed only where j <= i, so
//               no exp overflow meets a mask: kernel.py:49-51 takes
//               exp(where(tril, diff, -inf)) instead);
//       S    <- exp(total) S + (w * dtx)^T B, w_j = exp(total - cum_j).
// Unlike the reference, which always starts from S = 0 and drops the final
// state, the kernel takes an optional initial state (B, H, P, N) and writes
// the final state when asked (the reference sends both to its jnp path).
//
// What bounds it on an H100: operations.  At mamba2-1.3b's training shape
// (B 8, L 2048, H 64, P 64, N 128, Q 128) the least work is about 21.6 G
// multiply-adds (C B^T once per (b, chunk) over its causal pairs j <= i,
// the causal in-chunk product, the carried-state term and the state
// update), 0.646 ms at the 67 TFLOP/s float32 rate of the CUDA cores; the bytes (dtx in, y out, B, C, log_a)
// are 0.56 GB, 0.17 ms at 3.35 TB/s.
//
// Design (float32 FMAs on the CUDA cores; no TF32, no bf16 operands), two
// launches per call:
//   1. gram: G = C B^T for every (b, chunk), the column groups of 32 that
//      the causal lower triangle reaches, into a (B, L/Q, Q, Q) scratch
//      buffer (8 MB at the training shape, read back from L2).  The TPU
//      kernel recomputes C B^T per head (kernel.py:43-46); B and C are
//      shared by all heads, so it is computed once here.
//   2. scan: one block of 512 threads per (head, batch row) walks the
//      chunks in order, as the TPU grid does, with the state S held
//      transposed in shared memory.  A chunk's B and dtx tiles are staged
//      once; the rows of M are taken in slices of 64 (a whole Q x Q tile
//      of M beside B, C, dtx and S would exceed the 227 KB a block may
//      use), each slice's M read from G and masked with the decay.  Every
//      product is an FMA loop over a 4 x (P / 32) register tile per
//      thread, the tile sized at compile time; rows of M, C and B are read
//      four at a time as float4 broadcasts, so a multiply-add costs under
//      half a shared-memory load.  A warp's rows visit only the columns
//      their causal mask reaches.  Shared memory: 193 KB at the training
//      shape, one block (16 warps) per SM.
// Limits: Q <= 128, P <= 128, and the staged tiles within 227 KB.

#include <cuda_runtime.h>

namespace ssd {

constexpr int kThreads = 512;    // scan block: 16 warps
constexpr int kRows = 64;        // rows of M per slice: 4 per warp
constexpr int kGramThreads = 256;
constexpr int kGramRows = 32;    // rows of G per gram block: 4 per warp
constexpr int kMaxQ = 128;
constexpr int kMaxP = 128;
constexpr size_t kMaxSmem = 232448;  // 227 KB, the most one block may use

__host__ __device__ inline int pad4(int x) { return (x + 3) & ~3; }

__host__ __device__ inline size_t scan_smem_floats(int q, int p, int n) {
  const size_t qs = pad4(q), ns = pad4(n);
  return qs * ns                 // bs: B tile [Q][N], zero padded
         + qs * p                // xs: dtx tile [Q][P]
         + ns * p                // st: state, transposed [N][P]
         + kRows * ns            // cs: a slice of C [64][N]
         + kRows * qs            // ms: a slice of M [64][Q]
         + 2 * qs;               // cum, w
}

__host__ __device__ inline size_t gram_smem_floats(int q, int n) {
  return static_cast<size_t>(kGramRows) * n        // C rows of the tile
         + static_cast<size_t>(q) * (n + 1);       // B rows, padded
}

// Grid (ceil(Q / 32), L / Q, B); block 256 threads.  G[b][c][i][j] for
// i in the block's 32 rows and the column groups of 32 that j <= i reaches.
__global__ void __launch_bounds__(kGramThreads)
gram_kernel(const float* __restrict__ bm, const float* __restrict__ cm,
            float* __restrict__ gram, int L, int N, int Q) {
  extern __shared__ float smem[];
  const int np = N + 1;
  float* cs = smem;
  float* bs = cs + kGramRows * N;
  const int r0 = blockIdx.x * kGramRows, c = blockIdx.y, b = blockIdx.z;
  const int rows = min(kGramRows, Q - r0);
  const int cols = min(r0 + rows, Q);    // j < cols covers every j <= i
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long t0 = static_cast<long long>(b) * L
                       + static_cast<long long>(c) * Q;
  for (int idx = tid; idx < rows * N; idx += kGramThreads)
    cs[idx] = cm[(t0 + r0) * N + idx];
  for (int idx = tid; idx < cols * N; idx += kGramThreads) {
    const int j = idx / N, n = idx - j * N;
    bs[j * np + n] = bm[(t0 + j) * N + n];
  }
  __syncthreads();
  const int groups = (cols + 31) / 32;
  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[a][k] = 0.f;
  for (int n = 0; n < N; ++n) {
    float cv[4], bv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
      cv[a] = warp * 4 + a < rows ? cs[(warp * 4 + a) * N + n] : 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = lane + 32 * k;
      bv[k] = (k < groups && j < cols) ? bs[j * np + n] : 0.f;
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[a][k] = fmaf(cv[a], bv[k], acc[a][k]);
  }
  float* out = gram + (static_cast<long long>(b) * (L / Q) + c) * Q * Q;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = r0 + warp * 4 + a;
    if (warp * 4 + a >= rows) continue;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = lane + 32 * k;
      if (k < groups && j <= i) out[i * Q + j] = acc[a][k];
    }
  }
}

// Grid (H, B); block 512 threads; dynamic shared memory scan_smem_floats().
// KP = ceil(P / 32): the columns p = lane + 32 k, k < KP, of a thread.
template <int KP>
__global__ void __launch_bounds__(kThreads)
scan_kernel(const float* __restrict__ dtx, const float* __restrict__ la,
            const float* __restrict__ bm, const float* __restrict__ cm,
            const float* __restrict__ gram, const float* __restrict__ init,
            float* __restrict__ y, float* __restrict__ final_state, int L,
            int H, int P, int N, int Q) {
  extern __shared__ float4 smem4[];
  const int qs = pad4(Q), ns = pad4(N);
  float* bs = reinterpret_cast<float*>(smem4);
  float* xs = bs + qs * ns;
  float* st = xs + qs * P;
  float* cs = st + ns * P;
  float* ms = cs + kRows * ns;
  float* cum = ms + kRows * qs;
  float* wdec = cum + qs;

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long state_off = (static_cast<long long>(b) * H + h) * P * N;
  const int chunks = L / Q;

  // every pad (rows j >= Q, columns n >= N) stays 0 for the whole launch:
  // the loads below write only the live part
  const int total_floats = static_cast<int>(scan_smem_floats(Q, P, N));
  for (int idx = tid; idx < total_floats; idx += kThreads)
    bs[idx] = 0.f;
  __syncthreads();
  for (int idx = tid; idx < P * N; idx += kThreads) {
    const int p = idx / N, n = idx - p * N;
    st[n * P + p] = init ? init[state_off + idx] : 0.f;
  }

  int pk[KP];
  bool live[KP];
#pragma unroll
  for (int k = 0; k < KP; ++k) {
    pk[k] = lane + 32 * k;
    live[k] = pk[k] < P;
  }

  for (int c = 0; c < chunks; ++c) {
    const long long t0 = static_cast<long long>(b) * L
                         + static_cast<long long>(c) * Q;
    const float* g = gram + (static_cast<long long>(b) * chunks + c) * Q * Q;
    for (int idx = tid; idx < Q * N; idx += kThreads) {
      const int j = idx / N, n = idx - j * N;
      bs[j * ns + n] = bm[(t0 + j) * N + n];
    }
    for (int idx = tid; idx < Q * P; idx += kThreads) {
      const int j = idx / P, p = idx - j * P;
      xs[idx] = dtx[((t0 + j) * H + h) * P + p];
    }
    if (warp == 0) {
      // in-chunk cumulative sum: 4 steps per lane, then a warp scan
      float part[4];
      float run = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = lane * 4 + e;
        run += j < Q ? la[(t0 + j) * H + h] : 0.f;
        part[e] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += o;
      }
      const float before = incl - run;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = lane * 4 + e;
        if (j < Q) cum[j] = before + part[e];
      }
    }
    __syncthreads();
    const float total = cum[Q - 1];
    for (int j = tid; j < Q; j += kThreads) wdec[j] = expf(total - cum[j]);

    for (int r0 = 0; r0 < Q; r0 += kRows) {
      const int rows = min(kRows, Q - r0);
      for (int idx = tid; idx < rows * N; idx += kThreads) {
        const int i = idx / N, n = idx - i * N;
        cs[i * ns + n] = cm[(t0 + r0 + i) * N + n];
      }
      // the slice of M: G masked with the decay, exactly 0 above the
      // diagonal (G is read only where j <= i)
      for (int idx = tid; idx < rows * Q; idx += kThreads) {
        const int ri = idx / Q, j = idx - ri * Q, i = r0 + ri;
        ms[ri * qs + j] = j <= i ? g[i * Q + j] * expf(cum[i] - cum[j])
                                 : 0.f;
      }
      __syncthreads();

      // y for the warp's rows i = r0 + 4 warp + a
      if (warp * 4 < rows) {
        float acc[4][KP], acc2[4][KP];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int k = 0; k < KP; ++k) acc[a][k] = acc2[a][k] = 0.f;
        const int jend = min(r0 + warp * 4 + 4, Q);   // j <= the last row
        for (int j = 0; j < jend; j += 4) {
          float4 mv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a)
            mv[a] = *reinterpret_cast<const float4*>(
                &ms[(warp * 4 + a) * qs + j]);
          float xv[4][KP];
#pragma unroll
          for (int t = 0; t < 4; ++t)
#pragma unroll
            for (int k = 0; k < KP; ++k)
              xv[t][k] = live[k] ? xs[(j + t) * P + pk[k]] : 0.f;
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int k = 0; k < KP; ++k) {
              float s = acc[a][k];
              s = fmaf(mv[a].x, xv[0][k], s);
              s = fmaf(mv[a].y, xv[1][k], s);
              s = fmaf(mv[a].z, xv[2][k], s);
              s = fmaf(mv[a].w, xv[3][k], s);
              acc[a][k] = s;
            }
        }
        for (int n = 0; n < ns; n += 4) {
          float4 cv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a)
            cv[a] = *reinterpret_cast<const float4*>(
                &cs[(warp * 4 + a) * ns + n]);
          float sv[4][KP];
#pragma unroll
          for (int t = 0; t < 4; ++t)
#pragma unroll
            for (int k = 0; k < KP; ++k)
              sv[t][k] = live[k] ? st[(n + t) * P + pk[k]] : 0.f;
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int k = 0; k < KP; ++k) {
              float s = acc2[a][k];
              s = fmaf(cv[a].x, sv[0][k], s);
              s = fmaf(cv[a].y, sv[1][k], s);
              s = fmaf(cv[a].z, sv[2][k], s);
              s = fmaf(cv[a].w, sv[3][k], s);
              acc2[a][k] = s;
            }
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int ri = warp * 4 + a;
          if (ri >= rows) continue;
          const int i = r0 + ri;
          const float e = expf(cum[i]);
#pragma unroll
          for (int k = 0; k < KP; ++k)
            if (live[k])
              y[((t0 + i) * H + h) * P + pk[k]] = acc[a][k] + e * acc2[a][k];
        }
      }
      __syncthreads();
    }

    // state update: the thread's n = nb + 4 warp + t (t < 4), p = pk[k]
    const float decay = expf(total);
    for (int nb = 0; nb < ns; nb += 64) {
      const int n0 = nb + warp * 4;
      if (n0 >= ns) continue;
      float acc[4][KP];
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int k = 0; k < KP; ++k) acc[t][k] = 0.f;
      for (int j = 0; j < qs; j += 4) {
        const float4 w4 = *reinterpret_cast<const float4*>(&wdec[j]);
        const float wj[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float4 bv = *reinterpret_cast<const float4*>(
              &bs[(j + jj) * ns + n0]);
#pragma unroll
          for (int k = 0; k < KP; ++k) {
            const float x = live[k] ? wj[jj] * xs[(j + jj) * P + pk[k]]
                                    : 0.f;
            acc[0][k] = fmaf(bv.x, x, acc[0][k]);
            acc[1][k] = fmaf(bv.y, x, acc[1][k]);
            acc[2][k] = fmaf(bv.z, x, acc[2][k]);
            acc[3][k] = fmaf(bv.w, x, acc[3][k]);
          }
        }
      }
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int k = 0; k < KP; ++k)
          if (live[k]) {
            float* s = &st[(n0 + t) * P + pk[k]];
            *s = decay * *s + acc[t][k];
          }
    }
    __syncthreads();
  }

  if (final_state) {
    for (int idx = tid; idx < P * N; idx += kThreads) {
      const int p = idx / N, n = idx - p * N;
      final_state[state_off + idx] = st[n * P + p];
    }
  }
}

template <int KP>
int launch_scan(int batch, int l, int h, int p, int n, int q,
                const float* dtx, const float* la, const float* bm,
                const float* cm, const float* gram, const float* init,
                float* y, float* final_state, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * scan_smem_floats(q, p, n);
  cudaError_t err = cudaFuncSetAttribute(
      scan_kernel<KP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_kernel<KP><<<dim3(h, batch), kThreads, bytes, stream>>>(
      dtx, la, bm, cm, gram, init, y, final_state, l, h, p, n, q);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ssd

// Shared memory the larger of the two kernels needs at (q, p, n), in
// bytes: the wrapper refuses a geometry whose tiles exceed what a block
// may use.
extern "C" long long ssd_scan_smem_bytes(int q, int p, int n) {
  const size_t f = ssd::scan_smem_floats(q, p, n) > ssd::gram_smem_floats(q, n)
                       ? ssd::scan_smem_floats(q, p, n)
                       : ssd::gram_smem_floats(q, n);
  return static_cast<long long>(sizeof(float) * f);
}

// gram: scratch of batch * (l / q) * q * q floats.  init may be null (S
// starts at 0); final_state may be null (not written).
extern "C" int ssd_scan_fwd(int batch, int l, int h, int p, int n, int q,
                            const void* dtx, const void* log_a,
                            const void* bm, const void* cm, void* gram,
                            const void* init, void* y, void* final_state,
                            void* stream) {
  if (batch <= 0 || h <= 0 || p <= 0 || n <= 0 || q <= 0 || l <= 0 ||
      l % q != 0 || q > ssd::kMaxQ || p > ssd::kMaxP || batch > 65535 ||
      l / q > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (ssd_scan_smem_bytes(q, p, n) > static_cast<long long>(ssd::kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);

  const size_t gbytes = sizeof(float) * ssd::gram_smem_floats(q, n);
  cudaError_t err = cudaFuncSetAttribute(
      ssd::gram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(gbytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 ggrid((q + ssd::kGramRows - 1) / ssd::kGramRows, l / q, batch);
  ssd::gram_kernel<<<ggrid, ssd::kGramThreads, gbytes, st>>>(
      static_cast<const float*>(bm), static_cast<const float*>(cm),
      static_cast<float*>(gram), l, n, q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const auto* x = static_cast<const float*>(dtx);
  const auto* a = static_cast<const float*>(log_a);
  const auto* b = static_cast<const float*>(bm);
  const auto* c = static_cast<const float*>(cm);
  const auto* g = static_cast<const float*>(gram);
  const auto* s0 = static_cast<const float*>(init);
  auto* yo = static_cast<float*>(y);
  auto* sf = static_cast<float*>(final_state);
  switch ((p + 31) / 32) {
    case 1:
      return ssd::launch_scan<1>(batch, l, h, p, n, q, x, a, b, c, g, s0, yo,
                                 sf, st);
    case 2:
      return ssd::launch_scan<2>(batch, l, h, p, n, q, x, a, b, c, g, s0, yo,
                                 sf, st);
    case 3:
      return ssd::launch_scan<3>(batch, l, h, p, n, q, x, a, b, c, g, s0, yo,
                                 sf, st);
    default:
      return ssd::launch_scan<4>(batch, l, h, p, n, q, x, a, b, c, g, s0, yo,
                                 sf, st);
  }
}

// The text of a CUDA error code, for the Python wrapper's messages.
extern "C" const char* rmq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
