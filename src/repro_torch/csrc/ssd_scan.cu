// Mamba-2 SSD chunk scan (B9), chunk-parallel on Hopper's tensor cores.
//
// Replaces the Pallas TPU kernel `ssd_scan`
// (src/repro/kernels/ssd_scan/kernel.py:76, pallas_call :91).  What it
// computes is the same, at float32 accuracy:
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
// (B 8, L 2048, H 64, P 64, N 128, Q 128) the work is 21.6 G multiply-adds
// (C B^T once per (b, chunk) over its causal pairs, the causal in-chunk
// product, the carried-state term and the chunk states).  The 1e-4 gate
// asks for float32 accuracy; one TF32 pass keeps about three digits, so
// every product is split 3xTF32 (a = hi + lo, hi = tf32(a) by cvt.rna,
// lo = tf32(a - hi); a b ~ hi_a hi_b + hi_a lo_b + lo_a hi_b, the lo lo
// term dropped, summed in float32): three passes of 43.3 GFLOP at the
// 495 TFLOP/s dense TF32 rate is 0.262 ms.  The operand bytes (dtx in,
// y out, B, C, log_a) are 0.56 GB, 0.167 ms at 3.35 TB/s.
//
// Design: the SSD form of Mamba-2 (arXiv:2405.21060 s6) in three launches,
// every product on `mma.sync.m16n8k8` with TF32 operands and float32
// accumulators.  Each operand is split once: a tile that several warps read
// is split on its way into shared memory, laid out so that one 8- or
// 16-byte load yields half or all of a fragment in the registers mma.sync
// takes (register moves between MMAs cost more than the MMAs in a first
// version); a fragment that only one warp reads is split in that warp's
// registers.  Every exponential is one ex2.approx on cum kept in units of
// log2(e).
//   1. prep, one block per (b, chunk): G = C B^T over the causal 16 x 32
//      tiles into a (B, L/Q, Q, Q) scratch; cum for every head into a
//      (B, L/Q, H, Q) scratch (so the later kernels read their log_a
//      contiguously); and B split into hi / lo in the state walk's
//      shared-memory order (16 MB at the training shape, read from L2 by
//      every head's walk, which only copies it).
//   2. states, one block per (b, h, 64 x 64 tile of the P x N state):
//      the chunk states and the state passing folded into one walk over
//      the chunks.  The state tile lives in the accumulators; at chunk c
//      the block writes it (the state entering c) to a (B, L/Q, H, P, N)
//      scratch, scales it by exp(total_c) and adds (w * dtx_c)^T B_c on
//      the tensor cores, 32 rows of the chunk at a time, double-buffered:
//      while the MMAs run on one stage, the next stage's dtx rows are
//      loaded into registers (then scaled by w, split and stored) and its
//      B is copied by cp.async.
//   3. chunk scan, one block per (b, chunk, h, 64 columns of P), 8192
//      blocks at the training shape: y = exp(cum) (C S_{c-1}^T) + M dtx.
//      S_{c-1} is staged split, then dtx_c in the same buffer; C and G are
//      read from L2 (shared by all heads) as 8-byte pairs one k-step
//      ahead, and M is formed, masked by select and split in the registers
//      of the one warp that uses it.  A warp owns m-tiles w and 7 - w, so
//      the causal work is even; a k-step is one basic block, so the splits
//      and loads interleave with the MMAs.
//   Where the states live: folding the state passing into the walk costs
//   one write and one read of the state scratch, 2 x 268 MB at the
//   training shape (0.16 ms at 3.35 TB/s), against about 1.07 GB for
//   separate chunk-state and passing launches.  dtx is read twice by the
//   walk (once per N half; the second mostly from L2) and once by the
//   chunk scan.
// How far it gets (PERF.md s6): mma.sync peaks at 156.7 G MMA/s on an
// H100 (320.9 TFLOP/s of TF32, 65% of 495; tools/mma_rate.cu), so the
// 64.9 M MMAs of a call need 0.414 ms.  The chunk scan's MMAs hide behind
// the rest; what shows is its staging of S and dtx (exposed memory latency
// that three blocks an SM only partly cover: fetching dtx by cp.async
// during C S^T, at the price of the third block, was slower).  The walk is
// held by its per-stage staging and barrier.
// Limits: Q <= 128, P <= 128, and the staged tiles within 227 KB (the prep
// block stages C and B whole: N <= 216 at Q = 128).

#include <cuda_runtime.h>
#include <stdint.h>

namespace ssd {

constexpr int kMaxQ = 128;
constexpr int kMaxP = 128;
constexpr size_t kMaxSmem = 232448;  // 227 KB, the most one block may use
constexpr int kThreads = 128;        // state and chunk blocks: 4 warps
constexpr int kPrepThreads = 256;    // prep block: 8 warps
constexpr int kTile = 64;            // P (and N) columns of a block
constexpr int kSlice = 32;           // chunk rows of one state stage
constexpr int kARow = 72;            // state A plane row: banks 8t + 2g
constexpr int kBRow = 136;           // state B plane row pair: 8t + 2g
constexpr int kXWords = 66;          // 16-byte words a chunk dtx row pair
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}
// Row stride of a raw [row][k] tile read as (g, t) fragments: 4 (mod 8),
// so the 32 lanes of a fragment load hit 32 banks.
__host__ __device__ inline int kstride(int k) { return round_up(k, 8) + 4; }
// Row stride (floats) of the chunk scan's S plane, [p][n] in 16-byte
// words (hi, hi, lo, lo) of two columns, read 16 bytes a lane: 16 (mod 32).
__host__ __device__ inline int sstride(int n) {
  return 2 * round_up(n, 16) + 16;
}

__host__ __device__ inline size_t prep_smem_floats(int q, int n) {
  return 2 * static_cast<size_t>(round_up(q, 16)) * kstride(n);
}
// state block: two stages of (A hi, A lo, B hi, B lo) planes
constexpr int kAPlane = kSlice * kARow;
constexpr int kBPlane = kSlice / 2 * kBRow;
// B split by prep for the state walk: per (b, chunk, 32-row slice, 64-wide
// N tile) a hi and a lo plane of 16 row pairs x 128 floats (a walk
// plane's rows without their padding)
constexpr int kBFrag = 2 * (kSlice / 2) * 2 * kTile;
__host__ __device__ inline size_t state_smem_floats() {
  return 2 * 2 * static_cast<size_t>(kAPlane + kBPlane);
}
__host__ __device__ inline size_t chunk_smem_floats(int q, int n) {
  const size_t qr = round_up(q, 16);
  const size_t s_plane = static_cast<size_t>(kTile) * sstride(n);
  const size_t x_plane = qr / 2 * kXWords * 4;
  return qr + (s_plane > x_plane ? s_plane : x_plane);
}

// ---------------------------------------------------------------------------
// TF32 on the tensor cores
// ---------------------------------------------------------------------------
// hi = tf32(x) to nearest, ties away (cvt.rna: three instructions, NaN
// kept); lo = tf32(x - hi) to nearest even (cvt.rn: one instruction).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  asm("cvt.rn.tf32.f32 %0, %1;" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}

// (hi_a, hi_b, lo_a, lo_b) as one 16-byte shared-memory word: one load
// gives a B fragment's hi and lo pairs in the registers mma.sync takes.
__device__ __forceinline__ uint4 split2(float a, float b) {
  uint4 w;
  split(a, w.x, w.z);
  split(b, w.y, w.w);
  return w;
}

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// 2^x in one instruction (2 ulp; results below 2^-126 flush to 0).
__device__ __forceinline__ float ex2(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// d += a b for one m16n8k8 tile.  Fragments (g = lane / 4, t = lane % 4):
// a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); b0 (k t,
// col g), b1 (k t + 4, col g); d0 d1 (g, 2t, 2t + 1), d2 d3 (g + 8, ...).
// The order of k inside a step is free as long as a and b agree: the chunk
// scan maps k slots t and t + 4 to columns 2t and 2t + 1, so a thread's
// pair is one 8-byte load.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One k-step of 3xTF32 products over a warp's MI x NI tiles, in three
// passes (lo_a hi_b, hi_a lo_b, hi_a hi_b): the MMAs of a pass are
// independent, so no accumulator's chain of three holds the tensor pipe.
// Tiles with mon[mi] false are skipped (a warp-uniform test).
template <int MI, int NI>
__device__ __forceinline__ void mma3_tiles(float (&acc)[MI][NI][4],
                                           const uint32_t (&ah)[MI][4],
                                           const uint32_t (&al)[MI][4],
                                           const uint32_t (&bh)[NI][2],
                                           const uint32_t (&bl)[NI][2],
                                           const bool (&mon)[MI]) {
#pragma unroll
  for (int pass = 0; pass < 3; ++pass)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        if (!mon[mi]) continue;
        if (pass == 0) mma(acc[mi][ni], al[mi], bh[ni][0], bh[ni][1]);
        if (pass == 1) mma(acc[mi][ni], ah[mi], bl[ni][0], bl[ni][1]);
        if (pass == 2) mma(acc[mi][ni], ah[mi], bh[ni][0], bh[ni][1]);
      }
}

// Two consecutive floats of a row at columns k, k + 1 (< live), zero
// elsewhere; one 8-byte load where both are live and `vec` holds.
__device__ __forceinline__ float2 load2(const float* src, bool row_live,
                                        int k, int live, bool vec) {
  if (!row_live || k >= live) return make_float2(0.f, 0.f);
  if (vec && k + 1 < live) return __ldg(reinterpret_cast<const float2*>(src));
  return make_float2(__ldg(src), k + 1 < live ? __ldg(src + 1) : 0.f);
}

// cp.async of 16 bytes into shared memory, and the wait for all of a
// thread's copies.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

__device__ __forceinline__ float2 ldg2(const float* src) {
  return __ldg(reinterpret_cast<const float2*>(src));
}

__host__ __device__ inline bool aligned8(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 7) == 0;
}

// A [rows][cols] tile (cols even) from a row-major source into split2
// words of column pairs, row stride `stride` floats; zero outside
// rows_live x cols_live.  Eight 8-byte loads in flight a thread.
__device__ __forceinline__ void stage_cols(float* plane, int stride, int rows,
                                           int cols, const float* src,
                                           long long src_stride,
                                           int rows_live, int cols_live,
                                           bool vec) {
  const int pairs = cols / 2, total = rows * pairs;
  for (int base = threadIdx.x; base < total; base += 8 * kThreads) {
    float2 v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int idx = base + e * kThreads;
      const int r = idx / pairs, k = 2 * (idx - r * pairs);
      v[e] = load2(src + r * src_stride + k, idx < total && r < rows_live, k,
                   cols_live, vec);
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int idx = base + e * kThreads;
      if (idx >= total) break;
      const int r = idx / pairs, k = 2 * (idx - r * pairs);
      *reinterpret_cast<uint4*>(plane + r * stride + 2 * k) =
          split2(v[e].x, v[e].y);
    }
  }
}

// A [rows][64] tile (rows even) into split2 words of row pairs: word
// (j / 2, c) at 4 (kXWords (j / 2) + c) holds rows j and j + 1 of column
// c; zero outside rows_live x cols_live.  Sixteen 4-byte loads in flight.
__device__ __forceinline__ void stage_rows(float* plane, int rows,
                                           const float* src,
                                           long long src_stride,
                                           int rows_live, int cols_live) {
  const int total = rows / 2 * kTile;
  for (int base = threadIdx.x; base < total; base += 8 * kThreads) {
    float v[8][2];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int idx = base + e * kThreads;
      const int jp = idx / kTile, c = idx - jp * kTile;
      const bool col = idx < total && c < cols_live;
      const float* p = src + 2 * jp * src_stride + c;
      v[e][0] = col && 2 * jp < rows_live ? __ldg(p) : 0.f;
      v[e][1] = col && 2 * jp + 1 < rows_live ? __ldg(p + src_stride) : 0.f;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int idx = base + e * kThreads;
      if (idx >= total) break;
      const int jp = idx / kTile, c = idx - jp * kTile;
      *reinterpret_cast<uint4*>(plane + 4 * (jp * kXWords + c)) =
          split2(v[e][0], v[e][1]);
    }
  }
}

// ---------------------------------------------------------------------------
// 1. prep: G = C B^T (causal tiles) and cum, per (b, chunk)
// ---------------------------------------------------------------------------
// Grid (L / Q, B); block 256 threads; dynamic shared memory
// prep_smem_floats().  cum is written in units of log2(e) (cum * log2 e),
// so every decay later is one ex2.
__global__ void __launch_bounds__(kPrepThreads)
prep_kernel(const float* __restrict__ la, const float* __restrict__ bm,
            const float* __restrict__ cm, float* __restrict__ gram,
            float* __restrict__ cum, float* __restrict__ bfrag, int L, int H,
            int N, int Q) {
  extern __shared__ float smem[];
  const int qr = round_up(Q, 16), ks = kstride(N);
  float* cs = smem;            // C rows [qr][ks], zero padded
  float* bs = cs + qr * ks;    // B rows [qr][ks]
  const int c = blockIdx.x, b = blockIdx.y, nc = L / Q;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long t0 = static_cast<long long>(b) * L
                       + static_cast<long long>(c) * Q;
  const long long bc = static_cast<long long>(b) * nc + c;

  for (int idx = tid; idx < qr * ks; idx += kPrepThreads) {
    const int i = idx / ks, k = idx - i * ks;
    const bool live = i < Q && k < N;
    cs[idx] = live ? cm[(t0 + i) * N + k] : 0.f;
    bs[idx] = live ? bm[(t0 + i) * N + k] : 0.f;
  }

  // cum of each head: 4 consecutive rows per lane, then a warp scan
  for (int hh = warp; hh < H; hh += kPrepThreads / 32) {
    float part[4];
    float run = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = lane * 4 + e;
      run += j < Q ? la[(t0 + j) * H + hh] : 0.f;
      part[e] = run;
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += o;
    }
    const float before = incl - run;
    float* out = cum + (bc * H + hh) * Q;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = lane * 4 + e;
      if (j < Q) out[j] = (before + part[e]) * kLog2e;
    }
  }
  __syncthreads();

  // B split once for every head's state walk, in the walk's order: row
  // pair q of a slice holds rows 8 (q / 4) + q % 4 and 4 below, each
  // column n as the pair (2 n, 2 n + 1); zero past Q and N
  const int per_chunk = (Q + kSlice - 1) / kSlice;
  const int n_tiles = (N + kTile - 1) / kTile;
  for (int tile = 0; tile < per_chunk * n_tiles; ++tile) {
    const int r = tile / n_tiles, nt = tile - r * n_tiles;
    float* bf = bfrag + (bc * per_chunk * n_tiles + tile) * kBFrag;
    for (int idx = tid; idx < (kSlice / 2) * kTile; idx += kPrepThreads) {
      const int q = idx >> 6, col = idx & (kTile - 1);
      const int j = kSlice * r + 8 * (q >> 2) + (q & 3);
      const int n = kTile * nt + col;
      const float v0 = j < Q && n < N ? bs[j * ks + n] : 0.f;
      const float v1 = j + 4 < Q && n < N ? bs[(j + 4) * ks + n] : 0.f;
      uint32_t h0, l0, h1, l1;
      split(v0, h0, l0);
      split(v1, h1, l1);
      float* w = bf + q * 2 * kTile + 2 * col;
      *reinterpret_cast<uint2*>(w) = make_uint2(h0, h1);
      *reinterpret_cast<uint2*>(w + kBFrag / 2) = make_uint2(l0, l1);
    }
  }

  // the causal tiles: 16 rows x 32 columns whose first column is <= the
  // last live row, dealt to the warps in turn
  float* gout = gram + bc * Q * Q;
  const bool mon[1] = {true};
  int item = 0;
  for (int i0 = 0; i0 < qr; i0 += 16) {
    const int last = min(i0 + 15, Q - 1);
    for (int n0 = 0; n0 <= last; n0 += 32, ++item) {
      if (item % (kPrepThreads / 32) != warp) continue;
      const int nlive = min(4, (last - n0) / 8 + 1);
      float acc[1][4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[0][nt][e] = 0.f;
      for (int k0 = 0; k0 < N; k0 += 8) {
        uint32_t ah[1][4], al[1][4], bh[4][2], bl[4][2];
        split(cs[(i0 + g) * ks + k0 + t], ah[0][0], al[0][0]);
        split(cs[(i0 + g + 8) * ks + k0 + t], ah[0][1], al[0][1]);
        split(cs[(i0 + g) * ks + k0 + t + 4], ah[0][2], al[0][2]);
        split(cs[(i0 + g + 8) * ks + k0 + t + 4], ah[0][3], al[0][3]);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          bh[nt][0] = bh[nt][1] = bl[nt][0] = bl[nt][1] = 0u;
          if (nt >= nlive) continue;   // rows past the staged tile
          const int j = n0 + nt * 8 + g;
          split(bs[j * ks + k0 + t], bh[nt][0], bl[nt][0]);
          split(bs[j * ks + k0 + t + 4], bh[nt][1], bl[nt][1]);
        }
        mma3_tiles<1, 4>(acc, ah, al, bh, bl, mon);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int j = n0 + nt * 8 + 2 * t;
        if (nt >= nlive) continue;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = i0 + g + 8 * half;
          if (i >= Q) continue;
          if (j < Q) gout[i * Q + j] = acc[0][nt][2 * half];
          if (j + 1 < Q) gout[i * Q + j + 1] = acc[0][nt][2 * half + 1];
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 2. states: the chunk states and the state passing, one walk per tile
// ---------------------------------------------------------------------------
// Grid (ceil(N / 64) * ceil(P / 64), H, B); block 128 threads; dynamic
// shared memory state_smem_floats(): two stages, each four planes (hi and
// lo of A = w * dtx, hi and lo of B) laid out so that one 8-byte load is
// half a fragment in the registers mma.sync takes (no moves):
//   A[j][pos(p)], pos(p) = 16 (p / 16) + 2 (p % 8) + (p / 8 % 2): rows g
//     and g + 8 of an m-tile side by side, a0 a1 then a2 a3;
//   B[8 kk + t][2 n + h] holds B[8 kk + t + 4 h][n]: b0 b1 side by side.
// B's planes come split from prep (bfrag), copied as they are.  Warp
// (wm, wn) owns rows p0 + 32 wm + [0, 32) and columns n0 + 32 wn + [0, 32)
// of the state.  A staging: warp w takes rows w + 4 v, v < 8; lane L loads
// two floats and stores them as one 8-byte word at 2 L, so each store
// instruction covers 256 contiguous bytes.  kFull: P and N multiples of
// 64, Q of 32 (no masks).
template <bool kFull>
__global__ void __launch_bounds__(kThreads, 3)
state_kernel(const float* __restrict__ dtx, const float* __restrict__ bfrag,
             const float* __restrict__ cum, const float* __restrict__ init,
             float* __restrict__ states, float* __restrict__ final_state,
             int L, int H, int P, int N, int Q) {
  extern __shared__ float4 smem4[];
  float* planes = reinterpret_cast<float*>(smem4);
  const int n_tiles = (N + kTile - 1) / kTile;
  const int n0 = (blockIdx.x % n_tiles) * kTile;
  const int p0 = (blockIdx.x / n_tiles) * kTile;
  const int h = blockIdx.y, b = blockIdx.z;
  const int nc = L / Q, per_chunk = (Q + kSlice - 1) / kSlice;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, wm = warp >> 1, wn = warp & 1;
  const int np = min(kTile, P - p0), nn = min(kTile, N - n0);
  const bool busy = 32 * wm < np && 32 * wn < nn;
  const bool both[2] = {true, true};
  const bool pairs = N % 2 == 0;

  // the state tile in accumulator layout
  float acc[2][4][4];
  const long long hpn = static_cast<long long>(P) * N;
  auto frag_off = [&](int mi, int ni, int e, int& p, int& n) {
    p = p0 + 32 * wm + 16 * mi + g + (e >= 2 ? 8 : 0);
    n = n0 + 32 * wn + 8 * ni + 2 * t + (e & 1);
  };
  {
    const float* s0 = init ? init + (static_cast<long long>(b) * H + h) * hpn
                           : nullptr;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          int p, n;
          frag_off(mi, ni, e, p, n);
          acc[mi][ni][e] = (s0 && p < P && n < N) ? s0[p * N + n] : 0.f;
        }
  }
  auto store_state = [&](float* dst) {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          int p, n;
          frag_off(mi, ni, 2 * half, p, n);
          if (!kFull && (p >= P || n >= N)) continue;
          const float v0 = acc[mi][ni][2 * half], v1 = acc[mi][ni][2 * half + 1];
          if (kFull || (pairs && n + 1 < N)) {
            *reinterpret_cast<float2*>(dst + p * N + n) = make_float2(v0, v1);
          } else {
            dst[p * N + n] = v0;
            if (n + 1 < N) dst[p * N + n + 1] = v1;
          }
        }
  };

  // a lane's columns: A p = 16 (L / 8) + L % 8 and p + 8; B n = 32 (w % 2)
  // + L of row pair w / 2 + 2 v, i.e. rows 8 (v / 2) + w / 2 + 2 (v % 2)
  // and 4 below; A rows w + 4 v
  const int pa = 16 * (lane >> 3) + (lane & 7);
  const long long hp = static_cast<long long>(H) * P;
  const float* xbase = dtx + static_cast<long long>(b) * L * hp
                       + static_cast<long long>(h) * P + p0 + pa
                       + warp * hp;
  const float* csrc = cum + (static_cast<long long>(b) * nc * H + h) * Q;
  const float* bsrc = bfrag + (static_cast<long long>(b) * nc * per_chunk
                               * n_tiles + blockIdx.x % n_tiles) * kBFrag;
  float xr[8][2], cj[8], tot = 0.f, decay = 1.f;
  // stage (c, r): rows c Q + 32 r + [0, 32) of the batch row.  A (w * dtx)
  // goes through registers to be scaled and split; B, split by prep, is
  // copied into buffer `buf` by cp.async (16 bytes a copy, 8 a thread)
  auto load_stage = [&](int c, int r, int buf) {
    const int j0 = r * kSlice;
    const float* cumc = csrc + static_cast<long long>(c) * H * Q + j0;
    const float* xs = xbase + (static_cast<long long>(c) * Q + j0) * hp;
    tot = __ldg(csrc + static_cast<long long>(c) * H * Q + Q - 1);
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      const int ja = warp + 4 * v;                    // A row
      const float* xv = xs + 4 * v * hp;
      if (kFull) {
        cj[v] = __ldg(cumc + ja);
        xr[v][0] = __ldg(xv);
        xr[v][1] = __ldg(xv + 8);
      } else {
        const bool la = j0 + ja < Q;
        cj[v] = la ? __ldg(cumc + ja) : tot;
        xr[v][0] = la && pa < np ? __ldg(xv) : 0.f;
        xr[v][1] = la && pa + 8 < np ? __ldg(xv + 8) : 0.f;
      }
    }
    const float* bs = bsrc + (static_cast<long long>(c) * per_chunk + r)
                                 * n_tiles * kBFrag;
    float* bh = planes + buf * 2 * (kAPlane + kBPlane) + 2 * kAPlane;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int idx = tid + kThreads * e;   // 16-byte copy: (plane, row, col)
      const int pl = idx >> 9, row = (idx >> 5) & 15, col = idx & 31;
      cp_async16(bh + pl * kBPlane + row * kBRow + 4 * col, bs + 4 * idx);
    }
  };
  auto store_stage = [&](int buf) {
    float* ah = planes + buf * 2 * (kAPlane + kBPlane);
    float* al = ah + kAPlane;
    const int ra0 = warp * kARow + 2 * lane;
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      const float w = ex2(tot - cj[v]);   // <= 1: cum falls along the chunk
      uint32_t h0, l0, h1, l1;
      split(xr[v][0] * w, h0, l0);
      split(xr[v][1] * w, h1, l1);
      const int ra = ra0 + 4 * v * kARow;
      *reinterpret_cast<uint2*>(ah + ra) = make_uint2(h0, h1);
      *reinterpret_cast<uint2*>(al + ra) = make_uint2(l0, l1);
    }
    decay = ex2(tot);
  };

  // the walk: chunk c, its 32-row slices r; stage (c, r) is in buffer
  // `buf`, the next one's loads are issued before its MMAs
  load_stage(0, 0, 0);
  store_stage(0);
  cp_async_wait_all();
  __syncthreads();
  int buf = 0;
  for (int c = 0; c < nc; ++c) {
    for (int r = 0; r < per_chunk; ++r) {
      const bool last_r = r + 1 == per_chunk;
      const bool more = !last_r || c + 1 < nc;
      if (more) load_stage(last_r ? c + 1 : c, last_r ? 0 : r + 1, buf ^ 1);
      if (r == 0) {
        // the state entering chunk c, then its decay over the chunk
        store_state(states + ((static_cast<long long>(b) * nc + c) * H + h)
                                 * hpn);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mi][ni][e] *= decay;
      }
      if (busy) {
        const float* ahp = planes + buf * 2 * (kAPlane + kBPlane);
        const float* alp = ahp + kAPlane;
        const float* bhp = alp + kAPlane;
        const float* blp = bhp + kBPlane;
#pragma unroll
        for (int k0 = 0; k0 < kSlice; k0 += 8) {
          const int r0 = (k0 + t) * kARow, r1 = r0 + 4 * kARow;
          const int rb = (k0 / 2 + t) * kBRow;
          uint32_t ah[2][4], al[2][4], fh[4][2], fl[4][2];
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            const int m = 32 * wm + 16 * mi + 2 * g;
            const uint2 h01 = *reinterpret_cast<const uint2*>(ahp + r0 + m);
            const uint2 h23 = *reinterpret_cast<const uint2*>(ahp + r1 + m);
            const uint2 l01 = *reinterpret_cast<const uint2*>(alp + r0 + m);
            const uint2 l23 = *reinterpret_cast<const uint2*>(alp + r1 + m);
            ah[mi][0] = h01.x;
            ah[mi][1] = h01.y;
            ah[mi][2] = h23.x;
            ah[mi][3] = h23.y;
            al[mi][0] = l01.x;
            al[mi][1] = l01.y;
            al[mi][2] = l23.x;
            al[mi][3] = l23.y;
          }
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) {
            const int n = 2 * (32 * wn + 8 * ni + g);
            const uint2 vh = *reinterpret_cast<const uint2*>(bhp + rb + n);
            const uint2 vl = *reinterpret_cast<const uint2*>(blp + rb + n);
            fh[ni][0] = vh.x;
            fh[ni][1] = vh.y;
            fl[ni][0] = vl.x;
            fl[ni][1] = vl.y;
          }
          mma3_tiles<2, 4>(acc, ah, al, fh, fl, both);
        }
      }
      if (more) store_stage(buf ^ 1);
      cp_async_wait_all();
      buf ^= 1;
      __syncthreads();
    }
  }
  if (final_state)
    store_state(final_state + (static_cast<long long>(b) * H + h) * hpn);
}

// ---------------------------------------------------------------------------
// 3. chunk scan: y = exp(cum) (C S^T) + M dtx, per (b, chunk, h, P tile)
// ---------------------------------------------------------------------------
// Grid (H * ceil(P / 64), L / Q, B); block 128 threads; dynamic shared
// memory chunk_smem_floats(): cum [qr], then in one buffer S as split2
// words of column pairs (phase 1) or dtx as split2 words of row pairs
// (phase 2).  Warp w owns m-tiles w and 7 - w (rows 16 m + [0, 16))
// where < qr / 16.  k slots t and t + 4 are columns 2t and 2t + 1 of each
// 8-wide k-step.  kFull: Q 128, N a multiple of 8, P of 64, C 8-byte
// aligned (no clamps, masks or tests on the loads and stores).
template <bool kFull>
__global__ void __launch_bounds__(kThreads, 3)
chunk_kernel(const float* __restrict__ dtx, const float* __restrict__ cm,
             const float* __restrict__ gram, const float* __restrict__ cum,
             const float* __restrict__ states, float* __restrict__ y, int L,
             int H, int P, int N, int Q) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int p_tiles = (P + kTile - 1) / kTile;
  const int h = blockIdx.x / p_tiles, p0 = (blockIdx.x % p_tiles) * kTile;
  const int c = blockIdx.y, b = blockIdx.z, nc = L / Q;
  const int qr = round_up(Q, 16), ss = sstride(N), nk = round_up(N, 8);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int np = min(kTile, P - p0);
  const long long bc = static_cast<long long>(b) * nc + c;
  const long long tc = static_cast<long long>(b) * L
                       + static_cast<long long>(c) * Q;
  const float* cumc = cum + (bc * H + h) * Q;
  const float* st = states + (bc * H + h) * P * N + static_cast<long long>(p0)
                                                        * N;
  const float* gbc = gram + bc * Q * Q;
  float* cum_s = smem;                   // cum * log2 e; -inf past Q
  float* plane = smem + qr;              // qr is a multiple of 16: aligned

  for (int j = tid; j < qr; j += kThreads)
    cum_s[j] = j < Q ? cumc[j] : neg_inf();
  stage_cols(plane, ss, kTile, nk, st, N, np, N, N % 2 == 0 && aligned8(st));
  __syncthreads();

  const int mtiles = qr / 16;
  const int mt[2] = {warp, 7 - warp};
  const bool on[2] = {warp < mtiles, 7 - warp < mtiles};
  float acc[2][8][4];
#pragma unroll
  for (int sl = 0; sl < 2; ++sl)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[sl][nt][e] = 0.f;
  uint32_t ah[2][4], al[2][4], bh[8][2], bl[8][2];
  // the rows i of a thread in C and G, clamped to the chunk
  const float* crow[2][2];
  const float* grow[2][2];
#pragma unroll
  for (int sl = 0; sl < 2; ++sl)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = min(16 * mt[sl] + g + 8 * half, Q - 1);
      crow[sl][half] = cm + (tc + i) * N;
      grow[sl][half] = gbc + i * Q;
    }

  // phase 1: C S^T over k = n; C pairs from L2, one step ahead.  Rows past
  // Q read row Q - 1 and columns past N meet S's zero padding: neither
  // result is stored.
  const bool vec_c = N % 2 == 0 && aligned8(cm);
  float2 cr[2][2];
  auto load_c = [&](int k0) {
    const int k = k0 + 2 * t;
#pragma unroll
    for (int sl = 0; sl < 2; ++sl)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float* src = crow[sl][half];
        cr[sl][half] = kFull ? ldg2(src + k)
                       : vec_c ? ldg2(src + min(k, N - 2))
                               : load2(src + k, k < N, k, N, false);
      }
  };
  // A k-step is one basic block (the prefetch of the last step reloads it,
  // the slot tests fold where both slots are live), so the splits and loads
  // interleave with the MMAs.
  auto phase1_step = [&](int k0, const bool (&mon)[2]) {
#pragma unroll
    for (int sl = 0; sl < 2; ++sl) {
      split(cr[sl][0].x, ah[sl][0], al[sl][0]);
      split(cr[sl][1].x, ah[sl][1], al[sl][1]);
      split(cr[sl][0].y, ah[sl][2], al[sl][2]);
      split(cr[sl][1].y, ah[sl][3], al[sl][3]);
    }
    load_c(min(k0 + 8, nk - 8));
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const uint4 v = *reinterpret_cast<const uint4*>(
          plane + (nt * 8 + g) * ss + 2 * (k0 + 2 * t));
      bh[nt][0] = v.x;
      bh[nt][1] = v.y;
      bl[nt][0] = v.z;
      bl[nt][1] = v.w;
    }
    mma3_tiles<2, 8>(acc, ah, al, bh, bl, mon);
  };
  load_c(0);
  const bool all[2] = {true, true};
  if (kFull || (on[0] && on[1])) {
    for (int k0 = 0; k0 < nk; k0 += 8) phase1_step(k0, all);
  } else {
    for (int k0 = 0; k0 < nk; k0 += 8) phase1_step(k0, on);
  }
  // scale row i by exp(cum_i); keep cum_i for the decay of M
  float ci[2][2];
#pragma unroll
  for (int sl = 0; sl < 2; ++sl)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = 16 * mt[sl] + g + 8 * half;
      ci[sl][half] = on[sl] ? cum_s[i] : neg_inf();
      const float e = ex2(ci[sl][half]);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        acc[sl][nt][2 * half] *= e;
        acc[sl][nt][2 * half + 1] *= e;
      }
    }
  __syncthreads();   // every warp is done with S

  // phase 2: M dtx over k = j <= i
  stage_rows(plane, qr, dtx + (tc * H + h) * P + p0,
             static_cast<long long>(H) * P, Q, np);
  __syncthreads();

  // M pairs: G from L2 one step ahead (clamped into the chunk's tile, so
  // unconditional; what lies past the diagonal is masked below), decayed,
  // then split
  const int kend[2] = {on[0] ? 16 * mt[0] + 16 : 0,
                       on[1] ? 16 * mt[1] + 16 : 0};
  const int kmax = max(kend[0], kend[1]);
  const bool vec_g = Q % 2 == 0;
  const uint4* xplane = reinterpret_cast<const uint4*>(plane);
  float2 gr[2][2];
  auto load_g = [&](int k0) {
    const int j = k0 + 2 * t;
#pragma unroll
    for (int sl = 0; sl < 2; ++sl)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float* src = grow[sl][half];
        gr[sl][half] = kFull ? ldg2(src + j)
                       : vec_g ? ldg2(src + min(j, Q - 2))
                               : load2(src + j, j < Q, j, Q, false);
      }
  };
  auto phase2_step = [&](int k0, const bool (&mon)[2]) {
    const int j = k0 + 2 * t;
    const float2 cj = *reinterpret_cast<const float2*>(cum_s + j);
#pragma unroll
    for (int sl = 0; sl < 2; ++sl)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        // exp(cum_i - cum_j) <= 1 where j <= i < Q; nothing else counts
        // (a select, so garbage past the diagonal never enters a product)
        const int i = 16 * mt[sl] + g + 8 * half;
        const float c0 = ci[sl][half];
        const float m0 = gr[sl][half].x * ex2(c0 - cj.x);
        const float m1 = gr[sl][half].y * ex2(c0 - cj.y);
        split(j <= i && i < Q ? m0 : 0.f, ah[sl][half], al[sl][half]);
        split(j + 1 <= i && i < Q ? m1 : 0.f, ah[sl][half + 2],
              al[sl][half + 2]);
      }
    load_g(min(k0 + 8, kmax - 8));
    const int rw = (j / 2) * kXWords;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const uint4 v = xplane[rw + nt * 8 + g];
      bh[nt][0] = v.x;
      bh[nt][1] = v.y;
      bl[nt][0] = v.z;
      bl[nt][1] = v.w;
    }
    mma3_tiles<2, 8>(acc, ah, al, bh, bl, mon);
  };
  load_g(0);
  if (kFull || (on[0] && on[1])) {
    // slot 0 (m-tile w) ends first: both slots, then slot 1 alone
    const bool upper[2] = {false, true};
    int k0 = 0;
    for (; k0 < kend[0]; k0 += 8) phase2_step(k0, all);
    for (; k0 < kend[1]; k0 += 8) phase2_step(k0, upper);
  } else {
    for (int k0 = 0; k0 < kmax; k0 += 8) {
      const bool live[2] = {k0 < kend[0], k0 < kend[1]};
      phase2_step(k0, live);
    }
  }

  const bool pairs = P % 2 == 0;
#pragma unroll
  for (int sl = 0; sl < 2; ++sl) {
    if (!on[sl]) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = 16 * mt[sl] + g + 8 * half;
      if (!kFull && i >= Q) continue;
      float* out = y + ((tc + i) * H + h) * P;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int p = p0 + nt * 8 + 2 * t;
        if (!kFull && p >= P) continue;
        const float v0 = acc[sl][nt][2 * half], v1 = acc[sl][nt][2 * half + 1];
        if (kFull || (pairs && p + 1 < P)) {
          *reinterpret_cast<float2*>(out + p) = make_float2(v0, v1);
        } else {
          out[p] = v0;
          if (p + 1 < P) out[p + 1] = v1;
        }
      }
    }
  }
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes, bool max_carveout) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess || !max_carveout) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <bool kFull>
cudaError_t launch_states(dim3 grid, cudaStream_t st, const float* x,
                          const float* bf, const float* cu,
                          const float* init, float* ss, float* final_state,
                          int l, int h, int p, int n, int q) {
  const size_t bytes = sizeof(float) * state_smem_floats();
  cudaError_t err = set_smem(state_kernel<kFull>, bytes, true);
  if (err != cudaSuccess) return err;
  state_kernel<kFull><<<grid, kThreads, bytes, st>>>(
      x, bf, cu, init, ss, final_state, l, h, p, n, q);
  return cudaGetLastError();
}

template <bool kFull>
cudaError_t launch_chunks(dim3 grid, cudaStream_t st, const float* x,
                          const float* cmf, const float* gr, const float* cu,
                          const float* ss, float* y, int l, int h, int p,
                          int n, int q) {
  const size_t bytes = sizeof(float) * chunk_smem_floats(q, n);
  cudaError_t err = set_smem(chunk_kernel<kFull>, bytes, true);
  if (err != cudaSuccess) return err;
  chunk_kernel<kFull><<<grid, kThreads, bytes, st>>>(x, cmf, gr, cu, ss, y, l,
                                                      h, p, n, q);
  return cudaGetLastError();
}

}  // namespace ssd

// Shared memory the largest of the three blocks needs at (q, p, n), in
// bytes: the wrapper refuses a geometry whose tiles exceed what a block
// may use.
extern "C" long long ssd_scan_smem_bytes(int q, int p, int n) {
  (void)p;
  size_t f = ssd::prep_smem_floats(q, n);
  if (ssd::state_smem_floats() > f) f = ssd::state_smem_floats();
  if (ssd::chunk_smem_floats(q, n) > f) f = ssd::chunk_smem_floats(q, n);
  return static_cast<long long>(sizeof(float) * f);
}

// Scratch, all float32 and written before it is read: gram (B, L/Q, Q, Q),
// cum (B, L/Q, H, Q), bfrag (B, L/Q, ceil(Q / 32), ceil(N / 64), 4096),
// states (B, L/Q, H, P, N).  init may be null (S starts at 0);
// final_state may be null (not written).
extern "C" int ssd_scan_fwd(int batch, int l, int h, int p, int n, int q,
                            const void* dtx, const void* log_a,
                            const void* bm, const void* cm, void* gram,
                            void* cum, void* bfrag, void* states,
                            const void* init, void* y, void* final_state,
                            void* stream) {
  if (batch <= 0 || h <= 0 || p <= 0 || n <= 0 || q <= 0 || l <= 0 ||
      l % q != 0 || q > ssd::kMaxQ || p > ssd::kMaxP || batch > 65535 ||
      l / q > 65535 || h > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (ssd_scan_smem_bytes(q, p, n) > static_cast<long long>(ssd::kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const float*>(dtx);
  const auto* a = static_cast<const float*>(log_a);
  const auto* bmf = static_cast<const float*>(bm);
  const auto* cmf = static_cast<const float*>(cm);
  const auto* s0 = static_cast<const float*>(init);
  auto* gr = static_cast<float*>(gram);
  auto* cu = static_cast<float*>(cum);
  auto* ss = static_cast<float*>(states);
  auto* bf = static_cast<float*>(bfrag);
  auto* sf = static_cast<float*>(final_state);
  const int nc = l / q;

  const size_t prep_bytes = sizeof(float) * ssd::prep_smem_floats(q, n);
  cudaError_t err = ssd::set_smem(ssd::prep_kernel, prep_bytes, false);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd::prep_kernel<<<dim3(nc, batch), ssd::kPrepThreads, prep_bytes, st>>>(
      a, bmf, cmf, gr, cu, bf, l, h, n, q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const dim3 sgrid(((n + ssd::kTile - 1) / ssd::kTile)
                       * ((p + ssd::kTile - 1) / ssd::kTile),
                   h, batch);
  const bool full = p % ssd::kTile == 0 && n % ssd::kTile == 0 &&
                    q % ssd::kSlice == 0;
  err = full ? ssd::launch_states<true>(sgrid, st, x, bf, cu, s0, ss, sf, l,
                                        h, p, n, q)
             : ssd::launch_states<false>(sgrid, st, x, bf, cu, s0, ss, sf, l,
                                         h, p, n, q);
  if (err != cudaSuccess) return static_cast<int>(err);

  const dim3 cgrid(h * ((p + ssd::kTile - 1) / ssd::kTile), nc, batch);
  const bool full_chunk = q == ssd::kMaxQ && n % 8 == 0 &&
                          p % ssd::kTile == 0 && ssd::aligned8(cmf);
  err = full_chunk ? ssd::launch_chunks<true>(cgrid, st, x, cmf, gr, cu, ss,
                                              static_cast<float*>(y), l, h, p,
                                              n, q)
                   : ssd::launch_chunks<false>(cgrid, st, x, cmf, gr, cu, ss,
                                               static_cast<float*>(y), l, h,
                                               p, n, q);
  return static_cast<int>(err);
}

// The text of a CUDA error code, for the Python wrapper's messages.
extern "C" const char* rmq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
