// Throughput of mma.sync on one card: m16n8k8 with TF32 operands (the
// tensor-core instruction of the SSD chunk scan, csrc/ssd_scan.cu) and
// m16n8k16 with bf16 operands, float32 accumulators.  Each warp issues 8
// independent MMAs per iteration, so the tensor pipe, not a chain, sets
// the rate.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o mma_rate tools/mma_rate.cu
//   ./mma_rate

#include <cstdio>
#include <cstdint>
#include <cuda_runtime.h>
template <int KIND>
__global__ void bench(float* out, int iters) {
  float acc[8][4] = {};
  uint32_t a[4] = {threadIdx.x, threadIdx.x + 1, threadIdx.x + 2, threadIdx.x + 3};
  uint32_t b0 = threadIdx.x * 3, b1 = threadIdx.x * 5;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (KIND == 0)
        asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(acc[k][0]), "+f"(acc[k][1]), "+f"(acc[k][2]), "+f"(acc[k][3]) : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
      else
        asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(acc[k][0]), "+f"(acc[k][1]), "+f"(acc[k][2]), "+f"(acc[k][3]) : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
    }
  }
  float s = 0; for (int k = 0; k < 8; ++k) s += acc[k][0] + acc[k][1] + acc[k][2] + acc[k][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
int main() {
  float* out; cudaMalloc(&out, 132 * 16 * 512 * 4);
  for (int kind = 0; kind < 2; ++kind)
  for (int warps = 4; warps <= 16; warps *= 2) {
    int iters = 4096, blocks = 132 * 4;
    cudaEvent_t a, b; cudaEventCreate(&a); cudaEventCreate(&b);
    for (int rep = 0; rep < 2; ++rep) {
      cudaEventRecord(a);
      if (kind == 0) bench<0><<<blocks, 32 * warps>>>(out, iters); else bench<1><<<blocks, 32 * warps>>>(out, iters);
      cudaEventRecord(b); cudaEventSynchronize(b);
    }
    float ms; cudaEventElapsedTime(&ms, a, b);
    double mmas = (double)blocks * warps * iters * 8;
    double flop = mmas * (kind == 0 ? 2.0 * 16 * 8 * 8 : 2.0 * 16 * 8 * 16);
    printf("%s warps/block %d: %.3f ms, %.1f G mma/s, %.1f TFLOP/s\n", kind == 0 ? "tf32 m16n8k8" : "bf16 m16n8k16", warps, ms, mmas / ms / 1e6, flop / ms / 1e9);
  }
  return 0;
}
