// Peak issue rate of mma.sync on one NVIDIA GPU: m16n8k8 TF32 (the
// instruction of the fp32 3xTF32 kernels in daam_tpu_torch/csrc/attention.cu)
// and m16n8k16 bf16, eight independent accumulators a warp, 256-thread
// blocks, 1, 2 and 4 blocks per SM.  It bounds what 3xTF32 on mma.sync can
// reach: three TF32 products per fp32 product.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o build/mma_sync_rate \
//       scripts/mma_sync_rate.cu && build/mma_sync_rate
#include <cstdio>
#include <cstdint>
#include <cuda_runtime.h>
template <int KIND>
__global__ void __launch_bounds__(256) bench(float* out, int iters) {
  float d[8][4] = {};
  uint32_t a[4] = {threadIdx.x, threadIdx.x * 3u, 7u, 9u}, b0 = threadIdx.x * 5u, b1 = 11u;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (KIND == 0)
        asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                     : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3]) : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
      else
        asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                     : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3]) : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
    }
  }
  float s = 0; for (int j = 0; j < 8; ++j) s += d[j][0] + d[j][1] + d[j][2] + d[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
int main() {
  int sms; cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  float* out; cudaMalloc(&out, sizeof(float) * sms * 4 * 256);
  const int iters = 4096;
  for (int kind = 0; kind < 2; ++kind)
    for (int bps = 1; bps <= 4; bps *= 2) {
      cudaEvent_t e0, e1; cudaEventCreate(&e0); cudaEventCreate(&e1);
      auto launch = [&] { if (kind == 0) bench<0><<<sms * bps, 256>>>(out, iters); else bench<1><<<sms * bps, 256>>>(out, iters); };
      launch(); cudaEventRecord(e0); for (int r = 0; r < 5; ++r) launch(); cudaEventRecord(e1); cudaEventSynchronize(e1);
      float ms; cudaEventElapsedTime(&ms, e0, e1); ms /= 5;
      double flop = 2.0 * 16 * 8 * (kind ? 16 : 8) * 8.0 * iters * (sms * bps * 8.0);
      printf("%s blocks/SM=%d: %.3f ms, %.1f TFLOP/s\n", kind ? "bf16 m16n8k16" : "tf32 m16n8k8", bps, ms, flop / ms / 1e9);
    }
  return 0;
}
