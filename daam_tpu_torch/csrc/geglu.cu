// The UNet feed-forward's GEGLU gate, h * gelu(gate), in one pass.
//
// Replaces no TPU kernel: daam_tpu writes the gate as jnp code
// (models/unet.py, FeedForward), and XLA fuses the split, the fp32 GELU,
// the casts and the product into the projection's consumer.  PyTorch runs
// the same line eagerly as four elementwise passes over the gate in bf16 (a
// strided cast to fp32, the GELU, the cast back, the product with the
// strided h) or two in fp32, each reading and writing the whole gate
// through device memory: 26 bytes an element in bf16, 20 in fp32.
//
// geglu_kernel reads the projection's output once and writes the product
// once: 6 bytes an element in bf16, 12 in fp32.  Far below the card's
// ridge point, it is bound by those bytes at 3.35 TB/s (SDXL's 64² call,
// 8,192 rows of h and gate 2,560 wide: 126 MB, 37.6 us).  So each thread
// moves 16 bytes of h, 16 of the gate and 16 of the output at a time, and
// a grid-stride walk over rows x 16-byte chunks, ~4 a thread, keeps enough
// of them in flight; the erff of each element (~20 instructions) stays
// under the bytes' time.
//
// Input: the contiguous (rows, 2w) projection output, h in columns [0, w)
// and the gate in [w, 2w); output: contiguous (rows, w), the same dtype.
// Per element, the exact-erf GELU as PyTorch writes it
// (ActivationGeluKernel.cu: x * 0.5 * (1 + erf(x * M_SQRT1_2)) in float),
// rounded to the dtype as `.to(h.dtype)` rounds it, then the product in
// float rounded to the dtype, as `h * gelu(gate.float()).to(h.dtype)`
// computes it: the same operations at the same rounding points, so the same
// bits.  Where w is not a multiple of a chunk, or a base is off 16 bytes,
// the walk takes the same arithmetic one element at a time, so every width
// runs the kernel.

#include <stdint.h>

#ifndef DAAM_EMULATE
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#endif
#ifndef DAAM_LAUNCH
#define DAAM_LAUNCH(grid, threads, smem, stream, ...) \
  __VA_ARGS__<<<grid, threads, smem, stream>>>
#endif

namespace {

constexpr int GEGLU_THREADS = 256;
constexpr int GEGLU_CHUNKS_PER_THREAD = 4;  // of the walk, where the grid is not capped
constexpr long long GEGLU_MAX_BLOCKS = 65535;

// PyTorch's exact GELU in float, term for term.
__device__ __forceinline__ float gelu_erf(float g) {
  return g * 0.5f * (1.f + erff(g * 0.70710678118654752440f));
}

__device__ __forceinline__ float geglu_one(float h, float g) { return h * gelu_erf(g); }

__device__ __forceinline__ __nv_bfloat16 geglu_one(__nv_bfloat16 h, __nv_bfloat16 g) {
  const float a = __bfloat162float(__float2bfloat16(gelu_erf(__bfloat162float(g))));
  return __float2bfloat16(__bfloat162float(h) * a);
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// V elements of T a step of the walk: 16 bytes (8 bf16, 4 fp32) where the
// launcher found w a multiple of that and both bases on 16 bytes, else 1.
// (A 16-byte chunk past the first row cannot be aligned where the first is
// not: each row starts 2w elements after the last and each gate w after its
// h, so one test of the bases and of w decides every chunk.)
template <typename T, int V>
__global__ void __launch_bounds__(GEGLU_THREADS)
geglu_kernel(const T* __restrict__ x, T* __restrict__ out, int rows, int w, int n_blocks) {
  const unsigned chunks = (unsigned)w / V;  // a row's
  const long long total = (long long)rows * chunks;
  for (long long i = (long long)blockIdx.x * GEGLU_THREADS + threadIdx.x; i < total;
       i += (long long)n_blocks * GEGLU_THREADS) {
    const unsigned r = (unsigned)i / chunks;  // total < 2^31: the entry point's bound
    const int c = (int)((unsigned)i - r * chunks) * V;
    const T* hp = x + 2LL * w * r + c;
    const T* gp = hp + w;
    T* op = out + (long long)w * r + c;
    if constexpr (V == 1) {
      *op = geglu_one(*hp, *gp);
    } else {
      const uint4 hv = *reinterpret_cast<const uint4*>(hp);
      const uint4 gv = *reinterpret_cast<const uint4*>(gp);
      uint4 ov;
      const T* he = reinterpret_cast<const T*>(&hv);
      const T* ge = reinterpret_cast<const T*>(&gv);
      T* oe = reinterpret_cast<T*>(&ov);
#pragma unroll
      for (int j = 0; j < V; ++j) oe[j] = geglu_one(he[j], ge[j]);
      *reinterpret_cast<uint4*>(op) = ov;
    }
  }
}

template <typename T, int V>
int launch_geglu(const void* x, void* out, int rows, int w, cudaStream_t stream) {
  const long long chunks = (long long)rows * (w / V);
  const long long per_block = (long long)GEGLU_THREADS * GEGLU_CHUNKS_PER_THREAD;
  const long long want = (chunks + per_block - 1) / per_block;
  const int blocks = (int)(want < GEGLU_MAX_BLOCKS ? want : GEGLU_MAX_BLOCKS);
  DAAM_LAUNCH(dim3(blocks), GEGLU_THREADS, 0, stream, geglu_kernel<T, V>)(
      static_cast<const T*>(x), static_cast<T*>(out), rows, w, blocks);
  return cudaGetLastError();
}

template <typename T>
int launch_geglu(const void* x, void* out, int rows, int w, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  if (w % V == 0 && aligned16(x) && aligned16(out))
    return launch_geglu<T, V>(x, out, rows, w, stream);
  return launch_geglu<T, 1>(x, out, rows, w, stream);
}

}  // namespace

// Plain C interface, bound with ctypes (daam_tpu_torch/ops/kernels.py).
// dtype: 0 float32, 1 bfloat16.  x: contiguous (rows, 2w); out: contiguous
// (rows, w).  Returns the cudaError_t of the launch (0 on success);
// cudaErrorInvalidValue for an unknown dtype, an empty shape, or rows * 2w
// past 2^31 - 1 elements.
extern "C" int daam_geglu(int device, int dtype, const void* x, void* out, int rows, int w,
                          void* stream) {
  if (rows < 1 || w < 1 || (dtype != 0 && dtype != 1) || 2LL * rows * w > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype ? launch_geglu<__nv_bfloat16>(x, out, rows, w, s)
               : launch_geglu<float>(x, out, rows, w, s);
}
