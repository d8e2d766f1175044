// Heat-map overlays drawn on the card, up to PNG scanlines.
//
// GenerationExperiment.save_heat_map writes one PNG a word: the word's
// (h, w) map bicubic-resampled to the image's (H, W), min-max normalized,
// coloured by the 256-entry jet table, laid over the photo with the map as
// its weight, rounded to uint8 and PNG-encoded.  On the host that is a
// resample, a float64 numpy composite and Pillow's encoder, whose per-row
// filter choice costs as much as its deflate.  Every step but the deflate is
// parallel work over pixels and rows, so when the experiment's maps were
// made on the card, these two kernels do it there and the host only
// deflates the rows (daam_tpu_torch/png.py):
//
// overlay_resample_kernel: the map, resampled once to (H, W) as
//   F.interpolate(mode='bicubic', align_corners=False) does it on the CPU:
//   source index scale * (dst + 0.5) - 0.5 with scale = h / H, the cubic
//   convolution with A = -0.75 over four taps clamped to the border, the
//   width taps summed first, then the height taps, in fp32 with the
//   multiply-adds that PyTorch's x86 CPU build (GCC, FMA contraction) fuses
//   fused and no others, so each value equals PyTorch's bit for bit (held
//   on the CPU against torch 2.13's AVX-512 kernel); into fp32 scratch,
//   with each block's min and max of it.  A grid-stride loop of at most OV_BLOCKS blocks, so
//   the partial extremes fit a fixed slot at the end of the scratch.
// png_rows_kernel: one block per row y.  Every block reduces the partial
//   extremes itself (no third launch, no atomics), then composites rows
//   y - 1 and y into shared memory (the row above is recomputed, which is
//   cheaper than a grid-wide barrier), then picks y's PNG filter and writes
//   the filtered scanline: the filter type byte and 3W bytes.
//
// The composite reproduces the host route (heatmap.WordHeatMap.expand_as,
// then heatmap._jet_composite, then np.clip(x * 255 + 0.5, 0, 255) and a
// cast to uint8) operation by operation: the normalization (up - min) /
// (max - min + 1e-8) and, under color_normalize, the colour levels
// heat / max(heat) in fp32 (else the clipped heat), the table index
// floor(level * 256) clipped to [0, 255], the photo
// term photo * (1 - w) in fp32, and the jet term, the sum, the clip and the
// scaling in float64, as numpy promotes them against the float64 table.
// Every operation is an explicitly rounded intrinsic, so nvcc contracts
// nothing the host does not.  Where the resample agrees with the host's bit
// for bit, so do the pixels; where a host's PyTorch sums another way, an
// ulp moves a pixel where a table index boundary (by up to one step of the
// table, 4 levels) or a rounding half (1 level) lies between the two.
//
// The filter is chosen as Pillow chooses it for an 8-bit RGB PNG at its
// default settings (libImaging/ZipEncode.c): None, Sub, Up and Paeth are
// tried (Average only under optimize=True), each scored by the sum over
// the row of its bytes read as signed, |v| for v < 128 else 256 - v, and
// the least sum wins, ties going to None, then Up, then Sub, then Paeth.
// The row above the first is zeros.  So the scanlines deflate to what
// Pillow's encoder writes.  With filtered = 0 every row takes None: the raw
// composite, for a caller that draws it itself (matplotlib).  Without a
// resampled map (scratch null) the rows are the image's own bytes, for the
// experiment's output.png.
//
// Cost at 512 x 512: 262,144 resampled pixels (16 taps each) and 512
// blocks of 128 threads over 1,536-byte rows, ~1 MB of fp32 scratch and
// ~0.8 MB of scanlines; a few microseconds of device time, far below the
// copy of the scanlines to the host and the deflate.

#include <math.h>
#include <stdint.h>

#ifndef DAAM_EMULATE
#include <cuda_runtime.h>
#endif
#ifndef DAAM_LAUNCH
#define DAAM_DYNAMIC_SMEM(type, name) extern __shared__ __align__(16) type name[]
#define DAAM_LAUNCH(grid, threads, smem, stream, ...) \
  __VA_ARGS__<<<grid, threads, smem, stream>>>
#endif

namespace {

constexpr int OV_THREADS = 256;   // overlay_resample_kernel
constexpr int OV_BLOCKS = 256;    // its most blocks: the partial extremes' slot
constexpr int ROW_THREADS = 128;  // png_rows_kernel
constexpr int ROW_WARPS = ROW_THREADS / 32;
constexpr int LUT_BYTES = 256 * 3 * 8;  // the jet table, float64
constexpr int RED_BYTES = 128;          // the block's reductions
constexpr int ROW_SMEM_MAX = 227 * 1024;

inline int overlay_blocks(int H, int W) {
  const long long n = ((long long)H * W + OV_THREADS - 1) / OV_THREADS;
  return n < OV_BLOCKS ? (int)n : OV_BLOCKS;
}

inline long long rows_smem_bytes(int W) { return LUT_BYTES + RED_BYTES + 6LL * W; }

// PyTorch's cubic convolution weights (UpSample.h), A = -0.75, with the
// multiply-adds its CPU build fuses fused and the others rounded apart.
__device__ __forceinline__ float cubic1(float x) {  // |x| <= 1
  const float A = -0.75f;
  const float s = __fmaf_rn(A + 2.f, x, -(A + 3.f));
  return __fadd_rn(__fmul_rn(__fmul_rn(s, x), x), 1.f);
}
__device__ __forceinline__ float cubic2(float x) {  // 1 < |x| < 2
  const float A = -0.75f;
  const float s = __fmaf_rn(__fmaf_rn(A, x, -5.f * A), x, 8.f * A);
  return __fsub_rn(__fmul_rn(s, x), 4.f * A);
}

// t0 w0 + t1 w1 + t2 w2 + t3 w3 as PyTorch's CPU build sums it: the second
// product rounded, then three fused multiply-adds.
__device__ __forceinline__ float dot4(const float (&t)[4], const float (&w)[4]) {
  float r = __fmaf_rn(t[0], w[0], __fmul_rn(t[1], w[1]));
  r = __fmaf_rn(t[2], w[2], r);
  return __fmaf_rn(t[3], w[3], r);
}

// The four source indices (clamped to [0, n)) and weights of output index
// `dst` along an axis of n inputs resampled by `scale` = n / out.
__device__ __forceinline__ void cubic_taps(int dst, int n, float scale, int (&idx)[4],
                                           float (&wt)[4]) {
  const float real = __fmaf_rn(scale, __fadd_rn((float)dst, 0.5f), -0.5f);
  const int i0 = min((int)floorf(real), n - 1);
  const float t = fminf(fmaxf(__fsub_rn(real, (float)i0), 0.f), 1.f);
  const float t2 = __fsub_rn(1.f, t);
  wt[0] = cubic2(__fadd_rn(t, 1.f));
  wt[1] = cubic1(t);
  wt[2] = cubic1(t2);
  wt[3] = cubic2(__fadd_rn(t2, 1.f));
#pragma unroll
  for (int j = 0; j < 4; ++j) idx[j] = min(max(i0 - 1 + j, 0), n - 1);
}

__global__ void __launch_bounds__(OV_THREADS)
overlay_resample_kernel(const float* __restrict__ heat, int h, int w, int H, int W,
                        float* __restrict__ up, float* __restrict__ extremes, int n_blocks) {
  DAAM_DYNAMIC_SMEM(float, red);  // [8 warps][min, max]
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const float sy = (float)h / (float)H, sx = (float)w / (float)W;
  float lo = INFINITY, hi = -INFINITY;
  const long long n = (long long)H * W;
  for (long long p = (long long)blockIdx.x * OV_THREADS + tid; p < n;
       p += (long long)n_blocks * OV_THREADS) {
    const int y = (int)(p / W), x = (int)(p % W);
    int iy[4], ix[4];
    float wy[4], wx[4];
    cubic_taps(y, h, sy, iy, wy);
    cubic_taps(x, w, sx, ix, wx);
    float rows[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float* row = heat + (long long)iy[i] * w;
      const float t[4] = {row[ix[0]], row[ix[1]], row[ix[2]], row[ix[3]]};
      rows[i] = dot4(t, wx);
    }
    const float v = dot4(rows, wy);
    up[p] = v;
    lo = fminf(lo, v);
    hi = fmaxf(hi, v);
  }
#pragma unroll
  for (int m = 16; m; m >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, m));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, m));
  }
  if (lane == 0) red[2 * warp] = lo, red[2 * warp + 1] = hi;
  __syncthreads();
  if (tid == 0) {
    for (int i = 1; i < OV_THREADS / 32; ++i) lo = fminf(lo, red[2 * i]), hi = fmaxf(hi, red[2 * i + 1]);
    extremes[2 * blockIdx.x] = lo;
    extremes[2 * blockIdx.x + 1] = hi;
  }
}

// How a resampled value becomes a table index and a weight.
struct Levels {
  bool color, flat;
  float mn, d, hi;
};

__device__ __forceinline__ void composite_row(const uint8_t* __restrict__ image,
                                              const float* __restrict__ up, const double* lut,
                                              const Levels& lv, int y, int W, uint8_t* dst) {
  const uint8_t* src = image + (long long)y * W * 3;
  for (int x = threadIdx.x; x < W; x += ROW_THREADS) {
    if (!up) {
      for (int c = 0; c < 3; ++c) dst[3 * x + c] = src[3 * x + c];
      continue;
    }
    float heat = up[(long long)y * W + x];
    heat = __fdiv_rn(__fsub_rn(heat, lv.mn), lv.d);
    float level;
    if (lv.color) level = lv.flat ? 0.f : __fdiv_rn(heat, lv.hi);
    else level = fminf(fmaxf(heat, 0.f), 1.f);
    const int idx = min(max((int)__fmul_rn(level, 256.f), 0), 255);
    const float wgt = fminf(fmaxf(heat, 0.f), 1.f);
    const float keep = __fsub_rn(1.f, wgt);
    for (int c = 0; c < 3; ++c) {
      const float photo = __fmul_rn(__fdiv_rn((float)src[3 * x + c], 255.f), keep);
      double v = __dadd_rn((double)photo, __dmul_rn(lut[3 * idx + c], (double)wgt));
      v = fmin(fmax(v, 0.0), 1.0);
      const double s = fmin(fmax(__dadd_rn(__dmul_rn(v, 255.0), 0.5), 0.0), 255.0);
      dst[3 * x + c] = (uint8_t)s;
    }
  }
}

// |v| of a filtered byte read as signed, as Pillow scores a filter.
__device__ __forceinline__ int filter_score(int v) {
  v &= 255;
  return v < 128 ? v : 256 - v;
}

__device__ __forceinline__ int paeth(int a, int b, int c) {
  const int pa = abs(b - c), pb = abs(a - c), pc = abs(a + b - 2 * c);
  return (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
}

// Byte i of a row filtered by `f` (0 None, 1 Sub, 2 Up, 4 Paeth), 3 bytes a
// pixel.
__device__ __forceinline__ int filtered_byte(const uint8_t* cur, const uint8_t* prev, int i,
                                             int f) {
  const int x = cur[i], a = i >= 3 ? cur[i - 3] : 0, b = prev[i];
  switch (f) {
    case 1: return x - a;
    case 2: return x - b;
    case 4: return x - paeth(a, b, i >= 3 ? prev[i - 3] : 0);
    default: return x;
  }
}

__global__ void __launch_bounds__(ROW_THREADS)
png_rows_kernel(const uint8_t* __restrict__ image, const float* __restrict__ up,
                const float* __restrict__ extremes, int n_blocks,
                const double* __restrict__ lut, int W, int color_normalize,
                int filtered, uint8_t* __restrict__ out) {
  DAAM_DYNAMIC_SMEM(uint8_t, smem);
  double* lut_s = reinterpret_cast<double*>(smem);
  float* red_f = reinterpret_cast<float*>(smem + LUT_BYTES);          // [warp][min, max]
  int* red_i = reinterpret_cast<int*>(smem + LUT_BYTES + 8 * ROW_WARPS);  // [warp][4 sums]
  uint8_t* cur = smem + LUT_BYTES + RED_BYTES;
  uint8_t* prev = cur + 3 * W;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32, y = blockIdx.x;

  Levels lv{};
  if (up) {
    for (int i = tid; i < 256 * 3; i += ROW_THREADS) lut_s[i] = lut[i];
    float mn = INFINITY, mx = -INFINITY;
    for (int i = tid; i < n_blocks; i += ROW_THREADS)
      mn = fminf(mn, extremes[2 * i]), mx = fmaxf(mx, extremes[2 * i + 1]);
#pragma unroll
    for (int m = 16; m; m >>= 1) {
      mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, m));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, m));
    }
    if (lane == 0) red_f[2 * warp] = mn, red_f[2 * warp + 1] = mx;
    __syncthreads();
    for (int i = 0; i < ROW_WARPS; ++i) mn = fminf(mn, red_f[2 * i]), mx = fmaxf(mx, red_f[2 * i + 1]);
    // expand_as: (up - min) / (max - min + 1e-8); its min maps to 0 and its
    // max to (max - min) / d, as rounding is monotonic; _jet_composite's
    // levels are then (heat - 0) / (hi - 0)
    lv.color = color_normalize;
    lv.mn = mn;
    lv.d = __fadd_rn(__fsub_rn(mx, mn), 1e-8f);
    lv.hi = __fdiv_rn(__fsub_rn(mx, mn), lv.d);
    lv.flat = !(lv.hi > 0.f);
  }
  composite_row(image, up, lut_s, lv, y, W, cur);
  if (y > 0) composite_row(image, up, lut_s, lv, y - 1, W, prev);
  else
    for (int i = tid; i < 3 * W; i += ROW_THREADS) prev[i] = 0;
  __syncthreads();

  int f = 0;
  if (filtered) {
    int s[4] = {0, 0, 0, 0};  // None, Sub, Up, Paeth
    for (int i = tid; i < 3 * W; i += ROW_THREADS) {
      s[0] += filter_score(filtered_byte(cur, prev, i, 0));
      s[1] += filter_score(filtered_byte(cur, prev, i, 1));
      s[2] += filter_score(filtered_byte(cur, prev, i, 2));
      s[3] += filter_score(filtered_byte(cur, prev, i, 4));
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int m = 16; m; m >>= 1) s[k] += __shfl_xor_sync(0xffffffffu, s[k], m);
    if (lane == 0)
      for (int k = 0; k < 4; ++k) red_i[4 * warp + k] = s[k];
    __syncthreads();
    int sum[4] = {0, 0, 0, 0};
    for (int i = 0; i < ROW_WARPS; ++i)
      for (int k = 0; k < 4; ++k) sum[k] += red_i[4 * i + k];
    // the least sum; ties to None, then Up, then Sub, then Paeth
    int best = sum[0];
    if (sum[2] < best) f = 2, best = sum[2];
    if (sum[1] < best) f = 1, best = sum[1];
    if (sum[3] < best) f = 4;
  }
  uint8_t* row = out + (long long)y * (1 + 3LL * W);
  if (tid == 0) row[0] = (uint8_t)f;
  for (int i = tid; i < 3 * W; i += ROW_THREADS) row[1 + i] = (uint8_t)filtered_byte(cur, prev, i, f);
}

}  // namespace

// Plain C interface, bound with ctypes (daam_tpu_torch/ops/kernels.py).  Each
// launcher returns the cudaError_t of its launch (0 on success).

// Floats of scratch daam_overlay_resample writes at an (H, W) image: the
// resampled map, then the partial extremes.
extern "C" long long daam_overlay_scratch_floats(int H, int W) {
  return (long long)H * W + 2LL * OV_BLOCKS;
}

// heat: contiguous fp32 (h, w); scratch: daam_overlay_scratch_floats(H, W)
// floats.
extern "C" int daam_overlay_resample(int device, const float* heat, int h, int w, int H,
                                     int W, float* scratch, void* stream) {
  if (h < 1 || w < 1 || H < 1 || W < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int nb = overlay_blocks(H, W);
  DAAM_LAUNCH(dim3(nb), OV_THREADS, 2 * (OV_THREADS / 32) * sizeof(float),
              static_cast<cudaStream_t>(stream), overlay_resample_kernel)(
      heat, h, w, H, W, scratch, scratch + (long long)H * W, nb);
  return cudaGetLastError();
}

// image: contiguous uint8 (H, W, 3); scratch: what daam_overlay_resample
// wrote at (H, W), or null for the image's own rows; lut: the float64 jet
// table (256, 3); out: (H, 1 + 3W) bytes.  color_normalize: _jet_composite's
// (the map is min-max normalized as expand_as normalizes it); filtered: 0
// writes every row unfiltered.  A W whose two rows do not fit in shared
// memory returns cudaErrorInvalidValue.
extern "C" int daam_png_scanlines(int device, const uint8_t* image, const float* scratch,
                                  const double* lut, int H, int W, int color_normalize,
                                  int filtered, uint8_t* out,
                                  void* stream) {
  const long long smem = rows_smem_bytes(W);
  if (H < 1 || W < 1 || smem > ROW_SMEM_MAX) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(png_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
  }
  const float* extremes = scratch ? scratch + (long long)H * W : nullptr;
  DAAM_LAUNCH(dim3(H), ROW_THREADS, smem, static_cast<cudaStream_t>(stream), png_rows_kernel)(
      image, scratch, extremes, overlay_blocks(H, W), lut, W, color_normalize, filtered, out);
  return cudaGetLastError();
}
