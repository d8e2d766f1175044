// Hand-written Hopper (sm_90a) kernels for the traced DAAM attention path.
//
// flash_attention replaces daam_tpu/ops/pallas_attention.py
//   flash_self_attention (pallas_call at :169; body _self_attn_kernel :124 and
//   _attend_one_head :61) together with its packed-layout twin
//   flash_self_attention_packed (:322; body _self_attn_packed_kernel :220).
// cross_attention_acc replaces cross_attention_acc (:517; body
//   _cross_attn_acc_kernel :452) together with cross_attention_acc_packed
//   (:618; body _cross_attn_acc_packed_kernel :548); cross_attention_probs
//   replaces cross_attention_probs (:405).
//
// The packed Pallas twins exist only because a TPU block must span 128
// lanes.  Here q, k and v are read as (B, L, H, hd) views through three
// element strides each (the hd stride must be 1), so one kernel serves both
// the head-major (B, H, L, hd) tensors and the (B, L, H*hd) projection
// output without a relayout copy.  o is written as (B, Lq, H*hd), ready for
// to_out.  Storage is float or bf16; scale is hd^-1/2, passed in by the
// caller.
//
// What bounds them on an H100, and what the design does about it:
//
// * flash_attention is compute bound at the main path's shapes: the
//   64x64-latent self-attention (B=2, H=5, L=4096, hd=64) does
//   4*B*H*L*L*hd = 42.9 GFLOP against ~10 MB of bf16 q/k/v/o, and one UNet
//   evaluation's K2 launches add up to ~248 GFLOP.  Only the tensor cores
//   (989 TFLOP/s dense bf16) make that cheap, so bf16 goes to
//   flash_attention_wgmma_kernel, as FlashAttention-3 is built:
//   - one block owns (b, h, 128 queries): two consumer warpgroups of 64
//     query rows each, and a producer warpgroup that gives its registers
//     away (setmaxnreg) and keeps one thread issuing TMA loads;
//   - TMA copies the q tile once and streams 128-key k and v tiles through
//     a two-stage ring in shared memory (mbarriers mark full and empty
//     stages), over 4-D tensor maps of the (B, L, H, hd) views encoded per
//     call; rows are swizzled to 128 bytes (64-column panels; 64 or 32
//     bytes for hd 32 and 16), and rows past L arrive as zeros;
//   - S = Q K^T is one wgmma m64n128k16 per 16 of hd, both operands read
//     from shared memory (K-major: hd is contiguous);
//   - the online softmax runs on the fp32 S fragment in registers (row max
//     and sum over the 4 lanes that share a row, exp2 with the scale folded
//     in, keys past Lk set to -inf); unnormalized P = exp(s - m) is rounded
//     to bf16, as the Pallas body rounds it before PV, and since the S
//     fragment of 16 keys is laid out as the A fragment of a k16 step, P
//     never leaves registers: O += P V is wgmma m64n(hd)k16 with A from
//     registers and V from shared memory as a transposed (MN-major) B;
//   - O is divided by the row sum at the end and stored (B, Lq, H*hd).
//   It serves hd 16, 32, 64 and 128.  fp32 stays on flash_attention_kernel,
//   on the CUDA cores: on the tensor cores fp32 would be TF32 and miss the
//   fp32 gate of 1e-4.  That kernel gives each query four threads that keep
//   q and the output in registers and stream keys and values through
//   shared memory 32 rows at a time with the same online softmax; it took
//   3.86 ms at (2, 5, 4096, 4096) in bf16 (11.1 TFLOP/s) before bf16 moved
//   to the tensor cores.  On an H100 80GB HBM3 at a 700 W power limit the
//   wgmma kernel takes 0.130 ms at (2, 5, 4096, 4096) (330 TFLOP/s, a third
//   of the bf16 peak: each warpgroup's exp2 and its products take turns),
//   against 2.17 ms for the plain PyTorch version, and 0.90 ms of device
//   time over one UNet evaluation's K2 launches.
// * cross_attention_acc (K1, the DAAM capture) and cross_attention_probs
//   (K5, replacing cross_attention_probs :405; body _cross_attn_kernel
//   :347, the 'full'/'cond' capture behind save_heads) are memory bound.
//   K1 reads q and read-modify-writes the fp32 accumulator (Lk*Lq*4 bytes
//   each way): 17.96 MB at (1, 5, 4096, 77), 5.36 us at 3.35 TB/s, against
//   0.4 GFLOP.  K5 writes P as (B, H, Lq, Lk) in fp32 or bf16 instead:
//   12.6 MB of fp32 P at (2, 5, 4096, 77).  bf16 runs on the tensor cores,
//   in one kernel with two epilogues, cross_attention_mma_kernel:
//   - a 128-thread block owns (b, h, 64 queries), 16 per warp; cp.async
//     copies its q rows and all of k and v (bf16 rows padded to hd + 8, so
//     ldmatrix reads conflict-free) into shared memory, and, for K1, the
//     acc tile acc[b, h, 0:Lk, q0:q0+64] in a second group that lands
//     while the scores and P.V run: one bulk read and one 16-byte-store
//     write per element, where the CUDA-core kernel did Lk dependent
//     read-modify-writes per thread.  No atomics: each acc element belongs
//     to one block, so the sum is deterministic;
//   - S = Q K^T and O = P V are mma.sync m16n8k16 (bf16 in, fp32 out),
//     operands by ldmatrix (V transposed), P straight from the S fragment,
//     whose keys 16u .. 16u + 15 are the A fragment of the u-th k16 step;
//   - keys go in chunks of 80, so Lk = 77 is one chunk: its scores stay in
//     registers and the softmax is exact in one pass (row max and sum over
//     the 4 lanes of a quad, exp2 with the scale folded in, keys past Lk
//     at -inf, k and v rows past Lk zero-filled).  A longer Lk takes two
//     passes, the second recomputing each chunk's scores;
//   - P is normalized in fp32 and rounded to bf16 for P.V, as the Pallas
//     bodies do (:480, :369); the fp32 value goes into the accumulator or
//     P.  K1 adds it into the staged acc tile ([key][query], row stride 68
//     floats: a warp's 32 adds hit 32 banks) and writes the tile back.  K5
//     stages the block's P rows, one contiguous span of the output, at the
//     span's own alignment mod 16 bytes and writes it with 16-byte stores
//     (scalar ones for the head and tail); with cond_only (CFG layout
//     [uncond; cond]) blocks of the first B/2 samples skip it uniformly;
//   - each warp stages its 16 output rows in its own rows of the q tile and
//     stores O (B, Lq, H*hd) with 16-byte stores.
//   fp32 stays on cross_attention_acc_kernel and cross_attention_probs_kernel,
//   on the CUDA cores, by design: on the tensor cores fp32 would be TF32 and
//   miss the 1e-5 accumulator and 1e-4 output gates.  They give each query
//   one thread, stage k and v as fp32 and make two passes over the tokens;
//   K5 stages its 64 P rows in shared memory and writes them as one span.
//   On an H100 80GB HBM3 at a 700 W power limit the CUDA-core K1 took
//   0.073 ms at (1, 5, 4096, 77) in bf16, 7% of its bound, before bf16
//   moved to the tensor cores.
//
// No kernel synchronizes with the host or allocates memory; the
// Python wrapper (daam_tpu_torch/ops/kernels.py) checks shapes, strides and
// types, allocates o, and raises on the error code each entry point returns.
//
// tests/torch_emulate/warp.h runs the CUDA-core kernels and
// cross_attention_mma_kernel on the CPU: it defines DAAM_EMULATE, stands in
// for the CUDA headers and hopper.cuh's cp.async, ldmatrix and mma.sync, and
// defines the three macros below its own way.  The TMA and wgmma pieces
// (flash_attention_wgmma_kernel) are left out there.

#include <math.h>
#include <stdio.h>

#include <cstdint>

#ifndef DAAM_EMULATE
#include <cuda.h>  // CUtensorMap and its enums; the driver is reached at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

// y = 2^x, approximate (2 ulp), flushing denormals.
#define DAAM_EX2(y, x) asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x))
// The block's dynamic shared memory as an array `name` of `type`.
#define DAAM_DYNAMIC_SMEM(type, name) extern __shared__ __align__(16) type name[]
// DAAM_LAUNCH(grid, threads, smem, stream, kernel)(arguments...)
#define DAAM_LAUNCH(grid, threads, smem, stream, ...) \
  __VA_ARGS__<<<grid, threads, smem, stream>>>
#endif

namespace {

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Element strides of a (B, L, H, hd) view; the hd stride is 1.
struct Strides {
  long long b, l, h;
};

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

__device__ __forceinline__ void fma4(float4& acc, float p, float4 v) {
  acc.x += p * v.x;
  acc.y += p * v.y;
  acc.z += p * v.z;
  acc.w += p * v.w;
}

__device__ __forceinline__ float4 load4(const float* p) {
  return make_float4(p[0], p[1], p[2], p[3]);
}

__device__ __forceinline__ void store4(float* p, float4 v, float s) {
  p[0] = v.x * s;
  p[1] = v.y * s;
  p[2] = v.z * s;
  p[3] = v.w * s;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  DAAM_EX2(y, x);
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// flash_attention
// ---------------------------------------------------------------------------

constexpr int FA_BQ = 64;   // queries per block
constexpr int FA_TPQ = 4;   // threads per query
constexpr int FA_BK = 32;   // keys staged per tile
constexpr int FA_THREADS = FA_BQ * FA_TPQ;

// fp32 only: bf16 runs on the tensor cores (flash_attention_wgmma_kernel).
template <int HD>
__global__ void __launch_bounds__(FA_THREADS)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o, int H,
                       int Lq, int Lk, Strides qs, Strides ks, Strides vs,
                       float scale) {
  constexpr int C4 = HD / 16;  // float4 chunks per thread
  __shared__ float4 Ks[FA_BK][HD / 4];
  __shared__ float4 Vs[FA_BK][HD / 4];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int r = tid % FA_TPQ;
  const int qi = blockIdx.x * FA_BQ + tid / FA_TPQ;
  const bool valid = qi < Lq;

  // Thread r holds chunks c = r + FA_TPQ * i, i.e. dims 4c .. 4c + 3.
  float4 qr[C4], acc[C4];
  const float* qrow = q + b * qs.b + (long long)(valid ? qi : 0) * qs.l + h * qs.h;
#pragma unroll
  for (int i = 0; i < C4; ++i) {
    qr[i] = load4(qrow + 4 * (r + FA_TPQ * i));
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = -INFINITY;
  float l = 0.f;

  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;
  float* ksf = reinterpret_cast<float*>(&Ks[0][0]);
  float* vsf = reinterpret_cast<float*>(&Vs[0][0]);

  for (int k0 = 0; k0 < Lk; k0 += FA_BK) {
    __syncthreads();  // the previous tile is fully consumed
    for (int e = tid; e < FA_BK * HD; e += FA_THREADS) {
      const int row = e / HD;
      const int col = e % HD;
      const int key = k0 + row;
      float kv = 0.f, vv = 0.f;
      if (key < Lk) {
        kv = kb[key * ks.l + col];
        vv = vb[key * vs.l + col];
      }
      ksf[e] = kv;
      vsf[e] = vv;
    }
    __syncthreads();

    float s[FA_BK];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < FA_BK; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < C4; ++i) part += dot4(qr[i], Ks[j][r + FA_TPQ * i]);
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      s[j] = (k0 + j < Lk) ? part * scale : -INFINITY;
      tile_max = fmaxf(tile_max, s[j]);
    }
    // The first tile always holds key 0, so m_new is finite from here on and
    // corr is exactly 0 on the first tile (m = -inf).
    const float m_new = fmaxf(m, tile_max);
    const float corr = __expf(m - m_new);
    l *= corr;
#pragma unroll
    for (int i = 0; i < C4; ++i) {
      acc[i].x *= corr;
      acc[i].y *= corr;
      acc[i].z *= corr;
      acc[i].w *= corr;
    }
#pragma unroll
    for (int j = 0; j < FA_BK; ++j) {
      const float p = __expf(s[j] - m_new);  // masked keys give exactly 0
      l += p;
#pragma unroll
      for (int i = 0; i < C4; ++i) fma4(acc[i], p, Vs[j][r + FA_TPQ * i]);
    }
    m = m_new;
  }

  if (valid) {
    const float inv = 1.f / l;
    float* orow = o + ((long long)b * Lq + qi) * (H * HD) + h * HD;
#pragma unroll
    for (int i = 0; i < C4; ++i) store4(orow + 4 * (r + FA_TPQ * i), acc[i], inv);
  }
}

// ---------------------------------------------------------------------------
// flash_attention, bf16, on the tensor cores (wgmma + TMA)
// ---------------------------------------------------------------------------

constexpr int TC_BQ = 128;        // queries per block: 64 per consumer warpgroup
constexpr int TC_BK = 128;        // keys per tile
constexpr int TC_STAGES = 2;      // depth of the K/V ring in shared memory
constexpr int TC_THREADS = 384;   // warpgroups 0 and 1 compute, 2 loads
static_assert(TC_BQ == TC_BK, "one TMA box shape serves q, k and v");

// Shared-memory tiles hold rows of hd bf16 values in panels of PW columns,
// PW * 2 bytes = the swizzle span (128, 64 or 32 bytes), so hd = 128 is two
// 64-column panels and each panel is one TMA box.
template <int HD>
struct TcTile {
  static constexpr int PW = HD < 64 ? HD : 64;
  static constexpr int NP = HD / PW;
  static constexpr int ROW = PW * 2;                 // bytes of a panel row
  static constexpr uint32_t LAYOUT = PW == 64 ? 1 : PW == 32 ? 2 : 3;
  static constexpr int PANEL = TC_BK * ROW;          // bytes of one panel
  static constexpr int BYTES = NP * PANEL;           // one q, k or v tile
  static constexpr int SMEM = 1024 + (1 + 2 * TC_STAGES) * BYTES + 8 * (1 + 2 * TC_STAGES);
};

#ifndef DAAM_EMULATE
template <int HD>
__global__ void __launch_bounds__(TC_THREADS, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             __nv_bfloat16* __restrict__ o, int H, int Lq,
                             int Lk, float scale_log2) {
  using namespace hopper;
  using T = TcTile<HD>;
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzle repeats every 1024 bytes; tiles start on that boundary.
  const uint32_t q_s = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t k_s = q_s + T::BYTES;                  // + stage * T::BYTES
  const uint32_t v_s = k_s + TC_STAGES * T::BYTES;
  const uint32_t q_full = v_s + TC_STAGES * T::BYTES;
  const uint32_t kv_full = q_full + 8;                  // + 8 * stage
  const uint32_t kv_empty = kv_full + 8 * TC_STAGES;    // + 8 * stage

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * TC_BQ;
  const int n_tiles = (Lk + TC_BK - 1) / TC_BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < TC_STAGES; ++s) {
      mbar_init(kv_full + 8 * s, 1);
      mbar_init(kv_empty + 8 * s, 8);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // Producer: one thread keeps the next K/V tile in flight.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      mbar_arrive_expect_tx(q_full, T::BYTES);
      for (int p = 0; p < T::NP; ++p)
        tma_load_4d(q_s + p * T::PANEL, &tq, q_full, p * T::PW, q0, h, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % TC_STAGES;
        mbar_wait(kv_empty + 8 * s, ((t / TC_STAGES) & 1) ^ 1);
        const uint32_t full = kv_full + 8 * s;
        mbar_arrive_expect_tx(full, 2 * T::BYTES);
        for (int p = 0; p < T::NP; ++p) {
          const uint32_t off = s * T::BYTES + p * T::PANEL;
          tma_load_4d(k_s + off, &tk, full, p * T::PW, t * TC_BK, h, b);
          tma_load_4d(v_s + off, &tv, full, p * T::PW, t * TC_BK, h, b);
        }
      }
    }
  } else {
    // Consumers: warpgroup wg owns queries q0 + 64 wg .. + 63.  In the
    // accumulator fragments a thread holds rows r and r + 8 (r = 16 warp +
    // lane / 4) and, per 8-column chunk j, columns 8 j + 2 (lane % 4) + {0, 1}:
    // element 4 j + e is row r + 8 (e / 2), column 8 j + 2 (lane % 4) + e % 2.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int lane = threadIdx.x % 32;
    const int warp = (threadIdx.x % 128) / 32;
    const int quad = lane % 4;
    const uint32_t q_wg = q_s + wg * 64 * T::ROW;

    float oacc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) oacc[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY;  // running max, log2 domain
    float l0 = 0.f, l1 = 0.f;              // this thread's share of the sums

    mbar_wait(q_full, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % TC_STAGES;
      const uint32_t k_t = k_s + s * T::BYTES;
      const uint32_t v_t = v_s + s * T::BYTES;
      mbar_wait(kv_full + 8 * s, (t / TC_STAGES) & 1);

      // S = Q Kᵀ: q and k rows are K-major (hd contiguous); step 16 of hd
      // at a time, 32 bytes along the swizzled row of a panel.
      float sacc[TC_BK / 2];
#pragma unroll
      for (int i = 0; i < TC_BK / 2; ++i) sacc[i] = 0.f;
      fence_regs(sacc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = (kk / (T::PW / 16)) * T::PANEL + (kk % (T::PW / 16)) * 32;
        wgmma_m64n128k16_ss(sacc, make_desc(q_wg + off, 16, 8 * T::ROW, T::LAYOUT),
                            make_desc(k_t + off, 16, 8 * T::ROW, T::LAYOUT), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sacc);

      // Keys past Lk were zero-filled by TMA, which scores 0, not -inf.
      if ((t + 1) * TC_BK > Lk) {
        const int col0 = t * TC_BK + 2 * quad;
#pragma unroll
        for (int j = 0; j < TC_BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (col0 + 8 * j + (e & 1) >= Lk) sacc[4 * j + e] = -INFINITY;
      }

      // Online softmax over the tile, rows reduced across the 4 lanes of a quad.
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < TC_BK / 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(sacc[4 * j], sacc[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(sacc[4 * j + 2], sacc[4 * j + 3]));
      }
#pragma unroll
      for (int x = 1; x < 4; x <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
      }
      // Key 0 lies in the first tile, so the new max is finite and the
      // correction of the first tile is exp2(-inf) = 0.
      const float mn0 = fmaxf(m0, mx0 * scale_log2);
      const float mn1 = fmaxf(m1, mx1 * scale_log2);
      const float c0 = ex2(m0 - mn0), c1 = ex2(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      l0 *= c0;
      l1 *= c1;

      // Unnormalized P = exp(s - m), summed in fp32 and rounded to bf16 for
      // the PV product, as the Pallas body does.  The S fragment of keys
      // 16 u .. 16 u + 15 is the A fragment of the u-th k16 step of PV.
      uint32_t pa[TC_BK / 16][4];
#pragma unroll
      for (int u = 0; u < TC_BK / 16; ++u) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int j = 2 * u + half;
          const float p00 = ex2(fmaf(sacc[4 * j], scale_log2, -mn0));
          const float p01 = ex2(fmaf(sacc[4 * j + 1], scale_log2, -mn0));
          const float p10 = ex2(fmaf(sacc[4 * j + 2], scale_log2, -mn1));
          const float p11 = ex2(fmaf(sacc[4 * j + 3], scale_log2, -mn1));
          l0 += p00 + p01;
          l1 += p10 + p11;
          pa[u][2 * half] = pack_bf16(p00, p01);
          pa[u][2 * half + 1] = pack_bf16(p10, p11);
        }
      }
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        oacc[4 * j] *= c0;
        oacc[4 * j + 1] *= c0;
        oacc[4 * j + 2] *= c1;
        oacc[4 * j + 3] *= c1;
      }

      // O += P V: v rows are MN-major for this product (hd contiguous), so
      // the transposed-B form; a k16 step is 16 key rows further on, and
      // the panels of hd = 128 lie T::PANEL bytes apart along N.
      fence_regs(oacc);
      wgmma_fence();
#pragma unroll
      for (int u = 0; u < TC_BK / 16; ++u)
        wgmma_rs_tb<HD>(oacc, pa[u],
                        make_desc(v_t + u * 16 * T::ROW, T::PANEL, 8 * T::ROW, T::LAYOUT));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(oacc);

      __syncwarp();
      if (lane == 0) mbar_arrive(kv_empty + 8 * s);  // this warp is done with stage s
    }

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
    const int r = q0 + wg * 64 + warp * 16 + lane / 4;
    const long long row = (long long)H * HD;
    __nv_bfloat16* ob = o + (long long)b * Lq * row + h * HD + 2 * quad;
    if (r < Lq) {
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<uint32_t*>(ob + r * row + 8 * j) =
            pack_bf16(oacc[4 * j] * inv0, oacc[4 * j + 1] * inv0);
    }
    if (r + 8 < Lq) {
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<uint32_t*>(ob + (r + 8) * row + 8 * j) =
            pack_bf16(oacc[4 * j + 2] * inv1, oacc[4 * j + 3] * inv1);
    }
  }
}
#endif  // DAAM_EMULATE

// ---------------------------------------------------------------------------
// cross_attention_acc and cross_attention_probs, fp32, on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int CA_THREADS = 64;  // queries per block, one thread each

template <int HD>
__global__ void __launch_bounds__(CA_THREADS)
cross_attention_acc_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
                           float* __restrict__ acc, int H, int Lq, int Lk,
                           Strides qs, Strides ks, Strides vs, float scale) {
  constexpr int C4 = HD / 4;
  DAAM_DYNAMIC_SMEM(float4, smem);
  float4* Ks = smem;            // [Lk][HD / 4]
  float4* Vs = smem + Lk * C4;  // [Lk][HD / 4]

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int qi = blockIdx.x * CA_THREADS + tid;

  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;
  float* ksf = reinterpret_cast<float*>(Ks);
  float* vsf = reinterpret_cast<float*>(Vs);
  for (int e = tid; e < Lk * HD; e += CA_THREADS) {
    const int row = e / HD;
    const int col = e % HD;
    ksf[e] = kb[row * ks.l + col];
    vsf[e] = vb[row * vs.l + col];
  }
  __syncthreads();
  if (qi >= Lq) return;  // after the block's only barrier

  float4 qr[C4];
  const float* qrow = q + b * qs.b + (long long)qi * qs.l + h * qs.h;
#pragma unroll
  for (int c = 0; c < C4; ++c) qr[c] = load4(qrow + 4 * c);

  // Pass 1: running max and sum of exp over the tokens.
  float m = -INFINITY;
  float l = 0.f;
  for (int t = 0; t < Lk; ++t) {
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < C4; ++c) s += dot4(qr[c], Ks[t * C4 + c]);
    s *= scale;
    const float m_new = fmaxf(m, s);
    l = l * __expf(m - m_new) + __expf(s - m_new);
    m = m_new;
  }
  const float inv_l = 1.f / l;

  // Pass 2: normalized P into the accumulator column and into P.V.
  float4 oacc[C4];
#pragma unroll
  for (int c = 0; c < C4; ++c) oacc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  float* acc_col = acc + ((long long)b * H + h) * Lk * Lq + qi;
  for (int t = 0; t < Lk; ++t) {
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < C4; ++c) s += dot4(qr[c], Ks[t * C4 + c]);
    const float p = __expf(s * scale - m) * inv_l;
    acc_col[(long long)t * Lq] += p;
#pragma unroll
    for (int c = 0; c < C4; ++c) fma4(oacc[c], p, Vs[t * C4 + c]);
  }

  float* orow = o + ((long long)b * Lq + qi) * (H * HD) + h * HD;
#pragma unroll
  for (int c = 0; c < C4; ++c) store4(orow + 4 * c, oacc[c], 1.f);
}

template <typename PT, int HD>
__global__ void __launch_bounds__(CA_THREADS)
cross_attention_probs_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, float* __restrict__ o,
                             PT* __restrict__ p, int H, int Lq, int Lk,
                             int skip_b, Strides qs, Strides ks, Strides vs,
                             float scale) {
  constexpr int C4 = HD / 4;
  DAAM_DYNAMIC_SMEM(float4, smem);
  float4* Ks = smem;                                   // [Lk][HD / 4]
  float4* Vs = smem + Lk * C4;                         // [Lk][HD / 4]
  float* Ps = reinterpret_cast<float*>(smem + 2 * Lk * C4);  // [64][Lk]

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * CA_THREADS;
  const int qi = q0 + tid;
  const bool valid = qi < Lq;

  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;
  float* ksf = reinterpret_cast<float*>(Ks);
  float* vsf = reinterpret_cast<float*>(Vs);
  for (int e = tid; e < Lk * HD; e += CA_THREADS) {
    const int row = e / HD;
    const int col = e % HD;
    ksf[e] = kb[row * ks.l + col];
    vsf[e] = vb[row * vs.l + col];
  }
  __syncthreads();

  if (valid) {
    float4 qr[C4];
    const float* qrow = q + b * qs.b + (long long)qi * qs.l + h * qs.h;
#pragma unroll
    for (int c = 0; c < C4; ++c) qr[c] = load4(qrow + 4 * c);

    // Pass 1: running max and sum of exp over the tokens.
    float m = -INFINITY;
    float l = 0.f;
    for (int t = 0; t < Lk; ++t) {
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < C4; ++c) s += dot4(qr[c], Ks[t * C4 + c]);
      s *= scale;
      const float m_new = fmaxf(m, s);
      l = l * __expf(m - m_new) + __expf(s - m_new);
      m = m_new;
    }
    const float inv_l = 1.f / l;

    // Pass 2: normalized P into the staging row and into P.V.
    float4 oacc[C4];
#pragma unroll
    for (int c = 0; c < C4; ++c) oacc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
    float* prow = Ps + tid * Lk;
    for (int t = 0; t < Lk; ++t) {
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < C4; ++c) s += dot4(qr[c], Ks[t * C4 + c]);
      const float pt = __expf(s * scale - m) * inv_l;
      prow[t] = pt;
#pragma unroll
      for (int c = 0; c < C4; ++c) fma4(oacc[c], pt, Vs[t * C4 + c]);
    }

    float* orow = o + ((long long)b * Lq + qi) * (H * HD) + h * HD;
#pragma unroll
    for (int c = 0; c < C4; ++c) store4(orow + 4 * c, oacc[c], 1.f);
  }

  if (b < skip_b) return;  // block-uniform: no thread waits at the barrier
  __syncthreads();
  // The block's rows q0 .. q0 + rows - 1 are one contiguous span of P.
  const int n = min(CA_THREADS, Lq - q0) * Lk;
  PT* span = p + (((long long)b * H + h) * Lq + q0) * Lk;
  for (int e = tid; e < n; e += CA_THREADS) span[e] = from_f<PT>(Ps[e]);
}

// ---------------------------------------------------------------------------
// cross_attention_acc and cross_attention_probs, bf16, on the tensor cores
// ---------------------------------------------------------------------------

constexpr int MA_BQ = 64;             // queries per block: 16 per warp
constexpr int MA_THREADS = 128;
constexpr int MA_KC = 80;             // keys per chunk: Lk = 77 is one chunk
constexpr int MA_NT = MA_KC / 8;      // n8 tiles of a chunk's scores
constexpr int MA_ASTR = MA_BQ + 4;    // fp32 row stride of the acc tile

// Dynamic shared memory of a block: the q tile and all of k and v in bf16
// rows of hd + 8 elements (the 16-byte pad sends the eight rows an ldmatrix
// reads to eight different bank groups), then the epilogue's tile: one
// chunk of acc rows (p_size 0), or the block's span of P with up to 16
// bytes of lead (p_size = sizeof P's type).
inline long long ma_smem_bytes(int hd, long long Lk, int p_size) {
  const long long lkp = (Lk + 15) & ~15LL;
  const long long qkv = (MA_BQ + 2 * lkp) * (hd + 8) * 2;
  if (p_size == 0) return qkv + (Lk < MA_KC ? Lk : MA_KC) * MA_ASTR * 4;
  return qkv + (((MA_BQ * Lk + 16 / p_size) * p_size + 15) & ~15LL);
}

// Scores of keys c0 .. c0 + MA_KC - 1 for the warp's 16 queries, in the
// log2 domain (s * scale * log2 e), keys past Lk at -inf.  The fragment is
// mma's D layout: s[j] holds rows g and g + 8 (g = lane / 4) at keys
// c0 + 8 j + 2 (lane % 4) + {0, 1}.
template <int HD>
__device__ __forceinline__ void ma_scores(float (&s)[MA_NT][4],
                                          const uint32_t (&qf)[HD / 16][4],
                                          const __nv_bfloat16* Ks, int c0, int lkp,
                                          int Lk, float scale_log2, int lane) {
  using namespace hopper;
#pragma unroll
  for (int j = 0; j < MA_NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int jp = 0; jp < MA_NT / 2; ++jp) {
    const int key0 = c0 + 16 * jp;
    if (key0 < lkp) {
      // matrices: keys key0 + {0..7, 8..15} x hd {lo, hi} of the k16 step
      const __nv_bfloat16* row =
          Ks + (key0 + 8 * (lane / 16) + lane % 8) * (HD + 8) + 8 * ((lane / 8) % 2);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t kb[4];
        ldmatrix_x4(kb, smem_u32(row + 16 * kk));
        mma_m16n8k16(s[2 * jp], qf[kk], kb[0], kb[1]);
        mma_m16n8k16(s[2 * jp + 1], qf[kk], kb[2], kb[3]);
      }
    }
  }
  const int col = c0 + 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < MA_NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[j][e] = col + 8 * j + (e & 1) < Lk ? s[j][e] * scale_log2 : -INFINITY;
}

// ACC: acc += Pᵀ (cross_attention_acc); otherwise P is written out as PT
// (cross_attention_probs), skipping samples b < skip_b.
template <int HD, typename PT, bool ACC>
__global__ void __launch_bounds__(MA_THREADS, HD == 128 ? 2 : 3)
cross_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           __nv_bfloat16* __restrict__ o, float* __restrict__ acc,
                           PT* __restrict__ p, int H, int Lq, int Lk, int skip_b,
                           Strides qs, Strides ks, Strides vs, float scale_log2) {
  using namespace hopper;
  using bf16 = __nv_bfloat16;
  constexpr int STR = HD + 8;  // bf16 row stride of the q, k and v tiles
  constexpr int CH = HD / 8;   // 16-byte chunks of a row
  constexpr int VEC = 16 / sizeof(PT);
  DAAM_DYNAMIC_SMEM(uint8_t, ma_smem);

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * MA_BQ;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int qr = warp * 16 + g;  // block row of s[.][0..1]; s[.][2..3] is qr + 8
  const int lkp = (Lk + 15) & ~15;
  const int n_chunks = (Lk + MA_KC - 1) / MA_KC;
  bf16* Qs = reinterpret_cast<bf16*>(ma_smem);
  bf16* Ks = Qs + MA_BQ * STR;
  bf16* Vs = Ks + lkp * STR;
  float* At = reinterpret_cast<float*>(Vs + lkp * STR);  // ACC: [chunk rows][MA_ASTR]
  PT* Ps = reinterpret_cast<PT*>(Vs + lkp * STR);        // else: the P span, + lead

  // Group 0: q (rows past Lq zero-filled), and all of k and v (rows Lk ..
  // lkp - 1 zero-filled: P is 0 there, and 0 * V must stay 0).
  {
    const bf16* qb = q + b * qs.b + h * qs.h;
    for (int e = tid; e < MA_BQ * CH; e += MA_THREADS) {
      const int r = e / CH, c = e % CH;
      const bool in = q0 + r < Lq;
      cp_async16(smem_u32(Qs + r * STR + 8 * c), qb + (in ? q0 + r : 0) * qs.l + 8 * c,
                 in ? 16 : 0);
    }
    const bf16* kb = k + b * ks.b + h * ks.h;
    const bf16* vb = v + b * vs.b + h * vs.h;
    for (int e = tid; e < lkp * CH; e += MA_THREADS) {
      const int r = e / CH, c = e % CH;
      const bool in = r < Lk;
      cp_async16(smem_u32(Ks + r * STR + 8 * c), kb + (in ? r : 0) * ks.l + 8 * c,
                 in ? 16 : 0);
      cp_async16(smem_u32(Vs + r * STR + 8 * c), vb + (in ? r : 0) * vs.l + 8 * c,
                 in ? 16 : 0);
    }
    cp_async_commit();
  }
  // acc rows c0 .. c0 + rows - 1 of this block's 64 columns, 16 bytes a
  // copy (Lq % 4 == 0, so a copy is wholly inside or past Lq).
  float* acc_bh = ACC ? acc + ((long long)b * H + h) * Lk * Lq + q0 : nullptr;
  auto load_acc = [&](int c0) {
    const int rows = min(MA_KC, Lk - c0);
    for (int e = tid; e < rows * (MA_BQ / 4); e += MA_THREADS) {
      const int r = e / (MA_BQ / 4), c = e % (MA_BQ / 4);
      if (q0 + 4 * c < Lq)
        cp_async16(smem_u32(At + r * MA_ASTR + 4 * c), acc_bh + (long long)(c0 + r) * Lq + 4 * c,
                   16);
    }
    cp_async_commit();
  };
  if constexpr (ACC) {
    load_acc(0);  // group 1: lands while the scores and P.V run
    cp_async_wait<1>();
  } else {
    cp_async_wait<0>();
  }
  __syncthreads();

  uint32_t qf[HD / 16][4];  // the warp's 16 q rows as A fragments, one per k16 step
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    ldmatrix_x4(qf[kk], smem_u32(Qs + (warp * 16 + lane % 16) * STR + 16 * kk + 8 * (lane / 16)));

  // Pass 1: row max and sum of exp over the chunks (one chunk at Lk <= 80,
  // whose scores pass 2 then reuses).  A thread's partial sums of rows g and
  // g + 8 are reduced over the quad at the end.
  float s[MA_NT][4];
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    ma_scores<HD>(s, qf, Ks, c * MA_KC, lkp, Lk, scale_log2, lane);
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < MA_NT; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int x = 1; x < 4; x <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
    }
    // Key 0 lies in chunk 0, so the new max is finite and the first
    // correction is exp2(-inf) = 0.
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    l0 *= ex2(m0 - mn0);
    l1 *= ex2(m1 - mn1);
#pragma unroll
    for (int j = 0; j < MA_NT; ++j) {
      l0 += ex2(s[j][0] - mn0) + ex2(s[j][1] - mn0);
      l1 += ex2(s[j][2] - mn1) + ex2(s[j][3] - mn1);
    }
    m0 = mn0;
    m1 = mn1;
  }
#pragma unroll
  for (int x = 1; x < 4; x <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, x);
    l1 += __shfl_xor_sync(0xffffffffu, l1, x);
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;

  // Pass 2, per chunk: normalized P in fp32; O += bf16(P) V with P straight
  // from the score fragment (the fragment of keys 16 u .. 16 u + 15 is the A
  // fragment of the u-th k16 step); then the epilogue takes the fp32 P.
  float oacc[HD / 8][4];
#pragma unroll
  for (int jd = 0; jd < HD / 8; ++jd)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[jd][e] = 0.f;
  const bool write_p = !ACC && b >= skip_b;  // uniform over the block
  PT* span = ACC ? nullptr : p + (((long long)b * H + h) * Lq + q0) * Lk;
  // Ps[lead + i] holds span[i]: smem and device memory then agree mod 16 bytes.
  const int lead = ACC ? 0 : (int)((reinterpret_cast<uintptr_t>(span) / sizeof(PT)) % VEC);
  for (int c = 0; c < n_chunks; ++c) {
    const int c0 = c * MA_KC;
    if constexpr (ACC) {
      if (c > 0) load_acc(c0);  // the tile was written back at the end of chunk c - 1
    }
    if (n_chunks > 1) ma_scores<HD>(s, qf, Ks, c0, lkp, Lk, scale_log2, lane);
#pragma unroll
    for (int j = 0; j < MA_NT; ++j) {
      s[j][0] = ex2(s[j][0] - m0) * inv0;
      s[j][1] = ex2(s[j][1] - m0) * inv0;
      s[j][2] = ex2(s[j][2] - m1) * inv1;
      s[j][3] = ex2(s[j][3] - m1) * inv1;
    }
#pragma unroll
    for (int u = 0; u < MA_NT / 2; ++u) {
      if (c0 + 16 * u < lkp) {
        const uint32_t pa[4] = {pack_bf16(s[2 * u][0], s[2 * u][1]),
                                pack_bf16(s[2 * u][2], s[2 * u][3]),
                                pack_bf16(s[2 * u + 1][0], s[2 * u + 1][1]),
                                pack_bf16(s[2 * u + 1][2], s[2 * u + 1][3])};
        // matrices: keys {lo, hi} x hd columns 8 jd + {0..7, 8..15}, transposed
        const bf16* row =
            Vs + (c0 + 16 * u + 8 * ((lane / 8) % 2) + lane % 8) * STR + 8 * (lane / 16);
#pragma unroll
        for (int jd = 0; jd < HD / 8; jd += 2) {
          uint32_t vb[4];
          ldmatrix_x4_trans(vb, smem_u32(row + 8 * jd));
          mma_m16n8k16(oacc[jd], pa, vb[0], vb[1]);
          mma_m16n8k16(oacc[jd + 1], pa, vb[2], vb[3]);
        }
      }
    }
    if constexpr (ACC) {
      // The tile is [key][query] with a row stride of 68 floats, so a
      // warp's 32 adds of one fragment slot (4 keys x 8 queries) hit 32
      // banks.  Each acc element belongs to this block alone: no atomics.
      const int rows = min(MA_KC, Lk - c0);
      cp_async_wait<0>();
      __syncthreads();  // every thread's copies of the tile have landed
#pragma unroll
      for (int j = 0; j < MA_NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = 8 * j + 2 * t + (e & 1);
          if (key < rows) At[key * MA_ASTR + qr + 8 * (e >> 1)] += s[j][e];
        }
      __syncthreads();
      float* dst = acc_bh + (long long)c0 * Lq;
      for (int e = tid; e < rows * (MA_BQ / 4); e += MA_THREADS) {
        const int r = e / (MA_BQ / 4), c4 = e % (MA_BQ / 4);
        if (q0 + 4 * c4 < Lq)
          *reinterpret_cast<float4*>(dst + (long long)r * Lq + 4 * c4) =
              *reinterpret_cast<const float4*>(At + r * MA_ASTR + 4 * c4);
      }
      if (c + 1 < n_chunks) __syncthreads();  // before the next chunk's copies
    } else if (write_p) {
#pragma unroll
      for (int j = 0; j < MA_NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = c0 + 8 * j + 2 * t + (e & 1);
          const int row = qr + 8 * (e >> 1);
          if (key < Lk && q0 + row < Lq) Ps[lead + row * Lk + key] = from_f<PT>(s[j][e]);
        }
    }
  }

  // O: each warp stages its 16 rows in its own rows of the q tile (which
  // only it read, into qf), then stores them with 16-byte stores.
  bf16* Os = Qs + warp * 16 * STR;
  __syncwarp();
#pragma unroll
  for (int jd = 0; jd < HD / 8; ++jd) {
    *reinterpret_cast<uint32_t*>(Os + g * STR + 8 * jd + 2 * t) =
        pack_bf16(oacc[jd][0], oacc[jd][1]);
    *reinterpret_cast<uint32_t*>(Os + (g + 8) * STR + 8 * jd + 2 * t) =
        pack_bf16(oacc[jd][2], oacc[jd][3]);
  }
  __syncwarp();
  for (int e = lane; e < 16 * CH; e += 32) {
    const int r = e / CH, c = e % CH;
    const int qi = q0 + warp * 16 + r;
    if (qi < Lq)
      *reinterpret_cast<uint4*>(o + ((long long)b * Lq + qi) * (H * HD) + h * HD + 8 * c) =
          *reinterpret_cast<const uint4*>(Os + r * STR + 8 * c);
  }

  // P: the block's rows are one contiguous span of n elements; 16-byte
  // stores, with scalar ones for the head before the first 16-byte boundary
  // and for the tail.
  if (write_p) {
    __syncthreads();
    const int n = min(MA_BQ, Lq - q0) * Lk;
    const int head = min(n, (VEC - lead) % VEC);
    const int nvec = (n - head) / VEC;
    for (int i = tid; i < head; i += MA_THREADS) span[i] = Ps[lead + i];
    for (int i = tid; i < nvec; i += MA_THREADS)
      *reinterpret_cast<uint4*>(span + head + i * VEC) =
          *reinterpret_cast<const uint4*>(Ps + lead + head + i * VEC);
    for (int i = head + nvec * VEC + tid; i < n; i += MA_THREADS) span[i] = Ps[lead + i];
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <int HD>
cudaError_t launch_flash(const void* q, const void* k, const void* v, void* o,
                         int B, int H, int Lq, int Lk, Strides qs, Strides ks,
                         Strides vs, float scale, cudaStream_t stream) {
  dim3 grid((Lq + FA_BQ - 1) / FA_BQ, H, B);
  DAAM_LAUNCH(grid, FA_THREADS, 0, stream, flash_attention_kernel<HD>)(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), H, Lq, Lk, qs, ks,
      vs, scale);
  return cudaGetLastError();
}

// Error codes above this are a CUresult of cuTensorMapEncodeTiled.
constexpr int TENSOR_MAP_ERROR = 100000;

#ifndef DAAM_EMULATE
// cuTensorMapEncodeTiled, looked up in the driver through the runtime so the
// library needs no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

cudaError_t encode_tiled(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || p == nullptr) return cudaErrorSymbolNotFound;
    cached = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

// A 4-D map (hd, L, H, B) of a bf16 (B, L, H, hd) view, boxes of one panel
// by TC_BK rows, swizzled to the panel's width.
template <int HD>
CUresult encode_view(EncodeTiled encode, CUtensorMap* map, const void* ptr, int B,
                     int L, int H, Strides st) {
  using T = TcTile<HD>;
  const cuuint64_t dims[4] = {HD, (cuuint64_t)L, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st.l * 2, (cuuint64_t)st.h * 2,
                                 (cuuint64_t)st.b * 2};
  const cuuint32_t box[4] = {T::PW, TC_BK, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = T::PW == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : T::PW == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                   : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int HD>
int launch_flash_wgmma(int device, const void* q, const void* k, const void* v,
                       void* o, int B, int H, int Lq, int Lk, Strides qs, Strides ks,
                       Strides vs, float scale, cudaStream_t stream) {
  EncodeTiled encode;
  cudaError_t err = encode_tiled(&encode);
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tk, tv;
  CUresult res = encode_view<HD>(encode, &tq, q, B, Lq, H, qs);
  if (res == CUDA_SUCCESS) res = encode_view<HD>(encode, &tk, k, B, Lk, H, ks);
  if (res == CUDA_SUCCESS) res = encode_view<HD>(encode, &tv, v, B, Lk, H, vs);
  if (res != CUDA_SUCCESS) return TENSOR_MAP_ERROR + res;
  const int smem = TcTile<HD>::SMEM;
  static bool smem_set[64] = {};  // the opt-in, once per device
  if (device >= 64 || !smem_set[device]) {
    err = cudaFuncSetAttribute(flash_attention_wgmma_kernel<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    if (device < 64) smem_set[device] = true;
  }
  dim3 grid((Lq + TC_BQ - 1) / TC_BQ, H, B);
  flash_attention_wgmma_kernel<HD><<<grid, TC_THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), H, Lq, Lk,
      scale * 1.4426950408889634f);  // log2(e): the kernel works in exp2
  return cudaGetLastError();
}
#endif  // DAAM_EMULATE

template <int HD>
cudaError_t launch_cross_acc(const void* q, const void* k, const void* v,
                             void* o, float* acc, int B, int H, int Lq, int Lk,
                             Strides qs, Strides ks, Strides vs, float scale,
                             cudaStream_t stream) {
  const size_t smem = 2 * (size_t)Lk * HD * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        cross_attention_acc_kernel<HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid((Lq + CA_THREADS - 1) / CA_THREADS, H, B);
  DAAM_LAUNCH(grid, CA_THREADS, smem, stream, cross_attention_acc_kernel<HD>)(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), acc, H, Lq, Lk, qs, ks, vs,
      scale);
  return cudaGetLastError();
}

template <typename PT, int HD>
cudaError_t launch_cross_probs(const void* q, const void* k, const void* v,
                               void* o, void* p, int B, int H, int Lq, int Lk,
                               int skip_b, Strides qs, Strides ks, Strides vs,
                               float scale, cudaStream_t stream) {
  const size_t smem = (2 * (size_t)Lk * HD + (size_t)CA_THREADS * Lk) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        cross_attention_probs_kernel<PT, HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid((Lq + CA_THREADS - 1) / CA_THREADS, H, B);
  DAAM_LAUNCH(grid, CA_THREADS, smem, stream, cross_attention_probs_kernel<PT, HD>)(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), static_cast<PT*>(p), H,
      Lq, Lk, skip_b, qs, ks, vs, scale);
  return cudaGetLastError();
}

constexpr int SMEM_MAX = 227 * 1024;  // dynamic shared memory of one block

// The tensor-core kernels: acc (ACC) or P of type PT.  An Lk whose block
// needs more than SMEM_MAX bytes (ma_smem_bytes) is refused with
// cudaErrorInvalidValue before anything is launched.
template <int HD, typename PT, bool ACC>
cudaError_t launch_cross_mma(int device, const void* q, const void* k, const void* v,
                             void* o, float* acc, void* p, int B, int H, int Lq, int Lk,
                             int skip_b, Strides qs, Strides ks, Strides vs, float scale,
                             cudaStream_t stream) {
  const long long smem = ma_smem_bytes(HD, Lk, ACC ? 0 : (int)sizeof(PT));
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  auto kernel = cross_attention_mma_kernel<HD, PT, ACC>;
  static bool smem_set[64] = {};  // the opt-in to all of SMEM_MAX, once per device
  if (device >= 64 || !smem_set[device]) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           SMEM_MAX);
    if (err != cudaSuccess) return err;
    if (device < 64) smem_set[device] = true;
  }
  dim3 grid((Lq + MA_BQ - 1) / MA_BQ, H, B);
  DAAM_LAUNCH(grid, MA_THREADS, smem, stream, kernel)(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), acc,
      static_cast<PT*>(p), H, Lq, Lk, skip_b, qs, ks, vs,
      scale * 1.4426950408889634f);  // log2(e): the kernel works in exp2
  return cudaGetLastError();
}

cudaError_t cross_acc_dispatch(int hd, const void* q, const void* k, const void* v,
                               void* o, float* acc, int B, int H, int Lq, int Lk,
                               Strides qs, Strides ks, Strides vs, float scale,
                               cudaStream_t stream) {
  switch (hd) {
    case 16: return launch_cross_acc<16>(q, k, v, o, acc, B, H, Lq, Lk, qs, ks, vs, scale, stream);
    case 32: return launch_cross_acc<32>(q, k, v, o, acc, B, H, Lq, Lk, qs, ks, vs, scale, stream);
    case 64: return launch_cross_acc<64>(q, k, v, o, acc, B, H, Lq, Lk, qs, ks, vs, scale, stream);
    case 128: return launch_cross_acc<128>(q, k, v, o, acc, B, H, Lq, Lk, qs, ks, vs, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename PT>
cudaError_t cross_probs_dispatch(int hd, const void* q, const void* k, const void* v,
                                 void* o, void* p, int B, int H, int Lq, int Lk, int skip_b,
                                 Strides qs, Strides ks, Strides vs, float scale,
                                 cudaStream_t stream) {
  switch (hd) {
    case 16: return launch_cross_probs<PT, 16>(q, k, v, o, p, B, H, Lq, Lk, skip_b, qs, ks, vs, scale, stream);
    case 32: return launch_cross_probs<PT, 32>(q, k, v, o, p, B, H, Lq, Lk, skip_b, qs, ks, vs, scale, stream);
    case 64: return launch_cross_probs<PT, 64>(q, k, v, o, p, B, H, Lq, Lk, skip_b, qs, ks, vs, scale, stream);
    case 128: return launch_cross_probs<PT, 128>(q, k, v, o, p, B, H, Lq, Lk, skip_b, qs, ks, vs, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename PT, bool ACC>
cudaError_t cross_mma_dispatch(int device, int hd, const void* q, const void* k,
                               const void* v, void* o, float* acc, void* p, int B, int H,
                               int Lq, int Lk, int skip_b, Strides qs, Strides ks,
                               Strides vs, float scale, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch_cross_mma<16, PT, ACC>(device, q, k, v, o, acc, p, B, H, Lq, Lk, skip_b, qs, ks, vs, scale, stream);
    case 32: return launch_cross_mma<32, PT, ACC>(device, q, k, v, o, acc, p, B, H, Lq, Lk, skip_b, qs, ks, vs, scale, stream);
    case 64: return launch_cross_mma<64, PT, ACC>(device, q, k, v, o, acc, p, B, H, Lq, Lk, skip_b, qs, ks, vs, scale, stream);
    case 128: return launch_cross_mma<128, PT, ACC>(device, q, k, v, o, acc, p, B, H, Lq, Lk, skip_b, qs, ks, vs, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C interface, bound with ctypes.  Each returns the cudaError_t of its
// launch (0 on success).

// fp32 only, on the CUDA cores; bf16 goes to daam_flash_attention_wgmma.
extern "C" int daam_flash_attention(int device, int hd, const void* q,
                                    const void* k, const void* v, void* o,
                                    int B, int H, int Lq, int Lk, int qsb,
                                    int qsl, int qsh, int ksb, int ksl,
                                    int ksh, int vsb, int vsl, int vsh,
                                    float scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Strides qs{qsb, qsl, qsh}, ks{ksb, ksl, ksh}, vs{vsb, vsl, vsh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch_flash<16>(q, k, v, o, B, H, Lq, Lk, qs, ks, vs, scale, st);
    case 32: return launch_flash<32>(q, k, v, o, B, H, Lq, Lk, qs, ks, vs, scale, st);
    case 64: return launch_flash<64>(q, k, v, o, B, H, Lq, Lk, qs, ks, vs, scale, st);
    case 128: return launch_flash<128>(q, k, v, o, B, H, Lq, Lk, qs, ks, vs, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

#ifndef DAAM_EMULATE
// bf16 only; every view's base must be 16-byte aligned and its b, l, h
// strides multiples of 8 elements (16 bytes), as TMA requires.
extern "C" int daam_flash_attention_wgmma(int device, int hd, const void* q,
                                          const void* k, const void* v, void* o,
                                          int B, int H, int Lq, int Lk, int qsb,
                                          int qsl, int qsh, int ksb, int ksl,
                                          int ksh, int vsb, int vsl, int vsh,
                                          float scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Strides qs{qsb, qsl, qsh}, ks{ksb, ksl, ksh}, vs{vsb, vsl, vsh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch_flash_wgmma<16>(device, q, k, v, o, B, H, Lq, Lk, qs, ks, vs, scale, st);
    case 32: return launch_flash_wgmma<32>(device, q, k, v, o, B, H, Lq, Lk, qs, ks, vs, scale, st);
    case 64: return launch_flash_wgmma<64>(device, q, k, v, o, B, H, Lq, Lk, qs, ks, vs, scale, st);
    case 128: return launch_flash_wgmma<128>(device, q, k, v, o, B, H, Lq, Lk, qs, ks, vs, scale, st);
    default: return cudaErrorInvalidValue;
  }
}
#endif  // DAAM_EMULATE

// fp32 only, on the CUDA cores; bf16 goes to daam_cross_attention_acc_mma.
extern "C" int daam_cross_attention_acc(int device, int hd, const void* q,
                                        const void* k, const void* v, void* o,
                                        float* acc, int B, int H, int Lq, int Lk,
                                        int qsb, int qsl, int qsh, int ksb, int ksl,
                                        int ksh, int vsb, int vsl, int vsh,
                                        float scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return cross_acc_dispatch(hd, q, k, v, o, acc, B, H, Lq, Lk, Strides{qsb, qsl, qsh},
                            Strides{ksb, ksl, ksh}, Strides{vsb, vsl, vsh}, scale,
                            static_cast<cudaStream_t>(stream));
}

// bf16 only, on the tensor cores; every view's base must be 16-byte aligned
// and its b, l, h strides multiples of 8 elements, acc's base 16-byte
// aligned and Lq a multiple of 4.  An Lk whose block needs more than 227 KB
// of shared memory (ma_smem_bytes) returns cudaErrorInvalidValue.
extern "C" int daam_cross_attention_acc_mma(int device, int hd, const void* q,
                                            const void* k, const void* v, void* o,
                                            float* acc, int B, int H, int Lq, int Lk,
                                            int qsb, int qsl, int qsh, int ksb, int ksl,
                                            int ksh, int vsb, int vsl, int vsh,
                                            float scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return cross_mma_dispatch<float, true>(
      device, hd, q, k, v, o, acc, nullptr, B, H, Lq, Lk, 0, Strides{qsb, qsl, qsh},
      Strides{ksb, ksl, ksh}, Strides{vsb, vsl, vsh}, scale,
      static_cast<cudaStream_t>(stream));
}

// pdtype: the type of P (0 = float32, 1 = bfloat16); skip_b: samples
// b < skip_b get no P rows written (B/2 for cond_only, else 0).  fp32 q, k
// and v only, on the CUDA cores; bf16 goes to daam_cross_attention_probs_mma.
extern "C" int daam_cross_attention_probs(int device, int hd, const void* q,
                                          const void* k, const void* v, void* o,
                                          void* p, int pdtype, int skip_b, int B,
                                          int H, int Lq, int Lk, int qsb, int qsl,
                                          int qsh, int ksb, int ksl, int ksh, int vsb,
                                          int vsl, int vsh, float scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Strides qs{qsb, qsl, qsh}, ks{ksb, ksl, ksh}, vs{vsb, vsl, vsh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (pdtype) {
    case 0: return cross_probs_dispatch<float>(hd, q, k, v, o, p, B, H, Lq, Lk, skip_b, qs, ks, vs, scale, st);
    case 1: return cross_probs_dispatch<__nv_bfloat16>(hd, q, k, v, o, p, B, H, Lq, Lk, skip_b, qs, ks, vs, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

// bf16 q, k and v only, on the tensor cores, under the view and shared
// memory conditions of daam_cross_attention_acc_mma (Lq may be any size).
extern "C" int daam_cross_attention_probs_mma(int device, int hd, const void* q,
                                              const void* k, const void* v, void* o,
                                              void* p, int pdtype, int skip_b, int B,
                                              int H, int Lq, int Lk, int qsb, int qsl,
                                              int qsh, int ksb, int ksl, int ksh, int vsb,
                                              int vsl, int vsh, float scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Strides qs{qsb, qsl, qsh}, ks{ksb, ksl, ksh}, vs{vsb, vsl, vsh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (pdtype) {
    case 0: return cross_mma_dispatch<float, false>(device, hd, q, k, v, o, nullptr, p, B, H, Lq, Lk, skip_b, qs, ks, vs, scale, st);
    case 1: return cross_mma_dispatch<__nv_bfloat16, false>(device, hd, q, k, v, o, nullptr, p, B, H, Lq, Lk, skip_b, qs, ks, vs, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* daam_error_string(int err) {
  if (err >= TENSOR_MAP_ERROR) {
    static char msg[64];
    snprintf(msg, sizeof msg, "cuTensorMapEncodeTiled failed, CUresult %d",
             err - TENSOR_MAP_ERROR);
    return msg;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
