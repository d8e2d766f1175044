// Hand-written Hopper (sm_90a) kernels for the traced DAAM attention path.
//
// flash_attention replaces daam_tpu/ops/pallas_attention.py
//   flash_self_attention (pallas_call at :169; body _self_attn_kernel :124 and
//   _attend_one_head :61) together with its packed-layout twin
//   flash_self_attention_packed (:322; body _self_attn_packed_kernel :220).
// cross_attention_acc replaces cross_attention_acc (:517; body
//   _cross_attn_acc_kernel :452) together with cross_attention_acc_packed
//   (:618; body _cross_attn_acc_packed_kernel :548).
//
// The packed Pallas twins exist only because a TPU block must span 128
// lanes.  Here q, k and v are read as (B, L, H, hd) views through three
// element strides each (the hd stride must be 1), so one kernel serves both
// the head-major (B, H, L, hd) tensors and the (B, L, H*hd) projection
// output without a relayout copy.  o is written as (B, Lq, H*hd), ready for
// to_out.  Storage is float or bf16; all arithmetic is fp32; scale is
// hd^-1/2, passed in by the caller.
//
// What bounds them on an H100, and what the design does about it:
//
// * flash_attention is compute bound at the main path's shapes: the
//   64x64-latent self-attention (B=2, H=5, L=4096, hd=64) does
//   4*B*H*L*L*hd = 21.5 GFLOP against ~10 MB of bf16 q/k/v/o.  This first
//   version runs on the CUDA cores in fp32 (67 TFLOP/s peak, no tensor
//   cores), and the inner loop is bounded by shared-memory reads feeding the
//   FMAs.  One 256-thread block owns (b, h, 64 queries); four threads share
//   a query, each holding hd/4 lanes of q and of the output in registers as
//   float4 chunks interleaved so the four read 64 contiguous bytes of a
//   staged key row (conflict-free, and a broadcast across the warp's eight
//   queries).  Keys and values stream through shared memory 32 rows at a
//   time with an online softmax (running max and sum per query), so the
//   score matrix never leaves registers and any Lk works; the tail past Lk,
//   including Lk = 77, is masked.  Tensor cores (mma/wgmma) and TMA are
//   later work: on an H100 80GB HBM3 at a 700 W power limit this version
//   takes 3.86 ms at (2, 5, 4096, 4096) in bf16, against 2.16 ms for the
//   plain PyTorch version (cuBLAS tensor cores plus a materialized softmax).
// * cross_attention_acc is memory bound: per call it reads q and
//   read-modify-writes the fp32 accumulator (Lk*Lq*4 bytes each way, e.g.
//   6.3 MB for (1, 5, 4096) at Lk = 77) for only ~2*2*Lk*hd FLOP per query.
//   One thread owns one query; a 64-thread block owns the (b, h, 64-query)
//   columns of acc, so the += needs no atomics and is deterministic, and for
//   a fixed token neighbouring threads touch neighbouring acc addresses
//   (coalesced).  K and V for all Lk tokens are staged once per block in
//   shared memory.  Two passes over the tokens (running max and sum, then
//   the normalized probabilities) keep the scores out of memory; the second
//   pass adds P into acc and P.V into the output, normalizing P before PV
//   as the Pallas kernel does.  On an H100 80GB HBM3 at a 700 W power limit
//   it takes 0.073 ms at (1, 5, 4096, 77) in bf16, against 0.161 ms for the
//   plain PyTorch version.
// * cross_attention_probs replaces cross_attention_probs (:405; body
//   _cross_attn_kernel :347), the 'full'/'cond' capture behind save_heads:
//   O = PV and P itself written out as (B, H, Lq, Lk), in fp32 or bf16
//   whatever the storage type of q.  It is memory bound on the P write:
//   12.6 MB of fp32 P at (2, 5, 4096, 77) against ~0.2 GFLOP.  It keeps
//   K1's skeleton (one thread per query, 64-query blocks, K and V staged
//   once, two passes over the tokens), but one thread per query writing its
//   own 77-element P row would stride 77 elements across the warp.  The
//   block's 64 rows are one contiguous span of 64*Lk elements of P, so the
//   normalized rows are staged in shared memory (row stride Lk, odd for
//   Lk = 77, so the staging writes do not conflict) and the block writes
//   the span out cooperatively, neighbouring threads on neighbouring
//   addresses.  With cond_only (CFG layout [uncond; cond]) blocks of the
//   first B/2 samples skip the P write and those rows stay unwritten.  As
//   the Pallas body does (:369), P is rounded to the storage type of v
//   before the PV product, while P itself is written from the fp32 value.
//
// No kernel synchronizes with the host or allocates memory; the
// Python wrapper (daam_tpu_torch/ops/kernels.py) checks shapes, strides and
// types, allocates o, and raises on the error code each entry point returns.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

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

template <typename T>
__device__ __forceinline__ float4 load4(const T* p) {
  return make_float4(to_f(p[0]), to_f(p[1]), to_f(p[2]), to_f(p[3]));
}

template <typename T>
__device__ __forceinline__ void store4(T* p, float4 v, float s) {
  p[0] = from_f<T>(v.x * s);
  p[1] = from_f<T>(v.y * s);
  p[2] = from_f<T>(v.z * s);
  p[3] = from_f<T>(v.w * s);
}

// ---------------------------------------------------------------------------
// flash_attention
// ---------------------------------------------------------------------------

constexpr int FA_BQ = 64;   // queries per block
constexpr int FA_TPQ = 4;   // threads per query
constexpr int FA_BK = 32;   // keys staged per tile
constexpr int FA_THREADS = FA_BQ * FA_TPQ;

template <typename T, int HD>
__global__ void __launch_bounds__(FA_THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int H,
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
  const T* qrow = q + b * qs.b + (long long)(valid ? qi : 0) * qs.l + h * qs.h;
#pragma unroll
  for (int i = 0; i < C4; ++i) {
    qr[i] = load4(qrow + 4 * (r + FA_TPQ * i));
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = -INFINITY;
  float l = 0.f;

  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;
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
        kv = to_f(kb[key * ks.l + col]);
        vv = to_f(vb[key * vs.l + col]);
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
    T* orow = o + ((long long)b * Lq + qi) * (H * HD) + h * HD;
#pragma unroll
    for (int i = 0; i < C4; ++i) store4(orow + 4 * (r + FA_TPQ * i), acc[i], inv);
  }
}

// ---------------------------------------------------------------------------
// cross_attention_acc
// ---------------------------------------------------------------------------

constexpr int CA_THREADS = 64;  // queries per block, one thread each

template <typename T, int HD>
__global__ void __launch_bounds__(CA_THREADS)
cross_attention_acc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o,
                           float* __restrict__ acc, int H, int Lq, int Lk,
                           Strides qs, Strides ks, Strides vs, float scale) {
  constexpr int C4 = HD / 4;
  extern __shared__ float4 smem[];
  float4* Ks = smem;            // [Lk][HD / 4]
  float4* Vs = smem + Lk * C4;  // [Lk][HD / 4]

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int qi = blockIdx.x * CA_THREADS + tid;

  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;
  float* ksf = reinterpret_cast<float*>(Ks);
  float* vsf = reinterpret_cast<float*>(Vs);
  for (int e = tid; e < Lk * HD; e += CA_THREADS) {
    const int row = e / HD;
    const int col = e % HD;
    ksf[e] = to_f(kb[row * ks.l + col]);
    vsf[e] = to_f(vb[row * vs.l + col]);
  }
  __syncthreads();
  if (qi >= Lq) return;  // after the block's only barrier

  float4 qr[C4];
  const T* qrow = q + b * qs.b + (long long)qi * qs.l + h * qs.h;
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

  T* orow = o + ((long long)b * Lq + qi) * (H * HD) + h * HD;
#pragma unroll
  for (int c = 0; c < C4; ++c) store4(orow + 4 * c, oacc[c], 1.f);
}

// ---------------------------------------------------------------------------
// cross_attention_probs
// ---------------------------------------------------------------------------

template <typename T, typename PT, int HD>
__global__ void __launch_bounds__(CA_THREADS)
cross_attention_probs_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, T* __restrict__ o,
                             PT* __restrict__ p, int H, int Lq, int Lk,
                             int skip_b, Strides qs, Strides ks, Strides vs,
                             float scale) {
  constexpr int C4 = HD / 4;
  extern __shared__ float4 smem[];
  float4* Ks = smem;                                   // [Lk][HD / 4]
  float4* Vs = smem + Lk * C4;                         // [Lk][HD / 4]
  float* Ps = reinterpret_cast<float*>(smem + 2 * Lk * C4);  // [64][Lk]

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * CA_THREADS;
  const int qi = q0 + tid;
  const bool valid = qi < Lq;

  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;
  float* ksf = reinterpret_cast<float*>(Ks);
  float* vsf = reinterpret_cast<float*>(Vs);
  for (int e = tid; e < Lk * HD; e += CA_THREADS) {
    const int row = e / HD;
    const int col = e % HD;
    ksf[e] = to_f(kb[row * ks.l + col]);
    vsf[e] = to_f(vb[row * vs.l + col]);
  }
  __syncthreads();

  if (valid) {
    float4 qr[C4];
    const T* qrow = q + b * qs.b + (long long)qi * qs.l + h * qs.h;
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

    // Pass 2: normalized P into the staging row and, rounded to T, into P.V.
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
      const float pv = to_f(from_f<T>(pt));
#pragma unroll
      for (int c = 0; c < C4; ++c) fma4(oacc[c], pv, Vs[t * C4 + c]);
    }

    T* orow = o + ((long long)b * Lq + qi) * (H * HD) + h * HD;
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
// launchers
// ---------------------------------------------------------------------------

template <typename T, int HD>
cudaError_t launch_flash(const void* q, const void* k, const void* v, void* o,
                         int B, int H, int Lq, int Lk, Strides qs, Strides ks,
                         Strides vs, float scale, cudaStream_t stream) {
  dim3 grid((Lq + FA_BQ - 1) / FA_BQ, H, B);
  flash_attention_kernel<T, HD><<<grid, FA_THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, Lq, Lk, qs, ks, vs,
      scale);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_cross_acc(const void* q, const void* k, const void* v,
                             void* o, float* acc, int B, int H, int Lq, int Lk,
                             Strides qs, Strides ks, Strides vs, float scale,
                             cudaStream_t stream) {
  const size_t smem = 2 * (size_t)Lk * HD * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        cross_attention_acc_kernel<T, HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid((Lq + CA_THREADS - 1) / CA_THREADS, H, B);
  cross_attention_acc_kernel<T, HD><<<grid, CA_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), acc, H, Lq, Lk, qs, ks, vs,
      scale);
  return cudaGetLastError();
}

template <typename T, typename PT, int HD>
cudaError_t launch_cross_probs(const void* q, const void* k, const void* v,
                               void* o, void* p, int B, int H, int Lq, int Lk,
                               int skip_b, Strides qs, Strides ks, Strides vs,
                               float scale, cudaStream_t stream) {
  const size_t smem = (2 * (size_t)Lk * HD + (size_t)CA_THREADS * Lk) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        cross_attention_probs_kernel<T, PT, HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid((Lq + CA_THREADS - 1) / CA_THREADS, H, B);
  cross_attention_probs_kernel<T, PT, HD><<<grid, CA_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<PT*>(p), H,
      Lq, Lk, skip_b, qs, ks, vs, scale);
  return cudaGetLastError();
}

template <typename T, typename PT>
cudaError_t cross_probs_dispatch_hd(int hd, const void* q, const void* k,
                                    const void* v, void* o, void* p, int B,
                                    int H, int Lq, int Lk, int skip_b,
                                    Strides qs, Strides ks, Strides vs,
                                    float scale, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch_cross_probs<T, PT, 16>(q, k, v, o, p, B, H, Lq, Lk, skip_b, qs, ks, vs, scale, stream);
    case 32: return launch_cross_probs<T, PT, 32>(q, k, v, o, p, B, H, Lq, Lk, skip_b, qs, ks, vs, scale, stream);
    case 64: return launch_cross_probs<T, PT, 64>(q, k, v, o, p, B, H, Lq, Lk, skip_b, qs, ks, vs, scale, stream);
    case 128: return launch_cross_probs<T, PT, 128>(q, k, v, o, p, B, H, Lq, Lk, skip_b, qs, ks, vs, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

#define DAAM_DISPATCH(LAUNCH, ...)                                         \
  switch (dtype * 1000 + hd) {                                             \
    case 16: return LAUNCH<float, 16>(__VA_ARGS__);                        \
    case 32: return LAUNCH<float, 32>(__VA_ARGS__);                        \
    case 64: return LAUNCH<float, 64>(__VA_ARGS__);                        \
    case 128: return LAUNCH<float, 128>(__VA_ARGS__);                      \
    case 1016: return LAUNCH<__nv_bfloat16, 16>(__VA_ARGS__);              \
    case 1032: return LAUNCH<__nv_bfloat16, 32>(__VA_ARGS__);              \
    case 1064: return LAUNCH<__nv_bfloat16, 64>(__VA_ARGS__);              \
    case 1128: return LAUNCH<__nv_bfloat16, 128>(__VA_ARGS__);             \
    default: return cudaErrorInvalidValue;                                 \
  }

cudaError_t flash_dispatch(int dtype, int hd, const void* q, const void* k,
                           const void* v, void* o, int B, int H, int Lq,
                           int Lk, Strides qs, Strides ks, Strides vs,
                           float scale, cudaStream_t stream) {
  DAAM_DISPATCH(launch_flash, q, k, v, o, B, H, Lq, Lk, qs, ks, vs, scale,
                stream)
}

cudaError_t cross_acc_dispatch(int dtype, int hd, const void* q, const void* k,
                               const void* v, void* o, float* acc, int B,
                               int H, int Lq, int Lk, Strides qs, Strides ks,
                               Strides vs, float scale, cudaStream_t stream) {
  DAAM_DISPATCH(launch_cross_acc, q, k, v, o, acc, B, H, Lq, Lk, qs, ks, vs,
                scale, stream)
}

cudaError_t cross_probs_dispatch(int dtype, int pdtype, int hd, const void* q,
                                 const void* k, const void* v, void* o,
                                 void* p, int B, int H, int Lq, int Lk,
                                 int skip_b, Strides qs, Strides ks,
                                 Strides vs, float scale,
                                 cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  switch (dtype * 10 + pdtype) {
    case 0: return cross_probs_dispatch_hd<float, float>(hd, q, k, v, o, p, B, H, Lq, Lk, skip_b, qs, ks, vs, scale, stream);
    case 1: return cross_probs_dispatch_hd<float, bf16>(hd, q, k, v, o, p, B, H, Lq, Lk, skip_b, qs, ks, vs, scale, stream);
    case 10: return cross_probs_dispatch_hd<bf16, float>(hd, q, k, v, o, p, B, H, Lq, Lk, skip_b, qs, ks, vs, scale, stream);
    case 11: return cross_probs_dispatch_hd<bf16, bf16>(hd, q, k, v, o, p, B, H, Lq, Lk, skip_b, qs, ks, vs, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C interface, bound with ctypes.  dtype: 0 = float32, 1 = bfloat16.
// Each returns the cudaError_t of its launch (0 on success).

extern "C" int daam_flash_attention(int device, int dtype, int hd,
                                    const void* q, const void* k,
                                    const void* v, void* o, int B, int H,
                                    int Lq, int Lk, int qsb, int qsl, int qsh,
                                    int ksb, int ksl, int ksh, int vsb,
                                    int vsl, int vsh, float scale,
                                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return flash_dispatch(dtype, hd, q, k, v, o, B, H, Lq, Lk,
                        Strides{qsb, qsl, qsh}, Strides{ksb, ksl, ksh},
                        Strides{vsb, vsl, vsh}, scale,
                        static_cast<cudaStream_t>(stream));
}

extern "C" int daam_cross_attention_acc(int device, int dtype, int hd,
                                        const void* q, const void* k,
                                        const void* v, void* o, float* acc,
                                        int B, int H, int Lq, int Lk, int qsb,
                                        int qsl, int qsh, int ksb, int ksl,
                                        int ksh, int vsb, int vsl, int vsh,
                                        float scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return cross_acc_dispatch(dtype, hd, q, k, v, o, acc, B, H, Lq, Lk,
                            Strides{qsb, qsl, qsh}, Strides{ksb, ksl, ksh},
                            Strides{vsb, vsl, vsh}, scale,
                            static_cast<cudaStream_t>(stream));
}

// pdtype: the type of P (0 = float32, 1 = bfloat16); skip_b: samples
// b < skip_b get no P rows written (B/2 for cond_only, else 0).
extern "C" int daam_cross_attention_probs(int device, int dtype, int hd,
                                          const void* q, const void* k,
                                          const void* v, void* o, void* p,
                                          int pdtype, int skip_b, int B,
                                          int H, int Lq, int Lk, int qsb,
                                          int qsl, int qsh, int ksb, int ksl,
                                          int ksh, int vsb, int vsl, int vsh,
                                          float scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return cross_probs_dispatch(dtype, pdtype, hd, q, k, v, o, p, B, H, Lq, Lk,
                              skip_b, Strides{qsb, qsl, qsh},
                              Strides{ksb, ksl, ksh}, Strides{vsb, vsl, vsh},
                              scale, static_cast<cudaStream_t>(stream));
}

extern "C" const char* daam_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
