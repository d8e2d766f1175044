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
//   It serves hd 16, 32, 40, 64, 80, 128 and 160 (TcTile): SD 1.x's 40, 80
//   and 160 run on whole 64-column panels (64, 128 and 192 columns), whose
//   columns past hd TMA fills with zeros in shared memory only; S takes
//   the k16 steps up to hd, P V all of the padded width, and only hd
//   columns of O are stored.  At hd 160 the K/V ring has one stage (two
//   would pass 227 KB) and S goes 64 keys at a time, so the 96 O floats a
//   thread fit its registers.  On an H100 80GB HBM3 at a 700 W
//   power limit the wgmma kernel takes 0.130 ms at (2, 5, 4096, 4096) (330
//   TFLOP/s, a third of the bf16 peak: each warpgroup's exp2 and its
//   products take turns), against 2.17 ms for the plain PyTorch version,
//   and 0.90 ms of device time over one UNet evaluation's K2 launches.
//   fp32 (what daam-torch runs by default) runs both products as 3xTF32:
//   plain TF32 would round each operand to 10 mantissa bits (2^-11
//   relative) and miss the fp32 gate of 1e-4, and the CUDA cores (67
//   TFLOP/s) bound the work at 3.7 ms per SD 2.1 evaluation.  Each fp32
//   operand x is split into hi = tf32(x) and lo = tf32(x - hi), and
//   hi·hi + hi·lo + lo·hi, summed in fp32, is the product within ~2^-21
//   relative: three TF32 products (bound 1.52 ms per evaluation at 495
//   TFLOP/s).  At hd 16 to 128 they run on wgmma m64nNk8, Hopper's only way
//   to that rate, as split_kv_tf32x3_kernel and then
//   flash_attention_tf32x3_wgmma_kernel:
//   - TF32 wgmma reads only K-major operands from shared memory.  k (keys x
//     hd, hd contiguous) is K-major for S = Q Kᵀ as it lies; v is not for
//     P V.  So split_kv_tf32x3_kernel splits k and v once per call into
//     stage images in device memory (WtTile): k hi and lo in 32-byte
//     swizzled panels, v transposed (hd rows of keys) in 128-byte swizzled
//     panels.  Splitting in each 128-query block instead (a producer
//     warpgroup beside two consumers) repeated the work Lq / 128 times and
//     held the products to 0.69 ms at (2, 5, 4096, 4096);
//   - a 256-thread block owns (b, h, 128 queries), a warpgroup per 64
//     rows; its thread 0 keeps the next tiles' images in flight, one bulk
//     copy (cp.async.bulk) each, through a ring of three stages (two at hd
//     128; 64-key tiles, 32 past hd 64) whose mbarriers mark them full and
//     empty.  A ninth warp would cap every thread at 168 registers (three
//     warps on one of the SM's four register files), where hd 64 spilled
//     and ptxas serialized the products; 256 threads get 255;
//   - S = Q Kᵀ per k8 step: (Q lo, k hi) with Q lo from shared memory,
//     then (Q hi, k lo) and (Q hi, k hi) with Q hi from registers (with Q
//     lo in registers too, ptxas handed some of them to P lo at hd 64);
//   - the online softmax runs on the fp32 S fragment (row max and sum over
//     a quad, exp2 with the scale folded in, keys past Lk at -inf); P is not
//     rounded, as the Pallas body's p.astype(v.dtype) is a no-op in fp32;
//   - P never leaves registers: the S fragment gives lane (g, t) keys 2t
//     and 2t + 1 of an n8 tile, the TF32 A fragment wants columns t and
//     t + 4, so P is stored in A order and the split wrote each 8 keys of
//     vᵀ in the matching column order.  P hi is P itself (the tensor core
//     reads its top 19 bits), so (P, vᵀ lo) and (P, vᵀ hi) go first, then
//     P lo = tf32(P - hi) replaces P in place for (P lo, vᵀ hi);
//   - O is divided by the row sum at the end and stored with 8-byte stores.
//   On an H100 80GB HBM3 at a 700 W power limit the pair takes 0.428 ms of
//   device time at (2, 5, 4096, 4096) (100 TFLOP/s of fp32 work, 61% of the
//   3xTF32 bound) and 3.01 ms per SD 2.1 evaluation, against 0.837 and 5.22
//   ms for the mma.sync kernel below and 8.25 ms for SDPA in fp32.  Its two
//   launches cost more than one at Lq 64 and 256 and at Lk 77, where the
//   mma.sync kernel took 7-10 us and the pair takes 13-23 us.
//   hd 160 (SD 1.x's lowest levels) stays on flash_attention_tf32x3_kernel:
//   its Q lo and two 32-key stages would pass 227 KB.  That kernel splits in
//   the block and runs mma.sync m16n8k8 (~316 TFLOP/s of TF32 on this card,
//   scripts/mma_sync_rate.cu, so ~105 TFLOP/s of fp32 work at most):
//   - a 256-thread block owns (b, h, 128 queries), 16 per warp; cp.async
//     copies the q tile once; 16-key k and v tiles pass through registers,
//     where each element is split once for the whole block, and their hi
//     and lo parts go to a two-stage ring in shared memory; the next tile's
//     loads fly while this tile's products run, and one barrier a tile
//     suffices.  fp32 rows are padded to hd + 4 floats, so the eight rows of
//     an ldmatrix and the 32 loads of a V fragment hit 32 banks;
//   - q and k fragments come by ldmatrix, which moves each float as two b16
//     halves and so hands lane (g, t) row g, column t of an 8 x 4 float
//     block: the tf32 A and B layouts;
//   - P's A fragment comes from the S fragment by permuting keys within
//     each k8 step, and V's B fragment (plain 32-bit shared loads:
//     ldmatrix.trans moves only 16-bit elements) from rows 2t and 2t + 1.
//   It takes 0.054 ms at (2, 8, 256, 256) and 3.19 ms at (2, 8, 4096, 4096)
//   (54 TFLOP/s).
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
//     ldmatrix reads conflict-free; hd 40's rows zero-filled to 48 columns,
//     the k16 step, in shared memory) into shared memory, and, for K1, the
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
//   fp32 K1 and K5 go to cross_attention_tf32x3_kernel, one kernel with the
//   same two epilogues: the same block, chunks and softmax (shared
//   helpers), with fp32 tiles (rows of hd + 4 floats) and both products in
//   3xTF32 as in flash_attention_tf32x3_kernel; P enters P.V unrounded, as
//   the Pallas body's p.astype(v.dtype) is a no-op in fp32 (:361, :369).
//   Lk <= 80 stages everything at once as above, K5's P span where K1's acc
//   tile goes (64 rows of Lk floats and the lead fit in its Lk rows of 68);
//   a longer Lk streams each 80-key chunk's k (pass 1), then its k, v and
//   acc rows (pass 2), through the same buffers, and K5 stages and writes
//   each chunk's columns of P in turn, so every Lk fits (at most 137 KB a
//   block at hd 128).  Each warp splits the k and v fragments it loads:
//   cp.async lands raw fp32, and for K1 hi and lo copies of k and v beside
//   it would leave room for one block per SM instead of two; K5 has the
//   room, but splitting once for its block measured 1-4% slower at the
//   same two blocks per SM, so both keep the per-warp split.  On the card
//   above, per SD 2.1 evaluation, K1 takes 0.24-0.26 ms of device time (bound
//   0.062 ms, the bytes), where the former CUDA-core kernel (one thread per
//   query, two passes, Lk dependent read-modify-writes of acc each) took
//   0.81; K5 takes 0.39-0.41 ms per save-run evaluation (bound 0.093 ms),
//   where its CUDA-core kernel (one thread per query, two passes over the
//   tokens) took 1.27-1.31.  A block's own latency sets K5: its 40-block
//   launch at (2, 20, 64, 77), one wave, takes 10.5 us.
//
// No kernel synchronizes with the host or allocates memory; the
// Python wrapper (daam_tpu_torch/ops/kernels.py) checks shapes, strides and
// types, allocates o (and fp32 flash_attention's split K/V scratch), and
// raises on the error code each entry point returns.
//
// tests/torch_emulate/warp.h runs every kernel but the bf16 wgmma one on the
// CPU: it defines DAAM_EMULATE, stands in for the CUDA headers and
// hopper.cuh's cp.async, ldmatrix, mma.sync (bf16 and TF32), TF32 wgmma with
// A from registers, mbarriers and bulk copies, and defines the three macros
// below its own way.  The TMA tensor-map pieces
// (flash_attention_wgmma_kernel) are left out there.

#include <math.h>
#include <stdio.h>

#include <cstdint>
#include <type_traits>

#ifndef DAAM_EMULATE
#include <cuda.h>  // CUtensorMap and its enums; the driver is reached at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>

// y = 2^x, approximate (2 ulp), flushing denormals.
#define DAAM_EX2(y, x) asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x))
// The block's dynamic shared memory as an array `name` of `type`.
#define DAAM_DYNAMIC_SMEM(type, name) extern __shared__ __align__(16) type name[]
// DAAM_LAUNCH(grid, threads, smem, stream, kernel)(arguments...)
#define DAAM_LAUNCH(grid, threads, smem, stream, ...) \
  __VA_ARGS__<<<grid, threads, smem, stream>>>
#endif

#include "hopper.cuh"

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

__device__ __forceinline__ float ex2(float x) {
  float y;
  DAAM_EX2(y, x);
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from zero,
// as cvt.rna.tf32.f32 rounds it: half of the 13 dropped bits' range is added
// to the magnitude, then they are cleared (infinities and NaNs keep their
// class).  Two integer operations, which issue faster than the conversion
// instruction; tests/torch_emulate/run_case.cpp holds them to cvt.rna's
// definition.
__device__ __forceinline__ uint32_t tf32_round(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo + O(2^-22 x), hi and lo rounded to TF32.  With both operands
// split, hi·hi + hi·lo + lo·hi (3xTF32) is their fp32 product within
// ~2^-21 relative; lo·lo, ~2^-22, is dropped.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_round(x);
  lo = tf32_round(x - __uint_as_float(hi));
}

// The four fp32 values of an ldmatrix fragment (raw bits), split.
__device__ __forceinline__ void split_tf32(const uint32_t (&x)[4], uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(x[i]), hi[i], lo[i]);
}

// The lo part of an fp32 value x (raw bits) whose hi part is x itself, as
// the tensor core reads it: its top 19 bits.  x - hi is exact in fp32 and
// rounded to TF32 here, so hi + lo = x + O(2^-21 x).
__device__ __forceinline__ uint32_t tf32_lo(uint32_t x) {
  return tf32_round(__uint_as_float(x) - __uint_as_float(x & 0xffffe000u));
}

// d += a b on the tensor cores in 3xTF32 (mma.sync m16n8k8, fp32 sums).
__device__ __forceinline__ void mma_tf32x3(float (&d)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], uint32_t bh0,
                                           uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  hopper::mma_m16n8k8_tf32(d, al, bh0, bh1);
  hopper::mma_m16n8k8_tf32(d, ah, bl0, bl1);
  hopper::mma_m16n8k8_tf32(d, ah, bh0, bh1);
}

// The A fragment of P V's k8 step over the 8 keys of score fragment s, split.
// s gives lane (g, t) keys 2t and 2t + 1 of its n8 tile, and a k8 A
// fragment wants columns t and t + 4, so the step reads its column t as key
// 2t and its column t + 4 as key 2t + 1; the B fragment of V must take its
// rows in the same order (b0 = V[2t][n], b1 = V[2t + 1][n], n = 8 jd + g).
__device__ __forceinline__ void p_frag_tf32(const float (&s)[4], uint32_t (&ph)[4],
                                            uint32_t (&pl)[4]) {
  split_tf32(s[0], ph[0], pl[0]);  // (g, key 2t)
  split_tf32(s[2], ph[1], pl[1]);  // (g + 8, key 2t)
  split_tf32(s[1], ph[2], pl[2]);  // (g, key 2t + 1)
  split_tf32(s[3], ph[3], pl[3]);  // (g + 8, key 2t + 1)
}

// A warp's O += P V over 8 keys (rows key0 .. key0 + 7 of Vs, fp32 rows of
// STR floats, split here) in 3xTF32, P straight from its score fragment s.
template <int HD, int STR>
__device__ __forceinline__ void pv_tf32x3(float (&oacc)[HD / 8][4], const float (&s)[4],
                                          const float* Vs, int key0, int g, int t) {
  uint32_t ph[4], pl[4];
  p_frag_tf32(s, ph, pl);
  const float* vr = Vs + (key0 + 2 * t) * STR + g;
#pragma unroll
  for (int jd = 0; jd < HD / 8; ++jd) {
    uint32_t vh0, vl0, vh1, vl1;
    split_tf32(vr[8 * jd], vh0, vl0);
    split_tf32(vr[STR + 8 * jd], vh1, vl1);
    mma_tf32x3(oacc[jd], ph, pl, vh0, vh1, vl0, vl1);
  }
}

// ---------------------------------------------------------------------------
// flash_attention, fp32, on the tensor cores (mma.sync, 3xTF32)
// ---------------------------------------------------------------------------

constexpr int FT_BQ = 128;       // queries per block: 16 per warp
constexpr int FT_THREADS = 256;

// fp32 rows of hd + 4 floats: the eight 16-byte rows an ldmatrix reads, and
// a warp's 32 loads of a V fragment (rows 2t and 2t + 1, column g), each
// fall in 32 different banks (hd + 4 is 4 mod 8 at every head dim).  A
// stage of the ring holds a tile's k and v, each split into its TF32 hi
// and lo parts: four arrays of BK rows.  Only hd 160 comes here
// (wgmma_tf32x3_serves takes the others), where q and two stages of 32
// keys would need 246 KB, so a tile holds 16.
template <int HD>
struct FtTile {
  static constexpr int BK = 16;                       // keys per tile
  static constexpr int STR = HD + 4;
  static constexpr int KV = BK * STR;                 // floats of one array
  static constexpr int SMEM = (FT_BQ * STR + 2 * 4 * KV) * 4;  // q, two stages
  static constexpr int PIECES = BK * HD / 4;          // float4 of a k (v) tile
  static constexpr int LOADS = (PIECES + FT_THREADS - 1) / FT_THREADS;  // a thread's
};

template <int HD>
__global__ void __launch_bounds__(FT_THREADS, 1)
flash_attention_tf32x3_kernel(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, float* __restrict__ o, int H,
                              int Lq, int Lk, Strides qs, Strides ks, Strides vs,
                              float scale_log2) {
  using namespace hopper;
  using T = FtTile<HD>;
  constexpr int BK = T::BK, STR = T::STR, KV = T::KV;
  constexpr int CH = HD / 4;  // 16-byte chunks of a row
  DAAM_DYNAMIC_SMEM(float, ft_smem);
  float* Qs = ft_smem;
  float* KVs = Qs + FT_BQ * STR;  // stage s at KVs + 4 s KV: k hi, k lo, v hi, v lo

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * FT_BQ;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int n_tiles = (Lk + BK - 1) / BK;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;

  {  // q by cp.async, once; rows past Lq zero-filled
    const float* qb = q + b * qs.b + h * qs.h;
    for (int e = tid; e < FT_BQ * CH; e += FT_THREADS) {
      const int r = e / CH, c = e % CH;
      const bool in = q0 + r < Lq;
      cp_async16(smem_u32(Qs + r * STR + 4 * c), qb + (in ? q0 + r : 0) * qs.l + 4 * c,
                 in ? 16 : 0);
    }
    cp_async_commit();
  }
  // k and v tiles pass through registers: a thread holds T::LOADS 16-byte
  // pieces of each (rows past Lk as zeros: their scores are set to -inf,
  // and P = 0 must meet finite v), splits them once for the whole block and
  // stores both parts; the next tile's loads fly while this one's products
  // run.
  float4 kr[T::LOADS], vr[T::LOADS];
  auto fetch = [&](int tile) {
#pragma unroll
    for (int i = 0; i < T::LOADS; ++i) {
      const int e = tid + i * FT_THREADS, r = e / CH, c = e % CH, key = tile * BK + r;
      kr[i] = vr[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (e < T::PIECES && key < Lk) {
        kr[i] = *reinterpret_cast<const float4*>(kb + key * ks.l + 4 * c);
        vr[i] = *reinterpret_cast<const float4*>(vb + key * vs.l + 4 * c);
      }
    }
  };
  auto store_split = [&](int tile) {
    float* st = KVs + (tile % 2) * 4 * KV;
#pragma unroll
    for (int i = 0; i < T::LOADS; ++i) {
      const int e = tid + i * FT_THREADS, at = (e / CH) * STR + 4 * (e % CH);
      if (e >= T::PIECES) break;  // a thread's last piece, at hd 40 and 160
      const float4 x[2] = {kr[i], vr[i]};
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        uint4 hi, lo;
        split_tf32(x[m].x, hi.x, lo.x);
        split_tf32(x[m].y, hi.y, lo.y);
        split_tf32(x[m].z, hi.z, lo.z);
        split_tf32(x[m].w, hi.w, lo.w);
        *reinterpret_cast<uint4*>(st + 2 * m * KV + at) = hi;
        *reinterpret_cast<uint4*>(st + (2 * m + 1) * KV + at) = lo;
      }
    }
  };
  fetch(0);

  // Fragment addresses of this lane.  q: matrices (rows 0-7 | 8-15) x
  // (columns 8 kk + 0-3 | 4-7) of the warp's 16 rows give the A fragment of
  // the kk-th k8 step (ldmatrix reads each float as two b16 halves, so a
  // lane receives row lane / 4, column lane % 4).  k: matrices (keys 0-7 |
  // 8-15 of a 16-key pair) x (the two column halves) give b0, b1 of two n8
  // tiles.  v: rows 2t and 2t + 1 of an 8-key step, column g (p_frag_tf32).
  const uint32_t q_lane = smem_u32(Qs + (warp * 16 + lane % 16) * STR + 4 * (lane / 16));
  const int k_lane = (8 * (lane / 16) + lane % 8) * STR + 4 * ((lane / 8) % 2);
  const int v_lane = 2 * t * STR + g;

  float oacc[HD / 8][4];
#pragma unroll
  for (int jd = 0; jd < HD / 8; ++jd)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[jd][e] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max of rows g, g + 8 (log2 domain)
  float l0 = 0.f, l1 = 0.f;              // this thread's share of the sums
  cp_async_wait<0>();

  for (int tile = 0; tile < n_tiles; ++tile) {
    store_split(tile);
    if (tile + 1 < n_tiles) fetch(tile + 1);
    // The stage is complete, and every warp is done with the tile that
    // last used it (tile - 2: it passed this barrier's predecessor after).
    __syncthreads();
    const float* Kh = KVs + (tile % 2) * 4 * KV;
    const float* Kl = Kh + KV;
    const float* Vh = Kh + 2 * KV;
    const float* Vl = Kh + 3 * KV;

    // S = Q Kᵀ; s[j] is mma's D layout: rows g and g + 8 at keys
    // 8 j + 2t + {0, 1} of the tile.
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 8; ++kk) {
      uint32_t qa[4], qh[4], ql[4];
      ldmatrix_x4(qa, q_lane + 32 * kk);
      split_tf32(qa, qh, ql);
#pragma unroll
      for (int jp = 0; jp < BK / 16; ++jp) {
        uint32_t kh[4], kl[4];
        ldmatrix_x4(kh, smem_u32(Kh + 16 * jp * STR + k_lane + 8 * kk));
        ldmatrix_x4(kl, smem_u32(Kl + 16 * jp * STR + k_lane + 8 * kk));
        mma_tf32x3(s[2 * jp], qh, ql, kh[0], kh[1], kl[0], kl[1]);
        mma_tf32x3(s[2 * jp + 1], qh, ql, kh[2], kh[3], kl[2], kl[3]);
      }
    }
    if ((tile + 1) * BK > Lk) {  // keys past Lk scored 0 on their zero rows
      const int col0 = tile * BK + 2 * t;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col0 + 8 * j + (e & 1) >= Lk) s[j][e] = -INFINITY;
    }

    // Online softmax over the tile, rows reduced across the 4 lanes of a
    // quad.  Key 0 lies in the first tile, so the new max is finite and the
    // first tile's correction is exp2(-inf) = 0.
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int x = 1; x < 4; x <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
    }
    const float mn0 = fmaxf(m0, mx0 * scale_log2);
    const float mn1 = fmaxf(m1, mx1 * scale_log2);
    const float c0 = ex2(m0 - mn0), c1 = ex2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 *= c0;
    l1 *= c1;
#pragma unroll
    for (int jd = 0; jd < HD / 8; ++jd) {
      oacc[jd][0] *= c0;
      oacc[jd][1] *= c0;
      oacc[jd][2] *= c1;
      oacc[jd][3] *= c1;
    }
    // Unnormalized P = exp(s - m) in fp32 (the Pallas body's p.astype(v.dtype)
    // is no rounding in fp32), summed, and O += P V per 8 keys.
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      s[j][0] = ex2(fmaf(s[j][0], scale_log2, -mn0));
      s[j][1] = ex2(fmaf(s[j][1], scale_log2, -mn0));
      s[j][2] = ex2(fmaf(s[j][2], scale_log2, -mn1));
      s[j][3] = ex2(fmaf(s[j][3], scale_log2, -mn1));
      l0 += s[j][0] + s[j][1];
      l1 += s[j][2] + s[j][3];
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      if (tile * BK + 8 * j >= Lk) continue;  // keys wholly past Lk
      uint32_t ph[4], pl[4];
      p_frag_tf32(s[j], ph, pl);
      const int at = 8 * j * STR + v_lane;
#pragma unroll
      for (int jd = 0; jd < HD / 8; ++jd)
        mma_tf32x3(oacc[jd], ph, pl, __float_as_uint(Vh[at + 8 * jd]),
                   __float_as_uint(Vh[at + STR + 8 * jd]), __float_as_uint(Vl[at + 8 * jd]),
                   __float_as_uint(Vl[at + STR + 8 * jd]));
    }
  }

  // O / l, (B, Lq, H*hd): a quad's four lanes store a row's 32 bytes of an
  // n8 tile.
#pragma unroll
  for (int x = 1; x < 4; x <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, x);
    l1 += __shfl_xor_sync(0xffffffffu, l1, x);
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const int r = q0 + warp * 16 + g;
  const long long row = (long long)H * HD;
  float* ob = o + (long long)b * Lq * row + h * HD + 2 * t;
  if (r < Lq) {
#pragma unroll
    for (int jd = 0; jd < HD / 8; ++jd)
      *reinterpret_cast<float2*>(ob + r * row + 8 * jd) =
          make_float2(oacc[jd][0] * inv0, oacc[jd][1] * inv0);
  }
  if (r + 8 < Lq) {
#pragma unroll
    for (int jd = 0; jd < HD / 8; ++jd)
      *reinterpret_cast<float2*>(ob + (r + 8) * row + 8 * jd) =
          make_float2(oacc[jd][2] * inv1, oacc[jd][3] * inv1);
  }
}

// ---------------------------------------------------------------------------
// flash_attention, fp32, on the tensor cores (wgmma, 3xTF32)
// ---------------------------------------------------------------------------

constexpr int WT_BQ = 128;            // queries per block: 64 per consumer warpgroup
constexpr int WT_THREADS = 256;       // two warpgroups; thread 0 also copies
// (a ninth warp would put three warps on one of the SM's four register files
// and cap every thread at 168 registers, as ptxas compiles a 288- or
// 384-thread block, setmaxnreg or not)
constexpr int WT_SPLIT_THREADS = 128;

// The head dims flash_attention_tf32x3_wgmma_kernel serves; the others stay
// on flash_attention_tf32x3_kernel (mma.sync).  A thread holds its O
// fragment (hd / 2 floats), Q's hi fragment (hd / 2) and a 32- or 64-key S
// fragment; at hd 160 the block's Q lo and two 32-key stages would pass
// 227 KB of shared memory.
constexpr bool wgmma_tf32x3_serves(int hd) {
  return hd == 16 || hd == 32 || hd == 40 || hd == 64 || hd == 80 || hd == 128;
}

// One stage image: a tile of BK keys of k and v, each split into its TF32
// hi and lo parts, laid out as wgmma reads K-major B operands:
// - k hi and k lo (keys x hd, hd contiguous) as hd / 8 panels of BK rows of
//   32 bytes (one k8 step of S = Q Kᵀ each), 32-byte swizzle;
// - vᵀ hi and vᵀ lo (hd x keys, keys contiguous) as BK / 32 panels of hd
//   rows of 128 bytes (four k8 steps of O += P V each), 128-byte swizzle,
//   the columns of each 8 keys permuted (wt_v_at).
// split_kv_tf32x3_kernel writes the images of every tile to device memory
// once per call, and flash_attention_tf32x3_wgmma_kernel copies them whole
// into a ring of STAGES stages, beside Q's lo part.  Past hd 64 the tiles
// hold 32 keys, so that three stages fit 227 KB at hd 80 and two at 128.
template <int HD>
struct WtTile {
  static constexpr int BK = HD > 64 ? 32 : 64;        // keys per tile
  static constexpr int CH = HD / 4;                   // 16-byte chunks of a row
  static constexpr int PART = BK * HD * 4;            // bytes of one split part
  static constexpr int STAGE = 4 * PART;              // k hi, k lo, vᵀ hi, vᵀ lo
  static constexpr int QLO = 64 * HD * 4;             // a warpgroup's Q lo
  static constexpr int STAGES = 1024 + 3 * STAGE + 2 * QLO + 48 <= 227 * 1024 ? 3 : 2;
  static constexpr int SMEM = 1024 + STAGES * STAGE + 2 * QLO + 16 * STAGES;
  static_assert(PART % 1024 == 0, "WtTile: hd must be a multiple of 8");
};

// Byte offset of element (row r, column 4 c) in a k part of BK rows (or in
// a warpgroup's Q lo, 64 rows): panel c / 2, row r, 16-byte unit c % 2
// swizzled by bit 2 of the row (32-byte swizzle: address bit 4 ^= bit 7).
template <int BK>
__device__ __forceinline__ int wt_k_at(int r, int c) {
  return (c / 2) * BK * 32 + r * 32 + (((c ^ (r >> 2)) & 1) << 4);
}

// Byte offset of v's element (key r, column d) in a vᵀ part.  The S
// fragment gives lane (g, t) keys 2t and 2t + 1 of each n8 tile, and P goes
// in as the A fragment of a k8 step unshuffled, whose columns t and t + 4
// those keys become; so key r of each 8 is column (r % 8) / 2 + 4 (r % 2)
// of its k8 step, and vᵀ's row d holds the keys in that order.  Panel
// col / 32, row d, 16-byte unit (col % 32) / 4 swizzled by d % 8 (128-byte
// swizzle: address bits 4-6 ^= bits 7-9).
template <int HD>
__device__ __forceinline__ int wt_v_at(int r, int d) {
  const int col = (r & ~7) | ((r & 7) >> 1) | ((r & 1) << 2);
  const int c32 = col % 32;
  return (col / 32) * HD * 128 + d * 128 + ((((c32 >> 2) ^ d) & 7) << 4) + (c32 & 3) * 4;
}

// Block (tile, h, b): the stage image of keys tile * BK .. + BK - 1 of head h
// of sample b (keys past Lk as zeros: their scores are set to -inf, and
// P = 0 must meet finite v), built in shared memory and written to
// kv[b][h][tile] with 16-byte stores.
template <int HD>
__global__ void __launch_bounds__(WT_SPLIT_THREADS)
split_kv_tf32x3_kernel(const float* __restrict__ k, const float* __restrict__ v,
                       uint8_t* __restrict__ kv, int H, int Lk, int n_tiles, Strides ks,
                       Strides vs) {
  using T = WtTile<HD>;
  constexpr int BK = T::BK;
  DAAM_DYNAMIC_SMEM(uint8_t, img);
  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;
  // k: 8 keys by 4 chunks a warp, so each key's row is read 64 bytes at a
  // time and eight lanes in a row store to eight different rows of a panel.
  for (int e = threadIdx.x; e < BK * T::CH; e += WT_SPLIT_THREADS) {
    const int c = (e / 8) % T::CH, r = 8 * (e / (8 * T::CH)) + e % 8;
    const int key = tile * BK + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (key < Lk) x = *reinterpret_cast<const float4*>(kb + key * ks.l + 4 * c);
    uint4 hi, lo;
    split_tf32(x.x, hi.x, lo.x);
    split_tf32(x.y, hi.y, lo.y);
    split_tf32(x.z, hi.z, lo.z);
    split_tf32(x.w, hi.w, lo.w);
    *reinterpret_cast<uint4*>(img + wt_k_at<BK>(r, c)) = hi;
    *reinterpret_cast<uint4*>(img + T::PART + wt_k_at<BK>(r, c)) = lo;
  }
  // v transposed: a warp's lanes take 32 consecutive keys of one chunk, so
  // its stores into a vᵀ row (one panel) hit 32 banks.
  for (int e = threadIdx.x; e < BK * T::CH; e += WT_SPLIT_THREADS) {
    const int r = e % BK, c = e / BK, key = tile * BK + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (key < Lk) x = *reinterpret_cast<const float4*>(vb + key * vs.l + 4 * c);
    const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t hi, lo;
      split_tf32(xs[j], hi, lo);
      *reinterpret_cast<uint32_t*>(img + 2 * T::PART + wt_v_at<HD>(r, 4 * c + j)) = hi;
      *reinterpret_cast<uint32_t*>(img + 3 * T::PART + wt_v_at<HD>(r, 4 * c + j)) = lo;
    }
  }
  __syncthreads();
  uint4* out = reinterpret_cast<uint4*>(
      kv + (((long long)b * H + h) * n_tiles + tile) * T::STAGE);
  for (int i = threadIdx.x; i < T::STAGE / 16; i += WT_SPLIT_THREADS)
    out[i] = reinterpret_cast<const uint4*>(img)[i];
}

template <int HD>
__global__ void __launch_bounds__(WT_THREADS, 1)
flash_attention_tf32x3_wgmma_kernel(const float* __restrict__ q, const uint8_t* __restrict__ kv,
                                    float* __restrict__ o, int H, int Lq, int Lk, Strides qs,
                                    float scale_log2) {
  using namespace hopper;
  using T = WtTile<HD>;
  constexpr int BK = T::BK, STAGES = T::STAGES;
  DAAM_DYNAMIC_SMEM(uint8_t, wt_smem);
  // 128-byte swizzle repeats every 1024 bytes; the ring starts on that
  // boundary (every part is a multiple of 1024 bytes).
  const uint32_t ring = (smem_u32(wt_smem) + 1023) & ~1023u;
  const uint32_t qlo = ring + STAGES * T::STAGE;   // + wg * T::QLO
  const uint32_t full = qlo + 2 * T::QLO;          // + 8 * stage
  const uint32_t empty = full + 8 * STAGES;        // + 8 * stage

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * WT_BQ;
  const int n_tiles = (Lk + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);     // thread 0's arrival, then the bytes
      mbar_init(empty + 8 * s, 256);  // every thread, after its products
    }
    fence_barrier_init();
  }
  __syncthreads();

  // Thread 0 also keeps the stage images in flight, one bulk copy of
  // T::STAGE bytes a tile: up to STAGES tiles ahead, as the stages come
  // free (test_wait: it does not block its warpgroup on the other), and
  // blocking only for the tile about to be consumed.
  const uint8_t* src = kv + ((long long)b * H + h) * n_tiles * T::STAGE;
  int next_load = 0;
  auto refill = [&](int upto, bool block) {
    for (upto = min(upto, n_tiles); next_load < upto; ++next_load) {
      const int s = next_load % STAGES;
      const uint32_t parity = ((next_load / STAGES) & 1) ^ 1;  // its previous use done
      if (block) mbar_wait(empty + 8 * s, parity);
      else if (!mbar_test(empty + 8 * s, parity)) break;
      mbar_arrive_expect_tx(full + 8 * s, T::STAGE);
      bulk_load(ring + s * T::STAGE, src + (long long)next_load * T::STAGE, T::STAGE,
                full + 8 * s);
    }
  };

  // Warpgroup wg owns queries q0 + 64 wg .. + 63; a thread holds rows r and
  // r + 8 (r = 16 warp + lane / 4) of S and O (wgmma_tf32_rs).
  const int lane = threadIdx.x % 32;
  const int warp = (threadIdx.x % 128) / 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = q0 + wg * 64 + warp * 16 + g;

  // Q's A fragments, split once: hd / 8 k8 steps of 4 hi in registers;
  // the lo parts go to the warpgroup's Q lo in shared memory, laid out as a
  // k part of 64 rows (the (Q lo, k hi) product reads them from there).
  // With lo in registers too, ptxas gave some of them to P's lo part in the
  // loop at hd 64, and the next tile's S read P lo as Q lo.
  uint32_t qh[HD / 8][4];
  uint8_t* qlo_wg = wt_smem + (qlo - smem_u32(wt_smem)) + wg * T::QLO;
  {
    const float* qb = q + b * qs.b + h * qs.h;
#pragma unroll
    for (int kk = 0; kk < HD / 8; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = r0 + 8 * (i & 1), col = 8 * kk + t + 4 * (i >> 1);
        uint32_t lo;
        split_tf32(row < Lq ? qb[row * qs.l + col] : 0.f, qh[kk][i], lo);
        const int r = warp * 16 + g + 8 * (i & 1);  // row within the warpgroup
        *reinterpret_cast<uint32_t*>(qlo_wg + wt_k_at<64>(r, 2 * kk + (i >> 1)) + 4 * t) = lo;
      }
  }
  fence_proxy_async();  // the Q lo stores, before wgmma reads them
  __syncthreads();
  const uint64_t ql = make_desc(qlo + wg * T::QLO, 16, 256, 3);
  float oacc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) oacc[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max, log2 domain
  float l0 = 0.f, l1 = 0.f;              // this thread's share of the sums

  for (int tile = 0; tile < n_tiles; ++tile) {
    if (threadIdx.x == 0) {
      refill(tile + 1, true);
      refill(tile + STAGES, false);
    }
    __syncwarp();
    const int s = tile % STAGES;
    mbar_wait(full + 8 * s, (tile / STAGES) & 1);
    // One descriptor per part; a step adds its byte offset / 16 to the
    // start address field.
    const uint32_t st = ring + s * T::STAGE;
    const uint64_t kh = make_desc(st, 16, 256, 3), kl = make_desc(st + T::PART, 16, 256, 3);
    const uint64_t vh = make_desc(st + 2 * T::PART, 16, 1024, 1);
    const uint64_t vl = make_desc(st + 3 * T::PART, 16, 1024, 1);

    // S = Q Kᵀ in 3xTF32, small terms first: k8 step kk reads panel kk of
    // Q lo and of the k parts (SBO: 8 rows of 32 bytes).
    float sacc[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sacc[i] = 0.f;
    fence_regs(sacc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 8; ++kk) {
      const uint32_t off = kk * BK * 32 / 16;
      wgmma_tf32_ss<BK>(sacc, ql + kk * 64 * 32 / 16, kh + off, kk > 0);
      wgmma_tf32_rs<BK>(sacc, qh[kk], kl + off, 1);
      wgmma_tf32_rs<BK>(sacc, qh[kk], kh + off, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sacc);

    // Keys past Lk were zero-filled, which scores 0, not -inf.
    if ((tile + 1) * BK > Lk) {
      const int col0 = tile * BK + 2 * t;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col0 + 8 * j + (e & 1) >= Lk) sacc[4 * j + e] = -INFINITY;
    }

    // Online softmax over the tile, rows reduced across the 4 lanes of a
    // quad.  Key 0 lies in the first tile, so the new max is finite and
    // the first tile's correction is exp2(-inf) = 0.
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(sacc[4 * j], sacc[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(sacc[4 * j + 2], sacc[4 * j + 3]));
    }
#pragma unroll
    for (int x = 1; x < 4; x <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
    }
    const float mn0 = fmaxf(m0, mx0 * scale_log2);
    const float mn1 = fmaxf(m1, mx1 * scale_log2);
    const float c0 = ex2(m0 - mn0), c1 = ex2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 *= c0;
    l1 *= c1;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      oacc[4 * j] *= c0;
      oacc[4 * j + 1] *= c0;
      oacc[4 * j + 2] *= c1;
      oacc[4 * j + 3] *= c1;
    }
    // Unnormalized P = exp(s - m) in fp32, in place (the Pallas body's
    // p.astype(v.dtype) is no rounding in fp32), summed.  The S fragment
    // of n8 tile j holds (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1);
    // P is stored as (g, 2t), (g + 8, 2t), (g, 2t + 1), (g + 8, 2t + 1),
    // the A fragment of k8 step j of P V (rows g, g + 8, g, g + 8), whose
    // columns t and t + 4 the keys 2t and 2t + 1 become (wt_v_at), so
    // four consecutive registers go in as they are.
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const float p00 = ex2(fmaf(sacc[4 * j], scale_log2, -mn0));
      const float p01 = ex2(fmaf(sacc[4 * j + 1], scale_log2, -mn0));
      const float p10 = ex2(fmaf(sacc[4 * j + 2], scale_log2, -mn1));
      const float p11 = ex2(fmaf(sacc[4 * j + 3], scale_log2, -mn1));
      l0 += p00 + p01;
      l1 += p10 + p11;
      sacc[4 * j] = p00;
      sacc[4 * j + 1] = p10;
      sacc[4 * j + 2] = p01;
      sacc[4 * j + 3] = p11;
    }

    // O += P V in 3xTF32.  P's hi is P itself (the tensor core reads its
    // top 19 bits), so P hi·(vᵀ lo, vᵀ hi) go first, straight from the
    // S fragment; then P lo = tf32(P - hi) replaces P in place for
    // P lo·vᵀ hi.  k8 step u reads keys 8u .. 8u + 7, 32 bytes on along a
    // 128-byte row of vᵀ, a panel (hd rows, SBO 8 rows of 128 bytes) per
    // 4 steps.
    auto pv = [&](uint64_t vt, int u) {
      const uint32_t pa[4] = {__float_as_uint(sacc[4 * u]), __float_as_uint(sacc[4 * u + 1]),
                              __float_as_uint(sacc[4 * u + 2]),
                              __float_as_uint(sacc[4 * u + 3])};
      wgmma_tf32_rs<HD>(oacc, pa, vt + ((u / 4) * HD * 128 + (u % 4) * 32) / 16, 1);
    };
    fence_regs(sacc);
    fence_regs(oacc);
    wgmma_fence();
#pragma unroll
    for (int u = 0; u < BK / 8; ++u) {
      pv(vl, u);
      pv(vh, u);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(oacc);
    fence_regs(sacc);
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sacc[i] = __uint_as_float(tf32_lo(__float_as_uint(sacc[i])));
    fence_regs(sacc);
    wgmma_fence();
#pragma unroll
    for (int u = 0; u < BK / 8; ++u) pv(vh, u);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(oacc);
    mbar_arrive(empty + 8 * s);  // this thread's products have read stage s
  }

  // O / l, (B, Lq, H*hd): a quad's four lanes store a row's 32 bytes of an
  // n8 tile.
#pragma unroll
  for (int x = 1; x < 4; x <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, x);
    l1 += __shfl_xor_sync(0xffffffffu, l1, x);
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const long long row = (long long)H * HD;
  float* ob = o + (long long)b * Lq * row + h * HD + 2 * t;
  if (r0 < Lq) {
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<float2*>(ob + r0 * row + 8 * j) =
          make_float2(oacc[4 * j] * inv0, oacc[4 * j + 1] * inv0);
  }
  if (r0 + 8 < Lq) {
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<float2*>(ob + (r0 + 8) * row + 8 * j) =
          make_float2(oacc[4 * j + 2] * inv1, oacc[4 * j + 3] * inv1);
  }
}

// ---------------------------------------------------------------------------
// flash_attention, bf16, on the tensor cores (wgmma + TMA)
// ---------------------------------------------------------------------------

constexpr int TC_BQ = 128;        // queries per block: 64 per consumer warpgroup
constexpr int TC_BK = 128;        // keys per tile
constexpr int TC_THREADS = 384;   // warpgroups 0 and 1 compute, 2 loads
static_assert(TC_BQ == TC_BK, "one TMA box shape serves q, k and v");

// Shared-memory tiles hold rows of bf16 values in panels of PW columns,
// PW * 2 bytes = the swizzle span (128, 64 or 32 bytes), and each panel is
// one TMA box.  hd 16 and 32 are one narrow panel; any other hd takes
// 64-column panels, as many as cover it (40: one, 80 and 128: two, 160:
// three), HDP columns in all.  The tensor maps' inner dimension is hd, so
// a box's columns past hd arrive as zeros (TMA's out-of-bounds fill) and
// are never read from device memory: they add 0 to every score, and their
// columns of O, which are 0, are not stored.  S = Q K^T takes only the k16
// steps that reach a column below hd.  Three 48 KB tiles in each of two
// stages would pass 227 KB at hd 160, so its K/V ring has one stage.
template <int HD>
struct TcTile {
  static constexpr int PW = HD == 16 || HD == 32 ? HD : 64;
  static constexpr int NP = (HD + PW - 1) / PW;
  static constexpr int HDP = NP * PW;                // columns computed on
  static constexpr int KSTEPS = (HD + 15) / 16;      // k16 steps of S = Q K^T
  static constexpr int STAGES = HD > 128 ? 1 : 2;    // depth of the K/V ring
  // Keys per S sub-tile, the consumers' step through a tile: past hd 128
  // the O fragments (96 floats a thread at hd 160) beside a 128-key S
  // fragment would pass the 168 registers a thread of the 384 is compiled
  // for, so S and P go 64 keys at a time.
  static constexpr int SK = HD > 128 ? 64 : TC_BK;
  static constexpr int ROW = PW * 2;                 // bytes of a panel row
  static constexpr uint32_t LAYOUT = PW == 64 ? 1 : PW == 32 ? 2 : 3;
  static constexpr int PANEL = TC_BK * ROW;          // bytes of one panel
  static constexpr int BYTES = NP * PANEL;           // one q, k or v tile
  static constexpr int SMEM = 1024 + (1 + 2 * STAGES) * BYTES + 8 * (1 + 2 * STAGES);
};

#ifndef DAAM_EMULATE
// O (64 x N, fp32, N = HDP) += P (64 x 16, bf16 registers) V (16 x N), V's
// panels PANEL bytes apart from v in shared memory: one wgmma up to 128
// columns; 192 columns (hd 160) as 128 and 64, on the first two panels and
// on the third.
// S (64 x N, fp32) = Q (64 x 16) K^T (16 x N), both in shared memory, for
// an S sub-tile of N = 128 or 64 keys.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                                         int scale_d) {
  if constexpr (N == 128) {
    hopper::wgmma_m64n128k16_ss(d, da, db, scale_d);
  } else {
    static_assert(N == 64, "wgmma_ss: N must be 64 or 128");
    hopper::wgmma_m64n64k16_ss(d, da, db, scale_d);
  }
}

template <int N, int PANEL>
__device__ __forceinline__ void wgmma_pv(float (&o)[N / 2], const uint32_t (&p)[4],
                                         uint32_t v, uint32_t sbo, uint32_t layout) {
  using namespace hopper;
  if constexpr (N <= 128) {
    wgmma_rs_tb<N>(o, p, make_desc(v, PANEL, sbo, layout));
  } else {
    static_assert(N == 192, "wgmma_pv: N must be at most 128, or 192");
    wgmma_rs_tb<128>(*reinterpret_cast<float(*)[64]>(o), p, make_desc(v, PANEL, sbo, layout));
    wgmma_rs_tb<64>(*reinterpret_cast<float(*)[32]>(o + 64), p,
                    make_desc(v + 2 * PANEL, PANEL, sbo, layout));
  }
}

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
  constexpr int STAGES = T::STAGES;
  const uint32_t q_s = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t k_s = q_s + T::BYTES;                  // + stage * T::BYTES
  const uint32_t v_s = k_s + STAGES * T::BYTES;
  const uint32_t q_full = v_s + STAGES * T::BYTES;
  const uint32_t kv_full = q_full + 8;                  // + 8 * stage
  const uint32_t kv_empty = kv_full + 8 * STAGES;       // + 8 * stage

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * TC_BQ;
  const int n_tiles = (Lk + TC_BK - 1) / TC_BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
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
        const int s = t % STAGES;
        mbar_wait(kv_empty + 8 * s, ((t / STAGES) & 1) ^ 1);
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
    constexpr int SK = T::SK;

    float oacc[T::HDP / 2];  // columns past hd stay 0 and are not stored
#pragma unroll
    for (int i = 0; i < T::HDP / 2; ++i) oacc[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY;  // running max, log2 domain
    float l0 = 0.f, l1 = 0.f;              // this thread's share of the sums

    mbar_wait(q_full, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % STAGES;
      mbar_wait(kv_full + 8 * s, (t / STAGES) & 1);
#pragma unroll 1
      for (int sub = 0; sub < TC_BK / SK; ++sub) {
        // keys t·TC_BK + sub·SK .. + SK - 1: SK rows further on in every panel
        const int key0 = t * TC_BK + sub * SK;
        const uint32_t k_t = k_s + s * T::BYTES + sub * SK * T::ROW;
        const uint32_t v_t = v_s + s * T::BYTES + sub * SK * T::ROW;

        // S = Q Kᵀ: q and k rows are K-major (hd contiguous); step 16 of hd
        // at a time, 32 bytes along the swizzled row of a panel, up to the
        // step that holds column hd - 1 (the zero columns of hd 40's last
        // step add nothing).
        float sacc[SK / 2];
#pragma unroll
        for (int i = 0; i < SK / 2; ++i) sacc[i] = 0.f;
        fence_regs(sacc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < T::KSTEPS; ++kk) {
          const uint32_t off = (kk / (T::PW / 16)) * T::PANEL + (kk % (T::PW / 16)) * 32;
          wgmma_ss<SK>(sacc, make_desc(q_wg + off, 16, 8 * T::ROW, T::LAYOUT),
                       make_desc(k_t + off, 16, 8 * T::ROW, T::LAYOUT), kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sacc);

        // Keys past Lk were zero-filled by TMA, which scores 0, not -inf.
        if (key0 + SK > Lk) {
          const int col0 = key0 + 2 * quad;
#pragma unroll
          for (int j = 0; j < SK / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (col0 + 8 * j + (e & 1) >= Lk) sacc[4 * j + e] = -INFINITY;
        }

        // Online softmax over the keys, rows reduced across the 4 lanes of a
        // quad.
        float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
        for (int j = 0; j < SK / 8; ++j) {
          mx0 = fmaxf(mx0, fmaxf(sacc[4 * j], sacc[4 * j + 1]));
          mx1 = fmaxf(mx1, fmaxf(sacc[4 * j + 2], sacc[4 * j + 3]));
        }
#pragma unroll
        for (int x = 1; x < 4; x <<= 1) {
          mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
          mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
        }
        // Key 0 lies in the first keys, so the new max is finite and their
        // correction is exp2(-inf) = 0; keys wholly past Lk keep the max
        // (correction 1) and add P = 0.
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
        uint32_t pa[SK / 16][4];
#pragma unroll
        for (int u = 0; u < SK / 16; ++u) {
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
        for (int j = 0; j < T::HDP / 8; ++j) {
          oacc[4 * j] *= c0;
          oacc[4 * j + 1] *= c0;
          oacc[4 * j + 2] *= c1;
          oacc[4 * j + 3] *= c1;
        }

        // O += P V: v rows are MN-major for this product (hd contiguous), so
        // the transposed-B form; a k16 step is 16 key rows further on, and
        // the panels lie T::PANEL bytes apart along N.
        fence_regs(oacc);
        wgmma_fence();
#pragma unroll
        for (int u = 0; u < SK / 16; ++u)
          wgmma_pv<T::HDP, T::PANEL>(oacc, pa[u], v_t + u * 16 * T::ROW, 8 * T::ROW,
                                     T::LAYOUT);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(oacc);
      }

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
// cross_attention_acc and cross_attention_probs, bf16, on the tensor cores
// ---------------------------------------------------------------------------

constexpr int MA_BQ = 64;             // queries per block: 16 per warp
constexpr int MA_THREADS = 128;
constexpr int MA_KC = 80;             // keys per chunk: Lk = 77 is one chunk
constexpr int MA_NT = MA_KC / 8;      // n8 tiles of a chunk's scores
constexpr int MA_ASTR = MA_BQ + 4;    // fp32 row stride of the acc tile

// The head dim the bf16 products run on: hd rounded up to the k16 step of
// mma.sync m16n8k16 (40 -> 48; every other head dim is a multiple of 16).
// The columns past hd are zero in shared memory only.
__host__ __device__ constexpr int ma_hdp(int hd) { return (hd + 15) / 16 * 16; }

// Dynamic shared memory of a block: the q tile and all of k and v in bf16
// rows of ma_hdp(hd) + 8 elements (the 16-byte pad sends the eight rows an
// ldmatrix reads to eight different bank groups: a row is an odd number of
// 16-byte units, 3, 5, 7, 9, 11, 17 or 21), then the epilogue's tile: one
// chunk of acc rows (p_size 0), or the block's span of P with up to 16
// bytes of lead (p_size = sizeof P's type).
inline long long ma_smem_bytes(int hd, long long Lk, int p_size) {
  const long long lkp = (Lk + 15) & ~15LL;
  const long long qkv = (MA_BQ + 2 * lkp) * (ma_hdp(hd) + 8) * 2;
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

// Pass 1's step over one chunk of scores s (mma's D layout, log2 domain,
// keys past Lk at -inf): the running maxima m0, m1 of rows g and g + 8,
// reduced over the 4 lanes of a quad, and this thread's partial sums l0, l1
// of exp2(s - m).  Key 0 lies in chunk 0, so the new max is finite and the
// first correction is exp2(-inf) = 0.
__device__ __forceinline__ void ma_row_stats(const float (&s)[MA_NT][4], float& m0,
                                             float& m1, float& l0, float& l1) {
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

// Scores to normalized fp32 P in place, given pass 1's maxima and the
// inverses of the quad-reduced sums.
__device__ __forceinline__ void ma_normalize(float (&s)[MA_NT][4], float m0, float m1,
                                             float inv0, float inv1) {
#pragma unroll
  for (int j = 0; j < MA_NT; ++j) {
    s[j][0] = ex2(s[j][0] - m0) * inv0;
    s[j][1] = ex2(s[j][1] - m0) * inv0;
    s[j][2] = ex2(s[j][2] - m1) * inv1;
    s[j][3] = ex2(s[j][3] - m1) * inv1;
  }
}

// K1's accumulator tile: acc rows c0 .. c0 + rows - 1 (rows = min(MA_KC,
// Lk - c0)) of the block's 64 columns, acc_bh = acc[b, h, 0, q0], copied
// into At ([key][query], row stride MA_ASTR) 16 bytes a copy (Lq % 4 == 0,
// so a copy is wholly inside or past Lq), as one committed group.
__device__ __forceinline__ void ma_load_acc(float* At, const float* acc_bh, int c0, int Lk,
                                            int Lq, int q0, int tid) {
  const int rows = min(MA_KC, Lk - c0);
  for (int e = tid; e < rows * (MA_BQ / 4); e += MA_THREADS) {
    const int r = e / (MA_BQ / 4), c = e % (MA_BQ / 4);
    if (q0 + 4 * c < Lq)
      hopper::cp_async16(hopper::smem_u32(At + r * MA_ASTR + 4 * c),
                         acc_bh + (long long)(c0 + r) * Lq + 4 * c, 16);
  }
  hopper::cp_async_commit();
}

// acc += Pᵀ for the chunk at c0, P in mma's D layout (rows qr, qr + 8 of the
// block at keys c0 + 8 j + 2t + {0, 1}): waits for the tile, adds P into it
// (a warp's 32 adds of one fragment slot, 4 keys x 8 queries, hit 32 banks)
// and writes it back with 16-byte stores.  Each acc element belongs to this
// block alone: no atomics, and the sum is deterministic.
__device__ __forceinline__ void ma_add_acc(float* At, float* acc_bh,
                                           const float (&s)[MA_NT][4], int c0, int Lk,
                                           int Lq, int q0, int qr, int t, int tid) {
  const int rows = min(MA_KC, Lk - c0);
  hopper::cp_async_wait<0>();
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
}

// K5's staging of a chunk's normalized P, in mma's D layout (rows qr, qr + 8
// of the block at keys 8 j + 2t + {0, 1} of the chunk), as PT at
// dst[row * stride + key] for the block's rows below `rows` and the chunk's
// keys below `keys`.
template <typename PT>
__device__ __forceinline__ void ma_stage_p(PT* dst, const float (&s)[MA_NT][4], int stride,
                                           int keys, int rows, int qr, int t) {
#pragma unroll
  for (int j = 0; j < MA_NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = 8 * j + 2 * t + (e & 1);
      const int row = qr + 8 * (e >> 1);
      if (key < keys && row < rows) dst[row * stride + key] = from_f<PT>(s[j][e]);
    }
}

// The offset mod 16 bytes, in elements, of a P span: staged at Ps + lead,
// the span and its staging copy agree mod 16 bytes.
template <typename PT>
__device__ __forceinline__ int ma_lead(const PT* span) {
  return (int)((reinterpret_cast<uintptr_t>(span) / sizeof(PT)) % (16 / sizeof(PT)));
}

// K5's block rows of P are one contiguous span of n elements: written from
// its staging copy Ps[lead ..] with 16-byte stores, and scalar ones for the
// head before the first 16-byte boundary and for the tail.
template <typename PT>
__device__ __forceinline__ void ma_store_span(PT* span, const PT* Ps, int lead, int n,
                                              int tid) {
  constexpr int VEC = 16 / sizeof(PT);
  const int head = min(n, (VEC - lead) % VEC);
  const int nvec = (n - head) / VEC;
  for (int i = tid; i < head; i += MA_THREADS) span[i] = Ps[lead + i];
  for (int i = tid; i < nvec; i += MA_THREADS)
    *reinterpret_cast<uint4*>(span + head + i * VEC) =
        *reinterpret_cast<const uint4*>(Ps + lead + head + i * VEC);
  for (int i = head + nvec * VEC + tid; i < n; i += MA_THREADS) span[i] = Ps[lead + i];
}

// ACC: acc += Pᵀ (cross_attention_acc); otherwise P is written out as PT
// (cross_attention_probs), skipping samples b < skip_b.  hd 40 runs on 48
// columns (ma_hdp): its q, k and v rows are zero-filled past hd in shared
// memory, which adds 0 to the scores and gives O columns that are not
// stored.  Past hd 64 the O fragments (hd / 2 floats a thread) leave room
// for two blocks an SM, not three.
template <int HD, typename PT, bool ACC>
__global__ void __launch_bounds__(MA_THREADS, HD <= 64 ? 3 : 2)
cross_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           __nv_bfloat16* __restrict__ o, float* __restrict__ acc,
                           PT* __restrict__ p, int H, int Lq, int Lk, int skip_b,
                           Strides qs, Strides ks, Strides vs, float scale_log2) {
  using namespace hopper;
  using bf16 = __nv_bfloat16;
  constexpr int HDP = ma_hdp(HD);  // columns the products run on
  constexpr int STR = HDP + 8;     // bf16 row stride of the q, k and v tiles
  constexpr int CH = HD / 8;       // 16-byte chunks of a row in device memory
  constexpr int CHP = HDP / 8;     // ... in shared memory, zero-filled past CH
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
  // lkp - 1 zero-filled: P is 0 there, and 0 * V must stay 0); columns past
  // hd zero-filled, nothing read for them.
  {
    const bf16* qb = q + b * qs.b + h * qs.h;
    for (int e = tid; e < MA_BQ * CHP; e += MA_THREADS) {
      const int r = e / CHP, c = e % CHP;
      const bool in = q0 + r < Lq && c < CH;
      cp_async16(smem_u32(Qs + r * STR + 8 * c),
                 qb + (in ? (q0 + r) * qs.l + 8 * c : 0), in ? 16 : 0);
    }
    const bf16* kb = k + b * ks.b + h * ks.h;
    const bf16* vb = v + b * vs.b + h * vs.h;
    for (int e = tid; e < lkp * CHP; e += MA_THREADS) {
      const int r = e / CHP, c = e % CHP;
      const bool in = r < Lk && c < CH;
      cp_async16(smem_u32(Ks + r * STR + 8 * c), kb + (in ? r * ks.l + 8 * c : 0),
                 in ? 16 : 0);
      cp_async16(smem_u32(Vs + r * STR + 8 * c), vb + (in ? r * vs.l + 8 * c : 0),
                 in ? 16 : 0);
    }
    cp_async_commit();
  }
  float* acc_bh = ACC ? acc + ((long long)b * H + h) * Lk * Lq + q0 : nullptr;
  if constexpr (ACC) {
    ma_load_acc(At, acc_bh, 0, Lk, Lq, q0, tid);  // group 1: lands while the scores and P.V run
    cp_async_wait<1>();
  } else {
    cp_async_wait<0>();
  }
  __syncthreads();

  uint32_t qf[HDP / 16][4];  // the warp's 16 q rows as A fragments, one per k16 step
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk)
    ldmatrix_x4(qf[kk], smem_u32(Qs + (warp * 16 + lane % 16) * STR + 16 * kk + 8 * (lane / 16)));

  // Pass 1: row max and sum of exp over the chunks (one chunk at Lk <= 80,
  // whose scores pass 2 then reuses).  A thread's partial sums of rows g and
  // g + 8 are reduced over the quad at the end.
  float s[MA_NT][4];
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    ma_scores<HDP>(s, qf, Ks, c * MA_KC, lkp, Lk, scale_log2, lane);
    ma_row_stats(s, m0, m1, l0, l1);
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
  float oacc[HDP / 8][4];
#pragma unroll
  for (int jd = 0; jd < HDP / 8; ++jd)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[jd][e] = 0.f;
  const bool write_p = !ACC && b >= skip_b;  // uniform over the block
  PT* span = ACC ? nullptr : p + (((long long)b * H + h) * Lq + q0) * Lk;
  const int lead = ACC ? 0 : ma_lead(span);  // Ps[lead + i] holds span[i]
  for (int c = 0; c < n_chunks; ++c) {
    const int c0 = c * MA_KC;
    if constexpr (ACC) {
      // the tile was written back at the end of chunk c - 1
      if (c > 0) ma_load_acc(At, acc_bh, c0, Lk, Lq, q0, tid);
    }
    if (n_chunks > 1) ma_scores<HDP>(s, qf, Ks, c0, lkp, Lk, scale_log2, lane);
    ma_normalize(s, m0, m1, inv0, inv1);
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
        for (int jd = 0; jd < HDP / 8; jd += 2) {
          uint32_t vb[4];
          ldmatrix_x4_trans(vb, smem_u32(row + 8 * jd));
          mma_m16n8k16(oacc[jd], pa, vb[0], vb[1]);
          mma_m16n8k16(oacc[jd + 1], pa, vb[2], vb[3]);
        }
      }
    }
    if constexpr (ACC) {
      ma_add_acc(At, acc_bh, s, c0, Lk, Lq, q0, qr, t, tid);
      if (c + 1 < n_chunks) __syncthreads();  // before the next chunk's copies
    } else if (write_p) {
      ma_stage_p(Ps + lead + c0, s, Lk, Lk - c0, Lq - q0, qr, t);
    }
  }

  // O: each warp stages its 16 rows (hd columns) in its own rows of the q
  // tile (which only it read, into qf), then stores them with 16-byte
  // stores.
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

  if (write_p) {
    __syncthreads();
    ma_store_span(span, Ps, lead, min(MA_BQ, Lq - q0) * Lk, tid);
  }
}

// ---------------------------------------------------------------------------
// cross_attention_acc and cross_attention_probs, fp32, on the tensor cores
// (mma.sync, 3xTF32)
// ---------------------------------------------------------------------------

// Dynamic shared memory of a block: the q tile and one chunk of k and of v
// in fp32 rows of hd + 4 floats (a chunk's keys zero-filled to a multiple
// of 16), then the epilogue's tile of min(Lk, 80) rows of 68 floats: K1's
// chunk of acc rows, or K5's P, which needs less (64 rows of min(Lk, 80)
// values and up to 16 bytes of lead).  At most 137 KB (hd 128), so every
// Lk fits: past one chunk, the chunks stream through.
inline long long mt_smem_bytes(int hd, long long Lk) {
  const long long rows = Lk < MA_KC ? (Lk + 15) & ~15LL : MA_KC;
  return (MA_BQ + 2 * rows) * (hd + 4) * 4 + (Lk < MA_KC ? Lk : MA_KC) * MA_ASTR * 4;
}

// ma_scores in 3xTF32 from fp32 tiles: the scores of keys c0 .. c0 + MA_KC -
// 1 (rows 0 .. of Ks) for the warp's 16 queries, whose rows q_lane
// addresses as for flash_attention_tf32x3_kernel; log2 domain, keys past Lk
// at -inf, mma's D layout.
template <int HD>
__device__ __forceinline__ void mt_scores(float (&s)[MA_NT][4], uint32_t q_lane,
                                          const float* Ks, int c0, int Lk, float scale_log2,
                                          int lane) {
  using namespace hopper;
  constexpr int STR = HD + 4;
#pragma unroll
  for (int j = 0; j < MA_NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  const float* k_lane = Ks + (8 * (lane / 16) + lane % 8) * STR + 4 * ((lane / 8) % 2);
#pragma unroll
  for (int kk = 0; kk < HD / 8; ++kk) {
    uint32_t qa[4], qh[4], ql[4];
    ldmatrix_x4(qa, q_lane + 32 * kk);
    split_tf32(qa, qh, ql);
#pragma unroll
    for (int jp = 0; jp < MA_NT / 2; ++jp) {
      if (c0 + 16 * jp < Lk) {
        uint32_t kr[4], kh[4], kl[4];
        ldmatrix_x4(kr, smem_u32(k_lane + 16 * jp * STR + 8 * kk));
        split_tf32(kr, kh, kl);
        mma_tf32x3(s[2 * jp], qh, ql, kh[0], kh[1], kl[0], kl[1]);
        mma_tf32x3(s[2 * jp + 1], qh, ql, kh[2], kh[3], kl[2], kl[3]);
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

// cross_attention_mma_kernel in fp32: the same block, chunks, softmax and
// epilogues (ACC: acc += Pᵀ; otherwise P written out as PT, skipping
// samples b < skip_b), with both products in 3xTF32 and O in fp32.  P is
// normalized in fp32 and enters P V unrounded, as the Pallas body's
// p.astype(v.dtype) is a no-op in fp32.  At Lk <= 80 q, k, v (and K1's acc
// tile, in a second group that lands while the products run) arrive at
// once and the one chunk's scores stay in registers; K5 stages the block's
// P span in the tile's place and writes it with 16-byte stores.  A longer
// Lk streams each chunk's k (pass 1), then its k and v and K1's acc tile
// (pass 2) through the same buffers; K5 then stages and writes each chunk's
// P columns in turn.
template <int HD, typename PT, bool ACC>
__global__ void __launch_bounds__(MA_THREADS, HD >= 128 ? 1 : 2)
cross_attention_tf32x3_kernel(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, float* __restrict__ o,
                              float* __restrict__ acc, PT* __restrict__ p, int H, int Lq,
                              int Lk, int skip_b, Strides qs, Strides ks, Strides vs,
                              float scale_log2) {
  using namespace hopper;
  constexpr int STR = HD + 4;  // fp32 row stride of the q, k and v tiles
  constexpr int CH = HD / 4;   // 16-byte chunks of a row
  DAAM_DYNAMIC_SMEM(float, mt_smem);

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * MA_BQ;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int qr = warp * 16 + g;  // block row of s[.][0..1]; s[.][2..3] is qr + 8
  const int n_chunks = (Lk + MA_KC - 1) / MA_KC;
  const int kv_rows = n_chunks > 1 ? MA_KC : (Lk + 15) & ~15;
  float* Qs = mt_smem;
  float* Ks = Qs + MA_BQ * STR;
  float* Vs = Ks + kv_rows * STR;
  float* At = Vs + kv_rows * STR;         // ACC: [chunk rows][MA_ASTR]
  PT* Ps = reinterpret_cast<PT*>(At);     // else: P, the span or a chunk's rows
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;
  float* acc_bh = ACC ? acc + ((long long)b * H + h) * Lk * Lq + q0 : nullptr;

  // The keys of the chunk at c0 from src (k or v) into dst, rows past Lk
  // zero-filled up to a multiple of 16 (P is 0 there, and 0 * V must stay 0).
  auto load_keys = [&](float* dst, const float* src, long long stride, int c0) {
    const int rows = min(kv_rows, (Lk - c0 + 15) & ~15);
    for (int e = tid; e < rows * CH; e += MA_THREADS) {
      const int r = e / CH, c = e % CH;
      const bool in = c0 + r < Lk;
      cp_async16(smem_u32(dst + r * STR + 4 * c), src + (in ? c0 + r : 0) * stride + 4 * c,
                 in ? 16 : 0);
    }
  };
  {  // q rows past Lq are zero-filled
    const float* qb = q + b * qs.b + h * qs.h;
    for (int e = tid; e < MA_BQ * CH; e += MA_THREADS) {
      const int r = e / CH, c = e % CH;
      const bool in = q0 + r < Lq;
      cp_async16(smem_u32(Qs + r * STR + 4 * c), qb + (in ? q0 + r : 0) * qs.l + 4 * c,
                 in ? 16 : 0);
    }
  }
  if (n_chunks == 1) {
    load_keys(Ks, kb, ks.l, 0);
    load_keys(Vs, vb, vs.l, 0);
  }
  cp_async_commit();  // group 0: q, and at Lk <= 80 all of k and v
  if (ACC && n_chunks == 1) {
    ma_load_acc(At, acc_bh, 0, Lk, Lq, q0, tid);  // group 1: lands while the products run
    cp_async_wait<1>();
  } else {
    cp_async_wait<0>();
  }
  __syncthreads();
  const uint32_t q_lane = smem_u32(Qs + (warp * 16 + lane % 16) * STR + 4 * (lane / 16));

  // Pass 1: row max and sum of exp over the chunks.
  float s[MA_NT][4];
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    if (n_chunks > 1) {
      if (c > 0) __syncthreads();  // every warp is done with chunk c - 1's keys
      load_keys(Ks, kb, ks.l, c * MA_KC);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
    }
    mt_scores<HD>(s, q_lane, Ks, c * MA_KC, Lk, scale_log2, lane);
    ma_row_stats(s, m0, m1, l0, l1);
  }
#pragma unroll
  for (int x = 1; x < 4; x <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, x);
    l1 += __shfl_xor_sync(0xffffffffu, l1, x);
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;

  // Pass 2, per chunk: normalized fp32 P; O += P V per 8 keys, P straight
  // from the score fragment (pv_tf32x3); then acc += Pᵀ, or P staged.
  float oacc[HD / 8][4];
#pragma unroll
  for (int jd = 0; jd < HD / 8; ++jd)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[jd][e] = 0.f;
  const bool write_p = !ACC && b >= skip_b;  // uniform over the block
  const int rows = min(MA_BQ, Lq - q0);
  PT* span = ACC ? nullptr : p + (((long long)b * H + h) * Lq + q0) * Lk;
  // At Lk <= 80 Ps[lead + i] holds span[i]
  const int lead = !ACC && n_chunks == 1 ? ma_lead(span) : 0;
  for (int c = 0; c < n_chunks; ++c) {
    const int c0 = c * MA_KC;
    if (n_chunks > 1) {
      __syncthreads();  // chunk c - 1's keys, values and epilogue tile are consumed
      load_keys(Ks, kb, ks.l, c0);
      load_keys(Vs, vb, vs.l, c0);
      cp_async_commit();
      if (ACC) {
        ma_load_acc(At, acc_bh, c0, Lk, Lq, q0, tid);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      mt_scores<HD>(s, q_lane, Ks, c0, Lk, scale_log2, lane);
    }
    ma_normalize(s, m0, m1, inv0, inv1);
#pragma unroll
    for (int j = 0; j < MA_NT; ++j)
      if (c0 + 8 * j < Lk) pv_tf32x3<HD, STR>(oacc, s[j], Vs, 8 * j, g, t);
    if constexpr (ACC) {
      ma_add_acc(At, acc_bh, s, c0, Lk, Lq, q0, qr, t, tid);
    } else if (write_p && n_chunks == 1) {
      ma_stage_p(Ps + lead, s, Lk, Lk, rows, qr, t);
    } else if (write_p) {
      // the chunk's columns of P: rows of cw keys, Lk apart in P
      const int cw = min(MA_KC, Lk - c0);
      ma_stage_p(Ps, s, cw, cw, rows, qr, t);
      __syncthreads();
      for (int e = tid; e < rows * cw; e += MA_THREADS) {
        const int r = e / cw, col = e % cw;
        span[(long long)r * Lk + c0 + col] = Ps[r * cw + col];
      }
    }
  }

  // O: each warp stages its 16 rows in its own rows of the q tile (which
  // only it read), then stores them with 16-byte stores.
  float* Os = Qs + warp * 16 * STR;
  __syncwarp();
#pragma unroll
  for (int jd = 0; jd < HD / 8; ++jd) {
    *reinterpret_cast<float2*>(Os + g * STR + 8 * jd + 2 * t) =
        make_float2(oacc[jd][0], oacc[jd][1]);
    *reinterpret_cast<float2*>(Os + (g + 8) * STR + 8 * jd + 2 * t) =
        make_float2(oacc[jd][2], oacc[jd][3]);
  }
  __syncwarp();
  for (int e = lane; e < 16 * CH; e += 32) {
    const int r = e / CH, c = e % CH;
    const int qi = q0 + warp * 16 + r;
    if (qi < Lq)
      *reinterpret_cast<float4*>(o + ((long long)b * Lq + qi) * (H * HD) + h * HD + 4 * c) =
          *reinterpret_cast<const float4*>(Os + r * STR + 4 * c);
  }

  if (write_p && n_chunks == 1) {
    __syncthreads();
    ma_store_span(span, Ps, lead, rows * Lk, tid);
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

constexpr float LOG2E = 1.4426950408889634f;  // the kernels work in exp2

// Sets a kernel's dynamic shared memory limit to `bytes`, once per device.
template <typename K>
cudaError_t opt_in_smem(K kernel, int device, int bytes, bool (&done)[64]) {
  if (device < 64 && done[device]) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         bytes);
  if (err == cudaSuccess && device < 64) done[device] = true;
  return err;
}

template <int HD>
cudaError_t launch_flash_tf32x3(int device, const void* q, const void* k, const void* v,
                                void* o, int B, int H, int Lq, int Lk, Strides qs,
                                Strides ks, Strides vs, float scale, cudaStream_t stream) {
  constexpr int smem = FtTile<HD>::SMEM;
  static bool smem_set[64] = {};
  cudaError_t err = opt_in_smem(flash_attention_tf32x3_kernel<HD>, device, smem, smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid((Lq + FT_BQ - 1) / FT_BQ, H, B);
  DAAM_LAUNCH(grid, FT_THREADS, smem, stream, flash_attention_tf32x3_kernel<HD>)(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), H, Lq, Lk, qs, ks, vs,
      scale * LOG2E);
  return cudaGetLastError();
}

// Bytes of the stage images of every tile of every (b, h): the scratch
// split_kv_tf32x3_kernel writes.
template <int HD>
long long wt_scratch_bytes(int B, int H, int Lk) {
  using T = WtTile<HD>;
  return (long long)B * H * ((Lk + T::BK - 1) / T::BK) * T::STAGE;
}

// The split of k and v into `scratch` (wt_scratch_bytes), then the
// attention over it; two launches on one stream.
template <int HD>
cudaError_t launch_flash_tf32x3_wgmma(int device, const void* q, const void* k, const void* v,
                                      void* o, void* scratch, int B, int H, int Lq, int Lk,
                                      Strides qs, Strides ks, Strides vs, float scale,
                                      cudaStream_t stream) {
  using T = WtTile<HD>;
  static bool split_set[64] = {}, smem_set[64] = {};
  cudaError_t err = opt_in_smem(split_kv_tf32x3_kernel<HD>, device, T::STAGE, split_set);
  if (err == cudaSuccess)
    err = opt_in_smem(flash_attention_tf32x3_wgmma_kernel<HD>, device, T::SMEM, smem_set);
  if (err != cudaSuccess) return err;
  uint8_t* kv = static_cast<uint8_t*>(scratch);
  const int n_tiles = (Lk + T::BK - 1) / T::BK;
  DAAM_LAUNCH(dim3(n_tiles, H, B), WT_SPLIT_THREADS, T::STAGE, stream,
              split_kv_tf32x3_kernel<HD>)(static_cast<const float*>(k),
                                          static_cast<const float*>(v), kv, H, Lk, n_tiles, ks,
                                          vs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  DAAM_LAUNCH(dim3((Lq + WT_BQ - 1) / WT_BQ, H, B), WT_THREADS, T::SMEM, stream,
              flash_attention_tf32x3_wgmma_kernel<HD>)(
      static_cast<const float*>(q), kv, static_cast<float*>(o), H, Lq, Lk, qs, scale * LOG2E);
  return cudaGetLastError();
}

// The fp32 kernels: acc (ACC) or P of type PT.  Every Lk fits.
template <int HD, typename PT, bool ACC>
cudaError_t launch_cross_tf32x3(int device, const void* q, const void* k, const void* v,
                                void* o, float* acc, void* p, int B, int H, int Lq, int Lk,
                                int skip_b, Strides qs, Strides ks, Strides vs, float scale,
                                cudaStream_t stream) {
  auto kernel = cross_attention_tf32x3_kernel<HD, PT, ACC>;
  static bool smem_set[64] = {};  // the opt-in to the largest block, at Lk >= 80
  cudaError_t err = opt_in_smem(kernel, device, (int)mt_smem_bytes(HD, MA_KC), smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid((Lq + MA_BQ - 1) / MA_BQ, H, B);
  DAAM_LAUNCH(grid, MA_THREADS, mt_smem_bytes(HD, Lk), stream, kernel)(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), acc, static_cast<PT*>(p), H,
      Lq, Lk, skip_b, qs, ks, vs, scale * LOG2E);
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
  static bool smem_set[64] = {};
  err = opt_in_smem(flash_attention_wgmma_kernel<HD>, device, smem, smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid((Lq + TC_BQ - 1) / TC_BQ, H, B);
  flash_attention_wgmma_kernel<HD><<<grid, TC_THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), H, Lq, Lk, scale * LOG2E);
  return cudaGetLastError();
}
#endif  // DAAM_EMULATE

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
  static bool smem_set[64] = {};  // the opt-in to all of SMEM_MAX
  cudaError_t err = opt_in_smem(kernel, device, SMEM_MAX, smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid((Lq + MA_BQ - 1) / MA_BQ, H, B);
  DAAM_LAUNCH(grid, MA_THREADS, smem, stream, kernel)(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), acc,
      static_cast<PT*>(p), H, Lq, Lk, skip_b, qs, ks, vs, scale * LOG2E);
  return cudaGetLastError();
}

// f(std::integral_constant<int, HD>{}) at the head dim hd; a head dim
// without kernels is refused with cudaErrorInvalidValue.
template <typename F>
int by_head_dim(int hd, F f) {
  switch (hd) {
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 40: return f(std::integral_constant<int, 40>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 80: return f(std::integral_constant<int, 80>{});
    case 128: return f(std::integral_constant<int, 128>{});
    case 160: return f(std::integral_constant<int, 160>{});
    default: return cudaErrorInvalidValue;
  }
}

// The cross-attention kernels by route (TF32X3: fp32, else bf16) and
// epilogue (ACC: acc; else P of type PT), at the head dim hd.
template <bool TF32X3, typename PT, bool ACC>
int cross_dispatch(int device, int hd, const void* q, const void* k, const void* v, void* o,
                   float* acc, void* p, int B, int H, int Lq, int Lk, int skip_b, int qsb,
                   int qsl, int qsh, int ksb, int ksl, int ksh, int vsb, int vsl, int vsh,
                   float scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Strides qs{qsb, qsl, qsh}, ks{ksb, ksl, ksh}, vs{vsb, vsl, vsh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return by_head_dim(hd, [&](auto c) {
    constexpr int HD = decltype(c)::value;
    if constexpr (TF32X3)
      return launch_cross_tf32x3<HD, PT, ACC>(device, q, k, v, o, acc, p, B, H, Lq, Lk,
                                              skip_b, qs, ks, vs, scale, st);
    else
      return launch_cross_mma<HD, PT, ACC>(device, q, k, v, o, acc, p, B, H, Lq, Lk, skip_b,
                                           qs, ks, vs, scale, st);
  });
}

}  // namespace

// Plain C interface, bound with ctypes.  Each returns the cudaError_t of its
// launch (0 on success).

// Bytes of device memory daam_flash_attention_tf32x3 needs as scratch at
// this call's head dim and sizes (0 where flash_attention_tf32x3_kernel
// serves hd; -1 for a head dim without kernels).
extern "C" long long daam_flash_attention_tf32x3_scratch(int hd, int B, int H, int Lk) {
  long long bytes = -1;
  by_head_dim(hd, [&](auto c) {
    constexpr int HD = decltype(c)::value;
    if constexpr (wgmma_tf32x3_serves(HD)) bytes = wt_scratch_bytes<HD>(B, H, Lk);
    else bytes = 0;
    return 0;
  });
  return bytes;
}

// fp32 only, on the tensor cores in 3xTF32: split_kv_tf32x3_kernel, then
// flash_attention_tf32x3_wgmma_kernel, at the head dims they serve
// (wgmma_tf32x3_serves; `scratch`: 16-byte aligned, of
// daam_flash_attention_tf32x3_scratch bytes), else
// flash_attention_tf32x3_kernel (mma.sync; `scratch` unused).  Every view's
// base must be 16-byte aligned and its b, l, h strides multiples of 4
// elements (16 bytes), as the 16-byte loads and cp.async require.  bf16 goes
// to daam_flash_attention_wgmma.
extern "C" int daam_flash_attention_tf32x3(int device, int hd, const void* q,
                                           const void* k, const void* v, void* o,
                                           void* scratch, int B, int H, int Lq, int Lk,
                                           int qsb, int qsl, int qsh, int ksb, int ksl,
                                           int ksh, int vsb, int vsl, int vsh,
                                           float scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Strides qs{qsb, qsl, qsh}, ks{ksb, ksl, ksh}, vs{vsb, vsl, vsh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return by_head_dim(hd, [&](auto c) {
    constexpr int HD = decltype(c)::value;
    if constexpr (wgmma_tf32x3_serves(HD))
      return launch_flash_tf32x3_wgmma<HD>(device, q, k, v, o, scratch, B, H, Lq, Lk, qs, ks,
                                           vs, scale, st);
    else
      return launch_flash_tf32x3<HD>(device, q, k, v, o, B, H, Lq, Lk, qs, ks, vs, scale, st);
  });
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
  return by_head_dim(hd, [&](auto c) {
    return launch_flash_wgmma<decltype(c)::value>(device, q, k, v, o, B, H, Lq, Lk, qs, ks, vs,
                                                  scale, static_cast<cudaStream_t>(stream));
  });
}
#endif  // DAAM_EMULATE

// fp32 only, on the tensor cores in 3xTF32, under the view and accumulator
// conditions of daam_cross_attention_acc_mma (in 16-byte units: multiples of
// 4 floats); every Lk fits (mt_smem_bytes).  bf16 goes to
// daam_cross_attention_acc_mma.
extern "C" int daam_cross_attention_acc_tf32x3(int device, int hd, const void* q,
                                               const void* k, const void* v, void* o,
                                               float* acc, int B, int H, int Lq, int Lk,
                                               int qsb, int qsl, int qsh, int ksb, int ksl,
                                               int ksh, int vsb, int vsl, int vsh,
                                               float scale, void* stream) {
  return cross_dispatch<true, float, true>(device, hd, q, k, v, o, acc, nullptr, B, H, Lq,
                                           Lk, 0, qsb, qsl, qsh, ksb, ksl, ksh, vsb, vsl,
                                           vsh, scale, stream);
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
  return cross_dispatch<false, float, true>(device, hd, q, k, v, o, acc, nullptr, B, H, Lq,
                                            Lk, 0, qsb, qsl, qsh, ksb, ksl, ksh, vsb, vsl,
                                            vsh, scale, stream);
}

// pdtype: the type of P (0 = float32, 1 = bfloat16); skip_b: samples
// b < skip_b get no P rows written (B/2 for cond_only, else 0).  fp32 q, k
// and v only, on the tensor cores in 3xTF32, under the view conditions of
// daam_cross_attention_acc_tf32x3 (Lq may be any size); every Lk fits.
// bf16 goes to daam_cross_attention_probs_mma.
extern "C" int daam_cross_attention_probs_tf32x3(int device, int hd, const void* q,
                                                 const void* k, const void* v, void* o,
                                                 void* p, int pdtype, int skip_b, int B,
                                                 int H, int Lq, int Lk, int qsb, int qsl,
                                                 int qsh, int ksb, int ksl, int ksh,
                                                 int vsb, int vsl, int vsh, float scale,
                                                 void* stream) {
  switch (pdtype) {
    case 0: return cross_dispatch<true, float, false>(device, hd, q, k, v, o, nullptr, p, B, H, Lq, Lk, skip_b, qsb, qsl, qsh, ksb, ksl, ksh, vsb, vsl, vsh, scale, stream);
    case 1: return cross_dispatch<true, __nv_bfloat16, false>(device, hd, q, k, v, o, nullptr, p, B, H, Lq, Lk, skip_b, qsb, qsl, qsh, ksb, ksl, ksh, vsb, vsl, vsh, scale, stream);
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
  switch (pdtype) {
    case 0: return cross_dispatch<false, float, false>(device, hd, q, k, v, o, nullptr, p, B, H, Lq, Lk, skip_b, qsb, qsl, qsh, ksb, ksl, ksh, vsb, vsl, vsh, scale, stream);
    case 1: return cross_dispatch<false, __nv_bfloat16, false>(device, hd, q, k, v, o, nullptr, p, B, H, Lq, Lk, skip_b, qsb, qsl, qsh, ksb, ksl, ksh, vsb, vsl, vsh, scale, stream);
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
