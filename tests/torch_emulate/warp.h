// A CPU stand-in for the CUDA runtime and the PTX operations the kernels of
// daam_tpu_torch/csrc/attention.cu and overlay.cu use (overlay.cu's explicitly
// rounded __fadd_rn-style arithmetic too), so that their arithmetic and indexing
// run on a machine without a GPU (tests/test_torch_kernel_emulation.py): one
// std::thread per CUDA thread, pthread barriers for __syncthreads,
// __syncwarp and a warpgroup's collective wgmma,
// and exchange buffers for the warp collectives (__shfl_xor_sync, ldmatrix,
// mma.sync m16n8k16 in bf16 and m16n8k8 in TF32, and cvt.rna.tf32.f32 as a
// reference), whose element layouts follow the PTX ISA.  wgmma m64nNk8 in
// TF32 (A from registers, B K-major in shared memory) gathers each warp's A
// fragments after a barrier over the warpgroup's 128 threads and reads B
// through its matrix descriptor (start, SBO, 32-, 64- or 128-byte swizzle
// decoded from the bits); every TF32 operand is truncated as the tensor core
// reads it, and the products run at once (wgmma.fence, commit and wait and
// the proxy fence are no-ops); the SS form reads A through its descriptor
// the same way.  mbarriers keep a pending arrival count, a pending transaction
// byte count and a phase under one mutex per block (arrive, expect-tx, and
// wait on or test a phase's parity as try_wait and test_wait do); a bulk copy lands at
// once and completes its bytes on its barrier.  cp.async copies at once;
// shared memory is filled with 0xff bytes (NaN as bf16 or float) and every
// cp.async, ldmatrix, bulk copy or wgmma address, and a canary past the block's
// dynamic shared memory, is checked.  Included before attention.cu and
// overlay.cu, it defines DAAM_EMULATE, which leaves out the CUDA headers,
// hopper.cuh's PTX wrappers and the TMA and bf16 wgmma kernel
// (flash_attention_wgmma_kernel), and defines the kernel files' DAAM_EX2,
// DAAM_DYNAMIC_SMEM and DAAM_LAUNCH.
#pragma once
#include <pthread.h>
#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <thread>
#include <cstdio>
#include <cstdlib>
#include <functional>
#include <algorithm>
#include <condition_variable>
#include <map>
#include <mutex>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)
#define __grid_constant__
#define __shared__
#define __align__(n)
#define DAAM_EMULATE
using std::min; using std::max;
struct dim3 { unsigned x, y, z; dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
struct uint3s { unsigned x, y, z; };
extern thread_local uint3s threadIdx, blockIdx;
struct alignas(16) float4 { float x, y, z, w; };
struct alignas(8) float2 { float x, y; };
struct alignas(16) uint4 { unsigned x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline float2 make_float2(float a, float b) { return {a, b}; }
inline float __uint_as_float(uint32_t u) { float f; memcpy(&f, &u, 4); return f; }
inline uint32_t __float_as_uint(float f) { uint32_t u; memcpy(&u, &f, 4); return u; }
inline float __int_as_float(int i) { float f; memcpy(&f, &i, 4); return f; }
inline int __float_as_int(float f) { int i; memcpy(&i, &f, 4); return i; }
struct __nv_bfloat16 { unsigned short v; };
struct __nv_bfloat162 { __nv_bfloat16 a, b; };
inline float __bfloat162float(__nv_bfloat16 h) { uint32_t u = (uint32_t)h.v << 16; float f; memcpy(&f, &u, 4); return f; }
inline __nv_bfloat16 __float2bfloat16(float f) {
  uint32_t u; memcpy(&u, &f, 4);
  if (std::isnan(f)) return {0x7fc0};
  u += 0x7fff + ((u >> 16) & 1);
  return {(unsigned short)(u >> 16)};
}
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) { return {__float2bfloat16(a), __float2bfloat16(b)}; }
inline float __expf(float x) { return expf(x); }
inline void __trap() { abort(); }
inline long long clock64() { return 0; }
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef void* cudaStream_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class F> cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
inline cudaError_t cudaSetDevice(int) { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return ""; }

// ---- the emulated machine
struct EmuMbar {
  uint32_t count, pending, phase;
  long long tx;  // transaction bytes still expected in this phase
};
struct EmuBlock {
  uint8_t* smem;
  size_t smem_bytes;
  pthread_barrier_t block_bar;
  pthread_barrier_t warp_bar[32];
  pthread_barrier_t wg_bar[8];     // a warpgroup's 128 threads
  std::mutex mu;                   // guards the mbarriers
  std::condition_variable cv;
  std::map<uint32_t, EmuMbar> mbars;  // by shared-memory address
  uint64_t xch[32][32][8];  // [warp][lane][slot]
};
extern thread_local EmuBlock* emu_blk;
inline void emu_fail(const char* what) { fprintf(stderr, "emulation: %s\n", what); abort(); }
inline int emu_tid() { return threadIdx.x; }
inline void __syncthreads() { pthread_barrier_wait(&emu_blk->block_bar); }
inline void __syncwarp() { pthread_barrier_wait(&emu_blk->warp_bar[emu_tid() / 32]); }
inline uint64_t* emu_slot(int lane) { return emu_blk->xch[emu_tid() / 32][lane]; }
inline float __shfl_xor_sync(unsigned, float x, int m) {
  int lane = emu_tid() % 32;
  memcpy(emu_slot(lane), &x, 4);
  __syncwarp();
  float y; memcpy(&y, emu_slot(lane ^ m), 4);
  __syncwarp();
  return y;
}
inline int __shfl_xor_sync(unsigned mask, int x, int m) {
  return __float_as_int(__shfl_xor_sync(mask, __int_as_float(x), m));
}
// explicitly rounded arithmetic: x86-64's SSE rounds each operation alone
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fmaf_rn(float a, float b, float c) { return std::fma(a, b, c); }
inline double __dadd_rn(double a, double b) { return a + b; }
inline double __dmul_rn(double a, double b) { return a * b; }
inline size_t __cvta_generic_to_shared(const void* p) { return (const uint8_t*)p - emu_blk->smem; }
inline void emu_wg_sync() {
  if (emu_tid() / 128 >= 8) emu_fail("warpgroup past the eighth");
  pthread_barrier_wait(&emu_blk->wg_bar[emu_tid() / 128]);
}

// cvt.rna.tf32.f32 by its definition, on the value: to 10 mantissa bits,
// to nearest, ties away from zero; infinity and NaN pass through.  The
// kernels' tf32_round computes it with integer operations; run_case tf32
// holds the two equal.
inline uint32_t emu_cvt_rna_tf32(float x) {
  if (!std::isfinite(x)) return __float_as_uint(x);
  const float mag = std::fabs(x);
  int e;
  std::frexp(mag, &e);  // mag = m 2^e, m in [0.5, 1)
  const float ulp = std::ldexp(1.f, std::max(e - 11, -136));  // 10 bits after the leading one
  const float r = (float)(std::floor((double)mag / ulp + 0.5) * ulp);  // ties away
  return __float_as_uint(std::copysign(r, x));
}
namespace hopper {
inline void cp_async16(uint32_t dst, const void* src, uint32_t n) {
  if (dst % 16 || ((uintptr_t)src) % 16) emu_fail("cp.async address not 16-byte aligned");
  if (dst + 16 > emu_blk->smem_bytes) emu_fail("cp.async past the dynamic shared memory");
  if (n) memcpy(emu_blk->smem + dst, src, 16); else memset(emu_blk->smem + dst, 0, 16);
}
inline void cp_async_commit() {}
template <int N> inline void cp_async_wait() {}
inline uint16_t emu_ld16(uint32_t a) { uint16_t v; memcpy(&v, emu_blk->smem + a, 2); return v; }
inline void ldmatrix_any(uint32_t (&r)[4], uint32_t addr, bool trans) {
  int lane = emu_tid() % 32, g = lane / 4, t = lane % 4;
  if (addr % 16) emu_fail("ldmatrix row address not 16-byte aligned");
  if (addr + 16 > emu_blk->smem_bytes) emu_fail("ldmatrix row past the dynamic shared memory");
  emu_slot(lane)[0] = addr;
  __syncwarp();
  for (int i = 0; i < 4; ++i) {
    uint16_t lo, hi;
    if (!trans) {  // (row g, cols 2t, 2t+1)
      uint32_t row = (uint32_t)emu_slot(8 * i + g)[0];
      lo = emu_ld16(row + 4 * t); hi = emu_ld16(row + 4 * t + 2);
    } else {       // (rows 2t, 2t+1, col g)
      lo = emu_ld16((uint32_t)emu_slot(8 * i + 2 * t)[0] + 2 * g);
      hi = emu_ld16((uint32_t)emu_slot(8 * i + 2 * t + 1)[0] + 2 * g);
    }
    r[i] = lo | ((uint32_t)hi << 16);
  }
  __syncwarp();
}
inline void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) { ldmatrix_any(r, addr, false); }
inline void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) { ldmatrix_any(r, addr, true); }
inline float emu_bf(uint32_t v) { return __bfloat162float(__nv_bfloat16{(unsigned short)v}); }
inline void mma_m16n8k16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  int lane = emu_tid() % 32;
  uint64_t* s = emu_slot(lane);
  for (int i = 0; i < 4; ++i) s[i] = a[i];
  s[4] = b0; s[5] = b1;
  __syncwarp();
  float A[16][16], B[16][8];
  for (int l = 0; l < 32; ++l) {
    int g = l / 4, t = l % 4;
    uint64_t* x = emu_slot(l);
    int ar[4] = {g, g + 8, g, g + 8}, ac[4] = {2 * t, 2 * t, 2 * t + 8, 2 * t + 8};
    for (int i = 0; i < 4; ++i) {
      A[ar[i]][ac[i]] = emu_bf((uint32_t)x[i] & 0xffff);
      A[ar[i]][ac[i] + 1] = emu_bf((uint32_t)x[i] >> 16);
    }
    B[2 * t][g] = emu_bf((uint32_t)x[4] & 0xffff); B[2 * t + 1][g] = emu_bf((uint32_t)x[4] >> 16);
    B[2 * t + 8][g] = emu_bf((uint32_t)x[5] & 0xffff); B[2 * t + 9][g] = emu_bf((uint32_t)x[5] >> 16);
  }
  __syncwarp();
  int g = lane / 4, t = lane % 4;
  int rr[4] = {g, g, g + 8, g + 8}, cc[4] = {2 * t, 2 * t + 1, 2 * t, 2 * t + 1};
  for (int i = 0; i < 4; ++i) {
    float acc = 0.f;
    for (int k = 0; k < 16; ++k) acc += A[rr[i]][k] * B[k][cc[i]];
    d[i] += acc;
  }
}
// An operand register as the tensor core reads TF32: the low 13 bits are
// ignored (a value the kernel did not round arrives truncated).
inline float emu_tf32(uint32_t v) { return __uint_as_float(v & 0xffffe000u); }
inline void mma_m16n8k8_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  int lane = emu_tid() % 32;
  uint64_t* s = emu_slot(lane);
  for (int i = 0; i < 4; ++i) s[i] = a[i];
  s[4] = b0; s[5] = b1;
  __syncwarp();
  float A[16][8], B[8][8];
  for (int l = 0; l < 32; ++l) {
    int g = l / 4, t = l % 4;
    uint64_t* x = emu_slot(l);
    A[g][t] = emu_tf32((uint32_t)x[0]); A[g + 8][t] = emu_tf32((uint32_t)x[1]);
    A[g][t + 4] = emu_tf32((uint32_t)x[2]); A[g + 8][t + 4] = emu_tf32((uint32_t)x[3]);
    B[t][g] = emu_tf32((uint32_t)x[4]); B[t + 4][g] = emu_tf32((uint32_t)x[5]);
  }
  __syncwarp();
  int g = lane / 4, t = lane % 4;
  int rr[4] = {g, g, g + 8, g + 8}, cc[4] = {2 * t, 2 * t + 1, 2 * t, 2 * t + 1};
  for (int i = 0; i < 4; ++i) {
    float acc = 0.f;  // a product of two TF32 values is exact in fp32
    for (int k = 0; k < 8; ++k) acc += A[rr[i]][k] * B[k][cc[i]];
    d[i] += acc;
  }
}

// mbarriers and bulk copies
inline EmuMbar& emu_mbar(uint32_t bar) {  // under emu_blk->mu
  auto it = emu_blk->mbars.find(bar);
  if (it == emu_blk->mbars.end()) emu_fail("mbarrier used before mbar_init");
  return it->second;
}
inline void mbar_init(uint32_t bar, uint32_t count) {
  if (bar % 8 || bar + 8 > emu_blk->smem_bytes) emu_fail("mbarrier address");
  std::lock_guard<std::mutex> lock(emu_blk->mu);
  emu_blk->mbars[bar] = {count, count, 0, 0};
}
inline void fence_barrier_init() {}
// The phase completes once all `count` arrivals and every expected byte are
// in; the next one starts.
inline void emu_mbar_settle(EmuMbar& m) {  // under emu_blk->mu
  if (m.pending == 0 && m.tx == 0) {
    ++m.phase;
    m.pending = m.count;
    emu_blk->cv.notify_all();
  }
}
inline void mbar_arrive(uint32_t bar) {
  std::lock_guard<std::mutex> lock(emu_blk->mu);
  EmuMbar& m = emu_mbar(bar);
  if (m.pending == 0) emu_fail("mbarrier arrival past its count");
  --m.pending;
  emu_mbar_settle(m);
}
inline void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  std::lock_guard<std::mutex> lock(emu_blk->mu);
  EmuMbar& m = emu_mbar(bar);
  if (m.pending == 0) emu_fail("mbarrier arrival past its count");
  m.tx += bytes;
  --m.pending;
  emu_mbar_settle(m);
}
inline bool mbar_test(uint32_t bar, uint32_t parity) {
  std::lock_guard<std::mutex> lock(emu_blk->mu);
  return (emu_mbar(bar).phase & 1) != (parity & 1);
}
// cp.async.bulk global -> shared: lands now, then its bytes complete on bar.
inline void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  if (dst % 16 || bytes % 16 || ((uintptr_t)src) % 16) emu_fail("bulk copy not 16-byte aligned");
  if (dst + bytes > emu_blk->smem_bytes) emu_fail("bulk copy past the dynamic shared memory");
  memcpy(emu_blk->smem + dst, src, bytes);
  std::lock_guard<std::mutex> lock(emu_blk->mu);
  EmuMbar& m = emu_mbar(bar);
  m.tx -= bytes;
  if (m.tx < 0) emu_fail("bulk copy bytes past the barrier's expected transaction count");
  emu_mbar_settle(m);
}
// Returns once the phase of parity `parity` has completed: the current
// phase's parity differs from it (a fresh barrier's "previous" phase, parity
// 1, counts as completed).
inline void mbar_wait(uint32_t bar, uint32_t parity) {
  std::unique_lock<std::mutex> lock(emu_blk->mu);
  emu_blk->cv.wait(lock, [&] { return (emu_mbar(bar).phase & 1) != (parity & 1); });
}
// wgmma: the products run at the call, so the fences, commits and waits
// have nothing to order.
inline void fence_proxy_async() {}
inline void wgmma_fence() {}
inline void wgmma_commit() {}
template <int N> inline void wgmma_wait() {}
template <int N> inline void fence_regs(float (&)[N]) {}

// Element (n, k) of a K-major k8 TF32 operand through its descriptor db:
// row n at start + (n / 8) SBO + (n % 8) W, its k-th 4 bytes, then the
// swizzle (address bits 4.. ^= bits 7.., as many as W / 16 - 1 spans).
inline float emu_wgmma_b(uint64_t db, int n, int k) {
  const uint32_t start = (uint32_t)(db & 0x3FFF) << 4;
  const uint32_t sbo = (uint32_t)((db >> 32) & 0x3FFF) << 4;
  const uint32_t layout = (uint32_t)(db >> 62);
  if (layout == 0) emu_fail("wgmma: only a swizzled K-major B is emulated");
  const uint32_t width = 256u >> layout;  // 1: 128 bytes, 2: 64, 3: 32
  if (start % width + 32 > width) emu_fail("wgmma: a k8 step must lie within one swizzled row");
  uint32_t a = start + (n / 8) * sbo + (n % 8) * width + 4 * k;
  a ^= ((a >> 7) & (width / 16 - 1)) << 4;
  if (a + 4 > emu_blk->smem_bytes) emu_fail("wgmma operand past the dynamic shared memory");
  uint32_t v;
  memcpy(&v, emu_blk->smem + a, 4);
  return emu_tf32(v);
}
// D (64 x N) (+)= A (64 x 8, registers) B (8 x N), TF32, one warpgroup:
// warp w holds A's and D's rows 16 w .. 16 w + 15 in mma_m16n8k8_tf32's A
// layout, and d[4 j + e] = (g + 8 (e / 2), 8 j + 2 t + e % 2).
template <int N>
inline void wgmma_tf32_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  static_assert(N % 8 == 0 && N >= 8 && N <= 256, "wgmma m64nNk8: N a multiple of 8 to 256");
  const int lane = emu_tid() % 32;
  uint64_t* s = emu_slot(lane);
  for (int i = 0; i < 4; ++i) s[i] = a[i];
  emu_wg_sync();  // the warpgroup's 128 threads have posted their A fragments
  float A[16][8];
  for (int l = 0; l < 32; ++l) {
    const int g = l / 4, t = l % 4;
    const uint64_t* x = emu_slot(l);
    A[g][t] = emu_tf32((uint32_t)x[0]); A[g + 8][t] = emu_tf32((uint32_t)x[1]);
    A[g][t + 4] = emu_tf32((uint32_t)x[2]); A[g + 8][t + 4] = emu_tf32((uint32_t)x[3]);
  }
  const int g = lane / 4, t = lane % 4;
  for (int j = 0; j < N / 8; ++j)
    for (int e = 0; e < 4; ++e) {
      const int row = g + 8 * (e / 2), n = 8 * j + 2 * t + e % 2;
      float acc = 0.f;  // a product of two TF32 values is exact in fp32
      for (int k = 0; k < 8; ++k) acc += A[row][k] * emu_wgmma_b(db, n, k);
      d[4 * j + e] = scale_d ? d[4 * j + e] + acc : acc;
    }
  emu_wg_sync();  // every thread has read the slots
}
// The same with A (64 x 8) K-major in shared memory through descriptor da:
// a thread reads its own rows 16 w + g and 16 w + g + 8.
template <int N>
inline void wgmma_tf32_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int scale_d) {
  static_assert(N % 8 == 0 && N >= 8 && N <= 256, "wgmma m64nNk8: N a multiple of 8 to 256");
  emu_wg_sync();  // a warpgroup's collective
  const int w = emu_tid() % 128 / 32, g = emu_tid() % 32 / 4, t = emu_tid() % 4;
  float A[2][8];
  for (int h = 0; h < 2; ++h)
    for (int k = 0; k < 8; ++k) A[h][k] = emu_wgmma_b(da, 16 * w + g + 8 * h, k);
  for (int j = 0; j < N / 8; ++j)
    for (int e = 0; e < 4; ++e) {
      const int n = 8 * j + 2 * t + e % 2;
      float acc = 0.f;
      for (int k = 0; k < 8; ++k) acc += A[e / 2][k] * emu_wgmma_b(db, n, k);
      d[4 * j + e] = scale_d ? d[4 * j + e] + acc : acc;
    }
}
}  // namespace hopper

thread_local uint3s threadIdx, blockIdx;
thread_local EmuBlock* emu_blk;

inline void emu_launch(dim3 grid, int threads, size_t smem_bytes, cudaStream_t, const std::function<void()>& body) {
  for (unsigned z = 0; z < grid.z; ++z)
    for (unsigned y = 0; y < grid.y; ++y)
      for (unsigned x = 0; x < grid.x; ++x) {
        EmuBlock blk;
        constexpr size_t kCanary = 256;
        std::vector<uint8_t> mem(smem_bytes + kCanary + 16);
        blk.smem = (uint8_t*)(((uintptr_t)mem.data() + 15) & ~(uintptr_t)15);
        blk.smem_bytes = smem_bytes;
        memset(blk.smem, 0xff, smem_bytes);  // NaN as bf16 or float
        memset(blk.smem + smem_bytes, 0xa5, kCanary);
        pthread_barrier_init(&blk.block_bar, nullptr, threads);
        for (int w = 0; w < threads / 32; ++w) pthread_barrier_init(&blk.warp_bar[w], nullptr, 32);
        for (int w = 0; w < threads / 128; ++w) pthread_barrier_init(&blk.wg_bar[w], nullptr, 128);
        std::vector<std::thread> ts;
        for (int t = 0; t < threads; ++t)
          ts.emplace_back([&, t] {
            threadIdx = {(unsigned)t, 0, 0};
            blockIdx = {x, y, z};
            emu_blk = &blk;
            body();
          });
        for (auto& th : ts) th.join();
        for (size_t i = 0; i < kCanary; ++i)
          if (blk.smem[smem_bytes + i] != 0xa5) emu_fail("write past the dynamic shared memory");
        pthread_barrier_destroy(&blk.block_bar);
        for (int w = 0; w < threads / 32; ++w) pthread_barrier_destroy(&blk.warp_bar[w]);
        for (int w = 0; w < threads / 128; ++w) pthread_barrier_destroy(&blk.wg_bar[w]);
      }
}

// ---- the kernel file's macros
template <class K>
struct EmuLaunch {
  dim3 grid;
  int threads;
  size_t smem_bytes;
  K kernel;
  template <class... A> void operator()(A... a) const {
    emu_launch(grid, threads, smem_bytes, nullptr, [&] { kernel(a...); });
  }
};
template <class K>
EmuLaunch<K> emu_launcher(dim3 grid, int threads, size_t smem_bytes, K kernel) {
  return {grid, threads, smem_bytes, kernel};
}
#define DAAM_EX2(y, x) ((y) = exp2f(x))
#define DAAM_DYNAMIC_SMEM(type, name) type* name = reinterpret_cast<type*>(emu_blk->smem)
#define DAAM_LAUNCH(grid, threads, smem, stream, ...) emu_launcher(grid, threads, smem, __VA_ARGS__)
