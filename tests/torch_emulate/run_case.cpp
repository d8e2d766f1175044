// Runs one call of a tensor-core attention kernel of
// daam_tpu_torch/csrc/attention.cu through its C entry point on the CPU
// emulator (warp.h) and holds it against a float64 reference that rounds
// the inputs and P to bf16 where the bf16 kernel does (the fp32 kernels
// round nothing).  Built and run by tests/test_torch_kernel_emulation.py
// (the csrc directory on the include path).
//
//   run_case acc    B H Lq Lk hd layout              bf16, two calls into one acc
//   run_case acc32  B H Lq Lk hd layout              fp32 (3xTF32), the same
//   run_case flash  B H Lq Lk hd layout              fp32 (3xTF32) flash_attention
//       (flash_attention_tf32x3_wgmma_kernel where it serves hd, else
//       flash_attention_tf32x3_kernel)
//   run_case probs  B H Lq Lk hd layout pdtype cond  bf16, pdtype f32 or bf16
//   run_case probs32 B H Lq Lk hd layout pdtype cond fp32 (3xTF32), the same
//   run_case smem   hd Lk p_size                     prints ma_smem_bytes
//   run_case smem32 hd Lk                            prints mt_smem_bytes
//   run_case wgmma32                                 prints each head dim fp32
//       flash_attention serves on wgmma, with its keys per tile, its stages
//       and its block's shared memory (WtTile)
//   run_case tf32                                    the kernels' tf32_round
//       against cvt.rna.tf32.f32's definition (warp.h)
//   run_case refuse acc|f32|bf16 hd Lk              prints what the bf16
//       entry point returns for a call at that Lk (no memory: only for an Lk
//       it must refuse)
//   run_case overlay in out h w H W color filtered
//       overlay.cu's overlay_resample_kernel (h = 0: none, the image's own
//       rows) and png_rows_kernel on the file `in` (the float64 jet table
//       (256, 3), the fp32 map (h, w), the uint8 image (H, W, 3)); writes the
//       (H, 1 + 3W) scanlines to `out`, which the test holds against the host
//       route and Pillow
//   run_case geglu f32|bf16 rows w offset in out
//       geglu.cu's geglu_kernel on the (rows, 2w) elements of the file `in`
//       (raw float32 or bfloat16), input and output each placed `offset`
//       elements past a 16-byte boundary; holds every output element to the
//       same expression with std::erf in float, bit for bit, and the
//       elements around the output to their sentinel; writes the (rows, w)
//       output to `out`, which the test holds against PyTorch's CPU chain
//
// layout: head_major or packed.  Prints one line per check and exits 1 if
// any fails.
#include <cstdio>
#include <random>
#include <string>
#include <type_traits>

#include "warp.h"
#include "attention.cu"
#include "overlay.cu"
#include "geglu.cu"

namespace {

float bf16_round(float x) { return __bfloat162float(__float2bfloat16(x)); }

template <typename E>
float to_float(E x) {
  if constexpr (std::is_same_v<E, float>) return x;
  else return __bfloat162float(x);
}

struct Shape {
  int B, H, Lq, Lk, hd;
  bool packed;
};

// A (B, L, H, hd) view of bf16 or fp32 storage, starting `off` elements in.
template <typename E>
struct View {
  std::vector<E> mem;
  long long sb, sl, sh;
  int off;
  const E* ptr() const { return mem.data() + off; }
  float at(int b, int l, int h, int d) const {
    return to_float(mem[off + b * sb + l * sl + h * sh + d]);
  }
};

template <typename E>
View<E> make_view(const Shape& s, int L, std::mt19937& rng, int off) {
  View<E> v;
  v.off = off;
  std::normal_distribution<float> n(0.f, 1.f);
  v.mem.resize((size_t)s.B * L * s.H * s.hd + off);
  for (auto& x : v.mem) {
    if constexpr (std::is_same_v<E, float>) x = n(rng);
    else x = __float2bfloat16(n(rng));
  }
  if (s.packed) {
    v.sb = (long long)L * s.H * s.hd, v.sl = s.H * s.hd, v.sh = s.hd;
  } else {
    v.sb = (long long)s.H * L * s.hd, v.sl = s.hd, v.sh = (long long)L * s.hd;
  }
  return v;
}

// P (B, H, Lq, Lk) and O (B, Lq, H, hd); bf16 inputs round P to bf16
// before PV, as the bf16 kernel does.
template <typename E>
void reference(const Shape& s, const View<E>& q, const View<E>& k, const View<E>& v,
               std::vector<double>& P, std::vector<double>& O) {
  constexpr bool round_p = !std::is_same_v<E, float>;
  P.assign((size_t)s.B * s.H * s.Lq * s.Lk, 0);
  O.assign((size_t)s.B * s.Lq * s.H * s.hd, 0);
  const double scale = 1.0 / std::sqrt((double)s.hd);
  std::vector<double> e(s.Lk);
  for (int b = 0; b < s.B; ++b)
    for (int h = 0; h < s.H; ++h)
      for (int i = 0; i < s.Lq; ++i) {
        double mx = -1e300, sum = 0;
        for (int j = 0; j < s.Lk; ++j) {
          double dot = 0;
          for (int d = 0; d < s.hd; ++d) dot += (double)q.at(b, i, h, d) * k.at(b, j, h, d);
          e[j] = dot * scale;
          mx = std::max(mx, e[j]);
        }
        for (int j = 0; j < s.Lk; ++j) sum += (e[j] = std::exp(e[j] - mx));
        for (int j = 0; j < s.Lk; ++j) {
          const double p = e[j] / sum;
          P[(((size_t)b * s.H + h) * s.Lq + i) * s.Lk + j] = p;
          const double pv = round_p ? bf16_round((float)p) : p;
          for (int d = 0; d < s.hd; ++d)
            O[(((size_t)b * s.Lq + i) * s.H + h) * s.hd + d] += pv * (double)v.at(b, j, h, d);
        }
      }
}

int failures = 0;

void expect(bool ok, const char* what, double err) {
  printf("%-40s max_abs_err=%.3e %s\n", what, err, ok ? "ok" : "FAIL");
  failures += !ok;
}

template <typename E>
double o_error(const std::vector<E>& o, const std::vector<double>& O) {
  double err = 0;
  for (size_t i = 0; i < O.size(); ++i) err = std::max(err, std::fabs(to_float(o[i]) - O[i]));
  return err;
}

int launch_error(int err) {
  if (err) printf("launch returned %d FAIL\n", err);
  return err;
}

// Two calls into one accumulator (seeded with values in [0, 1)); the first
// q view starts 8 elements in, as the conditional half q[B/2:] of a batch
// does.  bf16 runs cross_attention_mma_kernel, fp32 the 3xTF32 kernel.
template <typename E>
void run_acc(const Shape& s, std::mt19937& rng) {
  constexpr bool fp32 = std::is_same_v<E, float>;
  std::vector<float> acc((size_t)s.B * s.H * s.Lk * s.Lq);
  std::uniform_real_distribution<float> u(0.f, 1.f);
  for (auto& x : acc) x = u(rng);
  std::vector<double> acc_ref(acc.begin(), acc.end()), P, O;
  std::vector<E> o((size_t)s.B * s.Lq * s.H * s.hd);
  double o_err = 0;
  for (int call = 0; call < 2; ++call) {
    const View<E> q = make_view<E>(s, s.Lq, rng, call ? 0 : 8);
    const View<E> k = make_view<E>(s, s.Lk, rng, 0), v = make_view<E>(s, s.Lk, rng, 0);
    const auto entry = fp32 ? daam_cross_attention_acc_tf32x3 : daam_cross_attention_acc_mma;
    if (launch_error(entry(0, s.hd, q.ptr(), k.ptr(), v.ptr(), o.data(), acc.data(), s.B,
                           s.H, s.Lq, s.Lk, q.sb, q.sl, q.sh, k.sb, k.sl, k.sh, v.sb, v.sl,
                           v.sh, 1.f / std::sqrt((float)s.hd), nullptr))) {
      ++failures;
      return;
    }
    reference(s, q, k, v, P, O);
    for (int b = 0; b < s.B; ++b)
      for (int h = 0; h < s.H; ++h)
        for (int i = 0; i < s.Lq; ++i)
          for (int j = 0; j < s.Lk; ++j)
            acc_ref[(((size_t)b * s.H + h) * s.Lk + j) * s.Lq + i] +=
                P[(((size_t)b * s.H + h) * s.Lq + i) * s.Lk + j];
    o_err = std::max(o_err, o_error(o, O));
  }
  double a_err = 0;
  for (size_t i = 0; i < acc.size(); ++i) a_err = std::max(a_err, std::fabs(acc[i] - acc_ref[i]));
  // O: bf16 within one bf16 ulp of outputs below 2; fp32 within 1e-5
  // (3xTF32 products, ~2^-21 relative); acc: fp32 sums of fp32 P
  if (fp32) expect(o_err <= 1e-5, "O (fp32)", o_err);
  else expect(o_err <= 1.6e-2, "O (bf16)", o_err);
  expect(a_err <= 2e-6, "acc (fp32, two calls)", a_err);
}

// fp32 flash_attention; q starts 4 floats (16 bytes) in.
void run_flash(const Shape& s, std::mt19937& rng) {
  const View<float> q = make_view<float>(s, s.Lq, rng, 4);
  const View<float> k = make_view<float>(s, s.Lk, rng, 0), v = make_view<float>(s, s.Lk, rng, 0);
  std::vector<float> o((size_t)s.B * s.Lq * s.H * s.hd);
  std::vector<float4> scratch(daam_flash_attention_tf32x3_scratch(s.hd, s.B, s.H, s.Lk) / 16);
  if (launch_error(daam_flash_attention_tf32x3(
          0, s.hd, q.ptr(), k.ptr(), v.ptr(), o.data(), scratch.data(), s.B, s.H, s.Lq, s.Lk,
          q.sb, q.sl, q.sh, k.sb, k.sl, k.sh, v.sb, v.sl, v.sh, 1.f / std::sqrt((float)s.hd),
          nullptr))) {
    ++failures;
    return;
  }
  std::vector<double> P, O;
  reference(s, q, k, v, P, O);
  expect(o_error(o, O) <= 1e-5, "O (fp32)", o_error(o, O));
}

template <typename PT>
double as_double(PT x) {
  if constexpr (sizeof(PT) == 4) return x;
  else return __bfloat162float(x);
}

// P written from a base one element past a 16-byte boundary, so the span
// stores take their scalar head and tail; the elements around P and, under
// cond_only, the first B/2 samples' rows must keep their sentinel.  bf16
// inputs run cross_attention_mma_kernel, fp32 the 3xTF32 kernel.
template <typename E, typename PT>
void run_probs(const Shape& s, int pdtype, bool cond_only, std::mt19937& rng) {
  constexpr bool fp32 = std::is_same_v<E, float>;
  const View<E> q = make_view<E>(s, s.Lq, rng, 0);
  const View<E> k = make_view<E>(s, s.Lk, rng, 0), v = make_view<E>(s, s.Lk, rng, 0);
  const size_t np = (size_t)s.B * s.H * s.Lq * s.Lk;
  PT sentinel;
  if constexpr (sizeof(PT) == 4) sentinel = 12345.f;
  else sentinel = __float2bfloat16(12345.f);
  std::vector<PT> p(np + 2, sentinel);
  PT* pp = p.data() + 1;
  std::vector<E> o((size_t)s.B * s.Lq * s.H * s.hd);
  const int skip_b = cond_only ? s.B / 2 : 0;
  const auto entry = fp32 ? daam_cross_attention_probs_tf32x3 : daam_cross_attention_probs_mma;
  if (launch_error(entry(0, s.hd, q.ptr(), k.ptr(), v.ptr(), o.data(), pp, pdtype, skip_b, s.B,
                         s.H, s.Lq, s.Lk, q.sb, q.sl, q.sh, k.sb, k.sl, k.sh, v.sb, v.sl, v.sh,
                         1.f / std::sqrt((float)s.hd), nullptr))) {
    ++failures;
    return;
  }
  std::vector<double> P, O;
  reference(s, q, k, v, P, O);
  double p_err = 0;
  const double unwritten = as_double(sentinel);
  bool kept = as_double(p[0]) == unwritten && as_double(p[np + 1]) == unwritten;
  const size_t per_sample = (size_t)s.H * s.Lq * s.Lk;
  for (size_t i = 0; i < np; ++i) {
    if ((int)(i / per_sample) < skip_b) kept &= as_double(pp[i]) == unwritten;
    else p_err = std::max(p_err, std::fabs(as_double(pp[i]) - P[i]));
  }
  if (fp32) expect(o_error(o, O) <= 1e-5, "O (fp32)", o_error(o, O));
  else expect(o_error(o, O) <= 1.6e-2, "O (bf16)", o_error(o, O));
  // fp32 P: the kernel's exp2 against exp; bf16 P: half a bf16 ulp below 1
  expect(p_err <= (pdtype ? 4e-3 : 2e-6), pdtype ? "P (bf16)" : "P (fp32)", p_err);
  expect(kept, "elements the call must not write", 0);
}

template <typename E>
uint32_t bits_of(E x) {
  if constexpr (std::is_same_v<E, float>) return __float_as_uint(x);
  else return x.v;
}

// h * gelu(gate) as the chain computes it, with std::erf in float.
float geglu_reference(float h, float g, bool bf16) {
  float a = g * 0.5f * (1.f + std::erf(g * 0.70710678118654752440f));
  if (bf16) a = bf16_round(a);
  const float out = h * a;
  return bf16 ? bf16_round(out) : out;
}

template <typename E>
int run_geglu(int rows, int w, int offset, const char* in, const char* out_path) {
  constexpr bool bf16 = !std::is_same_v<E, float>;
  const size_t n_in = (size_t)rows * 2 * w, n_out = (size_t)rows * w;
  const int pad = 16 / sizeof(E);  // sentinels past the output's end
  // 16-byte-aligned storage, the operands `offset` elements into it
  std::vector<uint4> x_mem((n_in + offset) * sizeof(E) / 16 + 1),
      o_mem((n_out + offset + pad) * sizeof(E) / 16 + 1);
  E* x = reinterpret_cast<E*>(x_mem.data()) + offset;
  E* o = reinterpret_cast<E*>(o_mem.data());
  E sentinel;
  if constexpr (bf16) sentinel = __float2bfloat16(12345.f);
  else sentinel = 12345.f;
  std::fill(o, o + n_out + offset + pad, sentinel);
  FILE* f = fopen(in, "rb");
  const bool read = f && fread(x, sizeof(E), n_in, f) == n_in;
  if (f) fclose(f);
  if (!read) {
    fprintf(stderr, "geglu: cannot read %s\n", in);
    return 2;
  }
  if (launch_error(daam_geglu(0, bf16, x, o + offset, rows, w, nullptr))) return 1;
  long bad = 0;
  for (int r = 0; r < rows; ++r)
    for (int c = 0; c < w; ++c) {
      const float h = to_float(x[(size_t)r * 2 * w + c]), g = to_float(x[(size_t)r * 2 * w + w + c]);
      bad += __float_as_uint(geglu_reference(h, g, bf16)) !=
             __float_as_uint(to_float(o[offset + (size_t)r * w + c]));
    }
  bool kept = true;
  for (int i = 0; i < offset; ++i) kept &= bits_of(o[i]) == bits_of(sentinel);
  for (int i = 0; i < pad; ++i) kept &= bits_of(o[offset + n_out + i]) == bits_of(sentinel);
  printf("geglu (%s) elements off the std::erf expression: %ld %s\n", bf16 ? "bf16" : "fp32",
         bad, bad ? "FAIL" : "ok");
  expect(kept, "elements the call must not write", 0);
  failures += bad != 0;
  f = fopen(out_path, "wb");
  const bool wrote = f && fwrite(o + offset, sizeof(E), n_out, f) == n_out;
  if (f) fclose(f);
  if (!wrote) return 2;
  return failures ? 1 : 0;
}

}  // namespace

int main(int argc, char** argv) {
  if (argc == 8 && std::string(argv[1]) == "geglu") {
    const int rows = atoi(argv[3]), w = atoi(argv[4]), offset = atoi(argv[5]);
    return std::string(argv[2]) == "bf16"
        ? run_geglu<__nv_bfloat16>(rows, w, offset, argv[6], argv[7])
        : run_geglu<float>(rows, w, offset, argv[6], argv[7]);
  }
  if (argc == 5 && std::string(argv[1]) == "smem") {
    printf("%lld\n", ma_smem_bytes(atoi(argv[2]), atoi(argv[3]), atoi(argv[4])));
    return 0;
  }
  if (argc == 2 && std::string(argv[1]) == "tf32") {
    // random bit patterns; every 13-bit tail of a normal and of a subnormal
    // value (the ties among them); zeros, infinities, the largest floats
    std::mt19937 rng(1);
    std::uniform_int_distribution<uint32_t> bits;
    long bad = 0, n = 0;
    auto check = [&](uint32_t b) {
      const float x = __uint_as_float(b);
      if (std::isnan(x)) return;
      bad += tf32_round(x) != emu_cvt_rna_tf32(x);
      ++n;
    };
    for (int i = 0; i < (1 << 22); ++i) check(bits(rng));
    for (uint32_t tail = 0; tail < 0x2000u; ++tail)
      for (uint32_t head : {0x3f800000u, 0xbf800000u, 0x00400000u, 0x80000000u}) check(head | tail);
    for (uint32_t b : {0u, 0x80000000u, 0x7f800000u, 0xff800000u, 0x7f7fffffu, 0xff7fffffu})
      check(b);
    printf("tf32_round differs from cvt.rna.tf32.f32 on %ld of %ld inputs\n", bad, n);
    return bad ? 1 : 0;
  }
  if (argc == 2 && std::string(argv[1]) == "wgmma32") {
    for (int hd : {16, 32, 40, 64, 80, 128, 160})
      by_head_dim(hd, [&](auto c) {
        constexpr int HD = decltype(c)::value;
        if constexpr (wgmma_tf32x3_serves(HD))
          printf("%d %d %d %d\n", HD, WtTile<HD>::BK, WtTile<HD>::STAGES, WtTile<HD>::SMEM);
        return 0;
      });
    return 0;
  }
  if (argc == 4 && std::string(argv[1]) == "smem32") {
    printf("%lld\n", mt_smem_bytes(atoi(argv[2]), atoi(argv[3])));
    return 0;
  }
  if (argc == 5 && std::string(argv[1]) == "refuse") {
    const std::string kind = argv[2];
    const int hd = atoi(argv[3]), Lk = atoi(argv[4]), Lq = 64;
    const float scale = 1.f / std::sqrt((float)hd);
    // packed (1, L, 1, hd) views of nothing
    const int err = kind == "acc"
        ? daam_cross_attention_acc_mma(0, hd, nullptr, nullptr, nullptr, nullptr, nullptr,
                                       1, 1, Lq, Lk, Lq * hd, hd, hd, Lk * hd, hd, hd,
                                       Lk * hd, hd, hd, scale, nullptr)
        : daam_cross_attention_probs_mma(0, hd, nullptr, nullptr, nullptr, nullptr, nullptr,
                                         kind == "bf16", 0, 1, 1, Lq, Lk, Lq * hd, hd, hd,
                                         Lk * hd, hd, hd, Lk * hd, hd, hd, scale, nullptr);
    printf("%s\n", err == cudaErrorInvalidValue ? "refused" : "not refused");
    return 0;
  }
  if (argc == 10 && std::string(argv[1]) == "overlay") {
    const int h = atoi(argv[4]), w = atoi(argv[5]), H = atoi(argv[6]), W = atoi(argv[7]);
    std::vector<double> lut(256 * 3);
    std::vector<float> heat((size_t)h * w);
    std::vector<uint8_t> image((size_t)H * W * 3), out((size_t)H * (1 + 3 * W));
    FILE* f = fopen(argv[2], "rb");
    const bool read = f && fread(lut.data(), 8, lut.size(), f) == lut.size() &&
                      fread(heat.data(), 4, heat.size(), f) == heat.size() &&
                      fread(image.data(), 1, image.size(), f) == image.size();
    if (f) fclose(f);
    if (!read) {
      fprintf(stderr, "overlay: cannot read %s\n", argv[2]);
      return 2;
    }
    std::vector<float> scratch(h ? daam_overlay_scratch_floats(H, W) : 0);
    if (h && launch_error(daam_overlay_resample(0, heat.data(), h, w, H, W, scratch.data(),
                                                nullptr)))
      return 1;
    if (launch_error(daam_png_scanlines(0, image.data(), h ? scratch.data() : nullptr,
                                        lut.data(), H, W, atoi(argv[8]), atoi(argv[9]),
                                        out.data(), nullptr)))
      return 1;
    f = fopen(argv[3], "wb");
    const bool wrote = f && fwrite(out.data(), 1, out.size(), f) == out.size();
    if (f) fclose(f);
    return wrote ? 0 : 2;
  }
  if (argc < 8) {
    fprintf(stderr, "usage: run_case acc|acc32|flash|probs|probs32 B H Lq Lk hd layout "
                    "[f32|bf16 cond]\n");
    return 2;
  }
  const std::string kind = argv[1];
  const Shape s{atoi(argv[2]), atoi(argv[3]), atoi(argv[4]), atoi(argv[5]), atoi(argv[6]),
                std::string(argv[7]) == "packed"};
  std::mt19937 rng(s.Lq * 1000 + s.Lk * 10 + s.hd);
  if (kind == "acc") {
    run_acc<__nv_bfloat16>(s, rng);
  } else if (kind == "acc32") {
    run_acc<float>(s, rng);
  } else if (kind == "flash") {
    run_flash(s, rng);
  } else if (argc == 10 && (kind == "probs" || kind == "probs32")) {
    const bool f32 = std::string(argv[8]) == "f32", cond_only = atoi(argv[9]) != 0;
    using bf16 = __nv_bfloat16;
    if (kind == "probs32" && f32) run_probs<float, float>(s, 0, cond_only, rng);
    else if (kind == "probs32") run_probs<float, bf16>(s, 1, cond_only, rng);
    else if (f32) run_probs<bf16, float>(s, 0, cond_only, rng);
    else run_probs<bf16, bf16>(s, 1, cond_only, rng);
  } else {
    fprintf(stderr, "probs needs a P type and a cond_only flag\n");
    return 2;
  }
  return failures ? 1 : 0;
}
