// Base-2^9 limb arithmetic as device functions, one MP value per thread:
// the reference that the warp operations of limb_warp.cuh are held to
// bit for bit (tests/test_torch_warp_emulation.py), and the constants and
// scalar steps they share.  One MP value is a float array of S = 1 + L
// slots:
//
//   slot 0   exponent code x0, e = |x0| - EOFF in limb units
//   slot i   limb l_i, an integer-valued float, balanced (|l_i| <~ 270)
//   value  = (sum_i l_i * 512^(1-i)) * 512^e
//
// This is the arithmetic of sdpb_tpu/mp/limb.py (and of the port's plain
// PyTorch version, sdpb_tpu_torch/mp/limb.py) written per element.  Limb
// products are below 2^17 and L of them are summed; while every partial
// sum is an integer below 2^24, float32 arithmetic is exact in any order
// and add, neg and mul agree bit for bit with the tensor versions.  That
// holds for any limbs up to S = 231 slots (|l| <= 270) and, above it, for
// all but limb patterns of one sign near +-256 throughout, a bound the
// JAX format shares.
// The rounded steps (the f32 mantissa estimate, the rsqrt seed) use the
// same IEEE operations: rintf rounds half to even like torch.round, the
// seed is 1.0f / sqrtf(x) (both correctly rounded without fast math), and
// the file is compiled with -fmad=false so no multiply-add is contracted.
#pragma once

#include <math.h>

namespace limb {
// Internal linkage: every translation unit that includes this header gets
// its own copy of the device functions (no duplicate host stubs at link).
namespace {

constexpr int kB = 9;
constexpr float kBeta = 512.0f;
constexpr float kInvBeta = 1.0f / 512.0f;
constexpr float kInvBeta2 = 1.0f / 262144.0f;
constexpr int kEoff = 16384;
constexpr int kZeroE = -10000000;
// The slot class a unit is built for (ops/limb_kernels.py SLOT_CLASSES):
// the kernels take values of kMinSlots..kMaxSlots slots, and the local
// arrays below hold kMaxSlots.  --precision 1024 needs S = 116, 2048
// S = 230 and 4096 S = 458.
#ifndef LIMB_MIN_SLOTS
#define LIMB_MIN_SLOTS 4
#endif
#ifndef LIMB_MAX_SLOTS
#define LIMB_MAX_SLOTS 128
#endif
constexpr int kMinSlots = LIMB_MIN_SLOTS;
constexpr int kMaxSlots = LIMB_MAX_SLOTS;
constexpr int kMaxExt = kMaxSlots + 4;

__device__ __forceinline__ int floordiv(int a, int b) {
  int q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}

__device__ __forceinline__ int expo(const float* a) {
  return isfinite(a[0]) ? (int)(fabsf(a[0]) - (float)kEoff) : 0;
}

__device__ __forceinline__ bool is_zero(const float* limbs, int L) {
  for (int i = 0; i < L; ++i)
    if (!(limbs[i] == 0.0f)) return false;
  return true;
}

__device__ __forceinline__ void fill(float* a, int S, float v) {
  for (int i = 0; i < S; ++i) a[i] = v;
}

__device__ __forceinline__ void copy(const float* a, float* out, int S) {
  for (int i = 0; i < S; ++i) out[i] = a[i];
}

__device__ __forceinline__ void negate(float* a, int S) {
  for (int i = 0; i < S; ++i) a[i] = -a[i];
}

// Slot 0 from the exponent and the limbs already in out[1..L]: clamped
// exponent, canonical zero, limb NaN/Inf folded in through 0 * sum.
__device__ __forceinline__ void build(int e, float* out, int L) {
  float s = 0.0f;
  bool zero = true;
  for (int i = 1; i <= L; ++i) {
    s = __fadd_rn(s, out[i]);
    zero = zero && (out[i] == 0.0f);
  }
  int ec = min(max(e, -kEoff), kEoff - 1) + kEoff;
  float z = __fmul_rn(0.0f, s);
  out[0] = zero ? z : __fadd_rn((float)ec, z);
}

// One balanced carry pass: l = 512 q + r, l_i <- r_i + q_{i+1}.
__device__ __forceinline__ void carry(float* ext, int n) {
  float q = rintf(__fmul_rn(ext[0], kInvBeta));
  for (int i = 0; i < n; ++i) {
    float r = __fsub_rn(ext[i], __fmul_rn(q, kBeta));
    float qn = (i + 1 < n) ? rintf(__fmul_rn(ext[i + 1], kInvBeta)) : 0.0f;
    ext[i] = __fadd_rn(r, qn);
    q = qn;
  }
}

// ext[0..n) with slot j weighing 512^(e_top - j) -> canonical out[0..L].
__device__ __noinline__ void renorm(int e_top, float* ext, int n, int L,
                                    int passes, float* out) {
  for (int p = 0; p < passes; ++p) carry(ext, n);
  int z = n;
  for (int i = 0; i < n; ++i) {
    if (ext[i] != 0.0f) {  // NaN counts as non-zero
      z = i;
      break;
    }
  }
  bool any = z < n;
  int e = e_top - z;
  bool under = (e < -kEoff) && any;
  bool over = (e >= kEoff) && any;
  float lead = any ? ext[z] : 0.0f;
  float inf = lead > 0.0f ? INFINITY : -INFINITY;
  for (int i = 0; i < L; ++i) {
    float v = (i + z < n) ? ext[i + z] : 0.0f;
    if (under) v = 0.0f;
    if (over) v = inf;
    out[1 + i] = v;
  }
  build(e, out, L);
}

__device__ __noinline__ void add(const float* a, const float* b, float* out,
                                 int L) {
  if (!isfinite(a[0]) || !isfinite(b[0])) {
    fill(out, L + 1, NAN);
    return;
  }
  int ea = is_zero(a + 1, L) ? kZeroE : expo(a);
  int eb = is_zero(b + 1, L) ? kZeroE : expo(b);
  int e = max(ea, eb);
  int sa = min(max(e - ea, 0), L);
  int sb = min(max(e - eb, 0), L);
  float ext[kMaxExt];
  ext[0] = 0.0f;
  for (int i = 0; i < L; ++i) {
    float va = (i >= sa) ? a[1 + i - sa] : 0.0f;
    float vb = (i >= sb) ? b[1 + i - sb] : 0.0f;
    ext[1 + i] = __fadd_rn(va, vb);
  }
  renorm(e + 1, ext, L + 1, L, 1, out);
}

// Truncated product: the limb convolution up to L + 2 output slots.
__device__ __noinline__ void mul(const float* a, const float* b, float* out,
                                 int L) {
  if (!isfinite(a[0]) || !isfinite(b[0])) {
    fill(out, L + 1, NAN);
    return;
  }
  float ext[kMaxExt];
  ext[0] = 0.0f;
  ext[1] = 0.0f;
  for (int k = 0; k < L + 2; ++k) {
    float acc = 0.0f;
    int lo = max(0, k - L + 1), hi = min(k, L - 1);
    for (int i = lo; i <= hi; ++i)
      acc = __fadd_rn(acc, __fmul_rn(a[1 + i], b[1 + k - i]));
    ext[2 + k] = acc;
  }
  renorm(expo(a) + expo(b) + 2, ext, L + 4, L, 3, out);
}

// x = (sum_t l_t 512^-t) * 512^e_x exactly, with 4 integer limbs.
__device__ __forceinline__ void float_limbs(float x, int* e_x, float* ls) {
  bool ok = isfinite(x) && x != 0.0f;
  int ex = 0;
  float m = frexpf(x, &ex);
  if (!ok) {
    m = 0.0f;
    ex = 0;
  }
  int e = -floordiv(-ex, kB);
  int r = kB * e - ex;
  float u = ldexpf(m, -r);
  for (int t = 0; t < 4; ++t) {
    u = __fmul_rn(u, kBeta);
    float li = rintf(u);
    ls[t] = li;
    u = __fsub_rn(u, li);
  }
  *e_x = ok ? e : 0;
}

__device__ __noinline__ void from_float(float x, float* out, int L) {
  if (isnan(x)) {
    fill(out, L + 1, NAN);
    return;
  }
  if (isinf(x)) {
    fill(out, L + 1, 0.0f);
    out[0] = (float)(2 * kEoff - 1);
    out[1] = x;
    return;
  }
  int e_x;
  float ext[kMaxExt];
  ext[0] = 0.0f;
  float_limbs(x, &e_x, ext + 1);
  renorm(e_x, ext, 5, L, 1, out);
}

__device__ __noinline__ void mul_float(const float* a, float x, float* out,
                                       int L) {
  if (!isfinite(a[0]) || !isfinite(x)) {
    fill(out, L + 1, NAN);
    return;
  }
  int e_x;
  float xs[4];
  float_limbs(x, &e_x, xs);
  float ext[kMaxExt];
  ext[0] = 0.0f;
  ext[1] = 0.0f;
  for (int k = 0; k < L + 2; ++k) {
    float acc = 0.0f;
    for (int t = 0; t < 4 && t <= k; ++t) {
      float v = (k - t < L) ? a[1 + k - t] : 0.0f;
      acc = __fadd_rn(acc, __fmul_rn(xs[t], v));
    }
    ext[2 + k] = acc;
  }
  renorm(expo(a) + e_x - 1 + 2, ext, L + 4, L, 3, out);
  if (x == 0.0f) fill(out, L + 1, 0.0f);
}

__device__ __forceinline__ void scale_limb_exp(float* a, int d, int L) {
  if (!isfinite(a[0])) return;
  int e = expo(a);
  if (!is_zero(a + 1, L)) e += d;
  build(e, a, L);
}

__device__ __forceinline__ float mant3(const float* limbs, int L) {
  float m = limbs[0];
  if (L > 1) m = __fadd_rn(m, __fmul_rn(limbs[1], kInvBeta));
  if (L > 2) m = __fadd_rn(m, __fmul_rn(limbs[2], kInvBeta2));
  return m;
}

// One balanced carry pass that keeps slot 0 as a wide accumulator (no
// carry leaves it; it absorbs the carry from slot 1).
__device__ __forceinline__ void carry_keep_head(float* r, int n) {
  float q = 0.0f;  // slot 0 makes no carry
  for (int i = 0; i < n; ++i) {
    float qn = (i + 1 < n) ? rintf(__fmul_rn(r[i + 1], kInvBeta)) : 0.0f;
    r[i] = __fadd_rn(__fsub_rn(r[i], __fmul_rn(q, kBeta)), qn);
    q = qn;
  }
}

// Long division with redundant balanced quotient digits (L + 2 digits
// from a float32 estimate of the remainder over the divisor).
__device__ __noinline__ void div(const float* a, const float* b, float* out,
                                 int L) {
  if (!isfinite(a[0]) || !isfinite(b[0])) {
    fill(out, L + 1, NAN);
    return;
  }
  const float* lb = b + 1;
  float bhat = mant3(lb, L);
  float inv_bhat = (bhat == 0.0f) ? INFINITY : __fdiv_rn(1.0f, bhat);
  float r[kMaxSlots];
  for (int i = 0; i < L; ++i) r[i] = a[1 + i];
  float ext[kMaxExt];
  ext[0] = 0.0f;
  ext[1] = 0.0f;
  for (int d = 0; d < L + 2; ++d) {
    float rhat = __fadd_rn(__fadd_rn(r[0], __fmul_rn(r[1], kInvBeta)),
                           __fmul_rn(r[2], kInvBeta2));
    float q = rintf(__fmul_rn(rhat, inv_bhat));
    for (int i = 0; i < L; ++i) r[i] = __fsub_rn(r[i], __fmul_rn(q, lb[i]));
    carry_keep_head(r, L);
    float head = __fmul_rn(r[0], kBeta);
    r[0] = __fadd_rn(r[1], head);
    for (int i = 1; i + 1 < L; ++i) r[i] = r[i + 1];
    r[L - 1] = 0.0f;
    ext[2 + d] = q;
  }
  renorm(expo(a) - expo(b) + 2, ext, L + 4, L, 3, out);
  bool bzero = is_zero(lb, L), azero = is_zero(a + 1, L);
  if (bzero && !azero) {
    fill(out, L + 1, NAN);
    out[1] = a[1] < 0.0f ? -INFINITY : INFINITY;
  } else if (bzero && azero) {
    fill(out, L + 1, NAN);
  }
}

// (sqrt(a), 1/sqrt(a)): Newton on 1/sqrt from a float32 seed, then one
// Heron correction for the sqrt.  Negative -> NaN; zero -> (0, +inf).
__device__ __noinline__ void sqrt_rsqrt(const float* a, float* s, float* y,
                                        int L, int steps) {
  const int S = L + 1;
  int ea = expo(a);
  float m = mant3(a + 1, L);
  int e2 = floordiv(ea, 2);
  int rem = ea - 2 * e2;
  float mm = __fmul_rn(m, rem == 1 ? kBeta : 1.0f);
  float y0 = __fdiv_rn(1.0f, __fsqrt_rn(mm));
  from_float(y0, y, L);
  scale_limb_exp(y, -e2, L);
  float t1[kMaxSlots], t2[kMaxSlots], one[kMaxSlots];
  from_float(1.0f, one, L);
  for (int it = 0; it < steps; ++it) {
    mul(y, y, t1, L);
    mul(a, t1, t2, L);          // a y^2
    negate(t2, S);
    add(t2, one, t1, L);        // 1 - a y^2
    mul(y, t1, t2, L);
    mul_float(t2, 0.5f, t1, L);
    add(y, t1, t2, L);
    copy(t2, y, S);
  }
  mul(a, y, s, L);
  mul(s, s, t1, L);
  negate(t1, S);
  add(a, t1, t2, L);            // a - s^2
  mul(t2, y, t1, L);
  mul_float(t1, 0.5f, t2, L);
  add(s, t2, t1, L);
  copy(t1, s, S);
  if (is_zero(a + 1, L)) {
    fill(s, S, 0.0f);
    from_float(INFINITY, y, L);
  }
}

}  // namespace
}  // namespace limb
