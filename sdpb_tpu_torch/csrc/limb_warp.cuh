// Base-2^9 limb arithmetic with one MP value per warp, for the
// factorization kernels in limb_chol.cu and limb_solve.cu and the
// elementwise add, mul and div in limb_elementwise.cu.
//
// The format is limb.cuh's (slot 0 the exponent code, slots 1..L the
// balanced integer limbs).  Here a value of S slots lives in the
// registers of one warp: lane t holds slots t, t + 32, t + 64, ... in
// V<R>::v[0], v[1], ..., where R = ceil((S + 3) / 32) also covers the
// L + 4 slots of a product before it is renormalized.  Slots past the
// valid range are kept at zero.
//
// Every operation gives the same bits as its per-thread version in
// limb.cuh (and as the plain PyTorch version in mp/limb.py):
// - A limb product is an integer below 2^17 and L of them are summed;
//   while every partial sum is an integer below 2^24 (limb.cuh says when)
//   it is exact in float32 in any order and with or without a fused
//   multiply-add: each lane sums the terms of its own output slots, from
//   operands staged in shared memory.
// - A carry pass reads each slot and its right neighbour before either
//   is written, so it is a stencil, and p passes make slot i a function
//   of slots i..i+p: each lane reads those from a shared-memory row once
//   and runs the passes on its own (no chain of p shuffle rounds).
// - The leading non-zero slot is one warp min-reduction, the shift goes
//   through shared memory, and the rebuilt slot 0 needs only whether
//   the limbs are all zero and whether one is not finite (one warp
//   or-reduction; limb.cuh's 0 * sum gives NaN exactly then).
// - The rounded scalar steps (the float32 mantissa estimate, the rsqrt
//   seed, float_limbs, a division's digit estimate) take warp-uniform
//   inputs and are computed by every lane with limb.cuh's own code, so
//   each lane gets the same bits and nothing has to be broadcast.
// The unit is compiled with -fmad=false like limb.cuh.
//
// Every function here must be called by all 32 lanes of a warp with
// warp-uniform arguments (the shuffles and votes use the full mask).
#pragma once

#include "limb.cuh"

namespace limbw {
namespace {

using limb::kBeta;
using limb::kEoff;
using limb::kInvBeta;
using limb::kInvBeta2;
using limb::kZeroE;

constexpr unsigned kFull = 0xffffffffu;

// Registers per lane for a value of S slots and its L + 4 product slots.
__host__ __device__ constexpr int regs_for(int S) { return (S + 3 + 31) / 32; }

// Scratch rows of one warp: row 0 has 32 R slots and the zero slots
// that the carry passes read past the end; row 1 (64 R floats) holds
// one operand's limbs at [32 R, 32 R + L) between zeros that are never
// written, so that shifted and convolution reads out of range give
// zero without a test.
constexpr int kPad = 4;
__host__ __device__ constexpr int row_floats(int R) { return 32 * R + kPad; }
__host__ __device__ constexpr int scratch_floats(int R) {
  return row_floats(R) + 64 * R;
}

template <int R>
struct V {
  float v[R];
};

// Per-warp context: the lane, the format, and the warp's own scratch
// rows in shared memory (buf0: row 0, pad: row 1; init_scratch zeroes
// what must stay zero).
struct Ctx {
  int lane;
  int S;
  int L;
  float* buf0;
  float* pad;
};

template <int R>
__device__ __forceinline__ void init_scratch(const Ctx& c) {
  if (c.lane < kPad) c.buf0[32 * R + c.lane] = 0.0f;
#pragma unroll
  for (int j = 0; j < 2 * R; ++j) c.pad[32 * j + c.lane] = 0.0f;
  __syncwarp();
}

template <int R>
__device__ __forceinline__ V<R> zero_value() {
  V<R> x;
#pragma unroll
  for (int j = 0; j < R; ++j) x.v[j] = 0.0f;
  return x;
}

template <int R>
__device__ __forceinline__ V<R> nan_value(const Ctx& c) {
  V<R> x;
#pragma unroll
  for (int j = 0; j < R; ++j) x.v[j] = (32 * j + c.lane < c.S) ? NAN : 0.0f;
  return x;
}

// Coalesced load / store of the S slots at p (global or shared).
template <int R>
__device__ __forceinline__ V<R> load(const float* p, const Ctx& c) {
  V<R> x;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int s = 32 * j + c.lane;
    x.v[j] = s < c.S ? p[s] : 0.0f;
  }
  return x;
}

template <int R>
__device__ __forceinline__ void store(float* p, const V<R>& x, const Ctx& c) {
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int s = 32 * j + c.lane;
    if (s < c.S) p[s] = x.v[j];
  }
}

// All 32 R register slots into a scratch row (for shifted reads).
template <int R>
__device__ __forceinline__ void stage(float* buf, const V<R>& x,
                                      const Ctx& c) {
#pragma unroll
  for (int j = 0; j < R; ++j) buf[32 * j + c.lane] = x.v[j];
}

// Limbs 1..L of x into the padded row: slot s at pad[32 R + s - 1].
template <int R>
__device__ __forceinline__ void stage_limbs(const V<R>& x, const Ctx& c) {
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int s = 32 * j + c.lane;
    if (s >= 1 && s <= c.L) c.pad[32 * R + s - 1] = x.v[j];
  }
}

template <int R>
__device__ __forceinline__ float slot0(const V<R>& x) {
  return __shfl_sync(kFull, x.v[0], 0);
}

// Slot s of x in every lane (s warp-uniform, s < 32 R).
template <int R>
__device__ __forceinline__ float get_slot(const V<R>& x, int s) {
  float r = 0.0f;
#pragma unroll
  for (int j = 0; j < R; ++j)
    if ((s >> 5) == j) r = x.v[j];
  return __shfl_sync(kFull, r, s & 31);
}

__device__ __forceinline__ int expo0(float x0) {
  return isfinite(x0) ? (int)(fabsf(x0) - (float)kEoff) : 0;
}

// True when limbs 1..L are all zero (a NaN limb is not zero).
template <int R>
__device__ __forceinline__ bool limbs_zero(const V<R>& x, const Ctx& c) {
  bool nz = false;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int s = 32 * j + c.lane;
    nz = nz || (s >= 1 && s <= c.L && !(x.v[j] == 0.0f));
  }
  return !__any_sync(kFull, nz);
}

template <int R>
__device__ __forceinline__ bool same_bits(const V<R>& x, const V<R>& y) {
  bool eq = true;
#pragma unroll
  for (int j = 0; j < R; ++j)
    eq = eq && (__float_as_uint(x.v[j]) == __float_as_uint(y.v[j]));
  return __all_sync(kFull, eq);
}

template <int R>
__device__ __forceinline__ V<R> negate(V<R> x) {
#pragma unroll
  for (int j = 0; j < R; ++j) x.v[j] = -x.v[j];
  return x;
}

// Slot 0 from the exponent and limbs 1..L (limb::build).
template <int R>
__device__ __forceinline__ void build(int e, V<R>& x, const Ctx& c) {
  unsigned flags = 0;  // 1: a limb is not zero, 2: a limb is not finite
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int s = 32 * j + c.lane;
    if (s >= 1 && s <= c.L) {
      if (!(x.v[j] == 0.0f)) flags |= 1u;
      if (!isfinite(x.v[j])) flags |= 2u;
    }
  }
  flags = __reduce_or_sync(kFull, flags);
  const int ec = min(max(e, -kEoff), kEoff - 1) + kEoff;
  const float x0 = !(flags & 1u) ? 0.0f : ((flags & 2u) ? NAN : (float)ec);
  if (c.lane == 0) x.v[0] = x0;
}

// P balanced carry passes over all slots (limb::carry P times).  Slot
// i after P passes depends on slots i..i+P before them; each lane reads
// those from the staged row and runs the passes itself.  Slots at and
// past the valid length are zero, so they carry nothing and stay zero.
template <int P, int R>
__device__ __forceinline__ void carry(V<R>& x, const Ctx& c) {
  stage(c.buf0, x, c);
  __syncwarp();
#pragma unroll
  for (int j = 0; j < R; ++j) {
    float w[P + 1];
    w[0] = x.v[j];
#pragma unroll
    for (int d = 1; d <= P; ++d) w[d] = c.buf0[32 * j + c.lane + d];
#pragma unroll
    for (int p = 0; p < P; ++p) {
#pragma unroll
      for (int k = 0; k < P - p; ++k) {
        const float q = rintf(__fmul_rn(w[k], kInvBeta));
        const float qn = rintf(__fmul_rn(w[k + 1], kInvBeta));
        w[k] = __fadd_rn(__fsub_rn(w[k], __fmul_rn(q, kBeta)), qn);
      }
    }
    x.v[j] = w[0];
  }
  __syncwarp();
}

// ext (slot i weighs 512^(e_top - i), n valid slots, the rest zero) ->
// canonical value (limb::renorm with P carry passes).  Uses c.buf0.
template <int P, int R>
__device__ __forceinline__ V<R> renorm(int e_top, V<R> ext, int n,
                                       const Ctx& c) {
  carry<P>(ext, c);
  unsigned first = 0xffffffffu;
#pragma unroll
  for (int j = R - 1; j >= 0; --j)
    if (ext.v[j] != 0.0f) first = 32 * j + c.lane;  // NaN counts too
  const int z = (int)min(__reduce_min_sync(kFull, first), (unsigned)n);
  const bool any = z < n;
  const int e = e_top - z;
  const bool under = (e < -kEoff) && any;
  const bool over = (e >= kEoff) && any;
  float inf = 0.0f;
  if (over) inf = get_slot(ext, z) > 0.0f ? INFINITY : -INFINITY;
  stage(c.buf0, ext, c);
  __syncwarp();
  V<R> out;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int s = 32 * j + c.lane;
    float v = 0.0f;
    if (s >= 1 && s <= c.L) {
      const int src = s - 1 + z;
      v = src < n ? c.buf0[src] : 0.0f;
      if (under) v = 0.0f;
      if (over) v = inf;
    }
    out.v[j] = v;
  }
  __syncwarp();
  build(e, out, c);
  return out;
}

// a + b (limb::add).  At most one operand is shifted (the other has
// the larger exponent); it goes through the padded row.
template <int R>
__device__ __forceinline__ V<R> add(const V<R>& a, const V<R>& b,
                                    const Ctx& c) {
  const float a0 = slot0(a), b0 = slot0(b);
  if (!isfinite(a0) || !isfinite(b0)) return nan_value<R>(c);
  const int L = c.L;
  const int ea = limbs_zero(a, c) ? kZeroE : expo0(a0);
  const int eb = limbs_zero(b, c) ? kZeroE : expo0(b0);
  const int e = max(ea, eb);
  const int sa = min(max(e - ea, 0), L);
  const int sb = min(max(e - eb, 0), L);
  const int sh = max(sa, sb);
  if (sh > 0) {
    stage_limbs(sa > 0 ? a : b, c);
    __syncwarp();
  }
  V<R> ext;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int s = 32 * j + c.lane;
    float v = 0.0f;
    if (s >= 1 && s <= L) {
      // slot s - sh of the shifted operand, zero when s <= sh
      const float moved = sh > 0 ? c.pad[32 * R + s - 1 - sh] : 0.0f;
      const float va = sa > 0 ? moved : a.v[j];
      const float vb = sb > 0 ? moved : b.v[j];
      v = __fadd_rn(va, vb);
    }
    ext.v[j] = v;
  }
  return renorm<1>(e + 1, ext, L + 1, c);
}

// Truncated product (limb::mul): A[0..S) in shared memory (visible to
// the warp), b's limbs already in the padded row.  Lane t sums the
// convolution terms of its slots t, t + 32, ... in one loop over i that
// all lanes share: A[1 + i] is a broadcast read, and b's limb of each
// term a read of the padded row, zero where the term does not exist.
template <int R>
__device__ __forceinline__ V<R> mul_padded(const float* A, float b0,
                                           const Ctx& c) {
  const float a0 = A[0];
  if (!isfinite(a0) || !isfinite(b0)) return nan_value<R>(c);
  const int L = c.L;
  // pb[32 j - i] = b's limb k - i + 1 for output slot k = 32 j + lane - 2
  const float* pb = c.pad + 32 * R + c.lane - 2;
  float acc[R][4];
#pragma unroll
  for (int j = 0; j < R; ++j)
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[j][u] = 0.0f;
  const float* pa = A + 1;
  int i = 0;
  for (; i + 8 <= L; i += 8) {
    float av[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) av[u] = pa[i + u];
#pragma unroll
    for (int u = 0; u < 8; ++u)
#pragma unroll
      for (int j = 0; j < R; ++j)
        acc[j][u & 3] = __fmaf_rn(av[u], pb[32 * j - i - u], acc[j][u & 3]);
  }
  for (; i < L; ++i) {
    const float av = pa[i];
#pragma unroll
    for (int j = 0; j < R; ++j)
      acc[j][0] = __fmaf_rn(av, pb[32 * j - i], acc[j][0]);
  }
  V<R> ext;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int k = 32 * j + c.lane - 2;
    const float sum = __fadd_rn(__fadd_rn(acc[j][0], acc[j][1]),
                                __fadd_rn(acc[j][2], acc[j][3]));
    ext.v[j] = (k >= 0 && k <= L + 1) ? sum : 0.0f;
  }
  __syncwarp();
  return renorm<3>(expo0(a0) + expo0(b0) + 2, ext, L + 4, c);
}

// a * b with a in shared memory (visible to the warp) and b in
// registers.
template <int R>
__device__ __forceinline__ V<R> mul_smem(const float* A, const V<R>& b,
                                         const Ctx& c) {
  stage_limbs(b, c);
  __syncwarp();
  return mul_padded<R>(A, slot0(b), c);
}

// a * b for values in registers.
template <int R>
__device__ __forceinline__ V<R> mul(const V<R>& a, const V<R>& b,
                                    const Ctx& c) {
  stage(c.buf0, a, c);
  return mul_smem<R>(c.buf0, b, c);
}

// a * x for a float x (limb::mul_float).
template <int R>
__device__ __forceinline__ V<R> mul_float(const V<R>& a, float x,
                                          const Ctx& c) {
  const float a0 = slot0(a);
  if (!isfinite(a0) || !isfinite(x)) return nan_value<R>(c);
  const int L = c.L;
  int e_x;
  float xs[4];
  limb::float_limbs(x, &e_x, xs);
  stage(c.buf0, a, c);
  __syncwarp();
  V<R> ext;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int k = 32 * j + c.lane - 2;
    float acc = 0.0f;
    if (k >= 0 && k <= L + 1) {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        if (t <= k) {
          const float v = (k - t < L) ? c.buf0[1 + k - t] : 0.0f;
          acc = __fadd_rn(acc, __fmul_rn(xs[t], v));
        }
      }
    }
    ext.v[j] = acc;
  }
  __syncwarp();
  V<R> out = renorm<3>(expo0(a0) + e_x - 1 + 2, ext, L + 4, c);
  if (x == 0.0f) {
#pragma unroll
    for (int j = 0; j < R; ++j) out.v[j] = 0.0f;
  }
  return out;
}

// Exact conversion of a warp-uniform float (limb::from_float).
template <int R>
__device__ __forceinline__ V<R> from_float(float x, const Ctx& c) {
  if (isnan(x)) return nan_value<R>(c);
  if (isinf(x)) {
    V<R> out = zero_value<R>();
    if (c.lane == 0) out.v[0] = (float)(2 * kEoff - 1);
    if (c.lane == 1) out.v[0] = x;
    return out;
  }
  int e_x;
  float ls[4];
  limb::float_limbs(x, &e_x, ls);
  V<R> ext = zero_value<R>();
#pragma unroll
  for (int t = 0; t < 4; ++t)
    if (c.lane == 1 + t) ext.v[0] = ls[t];
  return renorm<1>(e_x, ext, 5, c);
}

// a * 512^d, exponent only (limb::scale_limb_exp).
template <int R>
__device__ __forceinline__ V<R> scale_limb_exp(V<R> a, int d, const Ctx& c) {
  const float a0 = slot0(a);
  if (!isfinite(a0)) return a;
  int e = expo0(a0);
  if (!limbs_zero(a, c)) e += d;
  build(e, a, c);
  return a;
}

// float32 estimate of the mantissa from limbs 1..3 (limb::mant3).
template <int R>
__device__ __forceinline__ float mant3(const V<R>& a, const Ctx& c) {
  const float l1 = __shfl_sync(kFull, a.v[0], 1);
  const float l2 = __shfl_sync(kFull, a.v[0], 2);
  const float l3 = __shfl_sync(kFull, a.v[0], 3);
  float m = l1;
  if (c.L > 1) m = __fadd_rn(m, __fmul_rn(l2, kInvBeta));
  if (c.L > 2) m = __fadd_rn(m, __fmul_rn(l3, kInvBeta2));
  return m;
}

// Slot s + 1 of x in the lane that holds slot s, zero past the last
// register: one shuffle per register, lane 31 taking lane 0's value of
// the next register.
template <int R>
__device__ __forceinline__ V<R> next_slot(const V<R>& x, const Ctx& c) {
  float rot[R];
#pragma unroll
  for (int j = 0; j < R; ++j)
    rot[j] = __shfl_sync(kFull, x.v[j], (c.lane + 1) & 31);
  V<R> y;
#pragma unroll
  for (int j = 0; j < R; ++j)
    y.v[j] = c.lane < 31 ? rot[j] : (j + 1 < R ? rot[j + 1] : 0.0f);
  return y;
}

// a / b by long division with redundant balanced quotient digits
// (limb::div).  The remainder's r_i sits in slot i + 1 beside the
// divisor's limb l_i, in registers; slot 0 and the slots past L are held
// at zero.  Each of the L + 2 digits: the warp-uniform estimate from
// slots 1..3 (every lane computes it with limb.cuh's expression), r - q l
// in every lane, the carry pass that keeps slot 1 as a wide head (new
// r_i = r_i - 512 q_i + q_{i+1}, from the right neighbour's carry read
// before the pass), and the one-slot shift that folds the head down
// (another read of the right neighbour): 2 R + 3 shuffles a digit.
// Digit d lands in slot 2 + d of the product-length value that renorm
// turns into the result.
template <int R>
__device__ __forceinline__ V<R> div(const V<R>& a, const V<R>& b,
                                    const Ctx& c) {
  const float a0 = slot0(a), b0 = slot0(b);
  if (!isfinite(a0) || !isfinite(b0)) return nan_value<R>(c);
  const int L = c.L;
  const bool azero = limbs_zero(a, c);
  if (limbs_zero(b, c)) {
    // +-inf (the sign of a's first limb) over a zero divisor, 0/0 NaN
    V<R> out = nan_value<R>(c);
    const float a1 = __shfl_sync(kFull, a.v[0], 1);
    if (!azero && c.lane == 1) out.v[0] = a1 < 0.0f ? -INFINITY : INFINITY;
    return out;
  }
  bool valid[R];
  V<R> r, lb;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int s = 32 * j + c.lane;
    valid[j] = s >= 1 && s <= L;
    r.v[j] = valid[j] ? a.v[j] : 0.0f;
    lb.v[j] = valid[j] ? b.v[j] : 0.0f;
  }
  const float bhat = mant3(b, c);
  const float inv_bhat = (bhat == 0.0f) ? INFINITY : __fdiv_rn(1.0f, bhat);
  V<R> ext = zero_value<R>();
  for (int d = 0; d < L + 2; ++d) {
    const float r0 = __shfl_sync(kFull, r.v[0], 1);
    const float r1 = __shfl_sync(kFull, r.v[0], 2);
    const float r2 = __shfl_sync(kFull, r.v[0], 3);
    const float rhat = __fadd_rn(__fadd_rn(r0, __fmul_rn(r1, kInvBeta)),
                                 __fmul_rn(r2, kInvBeta2));
    const float q = rintf(__fmul_rn(rhat, inv_bhat));
    V<R> cq;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      if (valid[j]) r.v[j] = __fsub_rn(r.v[j], __fmul_rn(q, lb.v[j]));
      cq.v[j] = valid[j] ? rintf(__fmul_rn(r.v[j], kInvBeta)) : 0.0f;
    }
    const V<R> qn = next_slot(cq, c);
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const bool head = j == 0 && c.lane == 1;   // slot 1 carries nothing
      if (valid[j])
        r.v[j] = __fadd_rn(__fsub_rn(r.v[j], __fmul_rn(head ? 0.0f : cq.v[j],
                                                       kBeta)),
                           qn.v[j]);
    }
    const V<R> rn = next_slot(r, c);
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const bool head = j == 0 && c.lane == 1;
      if (valid[j])
        r.v[j] = head ? __fadd_rn(rn.v[j], __fmul_rn(r.v[j], kBeta))
                      : rn.v[j];
      if (32 * j + c.lane == 2 + d) ext.v[j] = q;
    }
  }
  return renorm<3>(expo0(a0) - expo0(b0) + 2, ext, L + 4, c);
}

// (sqrt(a), 1/sqrt(a)) (limb::sqrt_rsqrt): Newton on 1/sqrt from the
// float32 seed, then one Heron correction.  Negative -> NaN; zero ->
// (0, +inf).
template <int R>
__device__ __forceinline__ void sqrt_rsqrt(const V<R>& a, V<R>& s, V<R>& y,
                                           int steps, const Ctx& c) {
  const int ea = expo0(slot0(a));
  const float m = mant3(a, c);
  const int e2 = limb::floordiv(ea, 2);
  const int rem = ea - 2 * e2;
  const float mm = __fmul_rn(m, rem == 1 ? kBeta : 1.0f);
  const float y0 = __fdiv_rn(1.0f, __fsqrt_rn(mm));
  y = scale_limb_exp(from_float<R>(y0, c), -e2, c);
  const V<R> one = from_float<R>(1.0f, c);
  for (int it = 0; it < steps; ++it) {
    V<R> t = mul(a, mul(y, y, c), c);                    // a y^2
    t = add(negate(t), one, c);                          // 1 - a y^2
    t = mul_float(mul(y, t, c), 0.5f, c);
    y = add(y, t, c);
  }
  s = mul(a, y, c);
  V<R> t = add(a, negate(mul(s, s, c)), c);              // a - s^2
  t = mul_float(mul(t, y, c), 0.5f, c);
  s = add(s, t, c);
  if (limbs_zero(a, c)) {
    s = zero_value<R>();
    y = from_float<R>(INFINITY, c);
  }
}

// The context of the calling warp: its scratch rows in `scratch`
// (scratch_floats(R) floats per warp), initialized.
template <int R>
__device__ __forceinline__ Ctx warp_ctx(float* scratch, int S) {
  float* buf = scratch + (threadIdx.x >> 5) * scratch_floats(R);
  const Ctx c{(int)(threadIdx.x & 31), S, S - 1, buf, buf + row_floats(R)};
  init_scratch<R>(c);
  return c;
}

// cell - a * b, with a and b in shared memory visible to the warp.
template <int R>
__device__ __forceinline__ V<R> sub_product(const float* cell, const float* a,
                                            const float* b, const Ctx& c) {
  const V<R> u = mul_smem<R>(a, load<R>(b, c), c);
  return add(load<R>(cell, c), negate(u), c);
}

}  // namespace
}  // namespace limbw
