// Float64 word expansions: the column loops of the expansion Cholesky
// and triangular substitution, one thread block at a time.  The bodies
// of csrc/expansion_chol.cu and csrc/expansion_solve.cu.
//
// chol_panel_block and solve_block are what ONE block of the kernel
// does, written against a thread index ``tid`` of ``nthreads`` and a
// barrier, EXP_SYNC() (__syncthreads() on the card).  The per-value arithmetic
// is csrc/expansion.cuh's, so every entry takes the float64 operations
// of the plain loops (ops/expansion_kernels.py cholesky_panel_plain,
// solve_unblocked_plain) in their order, and the results agree bit for
// bit.  Work is shared between threads only across values, never
// inside one, and EXP_SYNC() separates the phases of a step.
//
// tests/test_torch_expansion_panels.py compiles this header with g++
// (-ffp-contract=off) and runs each block with host threads and a
// std::barrier as EXP_SYNC(), against the plain loops.

#pragma once

#include <string.h>

#include "expansion.cuh"

// The block-level functions are device code in the kernels, and the
// per-value operations they call are out of line there: one copy of
// each operation's code, with registers of its own.  The tests define
// all three macros for their host build.
#ifndef EXP_BLOCK
#define EXP_BLOCK __device__ __forceinline__
#endif
#ifndef EXP_OP
#define EXP_OP __device__ __noinline__
#endif

#ifndef EXP_SYNC
#define EXP_SYNC() __syncthreads()
#endif

namespace expn {

template <int K>
EXP_HD void copy(const double* src, double* dst) {
  for (int i = 0; i < K; ++i) dst[i] = src[i];
}

template <int K>
EXP_HD void set_zero(double* dst) {
  for (int i = 0; i < K; ++i) dst[i] = 0.0;
}

EXP_HD long long word_bits(double x) {
#ifdef __CUDA_ARCH__
  return __double_as_longlong(x);
#else
  long long b;
  memcpy(&b, &x, sizeof b);
  return b;
#endif
}

// Every word +0.0 (not -0.0): add of two such values is one again.
template <int K>
EXP_HD bool is_pos_zero(const double* v) {
  for (int i = 0; i < K; ++i)
    if (word_bits(v[i]) != 0) return false;
  return true;
}

template <int K>
EXP_HD bool same_bits(const double* a, const double* b) {
  for (int i = 0; i < K; ++i)
    if (word_bits(a[i]) != word_bits(b[i])) return false;
  return true;
}

template <int K>
EXP_OP void op_add(const double* a, const double* b, double* out) {
  add<K>(a, b, out);
}

template <int K>
EXP_OP void op_mul(const double* a, const double* b, double* out) {
  mul<K>(a, b, out);
}

template <int K>
EXP_OP void op_add_f64(const double* a, double x, double* out) {
  add_f64<K>(a, x, out);
}

// The seed of sqrt_rsqrt: torch.rsqrt of the leading word, which is
// ::rsqrt on the card and 1 / sqrt on the CPU.
EXP_HD double rsqrt_seed(double x) {
#ifdef __CUDA_ARCH__
  return rsqrt(x);
#else
  return 1.0 / sqrt(x);
#endif
}

// mp/core.py sqrt_rsqrt: Newton on 1/sqrt(a) from the seed, then one
// Heron correction of s = a y.  A negative a gives NaN.
template <int K>
EXP_BLOCK void sqrt_rsqrt(const double* a, double* s, double* y) {
  if (K == 1) {
    s[0] = sqrt(a[0]);
    y[0] = rsqrt_seed(a[0]);
    return;
  }
  y[0] = rsqrt_seed(a[0]);
  for (int i = 1; i < K; ++i) y[i] = 0.0;
  double u[K], v[K];
  // mp/core.py newton_steps: max(1, bit_length(53 K // 50))
  constexpr int kV = K * 53 / 50;
  static_assert(kV < 64, "newton_steps below is written for K <= 60");
  constexpr int kSteps = kV >= 32 ? 6 : kV >= 16 ? 5 : kV >= 8 ? 4
                         : kV >= 4 ? 3 : kV >= 2 ? 2 : 1;
#pragma unroll 1
  for (int it = 0; it < kSteps; ++it) {
    op_mul<K>(y, y, u);                       // y^2
    op_mul<K>(a, u, v);                       // a y^2
    for (int i = 0; i < K; ++i) v[i] = -v[i];
    op_add_f64<K>(v, 1.0, u);                 // 1 - a y^2
    op_mul<K>(y, u, v);
    for (int i = 0; i < K; ++i) v[i] *= 0.5;  // the correction
    op_add<K>(y, v, u);
    copy<K>(u, y);
  }
  double s0[K];
  op_mul<K>(a, y, s0);
  op_mul<K>(s0, s0, u);
  for (int i = 0; i < K; ++i) u[i] = -u[i];
  op_add<K>(a, u, v);                         // a - s^2
  op_mul<K>(v, y, u);
  for (int i = 0; i < K; ++i) u[i] *= 0.5;
  op_add<K>(s0, u, s);
}

// ``count`` additions of +0 to v, the zero terms a finished entry
// takes from the remaining steps' masked updates.  add is a function
// of its operands, so once one leaves v unchanged the rest do too.
template <int K>
EXP_BLOCK void zero_adds(double* v, int count) {
  double z[K], y[K];
  set_zero<K>(z);
  for (int i = 0; i < count; ++i) {
    op_add<K>(v, z, y);
    if (same_bits<K>(y, v)) return;
    copy<K>(y, v);
  }
}

// Entry (r, c) of a block's rows: the pivot block's, then the tile's.
template <int K>
EXP_HD double* panel_entry(double* diag, double* tile, int W, int r, int c) {
  return r < W ? diag + ((long)r * W + c) * K
               : tile + ((long)(r - W) * W + c) * K;
}

// One block's share of the column loop of a Cholesky panel: the
// matrix's rows R >= W of W columns, the first W rows the pivot block.
// The block holds the pivot block (``diag``, from ``in_diag``) and
// ``nt`` rows below it (``tile``, from ``in_tile``), each row W values
// of K words; a block that is not the first of its panel works on a
// private copy of the pivot block, which it computes again, so that
// blocks share nothing.  ``sh`` holds (W + nt + 2) K doubles: the
// step's multipliers, then the pivot's d and 1/d.
//
// Per column t, in the plain loop's order: d, 1/d = sqrt_rsqrt of the
// pivot; the column below it times 1/d (these are the multipliers);
// then every entry in a column c > t takes add(v, -mul(m_r, m_c)).
// An entry of column t is final after the step's zero additions
// (W - t of them, the masked update's zeros of steps t..W-1).  The
// pivot block's upper triangle is not computed and is written +0,
// as the plain version writes it: the blocked Cholesky reads only the
// lower triangle.
template <int K>
EXP_BLOCK void chol_panel_block(const double* in_diag, const double* in_tile,
                             double* diag, double* tile, int W, int nt,
                             double* sh, int tid, int nthreads) {
  const int rows = W + nt;
  for (long w = tid; w < (long)rows * W; w += nthreads) {
    const int r = (int)(w / W), c = (int)(w % W);
    copy<K>(r < W ? in_diag + w * K : in_tile + (w - (long)W * W) * K,
            panel_entry<K>(diag, tile, W, r, c));
  }
  EXP_SYNC();
  double* mult = sh;
  double* piv = sh + (long)rows * K;  // d, then 1/d
#pragma unroll 1
  for (int t = 0; t < W; ++t) {
    if (tid == 0)
      sqrt_rsqrt<K>(panel_entry<K>(diag, tile, W, t, t), piv, piv + K);
    EXP_SYNC();
    for (int r = tid; r < rows; r += nthreads) {
      double v[K];
      if (r < t) {
        set_zero<K>(panel_entry<K>(diag, tile, W, r, t));
        continue;
      }
      if (r == t) {
        copy<K>(piv, v);
      } else {
        op_mul<K>(panel_entry<K>(diag, tile, W, r, t), piv + K, v);
      }
      copy<K>(v, mult + (long)r * K);
      zero_adds<K>(v, W - t);
      copy<K>(v, panel_entry<K>(diag, tile, W, r, t));
    }
    EXP_SYNC();
    const int nc = W - 1 - t;
    for (long w = tid; w < (long)rows * nc; w += nthreads) {
      const int r = (int)(w / nc), c = t + 1 + (int)(w % nc);
      if (r < c) continue;  // the pivot block's upper triangle
      double p[K], v[K];
      op_mul<K>(mult + (long)r * K, mult + (long)c * K, p);
      for (int i = 0; i < K; ++i) p[i] = -p[i];
      double* e = panel_entry<K>(diag, tile, W, r, c);
      op_add<K>(e, p, v);
      copy<K>(v, e);
    }
    EXP_SYNC();
  }
}

// One block's share of the substitution X = L^-1 B (or L^-T B): the
// columns col0 .. col0 + tm - 1 of one batch element's right-hand side,
// L (n, n), B and X (n, m), inv_d (n) values of K words.  ``tree``
// holds n tm K doubles.
//
// Per row i, in the plain loop's order: the n terms mul(l_ik, x_k)
// (a term whose k is masked, k >= i forward or k <= i backward, is
// mul(+0, +0) = +0 and is written so), their sum by mp/core.py sum_'s
// tree (level by level: a[p] + a[p + h] for p < h = len/2, an odd last
// term carried to the next level), then x_i = mul(add(b_i, -sum),
// inv_d_i).  The tree works in place: the p-th partial sum stays in
// slot p and the carried last term in its slot (``tail``).  A pair of
// +0 values adds to +0 and is skipped.
template <int K>
EXP_BLOCK void solve_block(const double* L, const double* B,
                        const double* inv_d, double* X, int n, int m,
                        int col0, int tm, bool transpose, double* tree,
                        int tid, int nthreads) {
#pragma unroll 1
  for (int s = 0; s < n; ++s) {
    const int i = transpose ? n - 1 - s : s;
    for (int w = tid; w < n * tm; w += nthreads) {
      const int k = w / tm, q = w % tm;
      double* dst = tree + (long)w * K;
      if (transpose ? k <= i : k >= i) {
        set_zero<K>(dst);
        continue;
      }
      const double* lik = L + (long)(transpose ? k * n + i : i * n + k) * K;
      op_mul<K>(lik, X + ((long)k * m + col0 + q) * K, dst);
    }
    EXP_SYNC();
    int len = n, tail = n - 1;
#pragma unroll 1
    while (len > 1) {
      const int h = len / 2;
      for (int w = tid; w < h * tm; w += nthreads) {
        const int p = w / tm, q = w % tm;
        const int pb = p + h == len - 1 ? tail : p + h;
        double* a = tree + ((long)p * tm + q) * K;
        const double* b = tree + ((long)pb * tm + q) * K;
        if (is_pos_zero<K>(a) && is_pos_zero<K>(b)) continue;
        double o[K];
        op_add<K>(a, b, o);
        copy<K>(o, a);
      }
      EXP_SYNC();
      if (!(len & 1)) tail = h - 1;
      len = h + (len & 1);
    }
    for (int q = tid; q < tm; q += nthreads) {
      const double* acc = tree + ((long)tail * tm + q) * K;
      double na[K], r[K], o[K];
      for (int t = 0; t < K; ++t) na[t] = -acc[t];
      op_add<K>(B + ((long)i * m + col0 + q) * K, na, r);
      op_mul<K>(r, inv_d + (long)i * K, o);
      copy<K>(o, X + ((long)i * m + col0 + q) * K);
    }
    EXP_SYNC();
  }
}

}  // namespace expn
