// Float64 word expansions, one value per thread: the primitives of every
// expansion kernel (two_sum, two_prod, merge_words, mul_terms, key_less)
// and the reference per-value routines that the register and warp
// operations (csrc/expansion_regs.cuh, csrc/expansion_warp.cuh) are held
// to bit for bit in tests/test_torch_expansion_warp.py.
//
// An expansion of K words holds a value as the exact sum of K float64
// words in decreasing order of magnitude.  These are the algorithms of
// the JAX package's sdpb_tpu/mp/core.py (add :422, add_f64 :446,
// mul :487, mul_f64 :516, div :558) and of their plain PyTorch versions
// (sdpb_tpu_torch/mp/core.py add_plain, add_f64_plain, mul_plain,
// mul_f64_plain, div_plain), step for step: the same bitonic merge
// network, the same level order of the partial products, the same
// two_sum chain (VecSum) and the same predicated emit
// (VecSumErrBranch), so that all three agree bit for bit.  Every
// transform relies on float64 add, sub, mul and div rounding to
// nearest with no fused multiply-add: build with -fmad=false (nvcc) or
// -ffp-contract=off (a host compiler).
//
// The header has no CUDA dependency besides the EXP_HD qualifier, so
// tests/test_torch_expansion.py compiles the same routines with g++ and
// holds them against the plain versions on the CPU.

#pragma once

#include <math.h>

#ifndef EXP_HD
#define EXP_HD __host__ __device__ __forceinline__
#endif

namespace expn {

// Largest K a build takes (ops/expansion_kernels.py MAX_WORDS): the CRT
// prime pool's limit, --precision 2862.  The value-a-thread operations
// (this header's, expansion_regs.cuh's) hold K <= kThreadMaxWords
// (THREAD_MAX_WORDS, --precision 1060) in registers; above that every
// kernel runs its operations a value a warp (expansion_warp.cuh).
constexpr int kMaxWords = 54;
constexpr int kThreadMaxWords = 20;

// Words of the bitonic merge in add: the smallest power of two >= 2K.
template <int K>
EXP_HD constexpr int merge_words() {
  int n = 1;
  while (n < 2 * K) n <<= 1;
  return n;
}

// Partial products mul keeps: p[i][j] with i + j <= K and e[i][j] with
// i + j + 1 <= K (i, j < K).
template <int K>
EXP_HD constexpr int mul_terms() {
  int n = 0;
  for (int i = 0; i < K; ++i)
    for (int j = 0; j < K; ++j) n += (i + j <= K) + (i + j + 1 <= K);
  return n;
}

EXP_HD void two_sum(double a, double b, double& s, double& e) {
  const double t = a + b;
  const double bb = t - a;
  e = (a - (t - bb)) + (b - bb);
  s = t;
}

EXP_HD void fast_two_sum(double a, double b, double& s, double& e) {
  const double t = a + b;
  e = b - (t - a);
  s = t;
}

EXP_HD void split(double a, double& hi, double& lo) {
  const double t = 134217729.0 * a;  // 2^27 + 1
  hi = t - (t - a);
  lo = a - hi;
}

EXP_HD void two_prod(double a, double b, double& p, double& e) {
  const double q = a * b;
  double ahi, alo, bhi, blo;
  split(a, ahi, alo);
  split(b, bhi, blo);
  e = ((ahi * bhi - q) + ahi * blo + alo * bhi) + alo * blo;
  p = q;
}

// VecSum, in place: bottom-up two_sum chain; m[0] gets the sum, m[i+1]
// the error of the link at word i.
EXP_HD void vecsum(double* m, int n) {
  double s = m[n - 1];
  for (int i = n - 2; i >= 0; --i) {
    double t, e;
    two_sum(m[i], s, t, e);
    m[i + 1] = e;
    s = t;
  }
  m[0] = s;
}

// VecSumErrBranch: top-down fast_two_sum, a word emitted only where the
// link's error is nonzero (and a slot is left for the last residual).
template <int K>
EXP_HD void err_branch(const double* m, int n, double* out) {
  for (int t = 0; t < K; ++t) out[t] = 0.0;
  int j = 0;
  double e = m[0];
  for (int i = 1; i < n; ++i) {
    double r, e2;
    fast_two_sum(e, m[i], r, e2);
    if (e2 != 0.0 && j < K - 1) {
      out[j++] = r;
      e = e2;
    } else {
      e = r;
    }
  }
  out[j] = e;
}

// renorm_words(m, K, sort=False): VecSum once, then VecSumErrBranch.
template <int K>
EXP_HD void renorm(double* m, int n, double* out) {
  if (n == 1) {
    out[0] = m[0];
    for (int t = 1; t < K; ++t) out[t] = 0.0;
    return;
  }
  vecsum(m, n);
  err_branch<K>(m, n, out);
}

// The order of a stable ascending sort on the key -|x|, NaN last.
EXP_HD bool key_less(double x, double y) {
  const double kx = -fabs(x), ky = -fabs(y);
  if (isnan(kx)) return false;
  if (isnan(ky)) return true;
  return kx < ky;
}

template <int K>
EXP_HD void add(const double* a, const double* b, double* out) {
  if (K == 1) {
    out[0] = a[0] + b[0];
    return;
  }
  if (K == 2) {
    // AccurateDWPlusDW (Joldes-Muller-Popescu)
    double s, e, t, te;
    two_sum(a[0], b[0], s, e);
    two_sum(a[1], b[1], t, te);
    e = e + t;
    fast_two_sum(s, e, s, e);
    e = e + te;
    fast_two_sum(s, e, s, e);
    out[0] = s;
    out[1] = e;
    return;
  }
  constexpr int N = merge_words<K>();
  double m[N];
  // bitonic input [a | zeros | b reversed]
  for (int t = 0; t < N; ++t) m[t] = 0.0;
  for (int t = 0; t < K; ++t) {
    m[t] = a[t];
    m[N - 1 - t] = b[t];
  }
  // merge network: the pair (i, i + d) swaps unless |m_i| >= |m_{i+d}|
  for (int d = N / 2; d >= 1; d /= 2)
    for (int s0 = 0; s0 < N; s0 += 2 * d)
      for (int t = 0; t < d; ++t) {
        const double x = m[s0 + t], y = m[s0 + t + d];
        if (!(fabs(x) >= fabs(y))) {
          m[s0 + t] = y;
          m[s0 + t + d] = x;
        }
      }
  renorm<K>(m, N, out);
}

template <int K>
EXP_HD void add_f64(const double* a, double x, double* out) {
  if (K == 1) {
    out[0] = a[0] + x;
    return;
  }
  double m[K + 1];
  for (int t = 0; t < K; ++t) m[t] = a[t];
  m[K] = x;
  // stable insertion sort by decreasing magnitude
  for (int i = 1; i <= K; ++i) {
    const double v = m[i];
    int j = i - 1;
    while (j >= 0 && key_less(v, m[j])) {
      m[j + 1] = m[j];
      --j;
    }
    m[j + 1] = v;
  }
  renorm<K>(m, K + 1, out);
}

template <int K>
EXP_HD void mul(const double* a, const double* b, double* out) {
  if (K == 1) {
    out[0] = a[0] * b[0];
    return;
  }
  if (K == 2) {
    double p, e;
    two_prod(a[0], b[0], p, e);
    e = e + (a[0] * b[1] + a[1] * b[0]);
    fast_two_sum(p, e, p, e);
    out[0] = p;
    out[1] = e;
    return;
  }
  // level l: the values p[i][l-i], then the errors e[i][l-1-i], each
  // by ascending i.  A pair's two_prod is formed once, in the value
  // pass: its error waits in e_prev[i] for the level above, and the
  // last level (i + j = K) needs the rounded products only.
  double w[mul_terms<K>()];
  double e_cur[K], e_prev[K];
  for (int i = 0; i < K; ++i) e_cur[i] = e_prev[i] = 0.0;
  int n = 0;
  for (int l = 0; l <= K; ++l) {
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const int j = l - i;
      if (j < 0 || j >= K) continue;
      if (l == K) {
        w[n++] = a[i] * b[j];
      } else {
        two_prod(a[i], b[j], w[n++], e_cur[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const int j = l - 1 - i;
      if (l >= 1 && j >= 0 && j < K) w[n++] = e_prev[i];
    }
#pragma unroll
    for (int i = 0; i < K; ++i) e_prev[i] = e_cur[i];
  }
  renorm<K>(w, n, out);
}

template <int K>
EXP_HD void mul_f64(const double* a, double x, double* out) {
  if (K == 1) {
    out[0] = a[0] * x;
    return;
  }
  // [p_0, p_1, e_0, p_2, e_1, ..., p_{K-1}, e_{K-2}]
  double w[2 * K - 1];
  double e_prev;
  two_prod(a[0], x, w[0], e_prev);
  for (int i = 1; i < K; ++i) {
    double p, e;
    two_prod(a[i], x, p, e);
    w[2 * i - 1] = p;
    w[2 * i] = e_prev;
    e_prev = e;
  }
  renorm<K>(w, 2 * K - 1, out);
}

template <int K>
EXP_HD void div(const double* a, const double* b, double* out) {
  if (K == 1) {
    out[0] = a[0] / b[0];
    return;
  }
  // K + 1 quotient words, r <- r - b q_i, then renormalized
  double r[K], q[K + 1], t[K];
  for (int i = 0; i < K; ++i) r[i] = a[i];
  for (int s = 0; s <= K; ++s) {
    const double qi = r[0] / b[0];
    mul_f64<K>(b, qi, t);
    for (int i = 0; i < K; ++i) t[i] = -t[i];
    double nr[K];
    add<K>(r, t, nr);
    for (int i = 0; i < K; ++i) r[i] = nr[i];
    q[s] = qi;
  }
  renorm<K>(q, K + 1, out);
}

// One value of operation OP: 0 add, 1 mul, 2 div (b an expansion of K
// words); 3 add_f64, 4 mul_f64 (b one float64 word).  The host build's
// loop in tests/test_torch_expansion.py.
template <int K, int OP>
EXP_HD void apply(const double* a, const double* b, double* out) {
  double x[K], o[K];
  for (int t = 0; t < K; ++t) x[t] = a[t];
  if (OP <= 2) {
    double y[K];
    for (int t = 0; t < K; ++t) y[t] = b[t];
    if (OP == 0) {
      add<K>(x, y, o);
    } else if (OP == 1) {
      mul<K>(x, y, o);
    } else {
      div<K>(x, y, o);
    }
  } else if (OP == 3) {
    add_f64<K>(x, b[0], o);
  } else {
    mul_f64<K>(x, b[0], o);
  }
  for (int t = 0; t < K; ++t) out[t] = o[t];
}

}  // namespace expn
