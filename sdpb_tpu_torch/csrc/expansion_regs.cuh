// Float64 word expansions in registers: the per-value operations of the
// column-loop kernels (csrc/expansion_panels.cuh) and of the elementwise
// kernel's value-a-thread design (csrc/expansion_elementwise.cuh), K <=
// kThreadMaxWords.
//
// The same algorithms as csrc/expansion.cuh (add, add_f64, mul, mul_f64,
// div), float64 operation for float64 operation in the same order, so
// the results agree bit for bit; what differs is where the words live.  Every loop
// here runs over a compile-time range (static_for), so every array is
// indexed by constants and lives in registers, or keeps its words in
// the thread's scratch in shared memory: no operation touches local
// memory.  Three points needed a new form:
//
// - VecSumErrBranch emits a word only where a link's error is nonzero,
//   at a position known at run time.  The emitted words go to the
//   thread's K-word buffer in shared memory (Emit), one predicated
//   store a link off the dependency chain, and are read back once.
//   Once K - 1 words are out, every further link is a plain addition:
//   the links run in segments of 8 behind a branch on that, so a
//   saturated chain costs one dependent addition a link instead of
//   four.
// - mul's partial products are not stored: VecSum forms them on the fly
//   in its bottom-up order.  Its errors, which VecSumErrBranch reads
//   top-down, stay in registers up to K = 6 and in the thread's scratch
//   for K = 7, 8 (mul_unrolled); above, mul_stream runs in loops over the
//   levels of the products, keeps VecSum's partial sums at the level
//   boundaries in the scratch and forms each level's errors again from
//   its boundary (the same two_sums on the same words: the same bits),
//   with a code size and a register count that do not grow with K.
// - add_f64's stable insertion sort becomes an insertion by rank when a
//   is already in order (a renormalized expansion always is), and an
//   odd-even transposition network otherwise; both give the stable sort.
//
// The header has no CUDA dependency besides EXP_HD, so the tests
// compile it with g++ -ffp-contract=off.

#pragma once

#include <utility>

#include "expansion.cuh"

namespace expn {
namespace regs {

// f(integral_constant<int, i>) for i = LO .. HI - 1, in that order.
template <int LO, class F, int... I>
EXP_HD void static_for_impl(F& f, std::integer_sequence<int, I...>) {
  (f(std::integral_constant<int, LO + I>{}), ...);
}
template <int LO, int HI, class F>
EXP_HD void static_for(F&& f) {
  if constexpr (HI > LO)
    static_for_impl<LO>(f, std::make_integer_sequence<int, HI - LO>{});
}
// f(integral_constant<int, i>) for i = HI - 1 down to LO.
template <int HI, class F, int... I>
EXP_HD void static_for_down_impl(F& f, std::integer_sequence<int, I...>) {
  (f(std::integral_constant<int, HI - 1 - I>{}), ...);
}
template <int LO, int HI, class F>
EXP_HD void static_for_down(F&& f) {
  if constexpr (HI > LO)
    static_for_down_impl<HI>(f, std::make_integer_sequence<int, HI - LO>{});
}

#define EXP_IDX(I) decltype(I)::value

// A thread's scratch words in shared memory, word w at p[w * stride]:
// first the K words VecSumErrBranch emits, then (K >= kMulStream) mul's
// operands and VecSum's partial sums and errors (thread_words).
struct Emit {
  double* p;
  int stride;
};

// A thread's mul keeps VecSum's errors in registers below K = kMulSmem,
// in its scratch below kMulStream, and from there streams its partial
// products through loops over their levels (mul_stream).
constexpr int kMulSmem = 7;
constexpr int kMulStream = 9;

template <int K>
EXP_HD constexpr int thread_words() {
  return K < kMulSmem ? K : K < kMulStream ? K + mul_terms<K>() - 1
                                           : 6 * K + 1;
}

template <int K>
EXP_HD void load(const double* src, double (&v)[K]) {
  static_for<0, K>([&](auto I) { v[EXP_IDX(I)] = src[EXP_IDX(I)]; });
}

template <int K>
EXP_HD void store(const double (&v)[K], double* dst) {
  static_for<0, K>([&](auto I) { dst[EXP_IDX(I)] = v[EXP_IDX(I)]; });
}

template <int K>
EXP_HD void load_strided(const double* src, int st, double (&v)[K]) {
  static_for<0, K>([&](auto I) { v[EXP_IDX(I)] = src[EXP_IDX(I) * st]; });
}

template <int K>
EXP_HD void store_strided(const double (&v)[K], double* dst, int st) {
  static_for<0, K>([&](auto I) { dst[EXP_IDX(I) * st] = v[EXP_IDX(I)]; });
}

// One link of VecSumErrBranch (expansion.cuh err_branch): fast_two_sum
// of the running word e and the next term m, r emitted where the error
// is nonzero and a slot is left.
template <int K>
EXP_HD void eb_link(double& e, int& j, double m, const Emit& em) {
  const double r = e + m;
  const double e2 = m - (r - e);
  const bool emit = e2 != 0.0 && j < K - 1;
  if (emit) em.p[j * em.stride] = r;
  e = emit ? e2 : r;
  j += emit ? 1 : 0;
}

// The links of the terms m[LO .. HI - 1], in segments of 8: a segment
// that starts with K - 1 words out takes only the additions.
template <int K, int LO, int HI, int N>
EXP_HD void eb_range(double& e, int& j, const double (&m)[N],
                     const Emit& em) {
  constexpr int S = 8;
  static_for<0, (HI - LO + S - 1) / S>([&](auto G) {
    constexpr int a = LO + EXP_IDX(G) * S;
    constexpr int b = a + S < HI ? a + S : HI;
    if (j < K - 1) {
      static_for<a, b>([&](auto I) {
        eb_link<K>(e, j, m[EXP_IDX(I)], em);
      });
    } else {
      static_for<a, b>([&](auto I) { e = e + m[EXP_IDX(I)]; });
    }
  });
}

// The links of the terms src[(LO .. HI - 1) * st] (in shared memory),
// in segments of 8 as eb_range; each segment's words are read before the
// previous segment's links run, so that no read waits on the chain.
template <int K, int LO, int HI>
EXP_HD void eb_range_strided(double& e, int& j, const double* src, int st,
                             const Emit& em) {
  constexpr int S = 8;
  constexpr int G = (HI - LO + S - 1) / S;
  double nxt[S];
  static_for<0, S>([&](auto Q) {
    constexpr int i = LO + EXP_IDX(Q);
    nxt[EXP_IDX(Q)] = i < HI ? src[(i < HI ? i : LO) * st] : 0.0;
  });
  static_for<0, G>([&](auto GI) {
    constexpr int a = LO + EXP_IDX(GI) * S;
    constexpr int b = a + S < HI ? a + S : HI;
    double cur[S];
    static_for<0, S>([&](auto Q) {
      constexpr int i = a + S + EXP_IDX(Q);
      cur[EXP_IDX(Q)] = nxt[EXP_IDX(Q)];
      if constexpr (i < HI) nxt[EXP_IDX(Q)] = src[i * st];
    });
    if (j < K - 1) {
      static_for<0, b - a>([&](auto Q) {
        eb_link<K>(e, j, cur[EXP_IDX(Q)], em);
      });
    } else {
      static_for<0, b - a>([&](auto Q) { e = e + cur[EXP_IDX(Q)]; });
    }
  });
}

// The links of the terms src[(lo .. hi - 1) * st], a run-time range, in
// segments of 8 as eb_range_strided (the last one padded with links
// that do not run).
template <int K>
EXP_HD void eb_run(double& e, int& j, const double* src, int lo, int hi,
                   const Emit& em, int st = 1) {
  constexpr int S = 8;
  double nxt[S];
  static_for<0, S>([&](auto Q) {
    const int i = lo + EXP_IDX(Q);
    nxt[EXP_IDX(Q)] = src[(i < hi ? i : lo) * st];
  });
#pragma unroll 1
  for (int a = lo; a < hi; a += S) {
    double cur[S];
    static_for<0, S>([&](auto Q) {
      const int i = a + S + EXP_IDX(Q);
      cur[EXP_IDX(Q)] = nxt[EXP_IDX(Q)];
      nxt[EXP_IDX(Q)] = src[(i < hi ? i : lo) * st];
    });
    if (j < K - 1) {
      static_for<0, S>([&](auto Q) {
        if (a + EXP_IDX(Q) < hi) eb_link<K>(e, j, cur[EXP_IDX(Q)], em);
      });
    } else {
      static_for<0, S>([&](auto Q) {
        if (a + EXP_IDX(Q) < hi) e = e + cur[EXP_IDX(Q)];
      });
    }
  }
}

// The emitted words, then the last residual, then zeros.
template <int K>
EXP_HD void eb_finish(double e, int j, const Emit& em, double (&out)[K]) {
  static_for<0, K>([&](auto I) {
    constexpr int t = EXP_IDX(I);
    out[t] = t < j ? em.p[t * em.stride] : (t == j ? e : 0.0);
  });
}

// renorm(m, N, out) of expansion.cuh: VecSum in place, then
// VecSumErrBranch.
template <int K, int N>
EXP_HD void renorm(double (&m)[N], const Emit& em, double (&out)[K]) {
  static_assert(N >= 2, "renorm of one word");
  double s = m[N - 1];
  static_for_down<0, N - 1>([&](auto I) {
    constexpr int i = EXP_IDX(I);
    double t, e;
    two_sum(m[i], s, t, e);
    m[i + 1] = e;
    s = t;
  });
  m[0] = s;
  double e = s;
  int j = 0;
  eb_range<K, 1, N>(e, j, m, em);
  eb_finish<K>(e, j, em, out);
}

template <int K>
EXP_HD void add(const double (&a)[K], const double (&b)[K], const Emit& em,
                double (&out)[K]) {
  if constexpr (K == 1) {
    out[0] = a[0] + b[0];
  } else if constexpr (K == 2) {
    double s, e, t, te;
    two_sum(a[0], b[0], s, e);
    two_sum(a[1], b[1], t, te);
    e = e + t;
    fast_two_sum(s, e, s, e);
    e = e + te;
    fast_two_sum(s, e, s, e);
    out[0] = s;
    out[1] = e;
  } else {
    constexpr int N = merge_words<K>();
    double m[N];
    static_for<0, N>([&](auto I) { m[EXP_IDX(I)] = 0.0; });
    static_for<0, K>([&](auto I) {
      m[EXP_IDX(I)] = a[EXP_IDX(I)];
      m[N - 1 - EXP_IDX(I)] = b[EXP_IDX(I)];
    });
    // the bitonic merge network: stage q has distance d = N / 2^(q+1);
    // the pair (x, x + d) swaps unless |m_x| >= |m_{x+d}|
    constexpr int kStages = N == 4 ? 2 : N == 8 ? 3 : N == 16 ? 4
                            : N == 32 ? 5 : 6;
    static_assert(N == (1 << kStages), "merge_words is a power of two");
    static_for<0, kStages>([&](auto Q) {
      constexpr int d = N >> (EXP_IDX(Q) + 1);
      static_for<0, N / 2>([&](auto P) {
        constexpr int p = EXP_IDX(P);
        constexpr int x = (p / d) * 2 * d + p % d;
        const double u = m[x], v = m[x + d];
        const bool sw = !(fabs(u) >= fabs(v));
        m[x] = sw ? v : u;
        m[x + d] = sw ? u : v;
      });
    });
    renorm<K, N>(m, em, out);
  }
}

template <int K>
EXP_HD void add_f64(const double (&a)[K], double x, const Emit& em,
                    double (&out)[K]) {
  if constexpr (K == 1) {
    out[0] = a[0] + x;
  } else {
    double m[K + 1];
    bool sorted = true;
    static_for<1, K>([&](auto I) {
      sorted = sorted && !key_less(a[EXP_IDX(I)], a[EXP_IDX(I) - 1]);
    });
    if (sorted) {
      // x goes after every word whose key is not above its own
      int pos = 0;
      static_for<0, K>([&](auto I) {
        pos += key_less(x, a[EXP_IDX(I)]) ? 0 : 1;
      });
      static_for<0, K + 1>([&](auto I) {
        constexpr int t = EXP_IDX(I);
        const double below = t < K ? a[t < K ? t : 0] : 0.0;
        const double above = t > 0 ? a[t > 0 ? t - 1 : 0] : 0.0;
        m[t] = t < pos ? below : (t == pos ? x : above);
      });
    } else {
      static_for<0, K>([&](auto I) { m[EXP_IDX(I)] = a[EXP_IDX(I)]; });
      m[K] = x;
      // odd-even transposition: K + 1 rounds of adjacent swaps, each only
      // where the right word's key is strictly below the left's
      static_for<0, K + 1>([&](auto R) {
        static_for<0, (K + 1) / 2>([&](auto P) {
          constexpr int x0 = 2 * EXP_IDX(P) + (EXP_IDX(R) & 1);
          if constexpr (x0 + 1 <= K) {
            const double u = m[x0], v = m[x0 + 1];
            const bool sw = key_less(v, u);
            m[x0] = sw ? v : u;
            m[x0 + 1] = sw ? u : v;
          }
        });
      });
    }
    renorm<K, K + 1>(m, em, out);
  }
}

// mul's partial products in expansion.cuh's order: level l = 0 .. K, the
// values a_i b_{l-i} (ascending i), then the errors of the two_prods of
// level l - 1 (ascending i).  Term idx is ((i * 32 + j) * 2 + err).
template <int K>
EXP_HD constexpr int mul_code(int idx) {
  int n = 0;
  for (int l = 0; l <= K; ++l) {
    for (int i = 0; i < K; ++i) {
      const int j = l - i;
      if (j < 0 || j >= K) continue;
      if (n++ == idx) return (i * 32 + j) * 2;
    }
    if (l >= 1)
      for (int i = 0; i < K; ++i) {
        const int j = l - 1 - i;
        if (j < 0 || j >= K) continue;
        if (n++ == idx) return (i * 32 + j) * 2 + 1;
      }
  }
  return -1;
}

// Term IDX: the rounded product a_i b_j, or the error of its two_prod.
template <int K, int IDX>
EXP_HD double mul_term(const double (&a)[K], const double (&b)[K]) {
  constexpr int c = mul_code<K>(IDX);
  static_assert(c >= 0, "mul term index");
  constexpr int i = c / 64, j = (c / 2) % 32;
  if constexpr (c & 1) {
    double p, e;
    two_prod(a[i], b[j], p, e);
    return e;
  } else {
    return a[i] * b[j];
  }
}

// mul for small K, unrolled: VecSum forms the partial products in its
// bottom-up order and keeps its errors in registers (K < kMulSmem) or in
// the thread's scratch, where VecSumErrBranch reads them a segment
// ahead.
template <int K>
EXP_HD void mul_unrolled(const double (&a)[K], const double (&b)[K],
                         const Emit& em, double (&out)[K]) {
  if constexpr (K == 1) {
    out[0] = a[0] * b[0];
  } else if constexpr (K == 2) {
    double p, e;
    two_prod(a[0], b[0], p, e);
    e = e + (a[0] * b[1] + a[1] * b[0]);
    fast_two_sum(p, e, p, e);
    out[0] = p;
    out[1] = e;
  } else {
    constexpr int N = mul_terms<K>();
    // VecSum from the last term down; the terms of the next 8 links are
    // formed before the current 8 links run, so that the chain does not
    // wait on a two_prod
    constexpr int B = 8;
    constexpr int G = (N - 1 + B - 1) / B;
    double* serr = em.p + K * em.stride;  // K >= kMulSmem: the scratch
    double rerr[K < kMulSmem ? N - 1 : 1];
    double s = mul_term<K, N - 1>(a, b);
    double nxt[B];
    static_for<0, B>([&](auto Q) {
      constexpr int idx = N - 2 - EXP_IDX(Q);
      if constexpr (idx >= 0) nxt[EXP_IDX(Q)] = mul_term<K, idx>(a, b);
    });
    static_for<0, G>([&](auto GI) {
      constexpr int hi = N - 2 - EXP_IDX(GI) * B;
      double cur[B];
      static_for<0, B>([&](auto Q) {
        constexpr int idx = hi - B - EXP_IDX(Q);
        cur[EXP_IDX(Q)] = nxt[EXP_IDX(Q)];
        if constexpr (idx >= 0) nxt[EXP_IDX(Q)] = mul_term<K, idx>(a, b);
      });
      static_for<0, B>([&](auto Q) {
        constexpr int idx = hi - EXP_IDX(Q);
        if constexpr (idx >= 0) {
          double u, er;
          two_sum(cur[EXP_IDX(Q)], s, u, er);
          if constexpr (K < kMulSmem) {
            rerr[idx] = er;
          } else {
            serr[idx * em.stride] = er;
          }
          s = u;
        }
      });
    });
    double e = s;
    int j = 0;
    if constexpr (K < kMulSmem) {
      eb_range<K, 0, N - 1>(e, j, rerr, em);
    } else {
      eb_range_strided<K, 0, N - 1>(e, j, serr, em.stride, em);
    }
    eb_finish<K>(e, j, em, out);
  }
}

// Level l of mul's partial products: the values a_i b_{l-i}, i = vi0 ..
// vi0 + nv - 1, then the errors of the two_prods a_i b_{l-1-i}, i = ei0
// .. ei0 + ne - 1.
EXP_HD void mul_level(int K, int l, int& vi0, int& nv, int& ei0, int& ne) {
  vi0 = l - (K - 1) > 0 ? l - (K - 1) : 0;
  nv = (l < K - 1 ? l : K - 1) - vi0 + 1;
  ei0 = l - K > 0 ? l - K : 0;
  ne = l >= 1 ? (l - 1 < K - 1 ? l - 1 : K - 1) - ei0 + 1 : 0;
}

// f(pos, term) for the terms of level l from the last down to ``stop``
// (strided operands): the errors, then the values, each in a loop of its
// own without a branch, so that the loads and two_prods of a few terms
// can run ahead of the chain that takes them.
template <class F>
EXP_HD void mul_level_down(const double* a, const double* b, int st, int l,
                           int vi0, int nv, int ei0, int ne, int top,
                           F&& f) {
  // the errors: pos = nv .. nv + ne - 1, i = ei0 + pos - nv
#pragma unroll 4
  for (int pos = top - 1; pos >= nv; --pos) {
    const int i = ei0 + pos - nv;
    double p, e;
    two_prod(a[i * st], b[(l - 1 - i) * st], p, e);
    f(pos, e);
  }
#pragma unroll 4
  for (int pos = (top < nv ? top : nv) - 1; pos >= 0; --pos) {
    const int i = vi0 + pos;
    f(pos, a[i * st] * b[(l - i) * st]);
  }
}

// mul for larger K, in loops over the levels of the partial products,
// its operands and VecSum's words in the thread's scratch (Emit): a
// first pass runs VecSum's chain bottom-up and keeps its partial sum at
// each level's upper boundary; then, level by level top-down, the
// level's links are formed again from that boundary (their errors into
// the scratch) and VecSumErrBranch takes them in order.  The same
// float64 operations on the same words as mul_unrolled (and
// expansion.cuh mul), so the same bits, with a code size and a register
// count that do not grow with K.
template <int K>
EXP_HD void mul_stream(const double (&x)[K], const double (&y)[K],
                       const Emit& em, double (&out)[K]) {
  const int st = em.stride;
  double* a = em.p + K * st;
  double* b = a + K * st;
  double* cp = b + K * st;         // K + 1 words
  double* le = cp + (K + 1) * st;  // 2K words
  store_strided<K>(x, a, st);
  store_strided<K>(y, b, st);
  int vi0, nv, ei0, ne;
  // VecSum's chain, from the last term (level K's last error) down
  mul_level(K, K, vi0, nv, ei0, ne);
  double s, last;
  {
    const int i = ei0 + ne - 1;
    double p;
    two_prod(a[i * st], b[(K - 1 - i) * st], p, last);
  }
  s = last;
  mul_level_down(a, b, st, K, vi0, nv, ei0, ne, nv + ne - 1,
                 [&](int, double t) { s = t + s; });
#pragma unroll 1
  for (int l = K - 1; l >= 0; --l) {
    mul_level(K, l, vi0, nv, ei0, ne);
    cp[l * st] = s;
    mul_level_down(a, b, st, l, vi0, nv, ei0, ne, nv + ne,
                   [&](int, double t) { s = t + s; });
  }
  // VecSumErrBranch, a level at a time
  double e = s;
  int j = 0;
#pragma unroll 1
  for (int l = 0; l <= K; ++l) {
    mul_level(K, l, vi0, nv, ei0, ne);
    const int top = l < K ? nv + ne : nv + ne - 1;
    double s2 = l < K ? cp[l * st] : last;
    mul_level_down(a, b, st, l, vi0, nv, ei0, ne, top,
                   [&](int pos, double t) {
                     double u, er;
                     two_sum(t, s2, u, er);
                     le[pos * st] = er;
                     s2 = u;
                   });
    eb_run<K>(e, j, le, 0, top, em, st);
  }
  eb_finish<K>(e, j, em, out);
}

template <int K>
EXP_HD void mul(const double (&a)[K], const double (&b)[K], const Emit& em,
                double (&out)[K]) {
  if constexpr (K < kMulStream) {
    mul_unrolled<K>(a, b, em, out);
  } else {
    mul_stream<K>(a, b, em, out);
  }
}

// mul_f64 of a and the float64 word x (expansion.cuh mul_f64): the
// 2K - 1 words [p_0, p_1, e_0, ..., p_{K-1}, e_{K-2}] in registers,
// then renorm.  Scratch: the K emitted words.
template <int K>
EXP_HD void mul_f64(const double (&a)[K], double x, const Emit& em,
                    double (&out)[K]) {
  if constexpr (K == 1) {
    out[0] = a[0] * x;
  } else {
    double w[2 * K - 1];
    double e_prev;
    two_prod(a[0], x, w[0], e_prev);
    static_for<1, K>([&](auto I) {
      constexpr int i = EXP_IDX(I);
      double p, e;
      two_prod(a[i], x, p, e);
      w[2 * i - 1] = p;
      w[2 * i] = e_prev;
      e_prev = e;
    });
    renorm<K, 2 * K - 1>(w, em, out);
  }
}

// Words a div keeps in the thread's scratch (Emit): the K emitted words,
// then the K + 1 quotient words.
template <int K>
EXP_HD constexpr int div_words() {
  return 2 * K + 1;
}

// div of a by the K words b (expansion.cuh div), b at b[t * sb] (shared
// memory: read again each step, so that its words take no registers
// across the loop): K + 1 steps of r <- add(r, -mul_f64(b, r_0 / b_0)),
// the quotient words in the scratch after the emitted words, then their
// renormalization.
template <int K>
EXP_HD void div(const double (&a)[K], const double* b, int sb,
                const Emit& em, double (&out)[K]) {
  if constexpr (K == 1) {
    out[0] = a[0] / b[0];
  } else {
    double* q = em.p + K * em.stride;
    double r[K];
    static_for<0, K>([&](auto I) { r[EXP_IDX(I)] = a[EXP_IDX(I)]; });
#pragma unroll 1
    for (int s = 0; s <= K; ++s) {
      double y[K], t[K], nr[K];
      load_strided<K>(b, sb, y);
      const double qi = r[0] / y[0];
      mul_f64<K>(y, qi, em, t);
      static_for<0, K>([&](auto I) { t[EXP_IDX(I)] = -t[EXP_IDX(I)]; });
      add<K>(r, t, em, nr);
      static_for<0, K>([&](auto I) { r[EXP_IDX(I)] = nr[EXP_IDX(I)]; });
      q[s * em.stride] = qi;
    }
    double m[K + 1];
    static_for<0, K + 1>([&](auto I) {
      m[EXP_IDX(I)] = q[EXP_IDX(I) * em.stride];
    });
    renorm<K, K + 1>(m, em, out);
  }
}

}  // namespace regs
}  // namespace expn
