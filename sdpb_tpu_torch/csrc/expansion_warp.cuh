// Float64 word expansions, one value per warp: the operations of a
// Cholesky step's pivot chain (csrc/expansion_panels.cuh pivot_program),
// of the elementwise kernel's value-a-warp design
// (csrc/expansion_elementwise.cuh) and of every kernel above K = 20, up
// to the CRT prime pool's K = 54.
//
// The same algorithms as csrc/expansion.cuh (add, add_f64, mul,
// mul_f64, div), float64 operation for float64 operation in the same
// order, so the results agree bit for bit.  A renormalization is two chains of
// dependent additions whose order is fixed (VecSum, bottom-up, and
// VecSumErrBranch, top-down); everything else spreads over the lanes:
//
// - mul's partial products: lane L forms the terms L, L + 32, ...
//   (a two_prod gives the same words wherever it runs);
// - add's bitonic merge: one compare-exchange a lane a stage;
// - add_f64's stable insertion sort: each lane ranks one word by counting
//   the words that sort before it (ties by position, NaN last, as
//   expn::key_less), which is the stable sort's order;
// - VecSum's errors: the chain keeps only its partial sums, and the lanes
//   form the errors from them afterwards, each two_sum as the chain
//   would have formed it.
//
// The chains run on every lane at once with the same words (one warp
// instruction a link), each link's word a broadcast read of the warp's
// scratch issued a chunk of 8 links ahead, so that it does not wait for
// the chain.  VecSumErrBranch runs in segments of 8 links behind a
// branch that is the same on every lane: once K - 1 words are out, a
// segment is 8 dependent additions.  A
// thread alone pays every term's two_prod and every link's error in its
// own instruction stream; the warp pays one chain, which is what bounds
// the pivot.
//
// Every lane ends with the same result: the emitted words in the warp's
// scratch, the last residual and its position in registers (Res).

#pragma once

#include "expansion_regs.cuh"

#ifndef EXP_BLOCK
#define EXP_BLOCK __device__ __forceinline__
#endif
#ifndef EXP_SYNC_WARP
#define EXP_SYNC_WARP() __syncwarp()
#endif

namespace expn {
namespace warp {

// Up to this K a warp's mul reads its partial products from a table of
// term codes and keeps them all, with VecSum's partial sums and errors
// (3 mul_terms words: 12.5 KB at K = 20).  Above it (K = 21 .. 54, the
// CRT prime pool's limit) mul streams the products a level at a time
// (mul_levels): it keeps only VecSum's partial sums (mul_terms words),
// forms each level's terms from its index, and needs no code table; the
// term code's 5-bit fields, (i * 32 + j) * 2 + err, would not hold
// i, j >= 32 anyway.
constexpr int kCodeWords = 20;

// A warp's scratch in shared memory, in doubles: the words being
// renormalized (t), VecSum's partial sums (psum) and its errors (err),
// mul's term codes (K <= kCodeWords: mul_terms ints), the emitted words
// (K), the two operands (K each).  K <= kCodeWords: t, psum and err
// hold mul_terms words each, the most of mul, add and add_f64; above,
// t and err hold merge_words (add's merge, a level of mul's terms: at
// most 2K - 1) and psum mul_terms.
template <int K>
struct Layout {
  static constexpr bool kCodes = K <= kCodeWords;
  static constexpr int kT = kCodes ? mul_terms<K>() : merge_words<K>();
  static constexpr int kPsum = mul_terms<K>();
  static constexpr int kCode = kCodes ? mul_terms<K>() / 2 + 1 : 0;
  static constexpr int kWords = 2 * kT + kPsum + kCode + 3 * K;
};

template <int K>
EXP_HD constexpr int scratch_words() {
  return Layout<K>::kWords;
}

template <int K>
struct Scratch {
  double* t;
  double* psum;
  double* err;
  int* code;
  double* emit;
  double* x;
  double* y;
  EXP_HD explicit Scratch(double* w)
      : t(w),
        psum(w + Layout<K>::kT),
        err(w + Layout<K>::kT + Layout<K>::kPsum),
        code(reinterpret_cast<int*>(w + 2 * Layout<K>::kT +
                                    Layout<K>::kPsum)),
        emit(w + 2 * Layout<K>::kT + Layout<K>::kPsum + Layout<K>::kCode),
        x(emit + K),
        y(x + K) {}
};

// mul's term codes ((i * 32 + j) * 2 + err, regs::mul_code's order) in
// ws.code: lane l writes level l's.  Once per kernel; nothing above
// kCodeWords.
template <int K>
EXP_BLOCK void init_codes(const Scratch<K>& ws, int lane) {
  if constexpr (Layout<K>::kCodes) {
    int idx = 0, vi0, nv, ei0, ne;
    for (int l = 0; l <= K; ++l) {
      regs::mul_level(K, l, vi0, nv, ei0, ne);
      if (l == lane)
        for (int pos = 0; pos < nv + ne; ++pos) {
          const int i = pos < nv ? vi0 + pos : ei0 + pos - nv;
          const int j = pos < nv ? l - i : l - 1 - i;
          ws.code[idx + pos] = (i * 32 + j) * 2 + (pos < nv ? 0 : 1);
        }
      idx += nv + ne;
    }
    EXP_SYNC_WARP();
  }
}

// The result: emit[0 .. j) then e, then zeros.
struct Res {
  double e;
  int j;
};

// Up to this many words a renormalization is unrolled whole (K <= 8's
// mul); above, its chains run in loops of 8 links, which keeps the
// compiler from reading every word into registers at once.
constexpr int kUnrollWords = 96;

// VecSum and VecSumErrBranch of the N words ws.t[0 .. N), written by the
// lanes.  VecSum's chain reads its words 8 at a time, each 8 read before
// the previous 8 links run (every lane the same address: a broadcast),
// and lane 0 keeps the partial sums; the lanes then form the links'
// errors, which VecSumErrBranch reads the same way.
template <int K, int N>
EXP_BLOCK Res renorm(const Scratch<K>& ws, int lane) {
  constexpr int B = 8;
  constexpr bool kLoop = N > kUnrollWords;
  constexpr int NC = kLoop ? (N - 1) / B : 0;  // chunks run in the loops
  constexpr int REST = (N - 1) - NC * B;       // links unrolled after them
  EXP_SYNC_WARP();
  const double* t = ws.t;
  double* ps = ws.psum;
  double s = t[N - 1];
  // VecSum: chunk c takes the links k = N - 2 - 8c down to N - 9 - 8c
  double nxt[B];
  regs::static_for<0, B>([&](auto Q) {
    constexpr int k = N - 2 - EXP_IDX(Q);
    nxt[EXP_IDX(Q)] = t[k >= 0 ? k : 0];
  });
#pragma unroll 1
  for (int c = 0; c < NC; ++c) {
    const int top = N - 2 - c * B;
    double cur[B];
    regs::static_for<0, B>([&](auto Q) {
      const int k = top - B - EXP_IDX(Q);
      cur[EXP_IDX(Q)] = nxt[EXP_IDX(Q)];
      nxt[EXP_IDX(Q)] = t[k >= 0 ? k : 0];
    });
    regs::static_for<0, B>([&](auto Q) {
      if (lane == 0) ps[top - EXP_IDX(Q) + 1] = s;
      s = cur[EXP_IDX(Q)] + s;
    });
  }
  // the rest, links k = REST - 1 down to 0, unrolled: chunks of 8 whose
  // words are read before the previous chunk's links run
  regs::static_for<0, (REST + B - 1) / B>([&](auto GI) {
    constexpr int hi = REST - 1 - EXP_IDX(GI) * B;
    double cur[B];
    regs::static_for<0, B>([&](auto Q) {
      constexpr int k = hi - B - EXP_IDX(Q);
      cur[EXP_IDX(Q)] = nxt[EXP_IDX(Q)];
      if constexpr (k >= 0) nxt[EXP_IDX(Q)] = t[k];
    });
    regs::static_for<0, B>([&](auto Q) {
      constexpr int k = hi - EXP_IDX(Q);
      if constexpr (k >= 0) {
        if (lane == 0) ps[k + 1] = s;
        s = cur[EXP_IDX(Q)] + s;
      }
    });
  });
  EXP_SYNC_WARP();
  for (int k = lane; k < N - 1; k += 32) {
    double u, er;
    two_sum(t[k], ps[k + 1], u, er);
    ws.err[k + 1] = er;
  }
  EXP_SYNC_WARP();
  // VecSumErrBranch over err_1 .. err_{N-1}: segment g takes 1 + 8g ..
  const double* er = ws.err;
  const regs::Emit em{ws.emit, 1};
  double e = s;
  int j = 0;
  regs::static_for<0, B>([&](auto Q) {
    constexpr int i = 1 + EXP_IDX(Q);
    nxt[EXP_IDX(Q)] = er[i < N ? i : 1];
  });
#pragma unroll 1
  for (int g = 0; g < NC; ++g) {
    const int a = 1 + g * B;
    double cur[B];
    regs::static_for<0, B>([&](auto Q) {
      const int i = a + B + EXP_IDX(Q);
      cur[EXP_IDX(Q)] = nxt[EXP_IDX(Q)];
      nxt[EXP_IDX(Q)] = er[i < N ? i : 1];
    });
    if (j < K - 1) {
      regs::static_for<0, B>([&](auto Q) {
        regs::eb_link<K>(e, j, cur[EXP_IDX(Q)], em);
      });
    } else {
      regs::static_for<0, B>([&](auto Q) { e = e + cur[EXP_IDX(Q)]; });
    }
  }
  regs::eb_range_strided<K, 1 + NC * B, N>(e, j, er, 1, em);
  return {e, j};
}

// Term ``pos`` of level l of mul's partial products (regs::mul_level's
// order): the rounded product a_i b_j or the error of its two_prod (a
// two_prod gives the same words wherever it runs).
template <int K>
EXP_BLOCK double level_term(const Scratch<K>& ws, int l, int pos) {
  int vi0, nv, ei0, ne;
  regs::mul_level(K, l, vi0, nv, ei0, ne);
  const bool err = pos >= nv;
  const int i = err ? ei0 + pos - nv : vi0 + pos;
  const int j = (err ? l - 1 : l) - i;
  double p, e;
  two_prod(ws.x[i], ws.y[j], p, e);
  return err ? e : p;
}

// mul above kCodeWords: the same float64 operations as renorm<K,
// mul_terms> on the terms in mul_code's order (level l holds 2l + 1 terms
// from index l^2, level K the last 2K - 1), a level at a time.  VecSum's
// chain runs from the last term down, each level's terms formed by the
// lanes just before the chain reads them (8 links ahead, as renorm), and
// lane 0 keeps the partial sums; then, a level at a time from the first,
// the lanes form the level's terms again and its links' errors from those
// partial sums, and VecSumErrBranch takes them.  Scratch: the partial
// sums (mul_terms words) and two level buffers of at most 2K - 1 words.
template <int K>
EXP_BLOCK Res mul_levels(const Scratch<K>& ws, int lane) {
  constexpr int B = 8;
  double s = 0.0;
#pragma unroll 1
  for (int l = K; l >= 0; --l) {
    const int sz = l < K ? 2 * l + 1 : 2 * K - 1;
    double* ps = ws.psum + l * l;  // ps[p + 1]: the sum before link p
    EXP_SYNC_WARP();
    for (int p = lane; p < sz; p += 32) ws.t[p] = level_term<K>(ws, l, p);
    EXP_SYNC_WARP();
    int hi = sz - 1;
    if (l == K) s = ws.t[hi--];  // the last term starts the chain
    double nxt[B];
    regs::static_for<0, B>([&](auto Q) {
      const int i = hi - EXP_IDX(Q);
      nxt[EXP_IDX(Q)] = ws.t[i >= 0 ? i : 0];
    });
#pragma unroll 1
    for (int a = hi; a >= 0; a -= B) {
      double cur[B];
      regs::static_for<0, B>([&](auto Q) {
        const int i = a - B - EXP_IDX(Q);
        cur[EXP_IDX(Q)] = nxt[EXP_IDX(Q)];
        nxt[EXP_IDX(Q)] = ws.t[i >= 0 ? i : 0];
      });
      regs::static_for<0, B>([&](auto Q) {
        if (a - EXP_IDX(Q) >= 0) {
          if (lane == 0) ps[a - EXP_IDX(Q) + 1] = s;
          s = cur[EXP_IDX(Q)] + s;
        }
      });
    }
  }
  const regs::Emit em{ws.emit, 1};
  double e = s;
  int j = 0;
#pragma unroll 1
  for (int l = 0; l <= K; ++l) {
    // the level's links (the last term of all has none)
    const int nl = l < K ? 2 * l + 1 : 2 * K - 2;
    const double* ps = ws.psum + l * l;
    EXP_SYNC_WARP();
    for (int p = lane; p < nl; p += 32) {
      double u, er;
      two_sum(level_term<K>(ws, l, p), ps[p + 1], u, er);
      ws.err[p] = er;
    }
    EXP_SYNC_WARP();
    regs::eb_run<K>(e, j, ws.err, 0, nl, em);
  }
  return {e, j};
}

// mul of the operands ws.x, ws.y.
template <int K>
EXP_BLOCK Res mul(const Scratch<K>& ws, int lane) {
  if constexpr (Layout<K>::kCodes) {
    constexpr int N = mul_terms<K>();
    for (int k = lane; k < N; k += 32) {
      const int c = ws.code[k];
      double p, e;
      two_prod(ws.x[c >> 6], ws.y[(c >> 1) & 31], p, e);
      ws.t[k] = (c & 1) ? e : p;
    }
    return renorm<K, N>(ws, lane);
  } else {
    return mul_levels<K>(ws, lane);
  }
}

// add of the operands ws.x, ws.y: [x | zeros | y reversed] through the
// bitonic merge network (a compare-exchange a lane a stage), then the
// renormalization.
template <int K>
EXP_BLOCK Res add(const Scratch<K>& ws, int lane) {
  constexpr int N = merge_words<K>();
  double* m = ws.t;
  for (int w = lane; w < N; w += 32)
    m[w] = w < K ? ws.x[w] : (w >= N - K ? ws.y[N - 1 - w] : 0.0);
  // the pair (x, x + d) swaps unless |m_x| >= |m_{x+d}|
#pragma unroll 1
  for (int d = N / 2; d >= 1; d /= 2) {
    EXP_SYNC_WARP();
    if constexpr (N / 2 <= 32) {
      if (lane < N / 2) {
        const int x = (lane / d) * 2 * d + lane % d;
        const double u = m[x], v = m[x + d];
        const bool sw = !(fabs(u) >= fabs(v));
        m[x] = sw ? v : u;
        m[x + d] = sw ? u : v;
      }
    } else {
      // K > 32: 64 pairs a stage, two a lane
      for (int p = lane; p < N / 2; p += 32) {
        const int x = (p / d) * 2 * d + p % d;
        const double u = m[x], v = m[x + d];
        const bool sw = !(fabs(u) >= fabs(v));
        m[x] = sw ? v : u;
        m[x + d] = sw ? u : v;
      }
    }
  }
  return renorm<K, N>(ws, lane);
}

// add_f64 of the operand ws.x and the float64 word f: the K + 1 words in
// the stable order of expn::key_less (lane t ranks word t), then the
// renormalization.
template <int K>
EXP_BLOCK Res add_f64(const Scratch<K>& ws, double f, int lane) {
  if constexpr (K < 32) {
    if (lane <= K) {
      const double v = lane < K ? ws.x[lane] : f;
      int rank = 0;
      for (int u = 0; u <= K; ++u) {
        const double w = u < K ? ws.x[u] : f;
        rank += key_less(w, v) || (u < lane && !key_less(v, w)) ? 1 : 0;
      }
      ws.t[rank] = v;
    }
  } else {
    // K >= 32: lane t ranks the words t, t + 32
    for (int t = lane; t <= K; t += 32) {
      const double v = t < K ? ws.x[t] : f;
      int rank = 0;
      for (int u = 0; u <= K; ++u) {
        const double w = u < K ? ws.x[u] : f;
        rank += key_less(w, v) || (u < t && !key_less(v, w)) ? 1 : 0;
      }
      ws.t[rank] = v;
    }
  }
  return renorm<K, K + 1>(ws, lane);
}

// mul_f64 of the K words a (in shared memory; may be ws.x) and the
// float64 word f: [p_0, p_1, e_0, p_2, e_1, ..., p_{K-1}, e_{K-2}]
// (expansion.cuh mul_f64; lane i forms the two_prod of word i), then the
// renormalization.
template <int K>
EXP_BLOCK Res mul_f64(const Scratch<K>& ws, const double* a, double f,
                      int lane) {
  for (int i = lane; i < K; i += 32) {
    double p, e;
    two_prod(a[i], f, p, e);
    ws.t[i == 0 ? 0 : 2 * i - 1] = p;
    if (i < K - 1) ws.t[2 * i + 2] = e;
  }
  return renorm<K, 2 * K - 1>(ws, lane);
}

// The words of a result r, from the scratch and r's registers.
template <int K>
EXP_BLOCK double res_word(const Scratch<K>& ws, const Res& r, int t) {
  return t < r.j ? ws.emit[t] : (t == r.j ? r.e : 0.0);
}

// div of the operand ws.x by the K words b (shared memory, not in ws):
// K + 1 quotient words, each r <- add(r, -mul_f64(b, r_0 / b_0)) with r
// in ws.x (expansion.cuh div), the words kept in q (K + 1 words of the
// caller's), then their renormalization.  ws.x is overwritten.
template <int K>
EXP_BLOCK Res div(const Scratch<K>& ws, const double* b, double* q,
                  int lane) {
#pragma unroll 1
  for (int s = 0; s <= K; ++s) {
    EXP_SYNC_WARP();
    const double qi = ws.x[0] / b[0];
    const Res t = mul_f64<K>(ws, b, qi, lane);
    EXP_SYNC_WARP();
    for (int w = lane; w < K; w += 32) ws.y[w] = -res_word<K>(ws, t, w);
    if (lane == 0) q[s] = qi;
    EXP_SYNC_WARP();
    const Res r = add<K>(ws, lane);
    EXP_SYNC_WARP();
    for (int w = lane; w < K; w += 32) ws.x[w] = res_word<K>(ws, r, w);
  }
  EXP_SYNC_WARP();
  for (int w = lane; w <= K; w += 32) ws.t[w] = q[w];
  return renorm<K, K + 1>(ws, lane);
}

// mul out of line: one copy with registers of its own, for a caller
// whose own registers are all but full (the substitution at K >= 17).
#ifndef EXP_OUT_OF_LINE
#define EXP_OUT_OF_LINE __device__ __noinline__
#endif
template <int K>
EXP_OUT_OF_LINE Res mul_out_of_line(const Scratch<K>& ws, int lane) {
  return mul<K>(ws, lane);
}

}  // namespace warp
}  // namespace expn
