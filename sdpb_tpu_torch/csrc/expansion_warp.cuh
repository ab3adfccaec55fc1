// Float64 word expansions, one value per warp: the operations of a
// Cholesky step's pivot chain (csrc/expansion_panels.cuh pivot_program).
//
// The same algorithms as csrc/expansion.cuh (add, add_f64, mul),
// float64 operation for float64 operation in the same order, so the
// results agree bit for bit.  A renormalization is two chains of
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

// A warp's scratch in shared memory, in doubles: the words being
// renormalized, VecSum's partial sums and its errors (mul_terms words
// each, the most of mul, add and add_f64), mul's term codes (mul_terms
// ints), the emitted words (K), the two operands (K each).
template <int K>
EXP_HD constexpr int scratch_words() {
  return 3 * mul_terms<K>() + mul_terms<K>() / 2 + 1 + 3 * K;
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
        psum(w + mul_terms<K>()),
        err(w + 2 * mul_terms<K>()),
        code(reinterpret_cast<int*>(w + 3 * mul_terms<K>())),
        emit(w + 3 * mul_terms<K>() + mul_terms<K>() / 2 + 1),
        x(emit + K),
        y(x + K) {}
};

// mul's term codes ((i * 32 + j) * 2 + err, regs::mul_code's order) in
// ws.code: lane l writes level l's.  Once per kernel.
template <int K>
EXP_BLOCK void init_codes(const Scratch<K>& ws, int lane) {
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

// mul of the operands ws.x, ws.y.
template <int K>
EXP_BLOCK Res mul(const Scratch<K>& ws, int lane) {
  constexpr int N = mul_terms<K>();
  for (int k = lane; k < N; k += 32) {
    const int c = ws.code[k];
    double p, e;
    two_prod(ws.x[c >> 6], ws.y[(c >> 1) & 31], p, e);
    ws.t[k] = (c & 1) ? e : p;
  }
  return renorm<K, N>(ws, lane);
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
    if (lane < N / 2) {
      const int x = (lane / d) * 2 * d + lane % d;
      const double u = m[x], v = m[x + d];
      const bool sw = !(fabs(u) >= fabs(v));
      m[x] = sw ? v : u;
      m[x + d] = sw ? u : v;
    }
  }
  return renorm<K, N>(ws, lane);
}

// add_f64 of the operand ws.x and the float64 word f: the K + 1 words in
// the stable order of expn::key_less (lane t ranks word t), then the
// renormalization.
template <int K>
EXP_BLOCK Res add_f64(const Scratch<K>& ws, double f, int lane) {
  if (lane <= K) {
    const double v = lane < K ? ws.x[lane] : f;
    int rank = 0;
    for (int u = 0; u <= K; ++u) {
      const double w = u < K ? ws.x[u] : f;
      rank += key_less(w, v) || (u < lane && !key_less(v, w)) ? 1 : 0;
    }
    ws.t[rank] = v;
  }
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
