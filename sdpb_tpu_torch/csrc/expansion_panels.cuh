// Float64 word expansions: the column loops of the expansion Cholesky
// and triangular substitution, one thread block at a time.  The bodies
// of csrc/expansion_chol.cu and csrc/expansion_solve.cu.
//
// chol_panel_block and solve_block are what ONE block of a kernel does,
// written against a thread index ``tid`` of ``nthreads``, the block
// barrier EXP_SYNC() (__syncthreads()), the update threads' barrier
// EXP_SYNC_UPDATE(n) (named barrier 1) and a warp shuffle EXP_SHFL.
// The per-value arithmetic is csrc/expansion_regs.cuh's (a value a
// thread) and csrc/expansion_warp.cuh's (a value a warp: the pivots), so
// every entry takes the float64 operations of the plain loops
// (ops/expansion_kernels.py cholesky_panel_plain, solve_unblocked_plain)
// in their order, and the results agree bit for bit.  Each thread has
// regs::thread_words<K>() words of ``sh`` for its operations' scratch
// (regs::Emit).
//
// What bounds these loops is the chain of dependent float64 operations,
// not the work beside it: a Cholesky step's pivot (sqrt_rsqrt, ~15
// products and ~10 additions in a row), a substitution row's product,
// tree and division.  The design puts one warp on the chain and keeps
// the rest of the block on the work beside it (see each function).
//
// tests/test_torch_expansion_panels.py compiles this header with g++
// (-ffp-contract=off) and runs each block with one host thread per CUDA
// thread, std::barrier for the barriers and an exchange through memory
// for the shuffle, against the plain loops.

#pragma once

#include <string.h>

#include "expansion_warp.cuh"

#ifndef EXP_BLOCK
#define EXP_BLOCK __device__ __forceinline__
#endif
#ifndef EXP_SYNC
#define EXP_SYNC() __syncthreads()
#endif
// The n update threads (all warps but the first) of a Cholesky block.
#ifndef EXP_SYNC_UPDATE
#define EXP_SYNC_UPDATE(n) asm volatile("bar.sync 1, %0;" ::"r"(n) : "memory")
#endif
#ifndef EXP_SHFL
#define EXP_SHFL(v, src) __shfl_sync(0xffffffffu, (v), (src))
#endif
#ifndef EXP_SYNC_WARP
#define EXP_SYNC_WARP() __syncwarp()
#endif

namespace expn {

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
EXP_HD bool is_pos_zero(const double (&v)[K]) {
  bool z = true;
  regs::static_for<0, K>([&](auto I) {
    z = z && word_bits(v[EXP_IDX(I)]) == 0;
  });
  return z;
}

template <int K>
EXP_HD bool same_bits(const double (&a)[K], const double (&b)[K]) {
  bool s = true;
  regs::static_for<0, K>([&](auto I) {
    s = s && word_bits(a[EXP_IDX(I)]) == word_bits(b[EXP_IDX(I)]);
  });
  return s;
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

// ---------------------------------------------------------------------------
// The pivot program: a Cholesky step's serial chain as a list of
// operations on K-word slots in shared memory, run by one loop with one
// copy of each operation's code (the chain is ~30 operations; written
// out, each a copy of mul or add, it would be ~30 copies).
// ---------------------------------------------------------------------------

// Slots: the next column's entries (t+1, t) and (t+1, t+1), the
// pivot a, y = 1/sqrt(a) (also the current 1/d), two temporaries, the
// first sqrt estimate and d = sqrt(a).
enum PivotSlot { kX1, kX2, kA, kY, kU, kV, kS0, kS, kPivotSlots };

// mp/core.py newton_steps: max(1, bit_length(53 K // 50)).
template <int K>
EXP_HD constexpr int newton_steps() {
  constexpr int v = K * 53 / 50;
  static_assert(v < 64, "newton_steps is written for K <= 60");
  return v >= 32 ? 6 : v >= 16 ? 5 : v >= 8 ? 4 : v >= 4 ? 3
         : v >= 2 ? 2 : 1;
}

// Operation kinds and the code of one operation: kind | x << 2 | y << 6
// | out << 10 | neg_y << 14 | half_out << 15 | neg_x << 16.
enum PivotOp { kMul, kAdd, kAddOne, kSeed };
EXP_HD constexpr int pivot_code(int kind, int x, int y, int out,
                                int neg_y = 0, int half = 0, int neg_x = 0) {
  return kind | x << 2 | y << 6 | out << 10 | neg_y << 14 | half << 15 |
         neg_x << 16;
}

// Operation q of a step's program.  0..2: the next pivot's last update,
// a = x2 - (x1 / d)^2 as the plain loop forms it (the multiplier
// x1 * (1/d), its square, the subtraction); 3: the seed y; then
// mp/core.py sqrt_rsqrt: newton_steps(K) Newton steps of five operations
// and the Heron correction, five more.
template <int K>
EXP_HD int pivot_op(int q) {
  if (q < 4) {
    switch (q) {
      case 0: return pivot_code(kMul, kX1, kY, kU);
      case 1: return pivot_code(kMul, kU, kU, kU);
      case 2: return pivot_code(kAdd, kX2, kU, kA, 1);
      default: return pivot_code(kSeed, kA, kA, kY);
    }
  }
  q -= 4;
  if (q < 5 * newton_steps<K>()) {
    switch (q % 5) {
      case 0: return pivot_code(kMul, kY, kY, kU);        // y^2
      case 1: return pivot_code(kMul, kA, kU, kV);        // a y^2
      case 2: return pivot_code(kAddOne, kV, kV, kU, 0, 0, 1);  // 1 - a y^2
      case 3: return pivot_code(kMul, kY, kU, kV, 0, 1);  // the correction
      default: return pivot_code(kAdd, kY, kV, kY);
    }
  }
  switch (q - 5 * newton_steps<K>()) {
    case 0: return pivot_code(kMul, kA, kY, kS0);         // s0 = a y
    case 1: return pivot_code(kMul, kS0, kS0, kU);
    case 2: return pivot_code(kAdd, kA, kU, kV, 1);       // a - s0^2
    case 3: return pivot_code(kMul, kV, kY, kU, 0, 1);
    default: return pivot_code(kAdd, kS0, kU, kS);
  }
}

template <int K>
EXP_HD constexpr int pivot_ops() {
  return 4 + 5 * newton_steps<K>() + 5;
}

// Operations q0 .. q1 - 1 of the program on ``slot`` (kPivotSlots x K
// words), by the whole warp: for K >= 3 each operation is a warp
// operation (csrc/expansion_warp.cuh) on the warp's scratch ``wsm``;
// K = 2 (whose add and mul are not renormalizations) runs the per-thread
// operations on every lane, K = 1 is sqrt and the seed.  Every lane
// writes the same words; a warp barrier between an operation's reads and
// its writes keeps a lane from overwriting a slot another lane has yet
// to read.
template <int K>
EXP_BLOCK void pivot_program(double* slot, int q0, int q1, double* wsm,
                             const regs::Emit& em, int lane) {
  if constexpr (K == 1) {
    double a = slot[kA];
    if (q0 == 0) {
      const double m = slot[kX1] * slot[kY];
      a = slot[kX2] + -(m * m);
    }
    EXP_SYNC_WARP();
    slot[kA] = a;
    slot[kS] = sqrt(a);
    slot[kY] = rsqrt_seed(a);
    EXP_SYNC_WARP();
  } else {
    const warp::Scratch<K> ws(wsm);
#pragma unroll 1
    for (int q = q0; q < q1; ++q) {
      const int c = pivot_op<K>(q);
      const double* xs = slot + ((c >> 2) & 15) * K;
      const double* ys = slot + ((c >> 6) & 15) * K;
      double* os = slot + ((c >> 10) & 15) * K;
      const bool neg_x = (c >> 16) & 1, neg_y = (c >> 14) & 1;
      const bool half = (c >> 15) & 1;
      if constexpr (K == 2) {
        double x[K], y[K], o[K];
        regs::static_for<0, K>([&](auto I) {
          constexpr int t = EXP_IDX(I);
          x[t] = neg_x ? -xs[t] : xs[t];
          y[t] = neg_y ? -ys[t] : ys[t];
        });
        switch (c & 3) {
          case kMul: regs::mul<K>(x, y, em, o); break;
          case kAdd: regs::add<K>(x, y, em, o); break;
          case kAddOne: regs::add_f64<K>(x, 1.0, em, o); break;
          default:
            o[0] = rsqrt_seed(x[0]);
            o[1] = 0.0;
        }
        EXP_SYNC_WARP();  // every lane has read the operands
        regs::static_for<0, K>([&](auto I) {
          constexpr int t = EXP_IDX(I);
          os[t] = half ? o[t] * 0.5 : o[t];
        });
      } else {
        if constexpr (K <= 32) {
          if (lane < K) {
            ws.x[lane] = neg_x ? -xs[lane] : xs[lane];
            ws.y[lane] = neg_y ? -ys[lane] : ys[lane];
          }
        } else {
          for (int t = lane; t < K; t += 32) {
            ws.x[t] = neg_x ? -xs[t] : xs[t];
            ws.y[t] = neg_y ? -ys[t] : ys[t];
          }
        }
        EXP_SYNC_WARP();
        warp::Res r;
        switch (c & 3) {
          case kMul: r = warp::mul<K>(ws, lane); break;
          case kAdd: r = warp::add<K>(ws, lane); break;
          case kAddOne: r = warp::add_f64<K>(ws, 1.0, lane); break;
          default: r = {rsqrt_seed(ws.x[0]), 0};
        }
        EXP_SYNC_WARP();  // the emitted words are out, the operands read
        if constexpr (K <= 32) {
          if (lane < K) {
            const double w =
                lane < r.j ? ws.emit[lane] : (lane == r.j ? r.e : 0.0);
            os[lane] = half ? w * 0.5 : w;
          }
        } else {
          // K > 32: two words a lane
          for (int t = lane; t < K; t += 32) {
            const double w = warp::res_word<K>(ws, r, t);
            os[t] = half ? w * 0.5 : w;
          }
        }
      }
      EXP_SYNC_WARP();
    }
  }
}

// Entry (r, c) of a block's rows: the pivot block's, then the tile's.
template <int K>
EXP_HD double* panel_entry(double* diag, double* tile, int W, int r, int c) {
  return r < W ? diag + ((long)r * W + c) * K
               : tile + ((long)(r - W) * W + c) * K;
}

// Shared memory of a Cholesky block, in doubles.
template <int K>
EXP_HD constexpr long chol_smem_words(int rows, int nthreads) {
  return (long)regs::thread_words<K>() * nthreads +
         (long)K * (rows + 4 + kPivotSlots) + warp::scratch_words<K>();
}

// One block's share of the column loop of a Cholesky panel: the
// matrix's rows R >= W of W columns, the first W rows the pivot block.
// The block holds the pivot block (``diag``, from ``in_diag``) and
// ``nt`` rows below it (``tile``, from ``in_tile``), each row W values
// of K words, W + nt <= nthreads - 32; a block that is not the first of
// its panel works on a private copy of the pivot block, which it
// computes again, so that blocks share nothing.  ``sh`` holds
// chol_smem_words(W + nt, nthreads) doubles.
//
// Per column t, in the plain loop's order: d, 1/d = sqrt_rsqrt of the
// pivot; the column below it times 1/d (the multipliers); every entry
// in a column c > t takes add(v, -mul(m_r, m_c)).  An entry of column t
// is final after the step's zero additions (W - t of them, the masked
// update's zeros of steps t..W-1).  The pivot block's upper triangle is
// +0, as the plain version writes it.
//
// The schedule (look-ahead).  The first warp computes the pivots; the
// other warps (the update threads, one row each) everything else.  In
// step t the pivot warp forms the next pivot from the two entries of
// row t+1 it needs, (t+1, t) and (t+1, t+1), as the plain loop would
// after step t (multiplier, its square, the subtraction, sqrt_rsqrt),
// while the update threads form step t's multipliers (behind their own
// barrier) and the rest of step t's update; entry (t+1, t+1)'s update is
// the pivot warp's alone.  One block barrier a step hands the pivot
// over, so a step takes max(pivot chain, update) instead of their sum.
// Each entry still takes its updates in the order of t.  An update
// thread keeps its row's final word of column t in registers and stores
// it in step t+1, after the pivot warp has read entry (t+1, t).
template <int K>
EXP_BLOCK void chol_panel_block(const double* in_diag, const double* in_tile,
                                double* diag, double* tile, int W, int nt,
                                double* sh, int tid, int nthreads) {
  const int rows = W + nt;
  const regs::Emit em{sh + tid, nthreads};
  double* mult = sh + (long)regs::thread_words<K>() * nthreads;
  double* piv = mult + (long)rows * K;  // [t & 1]: d, then 1/d
  double* slot = piv + 4 * K;
  double* wsm = slot + kPivotSlots * K;  // the pivot warp's scratch
  for (long w = tid; w < (long)rows * W; w += nthreads) {
    const int r = (int)(w / W), c = (int)(w % W);
    const double* src =
        r < W ? in_diag + w * K : in_tile + (w - (long)W * W) * K;
    double* dst = panel_entry<K>(diag, tile, W, r, c);
    for (int i = 0; i < K; ++i) dst[i] = src[i];
  }
  EXP_SYNC();
  if (tid < 32) {
    // the pivot warp
    if constexpr (K >= 3) warp::init_codes<K>(warp::Scratch<K>(wsm), tid);
    for (int i = 0; i < K; ++i) slot[kA * K + i] = diag[i];
    pivot_program<K>(slot, 3, pivot_ops<K>(), wsm, em, tid);
    for (int i = 0; i < K; ++i) {
      piv[i] = slot[kS * K + i];
      piv[K + i] = slot[kY * K + i];
    }
#pragma unroll 1
    for (int t = 0; t < W; ++t) {
      EXP_SYNC();
      if (t + 1 < W) {
        const double* x1 = diag + ((long)(t + 1) * W + t) * K;
        for (int i = 0; i < K; ++i) {
          slot[kX1 * K + i] = x1[i];
          slot[kX2 * K + i] = x1[K + i];
        }
        pivot_program<K>(slot, 0, pivot_ops<K>(), wsm, em, tid);
        double* nxt = piv + ((t + 1) & 1) * 2 * K;
        for (int i = 0; i < K; ++i) {
          nxt[i] = slot[kS * K + i];
          nxt[K + i] = slot[kY * K + i];
        }
      }
    }
    return;
  }
  // the update threads: row u
  const int u = tid - 32, nu = nthreads - 32;
  double fin[K];
#pragma unroll 1
  for (int t = 0; t < W; ++t) {
    EXP_SYNC();
    const double* d = piv + (t & 1) * 2 * K;
    if (u < rows) {
      if (t >= 1) regs::store<K>(fin, panel_entry<K>(diag, tile, W, u, t - 1));
      if (u < t) {
        regs::static_for<0, K>([&](auto I) { fin[EXP_IDX(I)] = 0.0; });
      } else {
        double v[K];
        if (u == t) {
          regs::load<K>(d, v);
        } else {
          double x[K], y[K];
          regs::load<K>(panel_entry<K>(diag, tile, W, u, t), x);
          regs::load<K>(d + K, y);
          regs::mul<K>(x, y, em, v);
        }
        regs::store<K>(v, mult + (long)u * K);
        // the W - t zero additions, until one leaves v unchanged
        double z[K];
        regs::static_for<0, K>([&](auto I) { z[EXP_IDX(I)] = 0.0; });
#pragma unroll 1
        for (int i = 0; i < W - t; ++i) {
          double o[K];
          regs::add<K>(v, z, em, o);
          if (same_bits<K>(o, v)) break;
          regs::static_for<0, K>([&](auto I) { v[EXP_IDX(I)] = o[EXP_IDX(I)]; });
        }
        regs::static_for<0, K>([&](auto I) { fin[EXP_IDX(I)] = v[EXP_IDX(I)]; });
      }
    }
    EXP_SYNC_UPDATE(nu);
    const int nc = W - 1 - t;
#pragma unroll 1
    for (long w = u; w < (long)rows * nc; w += nu) {
      const int r = (int)(w / nc), c = t + 1 + (int)(w % nc);
      if (r < c || (r == t + 1 && c == t + 1)) continue;
      double* e = panel_entry<K>(diag, tile, W, r, c);
      double acc[K], x[K], y[K], p[K], o[K];
      regs::load<K>(e, acc);
      regs::load<K>(mult + (long)r * K, x);
      regs::load<K>(mult + (long)c * K, y);
      regs::mul<K>(x, y, em, p);
      regs::static_for<0, K>([&](auto I) { p[EXP_IDX(I)] = -p[EXP_IDX(I)]; });
      regs::add<K>(acc, p, em, o);
      regs::store<K>(o, e);
    }
  }
  if (u < rows) regs::store<K>(fin, panel_entry<K>(diag, tile, W, u, W - 1));
}

// ---------------------------------------------------------------------------
// The substitution
// ---------------------------------------------------------------------------

// K words of v from lane ``src`` of the warp.
template <int K>
EXP_HD void shfl_words(const double (&v)[K], int src, double (&out)[K]) {
#ifdef EXP_SHFL_WORDS
  EXP_SHFL_WORDS(v, src, out);
#else
  regs::static_for<0, K>([&](auto I) {
    out[EXP_IDX(I)] = EXP_SHFL(v[EXP_IDX(I)], src);
  });
#endif
}

constexpr int kSolveInlineWords = 16;

// Shared memory of a substitution block, in doubles: each thread's
// scratch and the x of its two leaves, and each warp's scratch.
template <int K>
EXP_HD constexpr long solve_smem_words(int nthreads) {
  return (long)(regs::thread_words<K>() + 2 * K) * nthreads +
         (long)(nthreads / 32) * warp::scratch_words<K>();
}

// One block's share of the substitution X = L^-1 B (or L^-T B): batch
// element's L (n, n), B and X (n, m), inv_d (n) values of K words, n <=
// 2G <= 64.  A group of G lanes (G a power of two, 32 / G groups a warp)
// solves one right-hand-side column, ``col0`` + the block's group index;
// groups past m - 1 idle.
//
// Per row i, in the plain loop's order: the n terms mul(l_ik, x_k) (a
// term whose k is masked, k >= i forward or k <= i backward, is
// mul(+0, +0) = +0 and is not computed), their sum by mp/core.py sum_'s
// tree (level by level: a[p] + a[p + h] for p < h = len/2, an odd last
// term carried to index h), then x_i = mul(add(b_i, -sum), inv_d_i).  A
// pair of +0 values adds to +0 and is skipped.
//
// The layout.  Lane p of a group holds the tree's leaf p, and where
// n > G also leaf p + n/2 (the first level's partner, added in the
// lane) and, for odd n, lane n/2 the carried last leaf.  So a row is one
// product (two where n > G) on every lane at once, the tree's levels by
// shuffles within the group (no barrier), and x_i formed by every lane
// of the group at once; the lane that holds leaf i keeps x_i in its
// registers for the rows below.
template <int K>
EXP_BLOCK void solve_block(const double* L, const double* B,
                           const double* inv_d, double* X, int n, int m,
                           int col0, int G, bool transpose, double* sh,
                           int tid, int nthreads) {
  const regs::Emit em{sh + tid, nthreads};
  const int lane = tid & 31, p = lane & (G - 1), base = lane - p;
  const int col = col0 + (tid >> 5) * (32 / G) + lane / G;
  const bool active = col < m;
  const int q = active ? col : m - 1;
  const bool two = n > G;
  const int h1 = n / 2;
  int l0, l1;
  if (!two) {
    l0 = p < n ? p : -1;
    l1 = -1;
  } else {
    l0 = p < h1 ? p : (p == h1 && (n & 1) ? 2 * h1 : -1);
    l1 = p < h1 ? p + h1 : -1;
  }
  // the x of the lane's two leaves, in its scratch after the operations'
  double* xs = sh + (long)regs::thread_words<K>() * nthreads + tid;
  // a group of 32 lanes forms x_i's product as a warp operation (out of
  // line above K = kSolveInlineWords, where the per-thread add's 64 words
  // leave no registers for it)
  const warp::Scratch<K> ws(sh + (long)(regs::thread_words<K>() + 2 * K) *
                                     nthreads +
                            (long)(tid >> 5) * warp::scratch_words<K>());
  if constexpr (K >= 3)
    if (G == 32) warp::init_codes<K>(ws, lane);
  double x0[K], x1[K];
#pragma unroll 1
  for (int s = 0; s < n; ++s) {
    const int i = transpose ? n - 1 - s : s;
    double v[K];
    const bool live0 = l0 >= 0 && (transpose ? l0 > i : l0 < i);
    if (live0) {
      double lik[K];
      regs::load<K>(L + (long)(transpose ? l0 * n + i : i * n + l0) * K, lik);
      regs::load_strided<K>(xs, nthreads, x0);
      regs::mul<K>(lik, x0, em, v);
    } else {
      regs::static_for<0, K>([&](auto I) { v[EXP_IDX(I)] = 0.0; });
    }
    int len = n;
    if (two) {
      const bool live1 = l1 >= 0 && (transpose ? l1 > i : l1 < i);
      if (l1 >= 0 && (live0 || live1)) {
        double w[K], o[K];
        if (live1) {
          double lik[K];
          regs::load<K>(L + (long)(transpose ? l1 * n + i : i * n + l1) * K,
                        lik);
          regs::load_strided<K>(xs + (long)K * nthreads, nthreads, x1);
          regs::mul<K>(lik, x1, em, w);
        } else {
          regs::static_for<0, K>([&](auto I) { w[EXP_IDX(I)] = 0.0; });
        }
        regs::add<K>(v, w, em, o);
        regs::static_for<0, K>([&](auto I) { v[EXP_IDX(I)] = o[EXP_IDX(I)]; });
      }
      len = h1 + (n & 1);
    }
#pragma unroll 1
    while (len > 1) {
      const int h = len / 2, odd = len & 1;
      const int src = p < h ? p + h : (odd && p == h ? 2 * h : p);
      double w[K];
      shfl_words<K>(v, base + src, w);
      if (p < h) {
        if (!(is_pos_zero<K>(v) && is_pos_zero<K>(w))) {
          double o[K];
          regs::add<K>(v, w, em, o);
          regs::static_for<0, K>([&](auto I) { v[EXP_IDX(I)] = o[EXP_IDX(I)]; });
        }
      } else if (odd && p == h) {
        regs::static_for<0, K>([&](auto I) { v[EXP_IDX(I)] = w[EXP_IDX(I)]; });
      }
      len = h + odd;
    }
    double sum[K], bi[K], r[K], di[K], xi[K];
    shfl_words<K>(v, base, sum);
    regs::load<K>(B + ((long)i * m + q) * K, bi);
    regs::static_for<0, K>([&](auto I) { sum[EXP_IDX(I)] = -sum[EXP_IDX(I)]; });
    regs::add<K>(bi, sum, em, r);
    regs::load<K>(inv_d + (long)i * K, di);
    bool done = false;
    if constexpr (K >= 3) {
      if (G == 32) {
        regs::store<K>(r, ws.x);
        regs::store<K>(di, ws.y);
        EXP_SYNC_WARP();
        warp::Res res;
        if constexpr (K <= kSolveInlineWords) {
          res = warp::mul<K>(ws, lane);
        } else {
          res = warp::mul_out_of_line<K>(ws, lane);
        }
        EXP_SYNC_WARP();
        regs::static_for<0, K>([&](auto I) {
          constexpr int t = EXP_IDX(I);
          xi[t] = t < res.j ? ws.emit[t] : (t == res.j ? res.e : 0.0);
        });
        EXP_SYNC_WARP();
        done = true;
      }
    }
    if (!done) regs::mul<K>(r, di, em, xi);
    if (l0 == i) regs::store_strided<K>(xi, xs, nthreads);
    if (l1 == i) regs::store_strided<K>(xi, xs + (long)K * nthreads, nthreads);
    if (active && p == 0) regs::store<K>(xi, X + ((long)i * m + q) * K);
  }
}

// ---------------------------------------------------------------------------
// Above K = kThreadMaxWords: every operation a value a warp
// ---------------------------------------------------------------------------

// A thread's operands alone at K = 54 are 216 registers, so above
// K = 20 the column loops run every operation on a warp
// (expansion_warp.cuh), one after another; these paths are held to the
// plain loops' bits, not tuned.

// Warp operation on the operands ws.x, ws.y (already written and
// synchronized): its result's words to ``dst`` (K words; may be an
// operand's source), negated where ``neg``.
template <int K, class Op>
EXP_BLOCK void warp_op_to(const warp::Scratch<K>& ws, Op op, double* dst,
                          bool neg, int lane) {
  const warp::Res r = op();
  EXP_SYNC_WARP();
  for (int t = lane; t < K; t += 32) {
    const double w = warp::res_word<K>(ws, r, t);
    dst[t] = neg ? -w : w;
  }
  EXP_SYNC_WARP();
}

// ws.x <- x, ws.y <- y (y == nullptr: +0 words), then a barrier.
template <int K>
EXP_BLOCK void warp_operands(const warp::Scratch<K>& ws, const double* x,
                             const double* y, bool neg_y, int lane) {
  for (int t = lane; t < K; t += 32) {
    ws.x[t] = x[t];
    ws.y[t] = y == nullptr ? 0.0 : (neg_y ? -y[t] : y[t]);
  }
  EXP_SYNC_WARP();
}

// Shared memory of a Cholesky block above kThreadMaxWords, in doubles:
// each warp's scratch, then the rows' multipliers and final words of the
// step's column, the pivots and the pivot warp's slots.
template <int K>
EXP_HD constexpr long chol_warps_smem_words(int rows, int nthreads) {
  return (long)(nthreads / 32) * warp::scratch_words<K>() +
         (long)K * (2 * rows + 4 + kPivotSlots);
}

// chol_panel_block above kThreadMaxWords: the same schedule (the pivot
// warp a step ahead, one block barrier a step, the update warps' own
// barrier between the multipliers and the update), with the update
// threads' work on the update warps: warp w takes rows w, w + nw, ...
// (each row's multiplier, its zero additions and its final word, kept in
// shared memory and stored a step late) and every nw-th entry of the
// update, each entry's product and addition a warp operation.
template <int K>
EXP_BLOCK void chol_panel_block_warps(const double* in_diag,
                                      const double* in_tile, double* diag,
                                      double* tile, int W, int nt, double* sh,
                                      int tid, int nthreads) {
  const int rows = W + nt, lane = tid & 31;
  const warp::Scratch<K> ws(sh + (long)(tid >> 5) * warp::scratch_words<K>());
  double* mult = sh + (long)(nthreads / 32) * warp::scratch_words<K>();
  double* fin = mult + (long)rows * K;
  double* piv = fin + (long)rows * K;  // [t & 1]: d, then 1/d
  double* slot = piv + 4 * K;
  for (long w = tid; w < (long)rows * W; w += nthreads) {
    const int r = (int)(w / W), c = (int)(w % W);
    const double* src =
        r < W ? in_diag + w * K : in_tile + (w - (long)W * W) * K;
    double* dst = panel_entry<K>(diag, tile, W, r, c);
    for (int i = 0; i < K; ++i) dst[i] = src[i];
  }
  EXP_SYNC();
  if (tid < 32) {
    // the pivot warp, as chol_panel_block's
    const regs::Emit em{nullptr, 0};
    double* wsm = sh;
    warp::init_codes<K>(ws, tid);
    for (int i = 0; i < K; ++i) slot[kA * K + i] = diag[i];
    pivot_program<K>(slot, 3, pivot_ops<K>(), wsm, em, tid);
    for (int i = 0; i < K; ++i) {
      piv[i] = slot[kS * K + i];
      piv[K + i] = slot[kY * K + i];
    }
#pragma unroll 1
    for (int t = 0; t < W; ++t) {
      EXP_SYNC();
      if (t + 1 < W) {
        const double* x1 = diag + ((long)(t + 1) * W + t) * K;
        for (int i = 0; i < K; ++i) {
          slot[kX1 * K + i] = x1[i];
          slot[kX2 * K + i] = x1[K + i];
        }
        pivot_program<K>(slot, 0, pivot_ops<K>(), wsm, em, tid);
        double* nxt = piv + ((t + 1) & 1) * 2 * K;
        for (int i = 0; i < K; ++i) {
          nxt[i] = slot[kS * K + i];
          nxt[K + i] = slot[kY * K + i];
        }
      }
    }
    return;
  }
  // the update warps
  const int uw = (tid >> 5) - 1, nw = nthreads / 32 - 1;
#pragma unroll 1
  for (int t = 0; t < W; ++t) {
    EXP_SYNC();
    const double* d = piv + (t & 1) * 2 * K;
#pragma unroll 1
    for (int u = uw; u < rows; u += nw) {
      double* f = fin + (long)u * K;
      if (t >= 1) {
        double* e = panel_entry<K>(diag, tile, W, u, t - 1);
        for (int i = lane; i < K; i += 32) e[i] = f[i];
      }
      EXP_SYNC_WARP();
      if (u < t) {
        for (int i = lane; i < K; i += 32) f[i] = 0.0;
        EXP_SYNC_WARP();
        continue;
      }
      if (u == t) {
        for (int i = lane; i < K; i += 32) f[i] = d[i];
        EXP_SYNC_WARP();
      } else {
        warp_operands<K>(ws, panel_entry<K>(diag, tile, W, u, t), d + K,
                         false, lane);
        warp_op_to<K>(ws, [&] { return warp::mul<K>(ws, lane); }, f, false,
                      lane);
      }
      for (int i = lane; i < K; i += 32) mult[(long)u * K + i] = f[i];
      // the W - t zero additions, until one leaves the value unchanged
#pragma unroll 1
      for (int z = 0; z < W - t; ++z) {
        warp_operands<K>(ws, f, nullptr, false, lane);
        const warp::Res r = warp::add<K>(ws, lane);
        EXP_SYNC_WARP();
        bool same = true;
        for (int i = 0; i < K; ++i)
          same = same && word_bits(warp::res_word<K>(ws, r, i)) ==
                             word_bits(f[i]);
        EXP_SYNC_WARP();  // every lane has compared
        if (same) break;
        for (int i = lane; i < K; i += 32) f[i] = warp::res_word<K>(ws, r, i);
        EXP_SYNC_WARP();
      }
    }
    EXP_SYNC_UPDATE(nthreads - 32);
    const int nc = W - 1 - t;
#pragma unroll 1
    for (long w = uw; w < (long)rows * nc; w += nw) {
      const int r = (int)(w / nc), c = t + 1 + (int)(w % nc);
      if (r < c || (r == t + 1 && c == t + 1)) continue;
      double* e = panel_entry<K>(diag, tile, W, r, c);
      // e <- add(e, -mul(m_r, m_c)): the product's words negated into
      // ws.y, e into ws.x
      warp_operands<K>(ws, mult + (long)r * K, mult + (long)c * K, false,
                       lane);
      warp_op_to<K>(ws, [&] { return warp::mul<K>(ws, lane); }, ws.y, true,
                    lane);
      for (int i = lane; i < K; i += 32) ws.x[i] = e[i];
      EXP_SYNC_WARP();
      warp_op_to<K>(ws, [&] { return warp::add<K>(ws, lane); }, e, false,
                    lane);
    }
  }
  for (int u = uw; u < rows; u += nw) {
    double* e = panel_entry<K>(diag, tile, W, u, W - 1);
    for (int i = lane; i < K; i += 32) e[i] = fin[(long)u * K + i];
  }
}

// One warp's share of the substitution above kThreadMaxWords: column
// ``col`` (< m) of X = L^-1 B (or L^-T B), L (n, n), B and X (n, m),
// inv_d (n), every operation a warp operation on the warp's scratch
// ``wsm``.  Per row i, in solve_block's order: the n terms mul(l_ik, x_k)
// (+0 where k is masked, as the plain loop's mul(+0, +0)) into ``tree``
// (n x K words of the column's own), their sum by mp/core.py sum_'s tree
// (a[p] + a[p + h], a pair of +0 values skipped, an odd last term
// carried), then x_i = mul(add(b_i, -sum), inv_d_i) into X, from where
// the rows below read it.
template <int K>
EXP_BLOCK void solve_column_warp(const double* L, const double* B,
                                 const double* inv_d, double* X,
                                 double* tree, int n, int m, int col,
                                 bool transpose, double* wsm, int lane) {
  const warp::Scratch<K> ws(wsm);
  auto pos_zero = [&](const double* v) {
    bool z = true;
    for (int t = 0; t < K; ++t) z = z && word_bits(v[t]) == 0;
    return z;
  };
#pragma unroll 1
  for (int s = 0; s < n; ++s) {
    const int i = transpose ? n - 1 - s : s;
#pragma unroll 1
    for (int p = 0; p < n; ++p) {
      double* v = tree + (long)p * K;
      if (transpose ? p > i : p < i) {
        warp_operands<K>(
            ws, L + (transpose ? (long)p * n + i : (long)i * n + p) * K,
            X + ((long)p * m + col) * K, false, lane);
        warp_op_to<K>(ws, [&] { return warp::mul<K>(ws, lane); }, v, false,
                      lane);
      } else {
        for (int t = lane; t < K; t += 32) v[t] = 0.0;
      }
    }
    EXP_SYNC_WARP();
#pragma unroll 1
    for (int len = n; len > 1;) {
      const int h = len / 2, odd = len & 1;
#pragma unroll 1
      for (int p = 0; p < h; ++p) {
        double* v = tree + (long)p * K;
        const double* w = tree + (long)(p + h) * K;
        if (pos_zero(v) && pos_zero(w)) continue;
        warp_operands<K>(ws, v, w, false, lane);
        warp_op_to<K>(ws, [&] { return warp::add<K>(ws, lane); }, v, false,
                      lane);
      }
      if (odd) {
        EXP_SYNC_WARP();  // every lane has read the level's pairs
        for (int t = lane; t < K; t += 32)
          tree[(long)h * K + t] = tree[(long)2 * h * K + t];
        EXP_SYNC_WARP();
      }
      len = h + odd;
    }
    double* xi = X + ((long)i * m + col) * K;
    warp_operands<K>(ws, B + ((long)i * m + col) * K, tree, true, lane);
    warp_op_to<K>(ws, [&] { return warp::add<K>(ws, lane); }, xi, false,
                  lane);
    warp_operands<K>(ws, xi, inv_d + (long)i * K, false, lane);
    warp_op_to<K>(ws, [&] { return warp::mul<K>(ws, lane); }, xi, false,
                  lane);
  }
}

}  // namespace expn
