// Float64 word expansions: the column loops of the expansion Cholesky
// and triangular substitution, one thread block at a time (up to K =
// kThreadMaxWords) or one warp of a thread-block cluster at a time
// (above it: chol_cluster_warp, solve_cluster_warp, at the end of this
// file).  The bodies of csrc/expansion_chol.cu and
// csrc/expansion_solve.cu.
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
// for the shuffle, against the plain loops;
// tests/test_torch_expansion_panels_wide.py does so for the clusters.

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
// The cluster's barrier (above K = 20), its arrive and its wait.
#ifndef EXP_CLUSTER_ARRIVE
#ifdef __CUDACC__
#define EXP_CLUSTER_ARRIVE()                              \
  do {                                                    \
    __threadfence();                                      \
    asm volatile("barrier.cluster.arrive;" ::: "memory"); \
  } while (0)
#define EXP_CLUSTER_WAIT()                              \
  do {                                                  \
    asm volatile("barrier.cluster.wait;" ::: "memory"); \
    __threadfence();                                    \
  } while (0)
#else
#define EXP_CLUSTER_ARRIVE() ((void)0)
#define EXP_CLUSTER_WAIT() ((void)0)
#endif
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
// Above K = kThreadMaxWords: every operation a value a warp, a step's
// operations spread over the warps of a thread-block cluster
// ---------------------------------------------------------------------------

// A thread's operands alone at K = 54 are 216 registers, so above K = 20
// the column loops run every operation on a warp (expansion_warp.cuh).
// Such an operation is slow, and its time is fixed: a product's VecSum
// chain runs over mul_terms<K>() words (574 at K = 23, 3,023 at K = 54)
// in an order that the bits fix.  Its scratch (warp::scratch_words: 6.2
// KB at K = 23, 27.5 KB at K = 54) lets one SM hold only a few of them.
// So the loops below run the operations that do not wait for each other
// on many warps at once, over several SMs: the G warps of a thread-block
// cluster, warp g = block rank * warps a block + warp in the block.
//
// The warps of a cluster exchange what they share (a panel's entries,
// its multipliers and pivots; a column's terms and x) through global
// memory, ordered by the cluster's barrier, split into its arrive and its
// wait: release and acquire at cluster scope, with a fence at the card's
// scope beside each.  Another block's shared memory would save an L2
// round trip, small beside a warp operation (a product takes 96,366
// cycles at K = 23 and 458,083 at K = 54: csrc/expansion_latency.cu), and
// a block's shared memory is its warps' scratch, which is what bounds
// the warps an SM holds; the panel itself is too large for it at any K
// here.  A cluster's blocks are resident together, so its barrier cannot
// wait on a block that has yet to start; it waits for the threads that
// have not exited, so a warp with no part to play exits.  Clusters share
// nothing.

EXP_BLOCK void cluster_sync() {
  EXP_CLUSTER_ARRIVE();
  EXP_CLUSTER_WAIT();
}

// Shared memory of a block of the cluster Cholesky, in doubles: its
// ``warps`` warps' scratch, then the pivot warp's slots (used by the
// first block only).
template <int K>
EXP_HD constexpr long chol_cluster_smem_words(int warps) {
  return (long)warps * warp::scratch_words<K>() + (long)K * kPivotSlots;
}

// Global memory a cluster of the Cholesky exchanges through, in doubles:
// the rows' multipliers and their final words of the step's column, then
// the pivots ([t & 1]: d, then 1/d).
template <int K>
EXP_HD constexpr long chol_cluster_share_words(int rows) {
  return (long)K * (2 * rows + 4);
}

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

// Step t's rows on update warp e of U (chol_panel_cluster): rows t, t +
// 1, ... in turn (one each while U covers them), then the rows above t.
// A row writes its final word of column t - 1, kept a step in ``fin``,
// then forms its multiplier of column t (by 1/d) into ``mult`` and its
// final word of column t: the W - t zero additions of the masked update,
// until one leaves the value unchanged.
template <int K>
EXP_BLOCK void chol_cluster_rows(const warp::Scratch<K>& ws, double* diag,
                                 double* tile, double* mult, double* fin,
                                 const double* d, int W, int rows, int t,
                                 int e, int U, int lane) {
  const auto mul = [&] { return warp::mul<K>(ws, lane); };
  const auto add = [&] { return warp::add<K>(ws, lane); };
#pragma unroll 1
  for (int j = e; j < rows; j += U) {
    const int u = (t + j) % rows;
    double* f = fin + (long)u * K;
    if (t >= 1) {
      double* x = panel_entry<K>(diag, tile, W, u, t - 1);
      for (int i = lane; i < K; i += 32) x[i] = f[i];
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
      warp_operands<K>(ws, panel_entry<K>(diag, tile, W, u, t), d + K, false,
                       lane);
      warp_op_to<K>(ws, mul, f, false, lane);
    }
    for (int i = lane; i < K; i += 32) mult[(long)u * K + i] = f[i];
#pragma unroll 1
    for (int z = 0; z < W - t; ++z) {
      warp_operands<K>(ws, f, nullptr, false, lane);
      const warp::Res r = add();
      EXP_SYNC_WARP();
      // every word's bits compared, the loads independent of each other
      long long diff = 0;
      for (int i = 0; i < K; ++i)
        diff |= word_bits(warp::res_word<K>(ws, r, i)) ^ word_bits(f[i]);
      EXP_SYNC_WARP();  // every lane has compared
      if (diff == 0) break;
      for (int i = lane; i < K; i += 32) f[i] = warp::res_word<K>(ws, r, i);
      EXP_SYNC_WARP();
    }
  }
}

// Step t's update on update warp e of U: the lower entries (r, c) of the
// columns c > t, (t + 1, t + 1) but (the pivot warp's), in row-major
// order, every U-th from the e-th; each e <- add(e, -mul(m_r, m_c)).
template <int K>
EXP_BLOCK void chol_cluster_update(const warp::Scratch<K>& ws, double* diag,
                                   double* tile, const double* mult, int W,
                                   int rows, int t, int e, int U, int lane) {
  const auto mul = [&] { return warp::mul<K>(ws, lane); };
  const auto add = [&] { return warp::add<K>(ws, lane); };
  int first = 0;  // the index of row r's first entry
#pragma unroll 1
  for (int r = t + 2; r < rows; ++r) {
    const int cnt = (r < W ? r : W - 1) - t;  // columns t + 1 ..
#pragma unroll 1
    for (int k = ((e - first) % U + U) % U; k < cnt; k += U) {
      const int c = t + 1 + k;
      double* x = panel_entry<K>(diag, tile, W, r, c);
      // the product's words negated into ws.y, the entry into ws.x
      warp_operands<K>(ws, mult + (long)r * K, mult + (long)c * K, false,
                       lane);
      warp_op_to<K>(ws, mul, ws.y, true, lane);
      for (int i = lane; i < K; i += 32) ws.x[i] = x[i];
      EXP_SYNC_WARP();
      warp_op_to<K>(ws, add, x, false, lane);
    }
    first += cnt;
  }
}

// The column loop of a Cholesky panel above kThreadMaxWords, by the G
// warps of a cluster: the matrix's rows R >= W of W columns, the first W
// rows the pivot block, in ``diag`` and ``tile`` as chol_panel_block
// holds them (a cluster that is not the first of its panel works on a
// private copy of the pivot block, which it computes again).  This is
// warp g (lane ``lane``), its scratch ``wsm``; ``slot`` (kPivotSlots x K
// words, shared memory) is the pivot warp's, ``share``
// (chol_cluster_share_words) the cluster's.
//
// The schedule is chol_panel_block's, spread over the cluster.  Warp 0,
// the pivot warp, forms pivot t + 1 in step t from row t + 1's entries
// (t + 1, t) and (t + 1, t + 1), as the plain loop would after step t,
// a step ahead of the rest.  The warps from ``lead`` on, the update
// warps, take step t's rows in turn (chol_cluster_rows), then, behind the
// cluster's barrier, step t's update entries in turn
// (chol_cluster_update); entry (t + 1, t + 1)'s update is the pivot
// warp's alone.  A step ends at the cluster's barrier, where the pivot
// warp hands pivot t + 1 over.  It arrives at the mid-step barrier as the
// step begins, so a step takes max(pivot chain, update) and not their
// sum.  Every entry takes its updates in the order of t, each the plain
// loop's mul and add.  Two cluster barriers a step.  The first ``lead``
// warps (the pivot warp, or its whole block) take no update, so that a
// cluster of many blocks leaves the pivot's chain alone on its SM: a
// warp operation there takes 1.15x as long beside 7 busy warps
// (csrc/expansion_latency.cu).
template <int K>
EXP_BLOCK void chol_panel_cluster(const double* in_diag, const double* in_tile,
                                  double* diag, double* tile, int W, int nt,
                                  double* share, double* slot, double* wsm,
                                  int g, int G, int lead, int lane) {
  const int rows = W + nt, U = G - lead;
  const warp::Scratch<K> ws(wsm);
  double* mult = share;
  double* fin = mult + (long)rows * K;
  double* piv = fin + (long)rows * K;
  for (long w = (long)g * 32 + lane; w < (long)rows * W;
       w += (long)G * 32) {
    const int r = (int)(w / W), c = (int)(w % W);
    const double* src =
        r < W ? in_diag + w * K : in_tile + (w - (long)W * W) * K;
    double* dst = panel_entry<K>(diag, tile, W, r, c);
    for (int i = 0; i < K; ++i) dst[i] = src[i];
  }
  cluster_sync();
  // a warp with no part in the steps exits: the cluster's barrier waits
  // for the threads that have not, and a waiting warp would take issue
  // slots from the pivot warp beside it
  if (g >= 1 && g < lead) return;
  const regs::Emit em{nullptr, 0};
  if (g == 0) {
    warp::init_codes<K>(ws, lane);
    for (int i = lane; i < K; i += 32) slot[kA * K + i] = diag[i];
    EXP_SYNC_WARP();
    pivot_program<K>(slot, 3, pivot_ops<K>(), wsm, em, lane);
    for (int i = lane; i < K; i += 32) {
      piv[i] = slot[kS * K + i];
      piv[K + i] = slot[kY * K + i];
    }
  }
  cluster_sync();
#pragma unroll 1
  for (int t = 0; t < W; ++t) {
    if (g == 0) {
      EXP_CLUSTER_ARRIVE();  // the mid-step barrier: nothing to wait for
      if (t + 1 < W) {
        const double* x1 = diag + ((long)(t + 1) * W + t) * K;
        for (int i = lane; i < K; i += 32) {
          slot[kX1 * K + i] = x1[i];
          slot[kX2 * K + i] = x1[K + i];
        }
        EXP_SYNC_WARP();
        pivot_program<K>(slot, 0, pivot_ops<K>(), wsm, em, lane);
        double* nxt = piv + ((t + 1) & 1) * 2 * K;
        for (int i = lane; i < K; i += 32) {
          nxt[i] = slot[kS * K + i];
          nxt[K + i] = slot[kY * K + i];
        }
      }
      EXP_CLUSTER_WAIT();
    } else {
      if (g >= lead)
        chol_cluster_rows<K>(ws, diag, tile, mult, fin,
                             piv + (t & 1) * 2 * K, W, rows, t, g - lead, U,
                             lane);
      cluster_sync();  // every row's multiplier is out
      if (g >= lead)
        chol_cluster_update<K>(ws, diag, tile, mult, W, rows, t, g - lead, U,
                               lane);
    }
    cluster_sync();
  }
  for (int u = g - lead; g >= lead && u < rows; u += U) {
    double* x = panel_entry<K>(diag, tile, W, u, W - 1);
    for (int i = lane; i < K; i += 32) x[i] = fin[(long)u * K + i];
  }
}

// Warp g of cluster ``cl`` of the cluster Cholesky (csrc/
// expansion_chol.cu): in, out (bb, R, W, K); scratch (bb, tiles - 1, W,
// W, K), the private pivot blocks; share (bb * tiles,
// chol_cluster_share_words(W + rt)).  Cluster b * tiles + tile, P blocks
// of ``warps`` warps (warp g in block g / warps, whose shared memory is
// ``sh``: chol_cluster_smem_words(warps)), takes batch element b's pivot
// block and rows W + tile * rt ... of at most rt rows; from P = 4 blocks
// up the pivot warp's block takes no update.
template <int K>
EXP_BLOCK void chol_cluster_warp(const double* in, double* out,
                                 double* scratch, double* share, int R,
                                 int W, int tiles, int rt, int P, int warps,
                                 long cl, int g, double* sh, int lane) {
  const long b = cl / tiles;
  const int tile = (int)(cl % tiles);
  const long panel = (long)R * W * K;
  const double* in_b = in + b * panel;
  double* out_b = out + b * panel;
  const int row0 = W + tile * rt;
  const int nt = R - row0 < rt ? R - row0 : rt;
  double* diag = tile == 0 ? out_b
                           : scratch + (b * (tiles - 1) + tile - 1) * W * W * K;
  const long words = warp::scratch_words<K>();
  chol_panel_cluster<K>(in_b, in_b + (long)row0 * W * K, diag,
                        out_b + (long)row0 * W * K, W, nt > 0 ? nt : 0,
                        share + cl * chol_cluster_share_words<K>(
                                         W + (R > W ? rt : 0)),
                        sh + warps * words, sh + (g % warps) * words, g,
                        P * warps, P >= 4 ? warps : 1, lane);
}

// One warp's share of the substitution above kThreadMaxWords where the
// columns fill the card (wc = 1): column ``col`` (< m) of X = L^-1 B (or
// L^-T B), L (n, n), B and X (n, m), inv_d (n), every operation a warp
// operation on the warp's scratch ``wsm``, one after another.  Per row
// i, in solve_block's order: the n terms mul(l_ik, x_k)
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

// Warp q's share of column ``col`` of X = L^-1 B (or L^-T B) above
// kThreadMaxWords, as one of the column's wc > 1 warps (they lie in one
// cluster and meet at its barrier): L (n, n), B and X (n, m), inv_d (n)
// values of K words.
// Per row i, in solve_block's order: the n terms mul(l_ik, x_k) (+0
// where k is masked, as the plain loop's mul(+0, +0)) into ``tree``,
// their sum by
// mp/core.py sum_'s tree (a[p] + a[p + h] by the warp that holds term p,
// in place, a pair of +0 values skipped, an odd last term carried to
// index h), a level at a time behind the column's barrier; then x_i =
// mul(add(b_i, -sum), inv_d_i) into X, from where the rows below read it.
//
// The schedule.  The root warp forms each x; the terms go to the leaf
// warps in turn (term p to leaf warp p mod the leaf warps).  Step
// s's row i (the row before it i'): in phase A the root forms x_i' while
// each leaf warp forms one of its terms of row i that does not need x_i'
// (and +0 for the masked ones); in phase B, behind the column's barrier,
// term i' (the one that needs x_i') and the rest; then the tree.  So a
// row costs the later of x_i' and one product, a product, and the tree's
// log2(n) additions: with two terms a leaf warp (wc = 1 + n / 2), two
// dependent products a row.  Where the root would cost more products a
// row without terms of its own (small wc), it also takes terms and forms
// its own in phase B.  Phase A of step n forms the last x.  ``tree`` holds
// two rows' terms (2 n x K words), as the root reads one row's sum while
// the leaf warps write the next row's terms.
template <int K>
EXP_BLOCK void solve_column_warps(const double* L, const double* B,
                                  const double* inv_d, double* X,
                                  double* tree, int n, int m, int col,
                                  int q, int wc, bool transpose,
                                  double* wsm, int lane) {
  const warp::Scratch<K> ws(wsm);
  const auto mul = [&] { return warp::mul<K>(ws, lane); };
  const auto add = [&] { return warp::add<K>(ws, lane); };
  // every word +0: the leading word alone decides most values, the rest
  // are read at once
  auto pos_zero = [&](const double* v) {
    if (word_bits(v[0]) != 0) return false;
    long long bits = 0;
    for (int t = 1; t < K; ++t) bits |= word_bits(v[t]);
    return bits == 0;
  };
  // The root is the column's last warp (alone in its block where the
  // column spans blocks).  It holds no terms where that costs no more
  // dependent products a row: ceil(n / (wc - 1)) against 1 + ceil(n /
  // wc).
  const bool leafless = (n + wc - 2) / (wc - 1) <= 1 + (n + wc - 1) / wc;
  const int leaves = leafless ? wc - 1 : wc;
  const bool is_root = q == wc - 1;
  const int lq = leafless && is_root ? -1 : q;  // leaf index, or -1
  auto row_of = [&](int s) { return transpose ? n - 1 - s : s; };
  auto live = [&](int i, int p) { return transpose ? p > i : p < i; };
  // term p of row i into v
  auto form_term = [&](int i, int p, double* v) {
    warp_operands<K>(
        ws, L + (transpose ? (long)p * n + i : (long)i * n + p) * K,
        X + ((long)p * m + col) * K, false, lane);
    warp_op_to<K>(ws, mul, v, false, lane);
  };
#pragma unroll 1
  for (int s = 0; s <= n; ++s) {
    const int i = row_of(s < n ? s : 0), prev = s >= 1 ? row_of(s - 1) : -1;
    double* tr = tree + (long)(s & 1) * n * K;
    // phase A
    if (is_root && s >= 1) {
      const double* sum = tree + (long)((s - 1) & 1) * n * K;
      double* xp = X + ((long)prev * m + col) * K;
      warp_operands<K>(ws, B + ((long)prev * m + col) * K, sum, true, lane);
      warp_op_to<K>(ws, add, xp, false, lane);
      warp_operands<K>(ws, xp, inv_d + (long)prev * K, false, lane);
      warp_op_to<K>(ws, mul, xp, false, lane);
    }
    if (s < n && lq >= 0 && !(is_root && s >= 1)) {
      bool one = false;
#pragma unroll 1
      for (int p = lq; p < n; p += leaves) {
        if (!live(i, p)) {
          for (int t = lane; t < K; t += 32) tr[(long)p * K + t] = 0.0;
          EXP_SYNC_WARP();
        } else if (p != prev && !one) {
          form_term(i, p, tr + (long)p * K);
          one = true;
        }
      }
    }
    cluster_sync();  // x_i' is out; phase A's terms are
    if (s == n) break;
    // phase B: term i' first, then the terms phase A left (all of the
    // root's, which formed x_i' there)
    if (lq >= 0) {
      if (prev >= 0 && prev % leaves == lq)
        form_term(i, prev, tr + (long)prev * K);
      const bool root = is_root && s >= 1;
      bool skip = !root;  // phase A formed the first
#pragma unroll 1
      for (int p = lq; p < n; p += leaves) {
        if (!live(i, p)) {
          if (root) {
            for (int t = lane; t < K; t += 32) tr[(long)p * K + t] = 0.0;
            EXP_SYNC_WARP();
          }
        } else if (p != prev) {
          if (skip)
            skip = false;
          else
            form_term(i, p, tr + (long)p * K);
        }
      }
    }
    // every term is out (not needed where the first level's pairs are
    // each one warp's own terms)
    if ((n / 2) % leaves != 0) cluster_sync();
#pragma unroll 1
    for (int len = n; len > 1;) {
      const int h = len / 2, odd = len & 1;
      if (lq >= 0) {
#pragma unroll 1
        for (int p = lq; p < h; p += leaves) {
          double* v = tr + (long)p * K;
          const double* w = tr + (long)(p + h) * K;
          if (pos_zero(v) && pos_zero(w)) continue;
          warp_operands<K>(ws, v, w, false, lane);
          warp_op_to<K>(ws, add, v, false, lane);
        }
      }
      cluster_sync();  // the level's pairs are read and written
      if (odd) {
        if (lq >= 0 && h % leaves == lq) {
          for (int t = lane; t < K; t += 32)
            tr[(long)h * K + t] = tr[(long)2 * h * K + t];
        }
        cluster_sync();
      }
      len = h + odd;
    }
  }
}

// Blocks of a cluster of the solve for wc warps a column: enough blocks
// of ``warps`` warps to hold a column's, or one block of several
// columns.
EXP_HD int solve_cluster_blocks(int wc, int warps) {
  return wc > warps ? (wc + warps - 1) / warps : 1;
}

// Warp gw of cluster ``cl`` of the solve (csrc/expansion_solve.cu): L
// (bb, n, n, K), B and X (bb, n, m, K), inv_d (bb, n, K), tree (bb * m,
// 2n, K), or (bb * m, n, K) for wc = 1; wc warps a column, clusters of
// P = solve_cluster_blocks(wc, warps) blocks of ``warps`` warps, each
// cluster P * warps / wc of the bb * m columns (warp gw's scratch
// ``wsm``; the rest of its warps exit).
template <int K>
EXP_BLOCK void solve_cluster_warp(const double* L, const double* B,
                                  const double* inv_d, double* X,
                                  double* tree, int bb, int n, int m, int wc,
                                  int warps, bool transpose, long cl, int gw,
                                  double* wsm, int lane) {
  const int cpc = solve_cluster_blocks(wc, warps) * warps / wc;
  const long colid = cl * cpc + gw / wc;
  // a warp of no column exits: the cluster's barrier waits for the
  // threads that have not
  if (gw / wc >= cpc || colid >= (long)bb * m) return;
  const long b = colid / m, nm = (long)n * m * K;
  const int col = (int)(colid % m);
  if (wc == 1)
    solve_column_warp<K>(L + b * n * n * K, B + b * nm, inv_d + b * n * K,
                         X + b * nm, tree + colid * n * K, n, m, col,
                         transpose, wsm, lane);
  else
    solve_column_warps<K>(L + b * n * n * K, B + b * nm, inv_d + b * n * K,
                          X + b * nm, tree + colid * 2 * n * K, n, m, col,
                          gw % wc, wc, transpose, wsm, lane);
}

#ifdef __CUDACC__
// Clusters of P blocks of ``threads`` threads and ``smem`` bytes of
// dynamic shared memory of ``kernel`` that the card holds at once (its
// registers and shared memory, and the GPCs the clusters pack into), or
// a negative CUDA error.
template <class... Params>
inline int max_clusters(void (*kernel)(Params...), int threads, int P,
                        size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(P, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = P;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  return err == cudaSuccess ? clusters : -(int)err;
}

// Launches ``kernel`` on ``blocks`` blocks of ``threads`` threads with
// ``smem`` bytes of dynamic shared memory each, in clusters of P blocks
// (consecutive blockIdx.x; block rank blockIdx.x % P); the launch's error.
template <class... Params, class... Args>
inline cudaError_t launch_cluster(void (*kernel)(Params...), long blocks,
                                  int threads, int P, size_t smem,
                                  void* stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = P;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
#endif

}  // namespace expn
