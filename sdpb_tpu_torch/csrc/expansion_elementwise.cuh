// Float64 word expansions, elementwise: what one block (a value a
// thread) or one warp (a value a warp) of csrc/expansion_elementwise.cu
// does.  The bodies of its two kernels.
//
// thread_values and warp_values are written against a thread index, the
// block barrier EXP_SYNC() (__syncthreads()) and the warp barrier
// EXP_SYNC_WARP() (__syncwarp()), so that tests/test_torch_expansion_
// elementwise.py compiles them with g++ -ffp-contract=off and runs a
// block on host threads (std::barrier as the barriers) against
// mp/core.py's plain functions.  The per-value arithmetic is
// csrc/expansion_regs.cuh's (a value a thread, its words in registers)
// and csrc/expansion_warp.cuh's (a value a warp), both the float64
// operations of csrc/expansion.cuh in its order: the same bits.

#pragma once

#include "expansion_warp.cuh"

#ifndef EXP_SYNC
#define EXP_SYNC() __syncthreads()
#endif

namespace expn {
namespace ew {

// The operations, as the library's entry point numbers them: b an
// expansion of K words (add, mul, div) or one float64 word a value
// (add_f64, mul_f64).
enum Op { kAdd, kMul, kDiv, kAddF64, kMulF64 };

template <int K, int OP>
EXP_HD constexpr int b_words() {
  return OP <= kDiv ? K : 1;
}

// A staged value's stride in shared memory: an odd number of words, so
// that the 32 values a warp reads (one word each) fall in distinct banks.
EXP_HD constexpr int odd(int w) { return w | 1; }

// A thread's scratch words (regs::Emit) by operation.
template <int K, int OP>
EXP_HD constexpr int thread_scratch_words() {
  return OP == kMul ? regs::thread_words<K>()
                    : OP == kDiv ? regs::div_words<K>() : K;
}

// Shared memory of a block of the value-a-thread design, in doubles: the
// staged operands a and b, then each thread's scratch.
template <int K, int OP>
EXP_HD constexpr long thread_smem_words(int nthreads) {
  return (long)nthreads *
         (odd(K) + odd(b_words<K, OP>()) + thread_scratch_words<K, OP>());
}

// A value a thread: the values first, first + step, ... (a chunk of
// ``nthreads`` from each), value i of a at a + i sa (sa = K, or 0 for
// one value broadcast over the batch), of b at b + i sb likewise, out
// (n, K).  The block copies a chunk's K x nthreads words of each operand
// into shared memory with consecutive threads on consecutive words
// (coalesced), each thread takes its value's words into registers, runs
// the operation (expansion_regs.cuh: no local memory), writes its
// result over its staged a, and the block copies the chunk out the same
// way.
template <int K, int OP>
EXP_BLOCK void thread_values(const double* a, long sa, const double* b,
                             long sb, double* out, long n, long first,
                             long step, double* sh, int tid, int nthreads) {
  constexpr int BW = b_words<K, OP>();
  constexpr int PA = odd(K), PB = odd(BW);
  double* xa = sh;
  double* xb = xa + (long)nthreads * PA;
  const regs::Emit em{xb + (long)nthreads * PB + tid, nthreads};
  for (long base = first; base < n; base += step) {
    const int cnt = n - base < nthreads ? (int)(n - base) : nthreads;
    EXP_SYNC();  // the previous chunk is out of the staging
    for (int f = tid; f < cnt * K; f += nthreads) {
      const int v = f / K, t = f - v * K;
      xa[v * PA + t] = a[(base + v) * sa + t];
    }
    for (int f = tid; f < cnt * BW; f += nthreads) {
      const int v = f / BW, t = f - v * BW;
      xb[v * PB + t] = b[(base + v) * sb + t];
    }
    EXP_SYNC();
    if (tid < cnt) {
      double x[K], o[K];
      regs::load<K>(xa + tid * PA, x);
      if constexpr (OP == kAdd || OP == kMul) {
        double y[K];
        regs::load<K>(xb + tid * PB, y);
        if constexpr (OP == kAdd) {
          regs::add<K>(x, y, em, o);
        } else {
          regs::mul<K>(x, y, em, o);
        }
      } else if constexpr (OP == kDiv) {
        regs::div<K>(x, xb + tid * PB, 1, em, o);
      } else if constexpr (OP == kAddF64) {
        regs::add_f64<K>(x, xb[tid * PB], em, o);
      } else {
        regs::mul_f64<K>(x, xb[tid * PB], em, o);
      }
      regs::store<K>(o, xa + tid * PA);
    }
    EXP_SYNC();
    for (int f = tid; f < cnt * K; f += nthreads) {
      const int v = f / K, t = f - v * K;
      out[(base + v) * K + t] = xa[v * PA + t];
    }
  }
}

// A warp's shared memory in the value-a-warp design, in doubles: the
// warp operations' scratch, and for div the divisor and the quotient
// words.
template <int K, int OP>
EXP_HD constexpr int warp_words() {
  return warp::scratch_words<K>() + (OP == kDiv ? 2 * K + 1 : 0);
}

// A value a warp (K >= 3): the values first, first + step, ..., the
// operands' words read by the lanes (consecutive lanes on consecutive
// words) into the warp's scratch ``wsm`` (warp_words), the operation as
// a warp operation (expansion_warp.cuh: the partial products, the merge
// and the errors spread over the lanes, the renormalization's chains run
// once), the result's words written by the lanes.  Operands as
// thread_values.
template <int K, int OP>
EXP_BLOCK void warp_values(const double* a, long sa, const double* b,
                           long sb, double* out, long n, long first,
                           long step, double* wsm, int lane) {
  static_assert(K >= 3, "the warp operations start at K = 3");
  const warp::Scratch<K> ws(wsm);
  double* bw = wsm + warp::scratch_words<K>();  // div: b, then q
  if constexpr (OP == kMul) warp::init_codes<K>(ws, lane);
  for (long i = first; i < n; i += step) {
    const double* ai = a + i * sa;
    const double* bi = b + i * sb;
    EXP_SYNC_WARP();  // the previous value's operands are read
    for (int t = lane; t < K; t += 32) {
      ws.x[t] = ai[t];
      if constexpr (OP == kAdd || OP == kMul) ws.y[t] = bi[t];
      if constexpr (OP == kDiv) bw[t] = bi[t];
    }
    EXP_SYNC_WARP();
    warp::Res r;
    if constexpr (OP == kAdd) {
      r = warp::add<K>(ws, lane);
    } else if constexpr (OP == kMul) {
      r = warp::mul<K>(ws, lane);
    } else if constexpr (OP == kDiv) {
      r = warp::div<K>(ws, bw, bw + K, lane);
    } else if constexpr (OP == kAddF64) {
      r = warp::add_f64<K>(ws, bi[0], lane);
    } else {
      r = warp::mul_f64<K>(ws, ws.x, bi[0], lane);
    }
    EXP_SYNC_WARP();
    for (int t = lane; t < K; t += 32)
      out[i * K + t] = warp::res_word<K>(ws, r, t);
  }
}

}  // namespace ew
}  // namespace expn
