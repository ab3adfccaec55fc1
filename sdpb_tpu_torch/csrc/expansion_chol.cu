// The float64-expansion Cholesky column loop for Hopper (sm_90a): one
// launch runs every column step of a panel (csrc/expansion_panels.cuh
// chol_panel_block).
//
// It replaces the JAX package's column loops of the expansion
// Cholesky, which XLA compiles into one program:
// sdpb_tpu/mp/linalg.py:207-237 (_cholesky_unblocked, n <= 64) and
// :318-340 (col_step and panel_step of cholesky, the 32 columns of a
// panel).  Written as PyTorch tensor code the loop takes ~45 launches
// a column (25 expansion kernels for sqrt_rsqrt alone at K = 8), and
// the host's launch cost, not the card, set the time.
//
// What bounds it on this card.  A step's pivot is ~35 dependent
// expansion operations in one thread (sqrt_rsqrt: newton_steps(K)
// Newton steps of three products and two additions, then the Heron
// correction), so a panel of 32 columns is a chain of ~1,100 dependent
// expansion operations: latency, milliseconds at K = 8.  The trailing
// update beside it is ~W^2 R / 2 products and additions, against the
// card's 17e12 float64 operations a second (no FMA: -fmad=false) and
// 3.35 TB/s: a bound of 0.01-0.2 ms at the panels of one iteration.
//
// What the design does about it.  One launch carries the whole column
// loop, so the host pays one call a panel instead of ~45 a column.  A
// block takes one batch element's pivot block and up to ``rt`` rows
// below it (ops/expansion_kernels.py CHOL_ROW_TILE); the blocks of a
// tall panel (the Q factor's: batch 1, up to 384 rows) each compute
// the pivot chain again on a private copy of the pivot block (in
// ``scratch``), so its rows spread over the card and no block waits
// for another.  A step: one thread forms the pivot, the block forms
// the column's multipliers into shared memory, every thread updates
// its entries, one __syncthreads() between the phases.  An entry's
// words stay in device memory (L1/L2) between steps; the expansion
// operations are out-of-line functions, one copy of each.  Overlapping
// a step's pivot with the update before it is left to a later change.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -c -Xcompiler -fPIC -DEXP_K=<K>
//        (see ops/expansion_kernels.py)

#include <cuda_runtime.h>

#include "expansion_panels.cuh"

namespace {

// Threads a block.  One block an SM suffices (__launch_bounds__ min
// blocks 1): without that bound ptxas gives these kernels fewer
// registers than their out-of-line operations' calls need and spills
// around the calls, at some K of 1..20.
constexpr int kThreads = 128;

// in, out (bb, R, W, K); scratch (bb, tiles - 1, W, W, K): block
// b * tiles + tile takes batch element b's pivot block and rows
// W + tile * rt ... of at most rt rows.
template <int K>
__global__ void __launch_bounds__(kThreads, 1)
    exp_chol_kernel(const double* __restrict__ in, double* __restrict__ out,
                    double* __restrict__ scratch, int R, int W, int tiles,
                    int rt) {
  extern __shared__ double sh[];
  const int b = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  const long panel = (long)R * W * K;
  const double* in_b = in + b * panel;
  double* out_b = out + b * panel;
  const int row0 = W + tile * rt;
  const int nt = min(rt, R - row0);
  double* diag = tile == 0 ? out_b
                           : scratch + ((long)b * (tiles - 1) + tile - 1) *
                                           W * W * K;
  expn::chol_panel_block<K>(in_b, in_b + (long)row0 * W * K, diag,
                            out_b + (long)row0 * W * K, W, nt > 0 ? nt : 0,
                            sh, threadIdx.x, kThreads);
}

}  // namespace

#ifndef EXP_K
#error "compile with -DEXP_K=<words per value>"
#endif
#define EXP_PASTE2(a, b) a##b
#define EXP_PASTE(a, b) EXP_PASTE2(a, b)

extern "C" {

int EXP_PASTE(expansion_chol_k, EXP_K)(const double* in, double* out,
                                       double* scratch, int bb, int R, int W,
                                       int tiles, int rt, void* stream) {
  if (bb < 1 || W < 1 || R < W || tiles < 1 || rt < 1 ||
      (tiles > 1 && scratch == nullptr) || EXP_K > expn::kMaxWords)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(W + rt + 2) * EXP_K * sizeof(double);
  exp_chol_kernel<EXP_K><<<bb * tiles, kThreads, smem,
                           (cudaStream_t)stream>>>(in, out, scratch, R, W,
                                                   tiles, rt);
  return (int)cudaGetLastError();
}

}  // extern "C"
