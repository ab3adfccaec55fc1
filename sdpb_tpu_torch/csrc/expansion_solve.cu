// The float64-expansion triangular substitution for Hopper (sm_90a):
// one launch runs every row of X = L^-1 B or L^-T B
// (csrc/expansion_panels.cuh solve_block).
//
// It replaces the JAX package's substitution loops, which XLA
// compiles into one program: sdpb_tpu/mp/linalg.py:354-373
// (_solve_lower_unblocked) and :487-507 (_solve_lower_t_unblocked),
// used directly for n <= 64 and for each 32-row panel of the blocked
// solves.  Written as PyTorch tensor code a row takes a masked product,
// a 5-6 level tree sum, a subtraction and a product, ~10 launches, so
// the host's launch cost set the time.
//
// What bounds it on this card.  A row's value depends on every row
// before it: per row a product, ceil(log2 n) tree additions, an
// addition and a product, one after another (~8 us at K = 8), so one
// launch is a chain of ~n such steps: latency, unless the batch is
// wide.  The work beside it, n^2 m / 2 products and additions, against
// the card's 17e12 float64 operations a second (no FMA: -fmad=false)
// is ~1 ms at the widest solve of one iteration (48 blocks of 32 rows
// against 384 columns) and microseconds at the narrow ones.
//
// What the design does about it.  One launch carries the whole loop.
// A block takes one batch element and a tile of up to 16 right-hand-
// side columns (ops/expansion_kernels.py solve_tile: fewer where n K
// words a column would not fit 48 KB of shared memory), so batch x
// tiles blocks run the chains side by side.  A row step: the block
// forms the row's n x tile products into shared memory (a masked term
// is +0 and costs a store), adds the tree level by level, a thread per
// pair, and forms x_i, a thread per column, one __syncthreads()
// between the phases.  x and L are read from device memory (L1/L2);
// the expansion operations are out-of-line functions, one copy each.
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

// L (bb, n, n, K), B and X (bb, n, m, K), inv_d (bb, n, K): block
// b * tiles + tile solves batch element b's columns tile * tm ... .
template <int K>
__global__ void __launch_bounds__(kThreads, 1)
    exp_solve_kernel(const double* __restrict__ L,
                     const double* __restrict__ B,
                     const double* __restrict__ inv_d, double* X, int n,
                     int m, int tm, int tiles, int transpose) {
  extern __shared__ double tree[];
  const int b = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  const int col0 = tile * tm;
  const long nm = (long)n * m * K;
  expn::solve_block<K>(L + (long)b * n * n * K, B + b * nm,
                       inv_d + (long)b * n * K, X + b * nm, n, m, col0,
                       min(tm, m - col0), transpose != 0, tree, threadIdx.x,
                       kThreads);
}

}  // namespace

#ifndef EXP_K
#error "compile with -DEXP_K=<words per value>"
#endif
#define EXP_PASTE2(a, b) a##b
#define EXP_PASTE(a, b) EXP_PASTE2(a, b)

extern "C" {

int EXP_PASTE(expansion_solve_k, EXP_K)(const double* L, const double* B,
                                        const double* inv_d, double* X,
                                        int bb, int n, int m, int tm,
                                        int transpose, void* stream) {
  if (bb < 1 || n < 1 || m < 1 || tm < 1 || EXP_K > expn::kMaxWords)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)n * tm * EXP_K * sizeof(double);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const int tiles = (m + tm - 1) / tm;
  exp_solve_kernel<EXP_K><<<bb * tiles, kThreads, smem,
                            (cudaStream_t)stream>>>(L, B, inv_d, X, n, m, tm,
                                                    tiles, transpose);
  return (int)cudaGetLastError();
}

}  // extern "C"
