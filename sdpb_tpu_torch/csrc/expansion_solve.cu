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
// before it: per row a product, ceil(log2 n) tree sums, a sum and a
// product, one after another, so one launch is a chain of ~n such steps:
// latency, unless the right-hand side is wide.  Each operation is issue-
// bound on its own warp (a K = 8 product ~6,000 cycles, a sum ~1,200,
// csrc/expansion_latency.cu).  The work beside it, n^2 m / 2 products and
// sums, against the card's 17e12 float64 operations a second (no FMA:
// -fmad=false), is ~1 ms at the widest solve of one iteration (48
// blocks of 32 rows against 384 columns).
//
// What the design does about it (rather than a block over a tile of
// columns, with a block barrier a tree level).
// A group of G lanes (a power of two, n <= 2G) solves one column: lane p
// holds the tree's leaf p (and leaf p + n/2 where n > G, added in the
// lane), so a row is one product on every lane at once, the tree's
// levels shuffles within the group, no block barrier at all; every lane
// of the group forms x_i, and the lane that holds leaf i keeps it in its
// scratch.  The wrapper takes one leaf a lane (G >= n) while the columns
// are few, for the shortest row, and two a lane (half the lanes, twice
// the columns a warp) where the columns fill the card
// (ops/expansion_kernels.py solve_lanes).  With a whole warp a column,
// x_i's product is a warp operation (csrc/expansion_warp.cuh).  Four
// warps a block; the operations keep their words in registers or the
// thread's shared-memory scratch: no local memory, no spill at any K.
//
// Above K = kThreadMaxWords = 20 every operation is a value a warp, and
// a warp operation there is slow and bound by its own chains
// (expansion_panels.cuh), so while the columns leave the card idle a
// column runs on wc warps of a thread-block cluster (solve_column_warps:
// a root warp forms each x, the leaf warps form the row's terms at once,
// the next row's that do not need the new x while it forms, and the
// tree's pairs a level at a time), which meet at the cluster's barrier
// and share the terms and X through global memory.  With two terms a
// leaf warp (wc = 1 + n / 2) a row costs two dependent products and
// log2(n) + 1 additions, not n products and n - 1 additions.  Where the
// columns fill the card (the full-width solves, bb * m in the thousands)
// a column stays on one warp, every operation one after another
// (solve_column_warp).  ops/expansion_kernels.py solve_column_warps
// picks wc from the batch and the clusters the card holds at once.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -c -Xcompiler -fPIC -DEXP_K=<K>
//        (see ops/expansion_kernels.py)

#include <cuda_runtime.h>

#include "expansion_panels.cuh"

namespace {

// Threads a block: four warps, each 32 / G right-hand-side columns.
constexpr int kThreads = 128;

// L (bb, n, n, K), B and X (bb, n, m, K), inv_d (bb, n, K): block
// b * tiles + tile solves batch element b's columns tile * cpb ...,
// cpb = 4 * 32 / G columns a block.
template <int K>
__global__ void __launch_bounds__(kThreads, 1)
    exp_solve_kernel(const double* __restrict__ L,
                     const double* __restrict__ B,
                     const double* __restrict__ inv_d, double* X, int n,
                     int m, int G, int tiles, int transpose) {
  extern __shared__ double sh[];
  const int b = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  const int cpb = (kThreads / 32) * (32 / G);
  const long nm = (long)n * m * K;
  expn::solve_block<K>(L + (long)b * n * n * K, B + b * nm,
                       inv_d + (long)b * n * K, X + b * nm, n, m, tile * cpb,
                       G, transpose != 0, sh, threadIdx.x, kThreads);
}

// Above K = kThreadMaxWords: warps a block, and blocks a cluster at
// most (the portable cluster size).  Four warps a block spread a
// column's leaf warps thinner over the SMs than eight (a product beside
// 7 busy warps takes 1.15x its time alone: csrc/expansion_latency.cu)
// and let the root warp sit in a block of its own.
constexpr int kWarps = 4;
constexpr int kMaxCluster = 8;

// Above K = kThreadMaxWords (expansion_panels.cuh solve_cluster_warp):
// wc warps a right-hand-side column, in clusters of P =
// solve_cluster_blocks(wc, kWarps) blocks, each cluster P * kWarps / wc
// columns of the bb * m; ``tree`` holds each column's terms.
// Blocks an SM holds, as many as the warps' scratch leaves room for (up
// to 8): the bound on the kernel's registers that lets them all in.
template <int K>
constexpr int solve_blocks_per_sm() {
  const long fit = 232448L / (kWarps * expn::warp::scratch_words<K>() *
                              (long)sizeof(double));
  return fit < 1 ? 1 : fit > 8 ? 8 : (int)fit;
}

template <int K>
__global__ void __launch_bounds__(kWarps * 32, solve_blocks_per_sm<K>())
    exp_solve_warps_kernel(const double* __restrict__ L,
                           const double* __restrict__ B,
                           const double* __restrict__ inv_d, double* X,
                           double* tree, int bb, int n, int m, int wc,
                           int transpose) {
  extern __shared__ double sh[];
  const int P = expn::solve_cluster_blocks(wc, kWarps);
  expn::solve_cluster_warp<K>(
      L, B, inv_d, X, tree, bb, n, m, wc, kWarps, transpose != 0,
      blockIdx.x / P, (blockIdx.x % P) * kWarps + (threadIdx.x >> 5),
      sh + (threadIdx.x >> 5) * expn::warp::scratch_words<K>(),
      threadIdx.x & 31);
}

}  // namespace

#ifndef EXP_K
#error "compile with -DEXP_K=<words per value>"
#endif
#define EXP_PASTE2(a, b) a##b
#define EXP_PASTE(a, b) EXP_PASTE2(a, b)

extern "C" {

#if EXP_K > 20
// tree: (bb, m, 2n, K) scratch of the columns' terms ((bb, m, n, K) for
// wc = 1); wc: warps a column (at most kWarps * kMaxCluster).
int EXP_PASTE(expansion_solve_warps_k, EXP_K)(const double* L,
                                              const double* B,
                                              const double* inv_d, double* X,
                                              double* tree, int bb, int n,
                                              int m, int wc, int transpose,
                                              void* stream) {
  if (bb < 1 || n < 1 || m < 1 || tree == nullptr || wc < 1 ||
      wc > kWarps * kMaxCluster || EXP_K > expn::kMaxWords)
    return (int)cudaErrorInvalidValue;
  const int P = expn::solve_cluster_blocks(wc, kWarps);
  const int cpc = P * kWarps / wc;  // columns a cluster
  const long clusters = ((long)bb * m + cpc - 1) / cpc;
  const size_t smem =
      (size_t)kWarps * expn::warp::scratch_words<EXP_K>() * sizeof(double);
  return (int)expn::launch_cluster(exp_solve_warps_kernel<EXP_K>,
                                   clusters * P, kWarps * 32, P, smem, stream,
                                   L, B, inv_d, X, tree, bb, n, m, wc,
                                   transpose);
}

// Clusters of P blocks of the kernel that the card holds at once, or a
// negative CUDA error.
int EXP_PASTE(expansion_solve_warps_clusters_k, EXP_K)(int P) {
  return expn::max_clusters(
      exp_solve_warps_kernel<EXP_K>, kWarps * 32, P,
      (size_t)kWarps * expn::warp::scratch_words<EXP_K>() * sizeof(double));
}
#else
int EXP_PASTE(expansion_solve_k, EXP_K)(const double* L, const double* B,
                                        const double* inv_d, double* X,
                                        int bb, int n, int m, int G,
                                        int transpose, void* stream) {
  if (bb < 1 || n < 1 || m < 1 || G < 1 || G > 32 || (G & (G - 1)) ||
      n > 2 * G || EXP_K > expn::kMaxWords)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      (size_t)expn::solve_smem_words<EXP_K>(kThreads) * sizeof(double);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        exp_solve_kernel<EXP_K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int cpb = (kThreads / 32) * (32 / G);
  const int tiles = (m + cpb - 1) / cpb;
  exp_solve_kernel<EXP_K><<<bb * tiles, kThreads, smem,
                            (cudaStream_t)stream>>>(L, B, inv_d, X, n, m, G,
                                                    tiles, transpose);
  return (int)cudaGetLastError();
}
#endif

}  // extern "C"
