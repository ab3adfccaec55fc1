// The float64-expansion Cholesky column loop for Hopper (sm_90a): one
// launch runs every column step of a panel (csrc/expansion_panels.cuh
// chol_panel_block).
//
// It replaces the JAX package's column loops of the expansion
// Cholesky, which XLA compiles into one program:
// sdpb_tpu/mp/linalg.py:207-237 (_cholesky_unblocked, n <= 64) and
// :318-340 (col_step and panel_step of cholesky, the 32 columns of a
// panel).  Written as PyTorch tensor code the loop takes ~45 launches
// a column, and the host's launch cost, not the card, set the time.
//
// What bounds it on this card.  Each step's pivot is a chain of ~30
// dependent expansion operations (the next pivot's last update, then
// sqrt_rsqrt: newton_steps(K) Newton steps of three products and two
// sums, the Heron correction), and a renormalization inside each is two
// chains of dependent float64 additions whose order the bits fix
// (VecSum, then VecSumErrBranch: 78 + 78 links for a K = 8 product, 438 +
// 438 at K = 20, 8.4 cycles a link).  So a panel is ~32 such chains in a
// row: latency, milliseconds.  The trailing update beside it, ~W^2 R / 2
// products and sums, is 0.01-0.2 ms of the card's float64 rate (no FMA:
// -fmad=false).
//
// What the design does about it.
// - The pivot runs on a warp (warp 0), as a short program of warp
//   operations (csrc/expansion_warp.cuh) on K-word slots in shared
//   memory: the partial products, the merge and VecSum's errors spread
//   over the lanes, the two chains run once, their words read from
//   shared memory ahead of the links that take them.
// - Look-ahead: in step t the pivot warp forms pivot t + 1 from row
//   t + 1's two entries while the other three warps (an update thread a
//   row) form step t's multipliers and the rest of step t's update.  One
//   block barrier a step hands the pivot over; a named barrier orders the
//   update threads' multipliers before their update.  A step takes
//   max(pivot chain, update) instead of their sum.
// - Every operation keeps its words in registers or in the thread's
//   shared-memory scratch, with compile-time indices
//   (csrc/expansion_regs.cuh): no local memory, no spill at any K.
// A block takes one batch element's pivot block and up to ``rt`` rows
// below it, W + rt <= 96 (ops/expansion_kernels.py chol_row_tile); the
// blocks of a tall panel (the Q factor's: batch 1, up to 384 rows) each
// compute the pivot chain again on a private copy of the pivot block (in
// ``scratch``), so that its rows spread over the card and no block waits
// for another.  Above K = 8 the renormalizations' chains run in loops of
// 8 links and a thread's product streams over its levels, which keeps
// the registers and the build's time in bounds.
//
// Above K = kThreadMaxWords = 20 (--precision 1061 .. 2862: K = 21 ..
// 54) every operation is a value a warp (expansion_panels.cuh
// chol_panel_cluster), and a warp operation there is slow (a product at
// K = 54 runs two chains over 3,023 words) and holds 6.2-27.5 KB of
// shared memory, so a few fit on an SM.  A step's update, ~(R - t)(W - t)
// products and additions, is then spread over the card: a panel (or a
// row tile of a tall one) runs on a thread-block cluster of P blocks of
// kWarps warps, the pivot warp and the update warps, P the largest power
// of two up to 8 with which all the batch's clusters run at once
// (ops/expansion_kernels.py chol_cluster_blocks, from
// cudaOccupancyMaxActiveClusters); from P = 4 up the pivot warp's block
// takes no update, so that the pivot chain runs alone on its SM (the
// block's other warps exit).  The warps share
// the panel, the multipliers and the pivots through global memory and
// meet at the cluster's barrier twice a step (barrier.cluster, chosen
// over a per-step flag in global memory): a cluster's blocks are resident
// together, so no block spins on one that has yet to start, and the
// hardware barrier is short beside a step's 34-39 dependent warp
// operations.  Another block's shared memory (distributed shared memory)
// was not needed: the L2 round trip it would save is small beside a warp
// operation, and every block's shared memory goes to its warps' scratch.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -c -Xcompiler -fPIC -DEXP_K=<K>
//        (see ops/expansion_kernels.py)

#include <cuda_runtime.h>

#include "expansion_panels.cuh"

namespace {

// Threads a block: the pivot warp and three warps of update threads,
// one row of the block each (so a block takes at most 96 rows).  The
// bound's one block an SM lets ptxas give each thread the registers
// that the in-register operations need.
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

// Above K = kThreadMaxWords: warps a block, and blocks a cluster at
// most (the portable cluster size).
constexpr int kWarps = 8;
constexpr int kMaxCluster = 8;

// Clusters of P blocks (expansion_panels.cuh chol_cluster_warp: cluster
// b * tiles + tile takes batch element b's pivot block and rows
// W + tile * rt ... of at most rt rows).  One block an SM: a block's
// 8 warps keep up to 255 registers a thread, and at K = 54 their scratch
// is all of the SM's shared memory.  out, scratch and share pass between
// the cluster's blocks (no __restrict__).
template <int K>
__global__ void __launch_bounds__(kWarps * 32, 1)
    exp_chol_warps_kernel(const double* __restrict__ in, double* out,
                          double* scratch, double* share, int R, int W,
                          int tiles, int rt, int P) {
  extern __shared__ double sh[];
  expn::chol_cluster_warp<K>(in, out, scratch, share, R, W, tiles, rt, P,
                             kWarps, blockIdx.x / P,
                             (blockIdx.x % P) * kWarps + (threadIdx.x >> 5),
                             sh, threadIdx.x & 31);
}

}  // namespace

#ifndef EXP_K
#error "compile with -DEXP_K=<words per value>"
#endif
#define EXP_PASTE2(a, b) a##b
#define EXP_PASTE(a, b) EXP_PASTE2(a, b)

extern "C" {

#if EXP_K > 20
// share: (bb * tiles, chol_cluster_share_words(W + rt)) doubles; P:
// blocks a cluster.
int EXP_PASTE(expansion_chol_warps_k, EXP_K)(const double* in, double* out,
                                             double* scratch, double* share,
                                             int bb, int R, int W, int tiles,
                                             int rt, int P, void* stream) {
  if (bb < 1 || W < 1 || R < W || tiles < 1 || rt < 1 ||
      (tiles > 1 && scratch == nullptr) || share == nullptr || P < 1 ||
      P > kMaxCluster || EXP_K > expn::kMaxWords)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      (size_t)expn::chol_cluster_smem_words<EXP_K>(kWarps) * sizeof(double);
  return (int)expn::launch_cluster(exp_chol_warps_kernel<EXP_K>,
                                   (long)bb * tiles * P, kWarps * 32, P, smem,
                                   stream, in, out, scratch, share, R, W,
                                   tiles, rt, P);
}

// Clusters of P blocks of the kernel that the card holds at once, or a
// negative CUDA error.
int EXP_PASTE(expansion_chol_warps_clusters_k, EXP_K)(int P) {
  return expn::max_clusters(
      exp_chol_warps_kernel<EXP_K>, kWarps * 32, P,
      (size_t)expn::chol_cluster_smem_words<EXP_K>(kWarps) * sizeof(double));
}
#else
int EXP_PASTE(expansion_chol_k, EXP_K)(const double* in, double* out,
                                       double* scratch, int bb, int R, int W,
                                       int tiles, int rt, void* stream) {
  if (bb < 1 || W < 1 || R < W || tiles < 1 || rt < 1 ||
      W + (R > W ? rt : 0) > kThreads - 32 ||
      (tiles > 1 && scratch == nullptr) || EXP_K > expn::kMaxWords)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)expn::chol_smem_words<EXP_K>(
                          W + (R > W ? rt : 0), kThreads) * sizeof(double);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        exp_chol_kernel<EXP_K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  exp_chol_kernel<EXP_K><<<bb * tiles, kThreads, smem,
                           (cudaStream_t)stream>>>(in, out, scratch, R, W,
                                                   tiles, rt);
  return (int)cudaGetLastError();
}
#endif

}  // extern "C"
