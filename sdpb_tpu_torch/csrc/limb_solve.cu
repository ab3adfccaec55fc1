// Batched unblocked limb triangular solve for Hopper (sm_90a), one MP
// operation per warp (limb_warp.cuh).
//
// It replaces the Pallas TPU kernel solve_unblocked_batched of
// sdpb_tpu/ops/limb_kernels.py (pallas_call at :180, _solve_body :121):
// X = L^-1 B (or L^-T B) by right-looking substitution, in the same
// order of limb operations, so that it agrees bit for bit with its plain
// PyTorch version (ops/limb_kernels.py::solve_unblocked_plain).
//
// What bounds it on this card.  It moves little memory (L and a tile of
// B are read once); it is n dependent steps, each one limb product per
// column of B for x_i and one product and one addition per pending
// (row, column) entry, all independent within the step.  So its time
// is the throughput of that limb arithmetic across the card, plus the
// latency of the n steps where there are too few entries to fill it.
//
// What the design does about it.  One block per (matrix, tile of tm
// columns of B); the tile width (at most 4 columns) is chosen in Python
// (ops/limb_kernels.py::solve_geometry) so that the grid has at least
// two blocks per SM of the card's 132 wherever m allows.  `out` is the
// substitution state.  Step i computes x_i for the tile's columns (one
// warp per column) into shared memory and stages L's column i (row i,
// transposed) there once for the whole tile; then one warp per pending
// (row, column) entry does its mul + add with both operands read from
// shared memory and its cell read coalesced from `out` (L2-resident).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -c -Xcompiler -fPIC   (see ops/limb_kernels.py)

#include <cuda_runtime.h>

#include "limb_warp.cuh"

namespace {

using limbw::Ctx;
using limbw::V;

// Shared memory of one block, in floats: x_i of the tile (tm S), L's
// column i (n S), the warps' scratch rows.  Mirrored by
// ops/limb_kernels.py::solve_geometry.
__host__ __device__ int solve_smem_floats(int n, int tm, int S, int W) {
  return tm * S + n * S + W * limbw::scratch_floats(limbw::regs_for(S));
}

// Blocks per SM by the registers R of one value: four (at most 64
// registers a thread) up to R = 5, where the kernel is throughput-bound
// and wants the warps more than the registers; fewer for the larger
// values of the higher slot classes, so that they do not spill.
constexpr int solve_blocks_per_sm(int R) {
  return R <= 5 ? 4 : (R <= 9 ? 2 : 1);
}

template <int R, int W>
__global__ void __launch_bounds__(W * 32, solve_blocks_per_sm(R))
    solve_warp_kernel(const float* __restrict__ l, const float* __restrict__ b,
                      const float* __restrict__ inv_d, float* out, int n,
                      int m, int S, int tm, int transpose) {
  extern __shared__ float sh[];
  float* xs = sh;                // x_i of the tile's columns
  float* lc = sh + tm * S;       // L[:, i] (L[i, :] transposed), by row
  const Ctx c = limbw::warp_ctx<R>(lc + n * S, S);
  const int warp = threadIdx.x >> 5;
  const int c0 = blockIdx.y * tm;
  const int tw = min(tm, m - c0);
  const float* Lm = l + (long)blockIdx.x * n * n * S;
  const float* D = inv_d + (long)blockIdx.x * n * S;
  const float* Bm = b + (long)blockIdx.x * n * m * S;
  float* O = out + (long)blockIdx.x * n * m * S;
  for (int idx = threadIdx.x; idx < n * tw * S; idx += W * 32) {
    const int r = idx / (tw * S), rest = idx % (tw * S);
    const long off = ((long)r * m + c0) * S + rest;
    O[off] = Bm[off];
  }
  __syncthreads();
  for (int t = 0; t < n; ++t) {
    const int i = transpose ? n - 1 - t : t;
    for (int k = warp; k < tw; k += W) {
      float* cell = O + ((long)i * m + c0 + k) * S;
      const V<R> x = limbw::mul(limbw::load<R>(cell, c),
                                limbw::load<R>(D + i * S, c), c);
      limbw::store(xs + k * S, x, c);
      limbw::store(cell, x, c);
    }
    const int r0 = transpose ? 0 : i + 1;
    const int np = transpose ? i : n - 1 - i;
    for (int idx = threadIdx.x; idx < np * S; idx += W * 32) {
      const int r = r0 + idx / S, s = idx % S;
      lc[r * S + s] = transpose ? Lm[((long)i * n + r) * S + s]
                                : Lm[((long)r * n + i) * S + s];
    }
    __syncthreads();
    for (int e = warp; e < np * tw; e += W) {
      const int r = r0 + e / tw, k = e % tw;
      float* cell = O + ((long)r * m + c0 + k) * S;
      limbw::store(
          cell, limbw::sub_product<R>(cell, lc + r * S, xs + k * S, c), c);
    }
    __syncthreads();
  }
}

template <int R, int W>
int launch(const float* l, const float* b, const float* inv_d, float* out,
           int bb, int n, int m, int S, int tm, int transpose,
           cudaStream_t stream) {
  const size_t smem = (size_t)solve_smem_floats(n, tm, S, W) * sizeof(float);
  if (smem > 48 * 1024) {
    const int err = cudaFuncSetAttribute(
        solve_warp_kernel<R, W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(bb, (m + tm - 1) / tm);
  solve_warp_kernel<R, W><<<grid, W * 32, smem, stream>>>(
      l, b, inv_d, out, n, m, S, tm, transpose);
  return (int)cudaGetLastError();
}

// Eight warps a block; ops/limb_kernels.py::SOLVE_WARPS.
constexpr int kSolveWarps = 8;

}  // namespace

// One object per R of the slot class, as in limb_chol.cu.
#ifndef LIMB_R
#error "compile with -DLIMB_R=<registers per value>"
#endif
#define LIMB_PASTE2(a, b) a##b
#define LIMB_PASTE(a, b) LIMB_PASTE2(a, b)

extern "C" {

int LIMB_PASTE(solve_unblocked_launch_r, LIMB_R)(
    const float* l, const float* b, const float* inv_d, float* out, int bb,
    int n, int m, int S, int tm, int transpose, int warps, void* stream) {
  if (S < limb::kMinSlots || S > limb::kMaxSlots ||
      limbw::regs_for(S) != LIMB_R || warps != kSolveWarps)
    return (int)cudaErrorInvalidValue;
  return launch<LIMB_R, kSolveWarps>(l, b, inv_d, out, bb, n, m, S, tm,
                                     transpose, (cudaStream_t)stream);
}

#ifdef LIMB_CLASS_ENTRIES
int limb_solve_smem_bytes(int n, int tm, int S, int warps) {
  return solve_smem_floats(n, tm, S, warps) * (int)sizeof(float);
}
#endif

}  // extern "C"
