// Batched unblocked limb Cholesky for Hopper (sm_90a), one MP operation
// per warp (limb_warp.cuh).
//
// It replaces the Pallas TPU kernel cholesky_unblocked_batched of
// sdpb_tpu/ops/limb_kernels.py (pallas_call at :251, _chol_body :211)
// and computes what that computes, in the same order of limb operations,
// so that it agrees bit for bit with its plain PyTorch version
// (sdpb_tpu_torch/ops/limb_kernels.py::cholesky_unblocked_plain).
//
// What bounds it on this card.  It moves little memory (an n = 32,
// S = 47 matrix is 188 KB, read once); it is a chain of n pivots, each a
// sqrt/rsqrt of ~21 dependent limb products (Newton steps), and between
// two pivots a column scale and a rank-1 update of n^2/2 entries.  A
// limb product is ~L^2/2 exact float multiply-adds plus three carry
// passes and a renormalization, so the time is the pivot chain's latency
// plus whatever of the update does not overlap it.
//
// What the design does about it.  One block per matrix; the factor is
// built in place in `out` (L2-resident) and the scaled column sits in
// shared memory.  Every MP operation runs on one warp (limb_warp.cuh),
// which cuts the chain of one product by about the width of a warp.  The
// column scale takes one warp per row, the trailing update one warp per
// entry of the lower triangle only (nothing reads the upper one, which
// the end zeroes).  Look-ahead: in the update for column j, warp 0 first
// updates the next diagonal entry and runs the next pivot's sqrt/rsqrt
// while the other warps finish the trailing block, so the pivot chain
// overlaps the update.  The plain version adds a masked zero to every
// entry at every step, which renormalizes finished entries; here each
// entry of column k takes its n - k zero additions in one pass at the
// end, stopping as soon as one more would leave it unchanged.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -c -Xcompiler -fPIC   (see ops/limb_kernels.py)

#include <cuda_runtime.h>

#include "limb_warp.cuh"

namespace {

using limbw::Ctx;
using limbw::V;

// Shared memory of one block, in floats: the scaled column (n S), the
// pivot's sqrt and rsqrt (2 S), the warps' scratch rows.  Mirrored by
// ops/limb_kernels.py::chol_geometry.
__host__ __device__ int chol_smem_floats(int n, int S, int W) {
  return n * S + 2 * S + W * limbw::scratch_floats(limbw::regs_for(S));
}

// sqrt and rsqrt of a pivot into piv[0, S) and piv[S, 2S).
template <int R>
__device__ __forceinline__ void pivot(const V<R>& a, float* piv, int steps,
                                      const Ctx& c) {
  V<R> s, y;
  limbw::sqrt_rsqrt(a, s, y, steps, c);
  limbw::store(piv, s, c);
  limbw::store(piv + c.S, y, c);
}

template <int R, int W>
__global__ void __launch_bounds__(W * 32, 1)
    chol_warp_kernel(const float* __restrict__ a, float* out, int n, int S,
                     int steps) {
  extern __shared__ float sh[];
  float* col = sh;               // scaled column j, before its zero adds
  float* piv = sh + n * S;       // the pivot's sqrt and rsqrt
  const Ctx c = limbw::warp_ctx<R>(piv + 2 * S, S);
  const int warp = threadIdx.x >> 5;
  const long base = (long)blockIdx.x * n * n * S;
  const float* A = a + base;
  float* O = out + base;
  for (int i = threadIdx.x; i < n * n * S; i += W * 32) O[i] = A[i];
  __syncthreads();
  if (warp == 0) pivot(limbw::load<R>(O, c), piv, steps, c);
  __syncthreads();
  for (int j = 0; j < n; ++j) {
    for (int r = j + warp; r < n; r += W) {
      float* cell = O + ((long)r * n + j) * S;
      V<R> x;
      if (r == j) {
        x = limbw::load<R>(piv, c);
      } else {
        x = limbw::mul(limbw::load<R>(cell, c), limbw::load<R>(piv + S, c), c);
      }
      limbw::store(col + r * S, x, c);
      limbw::store(cell, x, c);
    }
    __syncthreads();
    const int j1 = j + 1;
    if (j1 == n) break;
    if (warp == 0) {
      // look-ahead: the next diagonal entry, then the next pivot
      float* cell = O + ((long)j1 * n + j1) * S;
      const V<R> x = limbw::sub_product<R>(cell, col + j1 * S, col + j1 * S,
                                           c);
      limbw::store(cell, x, c);
      pivot(x, piv, steps, c);
    } else {
      // the rest of the trailing lower triangle, column-major over the
      // m x m block, entry (0, 0) being the diagonal that warp 0 took
      const int m = n - j1;
      int rr = 0, cc = 0, step = warp;
      while (true) {
        rr += step;
        while (rr >= m && cc < m) {
          const int over = rr - m;
          ++cc;
          rr = cc + over;
        }
        if (cc >= m) break;
        const int r = j1 + rr, k = j1 + cc;
        float* cell = O + ((long)r * n + k) * S;
        limbw::store(
            cell, limbw::sub_product<R>(cell, col + r * S, col + k * S, c), c);
        step = W - 1;
      }
    }
    __syncthreads();
  }
  // Entry (r, k) of the lower triangle takes n - k zero additions (one
  // per step from its column's on); the upper triangle is zeroed.
  const V<R> zero = limbw::zero_value<R>();
  for (int idx = warp; idx < n * n; idx += W) {
    const int r = idx / n, k = idx % n;
    float* cell = O + (long)idx * S;
    if (r < k) {
      limbw::store(cell, zero, c);
      continue;
    }
    V<R> x = limbw::load<R>(cell, c);
    for (int t = 0; t < n - k; ++t) {
      const V<R> y = limbw::add(x, zero, c);
      if (limbw::same_bits(x, y)) break;
      x = y;
    }
    limbw::store(cell, x, c);
  }
}

template <int R, int W>
int launch(const float* a, float* out, int bb, int n, int S, int steps,
           cudaStream_t stream) {
  const size_t smem = (size_t)chol_smem_floats(n, S, W) * sizeof(float);
  if (smem > 48 * 1024) {
    const int err = cudaFuncSetAttribute(
        chol_warp_kernel<R, W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  chol_warp_kernel<R, W><<<bb, W * 32, smem, stream>>>(a, out, n, S, steps);
  return (int)cudaGetLastError();
}

// Warps per block by the registers R of one value: the pivot's code sets
// the register budget, and __launch_bounds__(W * 32, 1) leaves 65536 /
// (32 W) registers a lane (at most 255).  Mirrored by
// ops/limb_kernels.py::CHOL_WARPS.
constexpr int chol_warps(int R) { return R == 1 ? 32 : (R <= 3 ? 16 : 8); }

}  // namespace

// The unit is compiled once for each R of its slot class (-DLIMB_R=R),
// so that the instantiations build in parallel; each object exports the
// launcher chol_unblocked_launch_r<R>, and the object of the class's
// lowest R also the class's entry points (-DLIMB_CLASS_ENTRIES).
#ifndef LIMB_R
#error "compile with -DLIMB_R=<registers per value>"
#endif
#define LIMB_PASTE2(a, b) a##b
#define LIMB_PASTE(a, b) LIMB_PASTE2(a, b)

extern "C" {

int LIMB_PASTE(chol_unblocked_launch_r, LIMB_R)(const float* a, float* out,
                                                 int bb, int n, int S,
                                                 int steps, int warps,
                                                 void* stream) {
  if (S < limb::kMinSlots || S > limb::kMaxSlots ||
      limbw::regs_for(S) != LIMB_R || warps != chol_warps(LIMB_R))
    return (int)cudaErrorInvalidValue;
  return launch<LIMB_R, chol_warps(LIMB_R)>(a, out, bb, n, S, steps,
                                            (cudaStream_t)stream);
}

#ifdef LIMB_CLASS_ENTRIES
int limb_min_slots() { return limb::kMinSlots; }

int limb_max_slots() { return limb::kMaxSlots; }

int limb_chol_warps(int S) { return chol_warps(limbw::regs_for(S)); }

int limb_chol_smem_bytes(int n, int S, int warps) {
  return chol_smem_floats(n, S, warps) * (int)sizeof(float);
}
#endif

}  // extern "C"
