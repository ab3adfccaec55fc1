// Batched unblocked limb Cholesky and triangular solve for Hopper (sm_90a).
//
// They replace the two Pallas TPU kernels of sdpb_tpu/ops/limb_kernels.py:
//   cholesky_unblocked_batched  (_chol_kernel/_chol_body)
//   solve_unblocked_batched     (_solve_kernel/_solve_body)
// and compute what those compute, in the same order of limb operations,
// so that the solve agrees bit for bit with the plain PyTorch version in
// sdpb_tpu_torch/ops/limb_kernels.py.
//
// What bounds them on the card: neither reads much memory (an n = 32,
// S = 47 factor is 188 KB, read once), so the limit is the limb arithmetic
// itself: each MP multiply is ~L^2/2 float multiply-adds plus three carry
// passes, run per element with its working arrays in thread-local memory
// (L1-resident).  The TPU kept an (n, tm, S) tile of ~770 KB in VMEM; an
// SM has at most 227 KB of shared memory, so this first design keeps the
// working matrix in the output buffer in global memory (L2-resident at
// these sizes), one thread block per matrix (Cholesky) or per
// (matrix, rhs tile) (solve), with threads over the matrix entries.  The
// Cholesky pivot's sqrt/rsqrt runs on one thread while the others wait:
// that serial chain is the kernel's critical path.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC   (see ops/limb_kernels.py)

#include <cuda_runtime.h>

#include "limb.cuh"

namespace {

constexpr int kThreads = 256;

// One block per matrix; the factor is built in place in `out`.
__global__ void chol_kernel(const float* __restrict__ a, float* out, int n,
                            int S, int steps) {
  extern __shared__ float sh[];
  float* d = sh;              // pivot sqrt      (S)
  float* dinv = sh + S;       // pivot rsqrt     (S)
  float* col = sh + 2 * S;    // scaled column   (n * S)
  const int L = S - 1;
  const long base = (long)blockIdx.x * n * n * S;
  const float* A = a + base;
  float* O = out + base;
  for (int i = threadIdx.x; i < n * n * S; i += blockDim.x) O[i] = A[i];
  __syncthreads();
  for (int j = 0; j < n; ++j) {
    if (threadIdx.x == 0) limb::sqrt_rsqrt(O + (j * n + j) * S, d, dinv, L,
                                           steps);
    __syncthreads();
    for (int r = threadIdx.x; r < n; r += blockDim.x) {
      float* cell = O + (r * n + j) * S;
      float* c = col + r * S;
      if (r > j) {
        limb::mul(cell, dinv, c, L);
      } else if (r == j) {
        limb::copy(d, c, S);
      } else {
        limb::fill(c, S, 0.0f);
      }
      limb::copy(c, cell, S);
    }
    __syncthreads();
    // every entry takes the add, as in the reference (masked entries add
    // an exact zero, which renormalizes them)
    for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x) {
      int r = idx / n, c = idx % n;
      float upd[limb::kMaxSlots], res[limb::kMaxSlots];
      if (r > j && c > j) {
        limb::mul(col + r * S, col + c * S, upd, L);
        limb::negate(upd, S);
      } else {
        limb::fill(upd, S, 0.0f);
      }
      limb::add(O + idx * S, upd, res, L);
      limb::copy(res, O + idx * S, S);
    }
    __syncthreads();
  }
  for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x) {
    if (idx / n < idx % n) limb::fill(O + idx * S, S, 0.0f);
  }
}

// One block per (matrix, rhs tile of tm columns).  `out` doubles as the
// substitution state: row i is final once step i has written x_i, and
// only the rows still pending take updates.
__global__ void solve_kernel(const float* __restrict__ l,
                             const float* __restrict__ b,
                             const float* __restrict__ inv_d, float* out,
                             int n, int m, int S, int tm, int transpose) {
  extern __shared__ float xs[];   // x_i for the tile's columns (tm * S)
  const int L = S - 1;
  const int bb = blockIdx.x;
  const int c0 = blockIdx.y * tm;
  const int tw = min(tm, m - c0);
  const float* Lm = l + (long)bb * n * n * S;
  const float* D = inv_d + (long)bb * n * S;
  const float* Bm = b + (long)bb * n * m * S;
  float* O = out + (long)bb * n * m * S;
  for (int idx = threadIdx.x; idx < n * tw * S; idx += blockDim.x) {
    int r = idx / (tw * S), rest = idx % (tw * S);
    long off = ((long)r * m + c0) * S + rest;
    O[off] = Bm[off];
  }
  __syncthreads();
  for (int t = 0; t < n; ++t) {
    const int i = transpose ? n - 1 - t : t;
    for (int c = threadIdx.x; c < tw; c += blockDim.x) {
      float* cell = O + ((long)i * m + c0 + c) * S;
      limb::mul(cell, D + i * S, xs + c * S, L);
      limb::copy(xs + c * S, cell, S);
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < n * tw; idx += blockDim.x) {
      int r = idx / tw, c = idx % tw;
      if (transpose ? (r >= i) : (r <= i)) continue;
      const float* lc = transpose ? Lm + (i * n + r) * S : Lm + (r * n + i) * S;
      float upd[limb::kMaxSlots], res[limb::kMaxSlots];
      limb::mul(lc, xs + c * S, upd, L);
      limb::negate(upd, S);
      float* cell = O + ((long)r * m + c0 + c) * S;
      limb::add(cell, upd, res, L);
      limb::copy(res, cell, S);
    }
    __syncthreads();
  }
}

int set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

extern "C" {

int limb_max_slots() { return limb::kMaxSlots; }

int chol_unblocked_launch(const float* a, float* out, int bb, int n, int S,
                          int steps, void* stream) {
  size_t smem = (size_t)(n + 2) * S * sizeof(float);
  int err = set_smem((const void*)chol_kernel, smem);
  if (err != cudaSuccess) return err;
  chol_kernel<<<bb, kThreads, smem, (cudaStream_t)stream>>>(a, out, n, S,
                                                            steps);
  return (int)cudaGetLastError();
}

int solve_unblocked_launch(const float* l, const float* b, const float* inv_d,
                           float* out, int bb, int n, int m, int S, int tm,
                           int transpose, void* stream) {
  size_t smem = (size_t)tm * S * sizeof(float);
  int err = set_smem((const void*)solve_kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(bb, (m + tm - 1) / tm);
  solve_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      l, b, inv_d, out, n, m, S, tm, transpose);
  return (int)cudaGetLastError();
}

}  // extern "C"
