// Elementwise float64-expansion add, mul, div, add_f64 and mul_f64 for
// Hopper (sm_90a): one launch per MP operation, in one of two designs,
// a value a thread or a value a warp (csrc/expansion_elementwise.cuh).
//
// On the TPU these are XLA fusions of sdpb_tpu/mp/core.py (add :422,
// add_f64 :446, mul :487, mul_f64 :516, div :558), not Pallas kernels:
// the JAX package runs expansions on the CPU, where one fused op is one
// loop.  Written as PyTorch tensor code (sdpb_tpu_torch/mp/core.py
// add_plain ...), one expansion product at K = 8 is some 700 launches
// of tiny kernels, so the solver would be bound by launch overhead.
// Each kernel here agrees bit for bit with that plain version: the same
// float64 operations in the same order.
//
// What bounds them on this card.  An addition at K words moves 3 K
// float64 words and does ~30 K float64 operations (the merge network,
// a 2K-link two_sum chain, the emit); a product does ~K^2/2 two_prods
// (17 operations each) and a ~K^2-link chain; a division is K + 1
// dependent steps of a scalar product and an addition.  Against the
// card's 3.35 TB/s and 17e12 float64 operations a second (no FMA) these
// are operation-bound above K ~ 4, and every chain is a sequence of
// dependent float64 operations: latency, unless many values run at
// once.
//
// What the design does about it.
// - A value a thread (K <= kThreadMaxWords = 20), for batches that fill
//   the card: the words live in registers (csrc/expansion_regs.cuh; a
//   product above K = 8 streams its levels through the thread's
//   shared-memory scratch), nothing goes to local memory, and the
//   block's K x 128 input words are staged through shared memory, so
//   that the global loads and stores are coalesced.
// - A value a warp (K >= 3, any K up to kMaxWords = 54), for batches too
//   small to fill the card and for every batch above K = 20: the partial
//   products, the merge network and the errors spread over the lanes
//   and the renormalization's two chains run once (csrc/
//   expansion_warp.cuh; above K = 20 a product streams its levels and
//   keeps only VecSum's partial sums).  4,096 values are 4,096 warps
//   over the 132 SMs, where a thread each they fill 32 blocks.
// ops/expansion_kernels.py picks the design from the batch and K
// (WARP_MAX_VALUES).  A single value broadcast over the batch is read in
// place (batch stride 0); both designs loop over the batch by the grid's
// stride, so any grid covers it.  The unit is built once per K
// (-DEXP_K), so every loop bound is a constant.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -c -Xcompiler -fPIC -DEXP_K=<K>
//        (see ops/expansion_kernels.py)

#include <cuda_runtime.h>

#include "expansion_elementwise.cuh"

namespace {

// Threads a block of the value-a-thread design, and warps a block of
// the value-a-warp design (ops/expansion_kernels.py EXPANSION_THREADS,
// EXPANSION_WARPS).
constexpr int kThreads = 128;
constexpr int kWarps = 4;

template <int K, int OP>
__global__ void __launch_bounds__(kThreads)
    exp_thread_kernel(const double* __restrict__ a, long sa,
                      const double* __restrict__ b, long sb,
                      double* __restrict__ out, long n) {
  extern __shared__ double sh[];
  expn::ew::thread_values<K, OP>(a, sa, b, sb, out, n,
                                 (long)blockIdx.x * kThreads,
                                 (long)gridDim.x * kThreads, sh, threadIdx.x,
                                 kThreads);
}

template <int K, int OP>
__global__ void __launch_bounds__(kWarps * 32)
    exp_warp_kernel(const double* __restrict__ a, long sa,
                    const double* __restrict__ b, long sb,
                    double* __restrict__ out, long n) {
  extern __shared__ double sh[];
  const int w = threadIdx.x >> 5;
  expn::ew::warp_values<K, OP>(a, sa, b, sb, out, n,
                               (long)blockIdx.x * kWarps + w,
                               (long)gridDim.x * kWarps,
                               sh + w * expn::ew::warp_words<K, OP>(),
                               threadIdx.x & 31);
}

// ``ready``: the kernel's shared-memory limit is raised (once).
template <class Kernel>
int launch(Kernel kernel, bool& ready, size_t smem, int blocks, int threads,
           const double* a, long sa, const double* b, long sb, double* out,
           long n, cudaStream_t stream) {
  if (!ready && smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  ready = true;
  kernel<<<blocks, threads, smem, stream>>>(a, sa, b, sb, out, n);
  return (int)cudaGetLastError();
}

template <int K, int OP>
int launch_op(const double* a, long sa, const double* b, long sb,
              double* out, long n, int warp, int blocks,
              cudaStream_t stream) {
  static bool ready_warp = false, ready_thread = false;
  if (warp) {
    if constexpr (K >= 3) {
      const size_t smem =
          (size_t)kWarps * expn::ew::warp_words<K, OP>() * sizeof(double);
      return launch(exp_warp_kernel<K, OP>, ready_warp, smem, blocks,
                    kWarps * 32, a, sa, b, sb, out, n, stream);
    }
  } else {
    if constexpr (K <= expn::kThreadMaxWords) {
      const size_t smem =
          (size_t)expn::ew::thread_smem_words<K, OP>(kThreads) *
          sizeof(double);
      return launch(exp_thread_kernel<K, OP>, ready_thread, smem, blocks,
                    kThreads, a, sa, b, sb, out, n, stream);
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

#ifndef EXP_K
#error "compile with -DEXP_K=<words per value>"
#endif
#define EXP_PASTE2(a, b) a##b
#define EXP_PASTE(a, b) EXP_PASTE2(a, b)

extern "C" {

// op: 0 add, 1 mul, 2 div, 3 add_f64, 4 mul_f64; warp: 0 a value a
// thread, 1 a value a warp.
int EXP_PASTE(expansion_launch_k, EXP_K)(const double* a, long sa,
                                         const double* b, long sb,
                                         double* out, long n, int op,
                                         int warp, int blocks,
                                         void* stream) {
  if (blocks < 1 || n < 1 || EXP_K > expn::kMaxWords)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (op) {
    case 0:
      return launch_op<EXP_K, 0>(a, sa, b, sb, out, n, warp, blocks, s);
    case 1:
      return launch_op<EXP_K, 1>(a, sa, b, sb, out, n, warp, blocks, s);
    case 2:
      return launch_op<EXP_K, 2>(a, sa, b, sb, out, n, warp, blocks, s);
    case 3:
      return launch_op<EXP_K, 3>(a, sa, b, sb, out, n, warp, blocks, s);
    case 4:
      return launch_op<EXP_K, 4>(a, sa, b, sb, out, n, warp, blocks, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

#ifdef EXP_CLASS_ENTRIES
int expansion_max_words() { return expn::kMaxWords; }
int expansion_thread_max_words() { return expn::kThreadMaxWords; }
int expansion_threads() { return kThreads; }
int expansion_warps() { return kWarps; }
#endif

}  // extern "C"
