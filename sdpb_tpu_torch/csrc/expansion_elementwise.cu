// Elementwise float64-expansion add, mul, div, add_f64 and mul_f64 for
// Hopper (sm_90a): one launch per MP operation, one MP value per thread
// (csrc/expansion.cuh).
//
// On the TPU these are XLA fusions of sdpb_tpu/mp/core.py (add :422,
// add_f64 :446, mul :487, mul_f64 :516, div :558), not Pallas kernels:
// the JAX package runs expansions on the CPU, where one fused op is one
// loop.  Written as PyTorch tensor code (sdpb_tpu_torch/mp/core.py
// add_plain ...), one expansion product at K = 8 is some 700 launches
// of tiny kernels (a two_prod grid, a gather, a 79-link two_sum chain
// and a 78-step predicated emit), so the solver would be bound by
// launch overhead.  Each kernel here agrees bit for bit with that plain
// version: the same float64 operations in the same order.
//
// What bounds them on this card.  An addition at K words moves 3 K
// float64 words and does ~30 K float64 operations (the merge network,
// a 2K-link two_sum chain, the emit); a product does ~K^2/2 two_prods
// (17 operations each) and a ~K^2-link chain; a division is K + 1
// dependent steps of a scalar product and an addition.  Against the
// card's 3.35 TB/s and 34 TFLOP/s of float64 outside the tensor cores
// these are operation-bound above K ~ 4, and every chain is a sequence
// of dependent float64 operations: latency, unless many values run at
// once.
//
// What the design does about it.  One thread holds one value; its
// words, the merge buffer and the level-ordered partial products live
// in registers and thread-local memory (a chain of up to 439 terms at
// K = 20), so nothing crosses threads and the grid has a thread for
// every value (128 threads a block; a grid-stride loop takes any
// smaller grid).  The unit is built once per K (-DEXP_K), so every loop
// bound is a constant.  A single value broadcast over the batch is read
// in place (batch stride 0).  The loads are strided by K words between
// threads; staging through shared memory is left to a later redesign.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -c -Xcompiler -fPIC -DEXP_K=<K>
//        (see ops/expansion_kernels.py)

#include <cuda_runtime.h>

#include "expansion.cuh"

namespace {

// Threads a block (ops/expansion_kernels.py EXPANSION_THREADS).
constexpr int kThreads = 128;

// op: 0 add, 1 mul, 2 div (b an expansion); 3 add_f64, 4 mul_f64 (b a
// float64 value a thread).  Value i of a is at a + i sa (sa = K, or 0
// for one value broadcast over the batch); b likewise (sb = K or 0 for
// expansions, 1 or 0 for floats); out is (n, K).
template <int K, int OP>
__global__ void __launch_bounds__(kThreads)
    expansion_kernel(const double* __restrict__ a, long sa,
                     const double* __restrict__ b, long sb,
                     double* __restrict__ out, long n) {
  for (long i = (long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (long)gridDim.x * kThreads) {
    expn::apply<K, OP>(a + i * sa, b + i * sb, out + i * K);
  }
}

template <int K, int OP>
int launch_op(const double* a, long sa, const double* b, long sb,
              double* out, long n, int blocks, cudaStream_t stream) {
  expansion_kernel<K, OP><<<blocks, kThreads, 0, stream>>>(a, sa, b, sb,
                                                           out, n);
  return (int)cudaGetLastError();
}

}  // namespace

#ifndef EXP_K
#error "compile with -DEXP_K=<words per value>"
#endif
#define EXP_PASTE2(a, b) a##b
#define EXP_PASTE(a, b) EXP_PASTE2(a, b)

extern "C" {

int EXP_PASTE(expansion_launch_k, EXP_K)(const double* a, long sa,
                                         const double* b, long sb,
                                         double* out, long n, int op,
                                         int blocks, void* stream) {
  if (blocks < 1 || n < 1 || EXP_K > expn::kMaxWords)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (op) {
    case 0: return launch_op<EXP_K, 0>(a, sa, b, sb, out, n, blocks, s);
    case 1: return launch_op<EXP_K, 1>(a, sa, b, sb, out, n, blocks, s);
    case 2: return launch_op<EXP_K, 2>(a, sa, b, sb, out, n, blocks, s);
    case 3: return launch_op<EXP_K, 3>(a, sa, b, sb, out, n, blocks, s);
    case 4: return launch_op<EXP_K, 4>(a, sa, b, sb, out, n, blocks, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

#ifdef EXP_CLASS_ENTRIES
int expansion_max_words() { return expn::kMaxWords; }
int expansion_threads() { return kThreads; }
#endif

}  // extern "C"
