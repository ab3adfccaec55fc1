// Elementwise limb add, mul and div for Hopper (sm_90a): one launch per
// MP operation, one MP value per warp (limb_warp.cuh).
//
// On the TPU these are XLA fusions of sdpb_tpu/mp/limb.py (add :499,
// mul :532, div :670), not Pallas kernels.  Written as PyTorch tensor
// code, one limb add is ~80 launches of tiny kernels and one limb
// division ~600, so the solver's many small MP operations would be bound
// by launch overhead.  Each kernel here agrees bit for bit with the
// plain PyTorch version (sdpb_tpu_torch/mp/limb.py add_plain, mul_plain,
// div_plain): the same exact integer arithmetic in float32.
//
// What bounds them on this card.  An addition moves 3 S floats and does
// ~L additions and three carry passes: bytes.  A product does ~L^2/2
// multiply-adds, a division L + 2 dependent digit steps of ~2L
// operations each: at S = 47 both need less time for their operations
// than for their bytes on paper, but a division's digits form a chain of
// dependent steps, so latency bounds it unless enough warps run at once.
//
// What the design does about it.  One warp holds one value in registers
// (lane t has slots t, t + 32, ...), so a load or store of a value is
// coalesced and every slot loop of the per-thread version is spread over
// 32 lanes; nothing goes through local memory.  A division keeps its
// remainder and the divisor's limbs in registers across the digits and
// moves each digit's carry and shift with shuffles.  Each block holds
// four warps with their own scratch rows in shared memory (the product's
// staged operands, the carry passes of renorm).  The grid has a warp for
// each value; a grid-stride loop takes any smaller grid.  A single value
// broadcast over the batch is read in place (batch stride 0).  The unit
// is built once per R (registers a lane spends on one value), as
// limb_chol.cu is.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -c -Xcompiler -fPIC   (see ops/limb_kernels.py)

#include <cuda_runtime.h>

#include "limb_warp.cuh"

namespace {

using limbw::Ctx;
using limbw::V;

// Four warps a block at every R: the scratch rows of R = 17 take 26 KB,
// under the 48 KB a block gets without opting in.
// ops/limb_kernels.py::ELEMENTWISE_WARPS.
constexpr int kElementwiseWarps = 4;

// Shared memory of one block, in floats: the warps' scratch rows.
// Mirrored by ops/limb_kernels.py::elementwise_geometry.
__host__ __device__ int elementwise_smem_floats(int S) {
  return kElementwiseWarps * limbw::scratch_floats(limbw::regs_for(S));
}

// op: 0 add, 1 mul, 2 div.  Value i of a is at a + i sa (sa = S, or 0
// for one value broadcast over the batch), likewise b; out is (n, S).
// The explicit minimum of one block an SM matters: without it ptxas
// held some instantiations (R = 7, 8, 10) to 56-80 registers and
// spilled; with it none spills (chip_smoke.py phase 2).
template <int R, int W, int OP>
__global__ void __launch_bounds__(W * 32, 1)
    elementwise_warp_kernel(const float* __restrict__ a, long sa,
                            const float* __restrict__ b, long sb,
                            float* __restrict__ out, long n, int S) {
  extern __shared__ float sh[];
  const Ctx c = limbw::warp_ctx<R>(sh, S);
  for (long i = (long)blockIdx.x * W + (threadIdx.x >> 5); i < n;
       i += (long)gridDim.x * W) {
    const V<R> x = limbw::load<R>(a + i * sa, c);
    const V<R> y = limbw::load<R>(b + i * sb, c);
    V<R> o;
    if (OP == 0) {
      o = limbw::add(x, y, c);
    } else if (OP == 1) {
      o = limbw::mul(x, y, c);
    } else {
      o = limbw::div(x, y, c);
    }
    limbw::store(out + i * S, o, c);
    // mul's early return (a NaN operand) reads the staged operand
    // after the last barrier: let every lane finish with the scratch
    // rows before the next value is staged there
    __syncwarp();
  }
}

template <int R, int W>
int launch(const float* a, long sa, const float* b, long sb, float* out,
           long n, int S, int op, int blocks, cudaStream_t stream) {
  const size_t smem = (size_t)elementwise_smem_floats(S) * sizeof(float);
  if (op == 0) {
    elementwise_warp_kernel<R, W, 0><<<blocks, W * 32, smem, stream>>>(
        a, sa, b, sb, out, n, S);
  } else if (op == 1) {
    elementwise_warp_kernel<R, W, 1><<<blocks, W * 32, smem, stream>>>(
        a, sa, b, sb, out, n, S);
  } else if (op == 2) {
    elementwise_warp_kernel<R, W, 2><<<blocks, W * 32, smem, stream>>>(
        a, sa, b, sb, out, n, S);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// One object per R of the slot class, as in limb_chol.cu.
#ifndef LIMB_R
#error "compile with -DLIMB_R=<registers per value>"
#endif
#define LIMB_PASTE2(a, b) a##b
#define LIMB_PASTE(a, b) LIMB_PASTE2(a, b)

extern "C" {

int LIMB_PASTE(limb_elementwise_launch_r, LIMB_R)(
    const float* a, long sa, const float* b, long sb, float* out, long n,
    int S, int op, int blocks, void* stream) {
  if (S < limb::kMinSlots || S > limb::kMaxSlots ||
      limbw::regs_for(S) != LIMB_R || blocks < 1 || n < 1)
    return (int)cudaErrorInvalidValue;
  return launch<LIMB_R, kElementwiseWarps>(a, sa, b, sb, out, n, S, op,
                                           blocks, (cudaStream_t)stream);
}

#ifdef LIMB_CLASS_ENTRIES
int limb_elementwise_smem_bytes(int S) {
  return elementwise_smem_floats(S) * (int)sizeof(float);
}
#endif

}  // extern "C"
