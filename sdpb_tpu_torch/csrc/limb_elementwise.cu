// Elementwise limb add, mul and div: one launch per MP operation.
//
// On the TPU these are XLA fusions of sdpb_tpu/mp/limb.py (add, mul, div),
// not Pallas kernels.  Written as PyTorch tensor code, one limb add is ~80
// launches of tiny kernels (split, shift, carry, renormalize, rebuild) and
// one limb division ~600, so the solver's many small MP operations were
// bound by launch overhead.  Each kernel here runs the per-element device
// functions of limb.cuh, one thread per MP value, and agrees bit for bit
// with the tensor code (the same exact integer arithmetic in float32).
// What bounds them at large sizes: the limb arithmetic per element
// (~L^2 multiply-adds for mul, ~L^2 for div), with operands read once.

#include <cuda_runtime.h>

#include "limb.cuh"

namespace {

constexpr int kThreads = 128;

// op: 0 add, 1 mul, 2 div.  a, b and out are (n, S), contiguous.
__global__ void elementwise_kernel(const float* __restrict__ a,
                                   const float* __restrict__ b, float* out,
                                   long n, int S, int op) {
  const int L = S - 1;
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < n;
       i += (long)gridDim.x * blockDim.x) {
    const float* x = a + i * S;
    const float* y = b + i * S;
    float* o = out + i * S;
    if (op == 0) {
      limb::add(x, y, o, L);
    } else if (op == 1) {
      limb::mul(x, y, o, L);
    } else {
      limb::div(x, y, o, L);
    }
  }
}

}  // namespace

extern "C" int limb_elementwise_launch(const float* a, const float* b,
                                       float* out, long n, int S, int op,
                                       void* stream) {
  // the local arrays of limb.cuh hold the unit's slot class
  if (S < limb::kMinSlots || S > limb::kMaxSlots)
    return (int)cudaErrorInvalidValue;
  long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 65535L * 8) blocks = 65535L * 8;
  if (blocks < 1) blocks = 1;
  elementwise_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      a, b, out, n, S, op);
  return (int)cudaGetLastError();
}
