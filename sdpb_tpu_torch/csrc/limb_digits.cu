// The two base conversions of the integer CRT pipeline for Hopper
// (sm_90a), one launch per call: limb values to balanced base-256 digits
// (digits_kernel) and balanced base-256 digit planes back to limb values
// (planes_warp_kernel).
//
// They replace no Pallas kernel: on the TPU, sdpb_tpu/mp/limb.py's
// digits_dev and planes_to_limb are XLA fusions.  Written as PyTorch
// tensor code (sdpb_tpu_torch/mp/limb.py digits_dev_plain,
// planes_to_limb_plain) they loop over limbs and planes in Python, ~900
// and ~700 launches of tiny kernels a call at 47 slots, so the host's
// launches, not the card, set their time.  Each kernel here gives the
// same bits as its plain version: the same integer shifts and masks, the
// same three carry passes, and for the planes the same renormalization
// (limb_warp.cuh renorm, bit for bit limb::renorm).
//
// What bounds them on this card.  Pure bit movement: a (11,16,16,47)
// limb array is 0.53 MB in and its 55 digits a value 0.62 MB out, tens
// of integer operations a digit; a value's planes are read once and its
// limbs written once.  Bytes bound both, and at the solver's sizes one
// launch (a few microseconds) is more than their bytes take.
//
// What the design does about it.  digits_kernel: a thread per output
// digit, threads of a value side by side, so the stores coalesce.  Digit
// t after the three carry passes depends on the raw digits t - 3..t only
// (a carry moves one digit up per pass), and a raw digit on the at most
// two limbs whose 9-bit windows reach its 8 bits, so each thread
// recomputes the four raw digits it needs from the limbs (read through
// L1) and runs the passes in registers: nothing is shared, nothing waits.
// planes_warp_kernel: a warp per value, as limb_warp.cuh holds it (lane t
// has slots t, t + 32, ...); each lane sums the at most three planes of
// each of its extended limbs, then the warp renormalizes with
// limb_warp.cuh's renorm<3> and stores the value coalesced.  Its R
// (registers a lane) is that of the extended limbs, at most one above
// the class's own, and the unit is built once per slot class with every
// such R.
//
// Inputs are canonical limb values (|exponent code| < 2^15) and planes
// below 2^13 in magnitude, as the CRT pipeline makes them.  A NaN or
// infinite slot gives finite, meaningless digits: CUDA's float-to-int
// conversion takes NaN to 0 and saturates +-inf, where the plain version
// on the CPU takes all three to INT_MIN; the callers poison such values
// downstream (ops/mpmm.py _poison, the Schur complement's finite check).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -c -Xcompiler -fPIC   (see ops/limb_kernels.py)

#include <cuda_runtime.h>

#include "limb_warp.cuh"

namespace {

using limb::kB;
using limb::kEoff;
using limbw::Ctx;
using limbw::V;

// Threads a block of digits_kernel (ops/limb_kernels.py DIGITS_THREADS).
constexpr int kDigitsThreads = 256;
// Warps a block of planes_warp_kernel, a value each
// (ops/limb_kernels.py PLANES_WARPS).
constexpr int kPlanesWarps = 4;

// Balanced base-256 digit of a and its carry (mp/limb.py _carry8).
__device__ __forceinline__ int bal8(int a) { return ((a + 128) & 255) - 128; }
__device__ __forceinline__ int cy8(int a) { return (a - bal8(a)) >> 8; }

// ceil((8 P - ref_bits) / 9): the top limb exponent of P planes at
// 2^-ref_bits (planes_to_limb_plain's e_top).
__host__ __device__ __forceinline__ int planes_e_top(int P, int ref_bits) {
  const int a = 8 * P - ref_bits;
  return a >= 0 ? (a + kB - 1) / kB : -(-a / kB);
}

// Raw digit t (before the carry passes) of the value with limbs
// x[1..L] whose limb j has its lowest bit at bit base - 9 j of the grid:
// sum over j of sign(l_j) * ((|l_j| shifted by sh = 8 t - base + 9 j) &
// 255), for sh in (-8, 10] as in digits_dev_plain, which holds for
// j = j0 and j0 + 1 alone.
__device__ __forceinline__ int raw_digit(const float* x, int L, int base,
                                         int t) {
  if (t < 0) return 0;
  const int c = 8 * t - base;
  const int j0 = -limb::floordiv(c + 7, kB);  // the least j with sh >= -7
  int acc = 0;
  for (int j = max(j0, 0); j <= j0 + 1 && j < L; ++j) {
    const int sh = c + kB * j;
    const int li = (int)x[1 + j];
    const unsigned mag = li < 0 ? 0u - (unsigned)li : (unsigned)li;
    const int v = (int)((sh >= 0 ? mag >> sh : mag << -sh) & 255u);
    acc += li < 0 ? -v : v;
  }
  return acc;
}

// x: n values of S slots; out: n x D digits, least significant first, of
// each value times 2^shift_bits (mp/limb.py digits_dev_plain).
__global__ void __launch_bounds__(kDigitsThreads)
    digits_kernel(const float* __restrict__ x, int* __restrict__ out, long n,
                  int S, int shift_bits, int D) {
  const long total = n * D;
  for (long i = (long)blockIdx.x * kDigitsThreads + threadIdx.x; i < total;
       i += (long)gridDim.x * kDigitsThreads) {
    const long v = i / D;
    const int t = (int)(i - v * D);
    const float* xv = x + v * S;
    const int e = (int)(fabsf(xv[0]) - (float)kEoff);
    const int base = shift_bits + kB * e;
    // w[k]: digit t - 3 + k; pass p leaves w[p + 1..3] carried p + 1 times
    int w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) w[k] = raw_digit(xv, S - 1, base, t - 3 + k);
#pragma unroll
    for (int p = 0; p < 3; ++p)
#pragma unroll
      for (int k = 3; k > p; --k) w[k] = bal8(w[k]) + cy8(w[k - 1]);
    out[i] = w[3];
  }
}

// P planes a value -> n limb values of S slots, each the planes' value
// times 2^-ref_bits (mp/limb.py planes_to_limb_plain): extended limb j
// (slot j + 2 after two zero heads, weight 512^(e_top - 1 - j)) sums the
// 9 bits of each plane t with shift sh = lo_j - 8 t in (-9, 14), then
// renorm<3> from e_top + 1 over n_ext + 2 slots.  32 R >= n_ext + 2.
template <int R, int W>
__global__ void __launch_bounds__(W * 32, 1)
    planes_warp_kernel(const int* __restrict__ planes,
                       float* __restrict__ out, long n, int P, int ref_bits,
                       int S) {
  extern __shared__ float sh[];
  const Ctx c = limbw::warp_ctx<R>(sh, S);
  const int e_top = planes_e_top(P, ref_bits);
  const int n_ext = c.L + 2 + max(0, e_top);
  for (long i = (long)blockIdx.x * W + (threadIdx.x >> 5); i < n;
       i += (long)gridDim.x * W) {
    const int* pv = planes + i * P;
    V<R> ext;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int s = 32 * j + c.lane;
      int acc = 0;
      if (s >= 2 && s < n_ext + 2) {
        const int lo = kB * (e_top - 1 - (s - 2)) + ref_bits;
        const int t0 = -limb::floordiv(13 - lo, 8);  // the least t, sh <= 13
        for (int t = max(t0, 0); t <= t0 + 2 && t < P; ++t) {
          const int sht = lo - 8 * t;
          if (sht <= -kB) continue;
          const int p = pv[t];
          const unsigned mag = p < 0 ? 0u - (unsigned)p : (unsigned)p;
          const int v = (int)((sht >= 0 ? mag >> sht : mag << -sht) & 511u);
          acc += p < 0 ? -v : v;
        }
      }
      ext.v[j] = (float)acc;
    }
    const V<R> o = limbw::renorm<3>(e_top + 1, ext, n_ext + 2, c);
    limbw::store(out + i * S, o, c);
    // the next value's renorm stages into the same scratch row
    __syncwarp();
  }
}

// The R of planes_warp_kernel that this slot class builds: those of its
// values and one more, for the extended limbs above the value's top.
constexpr int kPlanesMinR = limbw::regs_for(limb::kMinSlots);
constexpr int kPlanesMaxR = limbw::regs_for(limb::kMaxSlots) + 1;

__host__ __device__ int planes_smem_floats(int R) {
  return kPlanesWarps * limbw::scratch_floats(R);
}

template <int R>
int launch_planes(int regs, const int* planes, float* out, long n, int P,
                  int ref_bits, int S, int blocks, cudaStream_t stream) {
  if constexpr (R > kPlanesMaxR) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (regs != R)
      return launch_planes<R + 1>(regs, planes, out, n, P, ref_bits, S,
                                  blocks, stream);
    const size_t smem = (size_t)planes_smem_floats(R) * sizeof(float);
    planes_warp_kernel<R, kPlanesWarps>
        <<<blocks, kPlanesWarps * 32, smem, stream>>>(planes, out, n, P,
                                                      ref_bits, S);
    return (int)cudaGetLastError();
  }
}

}  // namespace

extern "C" {

int limb_digits_launch(const float* x, int* out, long n, int S,
                       int shift_bits, int D, int blocks, void* stream) {
  if (S < limb::kMinSlots || S > limb::kMaxSlots || n < 1 || D < 1 ||
      blocks < 1)
    return (int)cudaErrorInvalidValue;
  digits_kernel<<<blocks, kDigitsThreads, 0, (cudaStream_t)stream>>>(
      x, out, n, S, shift_bits, D);
  return (int)cudaGetLastError();
}

int limb_planes_launch(const int* planes, float* out, long n, int P,
                       int ref_bits, int S, int regs, int blocks,
                       void* stream) {
  if (S < limb::kMinSlots || S > limb::kMaxSlots || n < 1 || P < 1 ||
      blocks < 1 || regs < kPlanesMinR ||
      32 * regs < S + 3 + max(0, planes_e_top(P, ref_bits)))
    return (int)cudaErrorInvalidValue;
  return launch_planes<kPlanesMinR>(regs, planes, out, n, P, ref_bits, S,
                                    blocks, (cudaStream_t)stream);
}

int limb_digits_threads() { return kDigitsThreads; }

// Dynamic shared memory of a planes block at R, 0 for an R not built.
int limb_planes_smem_bytes(int R) {
  if (R < kPlanesMinR || R > kPlanesMaxR) return 0;
  return planes_smem_floats(R) * (int)sizeof(float);
}

}  // extern "C"
