// Latency of the warp-wide limb operations of limb_warp.cuh: one warp in
// one block runs each operation K times in a dependent chain and prints
// SM cycles per operation, at S = 26, 47 and 116 (--precision 212, 400
// and 1024).  This is the chain that bounds the Cholesky's pivots
// (limb_chol.cu): a sqrt/rsqrt is ~21 products, ~14 additions and ~7
// products by 0.5 in a row.
//
// Not part of the library build.  On a machine with the card, from the
// repository root:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
//        -I sdpb_tpu_torch/csrc -o /tmp/warp_latency \
//        sdpb_tpu_torch/csrc/warp_latency.cu && /tmp/warp_latency

#include <cstdio>
#include <initializer_list>

#include <cuda_runtime.h>

#include "limb_warp.cuh"

namespace {

using limbw::Ctx;
using limbw::V;

constexpr int kOps = 5;
const char* const kNames[kOps] = {"mul", "add", "mul_float", "sqrt_rsqrt",
                                  "renorm3"};

template <int R>
__global__ void latency(const float* a, const float* b, float* out,
                        long long* cycles, int S, int K, int steps) {
  extern __shared__ float sh[];
  const Ctx c = limbw::warp_ctx<R>(sh, S);
  const V<R> x = limbw::load<R>(a, c), y = limbw::load<R>(b, c);
  long long t[kOps + 1];
  V<R> acc = x;
  t[0] = clock64();
  for (int k = 0; k < K; ++k) acc = limbw::mul(acc, y, c);
  t[1] = clock64();
  for (int k = 0; k < K; ++k) acc = limbw::add(acc, y, c);
  t[2] = clock64();
  for (int k = 0; k < K; ++k) acc = limbw::mul_float(acc, 0.5f, c);
  t[3] = clock64();
  V<R> s = x, root, rinv;
  for (int k = 0; k < K; ++k) {
    limbw::sqrt_rsqrt(s, root, rinv, steps, c);
    s = root;
  }
  t[4] = clock64();
  V<R> e = x;
  for (int k = 0; k < K; ++k) e = limbw::renorm<3>(10, e, c.L + 4, c);
  t[5] = clock64();
  limbw::store(out, acc, c);
  limbw::store(out + 128, s, c);
  limbw::store(out + 256, e, c);
  if (c.lane == 0)
    for (int i = 0; i < kOps; ++i) cycles[i] = t[i + 1] - t[i];
}

int newton_steps(int L) {  // mp/limb.py newton_steps
  int q = 0;
  while ((1 << q) < 9.0 * L / 11.0) ++q;
  return q < 3 ? 3 : q;
}

}  // namespace

int main() {
  const int K = 32;
  float *da, *db, *dout;
  long long* dc;
  cudaMalloc(&da, 128 * 4);
  cudaMalloc(&db, 128 * 4);
  cudaMalloc(&dout, 384 * 4);
  cudaMalloc(&dc, kOps * 8);
  for (int S : {26, 47, 116}) {
    // x: a positive value near 2^9 with full limbs; y: 1 + 3/512
    float ha[128] = {0}, hb[128] = {0};
    ha[0] = limbw::kEoff + 1;
    ha[1] = 200.0f;
    for (int i = 2; i < S; ++i) ha[i] = (float)((i * 37) % 500 - 250);
    hb[0] = limbw::kEoff;
    hb[1] = 1.0f;
    hb[2] = 3.0f;
    cudaMemcpy(da, ha, sizeof(ha), cudaMemcpyHostToDevice);
    cudaMemcpy(db, hb, sizeof(hb), cudaMemcpyHostToDevice);
    const int R = limbw::regs_for(S);
    const size_t smem = limbw::scratch_floats(R) * sizeof(float);
    const int steps = newton_steps(S - 1);
    for (int rep = 0; rep < 2; ++rep) {  // the first run warms up
      if (R == 1) latency<1><<<1, 32, smem>>>(da, db, dout, dc, S, K, steps);
      if (R == 2) latency<2><<<1, 32, smem>>>(da, db, dout, dc, S, K, steps);
      if (R == 4) latency<4><<<1, 32, smem>>>(da, db, dout, dc, S, K, steps);
    }
    long long hc[kOps];
    cudaMemcpy(hc, dc, sizeof(hc), cudaMemcpyDeviceToHost);
    printf("S=%d R=%d newton_steps=%d (%s) cycles per op:", S, R, steps,
           cudaGetErrorString(cudaGetLastError()));
    for (int i = 0; i < kOps; ++i) printf(" %s %.0f", kNames[i], hc[i] / (double)K);
    printf("\n");
  }
  return 0;
}
