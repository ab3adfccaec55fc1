// Latency and issue cost of the float64-expansion operations on one SM:
// the per-thread operations of csrc/expansion_regs.cuh (what the
// column-loop kernels' update threads and substitutions run) and the
// warp operations of csrc/expansion_warp.cuh (a Cholesky's pivot warp)
// beside the per-thread operations of
// csrc/expansion.cuh (what the elementwise kernel runs, and what the
// column loops ran before), each in a dependent chain of ``reps``
// operations, x = op(x, y).  One block of 32 threads gives the chain's
// latency (one warp alone on its scheduler, as a Cholesky's pivot
// warp); one block of 128 threads gives four such warps on the SM's four
// schedulers, each thread its own chain (as the update threads); the
// warp operations run in one warp.  It prints one JSON line per
// operation: SM cycles per operation.
//
// Above K = 20 (every column-loop operation a value a warp) only the
// warp operations run: alone on the SM, and as each of 8 warps on one SM
// (as a cluster block of the column loops above K = 20 runs them), each
// warp its own chain; "warps" in the line says which.
//
// Not part of the library build.  On a machine with the card, from the
// repository root, for K in 2..54:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
//        -DEXP_K=8 -I sdpb_tpu_torch/csrc -o /tmp/expansion_latency \
//        sdpb_tpu_torch/csrc/expansion_latency.cu && /tmp/expansion_latency

#include <cstdio>
#include <vector>

#include <cuda_runtime.h>

#include "expansion_warp.cuh"

#ifndef EXP_K
#error "compile with -DEXP_K=<words per value>"
#endif

namespace {

constexpr int K = EXP_K;
constexpr int kOps = 5;
const char* const kNames[kOps] = {"mul", "add", "add_f64", "mul_old",
                                  "add_old"};

#if EXP_K <= 20
__global__ void __launch_bounds__(128, 1)
    latency(const double* a, const double* b, double* out,
            long long* cycles, int reps) {
  extern __shared__ double buf[];
  const expn::regs::Emit em{buf + threadIdx.x, (int)blockDim.x};
  double x[K], y[K], o[K];
  expn::regs::load<K>(a + threadIdx.x * K, x);
  expn::regs::load<K>(b + threadIdx.x * K, y);
  long long t[kOps + 1];
  t[0] = clock64();
  for (int r = 0; r < reps; ++r) {
    expn::regs::mul<K>(x, y, em, o);
    expn::regs::static_for<0, K>([&](auto I) { x[EXP_IDX(I)] = o[EXP_IDX(I)]; });
  }
  t[1] = clock64();
  for (int r = 0; r < reps; ++r) {
    expn::regs::add<K>(x, y, em, o);
    expn::regs::static_for<0, K>([&](auto I) { x[EXP_IDX(I)] = o[EXP_IDX(I)]; });
  }
  t[2] = clock64();
  for (int r = 0; r < reps; ++r) {
    expn::regs::add_f64<K>(x, y[0], em, o);
    expn::regs::static_for<0, K>([&](auto I) { x[EXP_IDX(I)] = o[EXP_IDX(I)]; });
  }
  t[3] = clock64();
  double xs[K], ys[K], os[K];
  for (int i = 0; i < K; ++i) {
    xs[i] = x[i];
    ys[i] = y[i];
  }
  for (int r = 0; r < reps; ++r) {
    expn::mul<K>(xs, ys, os);
    for (int i = 0; i < K; ++i) xs[i] = os[i];
  }
  t[4] = clock64();
  for (int r = 0; r < reps; ++r) {
    expn::add<K>(xs, ys, os);
    for (int i = 0; i < K; ++i) xs[i] = os[i];
  }
  t[5] = clock64();
  for (int i = 0; i < K; ++i) out[threadIdx.x * K + i] = x[i] + xs[i];
  for (int i = 0; i < kOps; ++i)
    cycles[threadIdx.x * kOps + i] = t[i + 1] - t[i];
}
#endif

// The warp operations of csrc/expansion_warp.cuh (a Cholesky's pivot
// warp): each warp of the block a dependent chain of ``reps`` of each,
// in its own scratch; warp 0's cycles.
__global__ void latency_warp(const double* a, const double* b, double* out,
                             long long* cycles, int reps) {
  extern __shared__ double wbuf[];
  const expn::warp::Scratch<K> ws(
      wbuf + (threadIdx.x >> 5) * expn::warp::scratch_words<K>());
  const int lane = threadIdx.x & 31;
  if constexpr (K >= 3) expn::warp::init_codes<K>(ws, lane);
  for (int i = lane; i < K; i += 32) {
    ws.x[i] = a[i];
    ws.y[i] = b[i];
  }
  long long t[4];
  for (int op = 0; op < 3; ++op) {
    __syncwarp();
    t[op] = clock64();
    for (int r = 0; r < reps; ++r) {
      __syncwarp();
      const expn::warp::Res res =
          op == 0 ? expn::warp::mul<K>(ws, lane)
                  : op == 1 ? expn::warp::add<K>(ws, lane)
                            : expn::warp::add_f64<K>(ws, b[0], lane);
      __syncwarp();
      for (int i = lane; i < K; i += 32)
        ws.x[i] = expn::warp::res_word<K>(ws, res, i);
    }
    __syncwarp();
    t[op + 1] = clock64();
  }
  if (threadIdx.x < 32)
    for (int i = lane; i < K; i += 32) out[i] = ws.x[i];
  if (threadIdx.x == 0)
    for (int i = 0; i < 3; ++i) cycles[i] = t[i + 1] - t[i];
}

// One dependent float64 addition after another: its latency.
__global__ void dadd_chain(const double* a, double* out, long long* cycles,
                           int reps) {
  double x = a[threadIdx.x], y = a[threadIdx.x + 1];
  const long long t0 = clock64();
  for (int r = 0; r < reps; ++r) {
#pragma unroll
    for (int i = 0; i < 16; ++i) x = x + y;
  }
  const long long t1 = clock64();
  out[threadIdx.x] = x;
  if (threadIdx.x == 0) cycles[0] = t1 - t0;
}

}  // namespace

int main() {
  const int reps = 64;
  // x: a value near 2^40 with every word carrying bits; y: 1 + a tail,
  // so that the chains stay in range and every word stays busy
  std::vector<double> a(128 * K), b(128 * K);
  unsigned s = 12345;
  auto rnd = [&s]() {
    s = s * 1103515245u + 12345u;
    return ((s >> 8) & 0xffff) / 65536.0 + 0.5;
  };
  for (int v = 0; v < 128; ++v) {
    double sc = 1099511627776.0, sc1 = 1.0;
    for (int i = 0; i < K; ++i) {
      a[v * K + i] = rnd() * sc;
      b[v * K + i] = i == 0 ? 1.0 : rnd() * sc1;
      sc *= 1.1102230246251565e-16;  // 2^-53
      sc1 *= 1.1102230246251565e-16;
    }
  }
  double *da, *db, *dout;
  long long* dc;
  cudaMalloc(&da, a.size() * sizeof(double));
  cudaMalloc(&db, b.size() * sizeof(double));
  cudaMalloc(&dout, a.size() * sizeof(double));
  cudaMalloc(&dc, 128 * kOps * sizeof(long long));
  cudaMemcpy(da, a.data(), a.size() * sizeof(double), cudaMemcpyHostToDevice);
  cudaMemcpy(db, b.data(), b.size() * sizeof(double), cudaMemcpyHostToDevice);
#if EXP_K <= 20
  const int smem = 128 * expn::regs::thread_words<K>() * sizeof(double);
  cudaFuncSetAttribute(latency, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  for (int threads : {32, 128}) {
    latency<<<1, threads, smem>>>(da, db, dout, dc, 2);  // warm-up
    latency<<<1, threads, smem>>>(da, db, dout, dc, reps);
    const cudaError_t err = cudaDeviceSynchronize();
    if (err != cudaSuccess) {
      std::printf("{\"error\": \"%s\"}\n", cudaGetErrorString(err));
      return 1;
    }
    std::vector<long long> c(128 * kOps);
    cudaMemcpy(c.data(), dc, c.size() * sizeof(long long),
               cudaMemcpyDeviceToHost);
    for (int i = 0; i < kOps; ++i)
      std::printf("{\"K\": %d, \"threads\": %d, \"op\": \"%s\", "
                  "\"cycles_per_op\": %.1f}\n",
                  K, threads, kNames[i], (double)c[i] / reps);
  }
#endif
  dadd_chain<<<1, 32>>>(da, dout, dc, 2);
  dadd_chain<<<1, 32>>>(da, dout, dc, reps);
  if (cudaDeviceSynchronize() == cudaSuccess) {
    long long c = 0;
    cudaMemcpy(&c, dc, sizeof c, cudaMemcpyDeviceToHost);
    std::printf("{\"K\": %d, \"threads\": 32, \"op\": \"dadd\", "
                "\"cycles_per_op\": %.1f}\n", K, (double)c / (16.0 * reps));
  }
  const int wsmem = 8 * expn::warp::scratch_words<K>() * sizeof(double);
  cudaFuncSetAttribute(latency_warp,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, wsmem);
  for (int warps : {1, 8}) {
    if (K < 3 || (warps > 1 && K <= expn::kThreadMaxWords)) break;
    const int reps_w = K > expn::kThreadMaxWords ? 8 : reps;
    const int bytes = warps * expn::warp::scratch_words<K>() * sizeof(double);
    latency_warp<<<1, 32 * warps, bytes>>>(da, db, dout, dc, 2);
    latency_warp<<<1, 32 * warps, bytes>>>(da, db, dout, dc, reps_w);
    const cudaError_t err = cudaDeviceSynchronize();
    if (err != cudaSuccess) {
      std::printf("{\"error\": \"%s\"}\n", cudaGetErrorString(err));
      return 1;
    }
    std::vector<long long> c(3);
    cudaMemcpy(c.data(), dc, 3 * sizeof(long long), cudaMemcpyDeviceToHost);
    const char* const names[3] = {"warp_mul", "warp_add", "warp_add_f64"};
    for (int i = 0; i < 3; ++i)
      std::printf("{\"K\": %d, \"threads\": 32, \"warps\": %d, "
                  "\"op\": \"%s\", \"cycles_per_op\": %.1f}\n",
                  K, warps, names[i], (double)c[i] / reps_w);
  }
  return 0;
}
