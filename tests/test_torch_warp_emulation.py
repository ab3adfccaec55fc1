"""The CUDA limb kernels' own source, run on the CPU.

The kernels in sdpb_tpu_torch/csrc/limb_chol.cu, limb_solve.cu and
limb_elementwise.cu (one MP operation per warp, limb_warp.cuh) run only
on the card.  This test compiles their device code with the host C++
compiler against a small emulation of the CUDA features they use -- one
std::thread per CUDA thread, warp shuffles, votes, reductions and
barriers through std::barrier -- and checks, at small shapes, that:

- every warp operation of limb_warp.cuh gives the same bits as the
  per-thread operation of limb.cuh that it replaces;
- each kernel gives the same bits as its plain PyTorch version
  (NaN in the same places), in both orientations for the solve, for a
  non-positive-definite input for the Cholesky, and for zero divisors,
  NaN, +-inf, both ends of the exponent range and an operand broadcast
  with batch stride 0 for the elementwise add, mul and div.

The emulation checks arithmetic and indexing, not timing or memory
ordering on the card; chip_smoke.py phase 3 holds the real kernels to
the same bits.  The host compiler runs with -ffp-contract=off, as nvcc
runs with -fmad=false.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from sdpb_tpu_torch.mp import limb
from sdpb_tpu_torch.ops import limb_kernels as lk

from torch_port_util import one_torch_thread  # noqa: F401,E402

CSRC = lk.CSRC

SHIM = r"""
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstring>
#include <math.h>
#include <memory>
#include <thread>
#include <vector>
using std::max;
using std::min;
#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __noinline__
#define __restrict__
#define __launch_bounds__(...)
struct Dim3 { unsigned x = 0, y = 0, z = 0; };
inline thread_local Dim3 threadIdx, blockIdx, gridDim;
struct WarpSync {
  std::barrier<> bar{32};
  float f[32];
  unsigned u[32];
};
inline std::vector<std::unique_ptr<WarpSync>> g_warps;
inline std::unique_ptr<std::barrier<>> g_block;
inline float* emu_smem = nullptr;
inline WarpSync& ws() { return *g_warps[threadIdx.x >> 5]; }
inline int lane_id() { return threadIdx.x & 31; }
inline void __syncwarp() { ws().bar.arrive_and_wait(); }
inline void __syncthreads() { g_block->arrive_and_wait(); }
inline float __shfl_sync(unsigned, float v, int src) {
  WarpSync& w = ws();
  w.f[lane_id()] = v;
  w.bar.arrive_and_wait();
  const float r = w.f[src & 31];
  w.bar.arrive_and_wait();
  return r;
}
inline float __shfl_down_sync(unsigned m, float v, int d) {
  const int src = lane_id() + d < 32 ? lane_id() + d : lane_id();
  return __shfl_sync(m, v, src);
}
template <class F>
inline unsigned warp_reduce(unsigned v, F op, unsigned init) {
  WarpSync& w = ws();
  w.u[lane_id()] = v;
  w.bar.arrive_and_wait();
  unsigned r = init;
  for (int i = 0; i < 32; ++i) r = op(r, w.u[i], i);
  w.bar.arrive_and_wait();
  return r;
}
inline unsigned __ballot_sync(unsigned, bool p) {
  return warp_reduce(p ? 1u : 0u,
                     [](unsigned r, unsigned x, int i) { return r | (x << i); },
                     0u);
}
inline bool __any_sync(unsigned m, bool p) { return __ballot_sync(m, p) != 0; }
inline bool __all_sync(unsigned m, bool p) {
  return __ballot_sync(m, p) == 0xffffffffu;
}
inline unsigned __reduce_or_sync(unsigned, unsigned v) {
  return warp_reduce(v, [](unsigned r, unsigned x, int) { return r | x; }, 0u);
}
inline unsigned __reduce_min_sync(unsigned, unsigned v) {
  return warp_reduce(
      v, [](unsigned r, unsigned x, int) { return std::min(r, x); },
      0xffffffffu);
}
inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }
inline unsigned __float_as_uint(float f) {
  unsigned u;
  std::memcpy(&u, &f, 4);
  return u;
}
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fsqrt_rn(float a) { return std::sqrt(a); }
inline float __fmaf_rn(float a, float b, float c) { return std::fma(a, b, c); }

// Run body() as every thread of each block of a gx x gy grid, one block
// after another, with smem_floats of shared memory.
template <class F>
void run_blocks(int gx, int gy, int threads, size_t smem_floats, F body) {
  std::vector<float> smem(smem_floats, -12345.0f);
  emu_smem = smem.data();
  for (int by = 0; by < gy; ++by)
    for (int bx = 0; bx < gx; ++bx) {
      g_warps.clear();
      for (int w = 0; w < threads / 32; ++w)
        g_warps.emplace_back(new WarpSync);
      g_block.reset(new std::barrier<>(threads));
      std::vector<std::thread> ts;
      for (int t = 0; t < threads; ++t)
        ts.emplace_back([=] {
          threadIdx.x = t;
          blockIdx.x = bx;
          blockIdx.y = by;
          gridDim.x = gx;
          gridDim.y = gy;
          body();
        });
      for (auto& th : ts) th.join();
    }
}
"""

HARNESS = r"""
#include "shim.h"
#include "kernels.inc"

using limbw::Ctx;
using limbw::V;

// op: 0 add, 1 mul, 2 mul_float, 3 from_float, 4 sqrt, 5 rsqrt,
// 6 scale_limb_exp, 7 div; one warp per value.
template <int R>
void warp_ops(int op, const float* a, const float* b, const float* xf,
              const int* ix, float* out, int count, int S, int steps) {
  for (int i = 0; i < count; ++i)
    run_blocks(1, 1, 32, limbw::scratch_floats(R), [=] {
      const Ctx c = limbw::warp_ctx<R>(emu_smem, S);
      const V<R> x = limbw::load<R>(a + i * S, c);
      const V<R> y = limbw::load<R>(b + i * S, c);
      V<R> o, s, r;
      switch (op) {
        case 0: o = limbw::add(x, y, c); break;
        case 1: o = limbw::mul(x, y, c); break;
        case 2: o = limbw::mul_float(x, xf[i], c); break;
        case 3: o = limbw::from_float<R>(xf[i], c); break;
        case 4: case 5:
          limbw::sqrt_rsqrt(x, s, r, steps, c);
          o = op == 4 ? s : r;
          break;
        case 6: o = limbw::scale_limb_exp(x, ix[i], c); break;
        default: o = limbw::div(x, y, c);
      }
      limbw::store(out + i * S, o, c);
    });
}

template <int R, int W>
void chol(const float* a, float* out, int bb, int n, int S, int steps) {
  run_blocks(bb, 1, W * 32, chol_smem_floats(n, S, W),
             [=] { chol_warp_kernel<R, W>(a, out, n, S, steps); });
}

template <int R, int W>
void solve(const float* l, const float* b, const float* d, float* out, int bb,
           int n, int m, int S, int tm, int tr) {
  run_blocks(bb, (m + tm - 1) / tm, W * 32, solve_smem_floats(n, tm, S, W),
             [=] { solve_warp_kernel<R, W>(l, b, d, out, n, m, S, tm, tr); });
}

template <int R, int W>
void ew(int op, const float* a, long sa, const float* b, long sb, float* out,
        long n, int S, int blocks) {
  run_blocks(blocks, 1, W * 32, elementwise_smem_floats(S), [=] {
    switch (op) {
      case 0: elementwise_warp_kernel<R, W, 0>(a, sa, b, sb, out, n, S); break;
      case 1: elementwise_warp_kernel<R, W, 1>(a, sa, b, sb, out, n, S); break;
      default: elementwise_warp_kernel<R, W, 2>(a, sa, b, sb, out, n, S);
    }
  });
}

extern "C" {

int emu_warp_ops(int op, const float* a, const float* b, const float* xf,
                 const int* ix, float* out, int count, int S, int steps) {
  switch (limbw::regs_for(S)) {
    case 1: warp_ops<1>(op, a, b, xf, ix, out, count, S, steps); return 0;
    case 2: warp_ops<2>(op, a, b, xf, ix, out, count, S, steps); return 0;
    case 3: warp_ops<3>(op, a, b, xf, ix, out, count, S, steps); return 0;
    case 4: warp_ops<4>(op, a, b, xf, ix, out, count, S, steps); return 0;
    case 5: warp_ops<5>(op, a, b, xf, ix, out, count, S, steps); return 0;
  }
  return 1;
}

int thread_ops(int op, const float* a, const float* b, const float* xf,
               const int* ix, float* out, int count, int S, int steps) {
  const int L = S - 1;
  std::vector<float> t(S);
  for (int i = 0; i < count; ++i) {
    const float* x = a + i * S;
    const float* y = b + i * S;
    float* o = out + i * S;
    switch (op) {
      case 0: limb::add(x, y, o, L); break;
      case 1: limb::mul(x, y, o, L); break;
      case 2: limb::mul_float(x, xf[i], o, L); break;
      case 3: limb::from_float(xf[i], o, L); break;
      case 4: limb::sqrt_rsqrt(x, o, t.data(), L, steps); break;
      case 5: limb::sqrt_rsqrt(x, t.data(), o, L, steps); break;
      case 6:
        for (int s = 0; s < S; ++s) o[s] = x[s];
        limb::scale_limb_exp(o, ix[i], L);
        break;
      default: limb::div(x, y, o, L);
    }
  }
  return 0;
}

// The (registers, warps) pairs of the launchers in limb_chol.cu,
// limb_solve.cu and limb_elementwise.cu.
int emu_chol(const float* a, float* out, int bb, int n, int S, int steps,
             int warps) {
  switch (limbw::regs_for(S) * 100 + warps) {
    case 132: chol<1, 32>(a, out, bb, n, S, steps); return 0;
    case 216: chol<2, 16>(a, out, bb, n, S, steps); return 0;
    case 316: chol<3, 16>(a, out, bb, n, S, steps); return 0;
    case 408: chol<4, 8>(a, out, bb, n, S, steps); return 0;
    case 508: chol<5, 8>(a, out, bb, n, S, steps); return 0;
  }
  return 1;
}

int emu_elementwise(int op, const float* a, long sa, const float* b, long sb,
                    float* out, long n, int S, int blocks) {
  constexpr int W = kElementwiseWarps;
  switch (limbw::regs_for(S)) {
    case 1: ew<1, W>(op, a, sa, b, sb, out, n, S, blocks); return 0;
    case 2: ew<2, W>(op, a, sa, b, sb, out, n, S, blocks); return 0;
    case 3: ew<3, W>(op, a, sa, b, sb, out, n, S, blocks); return 0;
    case 4: ew<4, W>(op, a, sa, b, sb, out, n, S, blocks); return 0;
    case 5: ew<5, W>(op, a, sa, b, sb, out, n, S, blocks); return 0;
  }
  return 1;
}

int emu_solve(const float* l, const float* b, const float* d, float* out,
              int bb, int n, int m, int S, int tm, int tr, int warps) {
  switch (limbw::regs_for(S) * 100 + warps) {
    case 108: solve<1, 8>(l, b, d, out, bb, n, m, S, tm, tr); return 0;
    case 208: solve<2, 8>(l, b, d, out, bb, n, m, S, tm, tr); return 0;
    case 308: solve<3, 8>(l, b, d, out, bb, n, m, S, tm, tr); return 0;
    case 408: solve<4, 8>(l, b, d, out, bb, n, m, S, tm, tr); return 0;
    case 508: solve<5, 8>(l, b, d, out, bb, n, m, S, tm, tr); return 0;
  }
  return 1;
}

}  // extern "C"
"""


def _device_code(name: str) -> str:
    """A kernel unit up to its launcher (host code with CUDA launch
    syntax), its dynamic shared memory taken from the emulation."""
    src = (CSRC / name).read_text()
    cut = src.index("template <int R, int W>\nint launch(")
    src = src[:cut] + "}  // namespace\n"
    src = src.replace("#include <cuda_runtime.h>", "")
    assert "extern __shared__ float sh[];" in src
    return src.replace("extern __shared__ float sh[];",
                       "float* sh = emu_smem;")


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler (g++) to build the emulation")
    d = tmp_path_factory.mktemp("warp_emulation")
    (d / "shim.h").write_text(SHIM)
    (d / "kernels.inc").write_text(
        "\n".join(_device_code(n) for n in ("limb_chol.cu", "limb_solve.cu",
                                             "limb_elementwise.cu")))
    (d / "harness.cpp").write_text(HARNESS)
    lib = d / "libemu.so"
    proc = subprocess.run(
        [cxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fno-fast-math",
         "-fPIC", "-shared", "-pthread", f"-I{CSRC}", f"-I{d}",
         # the per-thread ops of the 256-slot class, so that S = 130
         # (R = 5, --precision 1152) is compared as well
         "-DLIMB_MAX_SLOTS=256",
         "-Wno-unused-function", str(d / "harness.cpp"), "-o", str(lib)],
        capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    emu = ctypes.CDLL(str(lib))
    vp, cl, ci = ctypes.c_void_p, ctypes.c_long, ctypes.c_int
    emu.emu_elementwise.argtypes = [ci, vp, cl, vp, cl, vp, cl, ci, ci]
    return emu


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _same(got, want):
    return torch.equal(got.nan_to_num(0.0, 1.0, -1.0),
                       want.nan_to_num(0.0, 1.0, -1.0)) and torch.equal(
        got.isnan(), want.isnan())


def _random_limbs(rng, n, S):
    """Values over exponents 2^-200..2^200 with zeros, NaN, +inf and
    values at the ends of the exponent range."""
    e = rng.integers(-200, 200, size=n)
    words = np.stack([rng.standard_normal(n) * 2.0 ** e,
                      rng.standard_normal(n) * 2.0 ** (e - 53),
                      rng.standard_normal(n) * 2.0 ** (e - 106)], axis=-1)
    words[rng.random(n) < 0.1] = 0.0
    x = limb.from_words_np(words, S)
    x[1] = np.nan
    x[2] = limb.from_words_np(np.array([[np.inf, 0.0, 0.0]]), S)[0]
    x[3] = limb.one(S)
    x[3, 0] = 2 * limb.EOFF - 2
    x[4] = limb.one(S)
    x[4, 0] = 1
    return torch.from_numpy(x)


OPS = ("add", "mul", "mul_float", "from_float", "sqrt", "rsqrt",
       "scale_limb_exp", "div")


def _zero_divisors(a, b):
    """Zero divisors under a non-zero dividend of each sign and under a
    zero one, and a -inf dividend (entries 5..8)."""
    S = a.shape[-1]
    a, b = a.clone(), b.clone()
    a[5] = torch.from_numpy(limb.one(S))
    a[6] = -a[5]
    a[7] = 0.0
    a[8] = torch.from_numpy(limb.from_words_np(
        np.array([[-np.inf, 0.0, 0.0]]), S)[0])
    b[5:8] = 0.0
    return a, b


@pytest.mark.parametrize("S", [4, 26, 30, 47, 62, 116, 128, 130])
def test_warp_ops_match_per_thread_ops(emu, S):
    count = 16
    rng = np.random.default_rng(S)
    a = _random_limbs(rng, count, S)
    b = _random_limbs(rng, count, S)
    xf = torch.from_numpy((rng.standard_normal(count) * 2.0 ** rng.integers(
        -60, 60, count)).astype(np.float32))
    xf[:5] = torch.tensor([0.0, np.inf, np.nan, 0.5, -np.inf])
    ix = torch.from_numpy(rng.integers(-5, 5, count).astype(np.int32))
    steps = limb.newton_steps(S - 1)
    for op, name in enumerate(OPS):
        x, y = a.clone(), b
        if name in ("sqrt", "rsqrt"):
            x = limb.abs_(x)
            x[5] = -x[6]   # negative
            x[6] = 0.0     # zero
        if name == "div":
            x, y = _zero_divisors(x, y)
        warp = torch.empty_like(a)
        thread = torch.empty_like(a)
        assert emu.emu_warp_ops(op, _ptr(x), _ptr(y), _ptr(xf), _ptr(ix),
                                _ptr(warp), count, S, steps) == 0
        emu.thread_ops(op, _ptr(x), _ptr(y), _ptr(xf), _ptr(ix),
                       _ptr(thread), count, S, steps)
        assert _same(warp, thread), name


def _spd(rng, bb, n, S, scale=1.0):
    g = rng.standard_normal((bb, n, n))
    a = (g @ g.transpose(0, 2, 1) + n * np.eye(n)) * scale
    return torch.from_numpy(limb.from_words_np(a[..., None], S))


@pytest.mark.parametrize("bb,n,S", [(2, 7, 26), (1, 9, 47), (1, 4, 62),
                                    (1, 5, 116), (1, 3, 128),
                                    (1, 3, 130)])
def test_cholesky_kernel_matches_plain(emu, bb, n, S):
    rng = np.random.default_rng(n * S)
    a = _spd(rng, bb + 1, n, S, 1e20)
    a[-1] = -a[-1]                       # not positive definite
    out = torch.empty_like(a)
    geo = lk.chol_geometry(n, S)
    assert emu.emu_chol(_ptr(a), _ptr(out), bb + 1, n, S,
                        limb.newton_steps(S - 1), geo["warps"]) == 0
    assert _same(out, lk.cholesky_unblocked_plain(a))
    assert out[-1].isnan().any() and torch.isfinite(out[:-1]).all()


@pytest.mark.parametrize("bb,n,m,S,tm", [(2, 7, 9, 47, 4), (1, 9, 5, 26, 2),
                                         (1, 6, 3, 116, 1), (1, 5, 3, 128, 2),
                                         (1, 4, 3, 62, 3),
                                         (1, 4, 3, 130, 2)])
def test_solve_kernel_matches_plain(emu, bb, n, m, S, tm):
    rng = np.random.default_rng(n * m * S)
    lfac = lk.cholesky_unblocked_plain(_spd(rng, bb, n, S))
    d = torch.arange(n)
    inv_d = limb.recip(lfac[:, d, d, :]).contiguous()
    b = torch.from_numpy(limb.from_words_np(
        rng.standard_normal((bb, n, m))[..., None], S))
    warps = lk.solve_geometry(bb, n, m, S)["warps"]
    for transpose in (0, 1):
        out = torch.empty_like(b)
        assert emu.emu_solve(_ptr(lfac), _ptr(b), _ptr(inv_d), _ptr(out),
                             bb, n, m, S, tm, transpose, warps) == 0
        assert _same(out, lk.solve_unblocked_plain(lfac, b, inv_d,
                                                   bool(transpose)))



@pytest.mark.parametrize("S", [4, 26, 47, 116, 130])
def test_elementwise_kernel_matches_plain(emu, S):
    """limb_add, limb_mul and limb_div's kernel against add_plain,
    mul_plain and div_plain: 12 values on 2 blocks of 4 warps (so each
    warp takes one or two values in the grid-stride loop), then the same
    with b's first value broadcast over the batch (stride 0)."""
    n = 12
    rng = np.random.default_rng(100 + S)
    a, b = _zero_divisors(_random_limbs(rng, n, S), _random_limbs(rng, n, S))
    b[9] = a[9]            # x / x
    a[10] = -a[11]         # x + (-x)
    b[10] = a[11]
    assert lk.elementwise_geometry(n, S)["blocks"] == 3
    one, stride0 = lk.elementwise_operand(b[:1], (n,))
    assert stride0 == 0 and one.shape == (S,)
    for op, plain in enumerate((limb.add_plain, limb.mul_plain,
                                limb.div_plain)):
        for y, sb in ((b, S), (one, 0)):
            out = torch.empty_like(a)
            assert emu.emu_elementwise(op, _ptr(a), S, _ptr(y), sb,
                                       _ptr(out), n, S, 2) == 0
            assert _same(out, plain(a, y)), (op, sb)


@pytest.mark.parametrize("n", [1, 13])
def test_elementwise_kernel_on_its_own_grid(emu, n):
    """The elementwise kernel on the grid elementwise_geometry gives it (a
    warp for each value, the last block part empty), each op against its
    plain version at S = 47: 13 values on 4 blocks, or each of 13 values
    alone on one block."""
    S = 47
    rng = np.random.default_rng(200 + n)
    a, b = _zero_divisors(_random_limbs(rng, 13, S),
                          _random_limbs(rng, 13, S))
    blocks = lk.elementwise_geometry(n, S)["blocks"]
    assert blocks == -(-n // lk.ELEMENTWISE_WARPS)
    for op, plain in enumerate((limb.add_plain, limb.mul_plain,
                                limb.div_plain)):
        for i in range(0, 13, n):
            x, y = a[i:i + n].contiguous(), b[i:i + n].contiguous()
            out = torch.empty_like(x)
            assert emu.emu_elementwise(op, _ptr(x), S, _ptr(y), S,
                                       _ptr(out), n, S, blocks) == 0
            assert _same(out, plain(x, y)), (op, i)
