"""The redesigned elementwise expansion kernel's two designs against
mp/core.py's plain functions, on the CPU.

``csrc/expansion_elementwise.cuh`` holds what the kernel's blocks do: a
value a thread (``thread_values``: the block's operands staged through
shared memory, each thread's words in registers, K <= 20) and a value a
warp (``warp_values``: expansion_warp.cuh's operations, K >= 3, up to
the CRT prime pool's K = 54).  Here both are compiled with g++
-ffp-contract=off (nvcc runs with -fmad=false) and run with one host
thread per CUDA thread, ``std::barrier`` as ``__syncthreads()`` and as
``__syncwarp()``: a block of 32 threads for the first design, 32
threads a warp for the second, several blocks or warps one after
another over the grid-stride loop.  All five operations (add, mul,
div, add_f64, mul_f64) are held bit for bit, NaN in the same places, to
``add_plain`` ... ``mul_f64_plain`` at every K of each design up to 20
and at K = 21, 23, 32, 33 and 54 (a warp's term codes end at K = 20,
its merge network doubles its pairs above K = 32), with one operand
broadcast over the batch (stride 0), over zeros, exact cancellation,
NaN, +-inf and exponents 2^-500..2^500 (tails reaching the subnormal
range, which neither side flushes).
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from sdpb_tpu_torch.mp import core
from sdpb_tpu_torch.ops import expansion_kernels as ek

from torch_port_util import one_torch_thread  # noqa: F401,E402

THREAD_KS = tuple(range(1, ek.THREAD_MAX_WORDS + 1))
WARP_KS = tuple(range(3, ek.THREAD_MAX_WORDS + 1)) + (21, 23, 32, 33, 54)
# host threads a block of the value-a-thread design (the card's take
# 128: the staging and the grid-stride loop do not depend on it)
BLOCK = 32

HARNESS = r"""
#include <barrier>
#include <thread>
#include <vector>

static thread_local std::barrier<>* g_sync;
#define EXP_HD inline
#define EXP_BLOCK inline
#define EXP_OUT_OF_LINE inline
#define EXP_SYNC() g_sync->arrive_and_wait()
#define EXP_SYNC_WARP() g_sync->arrive_and_wait()
#include "expansion_elementwise.cuh"

// ``groups`` blocks of ``nthreads`` threads (design 0) or warps (design
// 1), one after another, as the grid of the kernel.
template <int K, int OP>
static void run(int design, const double* a, long sa, const double* b,
                long sb, double* out, long n, int groups, int nthreads) {
  const int width = design ? 32 : nthreads;
  for (int g = 0; g < groups; ++g) {
    std::vector<double> sh(
        design ? expn::ew::warp_words<K, OP>()
               : expn::ew::thread_smem_words<K, OP>(nthreads), -1e300);
    std::barrier<> sync(width);
    std::vector<std::thread> threads;
    for (int tid = 0; tid < width; ++tid)
      threads.emplace_back([&, tid] {
        g_sync = &sync;
        if constexpr (K >= 3) {
          if (design) {
            expn::ew::warp_values<K, OP>(a, sa, b, sb, out, n, g, groups,
                                         sh.data(), tid);
            return;
          }
        }
        if constexpr (K <= expn::kThreadMaxWords) {
          expn::ew::thread_values<K, OP>(a, sa, b, sb, out, n,
                                         (long)g * nthreads,
                                         (long)groups * nthreads, sh.data(),
                                         tid, nthreads);
        }
      });
    for (auto& t : threads) t.join();
  }
}

template <int K>
static void run_op(int design, int op, const double* a, long sa,
                   const double* b, long sb, double* out, long n, int groups,
                   int nthreads) {
  switch (op) {
    case 0: run<K, 0>(design, a, sa, b, sb, out, n, groups, nthreads); break;
    case 1: run<K, 1>(design, a, sa, b, sb, out, n, groups, nthreads); break;
    case 2: run<K, 2>(design, a, sa, b, sb, out, n, groups, nthreads); break;
    case 3: run<K, 3>(design, a, sa, b, sb, out, n, groups, nthreads); break;
    default: run<K, 4>(design, a, sa, b, sb, out, n, groups, nthreads);
  }
}

extern "C" int host_elementwise(int k, int design, int op, const double* a,
                                long sa, const double* b, long sb,
                                double* out, long n, int groups,
                                int nthreads) {
  switch (k) {
    CASES
  }
  return 1;
}
"""

# the libraries, each a set of K built by one g++ (all at once)
PARTS = {"thread_lo": (0, tuple(k for k in THREAD_KS if k <= 10)),
         "thread_hi": (0, tuple(k for k in THREAD_KS if k > 10)),
         "warp_lo": (1, tuple(k for k in WARP_KS if k <= 12)),
         "warp_hi": (1, tuple(k for k in WARP_KS if 12 < k <= 20)),
         "warp_wide": (1, (21, 23, 32)),
         "warp_widest": (1, (33, 54))}


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler (g++) to build the kernel code")
    d = tmp_path_factory.mktemp("expansion_elementwise_host")
    jobs = {}
    for name, (_, ks) in PARTS.items():
        cases = " ".join(f"case {k}: run_op<{k}>(design, op, a, sa, b, sb, "
                         f"out, n, groups, nthreads); return 0;" for k in ks)
        (d / f"{name}.cpp").write_text(HARNESS.replace("CASES", cases))
        jobs[name] = subprocess.Popen(
            [cxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fno-fast-math",
             "-fPIC", "-shared", "-pthread", f"-I{ek.CSRC}",
             str(d / f"{name}.cpp"), "-o", str(d / f"lib{name}.so")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    out = {}
    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
    for name, proc in jobs.items():
        _, err = proc.communicate()
        assert proc.returncode == 0, err[-4000:]
        so = ctypes.CDLL(str(d / f"lib{name}.so"))
        so.host_elementwise.argtypes = [ci, ci, ci, vp, cl, vp, cl, vp, cl,
                                        ci, ci]
        so.host_elementwise.restype = ci
        out[name] = so
    return out


def _lib(libs, design, k):
    return next(libs[name] for name, (d, ks) in PARTS.items()
                if d == design and k in ks)


def _same(got, want, label):
    assert torch.equal(got.isnan(), want.isnan()), label
    nan = got.isnan() | want.isnan()
    bad = ((got.view(torch.int64) != want.view(torch.int64)) & ~nan).any(-1)
    assert not bad.any(), (label, bad.nonzero()[:4].flatten().tolist())


def _operands(k, n, seed):
    """(a, b): n pairs of normalized K-word values over exponents
    2^-500..2^500 with zeros, NaN, +-inf, values near both ends of the
    float64 range, -0, an exact cancellation and a zero divisor."""
    rng = np.random.default_rng(seed)

    def rnd():
        e = rng.integers(-500, 500, size=(n, 1))
        w = rng.standard_normal((n, k)) * 2.0 ** (e - 53 * np.arange(k))
        w[rng.random(n) < 0.05] = 0.0
        x = core.renorm_words(torch.from_numpy(w), k)
        x[1] = np.nan
        x[2:4] = 0.0
        x[2, 0], x[3, 0] = np.inf, -np.inf
        x[4] = 0.0
        x[4, 0] = 2.0 ** 1000
        x[5] = 0.0
        x[5, 0] = 2.0 ** -1000
        x[6] = -0.0
        if k > 1:
            x[8, -1] = np.nan
        return x.contiguous()

    a, b = rnd(), rnd()
    b[9] = -a[9]      # exact cancellation
    b[10] = 0.0       # a zero divisor and summand
    return a, b


PLAIN = (("add", core.add_plain), ("mul", core.mul_plain),
         ("div", core.div_plain), ("add_f64", core.add_f64_plain),
         ("mul_f64", core.mul_f64_plain))


def _check(so, design, k, n, seed, groups):
    a, b = _operands(k, n, seed)
    for op, (name, plain) in enumerate(PLAIN):
        y = b[:, 0].contiguous() if op >= 3 else b
        width = 1 if op >= 3 else k
        for yy, sb in ((y, width), (y[:1].contiguous(), 0)):
            out = torch.empty_like(a)
            assert so.host_elementwise(k, design, op, a.data_ptr(), k,
                                       yy.data_ptr(), sb, out.data_ptr(), n,
                                       groups, BLOCK) == 0
            want = plain(a, yy if sb else yy.expand(y.shape))
            _same(out, want, (k, design, name, sb))


@pytest.mark.parametrize("k", THREAD_KS)
def test_thread_design_matches_plain(libs, k):
    """A value a thread: 75 values over two blocks of 32 (the grid-stride
    loop takes a second and a ragged third chunk)."""
    _check(_lib(libs, 0, k), 0, k, 75, 300 + k, 2)


@pytest.mark.parametrize("k", WARP_KS)
def test_warp_design_matches_plain(libs, k):
    """A value a warp: 13 values over 3 warps (the grid-stride loop)."""
    _check(_lib(libs, 1, k), 1, k, 13, 400 + k, 3)
