"""The register and warp operations against the per-thread ones, on the
CPU.

``csrc/expansion_regs.cuh`` (a thread's operations in registers, and for
larger K in loops over the partial products' levels; K <= 20) and
``csrc/expansion_warp.cuh`` (one value per warp: a Cholesky step's pivot
chain, the elementwise kernel's value-a-warp design, every operation of
the kernels above K = 20) must give the bits of ``csrc/expansion.cuh``
(held to mp/core.py's plain versions in test_torch_expansion.py), for
add, mul, add_f64, mul_f64 and div, at K = 1..20 and (the warp's alone)
at K = 21, 23, 32, 33 and 54.  Here all three are compiled with g++
-ffp-contract=off (nvcc runs with -fmad=false); the warp operations run
on 32 host threads with a ``std::barrier`` as ``__syncwarp()``.  Inputs:
normalized expansions over exponents 2^-500..2^500 (at K = 20 the tails
reach the subnormal range), exact cancellation, NaN, +-inf, +-0, words
out of order (add_f64's sorting network) and values near both ends of
the float64 range, every word's bits compared (NaN in the same places).
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

KS = tuple(range(1, ek.THREAD_MAX_WORDS + 1))
# above THREAD_MAX_WORDS only the warp operations run: the first K, the
# 1200-bit one, both sides of the merge network's 32 pairs, the limit
WIDE_KS = (21, 23, 32, 33, 54)
WARP_KS = tuple(range(3, ek.THREAD_MAX_WORDS + 1)) + WIDE_KS
OPS = ("add", "mul", "add_f64", "mul_f64", "div")

REGS = r"""
#define EXP_HD inline
#include "expansion_regs.cuh"

// op: 0 add, 1 mul, 2 add_f64, 3 mul_f64 (b's first word), 4 div;
// out_new from expansion_regs.cuh, out_old from expansion.cuh.
template <int K>
static void run(int op, const double* a, const double* b, double* onew,
                double* oold, long n) {
  double buf[expn::regs::thread_words<K>() + expn::regs::div_words<K>()];
  const expn::regs::Emit em{buf, 1};
  for (long v = 0; v < n; ++v) {
    double x[K], y[K], o[K];
    for (int t = 0; t < K; ++t) {
      x[t] = a[v * K + t];
      y[t] = b[v * K + t];
    }
    if (op == 0) {
      expn::regs::add<K>(x, y, em, o);
      expn::add<K>(x, y, oold + v * K);
    } else if (op == 1) {
      expn::regs::mul<K>(x, y, em, o);
      expn::mul<K>(x, y, oold + v * K);
    } else if (op == 2) {
      expn::regs::add_f64<K>(x, y[0], em, o);
      expn::add_f64<K>(x, y[0], oold + v * K);
    } else if (op == 3) {
      expn::regs::mul_f64<K>(x, y[0], em, o);
      expn::mul_f64<K>(x, y[0], oold + v * K);
    } else {
      expn::regs::div<K>(x, y, 1, em, o);
      expn::div<K>(x, y, oold + v * K);
    }
    for (int t = 0; t < K; ++t) onew[v * K + t] = o[t];
  }
}

// expansion.cuh's operations alone (above THREAD_MAX_WORDS).
template <int K>
static void run_old(int op, const double* a, const double* b, double* oold,
                    long n) {
  for (long v = 0; v < n; ++v) {
    const double* x = a + v * K;
    const double* y = b + v * K;
    double* o = oold + v * K;
    switch (op) {
      case 0: expn::add<K>(x, y, o); break;
      case 1: expn::mul<K>(x, y, o); break;
      case 2: expn::add_f64<K>(x, y[0], o); break;
      case 3: expn::mul_f64<K>(x, y[0], o); break;
      default: expn::div<K>(x, y, o);
    }
  }
}

extern "C" int host_old(int k, int op, const double* a, const double* b,
                        double* oold, long n) {
  switch (k) {
    OLD_CASES
  }
  return 1;
}

extern "C" int host_regs(int k, int op, const double* a, const double* b,
                         double* onew, double* oold, long n) {
  switch (k) {
    CASES
  }
  return 1;
}
"""

WARP = r"""
#include <barrier>
#include <thread>
#include <vector>

static std::barrier<>* g_warp;
#define EXP_HD inline
#define EXP_BLOCK inline
#define EXP_OUT_OF_LINE inline
#define EXP_SYNC_WARP() g_warp->arrive_and_wait()
#include "expansion_warp.cuh"

// One warp (32 host threads) a value: op 0 add, 1 mul, 2 add_f64, 3
// mul_f64 (b's first word), 4 div, out from expansion_warp.cuh.
template <int K>
static void run(int op, const double* a, const double* b, double* out,
                long n) {
  // the scratch, then div's divisor and quotient words
  std::vector<double> w(expn::warp::scratch_words<K>() + 2 * K + 1);
  const expn::warp::Scratch<K> ws(w.data());
  double* bw = w.data() + expn::warp::scratch_words<K>();
  std::barrier<> sync(32);
  g_warp = &sync;
  std::vector<std::thread> lanes;
  for (int lane = 0; lane < 32; ++lane)
    lanes.emplace_back([&, lane] {
      expn::warp::init_codes<K>(ws, lane);
      for (long v = 0; v < n; ++v) {
        for (int t = lane; t < K; t += 32) {
          ws.x[t] = a[v * K + t];
          ws.y[t] = b[v * K + t];
          bw[t] = b[v * K + t];
        }
        EXP_SYNC_WARP();
        const double f = b[v * K];
        const expn::warp::Res r =
            op == 0 ? expn::warp::add<K>(ws, lane)
            : op == 1 ? expn::warp::mul<K>(ws, lane)
            : op == 2 ? expn::warp::add_f64<K>(ws, f, lane)
            : op == 3 ? expn::warp::mul_f64<K>(ws, ws.x, f, lane)
                      : expn::warp::div<K>(ws, bw, bw + K, lane);
        EXP_SYNC_WARP();
        for (int t = lane; t < K; t += 32)
          out[v * K + t] = expn::warp::res_word<K>(ws, r, t);
        EXP_SYNC_WARP();
      }
    });
  for (auto& t : lanes) t.join();
}

extern "C" int host_warp(int k, int op, const double* a, const double* b,
                         double* out, long n) {
  switch (k) {
    CASES
  }
  return 1;
}
"""


def _build(d, name, src, cases, old_cases=""):
    (d / f"{name}.cpp").write_text(src.replace("OLD_CASES", old_cases)
                                   .replace("CASES", cases))
    return subprocess.Popen(
        [shutil.which("g++"), "-std=c++20", "-O1", "-ffp-contract=off",
         "-fno-fast-math", "-fPIC", "-shared", "-pthread", f"-I{ek.CSRC}",
         str(d / f"{name}.cpp"), "-o", str(d / f"lib{name}.so")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler (g++) to build the operations")
    d = tmp_path_factory.mktemp("expansion_ops_host")
    # the register operations in two halves, and the warp operations, all
    # compiled at once
    jobs = {
        "regs_lo": _build(d, "regs_lo", REGS, " ".join(
            f"case {k}: run<{k}>(op, a, b, onew, oold, n); return 0;"
            for k in KS if k <= 12)),
        "regs_hi": _build(d, "regs_hi", REGS, " ".join(
            f"case {k}: run<{k}>(op, a, b, onew, oold, n); return 0;"
            for k in KS if k > 12), " ".join(
            f"case {k}: run_old<{k}>(op, a, b, oold, n); return 0;"
            for k in WIDE_KS)),
        "warp": _build(d, "warp", WARP, " ".join(
            f"case {k}: run<{k}>(op, a, b, out, n); return 0;"
            for k in WARP_KS if k <= 20)),
        "warp_wide": _build(d, "warp_wide", WARP, " ".join(
            f"case {k}: run<{k}>(op, a, b, out, n); return 0;"
            for k in WIDE_KS)),
    }
    out = {}
    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
    for name, proc in jobs.items():
        _, err = proc.communicate()
        assert proc.returncode == 0, err[-4000:]
        so = ctypes.CDLL(str(d / f"lib{name}.so"))
        if name.startswith("warp"):
            so.host_warp.argtypes = [ci, ci, vp, vp, vp, cl]
            so.host_warp.restype = ci
        else:
            so.host_regs.argtypes = [ci, ci, vp, vp, vp, vp, cl]
            so.host_regs.restype = ci
            so.host_old.argtypes = [ci, ci, vp, vp, vp, cl]
            so.host_old.restype = ci
        out[name] = so
    return out


def _same(got, want, label):
    nan = got.isnan() | want.isnan()
    assert torch.equal(got.isnan(), want.isnan()), label
    bad = ((got.view(torch.int64) != want.view(torch.int64)) & ~nan).any(-1)
    assert not bad.any(), (label, bad.nonzero()[:4].flatten().tolist())


def _operands(k, n, seed):
    """(a, b): n pairs of K-word values, random normalized expansions with
    special values and unsorted words among them."""
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
        # words out of order: add_f64 sorts them
        x[7] = torch.from_numpy(rng.standard_normal(k)
                                * 2.0 ** rng.integers(-60, 60, k))
        if k > 1:
            x[8, -1] = np.nan
        return x.contiguous()

    a, b = rnd(), rnd()
    b[9] = -a[9]      # exact cancellation
    b[10] = a[10]
    return a, b


@pytest.mark.parametrize("k", KS)
def test_register_ops_match_per_thread_ops(libs, k):
    """expansion_regs.cuh add, mul (unrolled up to K = 8, streamed over
    the levels above), add_f64, mul_f64 and div give expansion.cuh's
    bits."""
    a, b = _operands(k, 200, k)
    so = libs["regs_lo" if k <= 12 else "regs_hi"]
    for op, name in enumerate(OPS):
        new, old = torch.empty_like(a), torch.empty_like(a)
        assert so.host_regs(k, op, a.data_ptr(), b.data_ptr(),
                            new.data_ptr(), old.data_ptr(), a.shape[0]) == 0
        _same(new, old, (k, name))


@pytest.mark.parametrize("k", WARP_KS)
def test_warp_ops_match_per_thread_ops(libs, k):
    """expansion_warp.cuh add, mul, add_f64, mul_f64 and div (a value a
    warp; the renormalization unrolled up to 96 words, in loops above;
    above K = 20 the product streamed a level at a time) give
    expansion.cuh's bits."""
    wide = k > ek.THREAD_MAX_WORDS
    a, b = _operands(k, 24 if wide else 48, 100 + k)
    so = libs["regs_lo" if k <= 12 else "regs_hi"]
    for op, name in enumerate(OPS):
        got, new, old = (torch.empty_like(a) for _ in range(3))
        assert libs["warp_wide" if wide else "warp"].host_warp(
            k, op, a.data_ptr(), b.data_ptr(), got.data_ptr(),
            a.shape[0]) == 0
        if wide:
            assert so.host_old(k, op, a.data_ptr(), b.data_ptr(),
                               old.data_ptr(), a.shape[0]) == 0
        else:
            assert so.host_regs(k, op, a.data_ptr(), b.data_ptr(),
                                new.data_ptr(), old.data_ptr(),
                                a.shape[0]) == 0
        _same(got, old, (k, name))
