"""The expansion column-loop kernels' code above K = 20 against their
plain loops, on the CPU.

Above ``ek.THREAD_MAX_WORDS`` words a thread cannot hold its operands in
registers, so ``csrc/expansion_panels.cuh`` runs every operation of the
column loops on a warp: ``chol_panel_block_warps`` (the pivot warp a
step ahead, each update row and update entry on one of the three update
warps) and ``solve_column_warp`` (a warp a right-hand-side column).
Here that code is compiled with g++ -ffp-contract=off and run as
tests/test_torch_expansion_panels.py runs the code below K = 20: a block
of 128 host threads with ``std::barrier`` as the block barrier, as the
update warps' named barrier and as each warp's ``__syncwarp()``; the
blocks one after another.  It is held bit for bit, NaN in the same places, to
``cholesky_panel_plain`` and ``solve_unblocked_plain`` at K = 23 (and
the Cholesky at K = 33, where a warp holds two words a lane): an
unblocked factor, a tall panel over two row tiles (the second block
computing the pivot block again), a non-PD matrix, and both solve
orientations with NaN and +-inf words.
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

K = 23
THREADS = 128
# the Cholesky's pivot program moves a slot's words two a lane above 32
K_TWO_A_LANE = 33

HARNESS = r"""
#include <algorithm>
#include <barrier>
#include <memory>
#include <thread>
#include <vector>

struct BlockSync {
  std::unique_ptr<std::barrier<>> block, update;
  std::vector<std::unique_ptr<std::barrier<>>> warp;
};
static BlockSync* g_bs;
static thread_local int g_tid;

#define EXP_HD inline
#define EXP_BLOCK inline
#define EXP_OUT_OF_LINE inline
#define EXP_SYNC() g_bs->block->arrive_and_wait()
#define EXP_SYNC_UPDATE(n) g_bs->update->arrive_and_wait()
#define EXP_SYNC_WARP() g_bs->warp[g_tid >> 5]->arrive_and_wait()
#include "expansion_panels.cuh"

template <class F>
static void run_block(int nthreads, F body) {
  BlockSync bs;
  bs.block.reset(new std::barrier<>(nthreads));
  bs.update.reset(new std::barrier<>(nthreads - 32));
  for (int w = 0; w < nthreads / 32; ++w)
    bs.warp.emplace_back(new std::barrier<>(32));
  g_bs = &bs;
  std::vector<std::thread> threads;
  for (int t = 0; t < nthreads; ++t)
    threads.emplace_back([&body, t] {
      g_tid = t;
      body(t);
    });
  for (auto& t : threads) t.join();
}

// csrc/expansion_chol.cu's grid above K = 20: block b * tiles + tile.
template <int K>
static void chol(const double* in, double* out, int bb, int R, int W,
                 int rt) {
  const int tiles = std::max(1, (R - W + rt - 1) / rt);
  std::vector<double> scratch((size_t)std::max(1, bb * (tiles - 1)) * W * W
                              * K);
  for (int blk = bb * tiles - 1; blk >= 0; --blk) {
    const int b = blk / tiles, tile = blk % tiles;
    const long panel = (long)R * W * K;
    const int row0 = W + tile * rt;
    const int nt = std::max(0, std::min(rt, R - row0));
    double* diag = tile == 0 ? out + b * panel
        : scratch.data() + ((long)b * (tiles - 1) + tile - 1) * W * W * K;
    std::vector<double> sh(
        expn::chol_warps_smem_words<K>(W + (R > W ? rt : 0), THREADS),
        -1e300);
    run_block(THREADS, [&](int tid) {
      expn::chol_panel_block_warps<K>(
          in + b * panel, in + b * panel + (long)row0 * W * K, diag,
          out + b * panel + (long)row0 * W * K, W, nt, sh.data(), tid,
          THREADS);
    });
  }
}

extern "C" void host_chol(int k, const double* in, double* out, int bb,
                          int R, int W, int rt) {
  if (k == KWORDS) chol<KWORDS>(in, out, bb, R, W, rt);
  if (k == KTWO) chol<KTWO>(in, out, bb, R, W, rt);
}

// csrc/expansion_solve.cu's grid above K = 20: a warp a column, the
// columns one warp after another.
extern "C" void host_solve(const double* L, const double* B,
                           const double* inv_d, double* X, int bb, int n,
                           int m, int transpose) {
  constexpr int K = KWORDS;
  std::vector<double> tree((size_t)bb * m * n * K, -1e300);
  for (int b = 0; b < bb; ++b)
    for (int col = m - 1; col >= 0; --col) {
      std::vector<double> sh(expn::warp::scratch_words<K>(), -1e300);
      const long nm = (long)n * m * K;
      run_block(32, [&](int tid) {
        expn::solve_column_warp<K>(
            L + (long)b * n * n * K, B + b * nm, inv_d + (long)b * n * K,
            X + b * nm, tree.data() + ((long)b * m + col) * n * K, n, m, col,
            transpose != 0, sh.data(), tid);
      });
    }
}
"""


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler (g++) to build the block code")
    d = tmp_path_factory.mktemp("expansion_panels_wide_host")
    src = (HARNESS.replace("KWORDS", str(K))
           .replace("KTWO", str(K_TWO_A_LANE))
           .replace("THREADS", str(THREADS)))
    (d / "harness.cpp").write_text(src)
    lib = d / "libexpansion_panels_wide.so"
    proc = subprocess.run(
        [cxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fno-fast-math",
         "-fPIC", "-shared", "-pthread", f"-I{ek.CSRC}",
         str(d / "harness.cpp"), "-o", str(lib)],
        capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    so = ctypes.CDLL(str(lib))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    so.host_chol.argtypes = [ci, vp, vp, ci, ci, ci, ci]
    so.host_solve.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci]
    return so


def _same(got, want):
    assert got.shape == want.shape
    assert torch.equal(got.isnan(), want.isnan())
    nan = got.isnan() | want.isnan()
    bad = ((got.view(torch.int64) != want.view(torch.int64)) & ~nan).any(-1)
    assert not bad.any(), bad.nonzero()[:4].tolist()


def _expansions(x, rng, k=K):
    w = np.stack([x] + [x * rng.standard_normal(x.shape) * 2.0 ** (-53 * i)
                        for i in range(1, k)], axis=-1)
    return core.renorm_words(torch.from_numpy(w), k)


def _spd(rng, bb, n):
    g = rng.standard_normal((bb, n, n))
    return g @ g.transpose(0, 2, 1) + n * np.eye(n)


def _chol(so, c, rt):
    c = c.contiguous()
    out = torch.empty_like(c)
    bb, R, W, k = c.shape
    so.host_chol(k, c.data_ptr(), out.data_ptr(), bb, R, W, rt)
    return out


def _solve(so, lfac, b, inv_d, transpose):
    out = torch.empty_like(b)
    bb, n, m, _ = b.shape
    so.host_solve(lfac.data_ptr(), b.data_ptr(), inv_d.data_ptr(),
                  out.data_ptr(), bb, n, m, int(transpose))
    return out


def test_cholesky_warps_match_plain(host):
    """The unblocked factor of (2, 6, 6), the second batch element not
    positive definite (NaN from its failing pivot on), and a (1, 14, 5)
    panel over row tiles of 5 rows, a NaN and a +inf word in it."""
    rng = np.random.default_rng(23)
    a = _expansions(_spd(rng, 2, 6), rng)
    a[1, 3, 3] = -a[1, 3, 3]
    got = _chol(host, a, 8)
    assert torch.isfinite(got[0]).all() and got[1].isnan().any()
    _same(got, ek.cholesky_panel_plain(a))
    c = _expansions(_spd(rng, 1, 14)[:, :, :5], rng)
    _same(_chol(host, c, 5), ek.cholesky_panel_plain(c))
    c[0, 8, 1, 0] = np.nan
    c[0, 12, 3, 0] = np.inf
    _same(_chol(host, c, 5), ek.cholesky_panel_plain(c))


def test_solve_warps_match_plain(host):
    """(1, 7, 7) x 3 in both orientations, then with a +inf word in L and
    a NaN word and a zero row in B."""
    rng = np.random.default_rng(24)
    n = 7
    lo = np.tril(rng.standard_normal((1, n, n)), -1) + n * np.eye(n)
    lfac = _expansions(lo, rng)
    didx = torch.arange(n)
    inv_d = core.recip(lfac[:, didx, didx, :]).contiguous()
    b = _expansions(rng.standard_normal((1, n, 3)), rng)
    for transpose in (False, True):
        _same(_solve(host, lfac, b, inv_d, transpose),
              ek.solve_unblocked_plain(lfac, b, inv_d, transpose))
    lfac[0, 4, 2, 0] = np.inf
    b[0, 1, 2, 0] = np.nan
    b[0, 5] = 0.0
    for transpose in (False, True):
        _same(_solve(host, lfac, b, inv_d, transpose),
              ek.solve_unblocked_plain(lfac, b, inv_d, transpose))


def test_cholesky_two_words_a_lane_matches_plain(host):
    """K = 33: the pivot program's slots hold more words than a warp has
    lanes; the unblocked factor of (1, 4, 4)."""
    rng = np.random.default_rng(33)
    a = _expansions(_spd(rng, 1, 4), rng, K_TWO_A_LANE)
    _same(_chol(host, a, 8), ek.cholesky_panel_plain(a))
