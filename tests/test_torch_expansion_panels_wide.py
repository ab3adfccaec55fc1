"""The expansion column-loop kernels' code above K = 20 against their
plain loops, on the CPU.

Above ``ek.THREAD_MAX_WORDS`` words a thread cannot hold its operands in
registers, so ``csrc/expansion_panels.cuh`` runs every operation of the
column loops on a warp, and spreads a step's operations over the warps of
a thread-block cluster: ``chol_cluster_warp`` (the pivot warp a step
ahead, the update warps taking the step's rows and update entries in
turn, two cluster barriers a step) and ``solve_cluster_warp`` (wc warps a
right-hand-side column: a row's terms and each tree level's pairs at
once, a cluster barrier after each; wc = 1 a warp a column).  Here that
code is compiled with g++ -ffp-contract=off and run with one host thread
per CUDA thread: every block of a cluster at once (each block its own
shared memory), a barrier of its own for each warp's ``__syncwarp()``,
and the cluster's barrier as a phase counter whose arrive and wait are
apart, as ``barrier.cluster.arrive`` and ``.wait``, which waits for the
threads that have not exited; the clusters one after another, as they
share nothing.  The emulated clusters are small (2
blocks of 2 warps, 1 block of 2, 2 blocks of 4) where the kernels' are 8
warps a block; the code takes both as parameters.

Each result is held bit for bit, NaN in the same places, to
``cholesky_panel_plain`` and ``solve_unblocked_plain`` at K = 23, 33
(two words a lane above 32) and 54 (the CRT prime pool's limit): an
unblocked factor, a non-PD matrix, a tall panel over several row tiles
(each tile's cluster computing the pivot block again) with NaN and +inf
words, and both solve orientations with NaN and +-inf words, a zero row,
and each of the two spreads.
"""

import ctypes
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from sdpb_tpu_torch.mp import core
from sdpb_tpu_torch.ops import expansion_kernels as ek

from torch_port_util import one_torch_thread  # noqa: F401,E402

KS = (23, 33, 54)
# the Cholesky's pivot program moves a slot's words two a lane above 32
K_TWO_A_LANE = 33

HARNESS = r"""
#include <algorithm>
#include <barrier>
#include <condition_variable>
#include <cstdlib>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

// barrier.cluster: a thread arrives (and may go on), then waits for the
// phase it arrived in to complete; the phase completes when every thread
// that has not exited has arrived.
struct PhaseBarrier {
  std::mutex mu;
  std::condition_variable cv;
  int n, count = 0;
  long gen = 0;
  explicit PhaseBarrier(int n) : n(n) {}
  long arrive() {
    std::lock_guard<std::mutex> lock(mu);
    const long g = gen;
    if (++count == n) {
      count = 0;
      ++gen;
      cv.notify_all();
    }
    return g;
  }
  void wait(long g) {
    std::unique_lock<std::mutex> lock(mu);
    cv.wait(lock, [&] { return gen > g; });
  }
  // an exited thread: the barrier waits for the others only
  void drop() {
    std::lock_guard<std::mutex> lock(mu);
    if (--n == count && count > 0) {
      count = 0;
      ++gen;
      cv.notify_all();
    }
  }
};

struct ClusterSync {
  std::unique_ptr<PhaseBarrier> cluster;
  std::vector<std::unique_ptr<std::barrier<>>> warp;
};
static thread_local ClusterSync* g_cs;
static thread_local int g_warp;
static thread_local long g_phase;

#define EXP_HD inline
#define EXP_BLOCK inline
#define EXP_OUT_OF_LINE inline
#define EXP_SYNC() std::abort()
#define EXP_SYNC_UPDATE(n) std::abort()
#define EXP_SYNC_WARP() g_cs->warp[g_warp]->arrive_and_wait()
#define EXP_CLUSTER_ARRIVE() (g_phase = g_cs->cluster->arrive())
#define EXP_CLUSTER_WAIT() g_cs->cluster->wait(g_phase)
#include "expansion_panels.cuh"

// The warps of one cluster at once, 32 host threads each: body(g, lane).
template <class F>
static void run_cluster(int warps, F body) {
  ClusterSync cs;
  cs.cluster.reset(new PhaseBarrier(warps * 32));
  for (int w = 0; w < warps; ++w) cs.warp.emplace_back(new std::barrier<>(32));
  std::vector<std::thread> threads;
  for (int t = 0; t < warps * 32; ++t)
    threads.emplace_back([&body, &cs, t] {
      g_cs = &cs;
      g_warp = t >> 5;
      body(t >> 5, t & 31);
      cs.cluster->drop();
    });
  for (auto& t : threads) t.join();
}

// csrc/expansion_chol.cu's grid above K = 20: clusters of P blocks of
// ``warps`` warps, cluster b * tiles + tile.
template <int K>
static void chol(const double* in, double* out, int bb, int R, int W, int rt,
                 int P, int warps) {
  const int tiles = std::max(1, (R - W + rt - 1) / rt);
  std::vector<double> scratch((size_t)std::max(1, bb * (tiles - 1)) * W * W
                              * K, -1e300);
  std::vector<double> share(
      (size_t)bb * tiles * expn::chol_cluster_share_words<K>(
          W + (R > W ? rt : 0)), -1e300);
  for (long cl = (long)bb * tiles - 1; cl >= 0; --cl) {
    std::vector<std::vector<double>> sh(
        P, std::vector<double>(expn::chol_cluster_smem_words<K>(warps),
                               -1e300));
    run_cluster(P * warps, [&](int g, int lane) {
      expn::chol_cluster_warp<K>(in, out, scratch.data(), share.data(), R, W,
                                 tiles, rt, P, warps, cl, g,
                                 sh[g / warps].data(), lane);
    });
  }
}

// csrc/expansion_solve.cu's grid above K = 20: wc warps a column.
template <int K>
static void solve(const double* L, const double* B, const double* inv_d,
                  double* X, int bb, int n, int m, int wc, int warps,
                  int transpose) {
  const int P = expn::solve_cluster_blocks(wc, warps);
  const int cpc = P * warps / wc;
  const long clusters = ((long)bb * m + cpc - 1) / cpc;
  std::vector<double> tree((size_t)bb * m * 2 * n * K, -1e300);
  const long words = expn::warp::scratch_words<K>();
  for (long cl = clusters - 1; cl >= 0; --cl) {
    std::vector<std::vector<double>> sh(
        P, std::vector<double>(warps * words, -1e300));
    run_cluster(P * warps, [&](int gw, int lane) {
      expn::solve_cluster_warp<K>(L, B, inv_d, X, tree.data(), bb, n, m, wc,
                                  warps, transpose != 0, cl, gw,
                                  sh[gw / warps].data() + (gw % warps) * words,
                                  lane);
    });
  }
}

extern "C" void host_chol(int k, const double* in, double* out, int bb,
                          int R, int W, int rt, int P, int warps) {
  if (k == 23) chol<23>(in, out, bb, R, W, rt, P, warps);
  if (k == 33) chol<33>(in, out, bb, R, W, rt, P, warps);
  if (k == 54) chol<54>(in, out, bb, R, W, rt, P, warps);
}

extern "C" void host_solve(int k, const double* L, const double* B,
                           const double* inv_d, double* X, int bb, int n,
                           int m, int wc, int warps, int transpose) {
  if (k == 23) solve<23>(L, B, inv_d, X, bb, n, m, wc, warps, transpose);
  if (k == 33) solve<33>(L, B, inv_d, X, bb, n, m, wc, warps, transpose);
  if (k == 54) solve<54>(L, B, inv_d, X, bb, n, m, wc, warps, transpose);
}
"""


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler (g++) to build the block code")
    d = tmp_path_factory.mktemp("expansion_panels_wide_host")
    (d / "harness.cpp").write_text(HARNESS)
    lib = d / "libexpansion_panels_wide.so"
    proc = subprocess.run(
        [cxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fno-fast-math",
         "-fPIC", "-shared", "-pthread", f"-I{ek.CSRC}",
         str(d / "harness.cpp"), "-o", str(lib)],
        capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    so = ctypes.CDLL(str(lib))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    so.host_chol.argtypes = [ci, vp, vp, ci, ci, ci, ci, ci, ci]
    so.host_solve.argtypes = [ci, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci]
    return so


def _same(got, want):
    assert got.shape == want.shape
    assert torch.equal(got.isnan(), want.isnan())
    nan = got.isnan() | want.isnan()
    bad = ((got.view(torch.int64) != want.view(torch.int64)) & ~nan).any(-1)
    assert not bad.any(), bad.nonzero()[:4].tolist()


def _expansions(x, rng, k):
    w = np.stack([x] + [x * rng.standard_normal(x.shape) * 2.0 ** (-53 * i)
                        for i in range(1, k)], axis=-1)
    return core.renorm_words(torch.from_numpy(w), k)


def _spd(rng, bb, n):
    g = rng.standard_normal((bb, n, n))
    return g @ g.transpose(0, 2, 1) + n * np.eye(n)


def _chol(so, c, rt, blocks=2, warps=2):
    c = c.contiguous()
    out = torch.empty_like(c)
    bb, R, W, k = c.shape
    so.host_chol(k, c.data_ptr(), out.data_ptr(), bb, R, W, rt, blocks,
                 warps)
    return out


def _solve(so, lfac, b, inv_d, transpose, wc, warps=2):
    out = torch.empty_like(b)
    bb, n, m, k = b.shape
    so.host_solve(k, lfac.data_ptr(), b.data_ptr(), inv_d.data_ptr(),
                  out.data_ptr(), bb, n, m, wc, warps, int(transpose))
    return out


# A plain loop's cost is its expansion products' (a Python loop over
# mul_terms, ~0.26 s a product at K = 54 whatever the batch), ~25 a
# Cholesky step; so each K's cases share one batch and one plain call,
# and the narrow panels (W = 5, 3, 2 at K = 23, 33, 54) keep them short;
# the emulations, in C++ through ctypes, run beside them in threads.
# The first W rows of a panel are its unblocked factor: the plain loop
# forms them from those rows alone, bit for bit.
CHOL_CASES = {23: (14, 5, 4), 33: (8, 3, 2), 54: (5, 2, 1)}  # R, W, rt
_PLAIN = {}


def _chol_input(k):
    """c (2, R, W) of an SPD matrix, its first batch element with a NaN
    and a +inf word below the pivot block, its second not positive
    definite at its last pivot (NaN from there on)."""
    R, W, _ = CHOL_CASES[k]
    rng = np.random.default_rng(k)
    c = _expansions(_spd(rng, 2, R)[:, :, :W], rng, k)
    c[0, W + 1, 0, 0] = np.nan
    c[0, R - 1, W - 1, 0] = np.inf
    c[1, W - 1, W - 1] = -c[1, W - 1, W - 1]
    return c


def _chol_plain(c):
    k = c.shape[-1]
    if ("chol", k) not in _PLAIN:
        _PLAIN["chol", k] = ek.cholesky_panel_plain(c)
    return _PLAIN["chol", k]


@pytest.mark.parametrize("k", KS)
def test_cholesky_warps_match_plain(host, k):
    """The unblocked factor (R == W), the second batch element not
    positive definite, on clusters of 4 blocks of 2 warps (the pivot
    warp's block taking no update) and of one block (a single update
    warp); and the tall panel over row tiles of rt rows (three clusters
    of 2 blocks), a NaN and a +inf word in it.  The emulations run in
    threads of their own beside the plain loop."""
    c = _chol_input(k)
    R, W, rt = CHOL_CASES[k]
    assert -(-(R - W) // rt) == 3
    with ThreadPoolExecutor(3) as pool:
        jobs = [pool.submit(_chol, host, c[:, :W], rt, blocks)
                for blocks in (4, 1)]
        tall = [pool.submit(_chol, host, c, rt, 2)]
        want = _chol_plain(c)
        assert torch.isfinite(want[0, :W]).all() and want[1].isnan().any()
        for job in jobs:
            _same(job.result(), want[:, :W])
        for job in tall:
            _same(job.result(), want)


@pytest.mark.parametrize("k", KS)
def test_solve_warps_match_plain(host, k):
    """(2, 5, 5) x 3 in both orientations, the second batch element
    with a +inf word in L and a NaN, a -inf word and a zero row in B;
    in each spread: wc = 1 (a warp a column, two columns a cluster of 2
    warps), wc = 2 (the root warp holding terms too), wc = 4 (a root and
    three leaf warps, two terms each; 2 blocks of 2 warps) and wc = 6 (a
    term a leaf warp; 3 blocks)."""
    rng = np.random.default_rng(100 + k)
    n = 5
    lo = np.tril(rng.standard_normal((2, n, n)), -1) + n * np.eye(n)
    lfac = _expansions(lo, rng, k)
    didx = torch.arange(n)
    inv_d = core.recip(lfac[:, didx, didx, :]).contiguous()
    b = _expansions(rng.standard_normal((2, n, 3)), rng, k)
    lfac[1, 3, 1, 0] = np.inf
    b[1, 1, 2, 0] = np.nan
    b[1, 2, 1, 0] = -np.inf
    b[1, 4] = 0.0
    spreads = (1, 2, 4, 6)
    with ThreadPoolExecutor(8) as pool:
        jobs = {(transpose, wc): pool.submit(_solve, host, lfac, b, inv_d,
                                             transpose, wc)
                for transpose in (False, True) for wc in spreads}
        for transpose in (False, True):
            want = ek.solve_unblocked_plain(lfac, b, inv_d, transpose)
            assert want[0].isfinite().all() and want[1].isnan().any()
            for wc in spreads:
                _same(jobs[transpose, wc].result(), want)


def test_cholesky_two_words_a_lane_matches_plain(host):
    """K = 33: the pivot program's slots hold more words than a warp has
    lanes; the unblocked factor on a cluster of 2 blocks of 4 warps, more
    update warps than the steps have rows and entries."""
    c = _chol_input(K_TWO_A_LANE)
    W = CHOL_CASES[K_TWO_A_LANE][1]
    _same(_chol(host, c[:, :W], 8, 2, 4), _chol_plain(c)[:, :W])


# Clusters of P = 1 .. 8 blocks a card of 132 SMs might hold at once,
# fewer of 3 and more blocks than the SMs allow where the GPCs do not
# divide: the Cholesky's blocks of 8 warps, one an SM; the solve's of 4,
# two an SM at K = 54 (their scratch), seven at K = 23 (registers).
CHOL_CLUSTERS = {1: 132, 2: 66, 3: 40, 4: 30, 5: 24, 6: 20, 7: 16, 8: 15}
SOLVE_CLUSTERS_K54 = {1: 264, 2: 132, 3: 88, 4: 64, 5: 50, 6: 42, 7: 36,
                      8: 30}
SOLVE_CLUSTERS_K23 = {1: 924, 2: 462, 3: 308, 4: 228, 5: 184, 6: 152,
                      7: 130, 8: 114}


def test_column_spreads_follow_the_batch():
    """The wrappers' choices: a Cholesky's clusters take up to 8 blocks
    while all of them fit on the card at once; a solve's columns take the
    warps that make a row cheapest in dependent products among those
    whose clusters all fit at once (and take at most 16 warps an SM
    where a column spans blocks): a root and two terms a leaf warp (two
    products a row) for the few columns of a small solve, fewer warps as
    the columns grow, a warp each once the columns fill the card (the
    full-width solves)."""
    assert ek.chol_cluster_blocks(2, CHOL_CLUSTERS) == 8
    assert ek.chol_cluster_blocks(11, CHOL_CLUSTERS) == 8
    assert ek.chol_cluster_blocks(48, CHOL_CLUSTERS) == 2
    assert ek.chol_cluster_blocks(16, CHOL_CLUSTERS) == 4
    assert ek.chol_cluster_blocks(200, CHOL_CLUSTERS) == 1
    assert [ek.solve_row_products(32, wc) for wc in (1, 2, 8, 16, 17, 33)] \
        == [33, 17, 5, 3, 2, 2]
    spread = ek.solve_column_warps
    assert spread(2, 32, 16, 132, SOLVE_CLUSTERS_K54) == 17
    assert spread(2, 32, 64, 132, SOLVE_CLUSTERS_K54) == 8
    assert spread(4, 32, 128, 132, SOLVE_CLUSTERS_K54) == 2
    assert spread(16, 48, 48, 132, SOLVE_CLUSTERS_K54) == 1
    assert spread(2, 32, 16, 132, SOLVE_CLUSTERS_K23) == 17
    assert spread(2, 32, 64, 132, SOLVE_CLUSTERS_K23) == 12
    assert spread(48, 32, 384, 132, SOLVE_CLUSTERS_K23) == 1
    assert spread(1, 5, 1, 132, SOLVE_CLUSTERS_K54) == 4
    assert spread(1, 3, 5, 132, SOLVE_CLUSTERS_K54) == 3
    assert spread(1, 1, 1, 132, SOLVE_CLUSTERS_K54) == 1
    assert spread(1, 64, 1, 132, SOLVE_CLUSTERS_K54) == 23
