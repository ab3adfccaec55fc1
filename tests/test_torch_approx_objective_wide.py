"""approx_objective above 1060 bits (K > 20 words), on the CPU, and the
word limits of the expansion kernels.

- At --precision 1200 (K = 23 words) the port's approx_objective
  matches sdpb_tpu's functions on the quickstart 1d SDP, on the solution
  that tests/make_torch_reference_trajectories.py recorded (sdpb_tpu's
  expansion solve at 212 bits, its words as the leading words of K = 23
  expansions): the linear term bit for bit, the quadratic term to 1e-30
  relative and the objective to 1e-38, as
  tests/test_torch_approx_objective.py holds them at 212 bits (the
  pivots' rsqrt seeds, which XLA's CPU and PyTorch round differently,
  amplified by the Schur complement's condition).
- The kernels take every K up to the CRT prime pool's limit: MAX_WORDS
  is the word count of max_crt_precision, and the CLI on the card checks
  the prime pool before the words, so that --precision 3000 exits 2
  naming the limit there as on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdpb_tpu.apps import approx_objective as japp
from sdpb_tpu.io.sdp_json import read_sdp as j_read_sdp
from sdpb_tpu.solver import problem_from_raw as j_problem_from_raw
from sdpb_tpu_torch.apps import approx_objective as tapp
from sdpb_tpu_torch.io.sdp_json import read_sdp as t_read_sdp
from sdpb_tpu_torch.ops import expansion_kernels as ek
from sdpb_tpu_torch.solver import driver, memory
from sdpb_tpu_torch.solver.data import problem_from_raw
from sdpb_tpu_torch.solver.params import SolverParams

from test_torch_approx_objective import (  # noqa: F401
    SDP_1D, _mp, _perturbation, _rel, solution)
from torch_port_util import one_torch_thread  # noqa: F401


PRECISION = 1200
K = SolverParams(precision=PRECISION, word_dtype="float64").n_words


def _widen(sol, k):
    """The recorded K = 4 solution as K-word expansions (zero words
    after its own)."""
    def pad(v):
        v = np.asarray(v)
        out = np.zeros(v.shape[:-1] + (k,))
        out[..., :v.shape[-1]] = v
        return out

    return {"y": pad(sol["y"]), "x": [pad(v) for v in sol["x"]],
            "X": [tuple(pad(m) for m in X) for X in sol["X"]],
            "Y": [tuple(pad(m) for m in Y) for Y in sol["Y"]]}


def _pert(raw):
    """_perturbation's moves (relative 1e-3, seeded) at K words."""
    d_const, d_b, d_c, d_B = _perturbation(raw, 1e-3)
    return (np.zeros(K), d_b, d_c, d_B)


def test_approx_objective_1200_bits_matches_sdpb_tpu(solution):
    sol = _widen(solution, K)
    raw_t = t_read_sdp(SDP_1D, k=K)
    raw_j = j_read_sdp(SDP_1D, k=K)
    d_const, d_b, d_c, d_B = _pert(raw_t)
    problem = problem_from_raw(raw_t, "cpu", torch.float64, K)
    t = torch.from_numpy
    x = [t(v) for v in sol["x"]]
    fac = tapp.setup_factorizations(
        problem, [tuple(t(m) for m in X) for X in sol["X"]],
        [tuple(t(m) for m in Y) for Y in sol["Y"]], x, t(sol["y"]))
    total, d_obj, dd_obj = tapp.approx_objective(
        problem, x, t(sol["y"]), t(d_const), t(d_b), [t(v) for v in d_c],
        [t(v) for v in d_B], factorizations=fac)
    jp = j_problem_from_raw(raw_j)
    j = jnp.asarray
    jx = [j(v) for v in sol["x"]]
    jfac = japp.setup_factorizations(
        jp, [tuple(j(m) for m in X) for X in sol["X"]],
        [tuple(j(m) for m in Y) for Y in sol["Y"]], jx, j(sol["y"]))
    jt, jd, jdd = japp.approx_objective(
        jp, jx, j(sol["y"]), j(d_const), j(d_b), [j(v) for v in d_c],
        [j(v) for v in d_B], factorizations=jfac)
    assert d_obj.shape[-1] == K
    assert np.array_equal(d_obj.numpy(), np.asarray(jd))
    assert _rel(total.numpy(), np.asarray(jt)) <= 1e-38
    assert _rel(dd_obj.numpy(), np.asarray(jdd)) <= 1e-30
    assert float(_mp(dd_obj.numpy())) != 0.0


def test_max_words_is_the_prime_pools_limit():
    """MAX_WORDS holds the largest precision the CRT prime pool takes
    (for one row, the most it ever takes), and the word checks of the
    kernels and of the library's solve admit every K up to it."""
    limit = memory.max_crt_precision(
        lambda p: SolverParams(precision=p, word_dtype="float64").n_words,
        torch.float64, 1)
    assert SolverParams(precision=limit,
                        word_dtype="float64").n_words == ek.MAX_WORDS
    assert ek.max_precision_bits() >= limit
    assert ek.THREAD_MAX_WORDS == 20 < ek.MAX_WORDS
    for k in (1, ek.THREAD_MAX_WORDS, ek.THREAD_MAX_WORDS + 1, K,
              ek.MAX_WORDS):
        ek.check_words("exp_mul", k)
    with pytest.raises(ValueError, match=f"limit of {ek.MAX_WORDS}"):
        ek.check_words("exp_mul", ek.MAX_WORDS + 1)
    assert [ek.elementwise_design(n, k) for n, k in (
        (1, 2), (10**6, 2), (1, 8), (10**6, 8), (10**6, 21), (1, 54))] == [
        "thread", "thread", "warp", "thread", "warp", "warp"]


class _CudaProblem:
    """What check_format reads of a problem held on the card."""

    def __init__(self, k):
        self.dtype, self.k = torch.float64, k
        self.device = torch.device("cuda", 0)


def test_library_solve_on_the_card_admits_the_prime_pools_words():
    params = SolverParams(precision=2800, word_dtype="float64")
    assert params.n_words > ek.THREAD_MAX_WORDS
    driver.check_format(_CudaProblem(params.n_words), params)
    with pytest.raises(ValueError, match="exceeds"):
        over = SolverParams(precision=53 * (ek.MAX_WORDS + 1),
                            word_dtype="float64")
        driver.check_format(_CudaProblem(over.n_words), over)


def test_cli_on_the_card_refuses_3000_bits_naming_the_limit(
        monkeypatch, tmp_path, capsys):
    """The card's path (no device given, a CUDA device present) checks
    the prime pool first: exit 2 naming the limit, before any word check
    or any tensor on the card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    rc = tapp.main(["--sdp", str(SDP_1D), "--precision", "3000",
                    "--newSdp", str(SDP_1D), "--solutionDir",
                    str(tmp_path / "missing"), "-v", "0"])
    assert rc == 2
    err = capsys.readouterr().err
    k = SolverParams(precision=3000, word_dtype="float64").n_words
    raw = t_read_sdp(SDP_1D, k=k)
    limit = memory.max_crt_precision(
        lambda p: SolverParams(precision=p, word_dtype="float64").n_words,
        torch.float64,
        memory.crt_rows(memory.shape_of_raw(raw, k, torch.float64)))
    assert "prime pool" in err and f"takes is {limit}" in err, err
