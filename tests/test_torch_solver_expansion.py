"""The port's float64-expansion solve (sdpb_tpu's --device cpu format)
on the CPU, on the committed quickstart 1d SDP at --precision 212
(K = 4 words).

- The SDP is read into the same float64 words as sdpb_tpu reads it,
  bucketed and unbucketed, bit for bit.
- 3 iterations track sdpb_tpu's expansion trajectory, recorded by
  tests/make_torch_reference_trajectories.py (a live JAX run of it
  compiles for ~90 s): objectives, mu, gap and the corrector beta to
  1e-25 relative, the error norms (float64 estimates) to 1e-12
  relative, the step lengths to 1e-12 absolute.  The two runs differ
  in the last words of the Cholesky pivots (sdpb_tpu's rsqrt seed is
  not correctly rounded on XLA's CPU, tests/test_torch_expansion.py)
  and in the eigenvectors behind the step lengths (two LAPACK builds),
  both far below these bounds.
- ``sdpb --device cpu`` solves in expansions and writes out.txt; its
  --precision has no cap (the limb kernels' cap is the card's).
"""

import json
import pathlib

import mpmath
import numpy as np
import pytest
import torch

from sdpb_tpu.io.sdp_json import read_sdp as j_read_sdp
from sdpb_tpu.solver import problem_from_raw as j_problem_from_raw
from sdpb_tpu.solver.data import bucketize as j_bucketize
from sdpb_tpu.solver.data import initial_state as j_initial_state
from sdpb_tpu_torch.apps import sdpb as app
from sdpb_tpu_torch.io.sdp_json import read_sdp as t_read_sdp
from sdpb_tpu_torch.solver import driver
from sdpb_tpu_torch.solver.data import (bucketed_problem_from_raw,
                                        initial_state, problem_from_arrays,
                                        problem_from_raw)
from sdpb_tpu_torch.solver.params import SolverParams

from torch_port_util import jax_arrays, sdpb_tpu_source_sha256
from torch_port_util import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
SDP_1D = ROOT / "sdpb_tpu_torch" / "data" / "quickstart_1d_sdp"
PREC = 212
K = 4


@pytest.fixture(scope="module")
def reference():
    data = json.loads((ROOT / "sdpb_tpu_torch" / "data" /
                       "reference_trajectories.json").read_text())
    assert data["sdpb_tpu_sha256"] == sdpb_tpu_source_sha256(), \
        "sdpb_tpu changed: rerun tests/make_torch_reference_trajectories.py"
    return data["quickstart_1d_expansion"]


def _params(**kw):
    return SolverParams(precision=PREC, word_dtype="float64", **kw)


def test_params_of_the_expansion_format():
    p = _params()
    assert (p.n_words, p.n_read_words, p.dtype) == (K, K, torch.float64)
    assert SolverParams(precision=5000, word_dtype="float64").n_words == 95
    assert p.mpconst("0.3").dtype == np.float64
    assert p.predictor_beta(True).tolist() == [0.0] * K
    # the limb format stays the default
    assert SolverParams(precision=PREC).dtype == torch.float32


def test_reading_the_1d_sdp_in_float64_matches_bit_for_bit():
    raw_j = j_read_sdp(SDP_1D, k=K)
    raw_t = t_read_sdp(SDP_1D, k=K)
    pj = j_problem_from_raw(raw_j)
    want = jax_arrays(j_bucketize(pj))
    problem_t = bucketed_problem_from_raw(raw_t, K, "cpu", torch.float64)
    assert problem_t.dtype == torch.float64
    assert np.array_equal(problem_t.b.numpy(), want["b"])
    assert np.array_equal(problem_t.objective_const.numpy(),
                          want["objective_const"])
    bk = problem_t.buckets[0]
    for name in ("c", "B"):
        assert np.array_equal(getattr(bk, name).numpy(),
                              want[f"buckets.0.{name}"])
    for p in range(2):
        assert np.array_equal(bk.q[p].numpy(), want[f"buckets.0.q.{p}"])
        assert np.array_equal(bk.u[p].numpy(), want[f"buckets.0.u.{p}"])
    # the unbucketed problem that approx_objective reads, from the raw
    # SDP and carried across from sdpb_tpu's
    flat = problem_from_raw(raw_t, "cpu", torch.float64, K)
    arrays = {"objective_const": np.asarray(pj.objective_const),
              "b": np.asarray(pj.b)}
    for j, bj in enumerate(pj.blocks):
        arrays.update({f"blocks.{j}.c": np.asarray(bj.c),
                       f"blocks.{j}.B": np.asarray(bj.B),
                       f"blocks.{j}.shape": np.array([bj.shape.m,
                                                      bj.shape.pts])})
        for p in range(2):
            arrays[f"blocks.{j}.q.{p}"] = np.asarray(bj.q[p])
            arrays[f"blocks.{j}.u.{p}"] = np.asarray(bj.u[p])
    carried, state = problem_from_arrays(arrays, "cpu")
    assert state is None
    # the unbucketed cold start
    sj = j_initial_state(pj, 1e20, 1e20)
    st = initial_state(flat, 1e20, 1e20)
    assert np.array_equal(st.y.numpy(), np.asarray(sj.y))
    for j in range(len(pj.blocks)):
        assert np.array_equal(st.x[j].numpy(), np.asarray(sj.x[j]))
        for p in range(2):
            assert np.array_equal(st.X[j][p].numpy(), np.asarray(sj.X[j][p]))
            assert np.array_equal(st.Y[j][p].numpy(), np.asarray(sj.Y[j][p]))
    for prob in (flat, carried):
        assert np.array_equal(prob.b.numpy(), np.asarray(pj.b))
        for bt, bj in zip(prob.blocks, pj.blocks):
            assert [getattr(bt.shape, f) for f in ("m", "pts", "he", "ho")] \
                == [getattr(bj.shape, f) for f in ("m", "pts", "he", "ho")]
            for name in ("c", "B"):
                assert np.array_equal(getattr(bt, name).numpy(),
                                      np.asarray(getattr(bj, name)))
            for p in range(2):
                assert np.array_equal(bt.q[p].numpy(), np.asarray(bj.q[p]))
                assert np.array_equal(bt.u[p].numpy(), np.asarray(bj.u[p]))


def _close(a, b, rel):
    ctx = mpmath.mp.clone()
    ctx.prec = 300
    a, b = ctx.mpf(a), ctx.mpf(b)
    return abs(a - b) <= rel * max(abs(a), abs(b), ctx.mpf("1e-300"))


def _track(records, reference, n):
    want = reference["iterations"][:n]
    assert len(records) == n
    for got, w in zip(records, want):
        for f in ("mu", "primal_objective", "dual_objective", "duality_gap",
                  "beta_corrector"):
            assert _close(getattr(got, f), w[f], 1e-25), (got.iteration, f)
        for f in ("primal_error_P", "primal_error_p", "dual_error"):
            assert _close(getattr(got, f), w[f], 1e-12), (got.iteration, f)
        for f in ("primal_step", "dual_step"):
            assert abs(getattr(got, f) - w[f]) <= 1e-12, (got.iteration, f)


def test_three_iterations_track_the_recorded_sdpb_tpu_run(reference):
    raw = t_read_sdp(SDP_1D, k=K)
    problem = bucketed_problem_from_raw(raw, K, "cpu", torch.float64)
    result = driver.solve(problem, _params(max_iterations=3))
    _track(result.iterations, reference, 3)
    assert result.state.y.dtype == torch.float64


def test_solve_refuses_a_problem_in_the_other_format():
    raw = t_read_sdp(SDP_1D, k=K)
    problem = bucketed_problem_from_raw(raw, K, "cpu", torch.float64)
    with pytest.raises(ValueError, match="float32"):
        driver.solve(problem, SolverParams(precision=PREC))


def test_cli_device_cpu_solves_in_expansions(tmp_path, reference, capsys):
    out = tmp_path / "out"
    rc = app.main(["-s", str(SDP_1D), "-o", str(out), "-c",
                   str(tmp_path / "ck"), "--precision", str(PREC),
                   "--device", "cpu", "--maxIterations", "3",
                   "--writeSolution", "x,y,z,X,Y"])
    assert rc == 0
    assert "float64 words" in capsys.readouterr().out
    fields = dict(line.rstrip(";").split(" = ", 1) for line in
                  (out / "out.txt").read_text().splitlines())
    assert fields["terminateReason"].strip() == \
        '"maxIterations exceeded"'
    # out.txt reports the residues after the 3rd step: iteration 4's
    assert _close(fields["primalObjective"],
                  reference["iterations"][3]["primal_objective"], 1e-25)
    for name in ("y.txt", "z.txt", "x_0.txt", "X_matrix_0.txt",
                 "Y_matrix_1.txt"):
        assert (out / name).exists(), name
    records = json.loads((out / "iterations.json").read_text())
    assert len(records) == 3
    meta = json.loads((tmp_path / "ck" / "checkpoint.json").read_text())
    assert meta["options"]["word_dtype"] == "float64"


def test_cli_device_cpu_takes_any_precision(tmp_path, monkeypatch, capsys):
    """--device cpu has no cap of its own: --precision 2800, above the
    card's expansion kernels (K <= 20, 1060 bits), reaches the solver
    as a 53-word float64 problem.  Its one limit is the CRT products'
    prime pool, shared with sdpb_tpu (~2800 bits): --precision 5000,
    above the limb kernels' cap of 4590 too, is refused at startup with
    exit 2 naming the pool's limit, where the estimate's CRT plan used
    to stop with a traceback."""
    seen = {}

    class Reached(Exception):
        pass

    def fake_solve(problem, params, **kw):
        seen.update(dtype=problem.dtype, k=problem.k)
        raise Reached

    monkeypatch.setattr(driver, "solve", fake_solve)
    argv = ["-s", str(SDP_1D), "-o", str(tmp_path / "out"), "-c",
            str(tmp_path / "ck"), "--device", "cpu", "--verbosity", "0"]
    with pytest.raises(Reached):
        app.main(argv + ["--precision", "2800"])
    assert seen == {"dtype": torch.float64, "k": 53}
    assert app.main(argv + ["--precision", "5000"]) == 2
    assert "prime pool" in capsys.readouterr().err
