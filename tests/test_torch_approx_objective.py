"""The port's approx_objective against sdpb_tpu's functions on the CPU,
on the solution of the quickstart 1d SDP that
tests/make_torch_reference_trajectories.py recorded (sdpb_tpu's
expansion solve at --precision 212, K = 4 words).

- A zero perturbation gives exactly zero linear and quadratic terms.
- A perturbed c (and b): the linear term is a sum of expansion
  products of the same words in the same order, equal bit for bit.
  The quadratic term goes through the rebuilt Schur and Q Cholesky
  factors, whose pivots' rsqrt seeds XLA's CPU and PyTorch round
  differently (tests/test_torch_expansion.py) in the last of 212 bits
  (~1e-64 relative); at the solution the Schur complement's condition
  estimate is ~4e59, which amplifies that to 8.4e-36 (measured): the
  quadratic term is held to 1e-30 relative, the objective (which adds
  it, ~1e-6 of the total) to 1e-38.
- The CLI writes and reloads its solver state, and runs on the CUDA
  device unless told "cpu" (it raises without one).
"""

import json
import pathlib

import jax
import jax.numpy as jnp
import mpmath
import numpy as np
import pytest
import torch

from sdpb_tpu.apps import approx_objective as japp
from sdpb_tpu.io.sdp_json import read_sdp as j_read_sdp
from sdpb_tpu.solver import problem_from_raw as j_problem_from_raw
from sdpb_tpu_torch.apps import approx_objective as tapp
from sdpb_tpu_torch.io import output as tout
from sdpb_tpu_torch.io.sdp_json import read_sdp as t_read_sdp
from sdpb_tpu_torch.mp import decimal as tdec
from sdpb_tpu_torch.solver.data import problem_from_raw

from torch_port_util import sdpb_tpu_source_sha256
from torch_port_util import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
SDP_1D = ROOT / "sdpb_tpu_torch" / "data" / "quickstart_1d_sdp"
K = 4


@pytest.fixture(scope="module")
def solution():
    data = json.loads((ROOT / "sdpb_tpu_torch" / "data" /
                       "reference_trajectories.json").read_text())
    assert data["sdpb_tpu_sha256"] == sdpb_tpu_source_sha256()
    sol = data["quickstart_1d_expansion"]["solution"]
    f = lambda v: np.asarray(v, dtype=np.float64)
    blocks = sol["blocks"]
    return {"y": f(sol["y"]), "x": [f(b["x"]) for b in blocks],
            "X": [tuple(f(m) if f(m).size else np.zeros((0, 0, K))
                        for m in b["X"]) for b in blocks],
            "Y": [tuple(f(m) if f(m).size else np.zeros((0, 0, K))
                        for m in b["Y"]) for b in blocks]}


def _perturbation(raw, scale):
    """(d_const, d_b, d_c, d_B) as float64 expansions: c and b moved by
    seeded random amounts of relative size ``scale``, B unchanged."""
    rng = np.random.default_rng(17)

    def move(a):
        d = np.zeros_like(a)
        d[..., 0] = scale * rng.standard_normal(a.shape[:-1])
        return d

    return (np.zeros(K), move(np.asarray(raw.b)),
            [move(np.asarray(rb.c)) for rb in raw.blocks],
            [np.zeros_like(np.asarray(rb.B)) for rb in raw.blocks])


def _mp(words):
    ctx = mpmath.mp.clone()
    ctx.prec = 400
    return ctx.fsum(ctx.mpf(float(w)) for w in np.asarray(words).ravel())


def _rel(a, b):
    a, b = _mp(a), _mp(b)
    return float(abs(a - b) / max(abs(b), mpmath.mpf("1e-300")))


def _jax_side(raw, sol, pert):
    problem = j_problem_from_raw(raw)
    j = jnp.asarray
    x = [j(v) for v in sol["x"]]
    fac = jax.jit(japp.setup_factorizations)(
        problem, [tuple(j(m) for m in X) for X in sol["X"]],
        [tuple(j(m) for m in Y) for Y in sol["Y"]], x, j(sol["y"]))
    d_const, d_b, d_c, d_B = pert
    return japp.approx_objective(problem, x, j(sol["y"]), j(d_const), j(d_b),
                                 [j(v) for v in d_c], [j(v) for v in d_B],
                                 factorizations=fac)


def _torch_side(raw, sol, pert):
    problem = problem_from_raw(raw, "cpu", torch.float64, K)
    t = torch.from_numpy
    x = [t(v) for v in sol["x"]]
    fac = tapp.setup_factorizations(
        problem, [tuple(t(m) for m in X) for X in sol["X"]],
        [tuple(t(m) for m in Y) for Y in sol["Y"]], x, t(sol["y"]))
    d_const, d_b, d_c, d_B = pert
    out = tapp.approx_objective(problem, x, t(sol["y"]), t(d_const),
                                t(d_b), [t(v) for v in d_c],
                                [t(v) for v in d_B], factorizations=fac)
    return out, fac


def test_zero_perturbation_gives_zero(solution):
    raw = t_read_sdp(SDP_1D, k=K)
    (total, d_obj, dd_obj), _ = _torch_side(raw, solution,
                                            _perturbation(raw, 0.0))
    assert not d_obj.numpy().any() and not dd_obj.numpy().any()
    # the objective b.y of the solved SDP: within the duality gap
    # (< 1e-30 relative) of sdpb_tpu's recorded primal objective
    ctx = mpmath.mp.clone()
    ctx.prec = 400
    want = ctx.mpf("1.84026576313204924668804017173148301784425")
    assert abs(_mp(total.numpy()) - want) < ctx.mpf("1e-29")


def test_perturbed_c_and_b_match_sdpb_tpu(solution):
    raw_t = t_read_sdp(SDP_1D, k=K)
    raw_j = j_read_sdp(SDP_1D, k=K)
    pert = _perturbation(raw_t, 1e-3)
    (total, d_obj, dd_obj), _ = _torch_side(raw_t, solution, pert)
    jt, jd, jdd = _jax_side(raw_j, solution, pert)
    assert np.array_equal(d_obj.numpy(), np.asarray(jd))
    assert _rel(total.numpy(), np.asarray(jt)) <= 1e-38
    assert _rel(dd_obj.numpy(), np.asarray(jdd)) <= 1e-30
    assert float(_mp(dd_obj.numpy())) != 0.0


def _write_solution(out, sol):
    out.mkdir()
    tout.write_vector(out / "y.txt", sol["y"])
    for j, x in enumerate(sol["x"]):
        tout.write_vector(out / f"x_{j}.txt", x)
        for p in range(2):
            if sol["X"][j][p].size:
                tout.write_matrix(out / f"X_matrix_{2 * j + p}.txt",
                                  sol["X"][j][p])
                tout.write_matrix(out / f"Y_matrix_{2 * j + p}.txt",
                                  sol["Y"][j][p])


def test_cli_writes_and_reloads_the_solver_state(solution, tmp_path,
                                                 capsys):
    out = tmp_path / "sol"
    _write_solution(out, solution)
    argv = ["--sdp", str(SDP_1D), "--precision", "212", "--newSdp",
            str(SDP_1D), "--solutionDir", str(out), "--writeSolverState"]
    assert tapp.main(argv, device="cpu") == 0
    first = json.loads(capsys.readouterr().out)
    assert (out / "Q_cholesky.txt").exists()
    assert tapp.main(argv, device="cpu") == 0
    captured = capsys.readouterr()
    assert "loaded solver state" in captured.err
    second = json.loads(captured.out)
    assert first == second
    assert [tdec.to_decimal(np.zeros(K))] * 2 == [
        first[0]["d_objective"], first[0]["dd_objective"]]


def test_cli_needs_a_card_unless_told_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapp.main(["--sdp", str(SDP_1D), "--precision", "212",
                   "--solutionDir", str(tmp_path), "--linear"])
