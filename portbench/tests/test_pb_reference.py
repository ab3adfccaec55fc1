"""The plain reference against the program on the CPU at a tiny size:
the frozen generator, sound runs within the limits, the control (one
word below the stated precision) and each fault outside them."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from portbench import control
from portbench import problem as pb
from portbench import run as harness

from . import pbutil

CELL = "p400-limbs.tiny"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    r = pbutil.bench_root(tmp_path_factory.mktemp("pbref"))
    pbutil.add_cell(r, CELL, "tiny-p400-limbs", "closed",
                    config_body=pbutil.tiny_config("tiny-p400-limbs"))
    return r


@pytest.mark.parametrize("word_format", ["limbs", "expansions"])
@pytest.mark.parametrize("buckets,n_dual,seed", [
    (((2, 2, 8), (1, 3, 6)), 16, 3),
    (((11, 1, 31),), 20, 2 ** 31 + 5)])
def test_generator_is_the_programs(buckets, n_dual, seed, word_format):
    """The frozen generator, handed to the program as a read SDP, gives
    the program's own problem (solver/synthetic.py), bit for bit."""
    from sdpb_tpu_torch.solver import synthetic

    params = harness.solver_params(pbutil.tiny_config(
        "t", word_format=word_format))
    got, _ = pb.to_program(pb.generate(seed, buckets, n_dual), params,
                           "cpu")
    want, _ = synthetic.build_problem(params, "cpu", buckets=buckets,
                                      n_dual=n_dual, seed=seed)
    assert torch.equal(got.b, want.b)
    for g, w in zip(got.buckets, want.buckets):
        for a, b in ((g.c, w.c), (g.B, w.B), (g.q[0], w.q[0]),
                     (g.q[1], w.q[1]), (g.u[0], w.u[0]), (g.u[1], w.u[1])):
            assert torch.equal(a, b)


def _readings(root, mode, seeds, iterations=2):
    return control.main(["--workload", CELL, "--mode", mode, "--iterations",
                         str(iterations), "--seeds", *map(str, seeds),
                         "--device", "cpu"], root=root)


def test_sound_runs_pass(root):
    limits = json.loads((root / f"portbench/limits/{CELL}.json").read_text())
    for line in _readings(root, "sound", [11]):
        r = line["readings"]
        assert line["passes"], r
        # a sound run is within a few units of the stated precision
        for name in ("direction", "beta", "mu", "residues"):
            assert r[name] < 100, (name, r)
        assert r["steps"] < limits["steps"]


def test_control_fails(root):
    for line in _readings(root, "control", [11]):
        assert not line["passes"], line["readings"]
        assert line["readings"]["direction"] > 1e12


@pytest.mark.parametrize("fault", control.FAULTS)
def test_fault_makes_run_incorrect(root, fault):
    """A whole run (the look for a card skipped) with the timed path
    broken underneath reports correct false."""
    with control.fault(fault):
        rc, lines, err = pbutil.run_cell(root, [
            "--workload", CELL, "--seed", "5", "--seconds", "0.1",
            "--trace", "0"])
    assert rc == 0, err
    res = json.loads(lines[-1])
    assert res["correct"] is False, res["check"]


def test_solves_restart_from_the_cold_start(root):
    """A solve that ends inside the window is followed by the next, from
    the cold start, and the judge starts each solve's first iteration
    there: judged as one trajectory, the second solve would fail."""
    from portbench import check

    cell = harness.load_cell(root, CELL)
    config = cell["config"]
    data = pb.generate(17, [tuple(b) for b in config["blocks"]],
                       int(config["n_dual"]))
    params = harness.solver_params(config, max_iterations=1)
    problem, _ = pb.to_program(data, params, "cpu")
    win = harness.window(problem, params, 0.0, torch.device("cpu"), False,
                         max_iterations=2, restart=True)
    assert [r["first_of_solve"] for r in win.records] == [True, True]
    limits = cell["limits"]
    r = check.judge(data, config, win.states, win.records, "cpu")
    assert check.verdict(r, limits), r
    win.records[1]["first_of_solve"] = False
    r = check.judge(data, config, win.states, win.records, "cpu")
    assert not check.verdict(r, limits), r


def test_mp_layer_against_mpmath():
    import mpmath

    from portbench.reference import mpt

    ctx = mpmath.mp.clone()
    ctx.prec = 2000
    rng = np.random.default_rng(0)
    a = rng.standard_normal((3, 5, 4)) * np.array([1e-30, 1.0, 1e40, 3.0])
    b = rng.standard_normal((3, 4, 6))
    A, B = (mpt.from_f64(torch.tensor(v), 8) for v in (a, b))
    C = mpt.matmul(A, B)
    for i in range(3):
        for j in range(5):
            for k in range(6):
                want = ctx.fsum(ctx.mpf(a[i, j, t]) * ctx.mpf(b[i, t, k])
                                for t in range(4))
                got = mpt.to_mpf(C[i, j, k], ctx)
                assert abs(got - want) <= abs(want) * ctx.mpf(2) ** -140
    M = rng.standard_normal((2, 6, 6))
    M = M @ M.transpose(0, 2, 1) + 6 * np.eye(6)
    Mm = mpt.from_f64(torch.tensor(M), 8)
    R = mpt.sub(mpt.eye(6, 8, "cpu", (2,)),
                mpt.matmul(Mm, mpt.inverse(Mm)))
    assert mpt.max_abs_f64(R) < 2.0 ** -130
    third = ctx.mpf(1) / 3
    assert abs(mpt.to_mpf(mpt.from_mpf(third, 8, "cpu"), ctx) - third) \
        < ctx.mpf(2) ** -150
    w = torch.tensor([[1.0, 2.0 ** -60, -2.0 ** -130]], dtype=torch.float64)
    assert mpt.to_mpf(mpt.from_f64_words(w, 8)[0], ctx) == \
        1 + ctx.mpf(2) ** -60 - ctx.mpf(2) ** -130
