"""The port's synthetic problem and two solver iterations on it against
sdpb_tpu on the CPU: bench.py's build_problem shrunk to 2 + 1 blocks
(m = 2 with 32 points, m = 4 with 24 points) and N = 16, at S = 14
(--precision 100).

The port builds the problem from the same seeded numpy stream, so the
arrays must agree bit for bit with bench.py's.  The iterations are held
to sdpb_tpu's trajectory on the same problem as recorded by
tests/make_torch_reference_trajectories.py in
sdpb_tpu_torch/data/reference_trajectories.json (a live JAX run of this
problem compiles for ~10 minutes on the CPU); the file carries the hash
of the sdpb_tpu sources it was recorded from, and the test fails when
they have changed since.  Tolerances per iteration
are those of test_torch_solver.py, where the 1d solve runs live against
sdpb_tpu, with the recorded values' 25 digits as an extra floor.
"""

import importlib.util
import json
import pathlib
from types import SimpleNamespace

import numpy as np

from sdpb_tpu.solver import SolverParams as JParams
from sdpb_tpu_torch.solver import driver, synthetic
from sdpb_tpu_torch.solver.data import bucketed_problem_from_arrays
from sdpb_tpu_torch.solver.params import SolverParams as TParams

from torch_port_util import compare_records, jax_arrays
from torch_port_util import sdpb_tpu_source_sha256
from torch_port_util import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
REFERENCE = ROOT / "sdpb_tpu_torch" / "data" / "reference_trajectories.json"
BUCKETS = ((2, 2, 32), (1, 4, 24))
N_DUAL = 16
PREC = 100


def _bench():
    spec = importlib.util.spec_from_file_location("bench", ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.N_DUAL = N_DUAL
    return mod


def test_shrunk_build_problem_matches_bench_bit_for_bit():
    jparams = JParams(precision=PREC, word_dtype="float32")
    problem_j, state_j = _bench().build_problem(jparams, buckets=BUCKETS)
    problem_a, state_a = bucketed_problem_from_arrays(
        jax_arrays(problem_j, state_j), "cpu")
    problem_t, state_t = synthetic.build_problem(
        TParams(precision=PREC), "cpu", buckets=BUCKETS, n_dual=N_DUAL)
    for bt, ba in zip(problem_t.buckets, problem_a.buckets):
        for f in ("c", "B"):
            assert np.array_equal(getattr(bt, f), getattr(ba, f)), f
        for p in range(2):
            assert np.array_equal(bt.q[p], ba.q[p])
            assert np.array_equal(bt.u[p], ba.u[p])
        assert bt.shape == ba.shape
        assert bt.block_indices == ba.block_indices
    assert np.array_equal(problem_t.b, problem_a.b)
    assert np.array_equal(problem_t.objective_const, problem_a.objective_const)
    for which in ("X", "Y"):
        for mt, ma in zip(getattr(state_t, which), getattr(state_a, which)):
            for p in range(2):
                assert np.array_equal(mt[p], ma[p])


def test_two_iterations_track_recorded_sdpb_tpu():
    recorded = json.loads(REFERENCE.read_text())
    assert recorded["sdpb_tpu_sha256"] == sdpb_tpu_source_sha256(), (
        "sdpb_tpu changed since the trajectories were recorded: rerun "
        "tests/make_torch_reference_trajectories.py")
    ref = recorded["synthetic_shrunk"]
    assert ref["precision"] == PREC and ref["n_dual"] == N_DUAL
    assert [tuple(b) for b in ref["buckets"]] == list(BUCKETS)
    params = TParams(precision=PREC, max_iterations=2)
    problem, state = synthetic.build_problem(params, "cpu", buckets=BUCKETS,
                                             n_dual=N_DUAL)
    result = driver.solve(problem, params, state=state)
    theirs = [SimpleNamespace(**row) for row in ref["iterations"]]
    compare_records(result.iterations, theirs, rel_mp=1e-10, rel_err=1e-5,
                    abs_step=1e-6)
