"""The port's single-device limb solve against sdpb_tpu on the CPU, on
the committed quickstart 1d SDP (S = 26, --precision 212).

Tolerances, per iteration: objectives, mu, gap and the corrector beta
to 1e-10 relative (the port's lambda_min eigenvector comes from a
float64 eigh, sdpb_tpu's from a float32 one; the Rayleigh quotient
makes the step-length difference second order); the error norms to
1e-5 relative (both are float32 estimates, and XLA's exp2 on the CPU
is off by ~1e-6); step lengths to 1e-6 absolute.
"""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdpb_tpu.io import output as jout
from sdpb_tpu.io.sdp_json import read_sdp as j_read_sdp
from sdpb_tpu.solver import SolverParams as JParams
from sdpb_tpu.solver import problem_from_raw, solve as j_solve
from sdpb_tpu.solver.data import bucketize, initial_bucketed_state
from sdpb_tpu_torch.io import output as tout
from sdpb_tpu_torch.io.sdp_json import read_sdp as t_read_sdp
from sdpb_tpu_torch.solver import driver
from sdpb_tpu_torch.solver.data import (bucketed_problem_from_arrays,
                                        bucketed_problem_from_raw)
from sdpb_tpu_torch.solver.params import SolverParams as TParams

from torch_port_util import compare_records, jax_arrays
from torch_port_util import one_torch_thread  # noqa: F401

SDP_1D = pathlib.Path(__file__).resolve().parents[1] / "sdpb_tpu_torch" \
    / "data" / "quickstart_1d_sdp"
PREC = 212


@pytest.fixture(scope="module")
def jax_problem():
    params = JParams(precision=PREC, word_dtype="float32")
    raw = j_read_sdp(SDP_1D, k=TParams(precision=PREC).n_read_words)
    return raw, bucketize(problem_from_raw(raw, dtype=jnp.float32,
                                           k=params.n_words))


def test_reading_the_1d_sdp_matches_bit_for_bit(jax_problem):
    raw_j, problem_j = jax_problem
    tp = TParams(precision=PREC)
    raw_t = t_read_sdp(SDP_1D, k=tp.n_read_words)
    assert np.array_equal(raw_t.b, raw_j.b)
    assert np.array_equal(raw_t.objective_const, raw_j.objective_const)
    assert raw_t.normalization == raw_j.normalization
    for bt, bj in zip(raw_t.blocks, raw_j.blocks):
        for f in ("c", "B", "bilinear_bases_even", "bilinear_bases_odd"):
            assert np.array_equal(getattr(bt, f), getattr(bj, f)), f
    problem_t = bucketed_problem_from_raw(raw_t, tp.n_words, "cpu")
    want = jax_arrays(problem_j)
    for key, val in want.items():
        got = _get(problem_t, key)
        assert np.array_equal(got, val), key


def _get(problem, key):
    parts = key.split(".")
    if parts[0] != "buckets":
        return getattr(problem, key).numpy()
    bk = problem.buckets[int(parts[1])]
    if parts[2] == "shape":
        return np.array([bk.shape.m, bk.shape.pts])
    if parts[2] == "block_indices":
        return np.array(bk.block_indices)
    val = getattr(bk, parts[2])
    return (val[int(parts[3])] if len(parts) > 3 else val).numpy()


def test_three_iterations_track_sdpb_tpu(jax_problem, tmp_path):
    _, problem_j = jax_problem
    state_j = initial_bucketed_state(problem_j, 1e20, 1e20)
    result_j = j_solve(problem_j, JParams(precision=PREC,
                                          word_dtype="float32",
                                          max_iterations=3), state=state_j)
    problem_t, state_t = bucketed_problem_from_arrays(
        jax_arrays(problem_j, state_j), "cpu")
    result_t = driver.solve(problem_t, TParams(precision=PREC,
                                               max_iterations=3),
                            state=state_t)
    assert result_t.reason.value == result_j.reason.value
    compare_records(result_t.iterations, result_j.iterations,
                    rel_mp=1e-10, rel_err=1e-5, abs_step=1e-6)
    for name, fn, res in (("j", jout.write_out_txt, result_j),
                          ("t", tout.write_out_txt, result_t)):
        fn(tmp_path / f"out_{name}.txt", res, 1)
    keys = [[line.split("=")[0].strip() for line in
             (tmp_path / f"out_{n}.txt").read_text().splitlines()]
            for n in ("j", "t")]
    assert keys[0] == keys[1]
    assert isinstance(result_t.state.y, torch.Tensor)
