"""The port's memory estimate and fail-fast check, the block costs of
``ck/block_timings``, and the sdpb CLI's startup refusals, on the CPU.

The estimate's own accuracy is a device measurement: chip_smoke.py
holds it against ``max_memory_allocated`` at N = 384 and N = 1024.
Here: what the CLI does with it, and that the shape-only path (before
anything is on the device) gives the same numbers as the problem.
"""

import pathlib

import numpy as np
import pytest

from sdpb_tpu.solver import memory as jmem
from sdpb_tpu.solver import placement as jplace
from sdpb_tpu_torch.apps import sdpb as app
from sdpb_tpu_torch.io.sdp_json import read_sdp
from sdpb_tpu_torch.ops import limb_kernels as lk
from sdpb_tpu_torch.solver import memory, placement, synthetic
from sdpb_tpu_torch.solver.data import bucketed_problem_from_raw
from sdpb_tpu_torch.solver.params import SolverParams

from torch_port_util import one_torch_thread  # noqa: F401

SDP_1D = pathlib.Path(__file__).resolve().parents[1] / "sdpb_tpu_torch" \
    / "data" / "quickstart_1d_sdp"


def test_parse_bytes_matches_sdpb_tpu():
    for text in ("0", "", "1024", "100.1K", "2G", "3m", "1.5T", "7kb",
                 "12 MB", 4096):
        assert memory.parse_bytes(text) == jmem.parse_bytes(text), text
    for bad in ("12X", "G", "1.2.3"):
        with pytest.raises(ValueError):
            memory.parse_bytes(bad)
    assert SolverParams(max_shared_memory="2M").max_shared_memory_bytes \
        == 2 << 20


def _full_width_shape(n_dual, k):
    from sdpb_tpu_torch.solver.data import block_shape_of

    return memory.ProblemShape(
        buckets=[memory.ShapeBucket(nb, block_shape_of(m, pts))
                 for nb, m, pts in synthetic.BUCKETS],
        dual_dim=n_dual, k=k)


def test_estimate_from_the_raw_sdp_equals_the_problems():
    params = SolverParams(precision=212)
    raw = read_sdp(SDP_1D, k=params.n_read_words)
    shape = memory.shape_of_raw(raw, params.n_words)
    problem = bucketed_problem_from_raw(raw, params.n_words, "cpu")
    assert memory.estimate_solver_memory(shape).components == \
        memory.estimate_solver_memory(problem).components


def test_estimate_of_the_expansion_format():
    """8 K bytes a float64-expansion value, the shape-only path equal to
    the problem's, and the plain route's temporaries counted on the CPU
    only."""
    import torch

    params = SolverParams(precision=212, word_dtype="float64")
    k = params.n_words
    raw = read_sdp(SDP_1D, k=k)
    shape = memory.shape_of_raw(raw, k, torch.float64)
    problem = bucketed_problem_from_raw(raw, k, "cpu", torch.float64)
    est = memory.estimate_solver_memory(shape)
    assert est.components == memory.estimate_solver_memory(
        problem).components
    bk = problem.buckets[0]
    values = sum(t.numel() // k for t in (bk.c, bk.B, *bk.q, *bk.u))
    assert est.components["problem data (c,B,q,u)"] == 8 * k * values
    limb = memory.estimate_solver_memory(memory.shape_of_raw(
        raw, SolverParams(precision=212).n_words))
    assert limb.components["problem data (c,B,q,u)"] == \
        4 * SolverParams(precision=212).n_words * values
    plain = memory.estimate_solver_memory(shape, plain=True)
    assert plain.total > est.total
    assert any(name.startswith("plain ") for name in plain.transients)


def test_estimate_grows_with_the_problem_and_the_q_cap_bounds_it():
    k = SolverParams(precision=400).n_words
    small = memory.estimate_solver_memory(_full_width_shape(384, k))
    large = memory.estimate_solver_memory(_full_width_shape(1024, k))
    assert 0 < small.total < large.total
    # every component, the largest product's transients included
    assert set(small.components) >= {
        "problem data (c,B,q,u)", "L^-1 B", "Q, L_Q, dy"}
    assert any(name.startswith("CRT ") for name in large.components)
    k1024 = SolverParams(precision=1024).n_words
    assert memory.estimate_solver_memory(
        _full_width_shape(384, k1024)).total > small.total
    # the Q residue stage is tiled under --maxSharedMemory
    shape = memory.ProblemShape(buckets=[memory.ShapeBucket(
        4096, _full_width_shape(384, k).buckets[0].shape)], dual_dim=384, k=k)
    q = "CRT residues of Q (bucket 0)"
    free = memory.estimate_solver_memory(shape).transients[q]
    capped = memory.estimate_solver_memory(shape, q_bytes_cap=1 << 20)
    assert capped.transients[q] < free


def test_check_memory_limit_fails_fast_with_the_components(monkeypatch):
    shape = _full_width_shape(384, SolverParams(precision=400).n_words)
    est = memory.check_memory_limit(shape, limit="1T")
    with pytest.raises(memory.MemoryLimitError) as err:
        memory.check_memory_limit(shape, limit=est.total - 1)
    for name in est.components:
        assert name in str(err.value)
    monkeypatch.setenv("SDPB_TPU_DEVICE_MEMORY", "1M")
    with pytest.raises(memory.MemoryLimitError):
        memory.check_memory_limit(shape)


def test_cli_exits_1_over_the_memory_limit_before_allocating(
        tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("SDPB_TPU_DEVICE_MEMORY", "1K")
    made = []
    monkeypatch.setattr(
        "sdpb_tpu_torch.solver.data.bucketed_problem_from_raw",
        lambda *a, **kw: made.append(1))
    rc = app.main(["-s", str(SDP_1D), "-o", str(tmp_path / "out"),
                   "--precision", "212"], device="cpu")
    assert rc == 1 and not made
    err = capsys.readouterr().err
    assert "exceeds the limit" in err and "problem data (c,B,q,u)" in err


def test_cli_refuses_a_precision_above_the_largest_kernel_class(
        tmp_path, capsys):
    top = lk.max_precision_bits()
    # refused at startup: the SDP directory is not even read
    rc = app.main(["-s", str(tmp_path / "missing"), "--precision",
                   str(top + 1)], device="cpu")
    assert rc == 2
    assert f"largest kernel class, which holds {top} bits" in \
        capsys.readouterr().err


def test_block_costs_match_sdpb_tpu(tmp_path):
    params = SolverParams(precision=212)
    problem, _ = synthetic.build_problem(
        params, "cpu", buckets=((3, 2, 6), (2, 1, 5)), n_dual=7)
    costs = placement.flop_model_costs(problem)
    assert np.array_equal(costs, jplace.flop_model_costs(problem))
    placement.write_flop_model_timings(tmp_path / "t", problem)
    assert np.array_equal(
        placement.read_block_costs(tmp_path / "t", None, 5),
        jplace.read_block_costs(tmp_path / "t", None, 5))
    per_bucket = [[0.5, 0.25, 2.0], [1e-3, 7.0]]
    placement.write_block_timings(tmp_path / "a", problem, per_bucket)
    jplace.write_block_timings(tmp_path / "b", problem, per_bucket)
    assert (tmp_path / "a" / "block_timings").read_text() == \
        (tmp_path / "b" / "block_timings").read_text()
    assert np.array_equal(placement.read_block_costs(None, None, 5,
                                                     problem=problem), costs)
    assert np.array_equal(placement.read_block_costs(None, SDP_1D, 1),
                          jplace.read_block_costs(None, SDP_1D, 1))
