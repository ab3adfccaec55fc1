"""The port's tracer (``sdpb_tpu_torch/utils/timers.py``): layer spans
and counters on the CPU, at the size of the benchmark's tiny SDP, and
the driver's timers as the benchmark reads them."""

from __future__ import annotations

import json
import pathlib
import re
import time

import numpy as np
import pytest
import torch

from portbench import problem as pb
from portbench import run as harness
from sdpb_tpu_torch.apps import sdpb as app
from sdpb_tpu_torch.mp import limb
from sdpb_tpu_torch.mp import linalg as la
from sdpb_tpu_torch.ops import limb_kernels as lk
from sdpb_tpu_torch.ops import mpmm
from sdpb_tpu_torch.solver import driver
from sdpb_tpu_torch.solver import iteration as it
from sdpb_tpu_torch.utils import timers as tr

from torch_port_util import one_torch_thread  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parents[1]
SDP_1D = REPO / "sdpb_tpu_torch" / "data" / "quickstart_1d_sdp"
# portbench/tests/pbutil.py's tiny SDP of two shape buckets
TINY = {"blocks": [[2, 2, 8], [1, 3, 6]], "n_dual": 16}
SEED = 2 ** 31 + 12345

LINALG = ("cholesky", "solve_lower", "solve_lower_t", "cholesky_solve",
          "lower_inverse", "lower_inverse_congruence", "matmul.crt",
          "matmul.plain", "matvec", "trace", "frobenius", "add_diag",
          "symmetrize", "cholesky_condition_estimate")
GLUE = ("digits_dev", "gemm_mp_batched", "restore_q_mp", "planes_to_mp_dev",
        "reduce_residues_mod", "exponents", "scale_pow2", "residues_split",
        "syrk_residues_split", "syrk_diag_residues_split",
        "gemm_residues_split", "crt_restore_planes", "add", "sub", "mul",
        "div", "recip", "sum_", "dot")
PHASES = ("residues", "schur", "xy_mu", "predictor", "beta_pairs",
          "corrector", "apply_step", "conditions")


def _solve(spans):
    """One iteration of the tiny SDP from the cold start with layer
    spans switched to ``spans``: (result, timers, records, counts,
    problem, perf_counter before and after)."""
    config = json.loads(
        (REPO / "portbench/configs/nmax6-p400-limbs.json").read_text())
    params = harness.solver_params(config, max_iterations=1)
    data = pb.generate(SEED, [tuple(b) for b in TINY["blocks"]],
                       TINY["n_dual"])
    problem, state = pb.to_program(data, params, torch.device("cpu"))
    tr.take()
    old = tr.layer_spans(spans)
    timers = tr.Timers()
    t0 = time.perf_counter()
    try:
        result = driver.solve(problem, params, state=state, timers=timers)
    finally:
        tr.layer_spans(old)
    t1 = time.perf_counter()
    records, counts = tr.take()
    return result, timers, records, counts, problem, (t0, t1)


@pytest.fixture(scope="module")
def traced():
    torch.set_num_threads(1)
    return _solve(True)


@pytest.fixture(scope="module")
def plain():
    torch.set_num_threads(1)
    return _solve(None)


def test_off_records_and_counts_nothing(plain):
    _, _, records, counts, _, _ = plain
    assert records == [] and counts == {}


def test_spans_leave_the_iterates_bit_for_bit(traced, plain):
    a, b = traced[0].state, plain[0].state
    for ta, tb in [(a.y, b.y), *zip(a.x, b.x),
                   *(p for xa, xb in zip(a.X, b.X) for p in zip(xa, xb)),
                   *(p for ya, yb in zip(a.Y, b.Y) for p in zip(ya, yb))]:
        assert torch.equal(ta.view(torch.int32), tb.view(torch.int32))
    assert [r.mu for r in traced[0].iterations] == \
        [r.mu for r in plain[0].iterations]


def test_every_span_closed_and_inside_its_parent(traced):
    records = traced[2]
    assert records
    for layer, name, start, stop, parent in records:
        assert 0 < start <= stop, (layer, name)
        if parent >= 0:
            p = records[parent]
            assert p[2] <= start and stop <= p[3], (p, layer, name)


@pytest.mark.parametrize("layer, names", [
    ("phases", PHASES), ("linalg", LINALG), ("glue", GLUE),
    ("limb_kernels", ("cholesky_unblocked_batched",
                      "solve_unblocked_batched"))])
def test_entry_points_appear_under_their_layer(traced, layer, names):
    seen = {}
    for lay, name, *_ in traced[2]:
        seen.setdefault(name, set()).add(lay)
    for name in names:
        assert seen.get(name) == {layer}, (name, seen.get(name))


def _blocked_routes(fmt: str, n: int, batch: int, m: int):
    """The factor, L^-1 B, L^-T B and L^-1 of seeded SPD matrices
    (batch, n, n) and right-hand sides (batch, n, m) in the format."""
    rng = np.random.default_rng(n)
    g = rng.standard_normal((batch, n, n))
    a = torch.from_numpy(g @ g.transpose(0, 2, 1) + n * np.eye(n))
    b = torch.from_numpy(rng.standard_normal((batch, n, m)))
    if fmt == "limbs":
        a, b = limb.from_float(a, 6), limb.from_float(b, 6)
    else:                           # K = 4 float64 words
        a, b = (torch.nn.functional.pad(t[..., None], (0, 3))
                for t in (a, b))
    l = la.cholesky(a)
    return [l, la.solve_lower(l, b), la.solve_lower_t(l, b),
            la.lower_inverse(l)]


@pytest.mark.parametrize("fmt", ["limbs", "expansions"])
@pytest.mark.parametrize("n, batch, m, panels", [
    (70, 1, 2, 3),          # above 2 x 32 rows: 96 padded, 3 panels
    (31, 2, 20, 0),         # the nmax6 SDP's Schur blocks and L^-1 B
    (20, 1, 1, 0),          # its Q
])
def test_panel_spans_only_where_the_routes_block(fmt, n, batch, m, panels,
                                                 one_torch_thread):  # noqa: F811
    tr.take()
    plain = _blocked_routes(fmt, n, batch, m)
    assert tr.take() == ([], {})
    old = tr.layer_spans(True)
    try:
        spanned = _blocked_routes(fmt, n, batch, m)
    finally:
        tr.layer_spans(old)
    records, counts = tr.take()
    bits = torch.int32 if fmt == "limbs" else torch.int64
    for got, want in zip(spanned, plain):
        assert torch.equal(got.view(bits), want.view(bits))
    routines = ("cholesky", "solve", "solve_t", "inverse")
    assert {site: v for (kind, site), v in counts.items()
            if kind == "panels"} == (
        dict.fromkeys(routines, panels) if panels else {})
    steps = [(name, records[parent][1]) for layer, name, _, _, parent
             in records if layer == "panels"]
    assert steps == [(f"{r}.panel", outer) for r, outer in zip(
        routines, ("cholesky", "solve_lower", "solve_lower_t",
                   "lower_inverse")) for _ in range(panels)]


def test_the_tiny_solve_opens_no_panel(traced):
    assert not any(layer == "panels" for layer, *_ in traced[2])
    assert not any(kind == "panels" for kind, _ in traced[3])


def test_apply_step_and_conditions_are_separate_phases(traced):
    top = [(name, parent) for layer, name, _, _, parent in traced[2]
           if layer == "phases"]
    # two residues (iterations 1 and 2) and one step
    assert [n for n, _ in top] == ["residues", "schur", "xy_mu",
                                   "predictor", "beta_pairs", "corrector",
                                   "apply_step", "conditions", "residues"]
    assert all(parent == -1 for _, parent in top)


def test_syncs_count_the_sites_hit(traced):
    _, _, _, counts, problem, _ = traced
    cpu_reads = sum(1 + 2 * len(it.parities(bk.shape))
                    for bk in problem.buckets)
    assert counts == {
        ("syncs", "driver._sync"): 3,          # two residues, one step
        ("syncs", "driver._mpf_of"): 8,        # four errors a residues
        ("syncs", "driver._np"): 3,            # the step's flag, lengths
        ("syncs", "driver.dec"): 12,           # the record's 9, result's 3
        ("syncs", "conditions.float"): 1,
        ("syncs", "conditions.cpu"): cpu_reads}


def test_launchers_and_builds_are_spans():
    k = 6
    a = torch.as_tensor(limb.from_f64_np(1.5, k))[None].expand(3, k)
    b = torch.as_tensor(limb.from_f64_np(0.25, k))[None].expand(3, k)
    x = torch.as_tensor(limb.from_f64_np(0.5, k)).expand(4, 2, k)
    plan = mpmm.plan_for(limb.precision_bits(k), 4)
    tr.take()
    old = tr.layer_spans(True)
    try:
        lk.limb_add(a, b)
        lk.limb_mul(a, b)
        lk.limb_div(a, b)
        mpmm.syrk_mp_batched(x, plan)
        lk.build(classes=())            # nothing to compile
    finally:
        tr.layer_spans(old)
    records, counts = tr.take()
    names = [(layer, name) for layer, name, _, _, parent in records
             if parent < 0]
    assert names == [("limb_kernels", "limb_add"),
                     ("limb_kernels", "limb_mul"),
                     ("limb_kernels", "limb_div"),
                     ("glue", "syrk_mp_batched"),
                     ("build", "limb_kernels.build")]
    assert counts == {}                 # no library built or loaded


def test_builds_none_in_an_iteration(traced):
    assert not any(kind in ("builds", "loads") for kind, _ in traced[3])


def test_layer_spans_follow_the_profiler():
    from torch.profiler import ProfilerActivity, profile

    x = torch.as_tensor(limb.from_f64_np(1.5, 6)).expand(2, 6)
    tr.take()
    assert tr.layer_spans(None) is None
    tr.at_iteration()
    mpmm.exponents(x)
    assert tr.take() == ([], {})
    with profile(activities=[ProfilerActivity.CPU]):
        tr.at_iteration()
        mpmm.exponents(x)
    mpmm.exponents(x)                   # until the next iteration starts
    tr.at_iteration()
    mpmm.exponents(x)
    records, _ = tr.take()
    assert [(r[0], r[1]) for r in records] == [("glue", "exponents")] * 2
    tr.layer_spans(False)
    with profile(activities=[ProfilerActivity.CPU]):
        tr.at_iteration()
        mpmm.exponents(x)
    tr.layer_spans(None)
    assert tr.take() == ([], {})


def test_route_names_the_innermost_span():
    tr.take()
    tr.route("crt")                     # off: nothing
    old = tr.layer_spans(True)
    try:
        with tr.scope("phases", "outer"):
            tr.route("a")
            with tr.scope("linalg", "inner"):
                tr.route("b")
    finally:
        tr.layer_spans(old)
    records, _ = tr.take()
    assert [(r[1], r[4]) for r in records] == [("outer.a", -1),
                                               ("inner.b", 0)]


def test_timers_named_in_seconds_for_the_benchmark(traced):
    _, timers, _, _, _, (t0, t1) = traced
    names = [n for n, _, _ in timers.named]
    assert names == ["run.iter_1.residues", "run.iter_1.step",
                     "run.iter_2.residues"]
    for _, start, stop in timers.named:
        assert t0 <= start <= stop <= t1
    residues, step = harness._phase_seconds(timers, 1)
    assert residues == timers.named[0][2] - timers.named[0][1]
    assert step == timers.named[1][2] - timers.named[1][1]
    assert 0 < residues < t1 - t0 and 0 < step < t1 - t0


def test_verbosity_3_profile_sums_each_span_path(tmp_path):
    tr.take()
    ck = tmp_path / "ck"
    assert app.main(["-s", str(SDP_1D), "--precision", "212", "-o",
                     str(tmp_path / "out"), "-c", str(ck),
                     "--maxIterations", "2", "--verbosity", "3"],
                    device="cpu") == 0
    assert tr.layer_spans(None) is None     # the setting is restored
    assert tr.take() == ([], {})
    text = (tmp_path / "ck.profiling" / "profiling.0").read_text()
    rows = re.findall(r'\{"([^"]+)", (\d+)\}', text)
    names = [n for n, _ in rows]
    layers = [n for n in names if n.startswith("layers/")]
    assert len(set(names)) == len(names)
    assert {"layers/residues", "layers/schur", "layers/conditions",
            "layers/apply_step", "layers/schur/cholesky"} <= set(layers)
    assert "sdpb.solve.run.iter_2.step" in names
    # the same paths at --verbosity 2 hold no layer lines
    assert app.main(["-s", str(SDP_1D), "--precision", "212", "-o",
                     str(tmp_path / "out2"), "-c", str(tmp_path / "ck2"),
                     "--maxIterations", "1", "--verbosity", "2"],
                    device="cpu") == 0
    text2 = (tmp_path / "ck2.profiling" / "profiling.0").read_text()
    assert "layers/" not in text2
