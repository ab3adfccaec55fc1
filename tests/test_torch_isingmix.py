"""The benchmark's 3d Ising sigma-epsilon configuration
(``portbench/configs/isingmix-nmax6-p400-limbs.json``: three shape
buckets, 2x2 blocks and a one-point 2x2 block whose odd parity is empty)
on the port's normal path at small sizes on the CPU: the seeded SDP
through ``bucketed_problem_from_raw`` and ``solver/driver.solve`` from
the cold start, each iteration judged by the benchmark's plain
reference (``portbench/check.py``) within the cell's limits.  The second
case has a 69-row Schur block and a 70-row Q, so the blocked routes of
``mp/linalg.py`` run, with their ``panels`` spans on."""

from __future__ import annotations

import json
import pathlib

import pytest
import torch

from portbench import check
from portbench import problem as pb
from portbench import run as harness
from sdpb_tpu_torch.utils import timers as tr

from torch_port_util import one_torch_thread  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parents[1]
CONFIG = json.loads(
    (REPO / "portbench/configs/isingmix-nmax6-p400-limbs.json").read_text())
LIMITS = json.loads(
    (REPO / "portbench/limits/p400-limbs.isingmix-nmax6.json").read_text())
SEED = 2 ** 31 + 424242
# (buckets, N, iterations): the configuration's three bucket kinds, and
# a shape whose Schur block (3 x 23 = 69 rows) and Q (70) block
CASES = {
    "three_kinds": (((2, 2, 9), (3, 1, 9), (1, 2, 1)), 12, 2),
    "blocked": (((1, 2, 23), (1, 1, 23), (1, 2, 1)), 70, 1),
}


@pytest.mark.parametrize("case", CASES)
def test_port_matches_the_plain_reference(case, one_torch_thread):  # noqa: F811
    buckets, n_dual, iterations = CASES[case]
    dev = torch.device("cpu")
    params = harness.solver_params(CONFIG, max_iterations=iterations + 1)
    data = pb.generate(SEED, buckets, n_dual)
    problem, _ = pb.to_program(data, params, dev)
    assert [(bk.shape.m, bk.shape.pts) for bk in problem.buckets] == \
        [(m, pts) for _, m, pts in buckets]
    # the one-point 2x2 block: an even basis of one row, no odd one
    assert data["buckets"][2]["q"][1].shape == (1, 0, 1)
    blocked = case == "blocked"
    tr.take()
    old = tr.layer_spans(True if blocked else None)
    try:
        win = harness.window(problem, params, 0.0, dev, False,
                             max_iterations=iterations)
    finally:
        tr.layer_spans(old)
    records, counts = tr.take()
    assert win.iterations == iterations and win.nonfinite is None
    readings = check.judge(data, CONFIG, win.states, win.records, dev)
    for name in check.NAMES:
        assert readings[name] <= LIMITS[name], (name, readings)
    panels = {site: n for (kind, site), n in counts.items()
              if kind == "panels"}
    if not blocked:
        assert panels == {}
        return
    # 3 panels of 32 rows each: the Schur block's Cholesky and Q's
    assert panels["cholesky"] == 3 + 3
    assert panels["inverse"] == 3
    assert panels["solve"] % 3 == 0 and panels["solve_t"] % 3 == 0
    names = {(layer, name) for layer, name, *_ in records
             if layer == "panels"}
    assert names == {("panels", "cholesky.panel"), ("panels", "solve.panel"),
                     ("panels", "solve_t.panel"),
                     ("panels", "inverse.panel")}
