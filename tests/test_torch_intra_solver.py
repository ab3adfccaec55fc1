"""The intra-block solver (sdpb_tpu_torch/parallel/intra_solver.py):
every block's X-sized state sharded by rows over gloo ranks on the CPU.

- 4 iterations of the quickstart 1d SDP over 2 ranks (the block's
  parity blocks of 3 and 2 rows padded to 4 and 2) in float64
  expansions at K = 3 track the port's one-device solve: mu, the
  primal objective and the duality gap to 1e-25 relative, the step
  lengths to 1e-10 (tests/test_intra_solver.py's bounds for sdpb_tpu's
  intra path against its plain one), and the gathered y and X to
  1e-25 relative.  Against sdpb_tpu.parallel.intra_solver on the same
  input over 2 virtual CPU devices, as tests/make_torch_reference_
  trajectories.py recorded it (test_torch_mesh.py says why recorded):
  the same termination, mu, the objectives and the gap to 1e-30
  relative, the step lengths to 1e-12 relative, y, x and X to 1e-30
  relative.
- The sdpb CLI over 2 ranks with SDPB_TPU_DEVICE_MEMORY set between
  the two-rank estimate and what row sharding needs routes the problem
  to the intra path and writes the one-rank run's out.txt objectives;
  below what row sharding needs it exits 1.
"""

import mpmath
import numpy as np
import pytest

from sdpb_tpu_torch.apps import sdpb as app
from sdpb_tpu_torch.io.sdp_json import read_sdp
from sdpb_tpu_torch.solver import driver, memory
from sdpb_tpu_torch.solver.data import bucketed_problem_from_raw
from sdpb_tpu_torch.solver.params import SolverParams

from test_torch_mesh import _worst, recorded
from torch_dist_util import (SDP_1D, intra_solve, run_cli_ranks,
                             run_ranks_beside)
from torch_port_util import one_torch_thread  # noqa: F401

K = 3


def _close(a, b, rel):
    ctx = mpmath.mp.clone()
    ctx.prec = 300
    a, b = ctx.mpf(a), ctx.mpf(b)
    return abs(a - b) <= rel * max(abs(a), abs(b), ctx.mpf("1e-300"))


def _rel(a, b):
    a, b = np.asarray(a).sum(-1), np.asarray(b).sum(-1)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def test_intra_driver_matches_the_one_device_solve(tmp_path):
    params = SolverParams(precision=K * 53, word_dtype="float64",
                          max_iterations=4)
    raw = read_sdp(SDP_1D, k=params.n_read_words)
    outs, plain = run_ranks_beside(
        lambda: driver.solve(bucketed_problem_from_raw(
            raw, params.n_words, "cpu", params.dtype), params),
        intra_solve, 2, tmp_path, K * 53, 4)
    ours = outs[0]
    assert np.array_equal(outs[1]["y"], ours["y"])
    assert ours["reason"] == plain.reason.name
    assert len(ours["records"]) == len(plain.iterations) == 4
    for r1, r2 in zip(plain.iterations, ours["records"]):
        for f in ("mu", "primal_objective", "duality_gap"):
            assert _close(getattr(r1, f), r2[f], 1e-25), (r1.iteration, f)
        for f in ("primal_step", "dual_step"):
            assert abs(getattr(r1, f) - r2[f]) < 1e-10
    assert _rel(ours["y"], plain.state.y.numpy()) < 1e-25
    for p in range(2):
        assert _rel(ours["X"][0][p], plain.state.X[0][p].numpy()) < 1e-25
    # sdpb_tpu's intra path on the same input
    rec = recorded("intra_quickstart_d2")
    assert ours["reason"] == rec["reason"]
    assert len(rec["iterations"]) == 4
    for r1, r2 in zip(rec["iterations"], ours["records"]):
        for f in ("mu", "primal_objective", "dual_objective",
                  "duality_gap"):
            assert _close(r1[f], r2[f], 1e-30), (r1["iteration"], f)
        for f in ("primal_step", "dual_step"):
            assert r2[f] == pytest.approx(r1[f], rel=1e-12)
    assert _worst(ours["y"], rec["y"], True) < mpmath.mpf("1e-30")
    assert _worst(ours["x"][0][0], rec["x"][0], True) < mpmath.mpf("1e-30")
    for p in range(2):
        assert _worst(ours["X"][0][p][0], rec["X"][0][p], True) \
            < mpmath.mpf("1e-30")


def _objectives(out_dir):
    fields = {}
    for line in (out_dir / "out.txt").read_text().splitlines():
        key, _, val = line.partition("=")
        fields[key.strip()] = val.strip().rstrip(";")
    return fields


def test_cli_routes_an_over_limit_problem_to_the_intra_path(tmp_path):
    base = ["-s", str(SDP_1D), "--precision", "212", "--maxIterations", "3",
            "--noFinalCheckpoint"]
    params = SolverParams(precision=212)
    shape = memory.shape_of_raw(read_sdp(SDP_1D, k=params.n_read_words),
                                params.n_words, params.dtype)
    two = memory.estimate_solver_memory(shape, plain=False, n_devices=2)
    one = memory.estimate_solver_memory(shape)
    need = one.total // 2 + max(one.components.values())
    assert need < two.total
    limit = (need + two.total) // 2
    assert memory.intra_would_fit(shape, limit, 2)
    argv = base + ["-o", str(tmp_path / "out"), "-c", str(tmp_path / "ck")]
    codes, one_rank = run_cli_ranks(
        argv, 2, tmp_path, log_dir=tmp_path,
        env={"SDPB_TPU_DEVICE_MEMORY": str(limit)},
        beside=lambda: app.main(base + [
            "-o", str(tmp_path / "one"), "-c", str(tmp_path / "ck_one"),
            "--verbosity", "0"], device="cpu"))
    assert (codes, one_rank) == ([0, 0], 0)
    log = (tmp_path / "rank0.log").read_text()
    assert "intra-block row sharding over 2 ranks" in log, log
    ours, want = _objectives(tmp_path / "out"), _objectives(tmp_path / "one")
    assert ours["terminateReason"] == want["terminateReason"]
    for f in ("primalObjective", "dualObjective", "dualityGap"):
        assert _close(ours[f], want[f], 1e-25), f
    # below what row sharding needs: exit 1, as on one device
    codes = run_cli_ranks(argv, 2, tmp_path, log_dir=tmp_path,
                          env={"SDPB_TPU_DEVICE_MEMORY": str(need // 4)})
    assert codes == [1, 1]
    assert "exceeds the limit" in (tmp_path / "rank0.err").read_text()
