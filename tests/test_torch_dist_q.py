"""The port's distributed Q (sdpb_tpu_torch/parallel/dist_q.py) as gloo
ranks on the CPU, in float64 expansions at K = 3 (the JAX package's CPU
format), against the dense one-device routes of both packages.

- The row-panel Cholesky and its solves (a vector right-hand side, and
  the forward and backward substitutions of a matrix one) at D = 2 and
  4 against the port's dense la.cholesky and solves (and the factor
  against sdpb_tpu's la.cholesky): 1e-28 relative on the factor, 1e-26
  on the solutions (tests/test_dist_q.py's bounds).
- A padded dual dimension (N = 27 over 4 ranks): the reduce-scattered
  residues restored by row panels and factored, against the replicated
  restore and Cholesky of the same residues, 1e-28 relative.
- A solve of test_torch_mesh.py's eight-block SDP (3 iterations) over
  2 ranks with DIST_Q_MIN_N lowered to 1 (the row-panel Q on every iteration):
  against the port's one-device solve (replicated Q) the first factor
  to 1e-28 relative, y and x to 1e-40 relative; against sdpb_tpu's
  mesh with its DIST_Q_MIN_N lowered alike (recorded, see
  test_torch_mesh.py) with test_torch_mesh.py's bounds.
- should_distribute_q follows the memory test and DIST_Q_MIN_N.
"""

import mpmath
import numpy as np
import pytest
import torch

from sdpb_tpu.mp import linalg as j_la
from sdpb_tpu_torch.mp import linalg as la
from sdpb_tpu_torch.ops import mpmm
from sdpb_tpu_torch.parallel import comm as comm_mod
from sdpb_tpu_torch.parallel import mesh
from sdpb_tpu_torch.solver import bucket_iteration as bi
from sdpb_tpu_torch.solver import memory

from test_torch_mesh import against_sdpb_tpu, blocks_run, recorded, _worst
from torch_dist_util import (dist_q_from_rows, mesh_solve, rowpanel_linalg,
                             run_ranks, run_ranks_beside)
from torch_port_util import one_torch_thread  # noqa: F401

K = 3


def _rand_spd(n, rng):
    a = rng.standard_normal((n, n))
    spd = a @ a.T + n * np.eye(n)
    out = np.zeros((n, n, K))
    out[..., 0] = spd
    # an exact two-word split, so that the words are not trivial
    out[..., 1] = spd * 2e-18 - np.round(spd * 2e-18)
    return out


def _rel(a, b):
    a, b = np.asarray(a).sum(-1), np.asarray(b).sum(-1)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("n_dev", [2, 4])
def test_rowpanel_cholesky_and_solves_match_dense(tmp_path, n_dev):
    rng = np.random.default_rng(n_dev)
    n = 64
    a = _rand_spd(n, rng)
    b = np.zeros((n, K))
    b[:, 0] = rng.standard_normal(n)
    bm = np.zeros((n, 5, K))
    bm[..., 0] = rng.standard_normal((n, 5))
    outs = run_ranks(rowpanel_linalg, n_dev, tmp_path, a, b, bm)
    l_ref = la.cholesky(torch.from_numpy(a))
    assert _rel(outs[0]["L"], l_ref) < 1e-28
    assert _rel(outs[0]["L"], np.asarray(j_la.cholesky(a))) < 1e-28
    x_ref = la.cholesky_solve(l_ref, torch.from_numpy(b))
    assert _rel(outs[0]["x"], x_ref) < 1e-26
    bmt = torch.from_numpy(bm)
    assert _rel(outs[0]["lo"], la.solve_lower(l_ref, bmt)) < 1e-26
    assert _rel(outs[0]["lo_t"], la.solve_lower_t(l_ref, bmt)) < 1e-26
    for o in outs[1:]:
        for key in o:
            assert np.array_equal(o[key], outs[0][key]), key


def test_padded_dual_dimension_restores_by_row_panels(tmp_path):
    rng = np.random.default_rng(2)
    rows, n = 40, 27
    x = np.zeros((rows, n, K))
    x[..., 0] = rng.standard_normal((rows, n)) / np.sqrt(rows)
    xt = torch.from_numpy(x)
    plan = mpmm.plan_for(mpmm.precision_of(xt.dtype, K), rows)
    e_col = mpmm.exponents(xt).amax(dim=0)
    q_res, d_res = bi._q_residues(xt[None], e_col, plan)
    l_rep = bi.restore_q_cholesky(q_res, d_res, e_col, torch.tensor(True),
                                  plan, K, xt.dtype)
    outs = run_ranks(dist_q_from_rows, 4, tmp_path, x, e_col.numpy(), rows)
    assert np.isfinite(outs[0]).all()
    assert _rel(outs[0], l_rep) < 1e-28


def test_row_panel_q_trajectory_matches_the_replicated_one(tmp_path):
    rec = recorded("mesh_blocks_d2_dist_q")
    args, blocks_one = blocks_run(tmp_path / "blocks", rec, 1)
    outs, (one, one_lq) = run_ranks_beside(blocks_one, mesh_solve, 2,
                                           tmp_path, *args, timeout=240)
    ours = outs[0]
    assert ours["distribute_q"]
    assert np.array_equal(outs[1]["y"], ours["y"])
    assert _rel(ours["L_Q"], one_lq) < 1e-28
    assert ours["reason"] == one.reason.name
    assert _worst(ours["y"], one.state.y.numpy(), True) < mpmath.mpf("1e-40")
    for i, x in enumerate(one.state.x):
        assert _worst(ours["x"][i], x.numpy(), True) < mpmath.mpf("1e-40")
    against_sdpb_tpu(ours, rec)


class _Problem:
    def __init__(self, n, world):
        self.b = torch.zeros((n, 8))
        self.comm = comm_mod.Comm(rank=0, world=world,
                                  device=torch.device("cpu"))

    dual_dim = property(lambda self: self.b.shape[0])
    k = property(lambda self: self.b.shape[-1])
    dtype = property(lambda self: self.b.dtype)


def test_should_distribute_q_thresholds(monkeypatch):
    """From the memory test, not only from DIST_Q_MIN_N."""
    monkeypatch.setattr(memory, "detect_device_memory",
                        lambda device=None: 16 * 2 ** 30)
    assert not mesh.should_distribute_q(_Problem(256, 2))
    monkeypatch.setattr(memory, "detect_device_memory",
                        lambda device=None: 2 ** 20)
    assert mesh.should_distribute_q(_Problem(256, 2))
    assert not mesh.should_distribute_q(_Problem(256, 1))
    assert mesh.should_distribute_q(_Problem(mesh.DIST_Q_MIN_N, 2))
    assert mesh.should_distribute_q(_Problem(mesh.DIST_Q_MIN_N, 1))


def test_memory_estimate_over_several_devices():
    """Blocks divide over the devices (rounding up, as the phantoms
    pad); Q is replicated below DIST_Q_MIN_N and divided by rows from
    it up."""
    from sdpb_tpu_torch.solver.data import block_shape_of

    def shape(n_dual):
        return memory.ProblemShape(
            buckets=[memory.ShapeBucket(7, block_shape_of(2, 12))],
            dual_dim=n_dual, k=47)

    small, big = shape(64), shape(mesh.DIST_Q_MIN_N)
    one = memory.estimate_solver_memory(small)
    four = memory.estimate_solver_memory(small, n_devices=4)
    key = "Cholesky L_X,L_Y"
    assert four.components[key] * 7 == one.components[key] * 2
    assert four.components["Q, L_Q, dy"] == one.components["Q, L_Q, dy"]
    q1 = memory.estimate_solver_memory(big).components["Q, L_Q, dy"]
    q4 = memory.estimate_solver_memory(big, n_devices=4) \
        .components["Q, L_Q, dy"]
    assert q4 < q1 / 3
    est = memory.estimate_solver_memory(small)
    need = est.total // 2 + max(est.components.values())
    assert memory.intra_would_fit(small, need, 2)
    assert not memory.intra_would_fit(small, need - 1, 2)
    assert not memory.intra_would_fit(small, 10 * est.total, 1)
