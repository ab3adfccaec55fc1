"""The port's block-sharded solve in the limb format on gloo ranks on
the CPU, against its one-device limb solve:

- a seeded synthetic problem of two buckets (5 blocks of m = 2, 3 of
  m = 1, --precision 212) placed by cost over 2 ranks: the restored Q
  of the first iteration (its Cholesky factor) is bit for bit the
  one-device Q; the records agree to 1e-30 relative (mu, objectives,
  gap, beta), the error norms to 1e-6 relative or both under 1e-40 (a
  float32 estimate of an error that is zero to the last limb comes out
  0 or the least subnormal, 1.4e-45, by the order of the sums) and the
  step lengths to 1e-12 (only the order of the cross-rank MP sums
  differs), y to 1e-45;
- the one-bucket sharded step (parallel/bucketed.py) over 2 ranks takes
  the step it takes on one device: y to 1e-30 relative, mu and the step
  lengths to 1e-12.
"""

import mpmath
import numpy as np
import pytest

from sdpb_tpu_torch.parallel import mesh
from sdpb_tpu_torch.solver import bucket_iteration as bi
from sdpb_tpu_torch.solver import driver, placement
from sdpb_tpu_torch.solver.data import bucketed_problem_from_arrays
from sdpb_tpu_torch.solver.params import SolverParams

from test_torch_mesh import _worst
from torch_dist_util import (bucketed_step, mesh_solve, run_ranks_beside,
                             synthetic_arrays)
from torch_port_util import compare_records
from torch_port_util import one_torch_thread  # noqa: F401


class _Rec:
    def __init__(self, d):
        self.__dict__.update(d)


def test_limb_mesh_q_is_bit_for_bit_the_one_device_q(tmp_path, monkeypatch):
    arrays = synthetic_arrays(212, "float32", ((5, 2, 4), (3, 1, 6)), 8, 3)
    problem, _ = bucketed_problem_from_arrays(arrays, "cpu")
    params = SolverParams(precision=212, max_iterations=3)
    first = {}
    factorize = bi.schur_factorize

    def keep_first(prob, res, max_q_bytes=None):
        out = factorize(prob, res, max_q_bytes)
        first.setdefault("L_Q", out[2].numpy().copy())
        return out

    monkeypatch.setattr(bi, "schur_factorize", keep_first)
    costs = placement.flop_model_costs(problem)
    costs[[0, 2, 7]] *= 3.0          # an uneven placement
    by_bucket = [[costs[j] for j in bk.block_indices]
                 for bk in problem.buckets]
    outs, single = run_ranks_beside(
        lambda: driver.solve(problem, params), mesh_solve, 2, tmp_path,
        arrays, 212, "float32", 3, None, by_bucket)
    ours = outs[0]
    for bk, slots, c in zip(problem.buckets, ours["slots"], by_bucket):
        assert list(slots) == list(mesh.bucket_slots(bk.nb, 2, c))
    assert any(list(s[s >= 0]) != sorted(s[s >= 0]) for s in ours["slots"])
    assert np.array_equal(ours["L_Q"], first["L_Q"])
    assert ours["reason"] == single.reason.name
    compare_records([_Rec(r) for r in ours["records"]], single.iterations,
                    rel_mp=1e-30, rel_err=1e-6, abs_step=1e-12,
                    floor_err=1e-40)
    assert _worst(ours["y"], single.state.y) < mpmath.mpf("1e-45")


def test_bucketed_step_over_two_ranks_is_the_one_device_step(tmp_path):
    arrays = synthetic_arrays(212, "float32", ((4, 2, 4),), 6, 9)
    outs, (y_one, info_one) = run_ranks_beside(
        lambda: bucketed_step(None, arrays), bucketed_step, 2, tmp_path,
        arrays)
    assert np.array_equal(outs[0][0], outs[1][0])
    assert _worst(outs[0][0], y_one, True) < mpmath.mpf("1e-30")
    for key in ("mu", "primal_step", "dual_step", "cx"):
        assert outs[0][1][key] == pytest.approx(info_one[key], rel=1e-12)
