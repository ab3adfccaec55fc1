"""One block sharded by rows over gloo ranks on the CPU
(sdpb_tpu_torch/parallel/intra.py), against sdpb_tpu.parallel.intra on
the first 2 virtual CPU devices, in float64 expansions at K = 3:

- the row-panel Cholesky and the distributed triangular solves (L^-1 U,
  L^-T U and the Cholesky solve of a matrix right-hand side) within
  1e-28 relative of sdpb_tpu's (its own tests hold its kernels to its
  dense ones at 1e-28..1e-24);
- the exact SYRK and GEMM over the row shards bit for bit;
- a row count that the ranks do not divide is refused.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from sdpb_tpu.parallel import intra as j_intra
from sdpb_tpu.parallel import mesh as j_mesh
from sdpb_tpu_torch.parallel import comm as comm_mod
from sdpb_tpu_torch.parallel import intra

from torch_dist_util import intra_linalg, run_ranks
from torch_port_util import one_torch_thread  # noqa: F401

K = 3


def _spd(n, rng):
    a = rng.standard_normal((n, n))
    spd = a @ a.T + n * np.eye(n)
    out = np.zeros((n, n, K))
    out[..., 0] = spd
    out[..., 1] = spd * 3e-18
    return out


def _words(rng, shape):
    out = np.zeros(shape + (K,))
    out[..., 0] = rng.standard_normal(shape)
    out[..., 1] = out[..., 0] * 1e-17
    return out


def _rel(a, b):
    a, b = np.asarray(a).sum(-1), np.asarray(b).sum(-1)
    return np.abs(a - b).max() / np.abs(b).max()


def test_intra_matches_sdpb_tpu_intra(tmp_path):
    rng = np.random.default_rng(0)
    n, m = 32, 12
    a, u = _spd(n, rng), _words(rng, (n, m))
    x, y = _words(rng, (n, m)), _words(rng, (n, 9))
    ours = run_ranks(intra_linalg, 2, tmp_path, a, u, x, y)
    for key in ours[0]:
        assert np.array_equal(ours[1][key], ours[0][key]), key
    ours = ours[0]
    jm = Mesh(np.array(jax.devices("cpu")[:2]), (j_mesh.AXIS,))
    l_j = j_intra.cholesky(jm, j_intra.shard_rows(jm, a))
    assert _rel(ours["L"], l_j) < 1e-28
    assert _rel(ours["t"], j_intra.solve_lower(jm, l_j, u)) < 1e-28
    assert _rel(ours["tt"], j_intra.solve_lower_t(jm, l_j, u)) < 1e-28
    assert _rel(ours["cs"], j_intra.cholesky_solve(jm, l_j, u)) < 1e-28
    xs, ys = j_intra.shard_rows(jm, x), j_intra.shard_rows(jm, y)
    np.testing.assert_array_equal(ours["syrk"],
                                  np.asarray(j_intra.syrk(jm, xs)))
    np.testing.assert_array_equal(ours["gemm"],
                                  np.asarray(j_intra.gemm(jm, xs, ys)))


def test_shard_rows_rejects_ragged():
    comm = comm_mod.Comm(rank=0, world=3, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="not divisible"):
        intra.shard_rows(comm, torch.zeros((10, 10, K)))
    assert intra.shard_rows(comm, torch.zeros((12, 10, K))).shape[0] == 4
