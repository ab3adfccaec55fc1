"""The one-bucket sharded step: a full predictor-corrector iteration on
one bucket of same-shape blocks, each rank holding its share of them.

The PyTorch counterpart of the JAX package's
``parallel/bucketed.py::make_sharded_step``: the bucket becomes a
one-bucket MeshProblem (every block of it real) and the step runs the
solver's phases (``solver/bucket_iteration.py``) with their collectives.
The centering follows the JAX package's bucketed step: the infeasible
predictor beta, and a corrector beta of at least it.  No entry point of
the port calls it (the JAX package's caller is its ``__graft_entry__``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..mp import core as mp
from ..solver import bucket_iteration as bi
from ..solver.data import BlockShape, BucketedState, SDPBucket
from .comm import Comm
from .mesh import MeshProblem


def make_sharded_step(shape: BlockShape, gamma: float = 0.7,
                      comm: Comm | None = None):
    """The step for one bucket of ``shape`` over ``comm``'s ranks (one
    device without it).  ``step(bucket, state, b_vec, total_psd_rows,
    beta_infeasible)`` takes this rank's blocks (an SDPBucket), the
    iterate of one bucket (x, y, X and Y of a BucketedState with one
    entry each), b, the PSD rows of the whole bucket (its block count
    times one block's) and the MP infeasible centering parameter; it
    returns the next iterate and a dict of float64 scalars (mu, the
    errors, the step lengths, c.x)."""
    if not (shape.psd_size(0) > 0 and shape.psd_size(1) > 0):
        raise ValueError("the bucketed step needs both parity blocks")

    def step(bucket: SDPBucket, state: BucketedState, b_vec,
             total_psd_rows: int, beta_infeasible):
        c = comm if comm is not None else Comm.local(b_vec.device)
        k, dt, dev = b_vec.shape[-1], b_vec.dtype, b_vec.device
        nb_all = int(total_psd_rows) // sum(shape.psd_sizes)
        problem = MeshProblem(
            objective_const=mp.zeros((), k, dev, dt), b=b_vec,
            buckets=[bucket], comm=c,
            masks=[torch.ones(bucket.nb, dtype=dt, device=dev)],
            slots=[np.arange(nb_all)], n_valid=[nb_all])
        res = bi.compute_residues(problem, state)
        L_S, LinvB, L_Q = bi.schur_factorize(problem, res)
        huge = np.asarray(mp.from_f64_np(1e300, k, dt))
        minus_XY, mu, _, _ = bi.compute_xy_mu(problem, state, huge)
        dx, dX, dy, dY = bi.search_direction(
            problem, state, res, minus_XY, L_S, LinvB, L_Q,
            mp.mul(beta_infeasible, mu), bi.zeros_like_XY(state))
        beta = bi.corrector_beta(problem, state, dX, dY, mu, False,
                                 beta_infeasible, beta_infeasible)
        dx, dX, dy, dY = bi.search_direction(
            problem, state, res, minus_XY, L_S, LinvB, L_Q,
            mp.mul(beta, mu), bi.pair_products(problem, dX, dY))
        new_state, alpha_p, alpha_d = bi.apply_step(
            problem, state, res, dx, dX, dy, dY, False, gamma)
        f64 = lambda v: float(mp.approx(v).to(torch.float64))
        info = {"mu": f64(mu), "dual_error": f64(res.dual_error),
                "primal_error_P": f64(res.primal_error_P),
                "primal_error_p": f64(res.primal_error_p),
                "primal_step": float(alpha_p), "dual_step": float(alpha_d),
                "cx": f64(res.primal_objective)}
        return new_state, info

    return step
