"""The seeded synthetic bucketed problem of the repository's benchmark
(``bench.py::build_problem``), built for the port.

Full width: 48 blocks with m=2 and 32 points plus 16 blocks with m=4
and 24 points (Schur sizes 96 and 240), dual dimension N = 384, with
the stock cold start X = Y = 1e20 I.  Data comes from
``numpy.random.default_rng(seed)`` in the same order as bench.py, so
both implementations build the same problem; the words are in
``params.word_dtype``'s format (limbs, or float64 words [x, 0, ...]),
so either format runs the same seeded data.
"""

from __future__ import annotations

import numpy as np
import torch

from ..mp import limb
from .data import (BucketedProblem, SDPBucket, block_shape_of, build_u,
                   initial_bucketed_state)

N_DUAL = 384
BUCKETS = ((48, 2, 32), (16, 4, 24))      # (nb, m, pts)


def build_problem(params, device, buckets=BUCKETS, n_dual: int = N_DUAL,
                  seed: int = 0):
    """(BucketedProblem, BucketedState) on ``device``."""
    rng = np.random.default_rng(seed)
    k, dt = params.n_words, params.dtype

    def mp_w(x):
        x = np.asarray(x, dtype=np.float64)[..., None]
        if dt == torch.float32:
            return limb.from_words_np(x, k)
        return np.concatenate([x, np.zeros(x.shape[:-1] + (k - 1,))], -1)

    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
    out = []
    j0 = 0
    for nb, m, pts in buckets:
        shape = block_shape_of(m, pts)
        q_e = rng.standard_normal((nb, shape.he, pts))
        q_o = rng.standard_normal((nb, shape.ho, pts))
        out.append(SDPBucket(
            c=t(mp_w(rng.standard_normal((nb, shape.schur_size)))),
            B=t(mp_w(rng.standard_normal((nb, shape.schur_size, n_dual)))),
            q=(t(mp_w(q_e)), t(mp_w(q_o))),
            u=(t(np.stack([build_u(mp_w(q_e[i]), m) for i in range(nb)])),
               t(np.stack([build_u(mp_w(q_o[i]), m) for i in range(nb)]))),
            shape=shape, block_indices=tuple(range(j0, j0 + nb))))
        j0 += nb
    problem = BucketedProblem(objective_const=t(mp_w(0.0)),
                              b=t(mp_w(rng.standard_normal(n_dual))),
                              buckets=out)
    state = initial_bucketed_state(
        problem, float(params.initial_matrix_scale_primal),
        float(params.initial_matrix_scale_dual))
    return problem, state
