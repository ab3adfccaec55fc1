"""The seeded SDP of a configuration, and its hand-over to the program.

``generate`` is a frozen copy of the program's ``solver/synthetic.py``
(itself ``bench.py::build_problem``): the same draws from
``numpy.random.default_rng(seed)`` in the same order, as float64 arrays,
so that the benchmark owns its inputs whatever later changes the
program makes.  ``to_program`` hands those arrays to the program as an
SDP read from files, one float64 word a value, and the program converts
them to its word format itself.
"""

from __future__ import annotations

import numpy as np


def _seed(seed: int) -> int:
    """Any whole number as a seed of numpy's generator."""
    return int(seed) % (1 << 64)


def shape_of(m: int, pts: int) -> dict:
    he = (pts - 1) // 2 + 1
    return {"m": m, "pts": pts, "he": he, "ho": pts - he,
            "schur": m * (m + 1) // 2 * pts}


def generate(seed: int, buckets, n_dual: int) -> dict:
    """{"buckets": [{m, pts, q: (even, odd), c, B}], "b",
    "objective_const"} as float64 arrays."""
    rng = np.random.default_rng(_seed(seed))
    out = []
    for nb, m, pts in buckets:
        sh = shape_of(m, pts)
        q_e = rng.standard_normal((nb, sh["he"], pts))
        q_o = rng.standard_normal((nb, sh["ho"], pts))
        c = rng.standard_normal((nb, sh["schur"]))
        B = rng.standard_normal((nb, sh["schur"], n_dual))
        out.append({"nb": nb, "m": m, "pts": pts, "q": (q_e, q_o), "c": c,
                    "B": B})
    return {"buckets": out, "b": rng.standard_normal(n_dual),
            "objective_const": 0.0}


def raw_sdp(data: dict):
    """The arrays as the program's RawSDP (``io/sdp_json.py``), one
    float64 word a value: what ``apps/sdpb.py`` reads from an SDP's files."""
    from sdpb_tpu_torch.io.sdp_json import RawBlock, RawSDP

    w = lambda a: np.asarray(a, dtype=np.float64)[..., None]
    blocks = [RawBlock(dim=bk["m"], num_points=bk["pts"],
                       bilinear_bases_even=w(bk["q"][0][i]),
                       bilinear_bases_odd=w(bk["q"][1][i]),
                       c=w(bk["c"][i]), B=w(bk["B"][i]))
              for bk in data["buckets"] for i in range(bk["nb"])]
    return RawSDP(objective_const=w(data["objective_const"]),
                  b=w(data["b"]), normalization=None, blocks=blocks)


def to_program(data: dict, params, device):
    """(BucketedProblem, BucketedState) of the program on ``device``: the
    arrays through the program's own conversion of a read SDP
    (``bucketed_problem_from_raw``, as ``apps/sdpb.py`` calls it), and
    X = Y = scale I."""
    from sdpb_tpu_torch.solver.data import bucketed_problem_from_raw

    problem = bucketed_problem_from_raw(raw_sdp(data), params.n_words,
                                        device, params.dtype)
    return problem, cold_state(problem, params)


def cold_state(problem, params):
    """The stock cold start of the program's iterate."""
    from sdpb_tpu_torch.solver.data import initial_bucketed_state

    return initial_bucketed_state(
        problem, float(params.initial_matrix_scale_primal),
        float(params.initial_matrix_scale_dual))
