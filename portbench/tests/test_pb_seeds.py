"""Every seed that the comparison's limits were set and proved on runs
the window's iterations from the cold start without a non-finite
residue or step: the reference's own trajectory (its float64 step
lengths) on the configuration's SDP at 80 bits, on the CPU.  The
trajectory grows mu by ~10^3 an iteration and reaches the solver's
maxComplementarity (1e100) near iteration 70, where a window's solve
ends and the next begins."""

from __future__ import annotations

import math

import mpmath
import pytest

from portbench import problem as pb
from portbench.reference import sdp

BLOCKS = ((11, 1, 31),)
N_DUAL = 20
L = 5
PARAMS = {"initial_matrix_scale": "1e20", "feasible_centering": "0.1",
          "infeasible_centering": "0.3", "step_length_reduction": "0.7",
          "primal_error": "1e-30", "dual_error": "1e-30",
          "duality_gap": "1e-30"}
# the seeds of the chip runs that set and proved the limits (PERF.md),
# and the most iterations a window of run_seconds ran there
SEEDS = (
    # the first look
    2147500001, 2147500002, 2147500003, 2147500004,
    # the two sets, the traced runs, the sound and the control readings
    2147510011, 2290010023, 2430010037, 2570010041, 2710010053, 2850010067,
    2147510101, 2500010111, 3000010129,
    2147510203, 2650010227, 3250010231,
    2147510307, 3350010311)
ITERATIONS = 70


@pytest.mark.parametrize("seed", SEEDS)
def test_seed_runs_clean(seed):
    import torch

    torch.set_num_threads(2)
    ctx = mpmath.mp.clone()
    ctx.prec = 20 * L + 64
    problem = sdp.problem_of(pb.generate(seed, BLOCKS, N_DUAL), L, "cpu")
    st = sdp.cold_start(problem, 1e20)
    for _ in range(ITERATIONS):
        it = sdp.iterate(problem, st, PARAMS, ctx)
        for v in (it.mu, it.primal_objective, it.dual_objective,
                  it.primal_error_P, it.primal_error_p, it.dual_error,
                  it.primal_step, it.dual_step):
            assert math.isfinite(float(v)), (seed, it)
        st = sdp.advance(st, it, L)
