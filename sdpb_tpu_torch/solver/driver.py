"""Host-side solver loop: termination logic and iteration records.

Mirrors `SDP_Solver::run` (`src/sdp_solve/SDP_Solver/run/run.cxx:184-482`)
and `compute_feasible_and_termination.cxx` for the single-device
bucketed problem.  Each iteration runs the residue phase, reads the
error scalars back to the host, decides termination with mpmath at full
precision, then runs the step phase.
"""

from __future__ import annotations

import dataclasses
import enum
import time

import mpmath
import numpy as np
import torch

from ..mp import decimal as mpdec
from ..parallel.multihost import fetch
from ..utils import timers as tracing
from . import bucket_iteration
from .data import BucketedProblem, BucketedState, initial_bucketed_state
from .params import SolverParams


class NonFiniteIterateError(RuntimeError):
    """The iterate went NaN/Inf: a Cholesky of a matrix that was not
    positive definite (precision exhausted) or an overflow."""


class TerminateReason(enum.Enum):
    PrimalDualOptimal = "found primal-dual optimal solution"
    PrimalFeasible = "found primal feasible solution"
    DualFeasible = "found dual feasible solution"
    PrimalFeasibleJumpDetected = "primal feasible jump detected"
    DualFeasibleJumpDetected = "dual feasible jump detected"
    MaxIterationsExceeded = "maxIterations exceeded"
    MaxRuntimeExceeded = "maxRuntime exceeded"
    MaxComplementarityExceeded = "maxComplementarity exceeded"
    PrimalStepTooSmall = "primal step too small"
    DualStepTooSmall = "dual step too small"
    SIGTERM_Received = "SIGTERM received"


@dataclasses.dataclass
class IterationRecord:
    iteration: int
    mu: str
    primal_objective: str
    dual_objective: str
    duality_gap: str
    primal_error_P: str
    primal_error_p: str
    dual_error: str
    R_error: str
    primal_step: float
    dual_step: float
    beta_corrector: str
    iter_time: float
    q_cond: float = 0.0
    max_block_cond: float = 0.0
    max_block_cond_name: str = ""


@dataclasses.dataclass
class SolveResult:
    reason: TerminateReason
    state: BucketedState
    iterations: list
    primal_objective: str
    dual_objective: str
    duality_gap: str
    primal_error: str
    dual_error: str


# Each read of a device value on the host waits for the device: the
# layer spans count them as ``syncs`` by site.

def _np(x):
    tracing.count("syncs", "driver._np")
    return fetch(x)


def _mpf_of(words, prec) -> mpmath.mpf:
    tracing.count("syncs", "driver._mpf_of")
    ctx = mpmath.mp.clone()
    ctx.prec = prec + 64
    return mpdec.to_mpf(fetch(words), ctx)


def _dec(words) -> str:
    tracing.count("syncs", "driver.dec")
    return mpdec.to_decimal(fetch(words))


def _sync(device):
    tracing.count("syncs", "driver._sync")
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _elapsed(comm, start_time: float) -> float:
    """Seconds since the start; the largest over the ranks."""
    dt = time.time() - start_time
    return comm.max_float(dt) if comm is not None else dt


def check_format(problem: BucketedProblem, params: SolverParams) -> None:
    """The problem's MP arrays must be in the parameters' word format at
    its word count; float64 expansions on the card must fit the
    expansion kernels (K <= ops/expansion_kernels.py MAX_WORDS = 54
    words, the CRT prime pool's --precision 2862; up to K = 20 their
    operations run a value a thread where the batch fills the card,
    above it a value a warp)."""
    if (problem.dtype, problem.k) != (params.dtype, params.n_words):
        raise ValueError(
            f"the problem holds {problem.k} slots of {problem.dtype}; "
            f"--precision {params.precision} in the {params.word_dtype} "
            f"format needs {params.n_words} slots of {params.dtype}")
    if problem.dtype == torch.float64 and problem.device.type == "cuda":
        from ..ops import expansion_kernels

        expansion_kernels.check_words("solve", problem.k)


def solve(problem: BucketedProblem, params: SolverParams,
          state: BucketedState | None = None, verbose: bool = False,
          iteration_hook=None, timers=None) -> SolveResult:
    """Run the interior-point loop to termination.  ``timers``
    (utils.timers.Timers) records run.iter_<n>.{residues,step}; as each
    iteration starts, and after the hook, the layer spans follow
    torch.profiler where their setting says so (``at_iteration``).

    ``problem`` is a BucketedProblem on one device, or a multi-device
    one (``parallel.mesh.MeshProblem``, blocks sharded over the ranks;
    ``parallel.intra_solver.IntraProblem``, every block's rows sharded
    over them).  Then every rank runs this loop: each decision comes
    from replicated or all-reduced values, so all ranks take the same
    branch; ``y`` is checked to be the same on every rank once an
    iteration; only rank 0 prints."""
    check_format(problem, params)
    from ..parallel import intra_solver

    if isinstance(problem, intra_solver.IntraProblem):
        it_mod, init = intra_solver, intra_solver.initial_state
    else:
        it_mod, init = bucket_iteration, initial_bucketed_state
    comm = problem.comm
    verbose = verbose and (comm is None or comm.is_root)
    if state is None:
        state = init(problem, float(params.initial_matrix_scale_primal),
                     float(params.initial_matrix_scale_dual))
    thr = params.thresholds_mpf()
    prec = params.precision
    start_time = time.time()
    records = []
    reason = TerminateReason.MaxIterationsExceeded
    primal_step = dual_step = 0.0
    if timers is None:
        from ..utils.timers import Timers

        timers = Timers()
    dev = problem.device

    it = 0
    while True:
        it += 1
        tracing.at_iteration()
        t0 = time.time()
        with timers.scoped(f"run.iter_{it}.residues"):
            res = it_mod.compute_residues(problem, state)
            _sync(dev)

        p_err_P = _mpf_of(res.primal_error_P, prec)
        p_err_p = _mpf_of(res.primal_error_p, prec)
        primal_error = max(p_err_P, p_err_p)
        dual_error = _mpf_of(res.dual_error, prec)
        duality_gap = _mpf_of(res.duality_gap, prec)
        if any(mpmath.isnan(v) or mpmath.isinf(v)
               for v in (primal_error, dual_error, duality_gap)):
            raise NonFiniteIterateError(
                f"non-finite residues at iteration {it}: a Cholesky "
                "input was not positive definite or a value overflowed "
                "- try increasing --precision")

        is_primal_feasible = primal_error < thr["primal_error"]
        is_dual_feasible = dual_error < thr["dual_error"]
        feasible = is_primal_feasible and is_dual_feasible
        is_optimal = duality_gap < thr["duality_gap"]

        terminate = True
        if feasible and is_optimal:
            reason = TerminateReason.PrimalDualOptimal
        elif is_dual_feasible and params.find_dual_feasible:
            reason = TerminateReason.DualFeasible
        elif is_primal_feasible and params.find_primal_feasible:
            reason = TerminateReason.PrimalFeasible
        elif dual_step == 1.0 and params.detect_dual_feasible_jump:
            reason = TerminateReason.DualFeasibleJumpDetected
        elif primal_step == 1.0 and params.detect_primal_feasible_jump:
            reason = TerminateReason.PrimalFeasibleJumpDetected
        elif it > params.max_iterations:
            reason = TerminateReason.MaxIterationsExceeded
        elif _elapsed(comm, start_time) >= params.max_runtime:
            reason = TerminateReason.MaxRuntimeExceeded
        elif it > 1 and primal_step < float(thr["min_primal_step"]):
            reason = TerminateReason.PrimalStepTooSmall
        elif it > 1 and dual_step < float(thr["min_dual_step"]):
            reason = TerminateReason.DualStepTooSmall
        else:
            terminate = False
        if terminate:
            break

        with timers.scoped(f"run.iter_{it}.step"):
            state, info = it_mod.compute_step(problem, state, res, params,
                                              feasible)
            _sync(dev)
        if comm is not None:
            comm.check_replicated(state.y, f"y at iteration {it}")

        if bool(_np(info.terminate_max_complementarity)):
            reason = TerminateReason.MaxComplementarityExceeded
            break
        primal_step = float(_np(info.primal_step))
        dual_step = float(_np(info.dual_step))
        if not (np.isfinite(primal_step) and np.isfinite(dual_step)):
            raise NonFiniteIterateError(
                f"non-finite step length at iteration {it}: the Schur "
                "or Q Cholesky failed (not positive definite) - try "
                "increasing --precision")

        rec = IterationRecord(
            iteration=it, mu=_dec(info.mu),
            primal_objective=_dec(res.primal_objective),
            dual_objective=_dec(res.dual_objective),
            duality_gap=_dec(res.duality_gap),
            primal_error_P=_dec(res.primal_error_P),
            primal_error_p=_dec(res.primal_error_p),
            dual_error=_dec(res.dual_error), R_error=_dec(info.R_error),
            primal_step=primal_step, dual_step=dual_step,
            beta_corrector=_dec(info.beta_corrector),
            iter_time=time.time() - t0, q_cond=info.q_cond,
            max_block_cond=info.max_block_cond,
            max_block_cond_name=info.max_block_cond_name)
        records.append(rec)
        if iteration_hook is not None:
            try:
                iteration_hook(rec, state)
            finally:
                # layer spans that follow a profiler the hook stopped
                tracing.at_iteration()
        if verbose:
            print(f"it {it:3d} mu={float(mpmath.mpf(rec.mu)):.3e} "
                  f"gap={float(mpmath.mpf(rec.duality_gap)):.3e} "
                  f"steps=({primal_step:.6f},{dual_step:.6f}) "
                  f"t={rec.iter_time:.3f}s", flush=True)

    return SolveResult(
        reason=reason, state=state, iterations=records,
        primal_objective=_dec(res.primal_objective),
        dual_objective=_dec(res.dual_objective),
        duality_gap=_dec(res.duality_gap),
        primal_error=mpmath.nstr(primal_error, 40),
        dual_error=mpmath.nstr(dual_error, 40))
