"""The comparison that decides ``correct``: every iteration the window
ran, judged against the plain reference (``reference/``) step by step.

The program's step lengths come from a float64 eigenvector's Rayleigh
quotient (float32 estimates of the matrices in the limb format), so two
sound implementations part at the step length's rounding and cannot be
compared over a trajectory.  So the reference restarts each iteration
from the program's own iterate before it (the first of each solve from
its own cold start) and judges:

- ``residues``: the primal and dual objectives (against the sum of the
  absolute values of their terms) and the duality gap;
- ``mu`` and ``beta``: the complementarity and the corrector's centering
  parameter, which the predictor's whole Newton solve sets (relative);
- ``direction``: the step the program took, fitted as alpha times the
  reference's corrector direction over (x, X) and over (y, Y): what is
  left over, against the step (1 when the iterate did not move);
- ``steps``: the fitted alphas against the reference's step lengths and
  against the program's own record of them (relative);
- ``errors``: the three error norms (primal P and p, dual) against the
  reference's, relative, but counted against the largest term of each
  residue times 2^(20 - precision) where the norm is below that (a
  residue that a full step has cancelled to rounding, which both sides
  read as noise and the program may read as 0).

The first four are counted in units of 2^-precision, the precision
that the configuration states (a sound run reads about the condition
number of what it computes; one word of 53 bits fewer reads 2^53 times
more), so that the readings of any precision fit a float64; the last
two are relative.  Each reading is the worst over the window's
iterations, printed beside its limit.
"""

from __future__ import annotations

import math

import mpmath

from .reference import mpt, sdp, words

NAMES = ("direction", "beta", "mu", "residues", "steps", "errors")
# the error norms are judged relative to themselves down to 2^20 units
# of the precision of their residue's largest term
FLOOR_BITS = 20
# a reading that is not finite, or an iterate that did not move, is
# printed as this (JSON has no infinity)
WORST = 1e300


def reference_limbs(precision: int) -> int:
    """Limbs of the reference: 200 bits and more above the program's."""
    return (int(precision) + 220) // mpt.BITS + 1


def _state_of(st, L: int, device) -> sdp.State:
    """The program's iterate (its BucketedState, any device) read
    exactly; empty parity blocks are dropped, as the reference has none."""
    rd = lambda t: words.read(t.to(device), L)
    return sdp.State(
        x=[rd(x) for x in st.x], y=rd(st.y),
        X=[[rd(p) for p in Xb if p.shape[1]] for Xb in st.X],
        Y=[[rd(p) for p in Yb if p.shape[1]] for Yb in st.Y])


def _flat(parts) -> mpt.MP:
    return mpt.cat([p.reshape(-1) for p in parts], 0)


def _fit(delta: mpt.MP, d: mpt.MP, ctx, bits: int):
    """(alpha, 2^bits max |delta - alpha d| / max |delta|) of a step
    ``delta`` against a direction ``d``."""
    top = mpt.max_abs_f64(delta)
    if top == 0.0:
        return 0.0, WORST
    num = mpt.to_mpf(mpt.dot(delta, d, 0), ctx)
    den = mpt.to_mpf(mpt.dot(d, d, 0), ctx)
    if den == 0:
        return 0.0, WORST
    alpha = num / den
    a = mpt.from_mpf(alpha, delta.L, delta.d.device)
    rest = mpt.mul_pow2(mpt.sub(delta, mpt.mul(d, a)), bits)
    return float(alpha), mpt.max_abs_f64(rest) / top


def _rel(got, want, unit=1) -> float:
    """|got - want| / |want| / unit."""
    if got == want:
        return 0.0
    if want == 0:
        return math.inf
    return float(abs(got - want) / abs(want) / unit)


def _rel_floor(got, want, big, unit) -> float:
    """|got - want| against |want|, or against ``big`` (the largest term
    of the residue) times 2^FLOOR_BITS ``unit``s where |want| is below
    that: an error norm that a full step has cancelled to the rounding of
    the program's precision, which both sides read as noise."""
    d = abs(got - want)
    if d == 0:
        return 0.0
    floor = big * unit * 2 ** FLOOR_BITS
    return float(d / max(abs(want), floor)) if floor > 0 or want \
        else math.inf


def _scaled(got, want, scale, unit) -> float:
    """|got - want| / scale / unit."""
    d = abs(got - want)
    if d == 0:
        return 0.0
    return float(d / scale / unit) if scale > 0 else math.inf


def judge(data: dict, config: dict, states: list, records: list, device,
          on_iteration=None) -> dict:
    """{name: worst reading} over the iterations of ``records`` (the
    program's iteration records, as dicts) and ``states`` (its iterate
    after each of them)."""
    precision = int(config["precision"])
    L = reference_limbs(precision)
    ctx = mpmath.mp.clone()
    ctx.prec = mpt.BITS * L + 64
    params = config["solver"]
    problem = sdp.problem_of(data, L, device)
    ulp = ctx.ldexp(ctx.mpf(1), -precision)
    cold = sdp.cold_start(problem, float(params["initial_matrix_scale"]))
    worst = dict.fromkeys(NAMES, 0.0)
    for k, (rec, st) in enumerate(zip(records, states)):
        if rec.get("first_of_solve", k == 0):
            prev = cold
        ref = sdp.iterate(problem, prev, params, ctx)
        nxt = _state_of(st, L, device)
        got = {key: ctx.mpf(rec[key]) for key in (
            "primal_objective", "dual_objective", "duality_gap", "mu",
            "beta_corrector")}
        read = {
            "residues": max(
                _scaled(got["primal_objective"], ref.primal_objective,
                        ref.objective_scale[0], ulp),
                _scaled(got["dual_objective"], ref.dual_objective,
                        ref.objective_scale[1], ulp),
                _scaled(got["duality_gap"], ref.duality_gap, 1, ulp)),
            "mu": _rel(got["mu"], ref.mu, ulp),
            "beta": _rel(got["beta_corrector"], ref.beta_corrector, ulp),
            "errors": max(
                _rel_floor(ctx.mpf(rec[key]), ctx.mpf(want), big, ulp)
                for key, want, big in zip(
                    ("primal_error_P", "primal_error_p", "dual_error"),
                    (ref.primal_error_P, ref.primal_error_p,
                     ref.dual_error), ref.error_scale)),
        }
        dp = _flat([mpt.sub(a, b) for a, b in zip(nxt.x, prev.x)]
                   + [mpt.sub(a, b) for Xa, Xb in zip(nxt.X, prev.X)
                      for a, b in zip(Xa, Xb)])
        ddir_p = _flat(ref.dx + [v for b in ref.dX for v in b])
        dd = _flat([mpt.sub(nxt.y, prev.y)]
                   + [mpt.sub(a, b) for Ya, Yb in zip(nxt.Y, prev.Y)
                      for a, b in zip(Ya, Yb)])
        ddir_d = _flat([ref.dy] + [v for b in ref.dY for v in b])
        ap, rp = _fit(dp, ddir_p, ctx, precision)
        ad, rd = _fit(dd, ddir_d, ctx, precision)
        read["direction"] = max(rp, rd)
        read["steps"] = max(
            abs(ap / ref.primal_step - 1.0), abs(ad / ref.dual_step - 1.0),
            abs(float(rec["primal_step"]) / ap - 1.0) if ap else 1.0,
            abs(float(rec["dual_step"]) / ad - 1.0) if ad else 1.0)
        for key, v in read.items():
            worst[key] = max(worst[key], min(v, WORST)) \
                if math.isfinite(v) else WORST
        if on_iteration is not None:
            on_iteration(k + 1, read)
        prev = nxt
    return worst


def verdict(readings: dict, limits: dict) -> bool:
    """Every reading at most its limit."""
    return all(readings[n] <= limits[n] for n in NAMES)
