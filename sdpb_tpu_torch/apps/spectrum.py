"""`spectrum` CLI: extract the operator spectrum from an SDPB solution.

Host-side (mpmath) equivalent of `src/spectrum/`:
- main/flags         <- `main.cxx:43` + `handle_arguments.cxx:26-63`
- read_pmp_info      <- `read_pmp_info.cxx`
- read_c_minus_By    <- `read_c_minus_By.cxx`
- read_x             <- `read_x.cxx` (x_<i>.txt text blocks)
- find_zeros         <- `compute_spectrum/find_zeros.cxx:24-60`
  (Lagrange-interpolate (c - B.y)/scalings -> polynomial matrix ->
  determinant by resampling -> minima of det -> depth test)
- root finding       <- `compute_spectrum/mpsolve.cxx` (MPSolve is
  replaced by mpmath.polyroots at the working precision)
- compute_lambda     <- `compute_spectrum/compute_lambda.hxx`
  (arXiv:1612.08471 App. A, corrected: least-squares fit of outer
  products at the zeros, leading eigenvector -> OPE vector)
- write_spectrum     <- `write_spectrum/*` -> spectrum.json

The port's copy of the JAX package's ``apps/spectrum.py``: host mpmath
only (it touches no device), over the port's ``pmp/core.py``,
``pmp/read.py`` (the pickling of mpf values across the worker pool)
and ``solver/placement.py`` (the LPT of blocks over the workers); its
spectrum.json is equal byte for byte.

    python -m sdpb_tpu_torch.apps.spectrum --precision 768 \\
        -i sdp/pmp_info.json --solution out --threshold 1e-10 \\
        -o spectrum.json
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import warnings
from pathlib import Path

import mpmath

from ..pmp.core import DampedRational, make_ctx, poly_eval


# ---------------------------------------------------------------------------
# pmp_info / inputs
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PVMInfo:
    block_index: int
    block_path: str
    dim: int
    prefactor: DampedRational
    reduced_prefactor: DampedRational
    sample_points: list
    sample_scalings: list
    reduced_sample_scalings: list


def read_pmp_info(path, ctx) -> list:
    doc = json.loads(Path(path).read_text())
    blocks = []
    for blk in doc:
        def dr(d):
            return DampedRational(ctx.mpf(d["constant"]), ctx.mpf(d["base"]),
                                  [ctx.mpf(p) for p in d["poles"]])
        blocks.append(PVMInfo(
            block_index=blk["index"],
            block_path=blk["path"],
            dim=blk["dim"],
            prefactor=dr(blk["prefactor"]),
            reduced_prefactor=dr(blk["reducedPrefactor"]),
            sample_points=[ctx.mpf(s) for s in blk["samplePoints"]],
            sample_scalings=[ctx.mpf(s) for s in blk["sampleScalings"]],
            reduced_sample_scalings=[ctx.mpf(s)
                                     for s in blk["reducedSampleScalings"]],
        ))
    blocks.sort(key=lambda b: b.block_index)
    return blocks


def read_c_minus_By(path, pmp_info, ctx) -> list:
    doc = json.loads(Path(path).read_text())
    blocks = [[ctx.mpf(s) for s in vec] for vec in doc["c_minus_By"]]
    assert len(blocks) == len(pmp_info), (len(blocks), len(pmp_info))
    for info, vec in zip(pmp_info, blocks):
        expect = info.dim * (info.dim + 1) // 2 * len(info.sample_points)
        assert len(vec) == expect, (info.block_index, len(vec), expect)
    return blocks


def read_x(solution_dir, pmp_info, ctx) -> list:
    out = []
    for info in pmp_info:
        tokens = (Path(solution_dir)
                  / f"x_{info.block_index}.txt").read_text().split()
        h, w = int(tokens[0]), int(tokens[1])
        assert w == 1
        vals = [ctx.mpf(t) for t in tokens[2:]]
        assert len(vals) == h
        out.append(vals)
    return out


# ---------------------------------------------------------------------------
# Polynomial helpers (coefficient lists, lowest degree first)
# ---------------------------------------------------------------------------

def _poly_mul(a, b, ctx):
    out = [ctx.mpf(0)] * (len(a) + len(b) - 1)
    for i, ai in enumerate(a):
        if ai == 0:
            continue
        for j, bj in enumerate(b):
            out[i + j] += ai * bj
    return out


def _poly_add_scaled(acc, p, s):
    for i, c in enumerate(p):
        acc[i] += s * c
    return acc


def lagrange_basis(points, ctx):
    """l_i(x) = prod_{j != i} (x - x_j)/(x_i - x_j)
    (`interpolate.hxx:12-37`)."""
    n = len(points)
    basis = []
    for i in range(n):
        poly = [ctx.mpf(1)]
        for j in range(n):
            if j == i:
                continue
            poly = _poly_mul(poly, [-points[j], ctx.mpf(1)], ctx)
            inv = 1 / (points[i] - points[j])
            poly = [c * inv for c in poly]
        basis.append(poly)
    return basis


def interpolate(basis, ys, ctx):
    n = max(len(p) for p in basis)
    out = [ctx.mpf(0)] * n
    for p, y in zip(basis, ys):
        _poly_add_scaled(out, p, y)
    return out


def _real_positive_roots_sorted(coeffs, ctx):
    """Real positive roots of a coefficient-list polynomial via
    mpmath.polyroots (the MPSolve stand-in, `mpsolve.cxx:130-163`)."""
    # strip leading (high-degree) zeros; polyroots wants highest first
    while coeffs and coeffs[-1] == 0:
        coeffs = coeffs[:-1]
    if len(coeffs) <= 1:
        return []
    rev = list(reversed(coeffs))
    with mpmath.workprec(ctx.prec):
        roots = mpmath.polyroots(rev, maxsteps=200,
                                 extraprec=ctx.prec // 2)
    eps = ctx.ldexp(ctx.mpf(1), -(ctx.prec // 2))
    out = []
    for r in roots:
        re = ctx.mpf(mpmath.re(r))
        im = ctx.mpf(mpmath.im(r))
        if re <= 0:
            continue
        if abs(im / re) > eps:
            continue
        out.append(re)
    return sorted(out)


def _poly_derivative(coeffs, ctx):
    return [i * c for i, c in enumerate(coeffs)][1:] or [ctx.mpf(0)]


def _find_real_positive_minima_sorted(coeffs, ctx):
    """Local minima of the polynomial on x > 0 (`mpsolve.cxx:165-210`)."""
    deriv_roots = _real_positive_roots_sorted(
        _poly_derivative(coeffs, ctx), ctx)
    if not deriv_roots:
        return []
    values = [poly_eval(coeffs, x, ctx) for x in deriv_roots]
    value_zero = poly_eval(coeffs, ctx.mpf(0), ctx)
    value_inf = poly_eval(coeffs, deriv_roots[-1] * 2, ctx)
    minima = []
    for i, x in enumerate(deriv_roots):
        prev_v = value_zero if i == 0 else values[i - 1]
        next_v = value_inf if i + 1 == len(values) else values[i + 1]
        if values[i] < prev_v and values[i] < next_v:
            minima.append(x)
    return minima


def _midpoint(a, b):
    """Harmonic mean, arithmetic if either is 0 (`find_zeros.cxx:96-104`)."""
    assert a != b
    if a == 0 or b == 0:
        return (a + b) / 2
    return 2 * a * b / (a + b)


def _det(mat, ctx):
    """Determinant by fraction-free Gaussian elimination (small dims)."""
    n = len(mat)
    if n == 1:
        return mat[0][0]
    a = [row[:] for row in mat]
    det = ctx.mpf(1)
    for col in range(n):
        piv = max(range(col, n), key=lambda r: abs(a[r][col]))
        if a[piv][col] == 0:
            return ctx.mpf(0)
        if piv != col:
            a[col], a[piv] = a[piv], a[col]
            det = -det
        det *= a[col][col]
        inv = 1 / a[col][col]
        for r in range(col + 1, n):
            f = a[r][col] * inv
            for c2 in range(col, n):
                a[r][c2] -= f * a[col][c2]
    return det


# ---------------------------------------------------------------------------
# find_zeros
# ---------------------------------------------------------------------------

def _interpolated_poly_matrix(c_minus_By, info, ctx):
    """`find_zeros.cxx:25-64`: divide by reduced scalings and
    interpolate each (r,s) entry to a degree num_points-1 polynomial."""
    dim = info.dim
    pts = len(info.sample_points)
    basis = lagrange_basis(info.sample_points, ctx)
    mat = [[None] * dim for _ in range(dim)]
    rsk = 0
    for i in range(dim):
        for j in range(i + 1):
            ys = []
            for k in range(pts):
                ys.append(c_minus_By[rsk] / info.reduced_sample_scalings[k])
                rsk += 1
            p = interpolate(basis, ys, ctx)
            mat[i][j] = p
            mat[j][i] = p
    return mat


def _determinant_poly(mat, sample_points, ctx):
    """Determinant of a polynomial matrix by resampling on a denser grid
    and re-interpolating (`find_zeros.cxx:106-168`)."""
    dim = len(mat)
    if dim == 1:
        return mat[0][0]
    pts = len(sample_points)
    det_points = []
    for i in range(pts - 1):
        x, x_next = sample_points[i], sample_points[i + 1]
        delta = (x_next - x) / dim
        for k in range(dim):
            det_points.append(x + delta * k)
    det_points.append(sample_points[-1])
    det_samples = []
    for x in det_points:
        m = [[poly_eval(mat[i][j], x, ctx) for j in range(dim)]
             for i in range(dim)]
        det_samples.append(_det(m, ctx))
    return interpolate(lagrange_basis(det_points, ctx), det_samples, ctx)


def _min_eigenvalue_sym(mat, ctx):
    with mpmath.workprec(ctx.prec):
        m = mpmath.matrix([[mpmath.mpf(x) for x in row] for row in mat])
        eigvals = mpmath.eigsy(m, eigvals_only=True)
    return min(ctx.mpf(v) for v in eigvals)


def find_zeros(c_minus_By, info, threshold, max_zero, ctx):
    """`find_zeros.cxx:171-293`."""
    assert threshold > 0
    dim = info.dim
    pts = len(info.sample_points)

    # Constant constraint: isolated zero at x=0 iff min eigenvalue small
    if pts == 1:
        mat = [[ctx.mpf(0)] * dim for _ in range(dim)]
        rsk = 0
        for i in range(dim):
            for j in range(i + 1):
                mat[i][j] = mat[j][i] = c_minus_By[rsk]
                rsk += 1
        mineig = _min_eigenvalue_sym(mat, ctx)
        assert mineig > -threshold, "All eigenvalues must be positive!"
        return [ctx.mpf(0)] if mineig < threshold else []

    mat = _interpolated_poly_matrix(c_minus_By, info, ctx)
    det = _determinant_poly(mat, info.sample_points, ctx)

    minima = []
    for x in _find_real_positive_minima_sorted(det, ctx):
        if max_zero > 0 and x > max_zero:
            warnings.warn(
                f"block_{info.block_index}: ignore large zero at x={x}")
            break
        minima.append(x)
    if not minima or minima[0] > 0:
        minima.insert(0, ctx.mpf(0))

    def eval_det(x):
        scale = info.reduced_prefactor.evaluate(x, ctx)
        m = [[poly_eval(mat[i][j], x, ctx) * scale for j in range(dim)]
             for i in range(dim)]
        return _det(m, ctx)

    zeros = []
    for i, x in enumerate(minima):
        y = eval_det(x)
        if i == 0:
            if len(minima) > 1:
                y_right = eval_det(_midpoint(x, minima[i + 1]))
                is_zero = y / y_right < threshold
            else:
                x_other = x / 2
                if x_other == 0:
                    x_other = info.sample_points[0]
                    if x_other == 0:
                        x_other = info.sample_points[1]
                assert x_other > 0
                is_zero = y / eval_det(x_other) < threshold
        elif i + 1 == len(minima):
            y_left = eval_det(_midpoint(x, minima[i - 1]))
            is_zero = y / y_left < threshold
        else:
            y_left = eval_det(_midpoint(x, minima[i - 1]))
            y_right = eval_det(_midpoint(x, minima[i + 1]))
            is_zero = y * y / y_left / y_right < threshold * threshold
        if is_zero:
            zeros.append(x)
    return zeros


# ---------------------------------------------------------------------------
# compute_lambda
# ---------------------------------------------------------------------------

def compute_lambda(info, x_vec, zero_values, ctx):
    """OPE vectors at each zero (`compute_lambda.hxx`; arXiv:1612.08471
    App. A).  Returns (zeros_with_lambda, error)."""
    dim = info.dim
    pts = len(info.sample_points)
    n_tuples = dim * (dim + 1) // 2
    assert len(x_vec) == n_tuples * pts

    # U_{j,k}: x scaled by reduced sample scalings, (pts x n_tuples)
    x_scaled = [[x_vec[rc * pts + k] * info.reduced_sample_scalings[k]
                 for rc in range(n_tuples)] for k in range(pts)]
    err_mat = [row[:] for row in x_scaled]

    if not zero_values:
        err = ctx.sqrt(sum(v * v for row in err_mat for v in row))
        return [], err

    nz = len(zero_values)
    # L(tau, x_k): Lagrange coefficients at the zeros, (pts x nz)
    interp = [[ctx.mpf(1)] * nz for _ in range(pts)]
    for pi in range(pts):
        for zi in range(nz):
            prod = ctx.mpf(1)
            for pj in range(pts):
                if pj != pi:
                    prod *= ((zero_values[zi] - info.sample_points[pj])
                             / (info.sample_points[pi]
                                - info.sample_points[pj]))
            interp[pi][zi] = prod

    # roots_fit = pinv(interp), (nz x pts), via mpmath SVD least squares
    with mpmath.workprec(ctx.prec):
        A = mpmath.matrix([[mpmath.mpf(interp[i][j]) for j in range(nz)]
                           for i in range(pts)])
        U, S, V = mpmath.svd_r(A)   # A = U * diag(S) * V
        tol = max(pts, nz) * mpmath.eps * max(S[i] for i in range(len(S)))
        # pinv(A) = V^T diag(1/S) U^T
        k_rank = len(S)
        pinv = mpmath.matrix(nz, pts)
        for a in range(nz):
            for b in range(pts):
                s = mpmath.mpf(0)
                for t in range(k_rank):
                    if S[t] > tol:
                        s += V[t, a] * U[b, t] / S[t]
                pinv[a, b] = s
        roots_fit = [[ctx.mpf(pinv[a, b]) for b in range(pts)]
                     for a in range(nz)]

    zeros_out = []
    for zi, zero in enumerate(zero_values):
        # V_{j,tau} = symmetrize(L^{-1} . U), as a dim x dim matrix
        Lam = [[ctx.mpf(0)] * dim for _ in range(dim)]
        rc = 0
        for col in range(dim):
            for row in range(col + 1):
                s = sum(roots_fit[zi][k] * x_scaled[k][rc]
                        for k in range(pts))
                w = s if row == col else s / 2
                Lam[row][col] = w
                Lam[col][row] = w
                rc += 1

        with mpmath.workprec(ctx.prec):
            M = mpmath.matrix([[mpmath.mpf(v) for v in row] for row in Lam])
            eigvals, eigvecs = mpmath.eigsy(M)
        idx = max(range(dim), key=lambda t: eigvals[t])
        max_eig = ctx.mpf(eigvals[idx])
        if max_eig < 0:
            warnings.warn(
                f"block_{info.block_index}: x={zero}: negative "
                f"max_eigenvalue={max_eig} replaced with 0.")
            max_eig = ctx.mpf(0)
        if max_eig == 0:
            zeros_out.append((zero, [ctx.mpf(0)] * dim))
            continue
        lam = [ctx.mpf(eigvecs[t, idx]) * ctx.sqrt(max_eig)
               for t in range(dim)]

        rc = 0
        for col in range(dim):
            for row in range(col + 1):
                factor = 1 if row == col else 2
                for k in range(pts):
                    err_mat[k][rc] -= (interp[k][zi] * lam[row] * lam[col]
                                       * factor)
                rc += 1

        # lambda normalized by 1/sqrt(reducedPrefactor(zero))
        scale = 1 / ctx.sqrt(info.reduced_prefactor.evaluate(zero, ctx))
        zeros_out.append((zero, [v * scale for v in lam]))

    err = ctx.sqrt(sum(v * v for row in err_mat for v in row))
    return zeros_out, err


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------

def _spectrum_worker(args):
    """Process-pool entry: re-read the inputs from disk (the files are
    the interface) and compute a subset of blocks; results cross back
    as raw-mpf wire form (mpmath clone-context mpfs don't pickle)."""
    (pmp_info_path, c_minus_By_path, solution, precision, threshold,
     max_zero, need_lambda, positions) = args
    from ..pmp.core import make_ctx
    from ..pmp.read import _to_wire

    ctx = make_ctx(precision)
    pmp_info = read_pmp_info(pmp_info_path, ctx)
    c_minus_By = read_c_minus_By(c_minus_By_path, pmp_info, ctx)
    x = read_x(solution, pmp_info, ctx) if need_lambda else None
    sub_info = [pmp_info[i] for i in positions]
    sub_cb = [c_minus_By[i] for i in positions]
    sub_x = [x[i] for i in positions] if x is not None else None
    out = compute_spectrum(sub_info, sub_cb, sub_x, ctx.mpf(threshold),
                           ctx.mpf(max_zero), need_lambda, ctx)
    return _to_wire(out)


def compute_spectrum_parallel(pmp_info_path, c_minus_By_path, solution,
                              precision, threshold, max_zero, need_lambda,
                              n_blocks, block_costs, jobs, ctx):
    """Blocks distributed over worker processes by LPT on cost
    (the reference runs `compute_spectrum.cxx:17-75` MPI-parallel over
    blocks); results returned in block order."""
    import concurrent.futures as cf
    import multiprocessing as mp_mod

    from ..pmp.read import _from_wire
    from ..solver.placement import lpt_assign

    bin_of, _ = lpt_assign(block_costs, jobs)
    groups = [[i for i in range(n_blocks) if bin_of[i] == w]
              for w in range(jobs)]
    groups = [g for g in groups if g]
    results = [None] * n_blocks
    with cf.ProcessPoolExecutor(
            max_workers=len(groups),
            mp_context=mp_mod.get_context("spawn")) as pool:
        futs = {pool.submit(_spectrum_worker,
                            (str(pmp_info_path), str(c_minus_By_path),
                             str(solution) if solution else None,
                             precision, str(threshold), str(max_zero),
                             need_lambda, g)): g
                for g in groups}
        for fut in cf.as_completed(futs):
            g = futs[fut]
            sub = _from_wire(fut.result(), ctx)
            for pos, entry in zip(g, sub):
                results[pos] = entry
    return results


def compute_spectrum(pmp_info, c_minus_By, x, threshold, max_zero,
                     need_lambda, ctx):
    """`compute_spectrum.cxx:17-75` (serial over blocks)."""
    results = []
    for li, info in enumerate(pmp_info):
        entry = {"block_path": info.block_path, "zeros": [], "error": None}
        try:
            zero_values = find_zeros(c_minus_By[li], info, threshold,
                                     max_zero, ctx)
            if need_lambda:
                zeros_out, err = compute_lambda(info, x[li], zero_values, ctx)
                entry["zeros"] = zeros_out
                entry["error"] = err
            else:
                entry["zeros"] = [(z, None) for z in zero_values]
        except Exception as e:  # noqa: BLE001 - block isolation
            warnings.warn(
                f"Failed to compute spectrum for block_{info.block_index} "
                f"block_path={info.block_path}: {e}")
        results.append(entry)
    return results


def write_spectrum(path, results, ctx):
    import math

    digits = int(math.ceil(ctx.prec * 0.30102999566398119522)) + 1

    def fmt(v):
        return ctx.nstr(v, digits, strip_zeros=True, min_fixed=1, max_fixed=0)

    doc = []
    for entry in results:
        zeros = []
        for zero, lam in entry["zeros"]:
            z = {"zero": fmt(zero)}
            if lam is not None:
                z["lambda"] = [fmt(v) for v in lam]
            zeros.append(z)
        out = {"block_path": entry["block_path"], "zeros": zeros}
        if entry["error"] is not None:
            out["error"] = fmt(entry["error"])
        doc.append(out)
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(doc, indent=2))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="spectrum",
        description="Extract operator spectrum from an SDPB solution")
    p.add_argument("-i", "--pmpInfo", required=True,
                   help="pmp_info.json written by pmp2sdp")
    p.add_argument("--solution", default=None,
                   help="Solution directory with x_<i>.txt (for --lambda)")
    p.add_argument("--cMinusBy", default=None,
                   help="c_minus_By.json written by sdpb (default: "
                        "<solution>/c_minus_By/c_minus_By.json)")
    p.add_argument("--threshold", required=True,
                   help="Zero-detection threshold on the determinant dip")
    p.add_argument("-o", "--output", required=True,
                   help="Output spectrum.json path")
    p.add_argument("--precision", type=int, required=True)
    p.add_argument("--maxZero", default="0",
                   help="Ignore zeros above this (0 = unlimited)")
    p.add_argument("--lambda", dest="need_lambda", default=True,
                   type=lambda s: s.lower() not in ("0", "false", "no"),
                   help="Compute OPE lambda vectors (needs --solution)")
    p.add_argument("-j", "--jobs", type=int, default=0,
                   help="Worker processes, blocks LPT-distributed by "
                        "size (0 = auto; the reference runs this "
                        "MPI-parallel over blocks, "
                        "compute_spectrum.cxx:17-75)")
    p.add_argument("-v", "--verbosity", type=int, default=1)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    ctx = make_ctx(args.precision)
    pmp_info = read_pmp_info(args.pmpInfo, ctx)
    c_minus_By_path = args.cMinusBy
    if c_minus_By_path is None:
        if args.solution is None:
            print("spectrum: need --cMinusBy or --solution",
                  file=sys.stderr)
            return 2
        c_minus_By_path = (Path(args.solution) / "c_minus_By"
                           / "c_minus_By.json")
    c_minus_By = read_c_minus_By(c_minus_By_path, pmp_info, ctx)
    x = None
    if args.need_lambda:
        if args.solution is None:
            print("spectrum: --lambda requires --solution", file=sys.stderr)
            return 2
        x = read_x(args.solution, pmp_info, ctx)
    jobs = args.jobs
    if not jobs:
        import os

        ncpu = os.cpu_count() or 1
        jobs = 1 if ncpu <= 2 else min(len(pmp_info), ncpu, 16)
    if jobs > 1 and len(pmp_info) > 1:
        costs = [len(info.sample_points) for info in pmp_info]
        results = compute_spectrum_parallel(
            args.pmpInfo, c_minus_By_path, args.solution, args.precision,
            args.threshold, args.maxZero, args.need_lambda,
            len(pmp_info), costs, jobs, ctx)
    else:
        results = compute_spectrum(
            pmp_info, c_minus_By, x, ctx.mpf(args.threshold),
            ctx.mpf(args.maxZero), args.need_lambda, ctx)
    write_spectrum(args.output, results, ctx)
    if args.verbosity >= 1:
        nz = sum(len(e["zeros"]) for e in results)
        print(f"spectrum: {nz} zeros in {len(results)} blocks "
              f"-> {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
