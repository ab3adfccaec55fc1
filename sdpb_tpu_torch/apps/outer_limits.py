"""`outer_limits` CLI: optimize over continuum constraints by a
cutting-plane loop around the interior-point solver.

Mirrors `src/outer_limits/`:
- Function / eval          <- `Function.hxx:7-15`, `Function/eval/*`
  (Chebyshev-series blocks with limiting values at epsilon/infinity)
- read_function_blocks     <- `read_function_blocks/*`
  (chebyshev_values -> coefficients DCT, `Json_Function_Parser.hxx:73-92`)
- setup_constraints        <- `compute_optimal/setup_constraints.cxx`
  (sample each block at its point set, row-rescale by the max element)
- compute_y_transform      <- `compute_y_transform.cxx` (SVD
  preconditioning: B = U s V^T, solve in y'' = scaled frame)
- generation loop          <- `compute_optimal.cxx:57-340`
  (solve -> find negative regions on an adaptive Mesh -> add points ->
  anneal dualityGapThreshold / dualityGapReduction)
- Mesh / get_new_points    <- `sdpb_util/Mesh.cxx`,
  `find_new_points/get_new_points.cxx` (quadratic-fit minima)
- checkpoints              <- `save_checkpoint.cxx` /
  `load_checkpoint/*` (checkpoint_<gen>.json.gz with yp, points,
  y_transform, b, threshold, c_scale)
- output                   <- `main.cxx:107-143` ({optimal, y, options})

The port's copy of the JAX package's ``apps/outer_limits.py``.  The
function blocks, the mesh and the y transform are host mpmath, as
there; the SDP of each generation is built on the device in float64
word expansions (all constraint blocks have num_points = 1, so they
bucket by dim) and solved by the port's ``solver/driver.py::solve``.

    python -m sdpb_tpu_torch.apps.outer_limits --functions functions.json \\
        --points points.json --precision 128 -o out.json

It runs on the CUDA device unless the caller passes ``device="cpu"``,
and never falls back: on the card the expansion arithmetic launches the
kernels of ``ops/expansion_kernels.py`` (every K up to 54 words, the CRT
prime pool's --precision 2862), on the CPU their plain versions.  Where
the JAX tool differs:
- it pins itself to the CPU (the TPU's float64 is not IEEE); the port
  solves on the card;
- above the prime pool's limit, computed from the first generation's
  constraints and the decision variables, the port exits 2 at startup
  naming the limit; the JAX tool has no such check, and its solver's CRT
  products raise "prime pool exhausted" when they meet such a precision.
  Later generations add constraints, and so CRT rows: a precision
  within a few bits of the limit can still raise so in a later solve,
  in both.
"""

from __future__ import annotations

import argparse
import dataclasses
import gzip
import json
import math
import sys
import time
from pathlib import Path

import mpmath
import numpy as np
import torch


# ---------------------------------------------------------------------------
# Function blocks
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Function:
    """Chebyshev-coefficient function on [0, max_delta] with limiting
    values at x=epsilon and x=infinity (`Function.hxx:7-15`)."""

    max_delta: object
    epsilon_value: object
    infinity_value: object
    chebyshev_coeffs: list

    def eval(self, epsilon, infinity, x, ctx):
        if x == epsilon:
            return self.epsilon_value
        if x == infinity:
            return self.infinity_value
        return _chebyshev_clenshaw(self.chebyshev_coeffs, ctx.mpf(0),
                                   self.max_delta, x, ctx)


def _chebyshev_clenshaw(c, a, b, x, ctx):
    """Clenshaw recurrence on [a,b] with the Oliver stabilization for x
    near the endpoints (`chebyshev_clenshaw_recurrence.hxx`)."""
    if x < a or x > b:
        raise ValueError(f"x in [a, b] is required: {x}, [{a}, {b}]")
    n = len(c)
    if n == 0:
        return ctx.mpf(0)
    if n == 1:
        return c[0] / 2
    cutoff = ctx.mpf("0.6")
    if x - a < b - x:
        u = 2 * (x - a) / (b - a)
        t = u - 1
        if t > -cutoff:
            b2 = ctx.mpf(0)
            b1 = c[n - 1]
            for j in range(n - 2, 0, -1):
                b1, b2 = 2 * t * b1 - b2 + c[j], b1
            return t * b1 - b2 + c[0] / 2
        bb = c[n - 1]
        d = bb
        b2 = ctx.mpf(0)
        for r in range(n - 2, 0, -1):
            d = 2 * u * bb - d + c[r]
            b2 = bb
            bb = d - bb
        return t * bb - b2 + c[0] / 2
    u = -2 * (b - x) / (b - a)
    t = u + 1
    if t < cutoff:
        b2 = ctx.mpf(0)
        b1 = c[n - 1]
        for j in range(n - 2, 0, -1):
            b1, b2 = 2 * t * b1 - b2 + c[j], b1
        return t * b1 - b2 + c[0] / 2
    bb = c[n - 1]
    d = bb
    b2 = ctx.mpf(0)
    for r in range(n - 2, 0, -1):
        d = 2 * u * bb + d + c[r]
        b2 = bb
        bb = d + bb
    return t * bb - b2 + c[0] / 2


def _values_to_coeffs(values, ctx):
    """DCT from values at Chebyshev zeros to series coefficients
    (`Json_Function_Parser.hxx:73-92`)."""
    n = len(values)
    coeffs = []
    for m in range(n):
        s = ctx.mpf(0)
        for k in range(n):
            s += 2 * ctx.cos(m * ctx.pi * (2 * (n - 1 - k) + 1)
                             / (2 * n)) * values[k] / n
        coeffs.append(s)
    return coeffs


def read_function_blocks(path, ctx):
    """Returns (objective, normalization, function_blocks) where
    function_blocks[b][i][j][n] is a Function."""
    doc = json.loads(Path(path).read_text())
    objective = [ctx.mpf(s) for s in doc["objective"]]
    normalization = [ctx.mpf(s) for s in doc["normalization"]]
    blocks = []
    for block in doc["functions"]:
        rows = []
        for row in block:
            cols = []
            for vec in row:
                funcs = []
                for f in vec:
                    if "chebyshev_values" in f:
                        coeffs = _values_to_coeffs(
                            [ctx.mpf(v) for v in f["chebyshev_values"]], ctx)
                    else:
                        coeffs = [ctx.mpf(v) for v in f["chebyshev_coeffs"]]
                    funcs.append(Function(
                        max_delta=ctx.mpf(f["max_delta"]),
                        epsilon_value=ctx.mpf(f["epsilon_value"]),
                        infinity_value=ctx.mpf(f["infinity_value"]),
                        chebyshev_coeffs=coeffs,
                    ))
                cols.append(funcs)
            rows.append(cols)
        blocks.append(rows)
    return objective, normalization, blocks


def read_points(path, ctx):
    from ..pmp.read import expand_nsv

    blocks = []
    for f in expand_nsv(path):
        doc = json.loads(Path(f).read_text())
        blocks.extend([[ctx.mpf(p) for p in blk] for blk in doc["points"]])
    return blocks


# ---------------------------------------------------------------------------
# Constraint assembly
# ---------------------------------------------------------------------------

def setup_constraints(max_index, epsilon, infinity, function_blocks,
                      normalization, points, ctx):
    """Per (block, point): rescaled c vector and B matrix
    (`setup_constraints.cxx`)."""
    c_out, B_out, dims = [], [], []
    n_cols = len(normalization) - 1
    for block, fb in enumerate(function_blocks):
        dim = len(fb)
        for x in sorted(points[block]):
            c = []
            B = []
            for row in range(dim):
                for col in range(row + 1):
                    pc = fb[row][col][max_index].eval(
                        epsilon, infinity, x, ctx) / normalization[max_index]
                    c.append(pc)
                    brow = []
                    for column in range(n_cols):
                        idx = column + (0 if column < max_index else 1)
                        brow.append(
                            pc * normalization[idx]
                            - fb[row][col][idx].eval(epsilon, infinity, x,
                                                     ctx))
                    B.append(brow)
            scale = max(
                [abs(v) for v in c] + [abs(v) for r in B for v in r])
            inv = 1 / scale if scale != 0 else ctx.mpf(1)
            c_out.append([v * inv for v in c])
            B_out.append([[v * inv for v in row] for row in B])
            dims.append(dim)
    return c_out, B_out, dims


def compute_y_transform(c_blocks, B_blocks, objectives, normalization,
                        max_index, use_svd, ctx):
    """SVD preconditioning (`compute_y_transform.cxx`).  Returns
    (yp_to_y [N x N'], b_star [N'], primal_c_scale)."""
    n = len(normalization) - 1
    dual_b = [objectives[i]
              - normalization[i] * (objectives[max_index]
                                    / normalization[max_index])
              for i in range(len(normalization)) if i != max_index]

    max_c = max((abs(v) for c in c_blocks for v in c), default=ctx.mpf(0))
    primal_c_scale = 1 / max_c if max_c != 0 else ctx.mpf(1)

    if not use_svd:
        yp_to_y = [[ctx.mpf(1) if i == j else ctx.mpf(0) for j in range(n)]
                   for i in range(n)]
        return yp_to_y, list(dual_b), primal_c_scale

    rows = [[primal_c_scale * v for v in row]
            for B in B_blocks for row in B]
    with mpmath.workprec(ctx.prec):
        A = mpmath.matrix(len(rows), n)
        for i, row in enumerate(rows):
            for j, v in enumerate(row):
                A[i, j] = mpmath.mpf(v)
        U, S, Vt = mpmath.svd_r(A)   # A = U * diag(S) * V^T (Vt is V^T)
        # yp_to_y(m, l) = V^T(l, m) / s(l) = V(m, l)/s(l)
        yp_to_y = [[ctx.mpf(Vt[l, m]) / ctx.mpf(S[l]) for l in range(n)]
                   for m in range(n)]
    # b_star = yp_to_y^T . b, scaled by 1/max|b_star|
    b_star = [sum(yp_to_y[m][l] * dual_b[m] for m in range(n))
              for l in range(n)]
    max_b = max(abs(v) for v in b_star)
    b_scale = 1 / max_b if max_b != 0 else ctx.mpf(1)
    return yp_to_y, [v * b_scale for v in b_star], primal_c_scale


def build_problem(c_blocks, B_blocks, dims, yp_to_y, b_star,
                  objective_const, primal_c_scale, k, ctx, device):
    """Assemble the in-memory SDP in the yp frame as a bucketed problem
    on ``device`` in k float64 words (the reference's second SDP ctor,
    `SDP/SDP.cxx:38-150`): each constraint is a dim x dim PSD block at
    one point, bilinear basis even = [1], odd empty."""
    from ..mp import decimal as mpdec
    from ..solver.data import (SDPBlock, SDPProblem, block_shape_of,
                               bucketize, build_u)

    n = len(b_star)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)

    def arr(vals, shape):
        out = np.zeros((*shape, k))
        flat = out.reshape(-1, k)
        i = 0
        for v in np.asarray(vals, dtype=object).reshape(-1):
            flat[i] = mpdec.from_mpf(v, k)
            i += 1
        return out

    blocks = []
    for c, B, dim in zip(c_blocks, B_blocks, dims):
        # transform B into the yp frame: B'' = c_scale * B . yp_to_y
        Bt = [[sum(B[r][m] * yp_to_y[m][l] for m in range(n))
               * primal_c_scale for l in range(n)] for r in range(len(B))]
        cs = [v * primal_c_scale for v in c]
        shape = block_shape_of(dim, 1)
        q_even = np.zeros((1, 1, k))
        q_even[0, 0, 0] = 1.0
        q_odd = np.zeros((0, 1, k))
        blocks.append(SDPBlock(
            c=t(arr(cs, (len(cs),))),
            B=t(arr(Bt, (len(Bt), n))),
            q=(t(q_even), t(q_odd)),
            u=(t(build_u(q_even, dim)), t(build_u(q_odd, dim))),
            shape=shape,
        ))
    problem = SDPProblem(
        objective_const=t(mpdec.from_mpf(objective_const, k)),
        b=t(arr(b_star, (n,))),
        blocks=blocks,
    )
    return bucketize(problem)


# ---------------------------------------------------------------------------
# Mesh refinement / new points
# ---------------------------------------------------------------------------

def _min_eig_sym(mat, ctx):
    dim = len(mat)
    if dim == 1:
        return mat[0][0]
    if dim == 2:
        a, b, c = mat[0][0], mat[1][1], mat[1][0]
        tr2 = (a + b) / 2
        disc = ctx.sqrt(((a - b) / 2) ** 2 + c * c)
        return tr2 - disc
    with mpmath.workprec(ctx.prec):
        m = mpmath.matrix([[mpmath.mpf(v) for v in row] for row in mat])
        ev = mpmath.eigsy(m, eigvals_only=True)
    return min(ctx.mpf(v) for v in ev)


def eval_summed(epsilon, infinity, summed, x, ctx):
    """min eigenvalue of the weight-summed function matrix
    (`eval_summed.cxx`)."""
    dim = len(summed)
    mat = [[None] * dim for _ in range(dim)]
    for r in range(dim):
        for c in range(r + 1):
            v = summed[r][c].eval(epsilon, infinity, x, ctx)
            mat[r][c] = mat[c][r] = v
    return _min_eig_sym(mat, ctx)


@dataclasses.dataclass
class _Mesh:
    x: list
    f: list
    lower: object = None
    upper: object = None


def _build_mesh(x0, x2, x4, f0, f2, f4, fn, mesh_threshold, block_eps, ctx):
    x = [x0, (x0 + x2) / 2, x2, (x2 + x4) / 2, x4]
    f = [f0, fn(x[1]), f2, fn(x[3]), f4]
    mesh = _Mesh(x=x, f=f)
    if abs(x[0] - x[1]) < ctx.sqrt(ctx.ldexp(ctx.mpf(1), -ctx.prec)):
        return mesh

    def need_refine(fm, fbar, fp):
        f_mid = (fm + fp) / 2
        diff = abs(f_mid - fbar)
        return (diff > mesh_threshold * (abs(f_mid) + abs(fbar))
                and diff > block_eps)

    if need_refine(f[0], f[1], f[2]):
        mesh.lower = _build_mesh(x[0], x[1], x[2], f[0], f[1], f[2], fn,
                                 mesh_threshold, block_eps, ctx)
    if need_refine(f[2], f[3], f[4]):
        mesh.upper = _build_mesh(x[2], x[3], x[4], f[2], f[3], f[4], fn,
                                 mesh_threshold, block_eps, ctx)
    return mesh


def _maybe_add_point(xm, xb, xp, fm, fb, fp, block_eps, out):
    """Quadratic-fit local minimum test (`get_new_points.cxx:5-24`)."""
    dx = xp - xm
    a = fb
    b = (fp - fm) / dx
    c = (fp - 2 * fb + fm) / (dx * dx / 4)
    if c > 0:
        x_min = -b / c + xb
        f_min = a - b * b / (2 * c)
        f_bar = (fp + fm) / 2
        if (xm <= x_min <= xp and f_min < abs(fb - f_bar)
                and abs(f_min) > block_eps):
            out.append(x_min)


def _get_new_points(mesh, block_eps, out):
    if mesh.lower is not None:
        _get_new_points(mesh.lower, block_eps, out)
    else:
        _maybe_add_point(mesh.x[0], mesh.x[1], mesh.x[2],
                         mesh.f[0], mesh.f[1], mesh.f[2], block_eps, out)
    if mesh.upper is not None:
        _get_new_points(mesh.upper, block_eps, out)
    else:
        _maybe_add_point(mesh.x[2], mesh.x[3], mesh.x[4],
                         mesh.f[2], mesh.f[3], mesh.f[4], block_eps, out)


def find_new_points(mesh_threshold, epsilon, infinity, function_blocks,
                    weights, points, ctx):
    """Scan each block functional for missed negative regions
    (`find_new_points.cxx`)."""
    new_points = []
    for block, fb in enumerate(function_blocks):
        max_delta = infinity
        block_scale = ctx.mpf(0)
        max_degree = 0
        for row in fb:
            for col in row:
                for fi, f in enumerate(col):
                    max_delta = min(max_delta, f.max_delta)
                    max_degree = max(max_degree, len(f.chebyshev_coeffs))
                    for coeff in f.chebyshev_coeffs:
                        block_scale = max(block_scale,
                                          abs(coeff * weights[fi]))
        block_eps = block_scale * ctx.ldexp(ctx.mpf(1), -ctx.prec)

        dim = len(fb)
        summed = []
        for r in range(dim):
            srow = []
            for c in range(dim):
                coeffs = [ctx.mpf(0)] * max_degree
                for fi, f in enumerate(fb[r][c]):
                    for ci, coeff in enumerate(f.chebyshev_coeffs):
                        coeffs[ci] += weights[fi] * coeff
                srow.append(Function(max_delta, ctx.mpf(0), ctx.mpf(0),
                                     coeffs))
            summed.append(srow)

        def fn(x, summed=summed):
            return eval_summed(epsilon, infinity, summed, x, ctx)

        lo = min(points[block])
        mesh = _build_mesh(lo, (lo + max_delta) / 2, max_delta,
                           fn(lo), fn((lo + max_delta) / 2), fn(max_delta),
                           fn, mesh_threshold, block_eps, ctx)
        found = []
        _get_new_points(mesh, block_eps, found)
        new_points.append([p for p in found if p not in points[block]])
    return new_points


def fill_weights(y, max_index, normalization):
    """Map solver y back to constraint weights (`fill_weights.hxx`)."""
    n_w = len(normalization)
    weights = [None] * n_w
    weights[max_index] = 1
    for row, v in enumerate(y):
        idx = row + (0 if row < max_index else 1)
        weights[idx] = v
        weights[max_index] = weights[max_index] - v * normalization[idx]
    weights[max_index] = weights[max_index] / normalization[max_index]
    return weights


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

def save_checkpoint(ck_dir, generation, threshold, c_scale, yp, points,
                    yp_to_y, b_star, infinity, ctx):
    """checkpoint_<gen>.json.gz (`save_checkpoint.cxx`)."""
    if not ck_dir:
        return generation
    ck_dir = Path(ck_dir)
    ck_dir.mkdir(parents=True, exist_ok=True)
    digits = int(math.ceil(ctx.prec * 0.30103)) + 1

    def fmt(v):
        return ctx.nstr(v, digits, strip_zeros=True, min_fixed=1,
                        max_fixed=0)

    doc = {
        "generation": str(generation + 1),
        "threshold": fmt(threshold),
        "c_scale": fmt(c_scale),
        "yp": [fmt(v) for v in yp],
        "points": [[("inf" if p == infinity else fmt(p))
                    for p in sorted(blk)] for blk in points],
        "y_transform": [[fmt(v) for v in row] for row in yp_to_y],
        "b": [fmt(v) for v in b_star],
    }
    old = ck_dir / f"checkpoint_{generation - 1}.json.gz"
    if old.exists():
        old.unlink()
    with gzip.open(ck_dir / f"checkpoint_{generation + 1}.json.gz",
                   "wt") as f:
        json.dump(doc, f)
    return generation + 1


def load_checkpoint(ck_dir, infinity, ctx):
    ck_dir = Path(ck_dir) if ck_dir else None
    if not ck_dir or not ck_dir.exists():
        return None
    cks = sorted(ck_dir.glob("checkpoint_*.json.gz"),
                 key=lambda p: int(p.name.split("_")[1].split(".")[0]))
    if not cks:
        return None
    with gzip.open(cks[-1], "rt") as f:
        doc = json.load(f)
    return {
        "generation": int(doc["generation"]),
        "threshold": ctx.mpf(doc["threshold"]),
        "c_scale": ctx.mpf(doc["c_scale"]),
        "yp": [ctx.mpf(v) for v in doc["yp"]],
        "points": [set(infinity if p == "inf" else ctx.mpf(p) for p in blk)
                   for blk in doc["points"]],
        "yp_to_y": [[ctx.mpf(v) for v in row] for row in doc["y_transform"]],
        "b_star": [ctx.mpf(v) for v in doc["b"]],
    }


# ---------------------------------------------------------------------------
# The generation loop
# ---------------------------------------------------------------------------

def compute_optimal(function_blocks, initial_points, objectives,
                    normalization, params, ctx, duality_gap_reduction,
                    mesh_threshold, use_svd=True, ck_dir=None,
                    verbosity=1, device="cpu"):
    """`compute_optimal.cxx:57-340`; the solves run on ``device``."""
    from ..mp import decimal as mpdec
    from ..pmp.compile import max_normalization_index
    from ..solver.driver import TerminateReason, solve
    from ..solver.data import initial_bucketed_state

    num_blocks = len(function_blocks)
    infinity = ctx.mpf(np.finfo(np.float64).max)
    epsilon = ctx.ldexp(ctx.mpf(1), -ctx.prec)
    target_gap = ctx.mpf(params.duality_gap_threshold)

    points = []
    for block in range(num_blocks):
        s = {epsilon, infinity}
        s.update(initial_points[block])
        points.append(s)

    max_index = max_normalization_index(normalization)
    objective_const = objectives[max_index] / normalization[max_index]
    n = len(normalization) - 1
    k = params.n_words

    ck = load_checkpoint(ck_dir, infinity, ctx)
    generation = 0
    threshold = ctx.mpf("1.1")
    if ck is not None:
        generation = ck["generation"]
        threshold = ck["threshold"]
        yp_to_y, b_star, primal_c_scale = (ck["yp_to_y"], ck["b_star"],
                                           ck["c_scale"])
        yp_saved = ck["yp"]
        points = ck["points"]
    else:
        c0, B0, _ = setup_constraints(max_index, epsilon, infinity,
                                      function_blocks, normalization,
                                      points, ctx)
        yp_to_y, b_star, primal_c_scale = compute_y_transform(
            c0, B0, objectives, normalization, max_index, use_svd, ctx)
        yp_saved = [ctx.mpf(0)] * n

    weights = None
    new_points = [[] for _ in range(num_blocks)]
    while threshold >= target_gap:
        for block in range(num_blocks):
            points[block].update(new_points[block])
        num_constraints = sum(len(p) for p in points)
        if verbosity >= 1:
            print(f"num_constraints: {num_constraints}")

        c_blocks, B_blocks, dims = setup_constraints(
            max_index, epsilon, infinity, function_blocks, normalization,
            points, ctx)
        problem = build_problem(c_blocks, B_blocks, dims, yp_to_y, b_star,
                                objective_const, primal_c_scale, k, ctx,
                                device)
        state = initial_bucketed_state(
            problem, float(ctx.mpf(params.initial_matrix_scale_primal)),
            float(ctx.mpf(params.initial_matrix_scale_dual)))
        yp0 = np.zeros((n, k))
        for i, v in enumerate(yp_saved):
            yp0[i] = mpdec.from_mpf(v, k)
        state = dataclasses.replace(
            state, y=torch.as_tensor(yp0, device=problem.device))

        has_new_points = False
        while not has_new_points and threshold >= target_gap:
            if verbosity >= 1:
                print(f"Threshold: {ctx.nstr(threshold, 6)}")
            run_params = dataclasses.replace(
                params,
                duality_gap_threshold=mpmath.nstr(
                    threshold, 40, strip_zeros=True, min_fixed=1,
                    max_fixed=0))
            result = solve(problem, run_params, state=state,
                           verbose=verbosity >= 2)
            state = result.state
            if result.reason in (TerminateReason.MaxComplementarityExceeded,
                                 TerminateReason.MaxIterationsExceeded,
                                 TerminateReason.MaxRuntimeExceeded,
                                 TerminateReason.PrimalStepTooSmall,
                                 TerminateReason.DualStepTooSmall,
                                 TerminateReason.SIGTERM_Received):
                raise RuntimeError(f"Cannot find solution: {result.reason}")

            y_host = state.y.detach().cpu().numpy()
            yp_saved = [mpdec.to_mpf(y_host[i], _mp_ctx(ctx))
                        for i in range(n)]
            y = [sum(yp_to_y[m][l] * yp_saved[l] for l in range(n))
                 for m in range(n)]
            weights = fill_weights(y, max_index, normalization)
            if verbosity >= 1:
                optimal = sum(o * w for o, w in zip(objectives, weights))
                print(f"optimal: {ctx.nstr(optimal, 20)}")

            new_points = find_new_points(mesh_threshold, epsilon, infinity,
                                         function_blocks, weights, points,
                                         ctx)
            has_new_points = any(len(np_) for np_ in new_points)
            if not has_new_points:
                if threshold == target_gap:
                    threshold = ctx.mpf(0)
                else:
                    threshold = max(threshold / duality_gap_reduction,
                                    target_gap)
        generation = save_checkpoint(ck_dir, generation, threshold,
                                     primal_c_scale, yp_saved, points,
                                     yp_to_y, b_star, infinity, ctx)
    return weights


def _mp_ctx(ctx):
    c = mpmath.mp.clone()
    c.prec = ctx.prec + 64
    return c


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="outer_limits",
        description="Cutting-plane optimizer over continuum constraints")
    p.add_argument("--functions", required=True)
    p.add_argument("--points", required=True)
    p.add_argument("-o", "--out", default=None)
    p.add_argument("-c", "--checkpointDir", default=None)
    p.add_argument("-p", "--precision", type=int, required=True)
    p.add_argument("--maxIterations", type=int, default=500)
    p.add_argument("--maxRuntime", type=float, default=2 ** 53)
    p.add_argument("--dualityGapThreshold", default="1e-30")
    p.add_argument("--primalErrorThreshold", default="1e-30")
    p.add_argument("--dualErrorThreshold", default="1e-30")
    p.add_argument("--initialMatrixScalePrimal", default="1e20")
    p.add_argument("--initialMatrixScaleDual", default="1e20")
    p.add_argument("--feasibleCenteringParameter", default="0.1")
    p.add_argument("--infeasibleCenteringParameter", default="0.3")
    p.add_argument("--stepLengthReduction", type=float, default=0.7)
    p.add_argument("--maxComplementarity", default="1e100")
    p.add_argument("--dualityGapReduction", default="1024")
    p.add_argument("--meshThreshold", default="0.001")
    p.add_argument("--useSVD", default="true",
                   type=lambda s: s.lower() not in ("0", "false", "no"))
    p.add_argument("-v", "--verbosity", type=int, default=1)
    return p


def max_precision(functions, initial_points, n_dual: int, ctx) -> int:
    """The largest --precision whose CRT products the prime pool holds
    for the first generation's SDP: a block of dim*(dim+1)/2 Schur rows
    per point of each function block (its initial points, epsilon and
    infinity) and ``n_dual`` decision variables."""
    from ..solver.data import block_shape_of
    from ..solver.memory import (ProblemShape, ShapeBucket, crt_rows,
                                 max_crt_precision)
    from ..solver.params import SolverParams

    infinity = ctx.mpf(np.finfo(np.float64).max)
    epsilon = ctx.ldexp(ctx.mpf(1), -ctx.prec)
    buckets = [ShapeBucket(len({epsilon, infinity, *pts}),
                           block_shape_of(len(fb), 1))
               for fb, pts in zip(functions, initial_points)]
    shape = ProblemShape(buckets=buckets, dual_dim=n_dual, k=1,
                         dtype=torch.float64)
    return max_crt_precision(
        lambda p: SolverParams(precision=p, word_dtype="float64").n_words,
        torch.float64, crt_rows(shape))


def main(argv=None, device=None) -> int:
    """CLI entry point: the CUDA device unless ``device`` says
    otherwise (e.g. "cpu"); raises without a CUDA device."""
    args = build_parser().parse_args(argv)

    from ..device import resolve_device
    from ..pmp.core import make_ctx
    from ..solver.params import SolverParams

    device = resolve_device(device)
    ctx = make_ctx(args.precision)
    t0 = time.time()

    objectives, normalization, functions = read_function_blocks(
        args.functions, ctx)
    initial_points = read_points(args.points, ctx)
    limit = max_precision(functions, initial_points,
                          len(normalization) - 1, ctx)
    if args.precision > limit:
        print(f"outer_limits: --precision {args.precision} needs a larger "
              f"CRT modulus than the prime pool (ops/exact.py) holds for "
              f"this problem; the largest precision it takes is {limit}",
              file=sys.stderr)
        return 2

    params = SolverParams(
        precision=args.precision,
        word_dtype="float64",
        max_iterations=args.maxIterations,
        max_runtime=args.maxRuntime,
        duality_gap_threshold=args.dualityGapThreshold,
        primal_error_threshold=args.primalErrorThreshold,
        dual_error_threshold=args.dualErrorThreshold,
        initial_matrix_scale_primal=args.initialMatrixScalePrimal,
        initial_matrix_scale_dual=args.initialMatrixScaleDual,
        feasible_centering_parameter=args.feasibleCenteringParameter,
        infeasible_centering_parameter=args.infeasibleCenteringParameter,
        step_length_reduction=args.stepLengthReduction,
        max_complementarity=args.maxComplementarity,
    )
    if device.type == "cuda":
        from ..ops import expansion_kernels

        # the kernels hold every K the prime pool does: a safeguard
        expansion_kernels.check_words("outer_limits", params.n_words)

    weights = compute_optimal(
        functions, initial_points, objectives, normalization, params, ctx,
        duality_gap_reduction=ctx.mpf(args.dualityGapReduction),
        mesh_threshold=ctx.mpf(args.meshThreshold),
        use_svd=args.useSVD, ck_dir=args.checkpointDir,
        verbosity=args.verbosity, device=device)

    optimal = sum(o * w for o, w in zip(objectives, weights))
    digits = int(math.ceil(ctx.prec * 0.30103)) + 1

    def fmt(v):
        return ctx.nstr(v, digits, strip_zeros=True, min_fixed=1,
                        max_fixed=0)

    out_path = Path(args.out) if args.out else \
        Path(str(args.functions).replace(".json", "") + "_out.json")
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps({
        "optimal": fmt(optimal),
        "y": [fmt(w) for w in weights],
        "options": {
            "precision": args.precision,
            "dualityGapThreshold": args.dualityGapThreshold,
            "maxIterations": args.maxIterations,
        },
    }, indent=2))
    if args.verbosity >= 1:
        print(f"optimal: {fmt(optimal)}")
        print(f"outer_limits finished in {time.time() - t0:.1f}s "
              f"-> {out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
