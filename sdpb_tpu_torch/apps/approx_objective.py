"""`approx_objective` CLI of the port: perturbation-theory estimate of
the objective of nearby SDPs, in the float64-expansion format.

    python -m sdpb_tpu_torch.apps.approx_objective --sdp <sdp dir> \\
        --precision 212 --newSdp <new sdp dir or .nsv> \\
        [--solutionDir <dir>] [--linear] [--writeSolverState]

The port of the JAX package's ``apps/approx_objective.py`` (reference
`src/approx_objective/`):
- linear term (`Approx_Objective.cxx:11-53`):
  d_obj = dconst + db.y + dc.x - x.dB.y
- quadratic term (`Approx_Objective.cxx:56-150`, `compute_dx_dy.cxx`):
  solve the Schur system for (dx, dy) from the rhs (dB.y - dc,
  db - dB^T.x), then dd_obj = (db.dy + dc.dx - dx.dB.y - x.dB.dy)/2
- solver setup (`setup_solver.cxx`): the S-Cholesky, L^-1 B and the Q
  Cholesky rebuilt from the solution's X and Y, or loaded from the
  text files that --writeSolverState caches;
- output (`main.cxx:123-150`): a JSON array of {path, objective,
  d_objective, dd_objective}.

It runs on the CUDA device unless the caller passes ``device="cpu"``,
and never falls back: the expansion arithmetic launches the kernels of
``ops/expansion_kernels.py`` on the card (every K up to the CRT prime
pool's limit, 54 words: --precision 2862) and runs their plain versions
on the CPU.  A precision above what the prime pool holds for the SDP
exits 2 at startup, naming the limit, on either device.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch


def _solve_schur(problem, L_S, LinvB, L_Q, dx, dy):
    """Solve {{S, -B}, {B^T, 0}} {dx, dy} = {rhs_x, rhs_y}
    (`solve_schur_complement_equation.cxx:16-80`), the solver's
    search-direction sequence."""
    from ..mp import core as mp
    from ..mp import linalg as la

    dx = [la.solve_lower(L_S[i], d) for i, d in enumerate(dx)]
    for i in range(len(dx)):
        dy = mp.sub(dy, la.matvec(LinvB[i], dx[i], transpose=True))
    dy = la.cholesky_solve(L_Q, dy)
    dx = [la.solve_lower_t(L_S[i], mp.add(d, la.matvec(LinvB[i], dy)))
          for i, d in enumerate(dx)]
    return dx, dy


def _tensor(words, device):
    return torch.as_tensor(np.ascontiguousarray(words), device=device)


def read_solution_vectors(solution_dir, problem, k: int):
    from ..io.text_io import read_text_vector

    dev = problem.b.device
    x = [_tensor(read_text_vector(Path(solution_dir) / f"x_{j}.txt", k),
                 dev) for j in range(len(problem.blocks))]
    y = _tensor(read_text_vector(Path(solution_dir) / "y.txt", k), dev)
    return x, y


def read_solution_XY(solution_dir, problem, k: int):
    from ..io.text_io import read_text_matrix

    dev = problem.b.device
    X, Y = [], []
    for j, bl in enumerate(problem.blocks):
        Xb, Yb = [], []
        for p in range(2):
            if bl.shape.psd_size(p) == 0:
                Xb.append(torch.zeros((0, 0, k), dtype=torch.float64,
                                      device=dev))
                Yb.append(torch.zeros((0, 0, k), dtype=torch.float64,
                                      device=dev))
                continue
            Xb.append(_tensor(read_text_matrix(
                Path(solution_dir) / f"X_matrix_{2 * j + p}.txt", k), dev))
            Yb.append(_tensor(read_text_matrix(
                Path(solution_dir) / f"Y_matrix_{2 * j + p}.txt", k), dev))
        X.append(tuple(Xb))
        Y.append(tuple(Yb))
    return X, Y


def d_sdp(raw_old, raw_new, device):
    """d_sdp = new - old on (const, b, c, B) (`Axpy.cxx`)."""
    from ..mp import core as mp

    if raw_new.num_blocks != raw_old.num_blocks:
        raise ValueError(f"the new SDP has {raw_new.num_blocks} blocks, "
                         f"the solved one {raw_old.num_blocks}")
    t = lambda a: _tensor(a, device)
    d_const = mp.sub(t(raw_new.objective_const), t(raw_old.objective_const))
    d_b = mp.sub(t(raw_new.b), t(raw_old.b))
    d_c, d_B = [], []
    for bo, bn in zip(raw_old.blocks, raw_new.blocks):
        if (bo.dim, bo.num_points) != (bn.dim, bn.num_points):
            raise ValueError("the new SDP's blocks differ in shape")
        d_c.append(mp.sub(t(bn.c), t(bo.c)))
        d_B.append(mp.sub(t(bn.B), t(bo.B)))
    return d_const, d_b, d_c, d_B


def approx_objective(problem, x, y, d_const, d_b, d_c, d_B,
                     factorizations=None):
    """(objective, d_objective, dd_objective) as MP scalars;
    ``factorizations=None`` gives the linear approximation only."""
    from ..mp import core as mp
    from ..mp import linalg as la

    k, dt, dev = problem.b.shape[-1], problem.b.dtype, problem.b.device
    objective = mp.add(problem.objective_const, mp.dot(problem.b, y, axis=0))

    # linear: dconst + db.y + sum_b (dc.x - x.dB.y)
    d_obj = mp.add(d_const, mp.dot(d_b, y, axis=0))
    for i in range(len(problem.blocks)):
        d_obj = mp.add(d_obj, mp.dot(d_c[i], x[i], axis=0))
        dBy = la.matvec(d_B[i], y)
        d_obj = mp.sub(d_obj, mp.dot(dBy, x[i], axis=0))

    dd_obj = mp.zeros((), k, dev, dt)
    if factorizations is not None:
        L_S, LinvB, L_Q = factorizations
        # rhs: dx = dB.y - dc ; dy = db - dB^T.x  (`compute_dx_dy.cxx`)
        dx_rhs = [mp.sub(la.matvec(d_B[i], y), d_c[i])
                  for i in range(len(problem.blocks))]
        dy_rhs = d_b
        for i in range(len(problem.blocks)):
            dy_rhs = mp.sub(dy_rhs, la.matvec(d_B[i], x[i], transpose=True))
        dx, dy = _solve_schur(problem, L_S, LinvB, L_Q, dx_rhs, dy_rhs)

        # dd = (db.dy + dc.dx - dx.dB.y - x.dB.dy)/2
        dd_obj = mp.dot(d_b, dy, axis=0)
        for i in range(len(problem.blocks)):
            dd_obj = mp.add(dd_obj, mp.dot(d_c[i], dx[i], axis=0))
            dBy = la.matvec(d_B[i], y)
            dd_obj = mp.sub(dd_obj, mp.dot(dBy, dx[i], axis=0))
            dBdy = la.matvec(d_B[i], dy)
            dd_obj = mp.sub(dd_obj, mp.dot(dBdy, x[i], axis=0))
        dd_obj = mp.mul_pow2(dd_obj, 0.5)

    total = mp.add(objective, mp.add(d_obj, dd_obj))
    return total, d_obj, dd_obj


def setup_factorizations(problem, X, Y, x, y):
    """S-Cholesky, L^-1 B and Q-Cholesky rebuilt from the solution
    (`setup_solver.cxx:153-224`, the fresh-build branch), through the
    solver's bucketed phases; the factors come back one per block."""
    from ..solver import bucket_iteration
    from ..solver.data import BucketedState, bucketize

    bp = bucketize(problem)
    stack = lambda per_block, bk: torch.stack(
        [per_block[j] for j in bk.block_indices])
    pair = lambda per_block, bk: tuple(
        stack([m[p] for m in per_block], bk) for p in range(2))
    state = BucketedState(x=[stack(x, bk) for bk in bp.buckets], y=y,
                          X=[pair(X, bk) for bk in bp.buckets],
                          Y=[pair(Y, bk) for bk in bp.buckets])
    res = bucket_iteration.compute_residues(bp, state)
    L_S_b, LinvB_b, L_Q = bucket_iteration.schur_factorize(bp, res)
    L_S, LinvB = [None] * len(problem.blocks), [None] * len(problem.blocks)
    for bi, bk in enumerate(bp.buckets):
        for pos, j in enumerate(bk.block_indices):
            L_S[j], LinvB[j] = L_S_b[bi][pos], LinvB_b[bi][pos]
    return L_S, LinvB, L_Q


def write_solver_state(solution_dir, factorizations) -> None:
    """Cache the S-Cholesky, L^-1 B and the Q-Cholesky as text blocks
    (`write_solver_state.cxx`); the Q factor is the LOWER one, as the
    JAX package writes it."""
    from ..io.output import write_matrix

    L_S, LinvB, L_Q = factorizations
    solution_dir = Path(solution_dir)
    for j in range(len(L_S)):
        write_matrix(solution_dir / f"schur_complement_cholesky_{j}.txt",
                     L_S[j])
        write_matrix(solution_dir / f"schur_off_diagonal_{j}.txt", LinvB[j])
    write_matrix(solution_dir / "Q_cholesky.txt", L_Q)


def load_solver_state(solution_dir, problem, k: int):
    """The cached factorizations if present, else None
    (`setup_solver.cxx:160-174`)."""
    from ..io.text_io import read_text_matrix

    solution_dir = Path(solution_dir)
    if not (solution_dir / "Q_cholesky.txt").exists():
        return None
    dev = problem.b.device
    L_S, LinvB = [], []
    for j in range(len(problem.blocks)):
        L_S.append(_tensor(read_text_matrix(
            solution_dir / f"schur_complement_cholesky_{j}.txt", k), dev))
        LinvB.append(_tensor(read_text_matrix(
            solution_dir / f"schur_off_diagonal_{j}.txt", k), dev))
    L_Q = _tensor(read_text_matrix(solution_dir / "Q_cholesky.txt", k), dev)
    return L_S, LinvB, L_Q


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="approx_objective",
        description="Quadratic perturbation estimate of SDP objectives")
    p.add_argument("--sdp", required=True, help="The solved SDP directory")
    p.add_argument("--precision", type=int, required=True)
    p.add_argument("--newSdp", default=None,
                   help="New SDP (or .nsv list) to approximate")
    p.add_argument("--solutionDir", default=None,
                   help="Directory with x_<i>.txt/y.txt (+ X/Y matrices "
                        "for quadratic); default '<sdp>_out'")
    p.add_argument("--linear", action="store_true",
                   help="Only the linear correction")
    p.add_argument("--writeSolverState", action="store_true")
    p.add_argument("--maxSharedMemory", default="0",
                   help="Accepted for compatibility (no effect)")
    p.add_argument("-v", "--verbosity", type=int, default=1)
    return p


def main(argv=None, device=None) -> int:
    """CLI entry point: the CUDA device unless ``device`` says
    otherwise (e.g. "cpu"); raises without a CUDA device."""
    args = build_parser().parse_args(argv)

    from ..device import resolve_device
    from ..io.sdp_json import read_sdp
    from ..mp import decimal as mpdec
    from ..pmp.read import expand_nsv
    from ..solver.data import problem_from_raw
    from ..solver.memory import crt_rows, max_crt_precision, shape_of_raw
    from ..solver.params import SolverParams

    device = resolve_device(device)
    params = SolverParams(precision=args.precision, word_dtype="float64")
    k = params.n_words
    sdp_path = Path(args.sdp)
    solution_dir = Path(args.solutionDir) if args.solutionDir else \
        sdp_path.parent / (sdp_path.name + "_out")

    raw = read_sdp(sdp_path, k=k)
    limit = max_crt_precision(
        lambda p: SolverParams(precision=p, word_dtype="float64").n_words,
        torch.float64, crt_rows(shape_of_raw(raw, k, torch.float64)))
    if args.precision > limit:
        print(f"approx_objective: --precision {args.precision} needs a "
              f"larger CRT modulus than the prime pool (ops/exact.py) "
              f"holds for this SDP; the largest precision it takes is "
              f"{limit}", file=sys.stderr)
        return 2
    if device.type == "cuda":
        from ..ops import expansion_kernels

        # the kernels hold every K the prime pool does: a safeguard
        expansion_kernels.check_words("approx_objective", k)
    problem = problem_from_raw(raw, device, torch.float64, k)
    x, y = read_solution_vectors(solution_dir, problem, k)

    factorizations = None
    if not args.linear:
        factorizations = load_solver_state(solution_dir, problem, k)
        if factorizations is None:
            X, Y = read_solution_XY(solution_dir, problem, k)
            factorizations = setup_factorizations(problem, X, Y, x, y)
            if args.writeSolverState:
                write_solver_state(solution_dir, factorizations)
                if args.verbosity >= 1:
                    print(f"wrote solver state to {solution_dir}",
                          file=sys.stderr)
        elif args.verbosity >= 1:
            print(f"loaded solver state from {solution_dir}",
                  file=sys.stderr)

    host = lambda t: t.detach().cpu().numpy()
    results = []
    if args.newSdp:
        for path in expand_nsv(args.newSdp):
            raw_new = read_sdp(path, k=k)
            total, d_obj, dd_obj = approx_objective(
                problem, x, y, *d_sdp(raw, raw_new, device),
                factorizations=factorizations)
            entry = {"path": str(path),
                     "objective": mpdec.to_decimal(host(total)),
                     "d_objective": mpdec.to_decimal(host(d_obj))}
            if not args.linear:
                entry["dd_objective"] = mpdec.to_decimal(host(dd_obj))
            results.append(entry)

    print(json.dumps(results, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
