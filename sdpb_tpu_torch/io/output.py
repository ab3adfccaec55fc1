"""Solution and observability writers, matching the reference's formats:

- ``out.txt``      (`src/sdpb/save_solution.cxx:30-39`)
- ``y.txt``/``z.txt``/``x_<i>.txt``/``X_matrix_<2i+p>.txt``/
  ``Y_matrix_<2i+p>.txt`` ("height width" + one decimal per line)
- ``iterations.json`` (`run/print_iteration.cxx:75-109`)
- ``c_minus_By/c_minus_By.json`` (`run/save_c_minus_By.hxx`)

Every decimal is the exact value of the MP words (float32 limbs or
float64 expansions, ``mp/decimal.py``).
"""

from __future__ import annotations

import json
import pathlib

import numpy as np
import torch

from ..mp import core as mpcore
from ..mp import decimal as mpdec
from ..mp import linalg as la


def _host(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _dec(words) -> str:
    return mpdec.to_decimal(_host(words))


def write_vector(path, vec_mp) -> None:
    vec = _host(vec_mp)
    lines = [f"{vec.shape[0]} 1"] + [_dec(vec[i]) for i in range(vec.shape[0])]
    pathlib.Path(path).write_text("\n".join(lines) + "\n")


def write_matrix(path, mat_mp) -> None:
    mat = _host(mat_mp)
    h, w = mat.shape[0], mat.shape[1]
    lines = [f"{h} {w}"] + [" ".join(_dec(mat[i, j]) for j in range(w))
                            for i in range(h)]
    pathlib.Path(path).write_text("\n".join(lines) + "\n")


def write_out_txt(path, result, runtime_seconds: int) -> None:
    pathlib.Path(path).write_text(
        f'terminateReason = "{result.reason.value}";\n'
        f"primalObjective = {result.primal_objective};\n"
        f"dualObjective   = {result.dual_objective};\n"
        f"dualityGap      = {result.duality_gap};\n"
        f"primalError     = {result.primal_error};\n"
        f"dualError       = {result.dual_error};\n"
        f"Solver runtime  = {runtime_seconds};\n")


def make_z(y_mp, normalization: list[str]):
    """Insert the normalization-eliminated component back into y
    (`save_solution.cxx:70-105`) -> float64 word expansions (K words for
    an expansion y, enough words for a limb y's precision)."""
    import mpmath

    y = _host(y_mp)
    k = y.shape[-1]
    expansion = y.dtype == np.float64
    ctx = mpmath.mp.clone()
    ctx.prec = (53 if expansion else 9) * k + 100
    n_vals = [ctx.mpf(s) for s in normalization]
    max_index = int(np.argmax([abs(float(v)) for v in n_vals]))
    y_vals = [mpdec.to_mpf(y[i], ctx) for i in range(y.shape[0])]
    z_vals = y_vals[:max_index] + [ctx.mpf(0)] + y_vals[max_index:]
    nz = ctx.fsum(n * z for n, z in zip(n_vals, z_vals))
    z_vals[max_index] = (1 - nz) / n_vals[max_index]
    kw = k if expansion else max(2, -(-(9 * k) // 53)) + 1
    return np.stack([mpdec.from_mpf(v, kw) for v in z_vals])


def iter_solution_blocks(problem, state):
    """(block index, shape, x, (X_even, X_odd), (Y_even, Y_odd)) in
    original block order."""
    for j in range(problem.num_blocks):
        shape = next(bk.shape for bk in problem.buckets
                     if j in bk.block_indices)
        yield (j, shape, state.block_x(problem, j),
               state.block_XY(problem, j, "X"),
               state.block_XY(problem, j, "Y"))


def save_solution(out_dir, result, problem, runtime_seconds: int,
                  write_solution: str = "x,y",
                  normalization: list[str] | None = None) -> None:
    """out.txt + the --writeSolution subset of x,y,z,X,Y."""
    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    parts = {p.strip() for p in write_solution.split(",") if p.strip()}
    write_out_txt(out_dir / "out.txt", result, runtime_seconds)
    state = result.state
    if "y" in parts:
        write_vector(out_dir / "y.txt", state.y)
    if "z" in parts:
        if normalization is None:
            raise ValueError("--writeSolution=z requires a normalization "
                             "(normalization.json in the SDP input)")
        write_vector(out_dir / "z.txt", make_z(state.y, normalization))
    for j, shape, x_j, X_j, Y_j in iter_solution_blocks(problem, state):
        if "x" in parts:
            write_vector(out_dir / f"x_{j}.txt", x_j)
        for parity in (0, 1):
            if shape.psd_size(parity) == 0:
                continue
            if "X" in parts:
                write_matrix(out_dir / f"X_matrix_{2 * j + parity}.txt",
                             X_j[parity])
            if "Y" in parts:
                write_matrix(out_dir / f"Y_matrix_{2 * j + parity}.txt",
                             Y_j[parity])


def compute_c_minus_By(problem, y):
    """Per-block c - B y, in original block order."""
    out = {}
    for bk in problem.buckets:
        cmb = mpcore.sub(bk.c, la.matvec(bk.B, y, vdims=1))
        for pos, j in enumerate(bk.block_indices):
            out[j] = _host(cmb[pos])
    return [out[j] for j in sorted(out)]


def save_c_minus_By(path, problem, y) -> None:
    blocks = compute_c_minus_By(problem, y)
    data = {"c_minus_By": [[_dec(b[i]) for i in range(b.shape[0])]
                           for b in blocks]}
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(data))


class IterationsJsonWriter:
    """Streams iterations.json records like the reference (an array of
    objects; an existing file rotates to iterations.<n>.json)."""

    def __init__(self, path):
        self.path = pathlib.Path(path)
        if self.path.exists():
            idx = 0
            while (self.path.parent / f"iterations.{idx}.json").exists():
                idx += 1
            self.path.rename(self.path.parent / f"iterations.{idx}.json")
        self.count = 0
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.path.write_text("[")

    def write(self, rec, total_time: float) -> None:
        entry = {
            "iteration": rec.iteration,
            "total_time": round(total_time, 3),
            "iter_time": round(rec.iter_time, 3),
            "mu": rec.mu, "P-obj": rec.primal_objective,
            "D-obj": rec.dual_objective, "gap": rec.duality_gap,
            "P-err": rec.primal_error_P, "p-err": rec.primal_error_p,
            "D-err": rec.dual_error, "R-err": rec.R_error,
            "P-step": repr(rec.primal_step), "D-step": repr(rec.dual_step),
            "beta": rec.beta_corrector,
            "Q_cond_number": repr(rec.q_cond),
            "max_block_cond_number": repr(rec.max_block_cond),
            "block_name": rec.max_block_cond_name,
        }
        sep = "\n" if self.count == 0 else ",\n"
        with self.path.open("a") as f:
            f.write(sep + json.dumps(entry))
        self.count += 1

    def close(self) -> None:
        with self.path.open("a") as f:
            f.write("\n]")
