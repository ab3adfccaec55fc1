"""Helpers shared by the port's solver tests: carry the JAX package's
bucketed problem and iterate across as plain numpy arrays, and compare
iteration records."""

import hashlib
import pathlib

import mpmath
import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


def sdpb_tpu_source_sha256() -> str:
    """Hash of the reference solver's sources (sdpb_tpu/**/*.py and
    bench.py, paths and bytes), stored beside the trajectories recorded
    from it so that a test notices when the recording is stale."""
    digest = hashlib.sha256()
    files = sorted(ROOT.glob("sdpb_tpu/**/*.py")) + [ROOT / "bench.py"]
    for path in files:
        digest.update(path.relative_to(ROOT).as_posix().encode())
        digest.update(path.read_bytes())
    return digest.hexdigest()


def jax_arrays(problem, state=None) -> dict:
    """sdpb_tpu BucketedProblem (+ BucketedState) -> the flat dict that
    sdpb_tpu_torch.solver.data.bucketed_problem_from_arrays reads."""
    out = {"objective_const": np.asarray(problem.objective_const),
           "b": np.asarray(problem.b)}
    for i, bk in enumerate(problem.buckets):
        p = f"buckets.{i}."
        out[p + "c"] = np.asarray(bk.c)
        out[p + "B"] = np.asarray(bk.B)
        for par in range(2):
            out[p + f"q.{par}"] = np.asarray(bk.q[par])
            out[p + f"u.{par}"] = np.asarray(bk.u[par])
        out[p + "shape"] = np.array([bk.shape.m, bk.shape.pts])
        out[p + "block_indices"] = np.array(bk.block_indices)
    if state is not None:
        out["y"] = np.asarray(state.y)
        for i in range(len(problem.buckets)):
            out[f"x.{i}"] = np.asarray(state.x[i])
            for par in range(2):
                out[f"X.{i}.{par}"] = np.asarray(state.X[i][par])
                out[f"Y.{i}.{par}"] = np.asarray(state.Y[i][par])
    return out


def compare_records(ours, theirs, rel_mp, rel_err, abs_step, floor_err=0):
    """Per-iteration agreement: objectives, mu, gap and beta to
    ``rel_mp`` relative; the error norms (float32 estimates) to
    ``rel_err``, or both at most ``floor_err``; step lengths to
    ``abs_step``."""
    ctx = mpmath.mp.clone()
    ctx.prec = 500
    assert len(ours) == len(theirs), (len(ours), len(theirs))

    def close(a, b, rel):
        a, b = ctx.mpf(a), ctx.mpf(b)
        return abs(a - b) <= rel * max(abs(a), abs(b), ctx.mpf("1e-300"))

    for a, b in zip(ours, theirs):
        for f in ("mu", "primal_objective", "dual_objective",
                  "duality_gap", "beta_corrector"):
            assert close(getattr(a, f), getattr(b, f), rel_mp), \
                (a.iteration, f, getattr(a, f), getattr(b, f))
        for f in ("primal_error_P", "primal_error_p", "dual_error"):
            va, vb = getattr(a, f), getattr(b, f)
            assert close(va, vb, rel_err) or \
                max(abs(ctx.mpf(va)), abs(ctx.mpf(vb))) <= floor_err, \
                (a.iteration, f, getattr(a, f), getattr(b, f))
        for f in ("primal_step", "dual_step"):
            assert abs(getattr(a, f) - getattr(b, f)) <= abs_step, \
                (a.iteration, f, getattr(a, f), getattr(b, f))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU tests run many small tensor operations; with
    several pytest workers on one host, one intra-op thread per worker
    avoids oversubscribing the cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)
