"""Checkpoint save and load, the JAX package's format and semantics.

Two generations are kept (current and backup), each one
``checkpoint_<gen>.npz`` holding every bucket's MP arrays exactly;
``checkpoint.json`` carries the generation numbers and the solver
options, and is committed by an atomic rename of
``checkpoint_new.json`` (`SDP_Solver/save_checkpoint.cxx:38-119`).  A
failed write is retried (`save_checkpoint.cxx:67-100`); a load falls
back to the backup generation when the current one cannot be read.

The state is the bucketed layout of ``solver/data.py`` (float32 limbs
or float64 expansions), the same keys and arrays as the JAX package
writes in either format, so a checkpoint written by either package
loads in the other.  Without a
``checkpoint.json``, a directory written with
``--writeSolution=x,y,X,Y`` loads as a text checkpoint
(`load_checkpoint/load_text_checkpoint.cxx`).
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import time
import zipfile

import numpy as np
import torch

from ..mp import limb
from .data import BucketedProblem, BucketedState

_VERSION = "sdpb-tpu-0.1"


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy()


def _flatten_state(state: BucketedState) -> dict:
    out = {"y": _host(state.y)}
    for i, x in enumerate(state.x):
        out[f"x_{i}"] = _host(x)
        for p in range(2):
            out[f"X_{i}_{p}"] = _host(state.X[i][p])
            out[f"Y_{i}_{p}"] = _host(state.Y[i][p])
    return out


def save_checkpoint(ck_dir, state: BucketedState, problem: BucketedProblem,
                    params, retries: int = 10) -> None:
    """Write the next generation and commit it; two generations are
    kept."""
    ck_dir = pathlib.Path(ck_dir)
    ck_dir.mkdir(parents=True, exist_ok=True)
    meta_path = ck_dir / "checkpoint.json"
    old_meta = {}
    if meta_path.exists():
        try:
            old_meta = json.loads(meta_path.read_text())
        except json.JSONDecodeError:
            old_meta = {}
    current = old_meta.get("current", None)
    new_gen = (current + 1) if current is not None else 0

    arrays = _flatten_state(state)
    for attempt in range(retries):
        try:
            np.savez(ck_dir / f"checkpoint_{new_gen}.npz", **arrays)
            break
        except OSError:
            if attempt == retries - 1:
                raise
            time.sleep(1)

    meta = {
        "version": _VERSION,
        "current": new_gen,
        "backup": current,
        "num_blocks": problem.num_blocks,
        "options": dataclasses.asdict(params),
        "time": time.time(),
    }
    tmp = ck_dir / "checkpoint_new.json"
    tmp.write_text(json.dumps(meta, indent=1))
    tmp.rename(meta_path)

    keep = {new_gen, current}
    for f in ck_dir.glob("checkpoint_*.npz"):
        try:
            gen = int(f.stem.split("_")[1])
        except (IndexError, ValueError):
            continue
        if gen not in keep:
            f.unlink()


def load_checkpoint(ck_dir, problem: BucketedProblem,
                    params) -> BucketedState | None:
    """The newest readable generation (else the backup) on the
    problem's device; a text checkpoint when there is no
    ``checkpoint.json``; None when there is neither."""
    ck_dir = pathlib.Path(ck_dir)
    meta_path = ck_dir / "checkpoint.json"
    if not meta_path.exists():
        return _load_text_checkpoint(ck_dir, problem, params)
    meta = json.loads(meta_path.read_text())
    dev = problem.device
    t = lambda a: torch.as_tensor(np.asarray(a), device=dev)
    reason = "no generation file"
    for gen in (meta.get("current"), meta.get("backup")):
        if gen is None:
            continue
        path = ck_dir / f"checkpoint_{gen}.npz"
        if not path.exists():
            continue
        try:
            with np.load(path) as z:
                y = t(z["y"])
                x, X, Y = [], [], []
                for i in range(len(problem.buckets)):
                    x.append(t(z[f"x_{i}"]))
                    X.append(tuple(t(z[f"X_{i}_{p}"]) for p in range(2)))
                    Y.append(tuple(t(z[f"Y_{i}_{p}"]) for p in range(2)))
            _check_shapes(problem, x, y, X, Y, path)
            return BucketedState(x=x, y=y, X=X, Y=Y)
        except (OSError, EOFError, KeyError, ValueError,
                zipfile.BadZipFile) as e:
            reason = f"{path.name}: {e!r}"
    raise RuntimeError(f"corrupt checkpoint in {ck_dir} ({reason})")


def _check_shapes(problem: BucketedProblem, x, y, X, Y, path) -> None:
    k = problem.k
    if tuple(y.shape) != (problem.dual_dim, k) or y.dtype != problem.dtype:
        raise ValueError(f"{path}: y of shape {tuple(y.shape)}, "
                         f"{y.dtype}; the problem needs "
                         f"({problem.dual_dim}, {k}) {problem.dtype}")
    for i, bk in enumerate(problem.buckets):
        if tuple(x[i].shape) != (bk.nb, bk.shape.schur_size, k):
            raise ValueError(f"{path}: x_{i} of shape {tuple(x[i].shape)}")
        for p, n in enumerate(bk.shape.psd_sizes):
            for name, mats in (("X", X), ("Y", Y)):
                if tuple(mats[i][p].shape) != (bk.nb, n, n, k):
                    raise ValueError(f"{path}: {name}_{i}_{p} of shape "
                                     f"{tuple(mats[i][p].shape)}")


def _load_text_checkpoint(ck_dir, problem: BucketedProblem,
                          params) -> BucketedState | None:
    """Per-block text files regrouped into bucket stacks; the decimals
    are read into float64 words, taken as they are by the expansion
    format and converted exactly to limbs."""
    from ..io.text_io import read_text_matrix, read_text_vector

    if not (ck_dir / "y.txt").exists():
        return None
    kw, k = params.n_read_words, params.n_words
    dev = problem.device
    if problem.dtype == torch.float64:
        t = lambda words: torch.as_tensor(words, device=dev)
    else:
        t = lambda words: torch.as_tensor(limb.from_words_np(words, k),
                                          device=dev)
    y = t(read_text_vector(ck_dir / "y.txt", kw))
    x, X, Y = [], [], []
    for bk in problem.buckets:
        xs, Xs, Ys = [], [[], []], [[], []]
        for j in bk.block_indices:
            xs.append(read_text_vector(ck_dir / f"x_{j}.txt", kw))
            for p in range(2):
                n = bk.shape.psd_size(p)
                if n == 0:
                    Xs[p].append(np.zeros((0, 0, kw)))
                    Ys[p].append(np.zeros((0, 0, kw)))
                    continue
                Xs[p].append(read_text_matrix(
                    ck_dir / f"X_matrix_{2 * j + p}.txt", kw))
                Ys[p].append(read_text_matrix(
                    ck_dir / f"Y_matrix_{2 * j + p}.txt", kw))
        x.append(t(np.stack(xs)))
        X.append(tuple(t(np.stack(Xs[p])) for p in range(2)))
        Y.append(tuple(t(np.stack(Ys[p])) for p in range(2)))
    return BucketedState(x=x, y=y, X=X, Y=Y)
