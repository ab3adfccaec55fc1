"""Checkpoints of the port against sdpb_tpu's, and the sdpb CLI's
checkpoint, SIGTERM and restart contract, on the CPU.

A checkpoint is the bucketed limb state; the state here is built from
the committed 1d SDP's problem with seeded random limb values (no
solve), so a file written by one package must load in the other bit
for bit.  The CLI runs in process (``main(argv, device="cpu")``): 6
iterations uninterrupted against 3, a SIGTERM drain and a restart for
3 more must end on identical out.txt objectives (the same arithmetic on
the same state, so exactly equal).
"""

import json
import os
import pathlib
import signal

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdpb_tpu.io.sdp_json import read_sdp as j_read_sdp
from sdpb_tpu.solver import SolverParams as JParams
from sdpb_tpu.solver import checkpoint as jck
from sdpb_tpu.solver import problem_from_raw
from sdpb_tpu.solver.data import BucketedState as JState
from sdpb_tpu.solver.data import bucketize
from sdpb_tpu_torch.apps import sdpb as app
from sdpb_tpu_torch.io.sdp_json import read_sdp
from sdpb_tpu_torch.mp import limb
from sdpb_tpu_torch.solver import checkpoint as tck
from sdpb_tpu_torch.solver import driver
from sdpb_tpu_torch.solver.data import BucketedState, bucketed_problem_from_raw
from sdpb_tpu_torch.solver.params import SolverParams

from torch_port_util import one_torch_thread  # noqa: F401

SDP_1D = pathlib.Path(__file__).resolve().parents[1] / "sdpb_tpu_torch" \
    / "data" / "quickstart_1d_sdp"
PREC = 212


@pytest.fixture(scope="module")
def problems():
    params = SolverParams(precision=PREC)
    raw = read_sdp(SDP_1D, k=params.n_read_words)
    tp = bucketed_problem_from_raw(raw, params.n_words, "cpu")
    jraw = j_read_sdp(SDP_1D, k=params.n_read_words)
    jp = bucketize(problem_from_raw(jraw, dtype=jnp.float32,
                                    k=JParams(precision=PREC,
                                              word_dtype="float32").n_words))
    return params, tp, jp


def _random_state(problem, seed):
    """numpy limb arrays of the state's shapes: random values over a
    wide exponent range (zeros included)."""
    rng = np.random.default_rng(seed)
    k = problem.k

    def arr(*shape):
        w = rng.standard_normal(shape + (2,)) * 2.0 ** rng.integers(
            -80, 80, shape + (1,))
        w[rng.random(shape) < 0.1] = 0.0
        return limb.from_words_np(w, k)

    out = {"y": arr(problem.dual_dim)}
    for i, bk in enumerate(problem.buckets):
        out[f"x_{i}"] = arr(bk.nb, bk.shape.schur_size)
        for p, n in enumerate(bk.shape.psd_sizes):
            out[f"X_{i}_{p}"] = arr(bk.nb, n, n)
            out[f"Y_{i}_{p}"] = arr(bk.nb, n, n)
    return out


def _torch_state(arrays, n):
    t = torch.from_numpy
    return BucketedState(
        x=[t(arrays[f"x_{i}"]) for i in range(n)], y=t(arrays["y"]),
        X=[tuple(t(arrays[f"X_{i}_{p}"]) for p in range(2))
           for i in range(n)],
        Y=[tuple(t(arrays[f"Y_{i}_{p}"]) for p in range(2))
           for i in range(n)])


def _jax_state(arrays, n):
    j = jnp.asarray
    return JState(
        x=[j(arrays[f"x_{i}"]) for i in range(n)], y=j(arrays["y"]),
        X=[tuple(j(arrays[f"X_{i}_{p}"]) for p in range(2))
           for i in range(n)],
        Y=[tuple(j(arrays[f"Y_{i}_{p}"]) for p in range(2))
           for i in range(n)])


def _flat(state):
    return tck._flatten_state(state) if isinstance(state, BucketedState) \
        else {key: np.asarray(v) for key, v in jck._flatten_state(
            state).items()}


def _same(a: dict, b: dict):
    assert a.keys() == b.keys()
    for key in a:
        assert a[key].dtype == b[key].dtype == np.float32, key
        assert np.array_equal(a[key].view(np.int32),
                              b[key].view(np.int32)), key


def test_checkpoints_load_across_packages_bit_for_bit(problems, tmp_path):
    params, tp, jp = problems
    n = len(tp.buckets)
    jparams = JParams(precision=PREC, word_dtype="float32")
    a = _random_state(tp, 1)
    jck.save_checkpoint(tmp_path / "j", _jax_state(a, n), jp, jparams)
    _same(_flat(tck.load_checkpoint(tmp_path / "j", tp, params)), a)
    b = _random_state(tp, 2)
    tck.save_checkpoint(tmp_path / "t", _torch_state(b, n), tp, params)
    _same(_flat(jck.load_checkpoint(tmp_path / "t", jp, jparams)), b)
    meta = json.loads((tmp_path / "t" / "checkpoint.json").read_text())
    assert (meta["current"], meta["backup"]) == (0, None)


def _random_expansions(problem, seed):
    """numpy float64 expansion arrays of the state's shapes: random
    normalized K-word values over a wide exponent range (zeros
    included)."""
    from sdpb_tpu_torch.mp import core as tcore

    rng = np.random.default_rng(seed)
    k = problem.k

    def arr(*shape):
        e = rng.integers(-80, 80, shape + (1,))
        w = rng.standard_normal(shape + (k,)) * 2.0 ** (
            e - 53 * np.arange(k))
        w[rng.random(shape) < 0.1] = 0.0
        return tcore.renorm_words(torch.from_numpy(w), k).numpy()

    out = {"y": arr(problem.dual_dim)}
    for i, bk in enumerate(problem.buckets):
        out[f"x_{i}"] = arr(bk.nb, bk.shape.schur_size)
        for p, n in enumerate(bk.shape.psd_sizes):
            out[f"X_{i}_{p}"] = arr(bk.nb, n, n)
            out[f"Y_{i}_{p}"] = arr(bk.nb, n, n)
    return out


def test_float64_checkpoints_load_across_packages_bit_for_bit(tmp_path):
    """The expansion format's state (sdpb_tpu's --device cpu) written by
    either package loads in the other bit for bit."""
    params = SolverParams(precision=PREC, word_dtype="float64")
    k = params.n_words
    raw = read_sdp(SDP_1D, k=k)
    tp = bucketed_problem_from_raw(raw, k, "cpu", torch.float64)
    jp = bucketize(problem_from_raw(j_read_sdp(SDP_1D, k=k)))
    jparams = JParams(precision=PREC, word_dtype="float64")
    n = len(tp.buckets)
    a = _random_expansions(tp, 6)
    jck.save_checkpoint(tmp_path / "j", _jax_state(a, n), jp, jparams)
    got = _flat(tck.load_checkpoint(tmp_path / "j", tp, params))
    b = _random_expansions(tp, 7)
    tck.save_checkpoint(tmp_path / "t", _torch_state(b, n), tp, params)
    back = _flat(jck.load_checkpoint(tmp_path / "t", jp, jparams))
    for want, have in ((a, got), (b, back)):
        assert want.keys() == have.keys()
        for key in want:
            assert want[key].dtype == have[key].dtype == np.float64, key
            assert np.array_equal(want[key].view(np.int64),
                                  have[key].view(np.int64)), key
    # a limb problem refuses the float64 state, naming the format
    with pytest.raises(RuntimeError, match="float64"):
        tck.load_checkpoint(tmp_path / "j", _limb_problem(), SolverParams(
            precision=PREC))


def _limb_problem():
    params = SolverParams(precision=PREC)
    raw = read_sdp(SDP_1D, k=params.n_read_words)
    return bucketed_problem_from_raw(raw, params.n_words, "cpu")


def test_backup_generation_and_write_retries(problems, tmp_path,
                                             monkeypatch):
    params, tp, _ = problems
    n = len(tp.buckets)
    gens = [_random_state(tp, s) for s in (3, 4, 5)]
    for g in gens:
        tck.save_checkpoint(tmp_path, _torch_state(g, n), tp, params)
    # two generations are kept: 1 (backup) and 2 (current)
    assert sorted(p.name for p in tmp_path.glob("checkpoint_*.npz")) == \
        ["checkpoint_1.npz", "checkpoint_2.npz"]
    _same(_flat(tck.load_checkpoint(tmp_path, tp, params)), gens[2])
    (tmp_path / "checkpoint_2.npz").write_bytes(b"garbage" * 10)
    _same(_flat(tck.load_checkpoint(tmp_path, tp, params)), gens[1])
    (tmp_path / "checkpoint_1.npz").write_bytes(b"PK\x03\x04truncated")
    with pytest.raises(RuntimeError, match="corrupt checkpoint"):
        tck.load_checkpoint(tmp_path, tp, params)

    calls = {"n": 0}
    orig = np.savez

    def failing(*args, **kwargs):
        calls["n"] += 1
        if calls["n"] < 3:
            raise OSError("disk full")
        return orig(*args, **kwargs)

    monkeypatch.setattr(np, "savez", failing)
    monkeypatch.setattr(tck.time, "sleep", lambda s: None)
    tck.save_checkpoint(tmp_path / "retry", _torch_state(gens[0], n), tp,
                        params)
    assert calls["n"] == 3
    _same(_flat(tck.load_checkpoint(tmp_path / "retry", tp, params)),
          gens[0])
    calls["n"] = -100
    with pytest.raises(OSError):
        tck.save_checkpoint(tmp_path / "fail", _torch_state(gens[0], n),
                            tp, params, retries=2)


def _objectives(out_dir):
    fields = {}
    for line in (out_dir / "out.txt").read_text().splitlines():
        key, _, val = line.partition("=")
        fields[key.strip()] = val.strip().rstrip(";")
    return {k: fields[k] for k in ("terminateReason", "primalObjective",
                                   "dualObjective", "dualityGap")}


def test_sigterm_drain_and_restart_match_an_uninterrupted_run(
        tmp_path, monkeypatch):
    base = ["-s", str(SDP_1D), "--precision", str(PREC), "--verbosity", "0"]
    assert app.main(base + ["-o", str(tmp_path / "whole"), "-c",
                            str(tmp_path / "ck_whole"), "--maxIterations",
                            "6"], device="cpu") == 0

    solve = driver.solve

    def solve_then_sigterm(problem, params, state=None, iteration_hook=None,
                           **kw):
        def hook(rec, cur_state):
            if rec.iteration == 3:
                os.kill(os.getpid(), signal.SIGTERM)
            iteration_hook(rec, cur_state)
        return solve(problem, params, state=state, iteration_hook=hook, **kw)

    ck = tmp_path / "ck"
    args = base + ["-o", str(tmp_path / "out"), "-c", str(ck)]
    monkeypatch.setattr(driver, "solve", solve_then_sigterm)
    assert app.main(args + ["--maxIterations", "6"], device="cpu") == 143
    monkeypatch.setattr(driver, "solve", solve)
    assert (ck / "checkpoint.json").exists()
    assert not (ck / "block_timings").exists()
    assert len(json.loads((tmp_path / "out" / "iterations.json")
                          .read_text())) == 3
    # the restart finds ck/checkpoint.json and runs the 3 iterations left
    assert app.main(args + ["--maxIterations", "3"], device="cpu") == 0
    assert _objectives(tmp_path / "out") == _objectives(tmp_path / "whole")
    assert len(json.loads((tmp_path / "out" / "iterations.json")
                          .read_text())) == 3
    assert (ck / "block_timings").read_text() == \
        (tmp_path / "ck_whole" / "block_timings").read_text()
    # the final checkpoint is a generation after the drain's
    meta = json.loads((ck / "checkpoint.json").read_text())
    assert (meta["current"], meta["backup"]) == (1, 0)
