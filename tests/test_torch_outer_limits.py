"""The port's outer_limits against sdpb_tpu's, on the CPU.

Inputs: the quickstart PMP (examples/quickstart.py) and the 2x2 PMP
with poles of test_torch_frontend.py, each through the port's
pmp2functions at -p 128 (byte for byte sdpb_tpu's:
test_torch_pmp2functions.py).  The pieces are host mpmath in both
packages and must agree exactly: the Chebyshev DCT and Clenshaw sum,
the mesh's new points, read_function_blocks, setup_constraints,
compute_y_transform, build_problem's word arrays (bit for bit) and the
checkpoint file.  The whole loop runs on the quickstart at --precision
128 (K = 3 words) from the points 0, 1, 4 with thresholds 1e-10 and
initial matrix scales 1e1, against sdpb_tpu's run of the same input
recorded in data/reference_trajectories.json ("outer_limits_quickstart",
tests/make_torch_reference_trajectories.py; a live JAX run takes
~134 s): the optimal and each y within 1e-19; measured gap 0 (the
printed digits are equal), with the same constraints per generation and
the same number of solves.
"""

import gzip
import json
import pathlib

import mpmath
import numpy as np
import pytest
import torch

from sdpb_tpu.apps import outer_limits as jol
from sdpb_tpu.pmp.core import make_ctx as jax_make_ctx
from sdpb_tpu.pmp.compile import max_normalization_index
from sdpb_tpu_torch.apps import outer_limits as ol
from sdpb_tpu_torch.apps import pmp2functions
from sdpb_tpu_torch.pmp.core import make_ctx
from sdpb_tpu_torch.solver.params import SolverParams

from test_torch_frontend import _quickstart, _two_by_two_with_poles
from torch_port_util import one_torch_thread  # noqa: F401,E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
REFERENCE = json.loads((ROOT / "sdpb_tpu_torch" / "data" /
                        "reference_trajectories.json").read_text())[
    "outer_limits_quickstart"]
OPTS = REFERENCE["options"]


@pytest.fixture(scope="module")
def functions(tmp_path_factory):
    """{case: functions.json path} from the port's pmp2functions -p 128."""
    tmp = tmp_path_factory.mktemp("functions")
    out = {}
    for case, write in (("quickstart", _quickstart),
                        ("poles", _two_by_two_with_poles)):
        write(tmp / f"{case}.json")
        out[case] = tmp / f"{case}_functions.json"
        assert pmp2functions.main([
            "-p", "128", "-i", str(tmp / f"{case}.json"), "-o",
            str(out[case]), "-v", "0"]) == 0
    return out


def _same(a, b):
    """Exact equality of nested lists of mpf values (or Functions)."""
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, ol.Function):
        for f in ("max_delta", "epsilon_value", "infinity_value",
                  "chebyshev_coeffs"):
            _same(getattr(a, f), getattr(b, f))
    else:
        assert a == b, (a, b)


def test_chebyshev_round_trip_bit_for_bit():
    """values -> coefficients -> values at the Chebyshev zeros, in both
    packages: equal mpf values, and the identity to 1e-60."""
    ctx, jctx = make_ctx(256), jax_make_ctx(256)
    vals = ["1.5", "-2.25", "0.125", "7", "-3"]
    coeffs = ol._values_to_coeffs([ctx.mpf(v) for v in vals], ctx)
    _same(coeffs, jol._values_to_coeffs([jctx.mpf(v) for v in vals], jctx))
    n = len(vals)
    f = ol.Function(ctx.mpf(10), ctx.mpf(0), ctx.mpf(0), coeffs)
    jf = jol.Function(jctx.mpf(10), jctx.mpf(0), jctx.mpf(0), coeffs)
    eps, inf = ctx.mpf(1e-40), ctx.mpf(1e300)
    for i, v in enumerate(vals):
        x = ctx.mpf("0.5") * 10 * (1 + ctx.cos(ctx.pi * (n - i - ctx.mpf(
            "0.5")) / n))
        got = f.eval(eps, inf, x, ctx)
        assert got == jf.eval(eps, inf, x, jctx)
        assert abs(got - ctx.mpf(v)) < ctx.mpf("1e-60")
    # both Clenshaw branches and the endpoints
    for x in ("0", "0.1", "3", "9.9", "10"):
        assert f.eval(eps, inf, ctx.mpf(x), ctx) == \
            jf.eval(eps, inf, jctx.mpf(x), jctx)
    assert f.eval(eps, inf, eps, ctx) == 0
    with pytest.raises(ValueError):
        f.eval(eps, inf, ctx.mpf(11), ctx)


def test_mesh_minimum_bit_for_bit():
    found = []
    for mod, mk in ((ol, make_ctx), (jol, jax_make_ctx)):
        ctx = mk(128)
        fn = lambda x: (x - 3) ** 2 - ctx.mpf("0.01")
        mesh = mod._build_mesh(ctx.mpf(0), ctx.mpf(5), ctx.mpf(10),
                               fn(ctx.mpf(0)), fn(ctx.mpf(5)),
                               fn(ctx.mpf(10)), fn, ctx.mpf("0.001"),
                               ctx.mpf("1e-35"), ctx)
        pts = []
        mod._get_new_points(mesh, ctx.mpf("1e-35"), pts)
        found.append(pts)
    _same(found[0], found[1])
    assert found[0] and min(abs(p - 3) for p in found[0]) < 0.05


def _pieces(mod, mk, path, points):
    """read_function_blocks, setup_constraints and compute_y_transform
    of one package at 128 bits."""
    ctx = mk(128)
    objectives, normalization, blocks = mod.read_function_blocks(path, ctx)
    infinity = ctx.mpf(np.finfo(np.float64).max)
    epsilon = ctx.ldexp(ctx.mpf(1), -ctx.prec)
    pts = [{epsilon, infinity, *(ctx.mpf(p) for p in block)}
           for block in points]
    max_index = max_normalization_index(normalization)
    c, B, dims = mod.setup_constraints(max_index, epsilon, infinity, blocks,
                                       normalization, pts, ctx)
    transform = mod.compute_y_transform(c, B, objectives, normalization,
                                        max_index, True, ctx)
    return dict(ctx=ctx, read=(objectives, normalization, blocks),
                constraints=(c, B, dims), transform=transform,
                objective_const=objectives[max_index]
                / normalization[max_index])


@pytest.mark.parametrize("case,points", [
    ("quickstart", [["0", "1", "4"]]),
    ("poles", [["0", "0.5", "2", "7"]])])
def test_pieces_bit_for_bit(functions, case, points):
    """read_function_blocks, setup_constraints, compute_y_transform and
    build_problem's word arrays (CPU tensors against sdpb_tpu's arrays,
    every bit)."""
    got = _pieces(ol, make_ctx, functions[case], points)
    want = _pieces(jol, jax_make_ctx, functions[case], points)
    for key in ("read", "constraints", "transform"):
        _same(got[key], want[key])
    k = SolverParams(precision=128, word_dtype="float64").n_words
    c, B, dims = got["constraints"]
    yp_to_y, b_star, c_scale = got["transform"]
    problem = ol.build_problem(c, B, dims, yp_to_y, b_star,
                               got["objective_const"], c_scale, k,
                               got["ctx"], "cpu")
    jproblem = jol.build_problem(c, B, dims, yp_to_y, b_star,
                                 got["objective_const"], c_scale, k,
                                 got["ctx"])
    bits = lambda a: np.asarray(a, dtype=np.float64).tobytes()
    assert problem.b.device.type == "cpu" and problem.k == k
    assert bits(problem.b) == bits(jproblem.b)
    assert bits(problem.objective_const) == bits(jproblem.objective_const)
    assert len(problem.buckets) == len(jproblem.buckets)
    for bk, jbk in zip(problem.buckets, jproblem.buckets):
        assert bk.shape == jbk.shape or (
            bk.shape.m, bk.shape.pts) == (jbk.shape.m, jbk.shape.pts)
        assert bk.block_indices == tuple(jbk.block_indices)
        for name in ("c", "B"):
            assert bits(getattr(bk, name)) == bits(getattr(jbk, name)), name
        for p in range(2):
            assert bits(bk.q[p]) == bits(jbk.q[p])
            assert bits(bk.u[p]) == bits(jbk.u[p])


def _argv(functions, tmp_path, precision):
    (tmp_path / "points.json").write_text(json.dumps(
        {"points": OPTS["points"]}))
    return ["--functions", str(functions["quickstart"]), "--points",
            str(tmp_path / "points.json"), "--precision", str(precision),
            "--dualityGapThreshold", OPTS["dualityGapThreshold"],
            "--primalErrorThreshold", OPTS["primalErrorThreshold"],
            "--dualErrorThreshold", OPTS["dualErrorThreshold"],
            "--initialMatrixScalePrimal", OPTS["initialMatrixScalePrimal"],
            "--initialMatrixScaleDual", OPTS["initialMatrixScaleDual"],
            "-o", str(tmp_path / "out.json"), "-c", str(tmp_path / "ck")]


def test_whole_loop_matches_the_recorded_sdpb_tpu_run(functions, tmp_path,
                                                      capsys, monkeypatch):
    """The CLI on the CPU at --precision 128: optimal and y within 1e-19
    of sdpb_tpu's (measured 0), the same constraints per generation and
    number of solves; each generation's checkpoint the text sdpb_tpu
    writes from the same values."""
    saved = []
    save = ol.save_checkpoint

    def keep(ck_dir, generation, *args):
        """Each generation's checkpoint text, and sdpb_tpu's
        save_checkpoint's from the same values."""
        out = save(ck_dir, generation, *args)
        jax_dir = tmp_path / f"jax_{generation}"
        jol.save_checkpoint(jax_dir, generation, *args)
        name = f"checkpoint_{out}.json.gz"
        saved.append([gzip.decompress((d / name).read_bytes()).decode()
                      for d in (pathlib.Path(ck_dir), jax_dir)])
        return out

    monkeypatch.setattr(ol, "save_checkpoint", keep)
    assert ol.main(_argv(functions, tmp_path, OPTS["precision"]),
                   device="cpu") == 0
    log = capsys.readouterr().out.splitlines()
    out = json.loads((tmp_path / "out.json").read_text())
    ctx = mpmath.mp.clone()
    ctx.prec = 256
    tol = ctx.mpf("1e-19")
    assert abs(ctx.mpf(out["optimal"]) - ctx.mpf(REFERENCE["optimal"])) <= tol
    assert abs(ctx.mpf(out["optimal"]) - ctx.mpf("1.8402657631320492")) \
        <= ctx.mpf("1e-10")
    assert len(out["y"]) == len(REFERENCE["y"])
    for a, b in zip(out["y"], REFERENCE["y"]):
        assert abs(ctx.mpf(a) - ctx.mpf(b)) <= tol
    assert [int(x.split()[1]) for x in log
            if x.startswith("num_constraints:")] == REFERENCE["constraints"]
    assert sum(x.startswith("Threshold:") for x in log) == \
        REFERENCE["solves"]

    # the checkpoint after each generation: the text sdpb_tpu writes
    # from the same values, and sdpb_tpu reads the first one back
    assert len(saved) == len(REFERENCE["constraints"])
    for ours, theirs in saved:
        assert ours == theirs
    jctx = jax_make_ctx(OPTS["precision"])
    ck = jol.load_checkpoint(tmp_path / "jax_0",
                             jctx.mpf(np.finfo(np.float64).max), jctx)
    assert ck["generation"] == 1 and len(ck["points"][0]) == \
        REFERENCE["constraints"][0]
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        f"checkpoint_{n}.json.gz" for n in (len(saved) - 1, len(saved))]


def test_max_precision_is_the_prime_pools():
    """The startup check's limit: the prime pool's for the first
    generation's CRT rows, at most the kernels' 54 words."""
    ctx = make_ctx(128)
    fb = [[[[None]]]]
    limit = ol.max_precision(fb, [[ctx.mpf(0), ctx.mpf(1)]], 1, ctx)
    from sdpb_tpu_torch.ops import expansion_kernels as ek

    assert 2800 < limit <= ek.max_precision_bits()
    assert ol.max_precision(fb * 40, [[ctx.mpf(i) for i in range(50)]] * 40,
                            30, ctx) <= limit
