"""Record sdpb_tpu's solver trajectories for the PyTorch port's checks.

    JAX_PLATFORMS=cpu python tests/make_torch_reference_trajectories.py \
        [entry ...]

Runs the JAX package's solver on the CPU and writes sdpb_tpu_torch/data/
reference_trajectories.json with, per iteration, mu, the objectives,
the gap, the error norms, beta and the step lengths (25 significant
digits of their float64 values for the limb entries, 60 digits for the
expansion entry), for:

- "quickstart_1d": the committed 1d SDP at --precision 212 in the limb
  format (the accelerator format, XLA route), solved to termination
  (the stock contract);
- "synthetic_shrunk": bench.py's build_problem with 2 + 1 blocks
  (m = 2 with 32 points, m = 4 with 24 points), N = 16, --precision 100,
  2 iterations, limb format;
- "quickstart_1d_expansion": the 1d SDP at --precision 212 in the
  float64-expansion format (K = 4 words, sdpb_tpu's --device cpu),
  solved to termination, with the full primalObjective and the final
  iterate's words (x, y, X, Y per block) as its solution;
- "outer_limits_quickstart": outer_limits on the quickstart PMP
  (examples/quickstart.py) through pmp2functions -p 128, at --precision
  128 from the points 0, 1, 4, thresholds 1e-10 and initial matrix
  scales 1e1: the optimal and the weights y as the CLI prints them, and
  the constraints of each generation.
- "mesh_quickstart_d2", "mesh_quickstart_d3": sdpb_tpu.parallel.mesh
  on the first 2 and 3 virtual CPU devices, the 1d SDP in expansions at
  K = 3, 6 iterations (its one block on device 0, phantoms elsewhere):
  the records, the slot arrays and the final y and x words;
- "mesh_blocks_d2", "mesh_blocks_d3", "mesh_blocks_d2_dist_q": the same
  on the eight-block SDP of tests/torch_dist_util.py::blocks_sdp with
  seeded costs (LPT placement), the last with DIST_Q_MIN_N lowered to 1
  so that Q goes by row panels; 3 iterations;
- "intra_quickstart_d2": sdpb_tpu.parallel.intra_solver on 2 virtual
  CPU devices, the 1d SDP at K = 3, 4 iterations: the records and the
  final y and X words.

The card's machine has no JAX, so chip_smoke.py compares the port's
1d runs against this file; tests/test_torch_solver_synthetic.py and
tests/test_torch_solver_expansion.py do the same on the CPU (a live JAX
run of the shrunk problem takes ~10 min, of the expansion solve ~90 s).
Naming entries records only those and keeps the others of the existing
file.  The file also stores the hash of sdpb_tpu's sources it was
recorded from ("sdpb_tpu_sha256"), which the tests check.
"""

import importlib.util
import json
import pathlib
import sys

import os

os.environ.setdefault("XLA_FLAGS",
                      "--xla_force_host_platform_device_count=8")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import mpmath  # noqa: E402
import numpy as np  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

from sdpb_tpu.io.sdp_json import read_sdp  # noqa: E402
from sdpb_tpu.solver import SolverParams, problem_from_raw, solve  # noqa
from sdpb_tpu.solver.data import bucketize  # noqa: E402
from torch_port_util import sdpb_tpu_source_sha256  # noqa: E402

FIELDS = ("mu", "primal_objective", "dual_objective", "duality_gap",
          "primal_error_P", "primal_error_p", "dual_error",
          "beta_corrector")


def _record(result, digits=25):
    """The iteration records at ``digits`` significant digits (parsed
    at 53 bits for 25 digits, as the limb entries were recorded; at
    precision 400 for more)."""
    ctx = mpmath.mp.clone()
    ctx.prec = 53 if digits <= 25 else 400
    out = []
    for rec in result.iterations:
        row = {f: ctx.nstr(ctx.mpf(getattr(rec, f)), digits)
               for f in FIELDS}
        row["iteration"] = rec.iteration
        row["primal_step"] = rec.primal_step
        row["dual_step"] = rec.dual_step
        out.append(row)
    return {"reason": result.reason.name,
            "primal_objective": result.primal_objective[:40],
            "iterations": out}


def quickstart_1d():
    params = SolverParams(precision=212, word_dtype="float32")
    raw = read_sdp(ROOT / "sdpb_tpu_torch" / "data" / "quickstart_1d_sdp",
                   k=max(2, -(-212 // 53)) + 1)
    problem = bucketize(problem_from_raw(raw, dtype=jnp.float32,
                                         k=params.n_words))
    return dict(precision=212, **_record(solve(problem, params)))


def synthetic_shrunk():
    spec = importlib.util.spec_from_file_location("bench", ROOT / "bench.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    bench.N_DUAL = 16
    params = SolverParams(precision=100, word_dtype="float32",
                          max_iterations=2)
    buckets = [(2, 2, 32), (1, 4, 24)]
    problem, state = bench.build_problem(params, buckets=buckets)
    return dict(precision=100, buckets=buckets, n_dual=16,
                **_record(solve(problem, params, state=state)))


def _words(a):
    """An MP array as nested lists of its float64 words (JSON keeps
    every bit: Python writes floats as their shortest round trip)."""
    return np.asarray(a, dtype=np.float64).tolist()


def quickstart_1d_expansion():
    params = SolverParams(precision=212, word_dtype="float64")
    raw = read_sdp(ROOT / "sdpb_tpu_torch" / "data" / "quickstart_1d_sdp",
                   k=params.n_words)
    problem = bucketize(problem_from_raw(raw, dtype=jnp.float64,
                                         k=params.n_words))
    result = solve(problem, params)
    state = result.state
    solution = {"y": _words(state.y), "blocks": []}
    for i, bk in enumerate(problem.buckets):
        for pos, j in enumerate(bk.block_indices):
            solution["blocks"].append({
                "block": j, "x": _words(state.x[i][pos]),
                "X": [_words(state.X[i][p][pos]) for p in range(2)],
                "Y": [_words(state.Y[i][p][pos]) for p in range(2)]})
    rec = _record(result, digits=60)
    rec["primal_objective"] = result.primal_objective
    return dict(precision=212, words=params.n_words, solution=solution,
                **rec)


# outer_limits_quickstart's options (the CLI's flags)
OUTER_LIMITS_QUICKSTART = dict(
    precision=128, points=[["0", "1", "4"]], dualityGapThreshold="1e-10",
    primalErrorThreshold="1e-10", dualErrorThreshold="1e-10",
    initialMatrixScalePrimal="1e1", initialMatrixScaleDual="1e1")


def outer_limits_quickstart():
    import contextlib
    import io
    import math
    import tempfile

    from sdpb_tpu.apps import outer_limits as ol
    from sdpb_tpu.apps.pmp2functions import pmp_to_functions
    from sdpb_tpu.io import pmp_writer
    from sdpb_tpu.pmp.core import make_ctx
    from sdpb_tpu.pmp.read import read_pmp

    opts = OUTER_LIMITS_QUICKSTART
    prec = opts["precision"]
    ctx = make_ctx(prec)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        # examples/quickstart.py:33-44
        pmp_writer.write_pmp_json(
            tmp / "pmp.json", objective=[0, -1], normalization=[1, 0],
            matrices=[pmp_writer.PositiveMatrixWithPrefactor(
                prefactor=pmp_writer.DampedRational(
                    constant=1, base="0.36787944117144233", poles=[]),
                polynomials=[[[[1, 0, 0, 0, 1], [0, 0, 1, 0, "1/12"]]]])])
        (tmp / "functions.json").write_text(json.dumps(
            pmp_to_functions(read_pmp(tmp / "pmp.json", ctx), ctx),
            indent=2))
        (tmp / "points.json").write_text(json.dumps(
            {"points": opts["points"]}))
        objectives, normalization, functions = ol.read_function_blocks(
            tmp / "functions.json", ctx)
        points = ol.read_points(tmp / "points.json", ctx)
        params = SolverParams(
            precision=prec,
            duality_gap_threshold=opts["dualityGapThreshold"],
            primal_error_threshold=opts["primalErrorThreshold"],
            dual_error_threshold=opts["dualErrorThreshold"],
            initial_matrix_scale_primal=opts["initialMatrixScalePrimal"],
            initial_matrix_scale_dual=opts["initialMatrixScaleDual"])
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            weights = ol.compute_optimal(
                functions, points, objectives, normalization, params, ctx,
                duality_gap_reduction=ctx.mpf(1024),
                mesh_threshold=ctx.mpf("0.001"), verbosity=1)
    digits = int(math.ceil(ctx.prec * 0.30103)) + 1
    fmt = lambda v: ctx.nstr(v, digits, strip_zeros=True, min_fixed=1,
                             max_fixed=0)
    lines = log.getvalue().splitlines()
    return dict(
        options=opts,
        optimal=fmt(sum(o * w for o, w in zip(objectives, weights))),
        y=[fmt(w) for w in weights],
        constraints=[int(x.split()[1]) for x in lines
                     if x.startswith("num_constraints:")],
        solves=sum(x.startswith("Threshold:") for x in lines))


MESH_K = 3
MESH_ITERATIONS = 6
BLOCKS_ITERATIONS = 3
INTRA_ITERATIONS = 4


def _mesh_run(problem, n_dev, costs=None, dist_q_min_n=None,
              iterations=MESH_ITERATIONS):
    from jax.sharding import Mesh

    from sdpb_tpu.parallel import mesh as j_mesh

    devs = jax.devices("cpu")
    assert len(devs) >= n_dev, devs
    saved = j_mesh.DIST_Q_MIN_N
    if dist_q_min_n is not None:
        j_mesh.DIST_Q_MIN_N = dist_q_min_n
    try:
        jm = Mesh(np.array(devs[:n_dev]), (j_mesh.AXIS,))
        mproblem = j_mesh.shard_problem(problem, jm, costs=costs)
        params = SolverParams(precision=MESH_K * 53,
                              max_iterations=iterations)
        result = solve(mproblem, params)
        state = j_mesh.unshard_state(result.state, mproblem)
    finally:
        j_mesh.DIST_Q_MIN_N = saved
    return dict(devices=n_dev, precision=MESH_K * 53,
                slots=[np.asarray(s).tolist() for s in mproblem.perms],
                y=_words(state.y), x=[_words(x) for x in state.x],
                **_record(result, digits=60))


def _quickstart_expansion(k):
    raw = read_sdp(ROOT / "sdpb_tpu_torch" / "data" / "quickstart_1d_sdp",
                   k=k)
    return problem_from_raw(raw, dtype=jnp.float64, k=k)


def mesh_quickstart(n_dev):
    return _mesh_run(bucketize(_quickstart_expansion(MESH_K)), n_dev)


def blocks_costs(problem):
    """Seeded per-block costs of each bucket (the LPT placement's
    input)."""
    rng = np.random.default_rng(1)
    return [rng.uniform(1, 9, bk.nb).tolist() for bk in problem.buckets]


def mesh_blocks(n_dev, dist_q_min_n=None):
    import tempfile

    from torch_dist_util import blocks_sdp

    with tempfile.TemporaryDirectory() as tmp:
        raw = read_sdp(blocks_sdp(tmp), k=MESH_K)
        problem = bucketize(problem_from_raw(raw, dtype=jnp.float64,
                                             k=MESH_K))
    costs = blocks_costs(problem)
    return dict(costs=costs, **_mesh_run(problem, n_dev, costs,
                                         dist_q_min_n, BLOCKS_ITERATIONS))


def intra_quickstart():
    from jax.sharding import Mesh

    from sdpb_tpu.parallel import intra_solver

    problem = _quickstart_expansion(MESH_K)
    jm = Mesh(np.array(jax.devices("cpu")[:2]), (intra_solver.AXIS,))
    params = SolverParams(precision=MESH_K * 53,
                          max_iterations=INTRA_ITERATIONS)
    result = solve(intra_solver.IntraProblem(problem, jm), params)
    st = result.state
    X = [[_words(np.asarray(st.X[j][p])[:n, :n])
          for p, n in enumerate(bl.shape.psd_sizes)]
         for j, bl in enumerate(problem.blocks)]
    return dict(devices=2, precision=MESH_K * 53, y=_words(st.y),
                x=[_words(x) for x in st.x], X=X,
                **_record(result, digits=60))


ENTRIES = {"quickstart_1d": quickstart_1d,
           "synthetic_shrunk": synthetic_shrunk,
           "quickstart_1d_expansion": quickstart_1d_expansion,
           "outer_limits_quickstart": outer_limits_quickstart,
           "mesh_quickstart_d2": lambda: mesh_quickstart(2),
           "mesh_quickstart_d3": lambda: mesh_quickstart(3),
           "mesh_blocks_d2": lambda: mesh_blocks(2),
           "mesh_blocks_d3": lambda: mesh_blocks(3),
           "mesh_blocks_d2_dist_q": lambda: mesh_blocks(2, 1),
           "intra_quickstart_d2": intra_quickstart}


def main(names):
    path = ROOT / "sdpb_tpu_torch" / "data" / "reference_trajectories.json"
    data = json.loads(path.read_text()) if names and path.exists() else {}
    data.update({"source": "sdpb_tpu on the CPU (limb entries: the XLA "
                           "route), tests/make_torch_reference_"
                           "trajectories.py",
                 "sdpb_tpu_sha256": sdpb_tpu_source_sha256()})
    for name in names or ENTRIES:
        data[name] = ENTRIES[name]()
    path.write_text(json.dumps(data, indent=0) + "\n")
    print(f"wrote {path}")


if __name__ == "__main__":
    main(sys.argv[1:])
