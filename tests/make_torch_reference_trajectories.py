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
  iterate's words (x, y, X, Y per block) as its solution.

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

import jax

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


ENTRIES = {"quickstart_1d": quickstart_1d,
           "synthetic_shrunk": synthetic_shrunk,
           "quickstart_1d_expansion": quickstart_1d_expansion}


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
