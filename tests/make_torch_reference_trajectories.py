"""Record sdpb_tpu's solver trajectories for the PyTorch port's checks.

    JAX_PLATFORMS=cpu python tests/make_torch_reference_trajectories.py

Runs the JAX package's limb-format solver on the CPU (its accelerator
format, XLA route) and writes sdpb_tpu_torch/data/
reference_trajectories.json with, per iteration, mu, the objectives,
the gap, the error norms, beta and the step lengths (25 significant
digits), for:

- "quickstart_1d": the committed 1d SDP at --precision 212, solved to
  termination (the stock contract);
- "synthetic_shrunk": bench.py's build_problem with 2 + 1 blocks
  (m = 2 with 32 points, m = 4 with 24 points), N = 16, --precision 100,
  2 iterations.

The card's machine has no JAX, so chip_smoke.py compares the port's
1d run against this file; tests/test_torch_solver_synthetic.py does
the same for the shrunk problem (a live JAX run of it takes ~10 min).
The file also stores the hash of sdpb_tpu's sources it was recorded
from ("sdpb_tpu_sha256"), which that test checks.
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


def _record(result):
    out = []
    for rec in result.iterations:
        row = {f: mpmath.nstr(mpmath.mpf(getattr(rec, f)), 25)
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


def main():
    data = {"source": "sdpb_tpu limb format, CPU (XLA route), "
                      "tests/make_torch_reference_trajectories.py",
            "sdpb_tpu_sha256": sdpb_tpu_source_sha256(),
            "quickstart_1d": quickstart_1d(),
            "synthetic_shrunk": synthetic_shrunk()}
    path = ROOT / "sdpb_tpu_torch" / "data" / "reference_trajectories.json"
    path.write_text(json.dumps(data, indent=0) + "\n")
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
