"""CUDA-event times of the float64-expansion column-loop kernels
(``exp_cholesky_panel``, ``exp_solve_unblocked``) at chip_smoke.py's
phase-3 shapes, for several checkouts in one run on one card.

    python3 compare_column_loops.py [--wide] TREE [TREE ...]

Each TREE is the root of a checkout of this repository (this one, or an
older commit unpacked with ``git archive``).  ``--wide`` times the
shapes above K = 20 instead (EXP_WIDE_CHOL_SHAPES, EXP_WIDE_SOLVE_SHAPES;
the libraries of K = 23 and 54 built, not that of K <= 20).  Each runs in a process of
its own, in the order given: its ``sdpb_tpu_torch`` is imported, its
expansion library built from its sources, and every shape timed with
the same inputs (chip_smoke.py's generators and seeds): CUDA events
around 3 calls after a warm-up.  One JSON line per tree and shape, then
per shape the mean time of each tree and the ratio of each tree's mean
to the first tree's.  Needs a CUDA device; bits are chip_smoke.py's to
check.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent


def _smoke():
    """This checkout's chip_smoke.py (shapes, input generators, timing)."""
    spec = importlib.util.spec_from_file_location(
        "column_loop_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def time_tree(tree: str, wide: bool = False) -> list:
    """Times of one checkout's kernels, this process importing its
    package."""
    import numpy as np

    sys.path.insert(0, str(Path(tree).resolve()))
    import torch

    from sdpb_tpu_torch.mp import core
    from sdpb_tpu_torch.ops import expansion_kernels as ek

    if not torch.cuda.is_available():
        raise SystemExit("compare_column_loops: no CUDA device")
    cs = _smoke()
    dev = torch.device("cuda", 0)
    if wide:
        ks = sorted({k for *_, k in cs.EXP_WIDE_CHOL_SHAPES})
        builds = [ek.build(force=True, k=k) for k in ks]
        build = {"seconds": sum(b["seconds"] for b in builds),
                 "ptxas": [ln for b in builds for ln in b["ptxas"]]}
        chol_shapes, solve_shapes = (cs.EXP_WIDE_CHOL_SHAPES,
                                     cs.EXP_WIDE_SOLVE_SHAPES)
    else:
        build = ek.build(force=True)
        chol_shapes, solve_shapes = cs.EXP_CHOL_SHAPES, cs.EXP_SOLVE_SHAPES
    res = cs._ptxas_resources(build["ptxas"])
    rows = [{"tree": tree, "build_s": build["seconds"],
             "spill_bytes": sum(r.get("spill_stores", 0)
                                + r.get("spill_loads", 0)
                                for r in res.values()),
             "resources": {n: r for n, r in res.items()
                           if "chol" in n or "solve" in n
                           or "warp::" in n}}]
    rng = np.random.default_rng(0)
    for bb, R, W, k in chol_shapes:
        c = cs._spd_expansions(rng, bb, R, k, dev, cols=W)
        ms = cs.cuda_ms(lambda: ek.exp_cholesky_panel(c), 3)
        rows.append({"tree": tree, "kernel": "exp_cholesky_panel",
                     "shape": [bb, R, W, k], "ms": ms})
    for bb, n, m, k in solve_shapes:
        lfac = ek.exp_cholesky_panel(cs._spd_expansions(rng, bb, n, k, dev))
        didx = torch.arange(n, device=dev)
        inv_d = core.recip(lfac[:, didx, didx, :]).contiguous()
        b = cs._words_of(rng, rng.standard_normal((bb, n, m)), k, dev)
        for transpose in (False, True):
            ms = cs.cuda_ms(lambda: ek.exp_solve_unblocked(
                lfac, b, inv_d, transpose), 3)
            rows.append({"tree": tree, "kernel": "exp_solve_unblocked",
                         "shape": [bb, n, m, k, int(transpose)], "ms": ms})
    return rows


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    wide = argv[:1] == ["--wide"]
    argv = argv[1:] if wide else argv
    if argv[:1] == ["--one"]:
        for row in time_tree(argv[1], wide):
            print(json.dumps(row), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    rows = []
    for tree in argv:
        proc = subprocess.run([sys.executable, __file__,
                               *(["--wide"] if wide else []), "--one", tree],
                              capture_output=True, text=True)
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode != 0:
            print(f"compare_column_loops: {tree} failed "
                  f"({proc.returncode})", flush=True)
            return proc.returncode
        for line in proc.stdout.splitlines():
            if line.startswith("{"):
                print(line, flush=True)
                rows.append(json.loads(line))
    first = argv[0]
    means = {}
    for r in rows:
        if "ms" in r:
            key = (r["kernel"], tuple(r["shape"]))
            means.setdefault(key, {}).setdefault(r["tree"], []).append(
                r["ms"])
    for (kernel, shape), per in means.items():
        mean = {t: sum(v) / len(v) for t, v in per.items()}
        print(json.dumps({"kernel": kernel, "shape": list(shape),
                          "mean_ms": mean,
                          "vs_first": {t: m / mean[first]
                                       for t, m in mean.items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
