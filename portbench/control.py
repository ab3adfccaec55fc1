"""Readings of the comparison that decides ``correct``, for setting and
proving its limits; the benchmark's own runs do not run this.

    python3 portbench/control.py --workload <name> --mode <mode> \
        --iterations <n> --seeds <s> [<s> ...]

On the card (``--device cpu`` at the sizes of the tests) and for each
seed: the cell's problem, ``--iterations`` iterations of the program
from the cold start through the window's own call
(``run.window``), then the comparison at the configuration's precision.
``--mode``:

- ``sound``: the program as the configuration states it (the lower
  readings);
- ``control``: the program one float64 word (53 bits) below the
  configuration's precision (the upper readings);
- ``fault:unchanged``: every step returns the iterate it was given;
- ``fault:half_batch``: Q from the first half of each bucket's blocks,
  doubled (the mean over the rest);
- ``fault:altered``: one entry of each new x changed by 2^-100 of it.

One JSON line a seed: its readings and whether they pass the limits.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    __package__ = "portbench"
    import portbench  # noqa: F401

from . import check  # noqa: E402
from . import problem as pb  # noqa: E402
from . import run as harness  # noqa: E402

CONTROL_BITS = 53
FAULTS = ("unchanged", "half_batch", "altered")


@contextlib.contextmanager
def fault(name: str):
    """The program with one fault planted under the window's call."""
    from sdpb_tpu_torch.solver import bucket_iteration as bit

    if name == "unchanged":
        old = bit.compute_step

        def compute_step(problem, state, *args, **kwargs):
            _, info = old(problem, state, *args, **kwargs)
            return state, info
        attr, new = "compute_step", compute_step
    elif name == "half_batch":
        old = bit._q_residues

        def _q_residues(lb, e_col, plan):
            nb = lb.shape[0]
            if nb < 2:
                return old(lb, e_col, plan)
            q, d = old(lb[:nb // 2], e_col, plan)
            return q + q, d + d
        attr, new = "_q_residues", _q_residues
    elif name == "altered":
        old = bit.apply_step

        def apply_step(*args, **kwargs):
            import torch

            from sdpb_tpu_torch.mp import core

            st, ap, ad = old(*args, **kwargs)
            x0 = st.x[0]
            one = x0[0, :1]
            k, dt = x0.shape[-1], x0.dtype
            eps = core.const_word(torch.tensor(2.0 ** -100, dtype=dt,
                                               device=x0.device), k, dt)
            x0 = x0.clone()
            x0[0, :1] = core.add(one, core.mul(one, eps))
            st.x[0] = x0
            return st, ap, ad
        attr, new = "apply_step", apply_step
    else:
        raise ValueError(f"no fault {name!r}")
    setattr(bit, attr, new)
    try:
        yield
    finally:
        setattr(bit, attr, old)


def readings(cell: dict, seed: int, iterations: int, device,
             precision: int | None = None) -> dict:
    """The comparison's readings of ``iterations`` iterations of the
    program (at ``precision`` bits if given) on the seed's problem."""
    config, traffic = cell["config"], cell["traffic"]
    over = {"max_iterations": iterations + 1}
    if precision is not None:
        over["precision"] = precision
    params = harness.solver_params(config, **over)
    data = pb.generate(seed, [tuple(b) for b in config["blocks"]],
                       int(config["n_dual"]))
    problem, _ = pb.to_program(data, params, device)
    win = harness.window(problem, params, 0.0, device, False,
                         max_iterations=iterations,
                         restart=bool(traffic.get("restart", False)))
    del problem
    return check.judge(data, config, win.states, win.records, device)


def main(argv=None, device=None, root: Path = harness.ROOT) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--mode", default="sound")
    ap.add_argument("--iterations", type=int, default=1)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    import torch

    cell = harness.load_cell(root, args.workload)
    dev = torch.device(args.device or device or "cuda")
    precision = None
    ctx = contextlib.nullcontext()
    if args.mode == "control":
        precision = int(cell["config"]["precision"]) - CONTROL_BITS
    elif args.mode.startswith("fault:"):
        ctx = fault(args.mode.split(":", 1)[1])
    elif args.mode != "sound":
        raise SystemExit(f"no mode {args.mode!r}")
    out = []
    with ctx:
        for seed in args.seeds:
            t0 = time.perf_counter()
            r = readings(cell, seed, args.iterations, dev, precision)
            line = {"workload": args.workload, "mode": args.mode,
                    "seed": seed, "readings": r,
                    "passes": check.verdict(r, cell["limits"]),
                    "seconds": time.perf_counter() - t0}
            print(json.dumps(line), flush=True)
            out.append(line)
    return out


if __name__ == "__main__":
    main()
