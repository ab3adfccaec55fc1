"""`pmp2functions` CLI: convert a PMP to the outer_limits function-block
format (values at Chebyshev points).

Mirrors `src/pmp2functions/` (`main.cxx:14`, `write_functions.cxx`):
- per block: num_chebyshev_points = max polynomial length,
  max_delta = 8 * max(sample_points), Chebyshev zeros of that interval
- per polynomial: infinity_value = coefficient at the block entry's
  max_degree (0 if below), epsilon_value = coefficient at min_degree,
  chebyshev_values = polynomial values at the Chebyshev zeros
- 2x2 blocks: zero out off-diagonal (or diagonal) max degrees so the
  limiting determinant is correct (`write_functions.cxx:110-131`);
  a block of more than 2 rows is refused

The port's copy of the JAX package's ``apps/pmp2functions.py``: host
mpmath only, over the port's ``pmp/read.py`` and ``pmp/core.py``, and
its functions file equal byte for byte.

    python -m sdpb_tpu_torch.apps.pmp2functions -p 128 -i pmp.json \\
        -o functions.json
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

from ..pmp.core import make_ctx, poly_eval


def pmp_to_functions(pmp, ctx) -> dict:
    """Build the functions-file document (as plain python structures
    with mpf leaves formatted by the caller)."""
    digits = int(math.ceil(ctx.prec * 0.30102999566398119522)) + 1

    def fmt(v):
        return ctx.nstr(ctx.mpf(v), digits, strip_zeros=True, min_fixed=1,
                        max_fixed=0)

    normalization = pmp.normalization
    if normalization is None:
        normalization = [ctx.mpf(0)] * len(pmp.objective)
        normalization[0] = ctx.mpf(1)

    blocks_out = []
    for m in pmp.matrices:
        polys = m.polynomials
        num_rows = len(polys)
        num_cheb = max(len(p) for row in polys for vec in row for p in vec)
        max_delta = 8 * max(m.sample_points)
        cheb_zeros = [
            ctx.mpf("0.5") * max_delta
            * (1 + ctx.cos(ctx.pi * (num_cheb - i - ctx.mpf("0.5"))
                           / num_cheb))
            for i in range(num_cheb)
        ]

        # per-entry max/min nonzero degree
        max_deg = [[0] * num_rows for _ in range(num_rows)]
        min_deg = [[10 ** 9] * num_rows for _ in range(num_rows)]
        for r in range(num_rows):
            for c in range(num_rows):
                for p in polys[r][c]:
                    for d, coeff in enumerate(p):
                        if coeff != 0:
                            max_deg[r][c] = max(max_deg[r][c], d)
                            min_deg[r][c] = min(min_deg[r][c], d)

        # limiting-determinant fix (`write_functions.cxx:110-131`)
        if num_rows == 2:
            first = max_deg[0][0] + max_deg[1][1]
            second = 2 * max_deg[0][1]
            if first > second:
                max_deg[0][1] = max_deg[1][0] = 0
            elif first < second:
                max_deg[0][0] = max_deg[1][1] = 0
        elif num_rows > 2:
            raise ValueError(
                f"Too large a dimension. Only 1x1 and 2x2 supported: "
                f"{num_rows}")

        rows_out = []
        for r in range(num_rows):
            cols_out = []
            for c in range(num_rows):
                vec_out = []
                for p in polys[r][c]:
                    deg = len(p) - 1
                    inf_v = p[max_deg[r][c]] if deg >= max_deg[r][c] \
                        else ctx.mpf(0)
                    eps_v = p[min_deg[r][c]] if deg >= min_deg[r][c] \
                        else ctx.mpf(0)
                    vec_out.append({
                        "max_delta": fmt(max_delta),
                        "infinity_value": fmt(inf_v),
                        "epsilon_value": fmt(eps_v),
                        "chebyshev_values": [
                            fmt(poly_eval(p, x, ctx)) for x in cheb_zeros],
                    })
                cols_out.append(vec_out)
            rows_out.append(cols_out)
        blocks_out.append(rows_out)

    return {
        "objective": [fmt(v) for v in pmp.objective],
        "normalization": [fmt(v) for v in normalization],
        "functions": blocks_out,
    }


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="pmp2functions",
        description="Convert PMP to outer_limits function blocks")
    p.add_argument("precision", type=int, nargs="?", default=None)
    p.add_argument("input", nargs="?", default=None)
    p.add_argument("output", nargs="?", default=None)
    p.add_argument("-p", "--precisionOpt", type=int, dest="precision_opt")
    p.add_argument("-i", "--input", dest="input_opt")
    p.add_argument("-o", "--output", dest="output_opt")
    p.add_argument("-n", "--maxNumPoles", type=int, default=-1)
    p.add_argument("-v", "--verbosity", type=int, default=1)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    precision = args.precision_opt or args.precision
    input_path = args.input_opt or args.input
    output_path = args.output_opt or args.output
    if not (precision and input_path and output_path):
        print("pmp2functions: precision, input and output are required",
              file=sys.stderr)
        return 2

    from ..pmp.read import read_pmp

    ctx = make_ctx(precision)
    max_num_poles = args.maxNumPoles if args.maxNumPoles >= 0 else None
    pmp = read_pmp(input_path, ctx, max_num_poles=max_num_poles)
    doc = pmp_to_functions(pmp, ctx)
    out = Path(output_path)
    if out.parent != Path("."):
        out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(doc, indent=2))
    if args.verbosity >= 1:
        print(f"pmp2functions: wrote {len(doc['functions'])} blocks "
              f"to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
