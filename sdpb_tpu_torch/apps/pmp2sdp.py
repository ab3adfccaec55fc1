"""`pmp2sdp` CLI: compile a PMP (JSON/Mathematica/XML/NSV) into the
on-disk SDP format consumed by `sdpb`.

Mirrors `src/pmp2sdp/main.cxx:16` + `Pmp2sdp_Parameters.cxx:18-53`
(same flags); the port's copy of sdpb_tpu/apps/pmp2sdp.py, with output
equal byte for byte.
"""

from __future__ import annotations

import argparse
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="pmp2sdp",
        description="Convert a Polynomial Matrix Program to SDP format")
    p.add_argument("-i", "--input", required=True,
                   help="PMP file (.json/.m/.xml) or .nsv file list")
    p.add_argument("-o", "--output", required=True,
                   help="Output SDP directory (or .zip with --zip)")
    p.add_argument("-p", "--precision", type=int, required=True,
                   help="Binary precision (bits) for the output numbers")
    p.add_argument("-n", "--maxNumPoles", type=int, default=-1,
                   help="Keep up to this many rightmost poles in "
                        "reducedPrefactor (-1 = unlimited)")
    p.add_argument("-f", "--outputFormat", default="bin",
                   choices=["json", "bin"],
                   help="Block data file format (default bin, as in the "
                        "reference `write_sdp.cxx:81`)")
    p.add_argument("-z", "--zip", action="store_true",
                   help="Store output to a zip file instead of a directory")
    p.add_argument("-j", "--jobs", type=int, default=0,
                   help="Worker processes for file-parallel parsing and "
                        "sampling (0 = auto, 1 = serial; the reference "
                        "bin-packs input files over MPI groups, "
                        "read_polynomial_matrix_program.cxx:12-50)")
    p.add_argument("-v", "--verbosity", type=int, default=1)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from ..pmp.compile import compile_pmp, write_sdp
    from ..pmp.core import make_ctx
    from ..pmp.read import read_pmp

    t0 = time.time()
    ctx = make_ctx(args.precision)
    max_num_poles = args.maxNumPoles if args.maxNumPoles >= 0 else None
    pmp = read_pmp(args.input, ctx, max_num_poles=max_num_poles,
                   jobs=args.jobs)
    if args.verbosity >= 1:
        print(f"pmp2sdp: read {pmp.num_matrices} matrices "
              f"from {args.input} ({time.time() - t0:.2f}s)")

    sdp = compile_pmp(pmp, ctx)
    command = "pmp2sdp " + " ".join(argv if argv is not None
                                    else sys.argv[1:])
    write_sdp(args.output, sdp, pmp, ctx, command=command,
              as_zip=args.zip, block_format=args.outputFormat)
    if args.verbosity >= 1:
        print(f"pmp2sdp: wrote {sdp.num_blocks} blocks to {args.output} "
              f"({time.time() - t0:.2f}s total)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
