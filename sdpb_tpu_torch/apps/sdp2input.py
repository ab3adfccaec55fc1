"""`sdp2input` — DEPRECATED forwarder to pmp2sdp (Mathematica/JSON).

Mirrors `src/sdp2input/main.cxx:15`: prints a deprecation notice and
forwards `--input/--output/--precision` to the pmp2sdp pipeline.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    print("sdp2input is DEPRECATED and will be removed; "
          "use pmp2sdp instead.", file=sys.stderr)
    p = argparse.ArgumentParser(prog="sdp2input")
    p.add_argument("--input", "-i", required=True)
    p.add_argument("--output", "-o", required=True)
    p.add_argument("--precision", "-p", type=int, required=True)
    p.add_argument("--debug", action="store_true")
    args = p.parse_args(argv)
    from .pmp2sdp import main as pmp2sdp_main

    return pmp2sdp_main(["-p", str(args.precision), "-i", args.input,
                         "-o", args.output])


if __name__ == "__main__":
    sys.exit(main())
