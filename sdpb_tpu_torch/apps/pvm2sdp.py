"""`pvm2sdp` — DEPRECATED forwarder to pmp2sdp (XML front end).

Mirrors `src/pvm2sdp/main.cxx:13`: prints a deprecation notice and
forwards `pvm2sdp <precision> <input.xml...> <output>` to the pmp2sdp
pipeline.
"""

from __future__ import annotations

import sys


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    print("pvm2sdp is DEPRECATED and will be removed; use pmp2sdp instead.",
          file=sys.stderr)
    if len(argv) < 3:
        print("usage: pvm2sdp <precision> <input...> <outputDir>",
              file=sys.stderr)
        return 2
    precision, *inputs, output = argv
    from .pmp2sdp import main as pmp2sdp_main

    rc = 0
    if len(inputs) == 1:
        return pmp2sdp_main(["-p", precision, "-i", inputs[0],
                             "-o", output])
    # multiple inputs: write a temp NSV list (the reference accepts a
    # list of files on the command line)
    import tempfile
    from pathlib import Path

    with tempfile.TemporaryDirectory() as td:
        nsv = Path(td) / "inputs.nsv"
        nsv.write_bytes(b"".join(
            str(Path(i).resolve()).encode() + b"\0" for i in inputs))
        rc = pmp2sdp_main(["-p", precision, "-i", str(nsv), "-o", output])
    return rc


if __name__ == "__main__":
    sys.exit(main())
