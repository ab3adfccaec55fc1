"""PMP front end: data model, sampling, readers, SDP compiler.

Host-side (mpmath) equivalent of the reference's `src/pmp/`,
`src/pmp_read/` and `src/pmp2sdp/` layers; the port's copy of
sdpb_tpu/pmp/, which imports no JAX either.
"""

from .core import (PMP, DampedRational, PolynomialVectorMatrix, make_ctx,
                   poly_eval)
from .read import read_pmp, expand_nsv
from .compile import OutputSDP, compile_pmp, write_sdp

__all__ = [
    "PMP", "DampedRational", "PolynomialVectorMatrix", "make_ctx",
    "poly_eval", "read_pmp", "expand_nsv", "OutputSDP", "compile_pmp",
    "write_sdp",
]
