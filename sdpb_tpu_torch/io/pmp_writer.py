"""User-facing PMP builder (the port's copy of sdpb_tpu/io/pmp_writer.py):
the Python equivalent of the reference's
Mathematica scripting layer (`mathematica/SDPB.m`: `WritePmpJson`,
`DampedRational`, `PositiveMatrixWithPrefactor`).

Bootstrap codes (or any SDP-generating script) construct a PMP in
Python and write the pmp.json consumed by pmp2sdp:

    from sdpb_tpu_torch.io.pmp_writer import (
        DampedRational, PositiveMatrixWithPrefactor, write_pmp_json)
    write_pmp_json("pmp.json",
                   objective=[0, -1],
                   normalization=[1, 0],
                   matrices=[PositiveMatrixWithPrefactor(
                       DampedRational(constant=1, base="0.367879...",
                                      poles=[]),
                       # polynomials[i][j][n] = coefficient list of the
                       # n-th decision-variable polynomial at entry (i,j)
                       polynomials=[[[[1, 0, 0, 0, 1],
                                      [0, 0, 1, 0, "1/12"]]]])])

Numbers may be ints, floats, decimal strings, fractions ("1/12"), or
mpmath mpfs; they are written as full-precision decimal strings.
"""

from __future__ import annotations

import dataclasses
import json
from fractions import Fraction
from pathlib import Path


def _num_str(v, digits: int = 250) -> str:
    """Render a number as a full-precision decimal string."""
    if isinstance(v, str):
        if "/" in v:
            v = Fraction(v)
        else:
            return v
    if isinstance(v, int):
        return str(v)
    if isinstance(v, Fraction):
        import mpmath

        with mpmath.workprec(int(digits * 3.33) + 16):
            return mpmath.nstr(mpmath.mpf(v.numerator) / v.denominator,
                               digits, strip_zeros=True)
    try:
        import mpmath

        if isinstance(v, mpmath.mpf) or type(v).__name__ == "mpf":
            return mpmath.nstr(v, digits, strip_zeros=True)
    except ImportError:
        pass
    return repr(float(v))


@dataclasses.dataclass
class DampedRational:
    """constant * base^x / prod (x - poles[k])  (`SDPB.m` DampedRational)."""

    constant: object = 1
    base: object = 1
    poles: list = dataclasses.field(default_factory=list)

    def json_dict(self):
        return {
            "constant": _num_str(self.constant),
            "base": _num_str(self.base),
            "poles": [_num_str(p) for p in self.poles],
        }


@dataclasses.dataclass
class PositiveMatrixWithPrefactor:
    """One PMP constraint: m x m matrix of polynomial vectors.

    polynomials[i][j][n] is the coefficient list (lowest degree first)
    of the polynomial multiplying decision variable n at entry (i, j).
    Optional sampling overrides mirror the pmp.json schema
    (`docs/json_schema/pmp_schema.json`).
    """

    prefactor: DampedRational | None = None
    polynomials: list = dataclasses.field(default_factory=list)
    reduced_prefactor: DampedRational | None = None
    max_num_poles: int | None = None
    sample_points: list | None = None
    sample_scalings: list | None = None
    reduced_sample_scalings: list | None = None
    bilinear_basis_even: list | None = None   # list of coeff lists
    bilinear_basis_odd: list | None = None

    def json_dict(self):
        out = {}
        if self.prefactor is not None:
            out["DampedRational"] = self.prefactor.json_dict()
        if self.reduced_prefactor is not None:
            out["reducedPrefactor"] = self.reduced_prefactor.json_dict()
        if self.max_num_poles is not None:
            out["maxNumPoles"] = int(self.max_num_poles)
        out["polynomials"] = [
            [[[_num_str(c) for c in poly] for poly in vec] for vec in row]
            for row in self.polynomials
        ]
        for key, val in (("samplePoints", self.sample_points),
                         ("sampleScalings", self.sample_scalings),
                         ("reducedSampleScalings",
                          self.reduced_sample_scalings)):
            if val is not None:
                out[key] = [_num_str(v) for v in val]
        if self.bilinear_basis_even is not None:
            out["bilinearBasis_0"] = [[_num_str(c) for c in poly]
                                      for poly in self.bilinear_basis_even]
        if self.bilinear_basis_odd is not None:
            out["bilinearBasis_1"] = [[_num_str(c) for c in poly]
                                      for poly in self.bilinear_basis_odd]
        return out


def write_pmp_xml(path, objective, matrices) -> None:
    """`WriteBootstrapSDP` (`mathematica/SDPB.m:134`): the legacy XML
    PMP format (old sampling), readable by the XML front end
    (`pmp_read/read_xml`).  Matrices may carry explicit samplePoints /
    sampleScalings / bilinear bases; the XML schema has no prefactor or
    normalization."""
    def w(out, indent, tag, body=None):
        pad = "  " * indent
        if body is None:
            out.append(f"{pad}<{tag}>")
        else:
            out.append(f"{pad}<{tag}>{body}</{tag}>")

    def close(out, indent, tag):
        out.append("  " * indent + f"</{tag}>")

    out = ['<?xml version="1.0"?>', "<sdp>"]
    w(out, 1, "objective")
    for v in objective:
        w(out, 2, "elt", _num_str(v))
    close(out, 1, "objective")
    w(out, 1, "polynomialVectorMatrices")
    for m in matrices:
        rows = len(m.polynomials)
        w(out, 2, "polynomialVectorMatrix")
        w(out, 3, "rows", rows)
        w(out, 3, "cols", rows)
        w(out, 3, "elements")
        for row in m.polynomials:
            for vec in row:
                w(out, 4, "polynomialVector")
                for poly in vec:
                    w(out, 5, "polynomial")
                    for c in poly:
                        w(out, 6, "coeff", _num_str(c))
                    close(out, 5, "polynomial")
                close(out, 4, "polynomialVector")
        close(out, 3, "elements")
        if m.sample_points is not None:
            w(out, 3, "samplePoints")
            for v in m.sample_points:
                w(out, 4, "elt", _num_str(v))
            close(out, 3, "samplePoints")
        if m.sample_scalings is not None:
            w(out, 3, "sampleScalings")
            for v in m.sample_scalings:
                w(out, 4, "elt", _num_str(v))
            close(out, 3, "sampleScalings")
        if m.bilinear_basis_even is not None:
            # old-sampling XML holds ONE bilinearBasis list (the full
            # combined basis; the READER parity-splits it).  A caller
            # supplying separate parities (the JSON convention) would
            # silently lose the odd basis here -- refuse instead.
            if m.bilinear_basis_odd is not None:
                raise ValueError(
                    "write_pmp_xml: the XML <bilinearBasis> field "
                    "holds the single combined basis "
                    "(bilinear_basis_even); supplying "
                    "bilinear_basis_odd separately is a JSON-format "
                    "convention the XML schema cannot express -- "
                    "merge the parities or use write_pmp_json")
            w(out, 3, "bilinearBasis")
            for poly in m.bilinear_basis_even:
                w(out, 4, "polynomial")
                for c in poly:
                    w(out, 5, "coeff", _num_str(c))
                close(out, 4, "polynomial")
            close(out, 3, "bilinearBasis")
        close(out, 2, "polynomialVectorMatrix")
    close(out, 1, "polynomialVectorMatrices")
    out.append("</sdp>")
    path = Path(path)
    if path.parent != Path("."):
        path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("\n".join(out) + "\n")


def write_pmp_json(path, objective, matrices, normalization=None) -> None:
    """`WritePmpJson` (`mathematica/SDPB.m:46`)."""
    doc = {"objective": [_num_str(v) for v in objective]}
    if normalization is not None:
        doc["normalization"] = [_num_str(v) for v in normalization]
    doc["PositiveMatrixWithPrefactorArray"] = [
        m.json_dict() for m in matrices]
    path = Path(path)
    if path.parent != Path("."):
        path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(doc, indent=1))
