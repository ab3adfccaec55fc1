"""PMP front-end readers: JSON / Mathematica / XML / NSV.

Host-side equivalents of `src/pmp_read/`:
- read_pmp()        <- `read_polynomial_matrix_program.cxx` (multi-file
  orchestration + objective/normalization consensus checks)
- _read_json()      <- `read_json/Json_PMP_Parser.cxx` (+ key handling in
  `Json_Positive_Matrix_With_Prefactor_Parser.hxx:95-113`)
- _read_mathematica() <- `read_mathematica/parse_SDP/*` (recursive
  descent over `SDP[obj, norm, {PositiveMatrixWithPrefactor[...]...}]`)
- _read_xml()       <- `read_xml/*` (old `<sdp>` element format)
- expand_nsv()      <- `collect_files_expanding_nsv.cxx` /
  `read_nsv_file_list.cxx` (NUL-separated file lists, recursive,
  relative to the .nsv's directory)
"""

from __future__ import annotations

import json
import re
import xml.sax
from pathlib import Path

from .core import PMP, DampedRational, PolynomialVectorMatrix


# ---------------------------------------------------------------------------
# NSV expansion
# ---------------------------------------------------------------------------

def read_nsv_file_list(path: Path) -> list:
    raw = Path(path).read_bytes().decode()
    entries = [e for e in raw.split("\0") if e]
    out = []
    for e in entries:
        p = Path(e)
        if not p.is_absolute():
            p = Path(path).parent / p
        out.append(p)
    return out


def expand_nsv(paths) -> list:
    """Expand .nsv entries recursively into a flat file list."""
    if isinstance(paths, (str, Path)):
        paths = [paths]
    out = []
    for p in paths:
        p = Path(p)
        if p.suffix == ".nsv":
            out.extend(expand_nsv(read_nsv_file_list(p)))
        else:
            out.append(p)
    return out


# ---------------------------------------------------------------------------
# JSON
# ---------------------------------------------------------------------------

def _damped_rational_json(d, ctx) -> DampedRational:
    return DampedRational(
        constant=ctx.mpf(d["constant"]),
        base=ctx.mpf(d["base"]),
        poles=[ctx.mpf(p) for p in d.get("poles", [])],
    )


def _read_json(path: Path, ctx, max_num_poles=None):
    doc = json.loads(Path(path).read_text())
    objective = [ctx.mpf(s) for s in doc["objective"]] \
        if "objective" in doc else None
    normalization = [ctx.mpf(s) for s in doc["normalization"]] \
        if "normalization" in doc else None

    matrices = []
    for entry in doc.get("PositiveMatrixWithPrefactorArray", []):
        prefactor = None
        if "prefactor" in entry:
            prefactor = _damped_rational_json(entry["prefactor"], ctx)
        elif "DampedRational" in entry:
            prefactor = _damped_rational_json(entry["DampedRational"], ctx)
        reduced = _damped_rational_json(entry["reducedPrefactor"], ctx) \
            if "reducedPrefactor" in entry else None

        polynomials = [
            [[[ctx.mpf(c) for c in poly] for poly in vec] for vec in row]
            for row in entry["polynomials"]
        ]

        def opt_vec(key):
            return [ctx.mpf(s) for s in entry[key]] if key in entry else None

        bilinear = None
        if "bilinearBasis" in entry:
            basis = [[ctx.mpf(c) for c in poly]
                     for poly in entry["bilinearBasis"]]
            bilinear = [basis, [list(p) for p in basis]]
        if "bilinearBasis_0" in entry or "bilinearBasis_1" in entry:
            if bilinear is None:
                bilinear = [[], []]
            for parity, key in enumerate(("bilinearBasis_0",
                                          "bilinearBasis_1")):
                if key in entry:
                    bilinear[parity] = [[ctx.mpf(c) for c in poly]
                                        for poly in entry[key]]

        matrices.append(PolynomialVectorMatrix(
            polynomials, ctx,
            prefactor=prefactor,
            reduced_prefactor=reduced,
            max_num_poles=_merge_max_num_poles(
                entry.get("maxNumPoles"), max_num_poles),
            sample_points=opt_vec("samplePoints"),
            sample_scalings=opt_vec("sampleScalings"),
            reduced_sample_scalings=opt_vec("reducedSampleScalings"),
            bilinear_basis=bilinear,
        ))
    return objective, normalization, matrices


def _merge_max_num_poles(local, global_):
    """min of the per-matrix and CLI limits, negatives = unlimited
    (`Json_Positive_Matrix_With_Prefactor_Parser.hxx:117-131`)."""
    vals = [v for v in (local, global_) if v is not None and v >= 0]
    return min(vals) if vals else None


# ---------------------------------------------------------------------------
# Mathematica SDP[...] expressions
# ---------------------------------------------------------------------------

_WS = re.compile(r"\s+")


def _parse_mathematica_number(s: str, ctx):
    """Convert '−1.234`199.6*^-10' to an mpf (`parse_number.cxx`)."""
    s = _WS.sub("", s)
    if "`" in s:
        head, _, tail = s.partition("`")
        # drop the precision mark digits up to *^ (if any)
        star = tail.find("*")
        s = head + (tail[star:] if star >= 0 else "")
    s = s.replace("*^", "e")
    return ctx.mpf(s)


class _MathematicaScanner:
    """Cursor over the SDP[...] expression text."""

    def __init__(self, text: str):
        self.text = text
        self.pos = 0

    def skip_ws(self):
        while self.pos < len(self.text) and self.text[self.pos].isspace():
            self.pos += 1

    def expect(self, literal: str):
        self.skip_ws()
        if not self.text.startswith(literal, self.pos):
            raise ValueError(
                f"Expected {literal!r} at ...{self.text[self.pos:self.pos+40]!r}")
        self.pos += len(literal)

    def peek(self) -> str:
        self.skip_ws()
        return self.text[self.pos] if self.pos < len(self.text) else ""

    def find(self, literal: str):
        idx = self.text.find(literal, self.pos)
        if idx < 0:
            raise ValueError(f"Could not find {literal!r}")
        self.pos = idx

    def scan_until(self, chars) -> str:
        start = self.pos
        # respect continuation backslash-newline inside numbers
        while self.pos < len(self.text) and self.text[self.pos] not in chars:
            self.pos += 1
        if self.pos >= len(self.text):
            raise ValueError("Unexpected end of input")
        return self.text[start:self.pos]


def _scan_number_list(sc: _MathematicaScanner, ctx) -> list:
    """Parse '{n, n, ...}' (possibly empty)."""
    sc.expect("{")
    out = []
    while True:
        if sc.peek() == "}":
            sc.pos += 1
            return out
        raw = sc.scan_until(",}")
        cleaned = raw.replace("\\\n", "").replace("\\\r\n", "")
        if cleaned.strip():
            out.append(_parse_mathematica_number(cleaned, ctx))
        if sc.text[sc.pos] == ",":
            sc.pos += 1
        else:
            sc.pos += 1  # consume '}'
            return out


def _parse_polynomial_expr(expr: str, ctx) -> list:
    """Parse a polynomial in x like '1 + 2.5*x + x^2 - 3 x^3'
    into a coefficient list (`parse_polynomial.cxx` accepts the subset
    written by SDPB.m: monomials joined by +/-)."""
    expr = expr.replace("\\\n", "").replace("\\\r\n", "")
    s = _WS.sub("", expr)
    if not s:
        return [ctx.mpf(0)]
    # split into signed monomials
    terms = []
    cur = ""
    for i, ch in enumerate(s):
        if ch in "+-" and i > 0 and s[i - 1] not in "e*^+-`":
            terms.append(cur)
            cur = ch if ch == "-" else ""
        else:
            cur += ch
    terms.append(cur)

    coeffs: list = []

    def set_coeff(degree, value):
        while len(coeffs) <= degree:
            coeffs.append(ctx.mpf(0))
        coeffs[degree] += value

    for term in terms:
        if not term:
            continue
        if "x" in term:
            mant, _, xpart = term.partition("x")
            mant = mant.rstrip("*")
            if mant in ("", "-", "+"):
                mant += "1"
            degree = 1
            if xpart.startswith("^"):
                degree = int(xpart[1:])
            set_coeff(degree, _parse_mathematica_number(mant, ctx))
        else:
            set_coeff(0, _parse_mathematica_number(term, ctx))
    if not coeffs:
        coeffs = [ctx.mpf(0)]
    return coeffs


def _scan_polynomial_vector(sc: _MathematicaScanner, ctx) -> list:
    sc.expect("{")
    polys = []
    while True:
        if sc.peek() == "}":
            sc.pos += 1
            return polys
        raw = sc.scan_until(",}")
        polys.append(_parse_polynomial_expr(raw, ctx))
        if sc.text[sc.pos] == ",":
            sc.pos += 1
        else:
            sc.pos += 1
            return polys


def _scan_damped_rational(sc: _MathematicaScanner, ctx) -> DampedRational:
    """DampedRational[constant, {poles}, base, x] or a bare constant."""
    sc.skip_ws()
    if not sc.text.startswith("DampedRational[", sc.pos):
        raw = sc.scan_until(",")
        return DampedRational(_parse_mathematica_number(raw, ctx),
                              ctx.mpf(1), [])
    sc.expect("DampedRational[")
    const = _parse_mathematica_number(sc.scan_until(","), ctx)
    sc.expect(",")
    poles = _scan_number_list(sc, ctx)
    sc.expect(",")
    base = _parse_mathematica_number(sc.scan_until(","), ctx)
    sc.expect(",")
    sc.scan_until("]")
    sc.expect("]")
    return DampedRational(const, base, poles)


def _read_mathematica(path: Path, ctx, max_num_poles=None):
    text = Path(path).read_text()
    sc = _MathematicaScanner(text)
    sc.find("SDP[")
    sc.pos += len("SDP[")
    objective = _scan_number_list(sc, ctx) or None
    sc.expect(",")
    normalization = _scan_number_list(sc, ctx) or None
    sc.expect(",")

    matrices = []
    sc.expect("{")
    while True:
        if sc.peek() == "}":
            sc.pos += 1
            break
        sc.skip_ws()
        sc.expect("PositiveMatrixWithPrefactor[")
        prefactor = _scan_damped_rational(sc, ctx)
        sc.expect(",")
        # matrix of polynomial vectors: {{{poly,...},...},...}
        sc.expect("{")
        rows = []
        while True:
            if sc.peek() == "}":
                sc.pos += 1
                break
            sc.skip_ws()
            sc.expect("{")
            row = []
            while True:
                if sc.peek() == "}":
                    sc.pos += 1
                    break
                row.append(_scan_polynomial_vector(sc, ctx))
                if sc.peek() == ",":
                    sc.pos += 1
            rows.append(row)
            if sc.peek() == ",":
                sc.pos += 1
        sc.expect("]")
        matrices.append(PolynomialVectorMatrix(
            rows, ctx, prefactor=prefactor, max_num_poles=max_num_poles))
        if sc.peek() == ",":
            sc.pos += 1
    return objective, normalization, matrices


# ---------------------------------------------------------------------------
# XML (old format)
# ---------------------------------------------------------------------------

class _XmlHandler(xml.sax.ContentHandler):
    """SAX assembly of the `<sdp>` format (`read_xml/*`): objective
    elts, then polynomialVectorMatrix elements with rows/cols/elements
    (row-major)/samplePoints/sampleScalings/bilinearBasis."""

    def __init__(self, ctx, max_num_poles):
        super().__init__()
        self.ctx = ctx
        self.max_num_poles = max_num_poles
        self.objective = []
        self.matrices = []
        self.stack = []
        self.chars = ""
        self.cur = None

    def startElement(self, name, attrs):
        self.stack.append(name)
        self.chars = ""
        if name == "polynomialVectorMatrix":
            self.cur = {"rows": 0, "cols": 0, "elements": [],
                        "samplePoints": [], "sampleScalings": [],
                        "bilinearBasis": []}
        elif name == "polynomialVector":
            self.cur["elements"].append([])
        elif name == "polynomial":
            container = (self.cur["bilinearBasis"]
                         if "bilinearBasis" in self.stack
                         else self.cur["elements"][-1])
            container.append([])

    def characters(self, content):
        self.chars += content

    def endElement(self, name):
        ctx = self.ctx
        text = self.chars.strip()
        path = self.stack
        if name == "elt":
            if "objective" in path:
                self.objective.append(ctx.mpf(text))
            elif "samplePoints" in path:
                self.cur["samplePoints"].append(ctx.mpf(text))
            elif "sampleScalings" in path:
                self.cur["sampleScalings"].append(ctx.mpf(text))
        elif name == "coeff":
            container = (self.cur["bilinearBasis"]
                         if "bilinearBasis" in path
                         else self.cur["elements"][-1])
            container[-1].append(ctx.mpf(text))
        elif name == "rows":
            self.cur["rows"] = int(text)
        elif name == "cols":
            self.cur["cols"] = int(text)
        elif name == "polynomialVectorMatrix":
            m = self.cur
            rows, cols = m["rows"], m["cols"]
            elems = m["elements"]
            assert len(elems) == rows * cols, (len(elems), rows, cols)
            grid = [[elems[i * cols + j] for j in range(cols)]
                    for i in range(rows)]
            basis = m["bilinearBasis"] or None
            self.matrices.append(PolynomialVectorMatrix(
                grid, ctx,
                max_num_poles=self.max_num_poles,
                sample_points=m["samplePoints"] or None,
                sample_scalings=m["sampleScalings"] or None,
                bilinear_basis=([basis, [list(p) for p in basis]]
                                if basis else None),
            ))
            self.cur = None
        self.stack.pop()
        self.chars = ""


def _read_xml(path: Path, ctx, max_num_poles=None):
    handler = _XmlHandler(ctx, max_num_poles)
    xml.sax.parse(str(path), handler)
    return handler.objective or None, None, handler.matrices


# ---------------------------------------------------------------------------
# Dispatch + multi-file merge
# ---------------------------------------------------------------------------

def _vals_equal(a, b) -> bool:
    return len(a) == len(b) and all(x == y for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# File-parallel reading (`read_polynomial_matrix_program.cxx:12-50`: the
# reference bin-packs input files over MPI process groups by file size;
# here a process pool with LPT submission order -- biggest files first,
# dynamic work stealing -- replaces the static bin-pack)
# ---------------------------------------------------------------------------

def _to_wire(obj):
    """Deep-convert parse results for pickling across processes: mpf
    leaves become their raw ('mpf', (sign, man, exp, bc)) tuples
    (clone-context mpf classes are not picklable), PolynomialVectorMatrix
    keeps its precomputed sampling data (the expensive part)."""
    if hasattr(obj, "_mpf_"):
        return ("__mpf__", obj._mpf_)
    if isinstance(obj, DampedRational):
        return ("__dr__", _to_wire(obj.constant), _to_wire(obj.base),
                _to_wire(obj.poles))
    if isinstance(obj, PolynomialVectorMatrix):
        d = {k: _to_wire(v) for k, v in obj.__dict__.items() if k != "ctx"}
        return ("__pvm__", d)
    if isinstance(obj, list):
        return ["__list__"] + [_to_wire(v) for v in obj]
    if isinstance(obj, tuple):
        return ("__tuple__",) + tuple(_to_wire(v) for v in obj)
    if isinstance(obj, dict):
        return {"__dict__": {k: _to_wire(v) for k, v in obj.items()}}
    return obj


def _from_wire(obj, ctx):
    if isinstance(obj, tuple):
        if obj and obj[0] == "__mpf__":
            return ctx.make_mpf(obj[1])
        if obj and obj[0] == "__dr__":
            return DampedRational(
                constant=_from_wire(obj[1], ctx),
                base=_from_wire(obj[2], ctx), poles=_from_wire(obj[3], ctx))
        if obj and obj[0] == "__pvm__":
            pvm = PolynomialVectorMatrix.__new__(PolynomialVectorMatrix)
            pvm.__dict__.update(
                {k: _from_wire(v, ctx) for k, v in obj[1].items()})
            pvm.ctx = ctx
            return pvm
        if obj and obj[0] == "__tuple__":
            return tuple(_from_wire(v, ctx) for v in obj[1:])
        return obj
    if isinstance(obj, list):
        if obj and obj[0] == "__list__":
            return [_from_wire(v, ctx) for v in obj[1:]]
        return [_from_wire(v, ctx) for v in obj]
    if isinstance(obj, dict) and "__dict__" in obj:
        return {k: _from_wire(v, ctx) for k, v in obj["__dict__"].items()}
    return obj


def _parse_one_file(f, ctx, max_num_poles):
    suffix = Path(f).suffix
    if suffix == ".json":
        return _read_json(f, ctx, max_num_poles)
    if suffix == ".m":
        return _read_mathematica(f, ctx, max_num_poles)
    if suffix == ".xml":
        return _read_xml(f, ctx, max_num_poles)
    raise ValueError(f"Expected .json, .m, or .xml extension: {f}")


def _parse_file_worker(args):
    """Process-pool entry: parse + sample one PMP file, return wire
    form.  Workers run host code only (the pmp layer is mpmath-only)
    and touch no device."""
    path, precision, max_num_poles = args
    from .core import make_ctx

    ctx = make_ctx(precision)
    obj, norm, mats = _parse_one_file(path, ctx, max_num_poles)
    return _to_wire(obj), _to_wire(norm), _to_wire(mats)


def _parse_files_parallel(files, ctx, max_num_poles, jobs: int):
    """Parse files across a process pool, LPT-ordered (largest file
    first) with dynamic work stealing; results returned in file order."""
    import concurrent.futures as cf
    import multiprocessing as mp_mod
    import os

    precision = ctx.prec
    order = sorted(range(len(files)),
                   key=lambda i: -os.path.getsize(files[i]))
    results = [None] * len(files)
    with cf.ProcessPoolExecutor(
            max_workers=jobs,
            mp_context=mp_mod.get_context("spawn")) as pool:
        futs = {pool.submit(_parse_file_worker,
                            (str(files[i]), precision, max_num_poles)): i
                for i in order}
        for fut in cf.as_completed(futs):
            i = futs[fut]
            obj, norm, mats = fut.result()
            results[i] = (_from_wire(obj, ctx), _from_wire(norm, ctx),
                          _from_wire(mats, ctx))
    return results


def read_pmp(paths, ctx, max_num_poles=None, jobs: int | None = 1) -> PMP:
    """Read and merge one or more PMP files (after NSV expansion).

    Mirrors `read_polynomial_matrix_program.cxx:12-90`: matrices are
    concatenated in file order (global block index = position); the
    objective/normalization must agree across files that define them.

    ``jobs``: worker processes for file-parallel parsing+sampling
    (1 = serial; None/0 = auto: one per file up to the CPU count).
    """
    files = expand_nsv(paths)
    if not files:
        raise ValueError("No input files")

    if not jobs:
        import os

        # auto: one worker per core up to the file count; on boxes with
        # <= 2 cores the interpreter startup of each child eats the
        # win, stay serial
        ncpu = os.cpu_count() or 1
        jobs = 1 if ncpu <= 2 else max(1, min(len(files), ncpu, 16))
    if jobs > 1 and len(files) > 1:
        parsed = _parse_files_parallel(files, ctx, max_num_poles,
                                       min(jobs, len(files)))
    else:
        parsed = [_parse_one_file(f, ctx, max_num_poles) for f in files]

    objective = None
    normalization = None
    matrices = []
    source_paths = []
    for f, (obj, norm, mats) in zip(files, parsed):
        if obj is not None:
            if objective is not None and not _vals_equal(objective, obj):
                raise ValueError(f"Inconsistent objectives in {f}")
            objective = obj
        if norm is not None:
            if normalization is not None \
                    and not _vals_equal(normalization, norm):
                raise ValueError(f"Inconsistent normalization in {f}")
            normalization = norm
        matrices.extend(mats)
        source_paths.extend([str(f)] * len(mats))

    if objective is None:
        raise ValueError("PMP: objective not found in any input file")
    return PMP(
        objective=objective,
        normalization=normalization,
        matrices=matrices,
        matrix_index_global=list(range(len(matrices))),
        source_paths=source_paths,
    )
