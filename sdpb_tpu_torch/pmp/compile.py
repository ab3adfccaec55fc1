"""PMP -> SDP compiler (the `pmp2sdp` core).

Host-side equivalents of `src/pmp2sdp/`:
- max_normalization_index     <- `src/pmp/max_normalization_index.hxx`
- convert_pvm / OutputSDP     <- `Output_SDP/Output_SDP.cxx:9-150`
  (manual eq. 3.1 -> 2.2: eliminate one decision variable via the
  normalization n.z = 1)
- DualConstraintGroup         <- `Dual_Constraint_Group.cxx:31-77` +
  `sample_bilinear_basis.cxx:19-62`
- write_sdp                   <- `write_sdp.cxx:246` + the per-file
  writers (`write_control_json.cxx`, `write_objectives_json.cxx`,
  `write_normalization_json.cxx`, `write_block_data.cxx`,
  `write_pmp_info_json.hxx`); JSON block format, directory or zip.
"""

from __future__ import annotations

import dataclasses
import json
import math
import zipfile
from pathlib import Path

from .core import PMP, PolynomialVectorMatrix, poly_eval


def max_normalization_index(normalization) -> int:
    """Index of the largest |n_i| (`max_normalization_index.hxx:5`)."""
    best = 0
    for i, v in enumerate(normalization):
        if abs(v) > abs(normalization[best]):
            best = i
    return best


def _is_trivial_normalization(normalization) -> bool:
    """(1, 0, ..., 0) or absent (`Output_SDP.cxx:88-101`)."""
    if normalization is None:
        return True
    for i, v in enumerate(normalization):
        if i == 0 and v != 1:
            return False
        if i != 0 and v != 0:
            return False
    return True


def _convert_polyvec(vec, normalization, max_index, ctx):
    """One polynomial vector from eq. 3.1 basis to eq. 2.2 basis
    (`Output_SDP.cxx:9-56`): out[0] = in[max]/n[max];
    out[1..] = in[i] - n[i]*out[0] for i != max."""
    poly_constant = [c / normalization[max_index] for c in vec[max_index]]
    out = [poly_constant]
    for i in range(len(normalization)):
        if i == max_index:
            continue
        coeffs = list(vec[i])
        size = max(len(coeffs), len(poly_constant))
        coeffs += [ctx.mpf(0)] * (size - len(coeffs))
        for d, pc in enumerate(poly_constant):
            coeffs[d] -= normalization[i] * pc
        out.append(coeffs)
    return out


@dataclasses.dataclass
class DualConstraintGroup:
    """Sampled constraints for one PVM (`Dual_Constraint_Group.hxx:36-67`):
    Tr(A_p Y) + (B y)_p = c_p over tuples p=(r,s,k)."""

    block_index: int
    dim: int
    num_points: int
    c: list                    # [schur_size] mpf
    B: list                    # [schur_size][N] mpf
    bilinear_bases: tuple      # ([he][pts], [ho][pts]) mpf

    @classmethod
    def from_pvm(cls, block_index: int, pvm: PolynomialVectorMatrix, ctx):
        dim = pvm.dim
        pts = pvm.num_points
        vec_dim = len(pvm.polynomials[0][0])
        c = []
        B = []
        # tuple order (s outer, r <= s, k) matches
        # `Dual_Constraint_Group.cxx:52-69` (their c loop variable = s)
        for s in range(dim):
            for r in range(s + 1):
                vec = pvm.polynomials[r][s]
                for k in range(pts):
                    x = pvm.sample_points[k]
                    scale = pvm.sample_scalings[k]
                    c.append(scale * poly_eval(vec[0], x, ctx))
                    B.append([-scale * poly_eval(vec[n], x, ctx)
                              for n in range(1, vec_dim)])

        bases = _sample_bilinear_bases(
            pvm.bilinear_basis, pvm.sample_points,
            pvm.reduced_sample_scalings, ctx)
        return cls(block_index=block_index, dim=dim, num_points=pts,
                   c=c, B=B, bilinear_bases=bases)


def _sample_bilinear_bases(basis_pair, points, scalings, ctx):
    """Evaluate sqrt(s_k) q_i(x_k) for each parity; the odd parity's
    sqrt(x) factor folds into the scalings
    (`sample_bilinear_basis.cxx:19-62`)."""
    even = [[ctx.sqrt(s) * poly_eval(q, x, ctx)
             for x, s in zip(points, scalings)]
            for q in basis_pair[0]]
    odd = [[ctx.sqrt(x * s) * poly_eval(q, x, ctx)
            for x, s in zip(points, scalings)]
           for q in basis_pair[1]]
    return (even, odd)


@dataclasses.dataclass
class OutputSDP:
    """PMP converted to the dual-constraint form (`Output_SDP.hxx`)."""

    objective_const: object
    dual_objective_b: list
    normalization: list | None
    groups: list               # [DualConstraintGroup]

    @property
    def num_blocks(self) -> int:
        return len(self.groups)


def compile_pmp(pmp: PMP, ctx) -> OutputSDP:
    """`Output_SDP::Output_SDP` (`Output_SDP.cxx:77-150`)."""
    if _is_trivial_normalization(pmp.normalization):
        objective_const = pmp.objective[0]
        dual_objective_b = list(pmp.objective[1:])
        groups = [
            DualConstraintGroup.from_pvm(
                pmp.matrix_index_global[i] if pmp.matrix_index_global else i,
                m, ctx)
            for i, m in enumerate(pmp.matrices)
        ]
    else:
        norm = pmp.normalization
        max_index = max_normalization_index(norm)
        objective_const = pmp.objective[max_index] / norm[max_index]
        dual_objective_b = [
            pmp.objective[i] - norm[i] * objective_const
            for i in range(len(norm)) if i != max_index
        ]
        groups = []
        for i, m in enumerate(pmp.matrices):
            converted = [
                [_convert_polyvec(m.polynomials[r][s], norm, max_index, ctx)
                 for s in range(m.dim)]
                for r in range(m.dim)
            ]
            # Re-wrap with the matrix's existing sampling data; the
            # conversion does not change degrees or sampling
            # (`Output_SDP.cxx:119-127` reuses the same PVM sampling).
            shim = _converted_pvm(m, converted)
            idx = pmp.matrix_index_global[i] if pmp.matrix_index_global else i
            groups.append(DualConstraintGroup.from_pvm(idx, shim, ctx))
    return OutputSDP(
        objective_const=objective_const,
        dual_objective_b=dual_objective_b,
        normalization=[*map(lambda v: v, pmp.normalization)]
        if pmp.normalization is not None else None,
        groups=groups,
    )


def _converted_pvm(m: PolynomialVectorMatrix, converted):
    """A shallow PVM copy with replaced polynomials (sampling reused)."""
    shim = object.__new__(PolynomialVectorMatrix)
    shim.polynomials = converted
    shim.ctx = m.ctx
    shim.prefactor = m.prefactor
    shim.reduced_prefactor = m.reduced_prefactor
    shim.num_points = m.num_points
    shim.sample_points = m.sample_points
    shim.sample_scalings = m.sample_scalings
    shim.reduced_sample_scalings = m.reduced_sample_scalings
    shim.bilinear_basis = m.bilinear_basis
    return shim


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------

def _formatter(ctx):
    digits = int(math.ceil(ctx.prec * 0.30102999566398119522)) + 1
    def fmt(v):
        return ctx.nstr(v, digits, strip_zeros=True, min_fixed=1,
                        max_fixed=0)
    return fmt


def write_sdp(out_path, sdp: OutputSDP, pmp: PMP, ctx,
              command: str = "", as_zip: bool = False,
              block_format: str = "json") -> None:
    """Write the on-disk SDP, directory or zip (`write_sdp.cxx:246`;
    format doc `docs/SDPB_input_format.md`).  ``block_format``:
    "json" (decimal strings) or "bin" (Boost-archive binary block_data,
    the reference's default, `write_block_data.cxx`)."""
    fmt = _formatter(ctx)
    files: dict[str, object] = {}

    files["control.json"] = json.dumps(
        {"num_blocks": sdp.num_blocks, "command": command}, indent=2)
    files["objectives.json"] = json.dumps(
        {"constant": fmt(sdp.objective_const),
         "b": [fmt(v) for v in sdp.dual_objective_b]}, indent=2)
    if pmp.normalization is not None:
        files["normalization.json"] = json.dumps(
            {"normalization": [fmt(v) for v in pmp.normalization]}, indent=2)

    pmp_info = []
    for i, m in enumerate(pmp.matrices):
        idx = pmp.matrix_index_global[i] if pmp.matrix_index_global else i
        path = pmp.source_paths[i] if pmp.source_paths else ""
        pmp_info.append({
            "index": idx,
            "path": str(path),
            "dim": m.dim,
            "prefactor": m.prefactor.json_dict(fmt),
            "reducedPrefactor": m.reduced_prefactor.json_dict(fmt),
            "samplePoints": [fmt(v) for v in m.sample_points],
            "sampleScalings": [fmt(v) for v in m.sample_scalings],
            "reducedSampleScalings": [fmt(v)
                                      for v in m.reduced_sample_scalings],
        })
    files["pmp_info.json"] = json.dumps(pmp_info)

    for g in sdp.groups:
        files[f"block_info_{g.block_index}.json"] = json.dumps(
            {"dim": g.dim, "num_points": g.num_points}, indent=2)
        if block_format == "bin":
            from ..io.sdp_bin import write_block_data_bin_mpf

            files[f"block_data_{g.block_index}.bin"] = \
                write_block_data_bin_mpf(
                    g.B, g.c, g.bilinear_bases[0], g.bilinear_bases[1],
                    ctx.prec, ctx)
        else:
            files[f"block_data_{g.block_index}.json"] = json.dumps({
                "bilinear_bases_even": [[fmt(v) for v in row]
                                        for row in g.bilinear_bases[0]],
                "bilinear_bases_odd": [[fmt(v) for v in row]
                                       for row in g.bilinear_bases[1]],
                "c": [fmt(v) for v in g.c],
                "B": [[fmt(v) for v in row] for row in g.B],
            })

    out_path = Path(out_path)
    if as_zip or out_path.suffix == ".zip":
        out_path.parent.mkdir(parents=True, exist_ok=True)
        with zipfile.ZipFile(out_path, "w",
                             compression=zipfile.ZIP_DEFLATED) as zf:
            for name, content in files.items():
                zf.writestr(name, content)
    else:
        out_path.mkdir(parents=True, exist_ok=True)
        for name, content in files.items():
            if isinstance(content, bytes):
                (out_path / name).write_bytes(content)
            else:
                (out_path / name).write_text(content)
