"""PMP data model: polynomials, damped rationals, constraint matrices.

Host-side (mpmath) equivalents of the reference's PMP layer:
- Polynomial            <- `src/pmp/Polynomial.hxx`
- DampedRational        <- `src/sdpb_util/Damped_Rational.hxx`
- PolynomialVectorMatrix<- `src/pmp/Polynomial_Vector_Matrix.hxx:33-66`
  (constructor defaults logic from `src/pmp/Polynomial_Vector_Matrix.cxx`)
- PMP                   <- `src/pmp/Polynomial_Matrix_Program.hxx:16-46`

All numbers are mpmath mpf at a caller-chosen binary precision (the
analog of GMP's global precision).  This layer never touches the GPU:
the reference runs it on host CPUs too, and the arbitrary-precision
Newton solves / Cholesky factorizations are tiny compared to the solve.
"""

from __future__ import annotations

import dataclasses
import warnings

import mpmath

from . import sampling


def make_ctx(precision_bits: int) -> mpmath.ctx_mp.MPContext:
    """An mpmath context at the given binary precision (GMP analog)."""
    ctx = mpmath.mp.clone()
    ctx.prec = precision_bits
    return ctx


def poly_eval(coeffs, x, ctx):
    """Evaluate sum_i coeffs[i] x^i by Horner (`Polynomial.hxx:42-55`)."""
    if not coeffs:
        return ctx.mpf(0)
    r = ctx.mpf(coeffs[-1])
    for c in reversed(coeffs[:-1]):
        r = r * x + c
    return r


def poly_degree(coeffs) -> int:
    return len(coeffs) - 1 if coeffs else 0


@dataclasses.dataclass
class DampedRational:
    """constant * base^x / prod_k (x - poles[k])
    (`sdpb_util/Damped_Rational.hxx:9-39`)."""

    constant: object   # mpf
    base: object       # mpf
    poles: list        # [mpf]

    def is_constant(self) -> bool:
        return not self.poles and self.base == 1

    def evaluate(self, x, ctx, min_pole_distance=0):
        """Evaluate at x; |x - pole| clamped from below by
        min_pole_distance (`Damped_Rational.hxx:17-39`)."""
        num = self.constant * ctx.power(self.base, x)
        den = ctx.mpf(1)
        for p in self.poles:
            delta = x - p
            if abs(delta) < min_pole_distance:
                delta = ctx.mpf(min_pole_distance)
            den *= delta
        return num / den

    def json_dict(self, fmt) -> dict:
        return {
            "constant": fmt(self.constant),
            "base": fmt(self.base),
            "poles": [fmt(p) for p in self.poles],
        }


def default_prefactor(max_degree: int, ctx) -> DampedRational:
    """exp(-x) for non-constant constraints, 1 for constants
    (`Polynomial_Vector_Matrix.cxx:35-60`)."""
    if max_degree == 0:
        return DampedRational(ctx.mpf(1), ctx.mpf(1), [])
    return DampedRational(ctx.mpf(1), ctx.exp(ctx.mpf(-1)), [])


class PolynomialVectorMatrix:
    """m x m symmetric matrix of polynomial vectors plus its sampling
    data.  The constructor reproduces the reference's defaults pipeline
    (`Polynomial_Vector_Matrix.cxx:126-199`): prefactor -> reduced
    prefactor (maxNumPoles truncation) -> num_points -> sample points ->
    scalings -> reduced scalings -> bilinear basis.
    """

    def __init__(self, polynomials, ctx, prefactor=None,
                 reduced_prefactor=None, max_num_poles=None,
                 sample_points=None, sample_scalings=None,
                 reduced_sample_scalings=None, bilinear_basis=None):
        # polynomials: [i][j] -> list of polynomial coeff-lists (len N+1)
        self.polynomials = polynomials
        self.ctx = ctx
        dim = len(polynomials)
        assert all(len(row) == dim for row in polynomials), "must be square"

        max_degree = 0
        for row in polynomials:
            for vec in row:
                for coeffs in vec:
                    max_degree = max(max_degree, poly_degree(coeffs))

        self.prefactor = prefactor if prefactor is not None else \
            default_prefactor(max_degree, ctx)

        # reduced prefactor: rightmost max_num_poles poles kept
        # (`Polynomial_Vector_Matrix.cxx:141-168`)
        if reduced_prefactor is not None:
            if prefactor is None:
                warnings.warn(
                    "reducedPrefactor is specified, but prefactor is not!")
            reduced = reduced_prefactor
        else:
            reduced = self.prefactor
        if max_num_poles is not None and max_num_poles >= 0 \
                and max_num_poles < len(reduced.poles):
            poles = sorted(reduced.poles)
            reduced = DampedRational(
                reduced.constant, reduced.base, poles[-max_num_poles:])
        self.reduced_prefactor = reduced
        if len(reduced.poles) > len(self.prefactor.poles):
            warnings.warn(
                "reducedPrefactor has more poles than prefactor, the "
                "number of sample points will be increased!")

        num_points = (max_degree + 1 + len(reduced.poles)
                      - len(self.prefactor.poles))
        assert num_points > 0, (num_points, max_degree)
        self.num_points = num_points

        self.sample_points = list(sample_points) if sample_points else \
            sampling.sample_points(num_points, self.reduced_prefactor, ctx)
        self.sample_scalings = list(sample_scalings) if sample_scalings \
            else sampling.sample_scalings(
                self.sample_points, self.prefactor, ctx)

        # reduced scalings default (`Polynomial_Vector_Matrix.cxx:183-193`)
        if reduced_sample_scalings:
            self.reduced_sample_scalings = list(reduced_sample_scalings)
        elif (reduced_prefactor is not None
              or len(self.reduced_prefactor.poles)
              != len(self.prefactor.poles)):
            self.reduced_sample_scalings = sampling.sample_scalings(
                self.sample_points, self.reduced_prefactor, ctx)
        else:
            self.reduced_sample_scalings = self.sample_scalings

        # bilinear basis: computed, or user-supplied truncated to
        # (delta1+1, delta2+1) (`Polynomial_Vector_Matrix.cxx:83-124`)
        degree = num_points - 1
        if bilinear_basis is None:
            self.bilinear_basis = sampling.bilinear_basis(
                self.sample_points, self.reduced_sample_scalings, ctx)
        else:
            basis = []
            for parity in (0, 1):
                size = degree // 2 + 1 if parity == 0 else (degree + 1) // 2
                given = bilinear_basis[parity]
                if len(given) < size:
                    raise ValueError(
                        f"PMP: bilinearBasis_{parity} size={len(given)}, "
                        f"required at least {size}")
                if len(given) > size:
                    warnings.warn(
                        f"PMP: bilinearBasis_{parity} size={len(given)} is "
                        f"too large, only the first {size} polynomials "
                        f"will be used")
                basis.append([list(p) for p in given[:size]])
            self.bilinear_basis = basis
        self.validate()

    @property
    def dim(self) -> int:
        return len(self.polynomials)

    def validate(self):
        """`Polynomial_Vector_Matrix::validate`."""
        degree = self.num_points - 1
        assert len(self.sample_points) == self.num_points, \
            (len(self.sample_points), self.num_points)
        assert len(self.reduced_sample_scalings) == len(self.sample_points)
        assert len(self.bilinear_basis[0]) == degree // 2 + 1
        expect_odd = 0 if degree == 0 else (degree + 1) // 2
        assert len(self.bilinear_basis[1]) == expect_odd, \
            (len(self.bilinear_basis[1]), expect_odd)
        m = self.dim
        for i in range(m):
            for j in range(m):
                if i != j and self.polynomials[i][j] != self.polynomials[j][i]:
                    raise ValueError(f"PVM not symmetric at ({i},{j})")


@dataclasses.dataclass
class PMP:
    """A polynomial matrix program (`Polynomial_Matrix_Program.hxx:16`):
    maximize objective . z with normalization . z = 1 subject to J
    positive PVM constraints."""

    objective: list            # [mpf], length N+1
    normalization: list | None  # [mpf] or None
    matrices: list             # [PolynomialVectorMatrix]
    # original global indices + source paths, for pmp_info.json
    matrix_index_global: list = dataclasses.field(default_factory=list)
    source_paths: list = dataclasses.field(default_factory=list)

    @property
    def num_matrices(self) -> int:
        return len(self.matrices)
