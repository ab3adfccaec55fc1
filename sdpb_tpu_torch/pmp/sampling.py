"""Sampling algorithm for PMP constraints (v3.1, arXiv:2509.14307).

Host-side mpmath implementation of:
- sample_points   <- `src/pmp/convert/sample_points.cxx:180-239`
  (Bohr-Sommerfeld roots of the integrated density, with a Newton
  solve for the support endpoint b at `sample_points.cxx:66-84`)
- sample_scalings <- `src/pmp/convert/sample_scalings.cxx:5-25`
- bilinear_basis  <- `src/pmp/convert/bilinear_basis/bilinear_basis.cxx`
  (orthogonal polynomials from an upper Cholesky of the sampled moment
  (Hankel) matrix, followed by a triangular inverse)

The Newton solves are bracket-guarded exactly like
boost::math::tools::newton_raphson_iterate and run at half the working
precision (`digits2 = precision/2`), matching the reference.
"""

from __future__ import annotations

import warnings

SMALL_POLE_THRESHOLD = "1e-10"
MIN_POLE_DISTANCE = "1e-16"


def _newton(f_df, guess, lo, hi, digits2_bits, ctx, max_iter=200):
    """Bracketed Newton iteration (boost newton_raphson_iterate
    semantics): clamp to [lo, hi], bisect when the Newton step leaves
    the bracket, stop when |dx| <= |x| * 2^(1-digits2_bits)."""
    x = ctx.mpf(guess)
    lo = ctx.mpf(lo)
    hi = ctx.mpf(hi)
    factor = ctx.ldexp(ctx.mpf(1), 1 - int(digits2_bits))
    dx = hi - lo
    for _ in range(max_iter):
        f, df = f_df(x)
        if f == 0:
            break
        if df == 0:
            # fall back to bisection on the sign of f
            x_new = (lo + hi) / 2
        else:
            x_new = x - f / df
        if x_new <= lo:
            x_new = (x + lo) / 2
        elif x_new >= hi:
            x_new = (x + hi) / 2
        # maintain bracket using the sign of f (f is increasing in our
        # uses; boost shrinks the bracket by the last step direction)
        if x_new < x:
            hi = x
        else:
            lo = x
        dx = x_new - x
        x = x_new
        if abs(dx) <= abs(x) * factor:
            break
    return x


def _b_equation(num_points, prefactor, b, ctx):
    """`sample_points.cxx:42-63`: the defining equation for the support
    endpoint b and its derivative."""
    eq = ctx.mpf(0)
    eq_deriv = ctx.mpf(0)
    for p in prefactor.poles:
        eq += 1 - ctx.sqrt(-p / (b - p))
        eq_deriv += ctx.sqrt(-p) / ctx.sqrt(b - p) ** 3 / 2
    log_base = ctx.log(prefactor.base)
    eq += -b * log_base / 2 - num_points
    eq_deriv += -log_base / 2
    return eq, eq_deriv


def _find_b(num_points, prefactor, ctx):
    lo = ctx.mpf(SMALL_POLE_THRESHOLD)
    hi = -(2 * num_points / ctx.log(prefactor.base))
    assert lo <= hi, (lo, hi)
    guess = (lo + hi) / 2
    return _newton(lambda b: _b_equation(num_points, prefactor, b, ctx),
                   guess, lo, hi, ctx.prec // 2, ctx)


def _acos_safe(x, ctx):
    """acos with truncation of rounding-error overshoot
    (`sample_points.cxx:19-39`)."""
    if abs(x) > 1:
        eps = ctx.ldexp(ctx.mpf(1), -(ctx.prec // 2))
        if abs(x) > 1 + eps:
            warnings.warn("acos argument lies outside of [-1,1] range "
                          f"and will be truncated: {x}")
        return ctx.acos(ctx.mpf(1) if x > 0 else ctx.mpf(-1))
    return ctx.acos(x)


def _integrated_density(prefactor, b, z, ctx):
    """`sample_points.cxx:85-135`: eigenvalue-density CDF and derivative."""
    assert z <= b, (z, b)
    pi = ctx.pi
    density = ctx.mpf(0)
    density_deriv = ctx.mpf(0)
    for p in prefactor.poles:
        density += (_acos_safe(1 - (2 * z * (b - p)) / (b * (z - p)), ctx)
                    - ctx.sqrt(-p / (b - p))
                    * _acos_safe(1 - (2 * z) / b, ctx)) / pi
        density_deriv += (ctx.sqrt(-p) / (ctx.sqrt(b - p) * (z - p))
                          * ctx.sqrt(b - z) / (pi * ctx.sqrt(z)))
    log_base = ctx.log(prefactor.base)
    density += -log_base / pi * (ctx.sqrt((b - z) * z)
                                 + b / 2 * _acos_safe(1 - (2 * z) / b, ctx))
    density_deriv += -log_base * ctx.sqrt(b - z) / (pi * ctx.sqrt(z))
    return density, density_deriv


def sample_points(num_points: int, prefactor, ctx) -> list:
    """Choose num_points sample points on x >= 0 minimizing the
    interpolation error weighted by the (reduced) prefactor
    (`sample_points.cxx:180-239`)."""
    if num_points == 1:
        if prefactor.poles:
            warnings.warn(
                "Prefactor for a constant constraint has poles")
        return [ctx.mpf(0)]

    assert 0 < prefactor.base < 1, \
        f"prefactor base must be in (0,1): {prefactor.base}"

    small = ctx.mpf(SMALL_POLE_THRESHOLD)
    for p in prefactor.poles:
        assert p <= 0, f"All poles must be <= 0: {p}"
    num_small = min(sum(1 for p in prefactor.poles if abs(p) <= small),
                    num_points)

    points = [ctx.mpf(0)] * num_points

    # Bohr-Sommerfeld roots for n in [num_small, num_points)
    if num_small < num_points:
        b = _find_b(num_points, prefactor, ctx)
        assert b > 0
        lo = ctx.mpf(SMALL_POLE_THRESHOLD)
        hi = b
        for n in range(num_small, num_points):
            guess = lo + (hi - lo) / (num_points - n + 1)
            guess = min(max(guess, lo), hi)

            def f_df(z, n=n):
                f, df = _integrated_density(prefactor, b, z, ctx)
                return f - n - ctx.mpf("0.5"), df

            points[n] = _newton(f_df, guess, lo, hi, ctx.prec // 2, ctx)
            lo = points[n]

    # Evenly spaced small points below the first BS root
    # (`sample_points.cxx:214-229`)
    small_point_end = (_find_b(num_points, prefactor, ctx)
                       if num_small == num_points else points[num_small])
    assert small_point_end > 0, "Cannot sample points near zero"
    for i in range(num_small):
        points[i] = small_point_end * i / num_small

    for i in range(1, num_points):
        assert points[i] > points[i - 1], (i, points)
    return points


def sample_scalings(points, damped_rational, ctx) -> list:
    """Evaluate the prefactor at the points, pole-regularized
    (`sample_scalings.cxx:5-25`)."""
    min_dist = ctx.mpf(MIN_POLE_DISTANCE)
    return [damped_rational.evaluate(x, ctx, min_dist) for x in points]


def _orthogonal_polynomials(table, ctx):
    """Coefficients of orthonormal polynomials for the moment table
    t_n = sum_k s_k x_k^n (`bilinear_basis.cxx:7-73`).

    The reference builds the Hankel matrix H[a][b] = t_{a+b} via an
    anti-band layout, upper-Cholesky's it (H = U^T U) and returns rows
    of U^{-1}; here we lower-Cholesky (H = L L^T, U = L^T) and
    forward-substitute, so q_row coefficients = row `row` of L^{-1}.
    """
    assert len(table) % 2 == 1, len(table)
    delta = len(table) // 2
    n = delta + 1
    H = [[table[a + b] for b in range(n)] for a in range(n)]

    # In-place lower Cholesky
    L = [[ctx.mpf(0)] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = H[i][j]
            for t in range(j):
                s -= L[i][t] * L[j][t]
            if i == j:
                if s <= 0:
                    raise ValueError(
                        "bilinear basis moment matrix not positive definite")
                L[i][i] = ctx.sqrt(s)
            else:
                L[i][j] = s / L[j][j]

    # Condition estimate = (max diag / min diag)^2
    # (`bilinear_basis.cxx:27-49`)
    dmin = min(L[i][i] for i in range(n))
    dmax = max(L[i][i] for i in range(n))
    if (dmax / dmin) ** 2 > ctx.ldexp(ctx.mpf(1), ctx.prec // 2):
        warnings.warn("bilinear bases: moment matrix is ill-conditioned, "
                      "this may reduce accuracy")

    # q_row coefficients = row `row` of L^{-1} = solution of
    # L^T w = e_row (back substitution; nonzeros at indices <= row).
    basis = []
    for row in range(n):
        w = [ctx.mpf(0)] * (row + 1)
        w[row] = 1 / L[row][row]
        for i in range(row - 1, -1, -1):
            s = ctx.mpf(0)
            for j in range(i + 1, row + 1):
                s -= L[j][i] * w[j]
            w[i] = s / L[i][i]
        basis.append(w)
    return basis


def bilinear_basis(points, scalings, ctx):
    """Two parity bases of orthogonal polynomials w.r.t. the sampled
    measure (`bilinear_basis.cxx:76-119`).  Returns
    ([q^even coeff-lists], [q^odd coeff-lists])."""
    degree = len(points) - 1
    if degree == 0:
        return [[[ctx.mpf(1)]], []]

    table_all = [ctx.mpf(0)] * (degree + 1)
    for x, s in zip(points, scalings):
        x_pow = ctx.mpf(1)
        for t in range(degree + 1):
            table_all[t] += x_pow * s
            x_pow *= x

    delta1 = degree // 2
    delta2 = (degree + 1) // 2 - 1
    table0 = table_all[: 2 * delta1 + 1]
    table1 = table_all[1: 2 * delta2 + 2]
    return [_orthogonal_polynomials(table0, ctx),
            _orthogonal_polynomials(table1, ctx)]
