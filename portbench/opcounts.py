"""The yardstick of the kernels: the card's peaks, the operations and
bytes of each hand-written kernel's call from its shapes, and the classes
of device kernels by name.

Frozen copies of ``chip_smoke.py``'s ``_mul_flops``, ``_chol_ops``,
``_solve_ops``, the limb kernels of ``PORT_KERNELS`` and
``PROFILE_CLASSES``, and of the program's Newton step count, so that a
later change of the program cannot move the yardstick.  Each input byte
is counted read once and each output byte written once.
"""

from __future__ import annotations

import math

PEAK_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
PEAK_F32_PER_S = 67e12         # H100 SXM float32, outside tensor cores

LIMB_BITS = 9


def limb_newton_steps(L: int) -> int:
    return max(3, int(math.ceil(math.log2(max(2.0, LIMB_BITS * L / 11.0)))))


def least_seconds(nbytes: float, ops: float, peak_ops: float) -> float:
    """The larger of the bytes at the memory rate and the operations at
    the arithmetic's rate."""
    return max(nbytes / PEAK_BYTES_PER_S, ops / peak_ops)


# --- limbs (float32 arithmetic) --------------------------------------------

def mul_flops(L):
    """L(L+1)/2 + 2L - 3 multiply-adds of a truncated limb product."""
    return 2 * (L * (L + 1) // 2 + 2 * L - 3)


def chol_ops(bb, n, L, steps):
    ops = 0
    for j in range(n):
        r = n - j - 1
        tri = r * (r + 1) // 2
        ops += (3 * steps + 3 + r + tri) * mul_flops(L) + tri * L
    return bb * ops


def solve_ops(bb, n, m, L):
    upd = n * (n - 1) // 2 * m
    return bb * ((n * m + upd) * mul_flops(L) + upd * L)


def limb_elementwise_ops(name, L):
    return {"limb_add": L, "limb_mul": mul_flops(L),
            "limb_div": (L + 2) * 2 * L}[name]


# --- device kernels by name -------------------------------------------------

LIMB_KERNELS = (r"\(anonymous namespace\)::chol_warp_kernel<",
                r"\(anonymous namespace\)::solve_warp_kernel<",
                r"\(anonymous namespace\)::elementwise_warp_kernel<")
# first match wins: the port's kernels, library matrix products, the
# integer elementwise glue (CRT digits and residues, limb exponents)
PROFILE_CLASSES = (
    ("port_kernels", "|".join(LIMB_KERNELS)),
    ("matmul", r"gemm|xmma|cutlass"),
    ("integer_glue", r"<(int|long)\b|\b(int|long)>|\((int|long)\)#"),
)
