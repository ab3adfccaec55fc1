"""Exact high-precision SYRK/GEMM through CRT residue arithmetic.

The PyTorch counterpart of the JAX package's ``ops/exact.py`` (the
redesign of the reference's ``bigint_syrk``): inputs |x| < 1 become
balanced base-256 digits, digits become residues mod ~13-bit primes,
per-prime products of the 7-bit-split residues run as integer matrix
products, and the CRT restores the result as balanced digit planes.

Every product here is an integer matrix product with all partial sums
below 2^31 < 2^53, so it runs as a float64 ``matmul`` of the int8
values: exact in any summation order, on the CPU and on the card.
Residues are reduced with integer ``remainder`` (the JAX code avoids
integer division, which the TPU lacks; the result in [0, p) is the
same).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..utils import timers

_span = timers.span("glue")

_BASE_BITS = 8
_BASE = 1 << _BASE_BITS


def _primes_in(lo: int, hi: int) -> list[int]:
    sieve = np.ones(hi, dtype=bool)
    sieve[:2] = False
    for i in range(2, int(hi ** 0.5) + 1):
        if sieve[i]:
            sieve[i * i:: i] = False
    return [int(p) for p in np.nonzero(sieve)[0] if p >= lo]


def _balance(v, p):
    half = p // 2
    return ((v + half) % p) - half


def _balanced_digits(w: int, n_planes: int) -> np.ndarray:
    out = np.zeros(n_planes, dtype=np.int64)
    ww = int(w)
    for t in range(n_planes):
        d = ((ww + _BASE // 2) % _BASE) - _BASE // 2
        out[t] = d
        ww = (ww - d) >> _BASE_BITS
    assert ww == 0, "out_planes too small for CRT weight"
    return out


@dataclasses.dataclass(eq=False)
class CrtPlan:
    """Static CRT configuration: ``bits`` of fixed-point precision per
    input, ``n_rows_max`` bound on the contraction length."""

    bits: int
    n_rows_max: int

    def __hash__(self):
        return hash((self.bits, self.n_rows_max))

    @functools.cached_property
    def n_digits(self) -> int:
        return self.bits // _BASE_BITS + 3

    @property
    def shift_bits(self) -> int:
        return _BASE_BITS * (self.n_digits - 1)

    @functools.cached_property
    def primes(self) -> np.ndarray:
        need = 2 * (self.n_digits * _BASE_BITS + 1) + \
            int(np.ceil(np.log2(max(2, self.n_rows_max)))) + 8
        primes, total = [], 0.0
        for p in _primes_in(4099, 8192):
            primes.append(p)
            total += np.log2(p)
            if total >= need:
                break
        else:
            raise ValueError("prime pool exhausted; raise the prime range")
        return np.array(primes, dtype=np.int64)

    @functools.cached_property
    def n_primes(self) -> int:
        return len(self.primes)

    @functools.cached_property
    def base_pow_mod(self) -> np.ndarray:
        """(n_digits, n_primes) balanced (256^t mod p)."""
        out = np.zeros((self.n_digits, self.n_primes), dtype=np.int64)
        for j, p in enumerate(self.primes):
            v = 1
            for t in range(self.n_digits):
                out[t, j] = v
                v = (v * _BASE) % int(p)
        return _balance(out, self.primes[None, :])

    @functools.cached_property
    def _M(self) -> int:
        m = 1
        for p in self.primes:
            m *= int(p)
        return m

    @functools.cached_property
    def out_planes(self) -> int:
        return self._M.bit_length() // _BASE_BITS + 3

    @functools.cached_property
    def crt_c(self) -> np.ndarray:
        M = self._M
        return np.array([pow((M // int(p)) % int(p), -1, int(p))
                         for p in self.primes], dtype=np.int64)

    @functools.cached_property
    def crt_weights(self) -> np.ndarray:
        """(n_primes, out_planes) balanced digits of W_i = c_i (M/p_i)."""
        M = self._M
        return np.stack([
            _balanced_digits(int(c) * (M // int(p)), self.out_planes)
            for c, p in zip(self.crt_c, self.primes)])

    @functools.cached_property
    def m_planes(self) -> np.ndarray:
        return _balanced_digits(self._M, self.out_planes)

    def tensors(self, device) -> dict:
        """Device copies of the plan's tables, cached per device."""
        key = str(device)
        cache = self.__dict__.setdefault("_tensors", {})
        if key not in cache:
            t = lambda a, dt: torch.as_tensor(np.asarray(a), dtype=dt,
                                              device=device)
            th, tl = _split7(t(self.base_pow_mod, torch.int32))
            p = self.primes
            cache[key] = {
                "p": t(p, torch.int32),
                "p_f": t(p, torch.float32),
                "table_h": th.to(torch.float64),
                "table_l": tl.to(torch.float64),
                "t14": t(np.int64(1 << 14) % p, torch.int32),
                "t7": t(np.int64(1 << 7) % p, torch.int32),
                "c": t(self.crt_c, torch.int32),
                "w": t(self.crt_weights, torch.float64),
                "m_planes": t(self.m_planes, torch.int32),
            }
        return cache[key]


def _imm(a, b):
    """Exact integer matrix product of small-integer tensors (|sums| <
    2^53) as a float64 matmul; int32 result."""
    return torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(
        torch.int32)


def _split7(v):
    """v = hi*128 + lo with lo balanced in [-64, 63] (int8 halves)."""
    lo = torch.bitwise_and(v + 64, 127) - 64
    hi = torch.bitwise_right_shift(v - lo, 7)
    return hi.to(torch.int8), lo.to(torch.int8)


def _mod(x, p):
    return torch.remainder(x, p)


@_span
def residues_split(digits, plan: CrtPlan):
    """Balanced 7-bit-split residues: digits (..., n_digits) -> (rh, rl)
    int8 of shape (..., n_primes) with r = 128*rh + rl (mod p, balanced).
    """
    tb = plan.tensors(digits.device)
    d = digits.to(torch.float64)
    sh = torch.matmul(d, tb["table_h"]).to(torch.int32)
    sl = torch.matmul(d, tb["table_l"]).to(torch.int32)
    p = tb["p"]
    r = _mod(sh * 128 + sl, p)
    rb = r - torch.where(r > p // 2, p, 0)
    return _split7(rb)


def _syrk_combine(s2, s1, s0, plan: CrtPlan):
    """q = 2^14 s2 + 2^7 s1 + s0 (mod p), prime axis leading."""
    tb = plan.tensors(s2.device)
    p3 = tb["p"][:, None, None]
    t14 = tb["t14"][:, None, None]
    t7 = tb["t7"][:, None, None]
    return _mod(_mod(s2, p3) * t14 + _mod(s1, p3) * t7 + _mod(s0, p3), p3)


def _batched_ata(a, b):
    """Per-prime a^T b: (..., n, ma, P) x (..., n, mb, P) ->
    (..., P, ma, mb)."""
    at = a.movedim(-1, -3).transpose(-1, -2).to(torch.float64)
    bt = b.movedim(-1, -3).to(torch.float64)
    return torch.matmul(at, bt).to(torch.int32)


@_span
def syrk_residues_split(r_split, plan: CrtPlan):
    """Per-prime exact A^T A from split residues (rh, rl) int8
    (..., n, m, n_primes) -> (..., n_primes, m, m) int32 in [0, p)
    (Karatsuba 3-product form)."""
    rh, rl = r_split
    s2 = _batched_ata(rh, rh)
    s0 = _batched_ata(rl, rl)
    rs = rh.to(torch.int32) + rl.to(torch.int32)
    s1 = _batched_ata(rs, rs) - s2 - s0
    return _syrk_combine(s2, s1, s0, plan)


@_span
def syrk_diag_residues_split(r_split, plan: CrtPlan):
    """Independently computed per-prime diagonal of A^T A:
    (rh, rl) (n, m, n_primes) -> (n_primes, m) int32 in [0, p)."""
    rh, rl = r_split
    h = rh.to(torch.int32)
    l = rl.to(torch.int32)
    s2 = (h * h).sum(dim=0, dtype=torch.int32)
    s0 = (l * l).sum(dim=0, dtype=torch.int32)
    s1 = (2 * h * l).sum(dim=0, dtype=torch.int32)
    p = plan.tensors(rh.device)["p"][None, :]
    q = _mod(s2, p) * (1 << 14) + _mod(s1, p) * (1 << 7) + _mod(s0, p)
    return _mod(q, p).movedim(0, 1)


@_span
def gemm_residues_split(a_split, b_split, plan: CrtPlan):
    """Per-prime exact A^T B: (ah, al) (..., n, ma, P), (bh, bl)
    (..., n, mb, P) -> (..., P, ma, mb) int32 in [0, p)."""
    ah, al = a_split
    bh, bl = b_split
    s2 = _batched_ata(ah, bh)
    s0 = _batched_ata(al, bl)
    asum = ah.to(torch.int32) + al.to(torch.int32)
    bsum = bh.to(torch.int32) + bl.to(torch.int32)
    s1 = _batched_ata(asum, bsum) - s2 - s0
    return _syrk_combine(s2, s1, s0, plan)


@_span
def crt_restore_planes(q_res, plan: CrtPlan, prime_axis: int = 0):
    """CRT-restore per-prime results q_res (int32 in [0, p), primes on
    ``prime_axis``) to balanced digit planes (..., out_planes) (two
    carry passes)."""
    tb = plan.tensors(q_res.device)
    r = q_res.movedim(prime_axis, -1)              # (..., P) in [0, p)
    rc = r * tb["c"]
    p = tb["p"]
    rc_div = torch.div(rc, p, rounding_mode="floor")
    rc_mod = rc - rc_div * p
    k_int = rc_div.sum(dim=-1, dtype=torch.int32)
    frac = (rc_mod.to(torch.float32) / tb["p_f"]).sum(dim=-1)
    k = k_int + torch.round(frac).to(torch.int32)
    rh, rl = _split7(r)
    w = tb["w"]
    planes = _imm(rh, w) * 128 + _imm(rl, w)
    planes = planes - k[..., None] * tb["m_planes"]
    for _ in range(2):
        d = torch.bitwise_and(planes + 128, 255) - 128
        cy = torch.bitwise_right_shift(planes - d, 8)
        planes = d + torch.nn.functional.pad(cy[..., :-1], (1, 0))
    return planes
