"""Device memory estimate and the fail-fast limit check of the port.

The reference predicts its per-node allocation before the solver runs
(`SDP_Solver/run/run.cxx:80-183`, `sdpb_util/memory_estimates.cxx`) so
that an oversized problem stops at startup with a per-component report
instead of dying mid-solve.  This module does the same for the port's
own buffers on one CUDA device:

- the MP arrays that live through an iteration (4 S bytes per limb
  value, 8 K per float64 expansion): problem data, the iterate and
  the next one, the Cholesky factors, pairings, residues, the Schur
  factors, L^-1 B, Q and its factor, and the search direction's
  matrices;
- the transient buffers of the largest exact product of the
  iteration.  Every CRT product (``ops/exact.py``, ``ops/mpmm.py``)
  turns each input value into D int32 base-256 digits, then into P
  residues through float64 matmuls of the digits, keeps them as int8
  halves, multiplies the halves as float64 matmuls, and restores each
  output value through O int32 digit planes (float64 matmuls of the
  residue halves by the CRT weights) and a renormalization.  The
  bytes per value of each stage below are read off that code: the
  tensors alive together at its widest point.  The largest products
  are L^-1 B (per bucket), the Q residues (per bucket), and the first
  trailing update of the blocked Q Cholesky;
- where expansion arithmetic runs its plain PyTorch versions (CPU
  tensors), the temporaries of the largest elementwise product, the Schur
  complement's terms: a plain expansion product keeps its partial
  products, their level-ordered copy and the two_sum chain's words
  alive together (on the card one kernel writes only its result).

``--maxSharedMemory`` caps the Q residue stage (the solver tiles it,
``bucket_iteration.q_block_chunk``); it is not a total limit.
"""

from __future__ import annotations

import dataclasses
import os
import re

import torch

from ..mp import core
from ..mp.linalg import _PANEL


class MemoryLimitError(RuntimeError):
    """Predicted device allocation exceeds the memory limit."""


def parse_bytes(text) -> int:
    """'100.1K' / '2G' / '1024' -> bytes (the reference's
    `String_To_Bytes_Translator.hxx`: a number and an optional
    B/K/M/G/T suffix, any case); 0 or empty means no value."""
    if isinstance(text, (int, float)):
        return int(text)
    s = str(text).strip()
    if not s:
        return 0
    m = re.fullmatch(r"([0-9]*\.?[0-9]+)\s*([bBkKmMgGtT]?)[bB]?", s)
    if not m:
        raise ValueError(f"cannot parse byte size: {text!r}")
    mult = {"": 1, "b": 1, "k": 2 ** 10, "m": 2 ** 20,
            "g": 2 ** 30, "t": 2 ** 40}[m.group(2).lower()]
    return int(float(m.group(1)) * mult)


def format_bytes(n: int) -> str:
    for unit, w in (("GB", 2 ** 30), ("MB", 2 ** 20), ("KB", 2 ** 10)):
        if n >= w:
            return f"{n / w:.2f} {unit}"
    return f"{n} B"


@dataclasses.dataclass
class MemoryEstimate:
    """Predicted device allocation by component (bytes).  Of the
    transient peaks of the iteration's products (``transients``), the
    largest is a component."""

    components: dict
    transients: dict = dataclasses.field(default_factory=dict)

    @property
    def total(self) -> int:
        return sum(self.components.values())

    def message(self, limit: int | None = None) -> str:
        """The reference-style allocation report
        (`print_allocation_message_per_node`)."""
        lines = ["Predicted device memory allocation:"]
        for name, b in sorted(self.components.items(),
                              key=lambda kv: -kv[1]):
            lines.append(f"  {name:<34} {format_bytes(b):>12}")
        lines.append(f"  {'total':<34} {format_bytes(self.total):>12}")
        if limit:
            lines.append(f"  {'limit':<34} {format_bytes(limit):>12}")
        return "\n".join(lines)


@dataclasses.dataclass
class ShapeBucket:
    nb: int
    shape: object      # solver.data.BlockShape


@dataclasses.dataclass
class ProblemShape:
    """What the estimate reads of a problem (a BucketedProblem has the
    same attributes): buckets with ``nb`` and ``shape``, the dual
    dimension, the slot count and the word dtype."""

    buckets: list
    dual_dim: int
    k: int
    dtype: torch.dtype = torch.float32

    @property
    def bucket_sizes(self) -> list:
        return [bk.nb for bk in self.buckets]


def shape_of_raw(raw, k: int, dtype=torch.float32) -> ProblemShape:
    """The bucket shapes of a RawSDP, before anything is on the device
    (the grouping of ``data.bucketed_problem_from_raw``)."""
    from .data import group_blocks

    return ProblemShape(
        buckets=[ShapeBucket(len(idxs), shape)
                 for shape, idxs in group_blocks(raw).items()],
        dual_dim=raw.dual_dim, k=k, dtype=core.torch_dtype(dtype))


def _plan(k: int, n_rows: int, dtype):
    from ..ops import mpmm

    return mpmm.plan_for(core.precision_bits_of(k, dtype), n_rows)


def crt_rows(shape) -> int:
    """The longest contraction of the solver's CRT products: Q's (the
    Schur rows of every block) or the dual dimension."""
    total = sum(bk.nb * bk.shape.schur_size for bk in shape.buckets)
    return max(total, int(shape.dual_dim), 1)


def max_crt_precision(words_for, dtype, n_rows: int) -> int:
    """The largest precision p whose CRT products the prime pool of
    ``ops/exact.py`` holds at contraction ``n_rows``, with
    ``words_for(p)`` words of ``dtype`` a value: the plan's modulus
    needs twice the input bits plus log2 of the rows, so the limit
    falls as the problem grows."""
    def holds(p):
        try:
            _plan(words_for(p), n_rows, dtype).primes
        except ValueError:
            return False
        return True

    lo, hi = 1, 1 << 16
    if holds(hi):
        return hi
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if holds(mid) else (lo, mid)
    return lo


def _stage_bytes(k: int, n_rows: int, dtype) -> dict:
    """Bytes per value at the widest point of each stage of one CRT
    product with contraction ``n_rows`` (ops/mpmm.py, ops/exact.py)."""
    plan = _plan(k, n_rows, dtype)
    D, P, O = plan.n_digits, plan.n_primes, plan.out_planes
    if core.torch_dtype(dtype) == torch.float64:
        # digits: the int64 shift amounts and shifted mantissas of one
        # word (8 D each, three of them) and the int32 accumulator;
        # restore: the kept words (a group of 5 planes each), their
        # stack, the two_sum chain's words and stack, the emit's slots
        n_keep = -(-O // 5)
        digits = 36 * D + 16
        renorm = 32 * n_keep + 40 * k
        item = 8 * k
    else:
        L = k - 1
        top = -(-(8 * O - 2 * plan.shift_bits) // 9)
        n_ext = L + 2 + max(0, top)
        digits = max(32 * (L + 1), 12 * L + 24 * D)
        renorm = 8 * n_ext + 32 * (n_ext + 2)
        item = 4 * k
    return {
        "P": P,
        # scaled input alive while its digits are made: the digit
        # accumulator and its shift temporaries, or the residue
        # matmuls (digits, their float64 copy, two P-wide products)
        "residues": item + max(digits, 12 * D + 16 * P),
        # the int8 residue halves of an input, kept for the product
        "halves": 2 * P,
        # per input value during the products: int32 sums of the halves
        # and their float64 copies (a SYRK copies its operand twice)
        "product_in": 4 * P + 8 * P,
        "syrk_in": 4 * P + 16 * P,
        # per output value: two int32 partial products, the float64
        # matmul result and its int32 copy
        "product_out": 4 * P + 4 * P + 8 * P + 4 * P,
        # per output value while restoring: the residues and the CRT
        # quotient temporaries (int32, P each), the int8 halves, one
        # float64 copy of them and the float64 and int32 planes (O each)
        # -- or, later, the planes and the renormalization
        "restore": max(18 * P + 8 * P + 16 * O, 4 * P + 12 * O + renorm),
    }


def _product_bytes(k, n_rows, n_a, n_b, n_out, dtype, syrk=False):
    """Transient peak of one CRT product of n_a- and n_b-value inputs
    (n_b = 0 for a SYRK) into n_out values."""
    st = _stage_bytes(k, n_rows, dtype)
    inputs = n_a + n_b
    return max(
        max(n_a, n_b) * st["residues"] + inputs * st["halves"],
        inputs * (st["halves"] + (st["syrk_in"] if syrk else
                                  st["product_in"]))
        + n_out * st["product_out"],
        n_out * (4 * st["P"] + st["restore"]))


def _plain_mul_bytes(k: int) -> int:
    """Bytes per value alive at once in a plain PyTorch expansion
    product: the two_prod grid and its splits (6 k^2 words), the
    concatenated and level-ordered terms (2 k^2 + T) and the two_sum
    chain's words and stack (2 T)."""
    terms = sum((i + j <= k) + (i + j + 1 <= k)
                for i in range(k) for j in range(k))
    return 8 * (8 * k * k + 3 * terms)


def q_distributed(n: int, n_devices: int) -> bool:
    """Whether the estimate counts Q as row panels (parallel/dist_q.py):
    from parallel/mesh.py's DIST_Q_MIN_N up, on several devices."""
    from ..parallel.mesh import DIST_Q_MIN_N

    return n_devices > 1 and n >= DIST_Q_MIN_N


def estimate_solver_memory(problem, q_bytes_cap: int | None = None,
                           plain: bool = False,
                           n_devices: int = 1) -> MemoryEstimate:
    """Predict the peak allocation of one interior-point iteration of
    the port on one device of ``n_devices``.

    ``problem`` needs only shapes (a BucketedProblem, or
    ``shape_of_raw``'s ProblemShape).  ``q_bytes_cap`` is the
    --maxSharedMemory cap on the Q residue stage; ``plain`` counts the
    plain elementwise route's temporaries (CPU tensors).  On several
    devices each bucket's blocks are divided over them, rounding up (the
    phantom padding of ``parallel.mesh.shard_problem``), and Q, L_Q and
    dy are replicated, or divided by rows where ``q_distributed``."""
    k = int(problem.k)
    n = int(problem.dual_dim)
    dt = core.torch_dtype(getattr(problem, "dtype", torch.float32))
    mp_item = (8 if dt == torch.float64 else 4) * k
    comp = {key: 0 for key in (
        "problem data (c,B,q,u)", "iterate x,X,Y,y and the next one",
        "Cholesky L_X,L_Y", "pairings A_X_inv,A_Y",
        "residues and step matrices", "Schur S, L_S, L_S^-1",
        "L^-1 B")}
    transients = {}
    total_rows = sum(bk.nb * bk.shape.schur_size for bk in problem.buckets)
    for bi, bk in enumerate(problem.buckets):
        nb, sh = -(-bk.nb // n_devices), bk.shape
        psd = sum(s * s for s in sh.psd_sizes)
        schur = sh.schur_size
        mp_pts = sh.m * sh.pts
        comp["problem data (c,B,q,u)"] += nb * mp_item * (
            schur + schur * n + sum(h * sh.pts for h in (sh.he, sh.ho))
            + sum(sh.m * h * mp_pts for h in (sh.he, sh.ho)))
        comp["iterate x,X,Y,y and the next one"] += \
            2 * nb * (2 * psd + schur) * mp_item
        comp["Cholesky L_X,L_Y"] += 2 * nb * psd * mp_item
        comp["pairings A_X_inv,A_Y"] += 2 * 2 * nb * mp_pts ** 2 * mp_item
        # primal and dual residues, -XY, R, Z, dX, dY and their
        # products, the dx vectors
        comp["residues and step matrices"] += \
            nb * (8 * psd + 4 * schur) * mp_item
        comp["Schur S, L_S, L_S^-1"] += 3 * nb * schur * schur * mp_item
        comp["L^-1 B"] += nb * schur * n * mp_item
        transients[f"CRT product L^-1 B (bucket {bi})"] = _product_bytes(
            k, schur, nb * schur * schur, nb * schur * n, nb * schur * n,
            dt)
        q_rows = nb * schur
        if q_bytes_cap:
            from .bucket_iteration import q_block_chunk

            q_rows = min(nb, q_block_chunk(problem, q_bytes_cap)) * schur
        transients[f"CRT residues of Q (bucket {bi})"] = _product_bytes(
            k, total_rows, q_rows * n, 0, n * n, dt, syrk=True)
        if plain and dt == torch.float64:
            terms = nb * (sh.n_tuples * sh.pts) ** 2
            transients[f"plain Schur complement terms (bucket {bi})"] = \
                terms * (_plain_mul_bytes(k) + 3 * mp_item)
    comp["iterate x,X,Y,y and the next one"] += 2 * n * mp_item
    q_own = -(-n // n_devices) if q_distributed(n, n_devices) else n
    comp["Q, L_Q, dy"] = (2 * q_own * n + 4 * n) * mp_item
    if n > 2 * _PANEL:
        trail = n - _PANEL
        rows = trail if q_own == n else q_own
        transients["CRT product Q Cholesky update"] = _product_bytes(
            k, _PANEL, trail * _PANEL, 0, rows * trail, dt, syrk=True)
    worst = max(transients, key=transients.get)
    comp[worst] = transients[worst]
    return MemoryEstimate(components=comp, transients=transients)


def intra_would_fit(problem, limit, n_devices: int) -> bool:
    """Would sharding every block's rows over ``n_devices``
    (parallel/intra_solver.py) bring the estimate under ``limit``?  The
    intra path divides the persistent block-sized tensors by the device
    count and keeps one full-size transient at a time: the one-device
    estimate over n_devices plus its largest component.  The sdpb CLI
    routes an over-limit problem there instead of exiting 1
    (`Block_Map.hxx:8-14`)."""
    limit = parse_bytes(limit) if limit else 0
    if not limit or n_devices < 2:
        return False
    est = estimate_solver_memory(problem)
    biggest = max(est.components.values()) if est.components else 0
    return est.total // n_devices + biggest <= limit


def detect_device_memory(device=None) -> int | None:
    """Free bytes on the CUDA device (``torch.cuda.mem_get_info``), or
    MemAvailable of /proc/meminfo for the CPU; None when unknown."""
    import torch

    device = torch.device(device) if device is not None else None
    if device is None or device.type == "cuda":
        if not torch.cuda.is_available():
            return None
        return int(torch.cuda.mem_get_info(device)[0])
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        return None
    return None


def check_memory_limit(problem, limit=None, device=None,
                       verbose: bool = False,
                       q_bytes_cap=None, n_devices: int = 1) -> MemoryEstimate:
    """Raise MemoryLimitError, with the per-component report, when the
    estimate for one of ``n_devices`` devices exceeds ``limit`` bytes.
    ``limit`` 0/None: the SDPB_TPU_DEVICE_MEMORY environment variable
    if set, else the device's free memory; no limit known -> no
    check."""
    plain = device is not None and torch.device(device).type == "cpu"
    est = estimate_solver_memory(problem,
                                 q_bytes_cap=parse_bytes(q_bytes_cap or 0),
                                 plain=plain, n_devices=n_devices)
    limit = parse_bytes(limit) if limit else 0
    if not limit:
        env = os.environ.get("SDPB_TPU_DEVICE_MEMORY")
        limit = parse_bytes(env) if env else \
            (detect_device_memory(device) or 0)
    if verbose:
        print(est.message(limit or None))
    if limit and est.total > limit:
        raise MemoryLimitError(
            f"predicted allocation {format_bytes(est.total)} exceeds the "
            f"limit {format_bytes(limit)}\n" + est.message(limit))
    return est
