"""Float64-expansion CUDA kernels for Hopper, their column loops' plain
PyTorch versions, and the build and loader.

``exp_add``, ``exp_mul``, ``exp_div``, ``exp_add_f64`` and
``exp_mul_f64`` run one expansion operation per launch
(``csrc/expansion_elementwise.cu`` over ``csrc/expansion_elementwise.cuh``),
where the JAX package leaves the expansion arithmetic of
``sdpb_tpu/mp/core.py`` to XLA fusions, in one of two designs: a value
a thread, its words in registers (``csrc/expansion_regs.cuh``), for
batches that fill the card at K <= THREAD_MAX_WORDS; a value a warp
(``csrc/expansion_warp.cuh``) for smaller batches (at most
WARP_MAX_VALUES values) and for every batch above THREAD_MAX_WORDS,
up to MAX_WORDS, the CRT prime pool's limit.  Their plain PyTorch
versions are ``mp/core.py``'s ``add_plain`` ... ``mul_f64_plain``.

``exp_cholesky_panel`` and ``exp_solve_unblocked`` run a whole column
loop of the expansion Cholesky and of the triangular substitution per
launch (``csrc/expansion_chol.cu``, ``csrc/expansion_solve.cu`` over
``csrc/expansion_panels.cuh``: a Cholesky's pivots on a warp of their
own ahead of the update; up to THREAD_MAX_WORDS the rest a value per
thread; above it every operation on a warp, a step's operations spread
over the warps of a thread-block cluster: chol_cluster_blocks and
solve_column_warps), where the JAX package's ``fori_loop``s are one XLA
program.  Their plain versions, ``cholesky_panel_plain`` and
``solve_unblocked_plain``, are the loops over the elementwise
operations.

Each unit is compiled with ``nvcc`` at first use (``-DEXP_K``): once for
every K in 1..THREAD_MAX_WORDS, all at once and linked into one shared
library, and once for each K above that when that K is first used, into
a library of its own; all under ``csrc/build/``, keyed by sources and
flags, and called through ``ctypes``; no PyTorch header is involved.

Each wrapper takes the plain version for tensors on the CPU and launches
its kernel for tensors on a CUDA device; it never falls back from one
to the other.  ``LAUNCHES`` counts kernel launches per wrapper and
design (``exp_mul`` a value a thread, ``exp_mul_warp`` a value a warp;
``exp_cholesky_panel_warp`` and ``exp_solve_unblocked_warp`` the column
loops above THREAD_MAX_WORDS).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
import time
from pathlib import Path

import torch

from ..mp import core
from .limb_kernels import BUILD_DIR, CSRC, NVCC_FLAGS, _nvcc, _status
from ..utils import timers

_span = timers.span("expansion_kernels")

SOURCES = ("expansion.cuh", "expansion_regs.cuh", "expansion_warp.cuh",
           "expansion_panels.cuh", "expansion_elementwise.cuh",
           "expansion_elementwise.cu", "expansion_chol.cu",
           "expansion_solve.cu")
# Each unit is compiled once per K (-DEXP_K); the elementwise unit's
# K = 1 object also carries the library's entry points.
UNITS = ("expansion_elementwise.cu", "expansion_chol.cu",
         "expansion_solve.cu")
# csrc/expansion.cuh kMaxWords: the largest K the kernels take, that of
# the CRT prime pool's limit (--precision 2862: solver/memory.py
# max_crt_precision); and kThreadMaxWords, the largest K whose operations
# run a value a thread, in registers (--precision 1060).
MAX_WORDS = 54
THREAD_MAX_WORDS = 20
# csrc/expansion_elementwise.cu kThreads and kWarps: threads a block of
# the value-a-thread design, warps a block of the value-a-warp design.
EXPANSION_THREADS = 128
EXPANSION_WARPS = 4
# The elementwise design: a value a warp for batches of at most this
# many values (and for K > THREAD_MAX_WORDS), a value a thread above
# (K >= 3; K = 1, 2 a thread always).  Chosen from chip_smoke.py phase
# 3's times of both designs at the batches the solver launches (phase
# 8b/8d's histogram of n per operation; PERF.md).
WARP_MAX_VALUES = 1024
# Blocks of an elementwise launch at most: the grid-stride loop takes
# the rest.
EXPANSION_MAX_BLOCKS = 8192
# The column-loop kernels (csrc/expansion_chol.cu, expansion_solve.cu):
# a Cholesky block's rows (its threads, 128, but the pivot warp: one
# update thread a row, so W + rows below it <= CHOL_MAX_ROWS), and the
# rows below the pivot block a block takes at most.
CHOL_MAX_ROWS = 96
CHOL_ROW_TILE = 32
# Above this many groups of G lanes that hold one leaf each, a solve
# packs two leaves a lane (half the lanes a column): the columns then
# fill the card, and a row costs a warp two products for twice the
# columns.
SOLVE_LATENCY_GROUPS = 1024
# Above THREAD_MAX_WORDS (csrc/expansion_solve.cu kWarps, and
# kMaxCluster of both column loops): warps a block of the solve, and
# blocks a thread-block cluster at most.
SOLVE_BLOCK_WARPS = 4
CLUSTER_MAX_BLOCKS = 8

_OPS = {"exp_add": 0, "exp_mul": 1, "exp_div": 2, "exp_add_f64": 3,
        "exp_mul_f64": 4}
LAUNCHES = {name: 0 for op in _OPS for name in (op, op + "_warp")}
LAUNCHES.update({name: 0 for loop in ("exp_cholesky_panel",
                                      "exp_solve_unblocked")
                 for name in (loop, loop + "_warp")})

# {None: the K <= THREAD_MAX_WORDS library, k: the library of K = k}
_LIB = {}


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def max_precision_bits() -> int:
    """The largest --precision whose expansions the kernels hold (at
    least the CRT prime pool's limit)."""
    return core.WORD_BITS * MAX_WORDS


def check_words(name: str, k: int) -> None:
    if not 1 <= k <= MAX_WORDS:
        raise ValueError(
            f"{name}: K={k} float64 words exceeds the CUDA expansion "
            f"kernels' limit of {MAX_WORDS} (--precision "
            f"{max_precision_bits()})")


def elementwise_design(n: int, k: int) -> str:
    """"thread" (a value a thread) or "warp" (a value a warp) for n
    values of K words."""
    if k > THREAD_MAX_WORDS or (k >= 3 and n <= WARP_MAX_VALUES):
        return "warp"
    return "thread"


def _library_path(k: int | None = None) -> Path:
    """The library of K = 1..THREAD_MAX_WORDS (k None), or of one K
    above."""
    digest = hashlib.sha256()
    for name in SOURCES:
        digest.update((CSRC / name).read_bytes())
    digest.update(" ".join(NVCC_FLAGS + [str(MAX_WORDS),
                                         str(THREAD_MAX_WORDS)]).encode())
    tag = "" if k is None else f"k{k}_"
    return BUILD_DIR / (f"libexpansion_kernels_{tag}"
                        f"{digest.hexdigest()[:16]}.so")


@timers.span("build", "expansion_kernels.build")
def build(force: bool = False, k: int | None = None) -> dict:
    """Compile the units into ``csrc/build/`` unless a library built from
    the same sources and flags exists: for k None every K in
    1..THREAD_MAX_WORDS, else the one K = k above it; one ``nvcc -c`` per
    unit and K, all started together, then one link.  Returns the build
    record (seconds, the ``-Xptxas -v`` resource lines, the library
    path)."""
    if k is not None and not THREAD_MAX_WORDS < k <= MAX_WORDS:
        raise ValueError(f"no library of its own for K={k}")
    lib = _library_path(k)
    if lib.exists() and not force:
        return {"library": str(lib), "seconds": 0.0, "ptxas": [],
                "cached": True}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    pid = os.getpid()
    t0 = time.time()
    words = range(1, THREAD_MAX_WORDS + 1) if k is None else (k,)
    jobs = []
    for unit in UNITS:
        for kk in words:
            obj = BUILD_DIR / f"{Path(unit).stem}_k{kk}.{pid}.o"
            extra = [f"-DEXP_K={kk}"] + (
                ["-DEXP_CLASS_ENTRIES"] if kk == 1 and unit == UNITS[0]
                else [])
            cmd = [_nvcc(), *NVCC_FLAGS, *extra, "-Xptxas", "-v", "-c",
                   "-o", str(obj), str(CSRC / unit)]
            jobs.append((obj, cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
    failure, lines = None, []
    for obj, cmd, proc in jobs:
        stdout, err = proc.communicate()
        if proc.returncode != 0 and failure is None:
            failure = (f"nvcc failed ({proc.returncode}) building the "
                       f"expansion kernels:\n{' '.join(cmd)}\n{stdout}\n"
                       f"{err}")
        lines += [ln.strip() for ln in err.splitlines()
                  if re.search(r"registers|spill|Compiling entry|"
                               r"Function properties|stack frame", ln)]
    if failure is not None:
        for obj, _, _ in jobs:
            obj.unlink(missing_ok=True)
        raise RuntimeError(failure)
    tmp = lib.with_suffix(f".{pid}.tmp")
    cmd = [_nvcc(), "-shared", "-o", str(tmp),
           *(str(obj) for obj, _, _ in jobs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    for obj, _, _ in jobs:
        obj.unlink(missing_ok=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)
    timers.count("builds", "expansion_kernels.build")
    return {"library": str(lib), "seconds": time.time() - t0,
            "ptxas": lines, "cached": False}


def _bind(lib, k: int) -> None:
    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
    entries = [("expansion_launch", [vp, cl, vp, cl, vp, cl, ci, ci, ci,
                                     vp])]
    if k <= THREAD_MAX_WORDS:
        entries += [("expansion_chol", [vp, vp, vp, ci, ci, ci, ci, ci, vp]),
                    ("expansion_solve", [vp, vp, vp, vp, ci, ci, ci, ci, ci,
                                         vp])]
    else:
        entries += [("expansion_chol_warps", [vp, vp, vp, vp, ci, ci, ci, ci,
                                              ci, ci, vp]),
                    ("expansion_chol_warps_clusters", [ci]),
                    ("expansion_solve_warps", [vp, vp, vp, vp, vp, ci, ci,
                                               ci, ci, ci, vp]),
                    ("expansion_solve_warps_clusters", [ci])]
    for name, args in entries:
        fn = getattr(lib, f"{name}_k{k}")
        fn.argtypes = args
        fn.restype = ci


def _lib(k: int):
    """The loaded library that holds K = k, built at first use."""
    key = None if k <= THREAD_MAX_WORDS else k
    if key in _LIB:
        return _LIB[key]
    return _load(key)


@timers.span("build", "expansion_kernels.load")
def _load(key: int | None):
    timers.count("loads", "expansion_kernels.load")
    lib = ctypes.CDLL(build(k=key)["library"])
    if key is None:
        for kk in range(1, THREAD_MAX_WORDS + 1):
            _bind(lib, kk)
        names = ("expansion_max_words", "expansion_thread_max_words",
                 "expansion_threads", "expansion_warps")
        for name in names:
            getattr(lib, name).restype = ctypes.c_int
        if tuple(getattr(lib, name)() for name in names) != (
                MAX_WORDS, THREAD_MAX_WORDS, EXPANSION_THREADS,
                EXPANSION_WARPS):
            raise RuntimeError("expansion kernel library disagrees on its "
                               "word limits or block sizes")
    else:
        _bind(lib, key)
    _LIB[key] = lib
    return lib


def _operand(x, batch, width: int):
    """(tensor, stride) of one operand: a single value broadcast over the
    batch (every batch axis of size 1 or stride 0) is read in place with
    batch stride 0; any other operand is broadcast to ``batch`` and made
    contiguous (stride ``width``)."""
    lead = x.dim() - (0 if width == 1 else 1)
    if all(d == 1 or s == 0
           for d, s in zip(x.shape[:lead], x.stride()[:lead])):
        return x[(0,) * lead].reshape(width).contiguous(), 0
    tail = () if width == 1 else (width,)
    return x.expand(batch + tail).contiguous(), width


def _launch(name, a, b, batch, k, b_width, design):
    out = torch.empty(batch + (k,), dtype=torch.float64, device=a.device)
    n = out.numel() // k
    if n == 0:
        return out
    design = design or elementwise_design(n, k)
    if design not in ("thread", "warp") or (
            design == "warp" and k < 3) or (
            design == "thread" and k > THREAD_MAX_WORDS):
        raise ValueError(f"{name}: no {design!r} design at K={k}")
    (a, sa), (b, sb) = _operand(a, batch, k), _operand(b, batch, b_width)
    per_block = EXPANSION_WARPS if design == "warp" else EXPANSION_THREADS
    blocks = min(EXPANSION_MAX_BLOCKS, max(1, -(-n // per_block)))
    err = getattr(_lib(k), f"expansion_launch_k{k}")(
        a.data_ptr(), sa, b.data_ptr(), sb, out.data_ptr(), n,
        _OPS[name], int(design == "warp"), blocks,
        torch.cuda.current_stream(out.device).cuda_stream)
    key = name + ("_warp" if design == "warp" else "")
    _status(key, err)
    LAUNCHES[key] += 1
    return out


def _on_cuda(name, *tensors):
    """Check dtype and device agreement; True for CUDA tensors, False
    for CPU ones, and raise for any other device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on different devices")
        if t.dtype != torch.float64:
            raise TypeError(f"{name}: expansion tensors must be float64")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev.type == "cuda"


def _binary(name, a, b, plain, design):
    if not _on_cuda(name, a, b):
        return plain(a, b)
    k = a.shape[-1]
    if b.shape[-1] != k:
        raise ValueError(f"{name}: word counts {k} != {b.shape[-1]}")
    check_words(name, k)
    batch = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    return _launch(name, a, b, batch, k, k, design)


def _with_float(name, a, x, plain, design):
    x = core._scalar_operand(a, x)
    if not _on_cuda(name, a, x):
        return plain(a, x)
    k = a.shape[-1]
    check_words(name, k)
    return _launch(name, a, x, a.shape[:-1], k, 1, design)


# ``design`` ("thread" or "warp") overrides elementwise_design on the card,
# for the comparison of the two designs (chip_smoke.py phase 3).

@_span
def exp_add(a, b, design=None):
    """a + b (float64 expansions, broadcasting over the batch axes)."""
    return _binary("exp_add", a, b, core.add_plain, design)


@_span
def exp_mul(a, b, design=None):
    """a * b, truncated (float64 expansions, broadcasting)."""
    return _binary("exp_mul", a, b, core.mul_plain, design)


@_span
def exp_div(a, b, design=None):
    """a / b by long division (float64 expansions, broadcasting)."""
    return _binary("exp_div", a, b, core.div_plain, design)


@_span
def exp_add_f64(a, x, design=None):
    """a + x for a float64 tensor x over a's batch axes."""
    return _with_float("exp_add_f64", a, x, core.add_f64_plain, design)


@_span
def exp_mul_f64(a, x, design=None):
    """a * x for a float64 tensor x over a's batch axes."""
    return _with_float("exp_mul_f64", a, x, core.mul_f64_plain, design)


# ---------------------------------------------------------------------------
# The column loops: a whole Cholesky panel, a whole substitution per launch
# ---------------------------------------------------------------------------

def cholesky_panel_plain(c):
    """Plain PyTorch version of ``exp_cholesky_panel``: the column loop
    of a Cholesky panel c (BB, R, W, K), R >= W, whose first W rows are
    the pivot block (the JAX package's ``col_step``; with R == W the
    unblocked right-looking Cholesky).  Per column t: the pivot's
    sqrt_rsqrt, the column below it times the pivot's rsqrt, and the
    rank-1 update added under the mask of columns > t.  The pivot
    block's upper triangle comes out +0: the blocked Cholesky reads
    only the lower one.  A non-PD input gives NaNs."""
    BB, R, W, k = c.shape
    rows = torch.arange(R, device=c.device)
    cidx = torch.arange(W, device=c.device)
    C = c.clone()
    for t in range(W):
        d, dinv = core.sqrt_rsqrt(C[:, t, t])
        col = core.mul(C[:, :, t], dinv[:, None, :])
        col = torch.where((rows > t)[:, None], col,
                          torch.where((rows == t)[:, None], d[:, None, :],
                                      0.0))
        C[:, :, t] = col
        upd = core.mul(col[:, :, None, :], col[:, None, :W, :])
        C = core.add(C, torch.where((cidx > t)[None, :, None], -upd, 0.0))
    upper = (rows[:W, None] < cidx[None, :])[:, :, None]
    C[:, :W] = torch.where(upper, 0.0, C[:, :W])
    return C


def solve_unblocked_plain(l, b, inv_d, transpose: bool = False):
    """Plain PyTorch version of ``exp_solve_unblocked``: X = L^-1 B (or
    L^-T B) by substitution, l (BB, n, n, K), b (BB, n, m, K), inv_d
    (BB, n, K), one row a step: the row's products with the rows found
    so far (the masked ones +0), their tree sum, subtracted from B's
    row, times the diagonal reciprocal."""
    n = b.shape[1]
    rows = torch.arange(n, device=b.device)
    x = torch.zeros_like(b)
    for t in range(n):
        i = n - 1 - t if transpose else t
        if transpose:
            li = torch.where((rows > i)[:, None], l[:, :, i, :], 0.0)
        else:
            li = torch.where((rows < i)[:, None], l[:, i, :, :], 0.0)
        acc = core.sum_(core.mul(li[:, :, None, :], x), axis=1)
        s = core.sub(b[:, i], acc)
        x[:, i] = core.mul(s, inv_d[:, i, None, :])
    return x


def chol_row_tile(W: int) -> int:
    """Rows below the pivot block a Cholesky block takes: at most
    CHOL_ROW_TILE, and W + tile <= CHOL_MAX_ROWS (one update thread a
    row)."""
    return max(1, min(CHOL_ROW_TILE, CHOL_MAX_ROWS - W))


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def chol_cluster_blocks(units: int, clusters) -> int:
    """Blocks P of a Cholesky cluster above THREAD_MAX_WORDS for
    ``units`` panels and row tiles (a cluster each): the largest power of
    two up to CLUSTER_MAX_BLOCKS with which all of them run at once
    (``clusters[P]``: clusters of P blocks the card holds, _clusters), at
    least 1."""
    p = 1
    while p < CLUSTER_MAX_BLOCKS and units <= clusters[2 * p]:
        p *= 2
    return p


_CLUSTERS = {}


def _clusters(kernel: str, k: int) -> dict:
    """{P: clusters of P blocks of the ``kernel`` ("chol" or "solve")
    above THREAD_MAX_WORDS that the card holds at once at K = k}, P = 1
    .. CLUSTER_MAX_BLOCKS."""
    if (kernel, k) not in _CLUSTERS:
        fn = getattr(_lib(k), f"expansion_{kernel}_warps_clusters_k{k}")
        out = {p: fn(p) for p in range(1, CLUSTER_MAX_BLOCKS + 1)}
        if min(out.values()) < 0:
            raise RuntimeError(f"expansion {kernel} kernel: occupancy "
                               f"query failed at K={k}: {out}")
        _CLUSTERS[kernel, k] = out
    return _CLUSTERS[kernel, k]


@_span
def exp_cholesky_panel(c):
    """The column loop of a Cholesky panel c (BB, R, W, K) in one launch
    (``cholesky_panel_plain`` on the CPU): one block per batch element
    and tile of chol_row_tile(W) rows below the pivot block (above
    THREAD_MAX_WORDS one cluster of chol_cluster_blocks blocks); on the
    card W < CHOL_MAX_ROWS (the port's panels are 32 wide, its unblocked
    factors at most 64)."""
    if not _on_cuda("exp_cholesky_panel", c):
        return cholesky_panel_plain(c)
    BB, R, W, k = c.shape
    if R < W:
        raise ValueError(f"exp_cholesky_panel: {R} rows < {W} columns")
    if R > W and W >= CHOL_MAX_ROWS or W > CHOL_MAX_ROWS:
        raise ValueError(f"exp_cholesky_panel: {W} columns exceed the "
                         f"kernel's {CHOL_MAX_ROWS} rows a block")
    check_words("exp_cholesky_panel", k)
    c = c.contiguous()
    out = torch.empty_like(c)
    if out.numel() == 0:
        return out
    rt = chol_row_tile(W)
    tiles = max(1, -(-(R - W) // rt))
    # the private pivot blocks of every block (cluster) but a panel's first
    scratch = torch.empty(((tiles - 1) * BB, W, W, k), dtype=c.dtype,
                          device=c.device)
    stream = torch.cuda.current_stream(c.device).cuda_stream
    if k > THREAD_MAX_WORDS:
        # each cluster's multipliers, final words and pivots
        rows = W + (rt if R > W else 0)
        share = torch.empty((BB * tiles, 2 * rows + 4, k), dtype=c.dtype,
                            device=c.device)
        err = getattr(_lib(k), f"expansion_chol_warps_k{k}")(
            c.data_ptr(), out.data_ptr(),
            scratch.data_ptr() if tiles > 1 else None, share.data_ptr(), BB,
            R, W, tiles, rt, chol_cluster_blocks(BB * tiles,
                                                 _clusters("chol", k)),
            stream)
        key = "exp_cholesky_panel_warp"
    else:
        err = getattr(_lib(k), f"expansion_chol_k{k}")(
            c.data_ptr(), out.data_ptr(),
            scratch.data_ptr() if tiles > 1 else None, BB, R, W, tiles, rt,
            stream)
        key = "exp_cholesky_panel"
    _status(key, err)
    LAUNCHES[key] += 1
    return out


def solve_lanes(bb: int, n: int, m: int) -> int:
    """Lanes G of a solve's group (one right-hand-side column; a power of
    two, n <= 2G <= 64): one leaf of the row's tree a lane (G >= n, G <=
    32) while the columns are few, so that a row costs one product;
    else two a lane (G >= n / 2), twice the columns a warp."""
    one = 1 << max(0, (n - 1).bit_length())
    two = 1 << max(0, (-(-n // 2) - 1).bit_length())
    if one <= 32 and bb * m <= SOLVE_LATENCY_GROUPS:
        return one
    return max(two, 1)


def solve_row_products(n: int, wc: int) -> int:
    """Dependent products a row of an n-row solve costs with wc warps a
    column (csrc/expansion_panels.cuh solve_column_warps): with a root
    warp that holds no terms, the later of x and one term, then term
    i' and the rest of its leaf warp's; else x, then the root's own
    terms."""
    if wc == 1:
        return n + 1
    leaf = -(-n // (wc - 1))
    if leaf <= 1 + -(-n // wc):
        return max(2, leaf)
    return 1 + max(1, -(-n // wc))


def solve_cluster_blocks(wc: int) -> int:
    """Blocks of a solve's cluster for wc warps a column."""
    return -(-wc // SOLVE_BLOCK_WARPS)


def solve_column_warps(bb: int, n: int, m: int, sms: int, clusters) -> int:
    """Warps wc of a column of a solve above THREAD_MAX_WORDS (at most
    SOLVE_BLOCK_WARPS * CLUSTER_MAX_BLOCKS): of those with which the bb
    * m columns' clusters all run at once (``clusters[P]``: clusters of P
    blocks the card holds, _clusters) and, where a column takes several
    blocks, their warps take at most 16 on each of the ``sms`` SMs
    (beyond, the warps' contention costs more than the spread saves:
    chip_smoke.py phase 3's sweep), the one whose row costs the fewest
    dependent products (solve_row_products), then the fewest warps; 1 (a
    warp a column) where the columns alone fill the card."""
    best, cols = (n + 1, 1), bb * m
    for wc in range(2, SOLVE_BLOCK_WARPS * CLUSTER_MAX_BLOCKS + 1):
        p = solve_cluster_blocks(wc)
        need = -(-cols // (p * SOLVE_BLOCK_WARPS // wc))
        if need > clusters[p] or (
                p > 1 and need * p * SOLVE_BLOCK_WARPS > 16 * sms):
            continue
        best = min(best, (solve_row_products(n, wc), wc))
    return best[1]


def _solve_spread(bb, n, m, k, device) -> int:
    return solve_column_warps(bb, n, m, _sms(device), _clusters("solve", k))


@_span
def exp_solve_unblocked(l, b, inv_d, transpose: bool = False):
    """X = L^-1 B (or L^-T B) by substitution in one launch
    (``solve_unblocked_plain`` on the CPU): l (BB, n, n, K) lower, b
    (BB, n, m, K), inv_d (BB, n, K) the diagonal's reciprocals; on the
    card n <= 64 (the port's unblocked solves and panels)."""
    if not _on_cuda("exp_solve_unblocked", l, b, inv_d):
        return solve_unblocked_plain(l, b, inv_d, transpose)
    BB, n, m, k = b.shape
    if k > THREAD_MAX_WORDS:
        return solve_warps(l, b, inv_d, transpose)
    l, b, inv_d, out = _solve_operands(l, b, inv_d)
    if out.numel() == 0:
        return out
    err = getattr(_lib(k), f"expansion_solve_k{k}")(
        l.data_ptr(), b.data_ptr(), inv_d.data_ptr(), out.data_ptr(),
        BB, n, m, solve_lanes(BB, n, m), int(transpose),
        torch.cuda.current_stream(b.device).cuda_stream)
    _status("exp_solve_unblocked", err)
    LAUNCHES["exp_solve_unblocked"] += 1
    return out


def _solve_operands(l, b, inv_d):
    """The checked, contiguous operands of a solve on the card, and its
    output."""
    BB, n, m, k = b.shape
    if l.shape != (BB, n, n, k) or inv_d.shape != (BB, n, k):
        raise ValueError(f"exp_solve_unblocked: shapes {tuple(l.shape)}, "
                         f"{tuple(b.shape)}, {tuple(inv_d.shape)}")
    if n > 64:
        raise ValueError(f"exp_solve_unblocked: {n} rows exceed the "
                         f"kernel's 64")
    check_words("exp_solve_unblocked", k)
    l, b, inv_d = l.contiguous(), b.contiguous(), inv_d.contiguous()
    return l, b, inv_d, torch.empty_like(b)


@_span
def solve_warps(l, b, inv_d, transpose: bool, wc: int | None = None):
    """exp_solve_unblocked on the card above THREAD_MAX_WORDS with wc
    warps a column (up to SOLVE_BLOCK_WARPS * CLUSTER_MAX_BLOCKS; None:
    solve_column_warps's choice; chip_smoke.py times the others against
    it)."""
    if not _on_cuda("exp_solve_unblocked", l, b, inv_d):
        raise ValueError("solve_warps: a launch on the card")
    l, b, inv_d, out = _solve_operands(l, b, inv_d)
    BB, n, m, k = b.shape
    if k <= THREAD_MAX_WORDS:
        raise ValueError(f"solve_warps: K={k} runs a value a thread")
    if out.numel() == 0:
        return out
    if wc is None:
        wc = _solve_spread(BB, n, m, k, b.device)
    # each column's terms of two rows (one for wc = 1) in a scratch of
    # its own
    tree = torch.empty((BB, m, (2 if wc > 1 else 1) * n, k), dtype=b.dtype,
                       device=b.device)
    err = getattr(_lib(k), f"expansion_solve_warps_k{k}")(
        l.data_ptr(), b.data_ptr(), inv_d.data_ptr(), out.data_ptr(),
        tree.data_ptr(), BB, n, m, wc, int(transpose),
        torch.cuda.current_stream(b.device).cuda_stream)
    _status("exp_solve_unblocked_warp", err)
    LAUNCHES["exp_solve_unblocked_warp"] += 1
    return out
