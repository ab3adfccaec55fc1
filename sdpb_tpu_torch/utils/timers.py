"""The port's tracer: hierarchical scoped timers, verbosity, and the
layer spans and counters recorded inside the program.

Host-side equivalent of the reference's tracing/profiling subsystem
(`src/sdpb_util/Timers/Timers.hxx:23-96`, `Verbosity.hxx:10-16`):
- Timers keeps an ordered list of (dotted name, start, stop) entries in
  seconds; `timers.scoped(...)` builds prefixes like
  `sdpb.solve.run.iter_3.step`
- write_profile() emits the same `{"name", elapsed}` list the
  reference writes to ck.profiling/profiling.<rank>

Layer spans are the second record kind: ``span`` (a decorator) and
``scope`` (a block) mark the layer boundaries of the solve (``phases``,
``linalg``, ``panels``: a panel step of a blocked factorization or
substitution, ``glue``, ``limb_kernels``, ``expansion_kernels``,
``build``), and ``count`` counts events by kind and site (``syncs``:
the host waiting on a device value; ``panels`` by routine; ``builds``
and ``loads`` of kernel libraries).  They are off by default; off, a
site costs one module global read and a direct call.  On, a span appends
[layer, name, start_ns, stop_ns, parent] to an in-memory list (parent:
the index of the innermost span open at its start, -1 for none), and
``take`` hands the records and counts over.  ``layer_spans`` switches
them: True or False for good, None (the default) to follow
torch.profiler, which the solver's driver looks at as each iteration
starts (``at_iteration``), so that a profiled iteration carries its
layer spans.  Both clocks are ``time.perf_counter`` (CLOCK_MONOTONIC on
Linux), the clock a device trace is tied to.  One thread records.
"""

from __future__ import annotations

import contextlib
import enum
import functools
import time
from pathlib import Path

_now = time.perf_counter_ns


class Verbosity(enum.IntEnum):
    """`sdpb_util/Verbosity.hxx:10-16`."""

    none = 0
    regular = 1
    debug = 2
    trace = 3


class Timers:
    """Ordered hierarchical timer registry, and the sums of the layer
    spans handed to it."""

    def __init__(self, verbosity: Verbosity = Verbosity.regular):
        self.named: list = []          # [(name, start_s, stop_s|None)]
        self.prefix = ""
        self.verbosity = Verbosity(verbosity)
        self.layer_ns: dict = {}       # {span path: summed ns}

    @contextlib.contextmanager
    def scoped(self, name: str):
        full = self.prefix + name
        old_prefix = self.prefix
        self.prefix = full + "."
        entry = [full, time.perf_counter(), None]
        self.named.append(entry)
        try:
            yield entry
        finally:
            entry[2] = time.perf_counter()
            self.prefix = old_prefix

    def add_layer_spans(self, records) -> None:
        """Sum ``records`` (from ``take``) per distinct span path, the
        names from the outermost span down joined by '/'."""
        paths = []
        for layer, name, start, stop, parent in records:
            path = name if parent < 0 else paths[parent] + "/" + name
            paths.append(path)
            self.layer_ns[path] = self.layer_ns.get(path, 0) + stop - start

    def write_profile(self, path) -> None:
        """`Timers::write_profile` format: `{"name", elapsed_ms}` lines,
        then one `layers/<span path>` line a distinct path."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        now = time.perf_counter()
        rows = [(full, int(((stop if stop is not None else now) - start)
                           * 1000))
                for full, start, stop in self.named]
        rows += [(f"layers/{p}", ns // 1_000_000)
                 for p, ns in self.layer_ns.items()]
        lines = ["{"]
        for i, (name, ms) in enumerate(rows):
            comma = "," if i + 1 < len(rows) else ""
            lines.append(f'    {{"{name}", {ms}}}{comma}')
        lines.append("}")
        path.write_text("\n".join(lines) + "\n")


# ---------------------------------------------------------------------------
# Layer spans and counters
# ---------------------------------------------------------------------------

_on = False                 # read by every span and counter site
_setting = None             # True / False for good; None: follow the profiler
_records: list = []         # [layer, name, start_ns, stop_ns, parent]
_open: list = []            # indices in _records of the open spans
_counts: dict = {}          # {(kind, site): n}


def _profiler_running() -> bool:
    import torch

    return torch.autograd._profiler_enabled()


def layer_spans(on: bool | None) -> bool | None:
    """Record layer spans and counts (True), never (False), or while
    torch.profiler runs (None); returns the previous setting."""
    global _on, _setting
    old, _setting = _setting, on
    _on = _profiler_running() if on is None else bool(on)
    return old


def at_iteration() -> None:
    """The driver's call as each iteration starts: under the setting
    None, layer spans follow torch.profiler."""
    global _on
    if _setting is None:
        _on = _profiler_running()


def take() -> tuple:
    """(records, counts) recorded so far, as tuples and a dict; the
    tracer starts afresh.  Called where no span is open."""
    global _records, _counts
    if _open:
        raise RuntimeError("layer spans taken inside an open span")
    out = [tuple(r) for r in _records], dict(_counts)
    _records, _counts = [], {}
    return out


def _begin(layer: str, name: str) -> list:
    rec = [layer, name, 0, 0, _open[-1] if _open else -1]
    _open.append(len(_records))
    _records.append(rec)
    rec[2] = _now()
    return rec


def _end(rec: list) -> None:
    rec[3] = _now()
    _open.pop()


def span(layer: str, name: str | None = None):
    """Decorator: each call of the function is a span of ``layer``
    named ``name`` (default: the function's name)."""
    def wrap(fn):
        label = name or fn.__name__

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            if not _on:
                return fn(*args, **kwargs)
            rec = _begin(layer, label)
            try:
                return fn(*args, **kwargs)
            finally:
                _end(rec)
        return spanned
    return wrap


class _Scope:
    __slots__ = ("layer", "name", "rec")

    def __init__(self, layer, name):
        self.layer, self.name = layer, name

    def __enter__(self):
        self.rec = _begin(self.layer, self.name)

    def __exit__(self, *exc):
        _end(self.rec)


_OFF = contextlib.nullcontext()


def scope(layer: str, name: str):
    """A block as a span of ``layer`` named ``name``."""
    return _Scope(layer, name) if _on else _OFF


def route(suffix: str) -> None:
    """Add ``.suffix`` to the name of the innermost open span (the
    route a call took)."""
    if _on and _open:
        rec = _records[_open[-1]]
        rec[1] = f"{rec[1]}.{suffix}"


def count(kind: str, site: str, n: int = 1) -> None:
    """Count ``n`` events of ``kind`` at ``site``."""
    if _on:
        key = (kind, site)
        _counts[key] = _counts.get(key, 0) + n


def rotate_profiling_dir(base: Path, max_old: int = 2) -> Path:
    """ck.profiling -> ck.profiling.0 -> ck.profiling.1 rotation
    (`sdpb/main.cxx:118-137`; tested in the reference's
    `sdpb.test.cxx:50-86`)."""
    base = Path(base)
    if base.exists():
        idx = 0
        while (base.parent / f"{base.name}.{idx}").exists():
            idx += 1
        if idx >= max_old:
            # shift down, dropping the oldest
            import shutil

            shutil.rmtree(base.parent / f"{base.name}.0")
            for i in range(1, idx):
                (base.parent / f"{base.name}.{i}").rename(
                    base.parent / f"{base.name}.{i - 1}")
            idx = max_old - 1
        base.rename(base.parent / f"{base.name}.{idx}")
    base.mkdir(parents=True, exist_ok=True)
    return base
