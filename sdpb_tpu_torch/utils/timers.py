"""Hierarchical scoped timers, verbosity, and memory sampling (the
port's own copy of sdpb_tpu/utils/timers.py).

Host-side equivalent of the reference's tracing/profiling subsystem
(`src/sdpb_util/Timers/Timers.hxx:23-96`, `Verbosity.hxx:10-16`,
`Proc_Meminfo.hxx:15`):
- Timers keeps an ordered list of (dotted name, elapsed) pairs;
  Scoped_Timer/`timers.scoped(...)` builds prefixes like
  `sdpb.solve.run.iter_3.step.initializeSchurComplementSolver.Q.syrk`
- at every timer start, /proc/meminfo MemUsed (MemTotal - MemAvailable)
  is sampled and the max is reported (the reference's Proc_Meminfo)
- write_profile() emits the same `{"name", elapsed}` list the
  reference writes to ck.profiling/profiling.<rank>
"""

from __future__ import annotations

import contextlib
import enum
import time
from pathlib import Path


class Verbosity(enum.IntEnum):
    """`sdpb_util/Verbosity.hxx:10-16`."""

    none = 0
    regular = 1
    debug = 2
    trace = 3


def proc_mem_used() -> int | None:
    """MemTotal - MemAvailable from /proc/meminfo, in bytes
    (`sdpb_util/Proc_Meminfo.hxx`)."""
    try:
        fields = {}
        for line in Path("/proc/meminfo").read_text().splitlines():
            key, _, rest = line.partition(":")
            fields[key.strip()] = int(rest.split()[0]) * 1024
        return fields["MemTotal"] - fields["MemAvailable"]
    except (OSError, KeyError, ValueError, IndexError):
        return None


class Timers:
    """Ordered hierarchical timer registry."""

    def __init__(self, verbosity: Verbosity = Verbosity.regular,
                 sample_memory: bool | None = None):
        self.named: list = []          # [(name, start, stop|None)]
        self.prefix = ""
        self.verbosity = Verbosity(verbosity)
        self.sample_memory = (self.verbosity >= Verbosity.debug
                              if sample_memory is None else sample_memory)
        self.max_mem_used = 0
        self.max_mem_used_name = ""

    @contextlib.contextmanager
    def scoped(self, name: str):
        full = self.prefix + name
        old_prefix = self.prefix
        self.prefix = full + "."
        entry = [full, time.monotonic(), None]
        self.named.append(entry)
        if self.sample_memory:
            mem = proc_mem_used()
            if mem is not None and mem > self.max_mem_used:
                self.max_mem_used = mem
                self.max_mem_used_name = full
        try:
            yield entry
        finally:
            entry[2] = time.monotonic()
            self.prefix = old_prefix

    def elapsed_seconds(self, name: str) -> float:
        for full, start, stop in self.named:
            if full == name:
                return (stop if stop is not None else time.monotonic()) - start
        raise KeyError(name)

    def elapsed_milliseconds(self, name: str) -> int:
        return int(self.elapsed_seconds(name) * 1000)

    def write_profile(self, path) -> None:
        """`Timers::write_profile` format: `{"name", elapsed_ms}` lines."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        lines = ["{"]
        now = time.monotonic()
        for i, (full, start, stop) in enumerate(self.named):
            ms = int(((stop if stop is not None else now) - start) * 1000)
            comma = "," if i + 1 < len(self.named) else ""
            lines.append(f'    {{"{full}", {ms}}}{comma}')
        lines.append("}")
        path.write_text("\n".join(lines) + "\n")


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
