"""What the program's own layer spans and counters say about the traced
window: the device's idle time split over the layer of the innermost
program span open on the host, and the program's count of syncs.

The program (``sdpb_tpu_torch/utils/timers.py``) records its layer
spans, [layer, name, start_ns, stop_ns, parent] on the host's
perf_counter clock, and counts its syncs while torch.profiler runs:
over the traced window's profiled iterations.  The readers take them
once, after the window.  Each idle gap between the first and the last
device operation of the window, moved to the host's clock by the
trace's offset (``trace.DeviceTrace``), is split over the innermost
spans that cover it; what no span covers goes to ``driver``.  A program
without layer spans, or a run without a device trace, gives None.
"""

from __future__ import annotations

import sys

# where no program span is open: the driver's loop and the benchmark's
# own work between iterations
OUTSIDE = "driver"

_last = (None, None)        # (run, readings): the readers share one taking


def _take():
    """(records, counts) from the program, or None where it has no
    layer spans."""
    try:
        from sdpb_tpu_torch.utils import timers
    except ImportError:
        return None
    take = getattr(timers, "take", None)
    return take() if take is not None else None


def segments(records):
    """(t0, t1, index) intervals of the host's clock in time order, in
    each of which record ``index`` is the innermost open span.  The
    records are one thread's, properly nested, in the order they
    opened."""
    out, stack, cur = [], [], None
    for i, (_, _, start, stop, _) in enumerate(records):
        while stack and records[stack[-1]][3] <= start:
            top = stack.pop()
            out.append((cur, records[top][3], top))
            cur = records[top][3]
        if stack:
            out.append((cur, start, stack[-1]))
        stack.append(i)
        cur = start
    while stack:
        top = stack.pop()
        out.append((cur, records[top][3], top))
        cur = records[top][3]
    return [s for s in out if s[1] > s[0]]


def split_gaps(gaps, segs, key):
    """{key(index) or OUTSIDE: ns} of the intervals ``gaps`` (sorted,
    disjoint) over the segments ``segs`` (from ``segments``)."""
    out, i = {}, 0
    for g0, g1 in gaps:
        while i < len(segs) and segs[i][1] <= g0:
            i += 1
        covered, j = 0, i
        while j < len(segs) and segs[j][0] < g1:
            ov = min(g1, segs[j][1]) - max(g0, segs[j][0])
            if ov > 0:
                k = key(segs[j][2])
                out[k] = out.get(k, 0) + ov
                covered += ov
            j += 1
        out[OUTSIDE] = out.get(OUTSIDE, 0) + (g1 - g0) - covered
    return out


def phase_of(records) -> list:
    """Each record's phase: its own name for a span of layer ``phases``,
    else its parent's phase, else OUTSIDE."""
    out = []
    for layer, name, _, _, parent in records:
        out.append(name if layer == "phases"
                   else out[parent] if parent >= 0 else OUTSIDE)
    return out


def attribute(records, host_gaps) -> dict:
    """The idle of ``host_gaps`` (ns, on the host's clock) by layer, by
    (phase, layer) and by (layer, span name) of the innermost span."""
    segs = segments(records)
    phases = phase_of(records)
    return {
        "layer": split_gaps(host_gaps, segs, lambda i: records[i][0]),
        "phase": split_gaps(host_gaps, segs,
                            lambda i: (phases[i], records[i][0])),
        "span": split_gaps(host_gaps, segs,
                           lambda i: (records[i][0], records[i][1])),
    }


def _readings(run) -> dict | None:
    taken = _take()
    if taken is None or run.trace is None or not run.traced_iterations:
        return None
    records, counts = taken
    if not records:
        return None
    n = run.traced_iterations
    dt = run.trace
    out = {"syncs": sum(v for (kind, _), v in counts.items()
                        if kind == "syncs") / n, "idle_ms": None}
    say = lambda msg: print(f"layers: {msg}", file=sys.stderr, flush=True)
    say(f"{len(records)} span records over {n} iterations "
        f"({len(records) / n:.0f} an iteration); counts an iteration: "
        + ", ".join(f"{kind} {site} {v / n:g}"
                    for (kind, site), v in sorted(counts.items())))
    copies = {}
    for name, (_, k) in dt.per_name.items():
        if name.startswith("Memcpy"):
            kind = name.split()[1]
            copies[kind] = copies.get(kind, 0) + k / n
    say("device copies an iteration: " + ", ".join(
        f"{kind} {v:g}" for kind, v in sorted(copies.items())))
    if dt.offset is None or not dt.ops:
        say("no marker ties the clocks: idle is not attributed")
        return out
    first = dt.ops[0][1]
    last = max(t1 for _, _, t1 in dt.ops)
    host_gaps = [(g0 - dt.offset, g1 - dt.offset)
                 for g0, g1 in dt.gaps(first, last)]
    got = attribute(records, host_gaps)
    per_it = lambda ns: ns / 1e6 / n
    out["idle_ms"] = {k: per_it(v) for k, v in got["layer"].items()}
    inner = sum(got["layer"].values()) / 1e9
    window = max(run.traced_s - run.busy_s, 1e-9)
    say("idle an iteration (ms): " + ", ".join(
        f"{k} {v:.3f}" for k, v in sorted(out["idle_ms"].items(),
                                          key=lambda kv: -kv[1])))
    say(f"idle between the window's first and last operation {inner:.6f} s"
        f" of the window's {window:.6f} s ({100 * inner / window:.3f}%; "
        f"before the first and after the last {window - inner:.6f} s)")
    label = lambda k: "/".join(k) if isinstance(k, tuple) else k
    say("idle an iteration by phase and layer (ms): " + ", ".join(
        f"{label(k)} {per_it(v):.2f}" for k, v in sorted(
            got["phase"].items(), key=lambda kv: -kv[1])
        if per_it(v) >= 0.5))
    top = sorted(((k, v) for k, v in got["span"].items() if k != OUTSIDE),
                 key=lambda kv: -kv[1])[:15]
    say("idle an iteration by innermost span (ms): " + ", ".join(
        f"{label(k)} {per_it(v):.2f}" for k, v in top))
    return out


def readings(run) -> dict | None:
    """The run's readings, computed at the first reader's call."""
    global _last
    if _last[0] is not run:
        _last = (run, _readings(run))
    return _last[1]


def idle_ms(run, layer: str) -> float | None:
    """Device idle an iteration (ms) while a span of ``layer`` was the
    innermost open one on the host."""
    got = readings(run)
    if got is None or got["idle_ms"] is None:
        return None
    return got["idle_ms"].get(layer, 0.0)


def syncs(run) -> float | None:
    """The program's syncs an iteration."""
    got = readings(run)
    return None if got is None else got["syncs"]
