"""Seconds of the driver's step phase an iteration: its synchronised
``run.iter_<n>.step`` spans, averaged over the traced run's iterations
before the profiler starts (``run.TRACE_AFTER``)."""


def read(run):
    vals = [p[1] for p in run.phase_s]
    return sum(vals) / len(vals) if vals else None
