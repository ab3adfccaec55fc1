"""Seconds of the driver's residues phase an iteration: its synchronised
``run.iter_<n>.residues`` spans, averaged over the traced run's iterations
before the profiler starts (``run.TRACE_AFTER``)."""


def read(run):
    vals = [p[0] for p in run.phase_s]
    return sum(vals) / len(vals) if vals else None
