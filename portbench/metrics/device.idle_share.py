"""Percent of the traced window in which no operation ran on the device
(kernels, copies and fills; one stream, so they do not overlap)."""


def read(run):
    if run.trace is None or not run.traced_s:
        return None
    return 100.0 * (1.0 - run.busy_s / run.traced_s)
