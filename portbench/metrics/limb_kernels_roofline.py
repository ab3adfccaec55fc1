"""Share of their roofline of the limb kernels (Cholesky, substitution,
elementwise): the least time of the window's calls (``opcounts``, from
their shapes) over the device time of their launches, in percent."""

from portbench import opcounts


def read(run):
    if run.trace is None or not run.calls.calls:
        return None
    device_s = sum(run.trace.by_name(p)[0] for p in opcounts.LIMB_KERNELS)
    if device_s <= 0:
        return None
    return 100.0 * run.calls.least_s / device_s
