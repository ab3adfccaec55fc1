"""Device milliseconds an iteration of the library's matrix products
(the CRT products of ``ops/exact.py``): ``opcounts.PROFILE_CLASSES``'s
matmul class."""


def read(run):
    if run.trace is None or not run.traced_iterations:
        return None
    s = run.trace.by_class().get("matmul")
    return s * 1e3 / run.traced_iterations if s else None
