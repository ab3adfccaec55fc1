"""Device milliseconds an iteration of the integer-typed elementwise
kernels (the CRT digits and residues and the limb exponents):
``opcounts.PROFILE_CLASSES``'s integer_glue class."""


def read(run):
    if run.trace is None or not run.traced_iterations:
        return None
    s = run.trace.by_class().get("integer_glue")
    return s * 1e3 / run.traced_iterations if s else None
