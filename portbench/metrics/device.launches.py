"""Device kernels launched an iteration in the traced window."""


def read(run):
    if run.trace is None or not run.traced_iterations:
        return None
    return run.trace.kernel_launches() / run.traced_iterations
