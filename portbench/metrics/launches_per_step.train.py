"""Device kernels and copies launched per training step in the traced window."""


def read(run):
    if run.trace is None or not run.traced.get("steps"):
        return None
    return run.trace.launches / run.traced["steps"]
