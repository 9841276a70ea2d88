"""Device kernels a frame in the traced job: a count that fusion
moves."""


def read(run):
    if run.trace is None or not run.traced_steps or not run.trace.kernels:
        return None
    return run.trace.kernels / run.traced_steps
