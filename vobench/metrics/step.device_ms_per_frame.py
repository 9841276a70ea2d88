"""Device kernel time a frame in the traced job, in ms: the sum of
kernel durations over the frames the job holds."""


def read(run):
    if run.trace is None or not run.traced_steps or not run.trace.kernels:
        return None
    return run.trace.kernel_s * 1e3 / run.traced_steps
