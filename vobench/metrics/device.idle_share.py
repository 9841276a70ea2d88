"""Share of the traced job in which no kernel, copy or set ran on
the device, in %: 1 - the union of their intervals over the job's profiled span."""


def read(run):
    if run.trace is None or not run.trace.window_s:
        return None
    return (1.0 - run.trace.busy_s / run.trace.window_s) * 100.0
