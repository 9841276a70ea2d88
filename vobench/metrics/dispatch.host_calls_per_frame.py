"""CUDA API calls (`cuda*`, `cu*`) the host made a frame in the traced
job: kernel and graph launches, copies and sets (``trace.
RUNTIME_CALL``), over the frames the job holds."""


def read(run):
    if run.trace is None or not run.traced_steps:
        return None
    return run.trace.runtime_calls / run.traced_steps
