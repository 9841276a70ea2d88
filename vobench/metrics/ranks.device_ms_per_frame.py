"""Kernel time a frame over every rank of the traced job, in ms: the sum of
the ranks' kernel durations (``vobench.doors.ranks.TRACED``, each rank's
own trace) over the frames the job holds, all clips. Beside one card's
``step.device_ms_per_frame`` it shows what the ranks add on the device.
None in a run without these traces or where no kernel ran (the CPU)."""

from vobench.doors.ranks import TRACED


def read(run):
    if run.trace is None or not TRACED or not run.traced_steps:
        return None
    kernel_s = sum(t.trace.kernel_s for t in TRACED)
    if not kernel_s:
        return None
    return kernel_s * 1e3 / run.traced_steps
