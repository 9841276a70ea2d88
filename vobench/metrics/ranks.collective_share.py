"""Share of each rank's kernel time in the traced job that its NCCL
kernels take (a kernel whose name holds "nccl"), in %; the largest over
the ranks. A rank that waits at the all-gather for a slower one counts the
wait here. From each rank's own trace of the job
(``vobench.doors.ranks.TRACED``); None in a run without one, or where a
rank ran no kernel (the CPU)."""

from vobench.doors.ranks import TRACED


def read(run):
    if run.trace is None or not TRACED:
        return None
    if any(not t.trace.kernel_s for t in TRACED):
        return None
    return max(t.nccl_s / t.trace.kernel_s for t in TRACED) * 100.0
