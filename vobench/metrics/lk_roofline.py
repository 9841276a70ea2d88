"""The LK kernels' share of their roofline, in %: the least time the card
could take for the LK launches of the traced job (each launch's
larger of operations / 67 TFLOP/s and bytes / 3.35 TB/s, ``vobench.
lkwork``, counted from the reference's update counts on the same steps of
the job's clips) over those launches' device time."""


def read(run):
    if run.trace is None or not run.trace.lk_kernels or run.lk_bound_s is None:
        return None
    return run.lk_bound_s * run.trace.lk_kernels / run.trace.lk_kernel_s * 100.0
