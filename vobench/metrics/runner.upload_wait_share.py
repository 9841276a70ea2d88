"""Share of the batched runner's loop spent waiting on its uploader, in %:
the sum of the ``runner.wait_upload`` spans over the sum of the
``runner.loop`` spans of the runner calls inside the window, from the
program's span recorder (``visual_odom_tpu_torch.utils.profiling``). None
where the recorder dropped a record of the window or holds no loop (the
recorder off, or a program without these spans)."""

try:
    from visual_odom_tpu_torch.utils.profiling import records
except ImportError:         # a program without the span recorder
    records = None


def read(run):
    if records is None:
        return None
    rec = records(int(run.jobs[0].t0 * 1e9), int(run.jobs[-1].t1 * 1e9) + 1)
    if not rec.complete:
        return None
    total = {"runner.loop": 0, "runner.wait_upload": 0}
    for s in rec.spans:
        if s.name in total:
            total[s.name] += s.end_ns - s.start_ns
    if not total["runner.loop"]:
        return None
    return total["runner.wait_upload"] / total["runner.loop"] * 100.0
