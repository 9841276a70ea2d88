"""Share of its life the batched runner's uploader thread spends stacking
and copying chunks, in %: for each uploader of the window (its spans by
request and thread), the sum of its ``upload.stack`` and ``upload.copy``
spans, over the time from its first span's start to its last one's end;
summed over the window's uploaders before the division. The rest of its
life it waits on the full queue (``upload.queue_full``), that is on the
step. From the program's span recorder
(``visual_odom_tpu_torch.utils.profiling``); None where the recorder
dropped a record of the window or holds no uploader span."""

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
    life, busy = {}, 0
    for s in rec.spans:
        if not s.name.startswith("upload."):
            continue
        key = (s.request, s.thread)
        lo, hi = life.get(key, (s.start_ns, s.end_ns))
        life[key] = (min(lo, s.start_ns), max(hi, s.end_ns))
        if s.name in ("upload.stack", "upload.copy"):
            busy += s.end_ns - s.start_ns
    lived = sum(hi - lo for lo, hi in life.values())
    if not lived:
        return None
    return busy / lived * 100.0
