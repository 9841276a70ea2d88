"""Share of its life each rank's chunk uploader spends stacking and
copying chunks, in %: ``upload.busy_share``'s formula (per uploader, the
sum of its ``upload.stack`` and ``upload.copy`` spans over the time from
its first span's start to its last one's end, summed over the uploaders
before the division) on the program spans each rank shipped for the
window's jobs (``vobench.doors.ranks``); the largest over the ranks. None
where a rank's recorder dropped a record of a job or holds no uploader
span."""

from vobench.doors.ranks import window_ranks


def _share(spans):
    life, busy = {}, 0
    for s in spans:
        if not s.name.startswith("upload."):
            continue
        key = (s.request, s.thread)
        lo, hi = life.get(key, (s.start_ns, s.end_ns))
        life[key] = (min(lo, s.start_ns), max(hi, s.end_ns))
        if s.name in ("upload.stack", "upload.copy"):
            busy += s.end_ns - s.start_ns
    lived = sum(hi - lo for lo, hi in life.values())
    return busy / lived * 100.0 if lived else None


def read(run):
    ranks = window_ranks(run)
    if ranks is None or not all(r.complete for r in ranks):
        return None
    shares = [_share(r.spans) for r in ranks]
    if any(s is None for s in shares):
        return None
    return max(shares)
