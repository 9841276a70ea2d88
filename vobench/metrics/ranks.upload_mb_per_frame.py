"""Bytes each rank's chunk uploader pinned and copied a frame the rank
stepped, in MB (1e6 B): the counter ``upload.bytes`` each rank shipped
for the window's jobs (``vobench.doors.ranks``) over the frames of its
data row; the largest over the ranks. A rank that uploads only its row
reads one frame's pair, 0.93 MB at 1241x376. None where a program counts
no ``upload.bytes``."""

from vobench.doors.ranks import window_ranks


def read(run):
    ranks = window_ranks(run)
    if ranks is None or any("upload.bytes" not in r.counters or not r.steps
                            for r in ranks):
        return None
    return max(r.counters["upload.bytes"] / r.steps for r in ranks) / 1e6
