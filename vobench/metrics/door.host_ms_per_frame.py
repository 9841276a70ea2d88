"""Host time of a live frame that the device waits for, in ms: the median
over the window's frames of the ``vo.process_frame`` span less its
``graph.replay`` and ``graph.fetch`` spans (the launch, and the fetch that
waits for the device), leaving the frame's input copies, state snapshot,
pose chaining and the calls between them. From the program's span
recorder (``visual_odom_tpu_torch.utils.profiling``); None where the
recorder dropped a record of the window, or a frame lacks these spans
(the recorder off, or an eager step)."""

import numpy as np

try:
    from visual_odom_tpu_torch.utils.profiling import records
except ImportError:         # a program without the span recorder
    records = None

DEVICE_BOUND = ("graph.replay", "graph.fetch")


def read(run):
    if records is None:
        return None
    rec = records(int(run.jobs[0].t0 * 1e9), int(run.jobs[-1].t1 * 1e9) + 1)
    if not rec.complete:
        return None
    frames, inside = {}, {}
    for s in rec.spans:
        if s.name == "vo.process_frame":
            frames[s.request] = s.end_ns - s.start_ns
        elif s.name in DEVICE_BOUND:
            got = inside.setdefault(s.request, {})
            got[s.name] = got.get(s.name, 0) + s.end_ns - s.start_ns
    if not frames:
        return None
    host = []
    for req, ns in frames.items():
        got = inside.get(req, {})
        if set(got) != set(DEVICE_BOUND):
            return None
        host.append(ns - sum(got.values()))
    return float(np.median(host)) / 1e6
