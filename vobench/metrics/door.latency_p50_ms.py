"""Median latency of the live door, in ms: the time from handing a frame
to ``VisualOdometry.process_frame`` until its pose is on the host, over
every frame of the window. In a closed loop of one camera it sets the
frame rate."""

import numpy as np


def read(run):
    lat = [x for j in run.jobs for x in j.counters.get("latencies", ())]
    if not lat:
        return None
    return float(np.median(lat)) * 1e3
