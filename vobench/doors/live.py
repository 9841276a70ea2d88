"""The live door: one clip through ``VisualOdometry``: ``initialize`` on
its first frame, then ``process_frame`` on each next frame once the last
pose is back on the host. Counter: each frame's latency in seconds
(``latencies``), from the hand-over to the returned pose."""

from __future__ import annotations

import time

import numpy as np

from vobench.bank import Clip
from vobench.doors import FrontDoor, Job


class Door(FrontDoor):
    warm_frames = 40

    def run(self, index, starts, rs, frames, traced) -> Job:
        from visual_odom_tpu_torch.runner.pipeline import VisualOdometry

        (start,) = starts
        lefts, rights = Clip(self.bank, start, frames).stacks()
        lat, poses, accept, inliers = [], [np.eye(4)], [], []
        t0 = time.perf_counter()
        with self.traced(traced), self.spans("job"):
            vo = VisualOdometry(self.config, self.intrinsics, seed=rs,
                                device=self.device)
            with self.spans("initialize"):
                vo.initialize(lefts[0], rights[0])
            for i in range(1, frames):
                ts = time.perf_counter()
                with self.spans("process_frame"):
                    r = vo.process_frame(lefts[i], rights[i])
                lat.append(time.perf_counter() - ts)
                poses.append(r.pose)
                accept.append(r.accept)
                inliers.append(r.num_inliers)
        t1 = time.perf_counter()
        return Job(index, starts, rs, t0, t1, frames - 1,
                   [np.stack(poses)], [np.asarray(accept)],
                   [float(np.mean(inliers))], {"latencies": lat})
