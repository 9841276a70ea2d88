"""The batched door: a job's clips in lockstep through
``parallel.batch_eval.run_sequences_batched(chunk=chunk)``, frames read
from host memory by the runner's own uploader thread. Counters: the
runner's ``wall_seconds`` (``runner_wall``) and the sum of its per-clip
``fallback_frames``."""

from __future__ import annotations

import time

from vobench.bank import Clip
from vobench.doors import FrontDoor, Job, accepts_from_poses


class Door(FrontDoor):
    warm_frames = 2

    def run(self, index, starts, rs, frames, traced) -> Job:
        from visual_odom_tpu_torch.parallel.batch_eval import \
            run_sequences_batched

        clips = [Clip(self.bank, s, frames) for s in starts]
        t0 = time.perf_counter()
        with self.traced(traced), self.spans("job"):
            with self.spans("runner"):
                poses, stats, wall = run_sequences_batched(
                    clips, self.config, self.intrinsics, seed=rs,
                    chunk=self.traffic["chunk"], device=self.device)
        t1 = time.perf_counter()
        steps = (frames - 1) * len(clips)
        return Job(index, starts, rs, t0, t1, steps, poses,
                   [accepts_from_poses(p) for p in poses],
                   [s["mean_inliers"] for s in stats],
                   {"runner_wall": wall,
                    "fallback_frames": sum(s["fallback_frames"]
                                           for s in stats)})
