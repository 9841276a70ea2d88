"""Whether what the timed path produced is correct.

After the window closes, the reference (``vobench.reference``, plain
PyTorch that imports nothing of the program) steps again every clip of
one job drawn from the seed, from its first frame, with the same frames
and the same RANSAC seeds. The program's chained poses are then held to
the reference's frame by frame (``frame_gaps``, ``compare``); each number
compared has its limit in ``limits/<cell>.json``.
"""

from __future__ import annotations

import numpy as np

from vobench.reference.step import chain_poses, run_clips


def draw_job(seed: int, jobs: list):
    """The job of ``jobs`` the reference recomputes, drawn from the
    seed."""
    rng = np.random.default_rng([seed, 2])
    return jobs[int(rng.integers(len(jobs)))]


def reference_run(job, bank, config, intrinsics, frames: int, device,
                  record_steps=()):
    """The reference over every clip of ``job``: (StepOutput stacked
    (T - 1, B, ...), LK records)."""
    lefts = np.stack([bank.lefts[s:s + frames] for s in job.starts])
    rights = np.stack([bank.rights[s:s + frames] for s in job.starts])
    seeds = [job.ransac_seed + b for b in range(len(job.starts))]
    return run_clips(config, intrinsics, lefts, rights, seeds, device,
                     record_steps=record_steps)


def _deltas(poses: np.ndarray) -> np.ndarray:
    """(T - 1, 4, 4) frame deltas inv(P[i-1]) @ P[i] of chained poses."""
    return np.linalg.inv(poses[:-1]) @ poses[1:]


def _angle(Ra: np.ndarray, Rb: np.ndarray) -> np.ndarray:
    """Angle between rotations, from their chordal distance
    ||Ra - Rb||_F = 2 sqrt(2) sin(angle / 2), exact near 0."""
    chord = np.linalg.norm(Ra - Rb, axis=(-2, -1))
    return 2.0 * np.arcsin(np.clip(chord / (2.0 * np.sqrt(2.0)), 0.0, 1.0))


def frame_gaps(job, ref_out) -> tuple:
    """(t, r), each (B, T - 1): per clip and frame the gap between the
    program's and the reference's frame delta, in translation (m) and in
    rotation (rad). A frame accepted by one side only is an infinite gap,
    one that both reject a gap of 0."""
    ts, rs = [], []
    for b in range(len(job.starts)):
        acc_p = np.asarray(job.accept[b], bool)
        acc_r = ref_out.accept[:, b].astype(bool)
        dp = _deltas(job.poses[b])
        dr = _deltas(chain_poses(ref_out.T_inv[:, b], acc_r))
        both, one = acc_p & acc_r, acc_p != acc_r
        for gap, out in (
                (np.linalg.norm(dp[:, :3, 3] - dr[:, :3, 3], axis=1), ts),
                (_angle(dp[:, :3, :3], dr[:, :3, :3]), rs)):
            out.append(np.where(both, gap, np.where(one, np.inf, 0.0)))
    return np.stack(ts), np.stack(rs)


def clip_quantile(gaps: np.ndarray, q: float) -> float:
    """The largest over clips of the ``q`` quantile of a clip's frames'
    gaps, an element of the gaps (no interpolation, so an infinite gap
    is never averaged away)."""
    return float(np.quantile(gaps, q, axis=1, method="inverted_cdf").max())


def compare(job, ref_out) -> dict:
    """Numbers that hold the program's poses of every clip of ``job`` to
    the reference's, frame by frame: the largest clip's median and third
    quartile of the frames' translation gaps (um) and rotation gaps
    (urad), the quartile seeing what goes wrong in a quarter of a clip's
    frames; beside them the largest gaps (mm, mrad), the frames accepted
    by one side only, the largest gap of a clip's mean PnP inliers, and
    the largest gap of a clip's end position in % of its path."""
    t, r = frame_gaps(job, ref_out)
    inl, ends = [], []
    for b in range(len(job.starts)):
        ref = chain_poses(ref_out.T_inv[:, b], ref_out.accept[:, b])
        prog = job.poses[b]
        inl.append(abs(job.mean_inliers[b]
                       - float(ref_out.num_inliers[:, b].mean())))
        path = np.linalg.norm(np.diff(ref[:, :3, 3], axis=0), axis=1).sum()
        ends.append(np.linalg.norm(prog[-1, :3, 3] - ref[-1, :3, 3])
                    / max(path, 1e-9))
    one = np.isinf(t)
    return {
        "delta_t_median_um": clip_quantile(t, 0.5) * 1e6,
        "delta_t_p75_um": clip_quantile(t, 0.75) * 1e6,
        "delta_r_median_urad": clip_quantile(r, 0.5) * 1e6,
        "delta_r_p75_urad": clip_quantile(r, 0.75) * 1e6,
        "delta_t_max_mm": float(t[~one].max(initial=0.0)) * 1e3,
        "delta_r_max_mrad": float(r[~one].max(initial=0.0)) * 1e3,
        "accept_mismatches": float(one.sum()),
        "mean_inliers_gap": float(max(inl)),
        "end_gap_pct": float(max(ends)) * 100.0,
    }


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}) over the numbers that have a
    limit; a number that is not finite is not correct."""
    shown = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    ok = all(np.isfinite(v["value"]) and v["value"] <= v["limit"]
             for v in shown.values())
    return bool(ok), shown
