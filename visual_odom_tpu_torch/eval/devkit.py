"""KITTI devkit artifacts.

Port of ``visual_odom_tpu/eval/devkit.py`` (numpy and matplotlib, no JAX):
the libviso2 devkit tool of the reference (src/evaluate/
evaluate_odometry.cpp, whose ``main`` is commented out, :471-497, and whose
plots shell out to gnuplot, :362-373) with its files as first-class
outputs:

- per-segment error rows     (saveSequenceErrors format, reference :118-130)
- path plot data             (savePathPlot, step 3, reference :132-147)
- error plot data tl/rl/ts/rs (saveErrorPlots binning, reference :224-298)
- stats.txt averages         (saveStats, reference :376-396)
- PNG plots via matplotlib   (the gnuplot scripts at :151-374, same axes
  and units), only when asked for.

``eval_all`` is devkit ``eval()`` (reference :398-469): score every
sequence of a results directory against the ground truth, write every
artifact, and report through a ``utils.notify.Notifier`` (the devkit's
Mail).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from visual_odom_tpu_torch.eval.kitti_eval import (LENGTHS, SegmentError,
                                                   ate_rmse,
                                                   calc_sequence_errors)
from visual_odom_tpu_torch.utils.notify import Notifier


def save_sequence_errors(errors: Sequence[SegmentError], path: str) -> None:
    """`first_frame r_err t_err len speed` rows (reference :118-130)."""
    with open(path, "w") as f:
        for e in errors:
            f.write(f"{e.first_frame} {e.r_err:f} {e.t_err:f} "
                    f"{e.length:f} {e.speed:f}\n")


def save_path_plot_data(poses_gt: np.ndarray, poses_result: np.ndarray,
                        path: str, step: int = 3) -> None:
    """`gt_x gt_z result_x result_z` every `step` frames (reference :132-147)."""
    n = min(len(poses_gt), len(poses_result))
    with open(path, "w") as f:
        for i in range(0, n, step):
            f.write(f"{poses_gt[i][0, 3]:f} {poses_gt[i][2, 3]:f} "
                    f"{poses_result[i][0, 3]:f} {poses_result[i][2, 3]:f}\n")


def _bin_errors(errors: Sequence[SegmentError]):
    """Average t/r error per segment length and per speed bucket, keeping a
    bin only when it has >= 3 samples (reference `num>2.5`, :263-264, :286)."""
    by_len, by_speed = [], []
    for length in LENGTHS:
        sel = [e for e in errors if e.length == length]
        if len(sel) > 2.5:
            by_len.append((length,
                           float(np.mean([e.t_err for e in sel])),
                           float(np.mean([e.r_err for e in sel]))))
    for speed in np.arange(2.0, 25.0, 2.0):
        sel = [e for e in errors if abs(e.speed - speed) < 2.0]
        if len(sel) > 2.5:
            by_speed.append((float(speed),
                             float(np.mean([e.t_err for e in sel])),
                             float(np.mean([e.r_err for e in sel]))))
    return by_len, by_speed


def save_error_plot_data(errors: Sequence[SegmentError], prefix: str) -> None:
    """Write `{prefix}_{tl,rl,ts,rs}.txt` (reference saveErrorPlots :224-298):
    tl/rl keyed by path length [m], ts/rs by speed [m/s]; raw (unscaled)
    error units, matching the devkit's files."""
    by_len, by_speed = _bin_errors(errors)
    with open(f"{prefix}_tl.txt", "w") as f:
        for x, t, _ in by_len:
            f.write(f"{x:f} {t:f}\n")
    with open(f"{prefix}_rl.txt", "w") as f:
        for x, _, r in by_len:
            f.write(f"{x:f} {r:f}\n")
    with open(f"{prefix}_ts.txt", "w") as f:
        for x, t, _ in by_speed:
            f.write(f"{x:f} {t:f}\n")
    with open(f"{prefix}_rs.txt", "w") as f:
        for x, _, r in by_speed:
            f.write(f"{x:f} {r:f}\n")


def save_stats(errors: Sequence[SegmentError], out_dir: str) -> None:
    """`stats.txt`: mean t_err, mean r_err over ALL segments (reference
    :376-396)."""
    t = float(np.mean([e.t_err for e in errors])) if errors else 0.0
    r = float(np.mean([e.r_err for e in errors])) if errors else 0.0
    with open(os.path.join(out_dir, "stats.txt"), "w") as f:
        f.write(f"{t:f} {r:f}\n")


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot_path(poses_gt: np.ndarray, poses_result: np.ndarray,
              out_png: str, title: str = "") -> None:
    """Bird's-eye x/z path plot, GT vs estimate (devkit plotPathPlot,
    reference :173-222, gnuplot replaced by matplotlib)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.plot(poses_gt[:, 0, 3], poses_gt[:, 2, 3], "-", color="#FF0000",
            lw=1.5, label="Ground Truth")
    ax.plot(poses_result[:, 0, 3], poses_result[:, 2, 3], "-",
            color="#0000FF", lw=1.5, label="Visual Odometry")
    ax.plot([poses_gt[0, 0, 3]], [poses_gt[0, 2, 3]], "ks", ms=7,
            label="Sequence Start")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.set_aspect("equal")
    ax.legend(loc="best", fontsize=8)
    if title:
        ax.set_title(title)
    fig.tight_layout()
    fig.savefig(out_png, dpi=110)
    plt.close(fig)


def plot_errors(errors: Sequence[SegmentError], prefix: str) -> None:
    """The devkit's four error plots (plotErrorPlots, reference :300-374):
    {prefix}_{tl,rl,ts,rs}.png with the same axis scaling — t_err*100 [%],
    r_err*57.3 [deg/m], speed*3.6 [km/h]."""
    plt = _plt()
    by_len, by_speed = _bin_errors(errors)
    panels = [
        ("tl", [(x, t * 100) for x, t, _ in by_len],
         "Path Length [m]", "Translation Error [%]"),
        ("rl", [(x, r * 57.3) for x, _, r in by_len],
         "Path Length [m]", "Rotation Error [deg/m]"),
        ("ts", [(x * 3.6, t * 100) for x, t, _ in by_speed],
         "Speed [km/h]", "Translation Error [%]"),
        ("rs", [(x * 3.6, r * 57.3) for x, _, r in by_speed],
         "Speed [km/h]", "Rotation Error [deg/m]"),
    ]
    for suffix, pts, xlabel, ylabel in panels:
        fig, ax = plt.subplots(figsize=(5, 2.5))
        if pts:
            xs, ys = zip(*pts)
            ax.plot(xs, ys, "s-", color="#0000FF", ms=4, lw=1.2)
        ax.set_xlabel(xlabel)
        ax.set_ylabel(ylabel)
        ax.set_ylim(bottom=0)
        fig.tight_layout()
        fig.savefig(f"{prefix}_{suffix}.png", dpi=110)
        plt.close(fig)


def eval_sequence_artifacts(poses_gt: np.ndarray, poses_result: np.ndarray,
                            out_dir: str, seq_name: str = "00",
                            plots: bool = True) -> list[SegmentError]:
    """All devkit artifacts for one sequence into out_dir/{errors,plot_path,
    plot_error} (the devkit's directory layout, reference :406-419)."""
    err_dir = os.path.join(out_dir, "errors")
    path_dir = os.path.join(out_dir, "plot_path")
    eplot_dir = os.path.join(out_dir, "plot_error")
    for d in (err_dir, path_dir, eplot_dir):
        os.makedirs(d, exist_ok=True)

    errors = calc_sequence_errors(poses_gt, poses_result)
    save_sequence_errors(errors, os.path.join(err_dir, f"{seq_name}.txt"))
    save_path_plot_data(poses_gt, poses_result,
                        os.path.join(path_dir, f"{seq_name}.txt"))
    save_error_plot_data(errors, os.path.join(eplot_dir, seq_name))
    if plots:
        plot_path(poses_gt, poses_result,
                  os.path.join(path_dir, f"{seq_name}.png"),
                  title=f"Sequence {seq_name}")
        plot_errors(errors, os.path.join(eplot_dir, seq_name))
    return errors


def eval_all(gt_dir: str, result_dir: str, out_dir: str,
             sequences: Optional[Sequence[str]] = None,
             notifier: Optional[Notifier] = None,
             plots: bool = True) -> dict:
    """Devkit `eval()` (reference :398-469): score `<result_dir>/<seq>.txt`
    against `<gt_dir>/<seq>.txt` for every sequence, write artifacts, return
    {seq: {t_err, r_err, ate}, "avg": ...}."""
    from visual_odom_tpu_torch.io.kitti import load_poses

    note = notifier or Notifier()
    if sequences is None:
        sequences = sorted(
            os.path.splitext(f)[0] for f in os.listdir(result_dir)
            if f.endswith(".txt"))
    all_errors: list[SegmentError] = []
    results: dict = {}
    for seq in sequences:
        gt_path = os.path.join(gt_dir, f"{seq}.txt")
        res_path = os.path.join(result_dir, f"{seq}.txt")
        if not (os.path.exists(gt_path) and os.path.exists(res_path)):
            note.msg(f"skipping sequence {seq}: missing poses")
            continue
        gt, res = load_poses(gt_path), load_poses(res_path)
        n = min(len(gt), len(res))
        if n < 2:
            note.msg(f"skipping sequence {seq}: too few poses")
            continue
        errors = eval_sequence_artifacts(gt[:n], res[:n], out_dir, seq, plots)
        all_errors.extend(errors)
        t = float(np.mean([e.t_err for e in errors])) if errors else 0.0
        r = float(np.mean([e.r_err for e in errors])) if errors else 0.0
        a = ate_rmse(gt[:n], res[:n])
        results[seq] = {"t_err": t, "r_err": r, "ate": a}
        note.msg(f"sequence {seq}: t_err {t * 100:.2f}%  "
                 f"r_err {r * 57.2957795:.4f} deg/m  ATE {a:.2f} m")
    if all_errors:
        save_stats(all_errors, out_dir)
        results["avg"] = {
            "t_err": float(np.mean([e.t_err for e in all_errors])),
            "r_err": float(np.mean([e.r_err for e in all_errors])),
        }
        note.msg(f"mean over {len(results) - 1} sequences: "
                 f"t_err {results['avg']['t_err'] * 100:.2f}%  "
                 f"r_err {results['avg']['r_err'] * 57.2957795:.4f} deg/m")
    note.close()
    return results
