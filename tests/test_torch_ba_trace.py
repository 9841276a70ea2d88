"""Windowed BA where a pose is observed once: the port against the JAX
package.

A window in which a pose is observed by a single stereo measurement (3
residuals for 6 degrees of freedom) is near-singular: the LM damping (1e-4)
alone fixes that pose's update, and float32 rounding, which differs between
the packages' summation orders, decides it. Every other pose is held to the
JAX package within SMOOTH_TOL, and the two packages differ on that pose
alone.

Script mode traces windowed BA on one run's saved tracks through both
packages, window by window (the short-course config, 8 / 256 / 3 / Huber
1.5), and reports the first window whose solved poses differ by more than
SMOOTH_TOL with the observations per pose there::

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_ba_trace.py \\
        chiprun_out/ba_trace/tracks_loop.npz chiprun_out/ba_trace/poses_loop.npz

(the files ``scripts/backend_courses.py --save-tracks DIR`` writes).
"""

import numpy as np
import jax
import pytest
import torch

from visual_odom_tpu.ba import problem as jproblem
from visual_odom_tpu.ba import schur as jschur
from visual_odom_tpu_torch.ba import schur
from visual_odom_tpu_torch.interop import ba_problem_from_numpy

torch.set_num_threads(1)

#: smoothed poses; the JAX package's ring-vs-single bound
#: (tests/test_ba_window.py:122)
SMOOTH_TOL = 5e-4
BA_SHORT = dict(window=8, iterations=8, max_landmarks=256, min_track_len=3,
                huber_delta=1.5)


def _np(x):
    return {k: np.asarray(v) for k, v in x._asdict().items()}


@pytest.mark.parametrize("obs_window", [None, 2], ids=["dense", "window2"])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("once", [3, 7], ids=["middle", "last"])
def test_once_observed_pose_is_the_only_difference(obs_window, seed, once):
    """8 poses; pose ``once`` keeps one observation. After ba_solve with
    the short config every other pose agrees with JAX within SMOOTH_TOL,
    and the largest difference is on pose ``once`` (measured: 4.4 to 16.9
    there, 3e-6 elsewhere)."""
    jp, _, _ = jproblem.synthetic_ba_problem(num_poses=8, num_landmarks=64,
                                             obs_window=obs_window, seed=seed)
    mask = np.asarray(jp.mask).copy()
    keep = np.flatnonzero(mask[once])[0]
    mask[once] = False
    mask[once, keep] = True
    jp = jp._replace(mask=jax.numpy.asarray(mask))
    tp = ba_problem_from_numpy(_np(jp), device="cpu")
    kw = dict(iterations=BA_SHORT["iterations"],
              huber_delta=BA_SHORT["huber_delta"])
    ref = np.asarray(jschur.ba_solve(jp, **kw).poses)
    got = schur.ba_solve(tp, **kw).poses.numpy()
    d = np.abs(got - ref).max(axis=1)
    others = np.delete(d, once)
    assert others.max() < SMOOTH_TOL, d
    assert np.isfinite(got).all()
    assert d[once] > SMOOTH_TOL and int(np.argmax(d)) == once, d


# ---- script mode: window by window on a run's saved tracks ------------------

def _snapshots(path):
    from visual_odom_tpu_torch.runner.pipeline import TrackSnapshot

    with np.load(path) as z:
        stacked = {k: z[k] for k in TrackSnapshot._fields}
    n = len(stacked["valid"])
    return [TrackSnapshot(*(stacked[k][i] for k in TrackSnapshot._fields))
            for i in range(n)]


def trace_windows(tracks_path: str, poses_path: str, tol: float = SMOOTH_TOL):
    """Smooth one run's tracks with both packages (JAX reads the numpy
    snapshots as they are; the port on the CPU), recording every window's
    problem and solution through the ``solver=`` hook. Returns the ATE of
    the chain and of each smoothing, and for the first window whose solved
    poses differ by more than ``tol``: its index, frames, observations per
    pose (``mask.sum(axis=1)``), the difference per pose, and the port's
    solver run on JAX's own problem of that window."""
    from visual_odom_tpu.ba import window as jwindow
    from visual_odom_tpu.config import CameraIntrinsics as JIntrinsics
    from visual_odom_tpu_torch.ba import window
    from visual_odom_tpu_torch.config import CameraIntrinsics

    snaps = _snapshots(tracks_path)
    with np.load(poses_path) as z:
        poses, gt = z["poses"], z["gt"]
        intr_d = {k: float(z[k]) for k in ("fx", "fy", "cx", "cy", "bf")}
        intr_d.update(width=int(z["width"]), height=int(z["height"]))
    solve_kw = dict(iterations=BA_SHORT["iterations"],
                    huber_delta=BA_SHORT["huber_delta"])
    build_kw = dict(window=BA_SHORT["window"],
                    max_landmarks=BA_SHORT["max_landmarks"],
                    min_track_len=BA_SHORT["min_track_len"])
    rec = {"jax": [], "port": []}

    def jsolver(p):
        out = jschur.ba_solve(p, **solve_kw)
        rec["jax"].append((_np(p), np.asarray(out.poses)))
        return out

    def psolver(p):
        out = schur.ba_solve(p, **solve_kw)
        rec["port"].append((p, out.poses.numpy()))
        return out

    jsm = jwindow.smooth_trajectory_ba(snaps, poses, JIntrinsics(**intr_d),
                                       solver=jsolver, **build_kw)
    psm = window.smooth_trajectory_ba(snaps, poses, CameraIntrinsics(**intr_d),
                                      solver=psolver, device="cpu", **build_kw)

    def ate(p):
        err = np.linalg.norm(p[:len(gt), :3, 3] - gt[:, :3, 3], axis=1)
        return float(np.sqrt(np.mean(err ** 2)))

    res = {"frames": len(poses), "windows_solved": [len(rec["jax"]),
                                                    len(rec["port"])],
           "ate_chain_m": ate(poses), "ate_ba_jax_m": ate(jsm),
           "ate_ba_port_m": ate(psm),
           "max_abs_diff_smoothed": float(np.abs(jsm - psm).max())}
    for k, ((jprob, jpose), (pprob, ppose)) in enumerate(zip(rec["jax"],
                                                             rec["port"])):
        d = np.abs(jpose - ppose).max(axis=1)
        if d.max() <= tol:
            continue
        on_jax = schur.ba_solve(ba_problem_from_numpy(jprob, device="cpu"),
                                **solve_kw).poses.numpy()
        dj = np.abs(on_jax - jpose).max(axis=1)
        res["first_differing_window"] = {
            "index": k, "obs_per_pose": jprob["mask"].sum(axis=1).tolist(),
            "obs_per_pose_port": pprob.mask.numpy().sum(axis=1).tolist(),
            "landmarks": int(jprob["mask"].any(axis=0).sum()),
            "diff_per_pose": d.tolist(),
            "port_solver_on_jax_problem_diff_per_pose": dj.tolist(),
            "problems_equal": bool(np.array_equal(
                jprob["mask"], pprob.mask.numpy())) and float(np.abs(
                    jprob["observations"] - pprob.observations.numpy()).max())
            == 0.0}
        res["first_differing_window"]["fixture"] = jprob
        break
    return res


if __name__ == "__main__":
    import json
    import sys

    out = trace_windows(sys.argv[1], sys.argv[2])
    fixture = out.get("first_differing_window", {}).pop("fixture", None)
    if fixture is not None and len(sys.argv) > 3:
        np.savez_compressed(sys.argv[3], **fixture)
    print(json.dumps(out))
