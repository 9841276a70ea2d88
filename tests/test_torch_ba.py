"""The port's track snapshots and windowed bundle adjustment against the JAX
package's, on the same numpy inputs.

- ``ba.problem`` / ``ba.schur``: projections, residuals, Jacobian blocks, one
  Gauss-Newton step and ``ba_solve`` on JAX's synthetic problems, carried
  into the port with ``interop.ba_problem_from_numpy``.
- ``ba.window``: ``build_window_problem`` and ``smooth_trajectory_ba`` on
  JAX's own snapshots and chained poses from a 17-frame course (carried
  with ``interop.track_snapshots_from_numpy``).
- ``runner.pipeline``: ``make_step_fn(with_tracks=True)`` against JAX's from
  JAX's state with JAX's RANSAC draws, and ``run_sequence_scan(
  collect_tracks=True)`` against stepping frame by frame.
- The port's own run: BA smoothing improves its ATE at the JAX tests' bar.

Script mode, the JAX package's CPU reference for ``chip_smoke.py``'s back-end
phase and ``scripts/backend_courses.py`` (a 1241x376 course: chain, windowed
BA in two configs, and on the loop course loop closure)::

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_ba.py loop 320
    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_ba.py long 1024
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_pipeline import INTR, RANSAC, H, W, _numpy_state
from visual_odom_tpu.ba import problem as jproblem
from visual_odom_tpu.ba import schur as jschur
from visual_odom_tpu.ba import window as jwindow
from visual_odom_tpu.config import CameraIntrinsics as JIntrinsics
from visual_odom_tpu.config import VOConfig as JVOConfig
from visual_odom_tpu.eval.kitti_eval import ate_rmse
from visual_odom_tpu.io.synthetic import SyntheticStereoSequence as JSequence
from visual_odom_tpu.runner import pipeline as jpipeline
from visual_odom_tpu_torch.ba import problem, schur, window
from visual_odom_tpu_torch.config import CameraIntrinsics, VOConfig
from visual_odom_tpu_torch.interop import (ba_problem_from_numpy,
                                           state_from_numpy,
                                           track_snapshots_from_numpy)
from visual_odom_tpu_torch.io.synthetic import SyntheticStereoSequence
from visual_odom_tpu_torch.runner import pipeline

# Small tensors: one intra-op thread each keeps the parallel test workers
# from oversubscribing the cores.
torch.set_num_threads(1)

#: px; float32 projections of the same points (a few ulps at u ~ 1000 px)
PX_TOL = 2e-4
#: Jacobian blocks, relative to the largest entry (float32 through
#: Rodrigues' series in another summation order)
JAC_RTOL = 5e-6
#: one damped GN step from the same problem: poses (rad, m), landmarks (m)
STEP_POSE_TOL = 1e-3
STEP_LM_TOL = 2e-2
#: ba_solve after 8 iterations: the fixed point is the same
SOLVE_POSE_TOL = 2e-5
SOLVE_LM_TOL = 2e-3
#: smoothed trajectory entries; the JAX package's own ring-vs-single bound
#: (tests/test_ba_window.py:122)
SMOOTH_TOL = 5e-4
#: px; observations whose initial residual lies this close to the prune
#: threshold may fall on either side of it
PRUNE_KNIFE = 1e-3
#: px; tracked positions of the same step (the step-parity rule of
#: tests/test_torch_pipeline.py)
TRACK_TOL = 1e-3
MAX_RESIDUAL_PX = 4.0


def _np(x):
    return {k: np.asarray(v) for k, v in x._asdict().items()}


def _port_problem(jp):
    return ba_problem_from_numpy(_np(jp), device="cpu")


@pytest.fixture(scope="module", params=[None, 2], ids=["dense", "window2"])
def synthetic(request):
    jp, poses_gt, lms_gt = jproblem.synthetic_ba_problem(
        num_poses=6, num_landmarks=64, obs_window=request.param)
    return jp, _port_problem(jp), (poses_gt, lms_gt), request.param


def test_synthetic_problem_matches_jax(synthetic):
    """The port's own synthetic problem: the same numpy draws, float32
    projections within PX_TOL."""
    jp, _, (poses_gt, lms_gt), ow = synthetic
    tp, p_gt, l_gt = problem.synthetic_ba_problem(
        num_poses=6, num_landmarks=64, obs_window=ow, device="cpu")
    np.testing.assert_array_equal(p_gt, poses_gt)
    np.testing.assert_array_equal(l_gt, lms_gt)
    ref = _np(jp)
    for k in ("poses", "landmarks", "mask"):
        np.testing.assert_array_equal(getattr(tp, k).numpy(), ref[k])
    assert np.abs(tp.observations.numpy() - ref["observations"]).max() < PX_TOL


def test_projection_residuals_and_cost_match_jax(synthetic):
    jp, tp, _, _ = synthetic
    intr = (jp.fx, jp.fy, jp.cx, jp.cy, jp.bf)
    ref = np.asarray(jproblem.project_stereo(jp.poses[2], jp.landmarks, intr))
    got = problem.project_stereo(tp.poses[2], tp.landmarks, intr).numpy()
    assert np.abs(got - ref).max() < PX_TOL
    r_ref = np.asarray(jproblem.residuals(jp))
    r = problem.residuals(tp).numpy()
    assert np.abs(r - r_ref).max() < PX_TOL
    assert not r[~np.asarray(jp.mask)].any()
    c_ref, c = float(jproblem.total_cost(jp)), float(problem.total_cost(tp))
    assert abs(c - c_ref) <= 1e-5 * c_ref            # float32 sums


@pytest.mark.parametrize("huber", [0.0, 1.5])
def test_jacobian_blocks_match_jax(synthetic, huber):
    jp, tp, _, _ = synthetic
    ref = [np.asarray(x) for x in jschur._jacobian_blocks(jp, huber)]
    got = [x.numpy() for x in schur._jacobian_blocks(tp, huber)]
    for name, g, r in zip("ABr", got, ref):
        assert g.shape == r.shape, name
        tol = PX_TOL if name == "r" else JAC_RTOL * np.abs(r).max()
        assert np.abs(g - r).max() <= tol, (name, np.abs(g - r).max())
    m = ~np.asarray(jp.mask)
    assert not got[0][m].any() and not got[1][m].any()


def test_gauge_pose_blocks_are_finite():
    """Pose 0 of a window problem sits at rvec = 0 exactly, where the
    unselected branch of rodrigues is 0/0: its forward-mode A blocks stay
    finite, as JAX's do, and agree with them."""
    jp, _, _ = jproblem.synthetic_ba_problem(num_poses=4, num_landmarks=32)
    jp = jp._replace(poses=jp.poses.at[0].set(0.0))
    tp = _port_problem(jp)
    assert not tp.poses[0].any()
    A, _, _ = schur._jacobian_blocks(tp, 1.5)
    A_ref = np.asarray(jschur._jacobian_blocks(jp, 1.5)[0])
    assert torch.isfinite(A).all() and np.isfinite(A_ref).all()
    assert np.abs(A[0].numpy() - A_ref[0]).max() <= JAC_RTOL * np.abs(A_ref).max()


def test_gauss_newton_step_matches_jax(synthetic):
    jp, tp, _, _ = synthetic
    ref = jschur.ba_gauss_newton_step(jp)
    got = schur.ba_gauss_newton_step(tp)
    assert np.abs(got.poses.numpy() - np.asarray(ref.poses)).max() < STEP_POSE_TOL
    assert (np.abs(got.landmarks.numpy() - np.asarray(ref.landmarks)).max()
            < STEP_LM_TOL)


@pytest.mark.parametrize("huber", [0.0, 1.5])
def test_ba_solve_matches_jax(synthetic, huber):
    """8 iterations converge to JAX's fixed point; pose 0 (the gauge) does
    not move and the solve gets closer to the ground truth."""
    jp, tp, (poses_gt, _), _ = synthetic
    ref = jschur.ba_solve(jp, iterations=8, huber_delta=huber)
    got = schur.ba_solve(tp, iterations=8, huber_delta=huber)
    assert np.abs(got.poses.numpy() - np.asarray(ref.poses)).max() < SOLVE_POSE_TOL
    assert (np.abs(got.landmarks.numpy() - np.asarray(ref.landmarks)).max()
            < SOLVE_LM_TOL)
    np.testing.assert_allclose(got.poses[0].numpy(), tp.poses[0].numpy(),
                               atol=1e-4)
    assert (np.abs(got.poses.numpy() - poses_gt).max()
            < np.abs(tp.poses.numpy() - poses_gt).max())


def test_ba_step_skips_a_non_finite_update():
    """A singular system leaves the problem as it was (the guard is a
    select on the device, not a host check)."""
    jp, _, _ = jproblem.synthetic_ba_problem(num_poses=3, num_landmarks=16)
    tp = _port_problem(jp)
    bad = tp._replace(observations=torch.full_like(tp.observations, np.nan))
    out = schur.ba_gauss_newton_step(bad)
    assert torch.equal(out.poses, bad.poses)
    assert torch.equal(out.landmarks, bad.landmarks)


# ---- windows of real tracks ------------------------------------------------

@pytest.fixture(scope="module")
def jax_run():
    """JAX's interactive run over the 17-frame course of
    tests/test_ba_window.py, with its snapshots (numpy)."""
    jintr = JIntrinsics(**INTR)
    jcfg = JVOConfig.for_image(H, W, ransac_iterations=RANSAC)
    seq = JSequence(jintr, num_frames=17, seed=0, speed=0.5)
    poses, _, snaps = jpipeline.run_sequence(seq, jcfg, jintr,
                                             collect_tracks=True)
    return seq, jintr, poses, [jax.tree.map(np.asarray, s) for s in snaps]


def test_window_problem_matches_jax(jax_run):
    """Same tracks, same chain: the same problem, masks equal apart from
    observations on the prune threshold's knife edge (counted; none on
    this course)."""
    _, jintr, poses, snaps = jax_run
    tracks = window.window_tracks(track_snapshots_from_numpy(snaps),
                                  list(range(8)))
    ref = jwindow.build_window_problem(tracks, poses[:8], jintr)
    got = window.build_window_problem(tracks, poses[:8],
                                      CameraIntrinsics(**INTR), device="cpu")
    assert ref is not None and got is not None
    for k in ("poses", "landmarks", "observations"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(ref, k)))
    r = np.abs(np.asarray(jproblem.residuals(
        ref._replace(mask=jnp.ones_like(ref.mask))))).max(axis=-1)
    knife = np.abs(r - MAX_RESIDUAL_PX) < PRUNE_KNIFE
    assert int(knife.sum()) == 0
    np.testing.assert_array_equal(got.mask.numpy()[~knife],
                                  np.asarray(ref.mask)[~knife])
    # the gauge frame is observed and every pose 0 block is finite
    assert got.mask[0].sum() >= 8 and not got.poses[0].any()
    assert torch.isfinite(schur._jacobian_blocks(got, 1.5)[0]).all()


def test_smoothing_matches_jax_on_jax_tracks(jax_run):
    seq, jintr, poses, snaps = jax_run
    ref = jwindow.smooth_trajectory_ba(snaps, poses, jintr, window=8,
                                       iterations=8)
    got = window.smooth_trajectory_ba(track_snapshots_from_numpy(snaps),
                                      poses, CameraIntrinsics(**INTR),
                                      window=8, iterations=8, device="cpu")
    assert got.shape == ref.shape and got.dtype == np.float64
    assert np.abs(got - ref).max() < SMOOTH_TOL
    gt = seq.poses[:len(poses)]
    assert ate_rmse(gt, got) < ate_rmse(gt, poses)


def test_smoothing_noop_without_tracks(jax_run):
    _, _, poses, snaps = jax_run
    dead = [s._replace(valid=np.zeros_like(s.valid))
            for s in track_snapshots_from_numpy(snaps)]
    out = window.smooth_trajectory_ba(dead, poses, CameraIntrinsics(**INTR),
                                      window=8, device="cpu")
    np.testing.assert_allclose(out, poses, atol=1e-12)


# ---- snapshots from the port's step and runner ------------------------------

@pytest.fixture(scope="module")
def course():
    seq = SyntheticStereoSequence(CameraIntrinsics(**INTR), num_frames=17,
                                  seed=0, speed=0.5)
    return seq, [seq.frame(i) for i in range(len(seq))]


def test_step_tracks_match_jax(course):
    """From JAX's state after frame 3, fed JAX's draws: frames 4..6's
    snapshots have JAX's ids and valid, and its points within TRACK_TOL."""
    _, frames = course
    jintr = JIntrinsics(**INTR)
    jcfg = JVOConfig.for_image(H, W, ransac_iterations=RANSAC)
    cfg = VOConfig.for_image(H, W, ransac_iterations=RANSAC)
    jstep = jpipeline.make_step_fn(jcfg, jintr, with_tracks=True)
    step = pipeline.make_step_fn(cfg, CameraIntrinsics(**INTR),
                                 with_tracks=True, device="cpu")
    jst = jpipeline.init_vo_state(jcfg, jintr, *frames[0])
    for i in (1, 2, 3):
        jst, _, _ = jstep(jst, *(jnp.asarray(x) for x in frames[i]))
    st = state_from_numpy(_numpy_state(jst), device="cpu")
    for i in (4, 5, 6):
        _, sub = jax.random.split(jst.key)
        u = torch.tensor(np.asarray(jax.random.uniform(
            sub, (RANSAC, cfg.padded_features))))
        jst, _, jtr = jstep(jst, *(jnp.asarray(x) for x in frames[i]))
        st, out, tr = step(st, *(torch.from_numpy(x) for x in frames[i]),
                           uniforms=u)
        ref = _np(jtr)
        np.testing.assert_array_equal(tr.ids.numpy(), ref["ids"])
        np.testing.assert_array_equal(tr.valid.numpy(), ref["valid"])
        v = ref["valid"]
        assert v.sum() > 50
        for k in ("points_l0", "points_r0", "points_l1", "points_r1"):
            assert np.abs(getattr(tr, k).numpy()[v] - ref[k][v]).max() < TRACK_TOL
        assert int(out.num_matched) == int(v.sum())


@pytest.fixture(scope="module")
def port_run(course):
    seq, frames = course
    cfg = VOConfig.for_image(H, W, ransac_iterations=RANSAC)
    out = pipeline.run_sequence_scan(frames, cfg, CameraIntrinsics(**INTR),
                                     chunk=6, warmup=False,
                                     collect_tracks=True, device="cpu")
    return seq, frames, cfg, out


def test_scan_tracks_equal_frame_by_frame(port_run):
    """One snapshot per step, frame i+1's at index i, equal to what the
    step returns frame by frame; ``valid`` counts ``num_matched``."""
    _, frames, cfg, (poses, fetched, _, n, snaps) = port_run
    assert n == len(frames) - 1 and len(snaps) == n
    intr = CameraIntrinsics(**INTR)
    step = pipeline.make_step_fn(cfg, intr, with_tracks=True, device="cpu")
    st = pipeline.init_vo_state(cfg, intr, *frames[0], device="cpu")
    for i in range(1, len(frames)):
        st, out, tr = step(st, *(torch.from_numpy(x) for x in frames[i]))
        for k, x in tr._asdict().items():
            np.testing.assert_array_equal(getattr(snaps[i - 1], k), x.numpy())
        assert int(snaps[i - 1].valid.sum()) == int(fetched.num_matched[i - 1])
    # without tracks: the JAX package's four elements, the same chain
    plain = pipeline.run_sequence_scan(frames[:5], cfg, intr, chunk=3,
                                       warmup=False, device="cpu")
    assert len(plain) == 4
    np.testing.assert_array_equal(plain[0], poses[:5])


def test_port_ba_improves_its_own_chain(port_run):
    """The bar of tests/test_ba_window.py:100 (smoothed ATE < 0.85 x chain
    ATE) on the port's own runs, pooled over RANSAC seeds 0-3. BA lands
    near one floor (0.040-0.048 m here, JAX 0.041 m) whatever the draws,
    while the chain's ATE is the draws' (0.037-0.109 m): seed 0's chain is
    already at 0.049 m (JAX's seed 0: 0.099 m), so one seed alone does not
    measure the bar."""
    seq, frames, cfg, (poses, _, _, _, snaps) = port_run
    intr = CameraIntrinsics(**INTR)
    gt = seq.poses
    chain, smooth = [], []
    for seed in range(4):
        if seed:
            poses, _, _, _, snaps = pipeline.run_sequence_scan(
                frames, cfg, intr, seed=seed, chunk=8, warmup=False,
                collect_tracks=True, device="cpu")
        smoothed = window.smooth_trajectory_ba(snaps, poses, intr, window=8,
                                               iterations=8, device="cpu")
        np.testing.assert_allclose(smoothed[0], np.eye(4), atol=1e-6)
        chain.append(ate_rmse(gt, poses))
        smooth.append(ate_rmse(gt, smoothed))
    assert sum(smooth) < 0.85 * sum(chain), (chain, smooth)


@pytest.mark.parametrize("entry", ["synthetic_ba_problem",
                                   "ba_problem_from_numpy",
                                   "build_window_problem",
                                   "smooth_trajectory_ba"])
def test_default_device_is_cuda(monkeypatch, entry):
    """Without a card and without device="cpu" the back end's entry points
    raise instead of carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    intr = CameraIntrinsics(**INTR)
    tracks = window.WindowTracks(ids=np.zeros((2, 4), np.int32),
                                 obs=np.zeros((2, 4, 3)),
                                 valid=np.ones((2, 4), bool))
    calls = {
        "synthetic_ba_problem": lambda: problem.synthetic_ba_problem(),
        "ba_problem_from_numpy": lambda: ba_problem_from_numpy(dict(
            poses=np.zeros((2, 6)), landmarks=np.zeros((1, 3)),
            observations=np.zeros((2, 1, 3)), mask=np.ones((2, 1), bool),
            fx=1.0, fy=1.0, cx=0.0, cy=0.0, bf=-1.0)),
        "build_window_problem": lambda: window.build_window_problem(
            tracks, np.tile(np.eye(4), (2, 1, 1)), intr),
        "smooth_trajectory_ba": lambda: window.smooth_trajectory_ba(
            [], np.tile(np.eye(4), (2, 1, 1)), intr),
    }
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()


# ---- the JAX package's CPU reference for chip_smoke.py's back-end phase ----

def jax_backend_reference(course: str, steps: int, height: int = 376,
                          width: int = 1241):
    """The JAX package on the CPU over the ``course`` ("loop" or "long") of
    ``steps`` steps at the bench's camera, as chip_smoke.py's back-end
    phase and scripts/backend_courses.py run the port: the chain (accept,
    ATE, budget), windowed BA with the CLI's short-course defaults and with
    the km-scale config, and on the loop course ``close_loops`` called as
    bench.py:220-222 calls it (closure before / after, ATE after)."""
    import concurrent.futures
    import os
    import time

    from bench import _kitti_intrinsics
    from visual_odom_tpu.io.synthetic import make_course
    from visual_odom_tpu.runner.loopclosure import close_loops

    jintr = _kitti_intrinsics(height, width)
    cfg = JVOConfig.for_image(height, width)
    seq = make_course(course, jintr, num_frames=steps + 1)
    with concurrent.futures.ThreadPoolExecutor(os.cpu_count() or 1) as ex:
        frames = list(ex.map(seq.frame, range(steps + 1)))
    gt = seq.poses

    def ate(poses):
        # the bench's ATE (bench.py:145-146): positions, no alignment
        err = np.linalg.norm(poses[:len(gt), :3, 3] - gt[:, :3, 3], axis=1)
        return float(np.sqrt(np.mean(err ** 2)))

    t = time.perf_counter()
    poses, fetched, _, n, snaps = jpipeline.run_sequence_scan(
        frames, cfg, jintr, chunk=16, collect_tracks=True)
    snaps = [jax.tree.map(np.asarray, s) for s in snaps]
    course_len = float(np.sum(np.linalg.norm(np.diff(gt[:, :3, 3], axis=0),
                                             axis=1)))
    res = {"course": course, "image": f"{width}x{height}", "steps": n,
           "scan_s": time.perf_counter() - t,
           "accept": float(np.mean(fetched.accept)),
           "ate_chain_m": ate(poses), "ate_budget_m": 0.01 * course_len}
    for name, kw in (("ba", {}), ("ba_km", dict(window=16, max_landmarks=384,
                                                 min_track_len=5,
                                                 huber_delta=0.8))):
        t = time.perf_counter()
        smoothed = jwindow.smooth_trajectory_ba(snaps, poses[:n + 1], jintr,
                                                **kw)
        res[f"ate_{name}_m"] = ate(smoothed)
        res[f"{name}_s"] = time.perf_counter() - t
    if course == "loop":
        lf = seq.loop_frame
        t = time.perf_counter()
        pg, info = close_loops(poses[:len(gt)], lambda i: frames[i], cfg,
                               jintr, gt_loop_pair=(0, lf))
        res.update(loop_frame=lf, loop_s=time.perf_counter() - t,
                   loop_edges=info.edges, candidates=len(info.candidates),
                   closure_before_m=info.closure_before_m,
                   closure_after_m=info.closure_after_m, ate_pg_m=ate(pg))
    return res


if __name__ == "__main__":
    import json
    import sys

    print(json.dumps(jax_backend_reference(sys.argv[1], int(sys.argv[2]))))
