"""The port's ring-sharded sequence-parallel BA
(``visual_odom_tpu_torch/parallel/ring_ba.py``) on CPU device lists, against
the port's ``ba_solve`` and the JAX package's ``ring_ba_solve`` on the
conftest's 8-device CPU mesh.

- The counterparts of tests/test_ring_ba.py (windowing, masks, the solve on
  4 and 8 windows, the hard gauge, one window, the halo check, auto halo
  with Huber, padding, the anchor prior), each ring solve also against
  JAX's ``ring_ba_solve`` on the same ``seq`` size: 1e-4, or 5e-4 with
  Huber (tests/test_ring_ba.py:71, 128).
- ``make_ring_windows``' errors word for word JAX's.
- The counterparts of tests/test_ba_window.py:105-164 on the port's own
  17-frame run: smoothing with ``make_ring_window_solver`` against the
  default solver and against JAX's ring smoothing of the same snapshots
  (5e-4), and, with short tracks, a window problem that takes the ring
  branch; ``solver.branches`` says which branch each problem took.

About 45 s alone.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from visual_odom_tpu.ba import problem as jproblem
from visual_odom_tpu.ba import schur as jschur
from visual_odom_tpu.ba import window as jwindow
from visual_odom_tpu.config import CameraIntrinsics as JIntrinsics
from visual_odom_tpu.parallel import ring_ba as jring
from visual_odom_tpu.parallel.mesh import make_mesh as jax_mesh
from visual_odom_tpu_torch.ba import problem, schur, window
from visual_odom_tpu_torch.config import CameraIntrinsics, VOConfig
from visual_odom_tpu_torch.interop import ba_problem_from_numpy
from visual_odom_tpu_torch.io.synthetic import SyntheticStereoSequence
from visual_odom_tpu_torch.parallel import ring_ba
from visual_odom_tpu_torch.parallel.mesh import make_mesh
from visual_odom_tpu_torch.runner import pipeline

# Small tensors: one intra-op thread each keeps the parallel test workers
# from oversubscribing the cores.
torch.set_num_threads(1)

#: ring vs global solve: tests/test_ring_ba.py:71 (and :128 with Huber)
RING_TOL = 1e-4
HUBER_TOL = 5e-4
#: smoothed trajectories and ring vs global on live tracks
#: (tests/test_ba_window.py:122, :160)
SMOOTH_TOL = 5e-4
H, W = 120, 160
INTR = dict(fx=120.0, fy=120.0, cx=W / 2, cy=H / 2, bf=-120.0 * 0.54,
            width=W, height=H)
CPU = torch.device("cpu")


def _long_problem(num_poses=16, num_landmarks=128, seed=3, obs_window=1):
    """tests/test_ring_ba.py's problem, in both packages."""
    jp, gt, _ = jproblem.synthetic_ba_problem(
        num_poses=num_poses, num_landmarks=num_landmarks, pixel_noise=0.2,
        pose_perturb=0.015, landmark_perturb=0.08, seed=seed,
        obs_window=obs_window)
    return jp, _port(jp), gt


def _port(jp):
    return ba_problem_from_numpy({k: np.asarray(v)
                                  for k, v in jp._asdict().items()},
                                 device="cpu")


def _seq_mesh(n):
    return make_mesh({"seq": n}, devices=[CPU] * n)


def _jax_seq_mesh(n):
    return jax_mesh({"seq": n}, devices=jax.devices()[:n])


def test_windowing_roundtrip_identity():
    _, p, _ = _long_problem(num_poses=8, num_landmarks=32)
    win = ring_ba.make_ring_windows(p, num_windows=4, halo=2)
    out = ring_ba.merge_ring_windows(p, win, win.poses, win.landmarks)
    assert torch.equal(out.poses, p.poses)
    assert torch.equal(out.landmarks, p.landmarks)


def test_windows_equal_jax_and_cover_each_obs_once():
    jp, p, _ = _long_problem(num_poses=8, num_landmarks=32)
    win = ring_ba.make_ring_windows(p, num_windows=4, halo=2)
    ref = jring.make_ring_windows(jp, num_windows=4, halo=2)
    for k in ("poses", "landmarks", "observations", "mask", "pose_valid"):
        np.testing.assert_array_equal(getattr(win, k).numpy(),
                                      np.asarray(getattr(ref, k)), k)
    assert (win.core, win.halo) == (ref.core, ref.halo)
    core_mask = win.mask[:, win.halo:win.halo + win.core].numpy()
    np.testing.assert_array_equal(
        core_mask.reshape(-1, core_mask.shape[-1]), p.mask.numpy())


@pytest.fixture(scope="module")
def long_problem():
    return _long_problem()


@pytest.mark.parametrize("num_windows", [4, 8])
def test_ring_ba_matches_global_solve_and_jax(long_problem, num_windows):
    jp, p, gt = long_problem
    ref = schur.ba_solve(p, iterations=10)
    out = ring_ba.ring_ba_solve(p, _seq_mesh(num_windows), halo=2, rounds=10)
    jout = jring.ring_ba_solve(jp, _jax_seq_mesh(num_windows), halo=2,
                               rounds=10)
    c0 = float(problem.total_cost(p))
    c_ref = float(problem.total_cost(ref))
    c_ring = float(problem.total_cost(out))
    assert c_ring < 0.05 * c0, (c0, c_ring)
    assert abs(c_ring - c_ref) < 0.01 * c_ref + 1e-3
    assert np.abs(out.poses.numpy() - ref.poses.numpy()).max() < RING_TOL
    assert np.abs(out.poses.numpy() - np.asarray(jout.poses)).max() < RING_TOL
    err_ring = np.abs(out.poses.numpy() - gt).max()
    err_ref = np.abs(ref.poses.numpy() - gt).max()
    assert err_ring < err_ref * 1.05 + 1e-4, (err_ring, err_ref)


def test_ring_ba_gauge_pose_fixed(long_problem):
    _, p, _ = long_problem
    out = ring_ba.ring_ba_solve(p, _seq_mesh(8), halo=2, rounds=6)
    assert torch.equal(out.poses[0], p.poses[0])


def test_ring_ba_single_window_degenerates_to_local():
    jp, p, _ = _long_problem(num_poses=8, num_landmarks=64)
    out = ring_ba.ring_ba_solve(p, _seq_mesh(1), halo=0, rounds=10)
    ref = schur.ba_solve(p, iterations=10)
    jout = jring.ring_ba_solve(jp, _jax_seq_mesh(1), halo=0, rounds=10)
    assert np.abs(out.poses.numpy() - ref.poses.numpy()).max() < RING_TOL
    assert np.abs(out.poses.numpy() - np.asarray(jout.poses)).max() < RING_TOL


def _message(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    raise AssertionError("no ValueError")


@pytest.mark.parametrize("case", ["span", "divisible", "halo_over_core"])
def test_window_errors_equal_jax(case):
    """An undersized halo raises (tests/test_ring_ba.py:98-109), as do an
    indivisible pose count and a halo over the core; the texts are JAX's."""
    jp, p, _ = _long_problem(obs_window=2)     # tracks span up to 5 poses
    assert ring_ba.required_ring_halo(p) == jring.required_ring_halo(jp) == 4
    windows, halo = {"span": (4, 1), "divisible": (3, 1),
                     "halo_over_core": (4, 5)}[case]
    got = _message(lambda: ring_ba.make_ring_windows(p, windows, halo=halo))
    assert got == _message(lambda: jring.make_ring_windows(jp, windows,
                                                           halo=halo))
    if case == "span":
        assert "span" in got
        ring_ba.make_ring_windows(p, num_windows=4, halo=4)


def test_ring_ba_auto_halo_and_huber_match_global_and_jax():
    jp, _, _ = _long_problem(obs_window=1)
    obs = np.asarray(jp.observations).copy()
    w, l = np.argwhere(np.asarray(jp.mask))[0]
    obs[w, l, :2] += 25.0
    jp = jp._replace(observations=jnp.asarray(obs))
    p = _port(jp)
    ref = schur.ba_solve(p, iterations=8, huber_delta=1.5)
    out = ring_ba.ring_ba_solve(p, _seq_mesh(8), halo=None, rounds=8,
                                huber_delta=1.5)
    jout = jring.ring_ba_solve(jp, _jax_seq_mesh(8), halo=None, rounds=8,
                               huber_delta=1.5)
    assert np.abs(out.poses.numpy() - ref.poses.numpy()).max() < HUBER_TOL
    assert np.abs(out.poses.numpy() - np.asarray(jout.poses)).max() < HUBER_TOL


def test_pad_problem_for_ring_is_inert():
    """Padded observation-less poses take a zero GN update; the core
    solution matches the unpadded solve and JAX's padded ring solve."""
    jp, p, _ = _long_problem(num_poses=12, num_landmarks=64)
    padded = ring_ba.pad_problem_for_ring(p, 16)
    jpadded = jring.pad_problem_for_ring(jp, 16)
    for k in ("poses", "observations", "mask"):
        np.testing.assert_array_equal(getattr(padded, k).numpy(),
                                      np.asarray(getattr(jpadded, k)), k)
    out = ring_ba.ring_ba_solve(padded, _seq_mesh(4), halo=2, rounds=8)
    ref = schur.ba_solve(p, iterations=8)
    jout = jring.ring_ba_solve(jpadded, _jax_seq_mesh(4), halo=2, rounds=8)
    assert np.abs(out.poses[:12].numpy() - ref.poses.numpy()).max() < RING_TOL
    assert np.abs(out.poses.numpy() - np.asarray(jout.poses)).max() < RING_TOL
    # the padded poses never moved
    assert torch.equal(out.poses[12:], padded.poses[12:])
    assert ring_ba.pad_problem_for_ring(p, 12) is p


def test_anchor_prior_pulls_pose_toward_anchor_as_jax():
    """tests/test_ring_ba.py:145-176 on the port's step, against JAX's."""
    jp, p, _ = _long_problem(num_poses=4, num_landmarks=48, obs_window=None)
    Wp = p.poses.shape[0]
    default = schur.ba_gauss_newton_step(p)
    aw0 = torch.zeros(Wp)
    aw0[0] = 1e9
    explicit = schur.ba_gauss_newton_step(p, anchor=p.poses, anchor_w=aw0)
    np.testing.assert_allclose(default.poses.numpy(), explicit.poses.numpy(),
                               atol=1e-7)
    target = p.poses.numpy().copy()
    target[2, 3] += 0.05
    aw = np.zeros(Wp, np.float32)
    aw[0], aw[2] = 1e9, 1e5
    got = schur.ba_gauss_newton_step(p, anchor=torch.from_numpy(target),
                                     anchor_w=torch.from_numpy(aw))
    ref = jschur.ba_gauss_newton_step(jp, anchor=jnp.asarray(target),
                                      anchor_w=jnp.asarray(aw))
    d_anchored = abs(float(got.poses[2, 3]) - target[2, 3])
    d_default = abs(float(default.poses[2, 3]) - target[2, 3])
    assert d_anchored < d_default and d_anchored < 0.01
    assert np.abs(got.poses.numpy() - np.asarray(ref.poses)).max() < 1e-3


# ---- windowed smoothing with the ring solver (tests/test_ba_window.py) --------


def _run(age_threshold=None):
    intr = CameraIntrinsics(**INTR)
    kw = {} if age_threshold is None else dict(age_threshold=age_threshold)
    cfg = VOConfig.for_image(H, W, ransac_iterations=200, **kw)
    seq = SyntheticStereoSequence(intr, num_frames=17, seed=0, speed=0.5)
    poses, _, _, _, snaps = pipeline.run_sequence_scan(
        iter(seq), cfg, intr, chunk=8, collect_tracks=True, warmup=False,
        device="cpu")
    return seq, intr, poses, snaps


@pytest.fixture(scope="module")
def vo_run():
    return _run()


def test_ba_smoothing_with_ring_solver_exact(vo_run):
    """The ring solver smooths as the default solver does and as JAX's ring
    solver does on the same snapshots (a 4-window ring over 8-frame
    windows: every window here falls back to ``ba_solve``)."""
    seq, intr, poses, snaps = vo_run
    solver = ring_ba.make_ring_window_solver(_seq_mesh(4))
    ref = window.smooth_trajectory_ba(snaps, poses, intr, window=8,
                                      iterations=8, device="cpu")
    ring = window.smooth_trajectory_ba(snaps, poses, intr, window=8,
                                       solver=solver, device="cpu")
    jax_ring = jwindow.smooth_trajectory_ba(
        snaps, poses, JIntrinsics(**INTR), window=8,
        solver=jring.make_ring_window_solver(_jax_seq_mesh(4)))
    np.testing.assert_allclose(ring, ref, atol=SMOOTH_TOL)
    np.testing.assert_allclose(ring, jax_ring, atol=SMOOTH_TOL)
    gt = seq.poses[:len(poses)]
    from visual_odom_tpu_torch.eval.kitti_eval import ate_rmse
    assert ate_rmse(gt, ring) < ate_rmse(gt, poses)
    assert solver.branches["single"] == len(poses) // 8
    assert solver.branches["ring"] == 0


def test_ring_window_solver_engages_ring_path():
    """Short-lived tracks (age cap 4) keep the halo within a 2-window
    ring's core of 8: the ring branch runs, and matches ``ba_solve`` and
    JAX's ring solve of the same problem."""
    _, intr, poses, snaps = _run(age_threshold=4)
    prob = window.build_window_problem(window.window_tracks(snaps,
                                                            list(range(16))),
                                       poses[:16], intr, device="cpu")
    assert prob is not None
    halo = ring_ba.required_ring_halo(prob)
    assert halo <= 16 // 2, f"halo {halo} > core 8: ring path untested"
    mesh = _seq_mesh(2)
    ring = ring_ba.ring_ba_solve(prob, mesh, halo=None, rounds=8,
                                 huber_delta=1.5)
    ref = schur.ba_solve(prob, iterations=8, huber_delta=1.5)
    jp = jproblem.BAProblem(**{k: (jnp.asarray(v.numpy())
                                   if isinstance(v, torch.Tensor) else v)
                               for k, v in prob._asdict().items()})
    jout = jring.ring_ba_solve(jp, _jax_seq_mesh(2), halo=None, rounds=8,
                               huber_delta=1.5)
    assert np.abs(ring.poses.numpy() - ref.poses.numpy()).max() < SMOOTH_TOL
    assert np.abs(ring.poses.numpy() - np.asarray(jout.poses)).max() < SMOOTH_TOL
    solver = ring_ba.make_ring_window_solver(mesh)
    solved = solver(prob)
    assert solver.branches == {"ring": 1, "single": 0}
    assert np.abs(solved.poses.numpy() - ring.poses.numpy()).max() < SMOOTH_TOL


def test_one_device_solver_takes_the_single_branch_bit_for_bit(vo_run):
    """A one-device ring (what the CLI's ``--ba-ring`` builds on one card or
    the CPU) is ``ba_solve`` at the solver's rounds and Huber delta."""
    _, intr, poses, snaps = vo_run
    prob = window.build_window_problem(window.window_tracks(snaps,
                                                            list(range(8))),
                                       poses[:8], intr, device="cpu")
    solver = ring_ba.make_ring_window_solver(_seq_mesh(1))
    got = solver(prob)
    ref = schur.ba_solve(prob, iterations=8, huber_delta=1.5)
    assert torch.equal(got.poses, ref.poses)
    assert solver.branches == {"ring": 0, "single": 1}
