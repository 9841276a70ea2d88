"""The port's evaluation, utilities, cameras and public helpers against the
JAX package's.

The counterparts of tests/test_eval.py and tests/test_devkit.py:

- ``eval.kitti_eval`` equals JAX's exactly on seeded random trajectories
  of more than 120 m (so 100 m segments exist);
- the devkit's files (errors, path and error plot data, ``stats.txt``) and
  ``eval_all``'s results and stdout equal JAX's byte for byte; the plots
  are written where matplotlib imports;
- ``Notifier``, ``load_gyro`` / ``integrate_gyro``, ``FakeCamera`` and
  ``ImageDirCamera`` equal JAX's; ``V4L2StereoCamera`` refuses a missing
  device node;
- ``Frame`` triangulates as JAX's, within tests/test_torch_geometry.py's
  triangulation bound;
- the public helpers at 120x160: ``pyr_down``, ``build_pyramid``,
  ``build_pyramid_with_derivs`` and ``scharr_derivatives`` within the
  pyramid tolerance of tests/test_torch_ops.py; ``euler_to_rotation``,
  ``is_rotation_matrix``, ``stereo_depth_from_disparity``, ``pose_delta``
  and ``integrate_pose_host`` within 1e-6.
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_odom_tpu.backend import integrate as jintegrate
from visual_odom_tpu.config import CameraIntrinsics as JIntrinsics
from visual_odom_tpu.core import lie as jlie
from visual_odom_tpu.core import triangulate as jtri
from visual_odom_tpu.core.frame import Frame as JFrame
from visual_odom_tpu.eval import devkit as jdevkit
from visual_odom_tpu.eval import kitti_eval as jeval
from visual_odom_tpu.io import camera as jcamera
from visual_odom_tpu.io import gyro as jgyro
from visual_odom_tpu.ops import pyramid as jpyramid
from visual_odom_tpu.utils import notify as jnotify
from visual_odom_tpu_torch.backend import integrate
from visual_odom_tpu_torch.config import CameraIntrinsics
from visual_odom_tpu_torch.core import lie, triangulate
from visual_odom_tpu_torch.core.frame import Frame
from visual_odom_tpu_torch.eval import devkit, kitti_eval
from visual_odom_tpu_torch.io import camera, gyro, kitti
from visual_odom_tpu_torch.ops import pyramid
from visual_odom_tpu_torch.utils import notify

torch.set_num_threads(1)

#: pyramid planes: 2 float32 ulps at 255 (tests/test_torch_ops.py)
PLANE_TOL = 2.0 ** -15
#: the small geometric helpers
HELPER_TOL = 1e-6
#: triangulation, relative (tests/test_torch_geometry.py): the float32
#: normal equations of the DLT lie up to ~3e-4 from float64 in JAX itself
#: at KITTI baselines, so the port is held to TRI_REL of JAX and to twice
#: JAX's own float32 error
TRI_REL = 1e-3


def _trajectory(n, seed, noise=0.0):
    """(n, 4, 4) poses of a car-like path, ~1.2 m a frame, slow yaw; with
    ``noise`` a drifting estimate of it."""
    rng = np.random.default_rng(seed)
    poses = np.tile(np.eye(4), (n, 1, 1))
    yaw = 0.0
    for i in range(1, n):
        yaw += rng.normal(scale=0.02)
        step = np.eye(4)
        c, s = np.cos(yaw), np.sin(yaw)
        step[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
        step[:3, 3] = [rng.normal(scale=0.05), rng.normal(scale=0.01),
                       1.2 + rng.normal(scale=0.1)]
        poses[i] = poses[i - 1] @ step
    if noise:
        drift = np.cumsum(rng.normal(scale=noise, size=(n, 3)), axis=0)
        poses[:, :3, 3] += drift
    return poses


@pytest.fixture(scope="module")
def trajectories():
    gt = _trajectory(260, seed=0)
    res = gt.copy()
    res[:, :3, 3] += np.cumsum(np.random.default_rng(1).normal(
        scale=0.05, size=(260, 3)), axis=0)
    assert jeval.trajectory_distances(gt)[-1] > 120.0
    return gt, res


def test_kitti_eval_equals_jax(trajectories):
    gt, res = trajectories
    np.testing.assert_array_equal(kitti_eval.trajectory_distances(gt),
                                  jeval.trajectory_distances(gt))
    errs = kitti_eval.calc_sequence_errors(gt, res)
    jerrs = jeval.calc_sequence_errors(gt, res)
    assert len(errs) == len(jerrs) > 10
    assert ([dataclasses.astuple(e) for e in errs]
            == [dataclasses.astuple(e) for e in jerrs])
    assert kitti_eval.average_errors(errs) == jeval.average_errors(jerrs)
    assert kitti_eval.ate_rmse(gt, res) == jeval.ate_rmse(gt, res)
    for delta in (1, 5):
        assert (kitti_eval.rpe_errors(gt, res, delta)
                == jeval.rpe_errors(gt, res, delta))
    assert (kitti_eval.evaluate_sequence(gt, res)
            == jeval.evaluate_sequence(gt, res))
    assert kitti_eval.LENGTHS == jeval.LENGTHS
    assert kitti_eval.STEP_SIZE == jeval.STEP_SIZE
    assert kitti_eval.average_errors([])[0] != kitti_eval.average_errors([])[0]


def _tree(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def test_devkit_files_equal_jax(trajectories, tmp_path):
    gt, res = trajectories
    errs = devkit.eval_sequence_artifacts(gt, res, str(tmp_path / "port"),
                                          "07", plots=False)
    jerrs = jdevkit.eval_sequence_artifacts(gt, res, str(tmp_path / "jax"),
                                            "07", plots=False)
    assert [dataclasses.astuple(e) for e in errs] == [
        dataclasses.astuple(e) for e in jerrs]
    devkit.save_stats(errs, str(tmp_path / "port"))
    jdevkit.save_stats(jerrs, str(tmp_path / "jax"))
    port, jax_files = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert sorted(port) == sorted(jax_files) == sorted(
        ["errors/07.txt", "plot_path/07.txt", "stats.txt"]
        + [f"plot_error/07_{s}.txt" for s in ("tl", "rl", "ts", "rs")])
    assert port == jax_files
    assert port["errors/07.txt"].count(b"\n") == len(errs)


def test_eval_all_equals_jax(trajectories, tmp_path, capsys):
    gt, res = trajectories
    gt_dir, res_dir = tmp_path / "gt", tmp_path / "res"
    os.makedirs(gt_dir), os.makedirs(res_dir)
    for i, seq in enumerate(("00", "01")):
        kitti.save_poses_kitti(str(gt_dir / f"{seq}.txt"), gt)
        kitti.save_poses_kitti(str(res_dir / f"{seq}.txt"),
                               _trajectory(260, seed=0, noise=0.02 * (i + 1)))
    kitti.save_poses_kitti(str(res_dir / "02.txt"), res)   # no ground truth
    capsys.readouterr()
    got = devkit.eval_all(str(gt_dir), str(res_dir), str(tmp_path / "port"),
                          plots=False)
    out = capsys.readouterr().out
    want = jdevkit.eval_all(str(gt_dir), str(res_dir), str(tmp_path / "jax"),
                            plots=False)
    assert out == capsys.readouterr().out
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)
    assert set(got) == {"00", "01", "avg"}
    assert "skipping sequence 02" in out
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")


def test_devkit_writes_plots(trajectories, tmp_path):
    pytest.importorskip("matplotlib")
    gt, res = trajectories
    devkit.eval_sequence_artifacts(gt, res, str(tmp_path), "03", plots=True)
    for f in (["plot_path/03.png"]
              + [f"plot_error/03_{s}.png" for s in ("tl", "rl", "ts", "rs")]):
        assert (tmp_path / f).stat().st_size > 0


def test_notifier_equals_jax(capsys):
    with notify.Notifier() as n:
        n.msg("plain %s %d", "line", 3)
        n.msg("no args %s")
    port = capsys.readouterr().out
    with jnotify.Notifier() as n:
        n.msg("plain %s %d", "line", 3)
        n.msg("no args %s")
    assert port == capsys.readouterr().out == "plain line 3\nno args %s\n"
    a = notify.Notifier(email="someone@example.com")
    a.msg("buffered")
    assert a._lines == ["buffered"]


def test_gyro_equals_jax(tmp_path):
    p = tmp_path / "gyro.txt"
    p.write_text("0.0 0.1 0.0 -0.2\n1.0 0.1 0.0 -0.2\nbad row here x\n"
                 "2.0 0.3 0.0 0.0 extra\n\n3 1\n")
    g, jg = gyro.load_gyro(str(p)), jgyro.load_gyro(str(p))
    np.testing.assert_array_equal(g, jg)
    assert g.shape == (3, 4)
    np.testing.assert_array_equal(gyro.integrate_gyro(g),
                                  jgyro.integrate_gyro(jg))
    assert gyro.integrate_gyro(g)[2, 2] == pytest.approx(-0.3)
    empty = tmp_path / "empty.txt"
    empty.write_text("\n")
    assert gyro.load_gyro(str(empty)).shape == (0, 4)
    np.testing.assert_array_equal(gyro.integrate_gyro(g[:1]),
                                  jgyro.integrate_gyro(jg[:1]))


def _pairs(n=3, seed=0):
    rng = np.random.default_rng(seed)
    return [tuple(rng.integers(0, 256, (12, 16), np.uint8) for _ in range(2))
            for _ in range(n)]


def _drain(cam, n):
    return [cam.get_lr_frames() for _ in range(n)]


def test_cameras_equal_jax(tmp_path, monkeypatch):
    pairs = _pairs()
    for loop in (False, True):
        cam, jcam = camera.FakeCamera(pairs, loop), jcamera.FakeCamera(
            pairs, loop)
        got, want = _drain(cam, 3), _drain(jcam, 3)
        if loop:
            got, want = got + _drain(cam, 2), want + _drain(jcam, 2)
        else:
            with pytest.raises(StopIteration):
                cam.get_lr_frames()
        for (a, b), (c, d) in zip(got, want):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, d)
    # a KITTI directory through ImageDirCamera, saving what it hands out
    from PIL import Image

    for d in ("image_0", "image_1"):
        os.makedirs(tmp_path / "seq" / d)
    for i, (l, r) in enumerate(pairs):
        Image.fromarray(l).save(tmp_path / "seq" / "image_0" / f"{i:06d}.png")
        Image.fromarray(r).save(tmp_path / "seq" / "image_1" / f"{i:06d}.png")
    monkeypatch.setenv("SAVE_FRAMES", "1")
    monkeypatch.setenv("SAVE_FRAMES_DIR", str(tmp_path / "saved"))
    cam = camera.ImageDirCamera(str(tmp_path / "seq"))
    got = _drain(cam, 3)
    with pytest.raises(StopIteration):
        cam.get_lr_frames()
    monkeypatch.setenv("SAVE_FRAMES_DIR", str(tmp_path / "jsaved"))
    want = _drain(jcamera.ImageDirCamera(str(tmp_path / "seq")), 3)
    for (a, b), (c, d), (e, f) in zip(got, want, pairs):
        for x, y, z in ((a, c, e), (b, d, f)):
            np.testing.assert_array_equal(x, y)
            np.testing.assert_array_equal(x, z)
    assert sorted(os.listdir(tmp_path / "saved")) == sorted(
        os.listdir(tmp_path / "jsaved")) == sorted(
        f"{s}{i:06d}.png" for s in ("left", "right") for i in range(3))
    np.testing.assert_array_equal(
        kitti._imread_gray(str(tmp_path / "saved" / "right000002.png")),
        pairs[2][1])


def test_v4l2_camera_refuses_missing_node(tmp_path):
    node = str(tmp_path / "video9")
    with pytest.raises(FileNotFoundError, match="not present"):
        camera.V4L2StereoCamera(node)
    with pytest.raises(FileNotFoundError, match="not present"):
        jcamera.V4L2StereoCamera(node)


def test_frame_triangulation_matches_jax():
    kw = dict(fx=718.856, fy=718.856, cx=607.1928, cy=185.2157,
              bf=-386.1448)
    intr, jintr = CameraIntrinsics(**kw), JIntrinsics(**kw)
    P_l, P_r = intr.proj_left(), intr.proj_right()
    np.testing.assert_array_equal(P_l, jintr.proj_left())
    rng = np.random.default_rng(7)
    pts3d = np.stack([rng.uniform(-8, 8, 64), rng.uniform(-2, 2, 64),
                      rng.uniform(5, 60, 64)], -1)

    def proj(P):
        x = np.c_[pts3d, np.ones(64)] @ P.T
        return x[:, :2] / x[:, 2:]

    world = np.eye(4)
    world[:3, :3] = np.asarray(jlie.rodrigues(jnp.array([0.1, -0.2, 0.05])))
    world[:3, 3] = [5.0, 0.0, -2.0]
    fr, jfr = Frame(0, P_l, P_r, world), JFrame(0, P_l, P_r, world)
    with pytest.raises(ValueError):
        fr.triangulate_feature_points(device="cpu")
    for f in (fr, jfr):
        f.set_features(proj(P_l), proj(P_r))
    got = fr.triangulate_feature_points(device="cpu")
    want = jfr.triangulate_feature_points()
    exact = triangulate.triangulate_points(
        *(torch.from_numpy(np.asarray(a, np.float64))
          for a in (P_l, P_r, fr.points_left, fr.points_right))).numpy()
    assert got.dtype == np.float32 and got.shape == (64, 3)

    def rel(a, b):
        return np.linalg.norm(a - b, axis=1) / np.linalg.norm(b, axis=1)

    assert rel(got, want).max() < TRI_REL
    assert rel(got, exact).max() <= 2.0 * rel(want, exact).max() + 1e-6
    np.testing.assert_allclose(got, pts3d, rtol=1e-2)
    gw, jw = fr.points_world(device="cpu"), jfr.points_world()
    assert rel(gw - world[:3, 3], jw - world[:3, 3]).max() < TRI_REL
    assert fr.valid.all() and fr.valid.shape == (64,)


def _image(seed=3, shape=(120, 160)):
    return np.random.default_rng(seed).uniform(0, 255, shape).astype(
        np.float32)


def test_pyramid_helpers_match_jax():
    img = _image()
    t = torch.from_numpy(img)
    for got, want in ((pyramid.pyr_down(t), jpyramid.pyr_down(jnp.asarray(img))),
                      *zip(pyramid.scharr_derivatives(t),
                           jpyramid.scharr_derivatives(jnp.asarray(img)))):
        want = np.asarray(want)
        assert got.shape == want.shape
        assert np.abs(got.numpy() - want).max() <= PLANE_TOL
    pyr = pyramid.build_pyramid(t, 3)
    jpyr = jpyramid.build_pyramid(jnp.asarray(img), 3)
    assert [tuple(p.shape) for p in pyr] == [(120, 160), (60, 80), (30, 40),
                                             (15, 20)]
    for g, w in zip(pyr, jpyr):
        assert np.abs(g.numpy() - np.asarray(w)).max() <= PLANE_TOL
    got = pyramid.build_pyramid_with_derivs(t, 3)
    want = jpyramid.build_pyramid_with_derivs(jnp.asarray(img), 3)
    for gs, ws in zip(got, want):
        assert len(gs) == len(ws) == 4
        for g, w in zip(gs, ws):
            assert np.abs(g.numpy() - np.asarray(w)).max() <= PLANE_TOL
    # batched images give each image's pyramid
    two = torch.from_numpy(np.stack([img, _image(4)]))
    np.testing.assert_array_equal(pyramid.pyr_down(two)[0].numpy(),
                                  pyramid.pyr_down(t).numpy())


def test_geometry_helpers_match_jax():
    rng = np.random.default_rng(11)
    euler = rng.uniform(-0.5, 0.5, (16, 3)).astype(np.float32)
    R = lie.euler_to_rotation(torch.from_numpy(euler))
    jR = np.asarray(jlie.euler_to_rotation(jnp.asarray(euler)))
    assert np.abs(R.numpy() - jR).max() < HELPER_TOL
    bad = R.clone()
    bad[3] *= 1.01
    np.testing.assert_array_equal(
        lie.is_rotation_matrix(bad, 1e-4).numpy(),
        np.asarray(jlie.is_rotation_matrix(jnp.asarray(bad.numpy()), 1e-4)))
    assert lie.is_rotation_matrix(bad, 1e-4).sum() == 15

    pts = rng.uniform(0, 160, (32, 2)).astype(np.float32)
    disp = rng.uniform(-1, 40, 32).astype(np.float32)
    z = triangulate.stereo_depth_from_disparity(
        torch.from_numpy(pts), torch.from_numpy(disp), 718.856, 0.537)
    jz = np.asarray(jtri.stereo_depth_from_disparity(
        jnp.asarray(pts), jnp.asarray(disp), 718.856, 0.537))
    assert np.max(np.abs(z.numpy() - jz) / np.abs(jz)) < HELPER_TOL

    rvec = np.array([0.01, -0.02, 0.005], np.float32)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [1.0, 2.0, 3.0]
    for tvec in ([0.1, 0.0, 1.0], [0.0, 0.0, 0.01]):   # accepted, rejected
        tvec = np.array(tvec, np.float32)
        gate = integrate.gate_and_integrate(torch.from_numpy(rvec),
                                            torch.from_numpy(tvec))
        jgate = jintegrate.gate_and_integrate(jnp.asarray(rvec),
                                              jnp.asarray(tvec))
        assert bool(gate.accept) == bool(jgate.accept)
        got = integrate.pose_delta(torch.from_numpy(pose), gate).numpy()
        want = np.asarray(jintegrate.pose_delta(jnp.asarray(pose), jgate))
        assert np.abs(got - want).max() < HELPER_TOL
        host = integrate.integrate_pose_host(pose.astype(np.float64),
                                             gate.T_inv.numpy(),
                                             bool(gate.accept))
        jhost = jintegrate.integrate_pose_host(
            pose.astype(np.float64), np.asarray(jgate.T_inv),
            bool(jgate.accept))
        assert host.dtype == np.float64
        assert np.abs(host - jhost).max() < HELPER_TOL
