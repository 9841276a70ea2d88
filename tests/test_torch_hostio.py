"""The port's host I/O against the JAX package's, byte for byte.

``MetricsLogger`` lines (but their ``t``), ``save_poses_kitti`` and
``PoseWriter`` files, ``load_poses`` arrays, ``render_trajectory``,
``render_tracks``, an offscreen ``LiveDisplay``'s canvases and ``save_png``
files equal JAX's, with cv2 present and with cv2 hidden
(``sys.modules["cv2"] = None``, so ``import cv2`` fails in both).
"""

import json
import sys
from typing import NamedTuple

import numpy as np
import pytest
import torch

from visual_odom_tpu.eval import plot as jplot
from visual_odom_tpu.io import kitti as jkitti
from visual_odom_tpu.utils import metrics as jmetrics
from visual_odom_tpu_torch.eval import plot
from visual_odom_tpu_torch.io import kitti
from visual_odom_tpu_torch.utils import metrics

torch.set_num_threads(1)


class Tracks(NamedTuple):
    points_l0: np.ndarray
    points_l1: np.ndarray
    valid: np.ndarray


def _poses(n=12, seed=0):
    rng = np.random.default_rng(seed)
    poses = np.tile(np.eye(4), (n, 1, 1))
    for i in range(1, n):
        a = rng.normal(scale=0.05, size=3)
        c, s = np.cos(a[1]), np.sin(a[1])
        step = np.eye(4)
        step[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
        step[:3, 3] = rng.normal(scale=[0.3, 0.02, 1.5]) + [0, 0, 8]
        poses[i] = poses[i - 1] @ step
    poses[3, 0, 3] = 1e6                 # off the canvas
    return poses


def _frame_and_tracks(seed=0, h=120, w=160, n=64):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w), dtype=np.uint8)
    p0 = rng.uniform([-3, -3], [w + 3, h + 3], (n, 2)).astype(np.float32)
    p1 = p0 + rng.normal(scale=2.0, size=(n, 2)).astype(np.float32)
    return img, Tracks(p0, p1, rng.random(n) > 0.2)


@pytest.fixture(params=["cv2", "no_cv2"])
def cv2_mode(request, monkeypatch):
    if request.param == "no_cv2":
        monkeypatch.setitem(sys.modules, "cv2", None)
    return request.param


def test_metrics_lines_equal_jax(tmp_path):
    records = [
        {"frame_id": 1, "accept": np.bool_(True), "scale": np.float32(0.81),
         "num_inliers": np.int32(61), "pose": None, "name": "a"},
        {"frame_id": 2, "scale": torch.tensor(0.5), "euler": [0.1, 0.2],
         "num_matched": torch.tensor(7, dtype=torch.int32), "x": 1.5e-9},
    ]
    files = {}
    for name, mod in (("jax", jmetrics), ("port", metrics)):
        path = tmp_path / f"{name}.jsonl"
        logger = mod.MetricsLogger(str(path))
        for r in records:
            logger.log(r)
        logger.close()
        files[name] = path.read_text().splitlines()
    assert len(files["port"]) == len(records)
    for a, b in zip(files["jax"], files["port"]):
        assert list(json.loads(b))[0] == "t"
        assert a.split(", ", 1)[1] == b.split(", ", 1)[1]


def test_pose_files_equal_jax(tmp_path):
    poses = _poses()
    kitti.save_poses_kitti(str(tmp_path / "port.txt"), poses)
    jkitti.save_poses_kitti(str(tmp_path / "jax.txt"), poses)
    for name, mod in (("port_w", kitti), ("jax_w", jkitti)):
        w = mod.PoseWriter(str(tmp_path / f"{name}.txt"))
        for p in poses:
            w.append(p)
        w.close()
    texts = {p.stem: p.read_bytes() for p in tmp_path.iterdir()}
    assert texts["port"] == texts["jax"]
    assert texts["port_w"] == texts["jax_w"]
    for name in ("port", "port_w"):
        got = kitti.load_poses(str(tmp_path / f"{name}.txt"))
        np.testing.assert_array_equal(
            got, jkitti.load_poses(str(tmp_path / f"{name}.txt")))
        np.testing.assert_allclose(got, poses, rtol=1e-8, atol=1e-12)
    one = tmp_path / "one.txt"
    kitti.save_poses_kitti(str(one), poses[:1])
    assert kitti.load_poses(str(one)).shape == (1, 4, 4)


def test_load_poses_refuses_rows_of_another_width(tmp_path):
    bad = tmp_path / "bad.txt"
    bad.write_text("1 2 3\n4 5 6\n")
    with pytest.raises(ValueError, match="12 values"):
        kitti.load_poses(str(bad))


def test_render_trajectory_equals_jax():
    poses, gt = _poses(seed=0), _poses(seed=1)
    for args in ((poses,), (poses, gt), (poses, gt, (300, 400), (50, 20))):
        got = plot.render_trajectory(*args)
        np.testing.assert_array_equal(got, jplot.render_trajectory(*args))
    assert got.any()


def test_render_tracks_equals_jax(cv2_mode):
    img, tr = _frame_and_tracks()
    for valid in (tr.valid, None):
        got = plot.render_tracks(img, tr.points_l0, tr.points_l1, valid)
        ref = jplot.render_tracks(img, tr.points_l0, tr.points_l1, valid)
        assert got.shape == (120, 160, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, ref)


def test_live_display_offscreen_equals_jax(cv2_mode):
    poses, gt = _poses(seed=2), _poses(seed=3)
    img, tr = _frame_and_tracks(seed=1)
    port = plot.LiveDisplay(poses_gt=gt, offscreen=True)
    ref = jplot.LiveDisplay(poses_gt=gt, offscreen=True)
    for i, p in enumerate(poses):
        args = (p, img, tr) if i % 3 == 0 else (p,)
        port.update(*args)
        ref.update(*args)
    port.close()
    ref.close()
    assert port.frames_shown == ref.frames_shown == len(poses)
    np.testing.assert_array_equal(port.canvas, ref.canvas)
    np.testing.assert_array_equal(port.last_tracks_vis, ref.last_tracks_vis)


def test_live_display_needs_a_display(monkeypatch):
    monkeypatch.delenv("DISPLAY", raising=False)
    monkeypatch.delenv("WAYLAND_DISPLAY", raising=False)
    for mod in (plot, jplot):
        with pytest.raises(RuntimeError, match="display server"):
            mod.LiveDisplay()


def test_save_png_equals_jax(tmp_path, cv2_mode):
    img, tr = _frame_and_tracks(seed=4)
    vis = plot.render_tracks(img, tr.points_l0, tr.points_l1, tr.valid)
    plot.save_png(str(tmp_path / "port.png"), vis)
    jplot.save_png(str(tmp_path / "jax.png"), vis)
    assert ((tmp_path / "port.png").read_bytes()
            == (tmp_path / "jax.png").read_bytes())
