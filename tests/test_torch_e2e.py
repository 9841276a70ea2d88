"""The port's counterparts of the behaviours of tests/test_e2e.py that no
other port test checks, with JAX's assertions verbatim, at 120x160 on the
CPU (``device="cpu"``):

- re-acquisition after two blank frames (tests/test_e2e.py:106): the
  second blank frame is rejected with no match and the pose stays frozen;
  frames 6-8 are accepted again;
- the rotation gate on the ``gatespike`` course (:190): the three spike
  steps are rejected, and tracking before and after is healthy;
- the inlier floor at a scene cut (:250): floor 30 rejects the step that
  consumes the cut frame; away from the seam both floors accept alike.
  The accept flags at both floors are also held to the JAX package's
  ``run_sequence_scan`` of the same frames on the CPU;
- the turning and stress gauntlet courses at 45 frames (:164).

About 75 s alone.
"""

import numpy as np
import pytest
import torch

from visual_odom_tpu.config import CameraIntrinsics as JIntrinsics
from visual_odom_tpu.config import VOConfig as JVOConfig
from visual_odom_tpu.runner.pipeline import run_sequence_scan as jax_scan
from visual_odom_tpu_torch.config import CameraIntrinsics, VOConfig
from visual_odom_tpu_torch.eval.kitti_eval import ate_rmse
from visual_odom_tpu_torch.io.synthetic import (SyntheticStereoSequence,
                                                make_course)
from visual_odom_tpu_torch.runner.pipeline import (VisualOdometry,
                                                   run_sequence,
                                                   run_sequence_scan)

torch.set_num_threads(1)

H, W = 120, 160
INTR = dict(fx=120.0, fy=120.0, cx=W / 2, cy=H / 2, bf=-120.0 * 0.54,
            width=W, height=H)
CPU = "cpu"
#: the inlier floors tests/test_e2e.py:250 compares, and the step that
#: consumes the cut frame
FLOORS = (0, 30)
SEAM_STEP = 11


def test_reacquire_after_total_tracking_loss():
    """Two blank frames kill every track and PnP diverges; both must be
    gate-rejected, the pose held, and tracking live again from frame 6."""
    intr = CameraIntrinsics(**INTR)
    cfg = VOConfig.for_image(H, W, ransac_iterations=200)
    seq = SyntheticStereoSequence(intr, num_frames=12, seed=1, speed=0.5)
    frames = [seq.frame(i) for i in range(len(seq))]
    blank = np.zeros((H, W), np.uint8)

    vo = VisualOdometry(cfg, intr, seed=0, device=CPU)
    vo.initialize(*frames[0])
    for i in (1, 2, 3):
        assert vo.process_frame(*frames[i]).accept
    vo.process_frame(blank, blank)
    r_blank2 = vo.process_frame(blank, blank)
    assert not r_blank2.accept
    assert r_blank2.num_matched == 0
    pose_frozen = vo.frame_pose.copy()
    # Frame 5 re-seeds detections against the blank t0 (no matches
    # possible); from frame 6 on, tracking must be live again.
    vo.process_frame(*frames[5])
    recovered = [vo.process_frame(*frames[i]) for i in (6, 7, 8)]
    assert all(r.accept for r in recovered), [r.accept for r in recovered]
    assert all(r.num_inliers > 10 for r in recovered)
    np.testing.assert_allclose(pose_frozen, r_blank2.pose, atol=1e-12)


def test_rotation_gate_rejects_spike_and_recovers():
    """The 3-frame 0.15 rad/frame yaw spike at mid-course is rejected by
    the 0.1 rad gate; the frames before it and after re-acquisition are
    accepted and tracked as healthily as ever."""
    intr = CameraIntrinsics(**INTR)
    cfg = VOConfig.for_image(H, W, ransac_iterations=150)
    n = 41
    seq = make_course("gatespike", intr, num_frames=n, speed=0.5)
    poses, fetched, _, _ = run_sequence_scan(list(seq), cfg, intr, chunk=8,
                                             device=CPU)
    accept = np.asarray(fetched.accept)[: n - 1]
    mid = n // 2
    # Step output k is the transition frame k -> k+1; the spike's yaw is
    # applied at i in [mid, mid + 3).
    for s in (mid, mid + 1, mid + 2):
        assert not accept[s], f"step {s} (0.15 rad yaw) must be rejected"
    before = accept[:mid]
    after = accept[mid + 5:]
    assert before.mean() >= 0.95, before.mean()
    assert after.mean() >= 0.9, after.mean()
    nm = np.asarray(fetched.num_matched)[: n - 1]
    assert nm[mid + 6:].mean() >= 0.6 * nm[: mid - 1].mean()


def _cut_frames():
    """Two procedural worlds back to back: a real scene cut at frame 12."""
    intr = CameraIntrinsics(**INTR)
    seq = SyntheticStereoSequence(intr, num_frames=12, seed=0, speed=0.5)
    seq2 = SyntheticStereoSequence(intr, num_frames=12, seed=7, speed=0.5)
    return list(seq) + list(seq2)


@pytest.fixture(scope="module")
def cut_accepts():
    """The port's accept flags over the cut course at each floor."""
    cut = _cut_frames()
    accepts = {}
    for floor in FLOORS:
        cfg = VOConfig.for_image(H, W, ransac_iterations=100,
                                 min_accept_inliers=floor)
        _, fetched, _, _ = run_sequence_scan(iter(cut), cfg,
                                             CameraIntrinsics(**INTR),
                                             chunk=4, device=CPU)
        accepts[floor] = np.asarray(fetched.accept)
    return accepts


def test_min_inlier_gate_rejects_scene_cut(cut_accepts):
    """Floor 30 rejects the step that consumes the cut frame; away from
    the seam both floors behave identically."""
    accepts = cut_accepts
    assert not accepts[30][SEAM_STEP]
    assert accepts[30][:10].all() and accepts[30][14:22].all()
    np.testing.assert_array_equal(accepts[0][:10], accepts[30][:10])


@pytest.mark.parametrize("floor", FLOORS)
def test_scene_cut_accept_flags_equal_jax(cut_accepts, floor):
    """The JAX package's scan of the same frames at the same floor accepts
    the same steps."""
    cfg = JVOConfig.for_image(H, W, ransac_iterations=100,
                              min_accept_inliers=floor)
    _, fetched, _, _ = jax_scan(iter(_cut_frames()), cfg, JIntrinsics(**INTR),
                                chunk=4)
    np.testing.assert_array_equal(cut_accepts[floor],
                                  np.asarray(fetched.accept))


@pytest.mark.parametrize("course", ["turning", "stress"])
def test_gauntlet_courses_trackable(course):
    """Near-gate turns, photometric drift, occluders and a low-texture
    stretch do not break tracking: accept >= 0.9, ATE within 3 % of the
    course's length, and the turns really approach the gate."""
    intr = CameraIntrinsics(**INTR)
    cfg = VOConfig.for_image(H, W, ransac_iterations=200)
    seq = make_course(course, intr, num_frames=45, speed=0.5)
    poses, results = run_sequence(seq, cfg, intr, device=CPU)
    accept = np.mean([r.accept for r in results])
    assert accept >= 0.9, accept
    gt = seq.poses[: len(poses)]
    course_len = np.sum(np.linalg.norm(np.diff(gt[:, :3, 3], axis=0), axis=1))
    assert ate_rmse(gt, poses) <= 0.03 * course_len
    peak = max(abs(seq._turning_yaw_rate(i, len(seq))) for i in range(len(seq)))
    assert peak > 0.05
