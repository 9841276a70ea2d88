"""The port's front doors against its own scan and against the JAX package.

- ``run_sequence`` (with its metrics, poses, track snapshots and an
  offscreen ``LiveDisplay``), ``VisualOdometry``, ``run_sequence_resumable``
  and ``run_sequence_buffered`` (with and without ``preupload``) equal
  ``run_sequence_scan`` bit for bit on one 17-frame course: every door
  steps the same ``make_step_fn`` with the same generator draws.
- The counterparts of
  tests/test_checkpoint_resume.py::test_resume_bitwise_matches_uninterrupted
  and ::test_checkpoint_writes_poses_file.
- A torn ``VisualOdometry`` snapshot, and one missing each required key
  (``gen_state`` among them), are refused as ``CorruptCheckpoint`` and the
  run starts fresh, as in tests/test_fault_injection.py:138-180; a snapshot
  without ``flow`` / ``disp`` restores them as zeros.
- ``restore_vo`` in both packages from one snapshot that JAX's
  ``save_checkpoint`` wrote, then one step each with JAX's draws fed in,
  within tests/test_torch_pipeline.py's step bounds.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_odom_tpu.config import CameraIntrinsics as JIntrinsics
from visual_odom_tpu.config import VOConfig as JVOConfig
from visual_odom_tpu.runner import pipeline as jpipe
from visual_odom_tpu.utils import checkpoint as jcheckpoint
from visual_odom_tpu_torch.config import CameraIntrinsics, VOConfig
from visual_odom_tpu_torch.eval.plot import LiveDisplay
from visual_odom_tpu_torch.io.kitti import load_poses
from visual_odom_tpu_torch.io.synthetic import SyntheticStereoSequence
from visual_odom_tpu_torch.runner import pipeline
from visual_odom_tpu_torch.utils import checkpoint

torch.set_num_threads(1)

H, W = 120, 160
INTR = dict(fx=120.0, fy=120.0, cx=80.0, cy=60.0, bf=-64.8, width=W, height=H)
#: the plain LK quad makes a CPU step ~0.4 s at this size; neither count
#: changes what the doors must reproduce
CFG = dict(ransac_iterations=100, lk_max_iters=10)
N_FRAMES = 17
#: step parity bounds of tests/test_torch_pipeline.py
COUNT_FRAC, ROT_TOL, TRANS_TOL = 0.03, 2e-3, 2e-2
#: the ``FrameResult`` fields that a ``StepOutput`` carries too
RESULT_FIELDS = ("accept", "scale", "num_inliers", "num_matched",
                 "num_bucketed")


@pytest.fixture(scope="module")
def setup():
    intr = CameraIntrinsics(**INTR)
    cfg = VOConfig.for_image(H, W, **CFG)
    seq = SyntheticStereoSequence(intr, num_frames=N_FRAMES, seed=0)
    return seq, [seq.frame(i) for i in range(N_FRAMES)], cfg, intr


@pytest.fixture(scope="module")
def scan(setup):
    _, frames, cfg, intr = setup
    return pipeline.run_sequence_scan(frames, cfg, intr, chunk=4,
                                      warmup=False, device="cpu")


@pytest.fixture(scope="module")
def front(setup, tmp_path_factory):
    """``run_sequence`` with every option on: collected tracks, metrics and
    poses files, and an offscreen live display."""
    _, frames, cfg, intr = setup
    d = tmp_path_factory.mktemp("front")
    live = LiveDisplay(offscreen=True)
    poses, results, snaps = pipeline.run_sequence(
        iter(frames), cfg, intr, metrics_path=str(d / "metrics.jsonl"),
        poses_path=str(d / "poses.txt"), collect_tracks=True, live=live,
        device="cpu")
    return poses, results, snaps, d, live


def _assert_results_match(results, fetched, poses):
    assert [r.frame_id for r in results] == list(range(1, len(poses)))
    for i, r in enumerate(results):
        np.testing.assert_array_equal(r.pose, poses[i + 1])
        for k in RESULT_FIELDS:
            assert getattr(r, k) == getattr(fetched, k)[i].item(), (i, k)


def test_run_sequence_equals_scan(front, scan):
    poses, results, _, _, _ = front
    np.testing.assert_array_equal(poses, scan[0])
    _assert_results_match(results, scan[1], scan[0])


def test_run_sequence_writes_metrics_and_poses(front):
    poses, results, _, d, _ = front
    lines = (d / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == len(results) == N_FRAMES - 1
    rec = json.loads(lines[3])
    assert "pose" not in rec and list(rec)[0] == "t"
    assert rec["frame_id"] == 4 and rec["num_matched"] == results[3].num_matched
    rows = np.array([[float(f"{v:.9e}") for v in p[:3].reshape(12)]
                     for p in poses])
    got = load_poses(str(d / "poses.txt"))
    np.testing.assert_array_equal(got[:, :3, :].reshape(-1, 12), rows)
    np.testing.assert_array_equal(got[:, 3], np.tile([0, 0, 0, 1.0],
                                                     (len(poses), 1)))


def test_run_sequence_tracks_and_live(front, scan):
    _, results, snaps, _, live = front
    assert len(snaps) == len(results)
    for s, r in zip(snaps, results):
        assert isinstance(s.valid, np.ndarray)
        assert int(s.valid.sum()) == r.num_matched
    assert live.frames_shown == len(results)
    assert live.last_tracks_vis.shape == (H, W, 3)
    assert live.canvas[..., 2].any()            # the red estimate


def test_visual_odometry_equals_scan(setup, scan):
    _, frames, cfg, intr = setup
    vo = pipeline.VisualOdometry(cfg, intr, device="cpu")
    with pytest.raises(RuntimeError, match="initialize"):
        vo.process_frame(*frames[1])
    vo.initialize(*frames[0])
    results = [vo.process_frame(l, r) for l, r in frames[1:]]
    assert vo.last_tracks is None and vo.frame_id == N_FRAMES - 1
    np.testing.assert_array_equal(vo.frame_pose, scan[0][-1])
    _assert_results_match(results, scan[1], scan[0])


def test_resumable_equals_scan(setup, scan, tmp_path):
    seq, _, cfg, intr = setup
    stats = []
    poses, results = pipeline.run_sequence_resumable(
        seq, cfg, intr, str(tmp_path / "ck.npz"), checkpoint_every=4,
        snapshot_stats=stats, device="cpu")
    np.testing.assert_array_equal(poses, scan[0])
    _assert_results_match(results, scan[1], scan[0])
    assert [s["frame"] for s in stats] == [4, 8, 12, 16]
    assert all(s["bytes"] > 0 and s["ms"] > 0 for s in stats)
    ck = checkpoint.load_checkpoint(str(tmp_path / "ck.npz"))
    assert int(ck["frame_id"]) == N_FRAMES - 1
    np.testing.assert_array_equal(ck["extra_poses"], poses)


@pytest.mark.parametrize("preupload", [True, False],
                         ids=["preupload", "streamed"])
def test_buffered_equals_scan(setup, scan, preupload):
    _, frames, cfg, intr = setup
    poses, bufs, wall = pipeline.run_sequence_buffered(
        frames, cfg, intr, preupload=preupload, device="cpu")
    assert wall > 0 and bufs.idx.tolist() == [N_FRAMES - 1]
    np.testing.assert_array_equal(poses, scan[0])
    for k in pipeline.OutputBuffers._fields[:-1]:
        np.testing.assert_array_equal(getattr(bufs, k), getattr(scan[1], k),
                                      err_msg=k)


def test_buffered_step_writes_at_the_device_cursor(setup):
    """Two buffered steps fill rows 0 and 1 and leave the cursor at 2; the
    rest of the buffers keep their initial values."""
    _, frames, cfg, intr = setup
    step = pipeline.make_buffered_step_fn(cfg, intr, device="cpu")
    raw = pipeline.make_step_fn(cfg, intr, device="cpu")
    st = pipeline.init_vo_state(cfg, intr, *frames[0], device="cpu")
    ref = pipeline.init_vo_state(cfg, intr, *frames[0], device="cpu")
    bufs = pipeline.make_output_buffers(4, device="cpu")
    for i in (1, 2):
        st, bufs = step(st, *frames[i], bufs)
        ref, out = raw(ref, *frames[i])
        for k in pipeline.OutputBuffers._fields[:-1]:
            assert torch.equal(getattr(bufs, k)[i - 1], getattr(out, k)), k
    assert bufs.idx.tolist() == [2]
    np.testing.assert_array_equal(bufs.T_inv[2:].numpy(),
                                  np.tile(np.eye(4, dtype=np.float32),
                                          (2, 1, 1)))
    assert not bufs.accept[2:].any() and not bufs.num_matched[2:].any()


# --- the counterparts of tests/test_checkpoint_resume.py -----------------


def test_resume_bitwise_matches_uninterrupted(setup, tmp_path):
    """9 frames, a snapshot every 3 frames: a run cut at 6 frames (its last
    snapshot at frame 5), resumed, equals the uninterrupted run bit for
    bit and processes frames 6, 7, 8 only."""
    seq, _, cfg, intr = setup
    full_ck, part_ck = str(tmp_path / "full.npz"), str(tmp_path / "part.npz")
    kw = dict(checkpoint_every=3, device="cpu")
    full, _ = pipeline.run_sequence_resumable(seq, cfg, intr, full_ck,
                                              max_frames=9, **kw)
    part, _ = pipeline.run_sequence_resumable(seq, cfg, intr, part_ck,
                                              max_frames=6, **kw)
    assert len(part) == 6
    assert int(checkpoint.load_checkpoint(part_ck)["frame_id"]) == 5
    resumed, results = pipeline.run_sequence_resumable(
        seq, cfg, intr, part_ck, max_frames=9, **kw)
    assert len(resumed) == len(full) == 9
    np.testing.assert_array_equal(resumed, full)
    assert [r.frame_id for r in results] == [6, 7, 8]


def test_checkpoint_writes_poses_file(setup, tmp_path):
    seq, _, cfg, intr = setup
    out = tmp_path / "poses.txt"
    poses, _ = pipeline.run_sequence_resumable(
        seq, cfg, intr, str(tmp_path / "ck.npz"), checkpoint_every=2,
        max_frames=5, poses_path=str(out), device="cpu")
    rows = out.read_text().splitlines()
    assert len(rows) == len(poses) == 5
    assert len(rows[0].split()) == 12
    np.testing.assert_allclose(load_poses(str(out)), poses, rtol=1e-8,
                               atol=1e-12)


# --- refusals --------------------------------------------------------------


@pytest.fixture(scope="module")
def short_run(setup, tmp_path_factory):
    """A 3-frame run with a snapshot after each frame: its poses and its
    final snapshot's payload."""
    seq, _, cfg, intr = setup
    ck = str(tmp_path_factory.mktemp("short") / "short.npz")
    poses, _ = pipeline.run_sequence_resumable(
        seq, cfg, intr, ck, checkpoint_every=1, max_frames=3, device="cpu")
    with np.load(ck) as z:
        payload = {k: z[k] for k in z.files}
    return poses, payload


def test_snapshot_keys(short_run):
    _, payload = short_run
    assert set(checkpoint._REQUIRED_KEYS) <= set(payload)
    assert "key" not in payload and "extra_poses" in payload
    assert payload["gen_state"].dtype == np.uint8
    assert int(payload["frame_id"]) == 2


def _torn(path, payload):
    with open(path, "wb") as f:
        f.write(b"PK\x03\x04 this is not a real npz payload")


def _without(key):
    def write(path, payload):
        np.savez(path, **{k: v for k, v in payload.items() if k != key})
    write.__name__ = f"no_{key}"
    return write


@pytest.mark.parametrize("corrupt",
                         [_torn] + [_without(k)
                                    for k in checkpoint._REQUIRED_KEYS],
                         ids=lambda f: f.__name__.strip("_"))
def test_corrupt_snapshot_refused_and_run_starts_fresh(setup, short_run,
                                                       tmp_path, capsys,
                                                       corrupt):
    seq, _, cfg, intr = setup
    poses, payload = short_run
    ck = str(tmp_path / "bad.npz")
    corrupt(ck, payload)
    missing = corrupt.__name__[3:] if corrupt is not _torn else "unreadable"
    with pytest.raises(checkpoint.CorruptCheckpoint, match=missing):
        checkpoint.load_checkpoint(ck)
    got, results = pipeline.run_sequence_resumable(
        seq, cfg, intr, ck, checkpoint_every=1, max_frames=3, device="cpu")
    assert "rejecting corrupt checkpoint" in capsys.readouterr().err
    assert [r.frame_id for r in results] == [1, 2]
    np.testing.assert_array_equal(got, poses)
    # the fresh run wrote a good snapshot over the bad one
    assert int(checkpoint.load_checkpoint(ck)["frame_id"]) == 2


def test_snapshot_without_flow_and_disp_restores_zeros(setup, short_run,
                                                       tmp_path):
    seq, _, cfg, intr = setup
    _, payload = short_run
    assert np.abs(payload["flow"]).sum() > 0
    ck = str(tmp_path / "old.npz")
    np.savez(ck, **{k: v for k, v in payload.items()
                    if k not in ("flow", "disp")})
    loaded = checkpoint.load_checkpoint(ck)
    vo = pipeline.VisualOdometry(cfg, intr, device="cpu")
    assert checkpoint.restore_vo(vo, loaded, *seq.frame(2)) == 3
    for k in ("flow", "disp"):
        t = getattr(vo.state.features, k)
        assert t.shape == payload[k].shape and not t.any()
    for k in ("points", "ids", "valid"):
        np.testing.assert_array_equal(getattr(vo.state.features, k).numpy(),
                                      payload[k])
    np.testing.assert_array_equal(vo.frame_pose, payload["frame_pose"])
    np.testing.assert_array_equal(vo.state.generator.get_state().numpy(),
                                  payload["gen_state"])
    assert np.isfinite(vo.process_frame(*seq.frame(3)).pose).all()


# --- restore against the JAX package ---------------------------------------


def test_restore_vo_matches_jax(setup, tmp_path):
    """JAX's ``VisualOdometry`` after frame 3, snapshotted by JAX's
    ``save_checkpoint``; the port's snapshot is that file with a generator
    state added. Both packages restore it from frame 3's images, then step
    frame 4, the port fed JAX's RANSAC draws."""
    seq, frames, cfg, intr = setup
    jintr = JIntrinsics(**INTR)
    jcfg = JVOConfig.for_image(H, W, **CFG)
    jvo = jpipe.VisualOdometry(jcfg, jintr)
    jvo.initialize(*frames[0])
    for i in (1, 2, 3):
        jvo.process_frame(*frames[i])
    jck = str(tmp_path / "jax.npz")
    jcheckpoint.save_checkpoint(jck, jvo)
    with np.load(jck) as z:
        payload = {k: z[k] for k in z.files}
    payload["gen_state"] = torch.Generator().get_state().numpy()
    ck = str(tmp_path / "port.npz")
    np.savez(ck, **payload)

    jres = jpipe.VisualOdometry(jcfg, jintr)
    assert jcheckpoint.restore_vo(jres, jcheckpoint.load_checkpoint(jck),
                                  *frames[3]) == 4
    vo = pipeline.VisualOdometry(cfg, intr, device="cpu")
    assert checkpoint.restore_vo(vo, checkpoint.load_checkpoint(ck),
                                 *frames[3]) == 4
    assert vo.frame_id == jres.frame_id == 3
    np.testing.assert_array_equal(vo.frame_pose, jres.frame_pose)
    for name in vo.state.features._fields:
        np.testing.assert_array_equal(
            getattr(vo.state.features, name).numpy(),
            np.asarray(getattr(jres.state.features, name)), err_msg=name)
    for a, b in zip(vo.state.lk_l0.pyramid, jres.state.lk_l0.pyramid):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)

    _, sub = jax.random.split(jres.state.key)
    u = torch.tensor(np.asarray(jax.random.uniform(
        sub, (cfg.ransac_iterations, cfg.padded_features))))
    _, ref = jpipe.make_step_fn(jcfg, jintr)(
        jres.state, *(jnp.asarray(x) for x in frames[4]))
    _, got = pipeline.make_step_fn(cfg, intr, device="cpu")(
        vo.state, *(torch.from_numpy(x) for x in frames[4]), uniforms=u)
    assert int(got.num_bucketed) == int(ref.num_bucketed)
    for name in ("num_matched", "num_inliers"):
        r, g = int(getattr(ref, name)), int(getattr(got, name))
        assert abs(g - r) <= COUNT_FRAC * r, (name, g, r)
    assert bool(got.accept) == bool(ref.accept)
    d = np.abs(got.T_inv.numpy() - np.asarray(ref.T_inv))
    assert d[:3, :3].max() < ROT_TOL and d[:3, 3].max() < TRANS_TOL
