"""The port's scan checkpoints: ``utils.checkpoint`` and
``runner.pipeline.run_sequence_scan_resumable`` / ``restore_scan_state``.

- A crashed and resumed run equals the uninterrupted one bit for bit
  (poses, every ``StepOutput`` field and, collecting them, every
  ``TrackSnapshot`` field), and both equal ``run_sequence_scan`` at the
  same chunk: the scenario of
  tests/test_checkpoint_resume.py::test_scan_resume_bitwise_matches_uninterrupted
  (crash at frame 30, chunk 8, a snapshot every 16 steps, 41 steps) and
  ::test_scan_resume_with_tracks_bitwise.
- A snapshot that covers the whole run returns its outputs and reads no
  frame.
- A torn file, a file missing any required key (``gen_state`` among them)
  and a cursor past the end are refused as ``CorruptCheckpoint``, and the
  run starts fresh.
- ``restore_scan_state`` in both packages from one numpy snapshot, then one
  step each with JAX's draws fed in, within tests/test_torch_pipeline.py's
  step bounds.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_odom_tpu.config import CameraIntrinsics as JIntrinsics
from visual_odom_tpu.config import VOConfig as JVOConfig
from visual_odom_tpu.runner import pipeline as jpipe
from visual_odom_tpu_torch.config import CameraIntrinsics, VOConfig
from visual_odom_tpu_torch.io.synthetic import SyntheticStereoSequence
from visual_odom_tpu_torch.runner import pipeline
from visual_odom_tpu_torch.utils import checkpoint

torch.set_num_threads(1)

H, W = 120, 160
INTR = dict(fx=120.0, fy=120.0, cx=80.0, cy=60.0, bf=-64.8, width=W, height=H)
#: the plain LK quad makes a CPU step ~0.4-0.6 s at this size; neither
#: RANSAC's nor LK's iteration count changes what a resume must reproduce
CFG = dict(ransac_iterations=100, lk_max_iters=10)
CHUNK, EVERY, CRASH_AT = 8, 16, 30
#: step parity bounds of tests/test_torch_pipeline.py
COUNT_FRAC, ROT_TOL, TRANS_TOL = 0.03, 2e-3, 2e-2


class _FlakySeq:
    """Random-access view that raises once when frame ``crash_at`` is first
    asked for, and counts the frames it hands out."""

    def __init__(self, seq, crash_at):
        self._seq = seq
        self._crash_at = crash_at
        self._armed = True
        self.reads = 0

    def __len__(self):
        return len(self._seq)

    def frame(self, i):
        if self._armed and i >= self._crash_at:
            self._armed = False
            raise RuntimeError("injected decode failure")
        self.reads += 1
        return self._seq.frame(i)


@pytest.fixture(scope="module")
def setup():
    intr = CameraIntrinsics(**INTR)
    cfg = VOConfig.for_image(H, W, **CFG)
    seq = SyntheticStereoSequence(intr, num_frames=42, seed=0)
    return seq, cfg, intr


@pytest.fixture(scope="module")
def plain(setup):
    """``run_sequence_scan`` at the same chunk, collecting tracks
    (collecting changes no result)."""
    seq, cfg, intr = setup
    return pipeline.run_sequence_scan(iter(seq), cfg, intr, chunk=CHUNK,
                                      warmup=False, collect_tracks=True,
                                      device="cpu")


@pytest.fixture(scope="module")
def full(setup, tmp_path_factory):
    """The uninterrupted resumable run; its last snapshot is at step 32."""
    seq, cfg, intr = setup
    ck = str(tmp_path_factory.mktemp("full") / "full.npz")
    stats = []
    out = pipeline.run_sequence_scan_resumable(
        seq, cfg, intr, ck, checkpoint_every=EVERY, chunk=CHUNK,
        warmup=False, snapshot_stats=stats, device="cpu")
    return out, ck, stats


def _assert_equal_outputs(a, b):
    assert type(a) is type(b)
    for name, x, y in zip(a._fields, a, b):
        np.testing.assert_array_equal(x, y, err_msg=name)


def test_uninterrupted_resumable_equals_scan(full, plain):
    (poses, fetched, _, done), _, stats = full
    assert done == 41
    np.testing.assert_array_equal(poses, plain[0])
    _assert_equal_outputs(fetched, plain[1])
    # snapshots every 16 steps, whole chunks only
    assert [s["step"] for s in stats] == [16, 32]
    assert all(s["bytes"] > 0 and s["ms"] > 0 for s in stats)


@pytest.mark.parametrize("tracks", [False, True], ids=["outputs", "tracks"])
def test_scan_resume_bitwise_matches_uninterrupted(setup, plain, tmp_path,
                                                   tracks):
    """Crash at frame 30 (the last snapshot is step 16), resume with the
    healthy sequence: bit for bit the uninterrupted run."""
    seq, cfg, intr = setup
    ck = str(tmp_path / "crash.npz")
    kw = dict(checkpoint_every=EVERY, chunk=CHUNK, warmup=False,
              collect_tracks=tracks, device="cpu")
    with pytest.raises(RuntimeError, match="injected"):
        pipeline.run_sequence_scan_resumable(_FlakySeq(seq, CRASH_AT), cfg,
                                             intr, ck, **kw)
    assert int(checkpoint.load_scan_checkpoint(ck)["frames_done"]) == 16
    out = pipeline.run_sequence_scan_resumable(seq, cfg, intr, ck, **kw)
    assert out[3] == 25                       # steps 17..41 only
    np.testing.assert_array_equal(out[0], plain[0])
    _assert_equal_outputs(out[1], plain[1])
    if tracks:
        assert len(out[4]) == len(plain[4]) == 41
        for a, b in zip(out[4], plain[4]):
            _assert_equal_outputs(a, b)


def test_resume_from_complete_reads_no_frame(setup, full):
    """33 frames end on the step-32 snapshot: the run returns its stored
    outputs without reading a frame."""
    seq, cfg, intr = setup
    (poses, fetched, _, _), ck, _ = full
    flaky = _FlakySeq(seq, crash_at=0)
    p, f, wall, done = pipeline.run_sequence_scan_resumable(
        flaky, cfg, intr, ck, checkpoint_every=EVERY, chunk=CHUNK,
        max_frames=33, device="cpu")
    assert done == 0 and wall == 0.0 and flaky.reads == 0
    np.testing.assert_array_equal(p, poses[:33])
    _assert_equal_outputs(f, type(fetched)(*(x[:32] for x in fetched)))


# --- refusals ------------------------------------------------------------


@pytest.fixture(scope="module")
def short_run(setup, tmp_path_factory):
    """A 5-frame run, chunk 2, a snapshot every 2 steps: its final
    snapshot (at step 4) and its poses."""
    seq, cfg, intr = setup
    ck = str(tmp_path_factory.mktemp("short") / "short.npz")
    out = pipeline.run_sequence_scan_resumable(
        seq, cfg, intr, ck, checkpoint_every=2, chunk=2, max_frames=5,
        warmup=False, device="cpu")
    with np.load(ck) as z:
        payload = {k: z[k] for k in z.files}
    return out, payload


@pytest.mark.parametrize("key", checkpoint._SCAN_REQUIRED)
def test_missing_key_refused(short_run, tmp_path, key):
    """Each required key, ``gen_state`` (the generator's state, which JAX's
    ``key`` becomes) among them: a file without it is corrupt, and the
    message names it."""
    _, payload = short_run
    p = str(tmp_path / "missing.npz")
    np.savez(p, **{k: v for k, v in payload.items() if k != key})
    with pytest.raises(checkpoint.CorruptCheckpoint, match=key):
        checkpoint.load_scan_checkpoint(p)


def test_snapshot_keys_and_generator_state(short_run):
    _, payload = short_run
    assert set(checkpoint._SCAN_REQUIRED) <= set(payload)
    assert "key" not in payload
    assert payload["gen_state"].dtype == np.uint8
    assert int(payload["frames_done"]) == 4
    gen = torch.Generator()
    gen.set_state(torch.from_numpy(payload["gen_state"]))


def test_tracks_run_refuses_snapshot_without_tracks(setup, short_run,
                                                    tmp_path, capsys):
    """A snapshot written without track snapshots cannot resume a
    collect_tracks run: refused, and the run starts fresh."""
    seq, cfg, intr = setup
    (poses, _, _, _), payload = short_run
    ck = str(tmp_path / "no_tracks.npz")
    np.savez(ck, **payload)
    out = pipeline.run_sequence_scan_resumable(
        seq, cfg, intr, ck, checkpoint_every=2, chunk=2, max_frames=5,
        warmup=False, collect_tracks=True, device="cpu")
    assert out[3] == 4 and len(out[4]) == 4
    assert "missing trk_points" in capsys.readouterr().err
    np.testing.assert_array_equal(out[0], poses)


def _torn(path, payload):
    with open(path, "wb") as f:
        f.write(b"PK\x03\x04 definitely not a full zip")


def _no_gen_state(path, payload):
    np.savez(path, **{k: v for k, v in payload.items() if k != "gen_state"})


def _cursor_past_end(path, payload):
    n = 9
    d = dict(payload, frames_done=np.int64(n))
    for k in list(d):
        if k.startswith("out_"):
            d[k] = np.concatenate([d[k]] * 3)[:n]
    np.savez(path, **d)


@pytest.mark.parametrize("corrupt", [_torn, _no_gen_state, _cursor_past_end],
                         ids=["torn", "no_gen_state", "cursor_past_end"])
def test_corrupt_snapshot_starts_fresh(setup, short_run, tmp_path, capsys,
                                       corrupt):
    seq, cfg, intr = setup
    (poses, fetched, _, _), payload = short_run
    ck = str(tmp_path / "bad.npz")
    corrupt(ck, payload)
    if corrupt is not _cursor_past_end:
        with pytest.raises(checkpoint.CorruptCheckpoint):
            checkpoint.load_scan_checkpoint(ck)
    p, f, _, done = pipeline.run_sequence_scan_resumable(
        seq, cfg, intr, ck, checkpoint_every=2, chunk=2, max_frames=5,
        warmup=False, device="cpu")
    assert "rejecting corrupt checkpoint" in capsys.readouterr().err
    assert done == 4
    np.testing.assert_array_equal(p, poses)
    _assert_equal_outputs(f, fetched)
    # the fresh run wrote a good snapshot over the bad one
    assert int(checkpoint.load_scan_checkpoint(ck)["frames_done"]) == 4


def test_atomic_write_leaves_no_temporary(tmp_path):
    p = str(tmp_path / "a" / "snap.npz")
    size = checkpoint._atomic_savez(p, {"x": np.arange(4)})
    assert os.listdir(tmp_path / "a") == ["snap.npz"]
    assert size == os.path.getsize(p)


# --- restore against the JAX package -------------------------------------


def test_restore_scan_state_matches_jax(setup):
    """One numpy snapshot of JAX's state after frame 3 (through JAX's own
    packer), restored by both packages from frame 3's images; then frame 4
    stepped by both, the port fed JAX's RANSAC draws."""
    seq, cfg, intr = setup
    jintr = JIntrinsics(**INTR)
    jcfg = JVOConfig.for_image(H, W, **CFG)
    frames = [seq.frame(i) for i in range(5)]
    jstep = jpipe.make_step_fn(jcfg, jintr)
    jst = jpipe.init_vo_state(jcfg, jintr, *frames[0])
    for i in (1, 2, 3):
        jst, _ = jstep(jst, *(jnp.asarray(x) for x in frames[i]))
    f32, i32 = jpipe._make_snapshot_packer(jcfg)(jst)
    ck = jpipe._unpack_snapshot(jcfg, np.asarray(f32), np.asarray(i32))
    ck["gen_state"] = torch.Generator().get_state().numpy()

    jres = jpipe.restore_scan_state(jcfg, jintr, ck, *frames[3])
    res = pipeline.restore_scan_state(cfg, intr, ck, *frames[3], device="cpu")
    for name in res.features._fields:
        np.testing.assert_array_equal(
            getattr(res.features, name).numpy(),
            np.asarray(getattr(jres.features, name)), err_msg=name)
    for a, b in zip(res.lk_l0.pyramid, jres.lk_l0.pyramid):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)

    _, sub = jax.random.split(jres.key)
    u = torch.tensor(np.asarray(jax.random.uniform(
        sub, (cfg.ransac_iterations, cfg.padded_features))))
    _, ref = jstep(jres, *(jnp.asarray(x) for x in frames[4]))
    _, got = pipeline.make_step_fn(cfg, intr, device="cpu")(
        res, *(torch.from_numpy(x) for x in frames[4]), uniforms=u)
    assert int(got.num_bucketed) == int(ref.num_bucketed)
    for name in ("num_matched", "num_inliers"):
        r, g = int(getattr(ref, name)), int(getattr(got, name))
        assert abs(g - r) <= COUNT_FRAC * r, (name, g, r)
    assert bool(got.accept) == bool(ref.accept)
    d = np.abs(got.T_inv.numpy() - np.asarray(ref.T_inv))
    assert d[:3, :3].max() < ROT_TOL and d[:3, 3].max() < TRANS_TOL
