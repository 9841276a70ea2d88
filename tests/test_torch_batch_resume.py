"""The port's restartable batched runner: ``run_sequences_batched`` with
``checkpoint_path`` / ``checkpoint_every``, ``save_batch_checkpoint`` /
``load_batch_checkpoint`` and ``parallel.batch.restore_batched_state``.

- The counterpart of
  tests/test_cli_batch.py::test_batched_resume_bitwise_matches_uninterrupted,
  in its setting (120x160, 100 RANSAC iterations, two synthetic sequences
  of 33 frames, chunk 8, a snapshot every 16 steps, a failure at frame
  22; LK capped at 10 iterations to keep the CPU run short, which changes
  nothing a resume must reproduce): the resumed poses and stats equal the
  uninterrupted run's bit for bit, and a snapshot for B = 2 is refused by
  a run of B = 3 ("batch mismatch") and by a run on another device kind.
- A torn snapshot, one missing a key and one whose cursor is off the
  chunk grid are each rejected with a warning, and the run starts fresh.
- ``checkpoint_path`` without ``chunk`` raises.
- The same run read from two ``KittiSequence`` directories of PNGs equals
  the run from frame lists.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from visual_odom_tpu_torch.config import CameraIntrinsics, VOConfig
from visual_odom_tpu_torch.io.kitti import KittiSequence
from visual_odom_tpu_torch.io.synthetic import SyntheticStereoSequence
from visual_odom_tpu_torch.parallel.batch_eval import run_sequences_batched
from visual_odom_tpu_torch.utils.checkpoint import (CorruptCheckpoint,
                                                    load_batch_checkpoint)

torch.set_num_threads(1)

H, W = 120, 160
INTR = dict(fx=120.0, fy=120.0, cx=80.0, cy=60.0, bf=-64.8, width=W, height=H)
CFG = dict(ransac_iterations=100, lk_max_iters=10)
FRAMES, CHUNK, EVERY, CRASH_AT = 33, 8, 16, 22
#: the short course of the refusal and PNG tests: 4 steps in chunks of 2
SHORT, SHORT_CHUNK = 5, 2


class _FlakyBatchSeq:
    """Random-access view that raises when a frame at or past ``crash_at``
    is asked for."""

    def __init__(self, seq, crash_at):
        self._seq, self._crash_at = seq, crash_at

    def __len__(self):
        return len(self._seq)

    def frame(self, i):
        if i >= self._crash_at:
            raise RuntimeError("injected decode failure")
        return self._seq.frame(i)


@pytest.fixture(scope="module")
def setup():
    intr = CameraIntrinsics(**INTR)
    cfg = VOConfig.for_image(H, W, **CFG)
    seqs = [SyntheticStereoSequence(intr, num_frames=FRAMES, seed=s, speed=0.5)
            for s in (0, 1)]
    return intr, cfg, seqs


@pytest.fixture(scope="module")
def reference(setup):
    intr, cfg, seqs = setup
    return run_sequences_batched(seqs, cfg, intr, chunk=CHUNK, device="cpu")


@pytest.fixture(scope="module")
def crashed(setup, tmp_path_factory):
    """The snapshot a run failed at frame CRASH_AT left behind."""
    intr, cfg, seqs = setup
    ck = str(tmp_path_factory.mktemp("batch") / "batch.npz")
    stats = []
    with pytest.raises(RuntimeError, match="injected"):
        run_sequences_batched([_FlakyBatchSeq(seqs[0], CRASH_AT), seqs[1]],
                              cfg, intr, chunk=CHUNK, checkpoint_path=ck,
                              checkpoint_every=EVERY, snapshot_stats=stats,
                              device="cpu")
    return ck, stats


def test_resumed_batched_run_equals_uninterrupted(setup, reference, crashed,
                                                  tmp_path, capsys):
    intr, cfg, seqs = setup
    ck, stats = crashed
    assert [s["step"] for s in stats] == [EVERY]
    assert stats[0]["bytes"] == os.path.getsize(ck) > 0
    snap = load_batch_checkpoint(ck, batch=2)
    assert int(snap["frames_done"]) == EVERY
    assert snap["gen_state"].shape[0] == 2 and snap["out_T_inv"].shape == (
        EVERY, 2, 4, 4)
    resume_ck = str(tmp_path / "resume.npz")
    shutil.copy(ck, resume_ck)
    poses, st, _ = run_sequences_batched(
        seqs, cfg, intr, chunk=CHUNK, checkpoint_path=resume_ck,
        checkpoint_every=EVERY, verbose=True, device="cpu")
    assert f"resumed batched scan from {resume_ck} at step {EVERY}" in \
        capsys.readouterr().out
    ref_poses, ref_stats, _ = reference
    for a, b in zip(poses, ref_poses):
        assert a.shape == (FRAMES, 4, 4)
        np.testing.assert_array_equal(a, b)
    assert st == ref_stats


def test_snapshot_refused_by_another_batch_or_device(crashed):
    ck, _ = crashed
    with pytest.raises(CorruptCheckpoint, match="batch mismatch"):
        load_batch_checkpoint(ck, batch=3)
    with pytest.raises(CorruptCheckpoint, match="taken on cpu, run on cuda"):
        load_batch_checkpoint(ck, batch=2, device="cuda")
    assert int(load_batch_checkpoint(ck, batch=2, device="cpu")[
        "frames_done"]) == EVERY


def test_checkpoint_needs_chunk(setup, tmp_path):
    intr, cfg, seqs = setup
    with pytest.raises(ValueError, match="chunk > 0"):
        run_sequences_batched(seqs, cfg, intr,
                              checkpoint_path=str(tmp_path / "x.npz"),
                              device="cpu")


@pytest.fixture(scope="module")
def short(setup, tmp_path_factory):
    """The first SHORT frames of both sequences as lists, their run at
    chunk SHORT_CHUNK, and a snapshot that run wrote at step 2."""
    intr, cfg, seqs = setup
    lists = [[s.frame(i) for i in range(SHORT)] for s in seqs]
    ck = str(tmp_path_factory.mktemp("short") / "short.npz")
    ref = run_sequences_batched(lists, cfg, intr, chunk=SHORT_CHUNK,
                                checkpoint_path=ck,
                                checkpoint_every=SHORT_CHUNK, device="cpu")
    return lists, ref, ck


def _same_run(got, ref):
    for a, b in zip(got[0], ref[0]):
        np.testing.assert_array_equal(a, b)
    assert got[1] == ref[1]


def _untrusted(ck, fault, path):
    """Write a copy of snapshot ``ck`` with ``fault`` to ``path``."""
    if fault == "torn":
        with open(ck, "rb") as f:
            data = f.read()
        with open(path, "wb") as f:
            f.write(data[: len(data) // 2])
        return
    with np.load(ck) as z:
        snap = {k: z[k] for k in z.files}
    if fault == "missing_key":
        del snap["gen_state"]
    else:       # off the chunk grid, outputs cut to match the cursor
        snap["frames_done"] = np.int64(1)
        for k in [k for k in snap if k.startswith("out_")]:
            snap[k] = snap[k][:1]
    np.savez(path, **snap)


@pytest.mark.parametrize("fault", ["torn", "missing_key", "off_boundary"])
def test_untrusted_snapshot_starts_fresh(setup, short, tmp_path, capsys,
                                         fault):
    intr, cfg, _ = setup
    lists, ref, ck = short
    assert int(load_batch_checkpoint(ck, batch=2)["frames_done"]) == \
        SHORT_CHUNK
    bad = str(tmp_path / "bad.npz")
    _untrusted(ck, fault, bad)
    got = run_sequences_batched(lists, cfg, intr, chunk=SHORT_CHUNK,
                                checkpoint_path=bad, device="cpu")
    err = capsys.readouterr().err
    assert "warning: rejecting corrupt checkpoint" in err
    assert {"torn": "unreadable", "missing_key": "missing keys ['gen_state']",
            "off_boundary": "not a chunk-2 boundary"}[fault] in err
    _same_run(got, ref)


def test_kitti_directories_equal_frame_lists(setup, short, tmp_path):
    from PIL import Image

    intr, cfg, _ = setup
    lists, ref, _ = short
    dirs = []
    for b, frames in enumerate(lists):
        root = tmp_path / f"seq{b}"
        for side, d in enumerate(("image_0", "image_1")):
            os.makedirs(root / d)
            for i, pair in enumerate(frames):
                Image.fromarray(pair[side]).save(root / d / f"{i:06d}.png")
        dirs.append(KittiSequence(str(root)))
    got = run_sequences_batched(dirs, cfg, intr, chunk=SHORT_CHUNK,
                                device="cpu")
    _same_run(got, ref)
