"""The scan runners' upload threads and deferred fetch, on the CPU.

- The counterparts of tests/test_soak.py::test_scan_streams_o_chunk (71
  frames, chunk 8: at most three chunks' frames alive) and
  ::test_scan_stats_out_attribution (the first chunk goes up before the
  uploader starts), and of
  tests/test_e2e.py::test_parallel_uploader_matches_single_thread (three
  threads deliver in order: bit for bit the single thread's run).
- ``preupload=True`` is bit for bit the streamed run; the resumable scan
  through three upload threads is bit for bit ``run_sequence_scan``.
- A step that raises mid-run, or a source that raises mid-stream, leaves no
  uploader thread alive, and the caller gets the error.
- ``run_sequence_scan`` fetches nothing before it has dispatched its last
  chunk.
- Many uploader threads, switching often, deliver every chunk once and in
  order.
"""

import sys
import threading
import weakref

import numpy as np
import pytest
import torch

from visual_odom_tpu_torch.config import CameraIntrinsics, VOConfig
from visual_odom_tpu_torch.io.synthetic import SyntheticStereoSequence
from visual_odom_tpu_torch.runner import pipeline

torch.set_num_threads(1)

H, W = 120, 160
INTR = dict(fx=120.0, fy=120.0, cx=W / 2, cy=H / 2, bf=-120.0 * 0.54,
            width=W, height=H)
#: as tests/test_torch_front_doors.py: a CPU step ~0.4 s at this size
CFG = dict(ransac_iterations=100, lk_max_iters=10)


def _setup(n):
    intr = CameraIntrinsics(**INTR)
    cfg = VOConfig.for_image(H, W, **CFG)
    return SyntheticStereoSequence(intr, num_frames=n, seed=0, speed=0.5), \
        cfg, intr


class _RetentionMonitor:
    """Wraps a frame iterator and counts how many of the arrays it yielded
    are still referenced anywhere (weakref liveness), at every yield."""

    def __init__(self, frames):
        self._frames = frames
        self._refs = []
        self.max_alive = 0

    def __iter__(self):
        for left, right in self._frames:
            left, right = np.array(left), np.array(right)
            self._refs += [weakref.ref(left), weakref.ref(right)]
            alive = sum(1 for r in self._refs if r() is not None)
            self.max_alive = max(self.max_alive, alive)
            yield left, right


def _uploader_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith("vo-upload-") and t.is_alive()]


def _assert_same(a, b):
    np.testing.assert_array_equal(a[0], b[0])
    assert a[3] == b[3]
    for name, x, y in zip(a[1]._fields, a[1], b[1]):
        np.testing.assert_array_equal(x, y, err_msg=name)


def test_scan_streams_o_chunk():
    """The scan holds O(chunk) decoded frames, not O(sequence): chunk 8
    over 70 steps, at most 3 chunks x 2 arrays alive (a runner that
    materialised the sequence would reach 142)."""
    seq, cfg, intr = _setup(71)
    mon = _RetentionMonitor(seq)
    poses, fetched, _, processed = pipeline.run_sequence_scan(
        iter(mon), cfg, intr, chunk=8, device="cpu")
    assert processed == 70 and len(poses) == 71
    assert mon.max_alive <= 3 * 8 * 2, mon.max_alive
    assert float(np.mean(fetched.accept)) >= 0.95
    err = np.linalg.norm(poses[:, :3, 3] - seq.poses[:, :3, 3], axis=1)
    assert float(np.sqrt((err ** 2).mean())) < 0.03 * 71 * 0.5


def test_scan_stats_out_attribution():
    """The first chunk goes up before the uploader thread starts, so the
    thread uploads 3 of the 4 chunks."""
    seq, cfg, intr = _setup(17)
    stats = {}
    _, _, wall, processed = pipeline.run_sequence_scan(
        iter(seq), cfg, intr, chunk=4, stats_out=stats, device="cpu")
    assert processed == 16 and wall > 0
    assert stats["chunks"] == 3
    assert stats["upload_bytes"] == 3 * 4 * 2 * H * W
    assert 0.0 <= stats["busy_frac"] <= 1.0
    assert stats["upload_mb_s"] > 0.0
    assert stats["thread_wall_s"] > 0.0


@pytest.fixture(scope="module")
def course41():
    seq, cfg, intr = _setup(41)
    frames = list(seq)
    return frames, cfg, intr, pipeline.run_sequence_scan(
        frames, cfg, intr, chunk=8, warmup=False, device="cpu")


def test_parallel_uploader_matches_single_thread(course41):
    frames, cfg, intr, ref = course41
    stats = {}
    got = pipeline.run_sequence_scan(frames, cfg, intr, chunk=8,
                                     warmup=False, upload_threads=3,
                                     stats_out=stats, device="cpu")
    _assert_same(got, ref)
    assert stats["threads"] == 3
    assert stats["chunks"] == 4          # chunk 0 goes up before the pool
    assert stats["upload_bytes"] == 4 * 8 * 2 * H * W
    assert len(stats["per_thread"]) == 3
    assert sum(t["chunks"] for t in stats["per_thread"]) == 4
    assert stats["agg_upload_mb_s"] >= 0
    assert stats["busy_frac"] == max(t["busy_frac"]
                                     for t in stats["per_thread"])


def test_preupload_matches_streamed(course41):
    frames, cfg, intr, ref = course41
    stats = {}
    got = pipeline.run_sequence_scan(frames, cfg, intr, chunk=8,
                                     warmup=False, preupload=True,
                                     upload_threads=4, stats_out=stats,
                                     device="cpu")
    _assert_same(got, ref)
    # preupload takes the single uploader whatever ``upload_threads`` says
    assert stats["chunks"] == 4 and "threads" not in stats


def test_resumable_scan_through_upload_threads(course41, tmp_path):
    """The resumable scan through three upload threads, snapshots on: bit
    for bit ``run_sequence_scan`` (tests/test_torch_checkpoint.py holds
    the single thread to it)."""
    frames, cfg, intr, ref = course41

    class Seq:
        def __len__(self):
            return len(frames)

        def frame(self, i):
            return frames[i]

    stats, snaps = {}, []
    got = pipeline.run_sequence_scan_resumable(
        Seq(), cfg, intr, str(tmp_path / "ck.npz"), checkpoint_every=16,
        chunk=8, warmup=False, stats_out=stats, upload_threads=3,
        snapshot_stats=snaps, device="cpu")
    _assert_same(got, ref)
    assert stats["chunks"] == 5 and stats["threads"] == 3
    assert [s["step"] for s in snaps] == [16, 32]


class _FailingScan:
    """Stands in for ``make_scan_step_fn``: a chunk step that raises on its
    ``fail_at``-th call."""

    def __init__(self, fail_at):
        self.calls = 0
        self.fail_at = fail_at

    def __call__(self, config, intrinsics, with_tracks=False, device=None):
        def scan_chunk(state, lefts, rights):
            self.calls += 1
            if self.calls == self.fail_at:
                raise RuntimeError("injected step failure")
            return (state,)
        return scan_chunk


def _tiny_frames(n, fail_at=None):
    for i in range(n):
        if i == fail_at:
            raise OSError("injected decode failure")
        yield (np.full((H, W), i % 251, np.uint8),
               np.full((H, W), i % 251, np.uint8))


@pytest.mark.parametrize("threads", [1, 3])
def test_step_failure_leaves_no_uploader_thread(monkeypatch, threads):
    _, cfg, intr = _setup(2)
    monkeypatch.setattr(pipeline, "make_scan_step_fn", _FailingScan(2))
    with pytest.raises(RuntimeError, match="injected step failure"):
        pipeline.run_sequence_scan(_tiny_frames(41), cfg, intr, chunk=4,
                                   warmup=False, upload_threads=threads,
                                   device="cpu")
    assert not _uploader_threads()


@pytest.mark.parametrize("threads", [1, 3])
def test_source_failure_reaches_the_caller(monkeypatch, threads):
    """A frame source that raises in an uploader thread: the error comes
    back on the caller (through ``finish()`` or ``get()``), and no uploader
    thread stays alive."""
    _, cfg, intr = _setup(2)
    scan = _FailingScan(fail_at=None)
    monkeypatch.setattr(pipeline, "make_scan_step_fn", scan)
    monkeypatch.setattr(pipeline, "_fetch_chunks", lambda outs: [])
    with pytest.raises(OSError, match="injected decode failure"):
        pipeline.run_sequence_scan(_tiny_frames(41, fail_at=30), cfg, intr,
                                   chunk=4, warmup=False,
                                   upload_threads=threads, device="cpu")
    assert not _uploader_threads()
    assert scan.calls <= 8          # frames 1..28 at most: chunks 0..6


def test_scan_fetches_only_after_its_last_chunk(monkeypatch):
    """Every chunk is dispatched before the first fetch: the loop never
    waits for the device. Then two fetches: the last chunk's (the wall
    stops on it) and the others' in one copy."""
    seq, cfg, intr = _setup(9)
    events = []
    make_scan = pipeline.make_scan_step_fn
    fetch = pipeline._fetch_chunks

    def logged_make_scan(*args, **kw):
        scan_chunk = make_scan(*args, **kw)

        def logged(*a):
            events.append("chunk")
            return scan_chunk(*a)
        return logged

    def logged_fetch(outs):
        events.append(f"fetch {len(outs)}")
        return fetch(outs)

    monkeypatch.setattr(pipeline, "make_scan_step_fn", logged_make_scan)
    monkeypatch.setattr(pipeline, "_fetch_chunks", logged_fetch)
    poses, fetched, _, n = pipeline.run_sequence_scan(
        iter(seq), cfg, intr, chunk=2, warmup=False, device="cpu")
    assert n == 8 and fetched.T_inv.shape == (8, 4, 4)
    assert events == ["chunk"] * 4 + ["fetch 1", "fetch 3"]


def test_many_threads_deliver_every_chunk_once_in_order():
    """32 upload threads (more than cores) with a 1 us switch interval:
    200 chunks arrive in order, each once, and the stats add up."""
    def chunks():
        for i in range(200):
            a = np.full((2, 3, 5), i, np.int32)
            yield a, a + 1, 2

    stats = {}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        up = pipeline._ParallelChunkUploader(chunks(), torch.device("cpu"),
                                             threads=32, stats_out=stats)
        got = [int(item[0][0, 0, 0]) for item in iter(up.get, None)]
        up.finish()
    finally:
        sys.setswitchinterval(old)
    assert got == list(range(200))
    assert stats["chunks"] == 200 and stats["threads"] == 32
    assert stats["upload_bytes"] == 200 * 2 * 2 * 3 * 5 * 4
    assert not _uploader_threads()
