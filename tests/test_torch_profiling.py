"""The span recorder (``utils.profiling``) and the spans the front doors
open, on the CPU.

- Spans nest on a thread (parent: the innermost span open there); a span
  with none open starts a request, and a helper thread's spans join the
  request handed to them; the ring keeps its last ``size`` records and
  counts what it drops; ``recording(False)`` records and counts nothing,
  and a span still times its block.
- A span opens a range only while a ``torch.profiler`` runs, and the
  range is in the profile, as an op (no user annotation, which the
  profiler would mirror onto a device's timeline).
- ``run_sequences_batched``, chunked and stepwise, records the
  ``runner.*`` spans under one ``runner.call`` and its uploader's
  ``upload.*`` spans in the call's request; ``runner.loop`` is its
  ``wall_seconds``. The uploaders' ``stats_out`` keeps its keys, with the
  recorder on and off.
- ``VisualOdometry`` records ``vo.initialize``, ``vo.process_frame`` (its
  ``frame_time_ms``) and ``vo.chain``, eagerly and through the CPU form of
  its graph (``GraphedStep(_replay_body=True)``), where each frame also
  records ``graph.input``, ``graph.replay``, ``graph.fetch`` and
  ``graph.snapshot``, and the first a ``graph.capture`` and a count of
  ``graph.captures``.
"""

import collections
import sys
import threading
import time

import numpy as np
import pytest
import torch

from visual_odom_tpu_torch.config import CameraIntrinsics, VOConfig
from visual_odom_tpu_torch.io.synthetic import SyntheticStereoSequence
from visual_odom_tpu_torch.parallel.batch_eval import run_sequences_batched
from visual_odom_tpu_torch.runner import pipeline
from visual_odom_tpu_torch.utils import cudagraph, profiling

torch.set_num_threads(1)

H, W = 120, 160
INTR = dict(fx=120.0, fy=120.0, cx=80.0, cy=60.0, bf=-64.8, width=W, height=H)
#: as tests/test_torch_front_doors.py: the plain LK quad makes a CPU step
#: ~0.4 s at this size
CFG = dict(ransac_iterations=100, lk_max_iters=10)
N_FRAMES = 5


@pytest.fixture(scope="module")
def setup():
    intr = CameraIntrinsics(**INTR)
    cfg = VOConfig.for_image(H, W, **CFG)
    seqs = [SyntheticStereoSequence(intr, num_frames=N_FRAMES, seed=s)
            for s in (0, 1)]
    frames = [[seq.frame(i) for i in range(N_FRAMES)] for seq in seqs]
    return cfg, intr, frames


@pytest.fixture(autouse=True)
def recorder():
    """Every test starts with the recorder on and an empty ring, and
    leaves it so."""
    profiling._reset()
    was = profiling.recording(True)
    yield
    profiling.recording(was)
    profiling._reset()


def _since(t0: int) -> list:
    return profiling.records(t0).spans


def _by_name(spans) -> dict:
    out = collections.defaultdict(list)
    for s in spans:
        out[s.name].append(s)
    return out


# --- the recorder -------------------------------------------------------------


def test_spans_nest_and_requests_group_them():
    t0 = time.perf_counter_ns()
    with profiling.span("a") as a:
        with profiling.span("b", label="x") as b:
            with profiling.span("c") as c:
                pass
        req = profiling.current_request()
        got = []
        th = threading.Thread(target=lambda: got.append(
            _in_thread(req)))
        th.start()
        th.join()
    with profiling.span("d") as d:
        pass
    spans = {s.name: s for s in _since(t0)}
    assert set(spans) == {"a", "b", "c", "d", "t1", "t2"}
    assert spans["a"].parent == 0 and spans["d"].parent == 0
    assert spans["b"].parent == a.id and spans["c"].parent == b.id
    assert spans["b"].label == "x" and spans["c"].label == ""
    assert spans["a"].request == spans["b"].request == spans["c"].request
    assert spans["d"].request != spans["a"].request
    # the helper thread's spans: the caller's request, parents on their
    # own thread
    assert req == spans["a"].request
    assert spans["t1"].request == spans["t2"].request == req
    assert spans["t1"].parent == 0 and spans["t2"].parent == spans["t1"].id
    assert spans["t1"].thread == got[0] != spans["a"].thread
    assert spans["a"].thread == threading.get_ident()
    for s in spans.values():
        assert s.start_ns <= s.end_ns
    assert spans["a"].start_ns <= spans["b"].start_ns <= spans["c"].start_ns
    assert spans["c"].end_ns <= spans["b"].end_ns <= spans["a"].end_ns
    assert c.seconds == (spans["c"].end_ns - spans["c"].start_ns) / 1e9
    # spans close in order: the records are in the order they closed
    assert [s.name for s in _since(t0)] == ["c", "b", "t2", "t1", "a", "d"]
    assert d.id > a.id


def _in_thread(req: int) -> int:
    with profiling.span("t1", request=req):
        with profiling.span("t2"):
            pass
    return threading.get_ident()


def test_a_new_request_where_no_span_is_open():
    first = profiling.current_request()
    assert profiling.current_request() != first
    with profiling.span("a", request=first) as a:
        assert profiling.current_request() == first == a.request


def test_the_ring_keeps_its_last_records_and_counts_the_dropped():
    profiling._reset(size=4)
    made = []
    for k in range(6):
        with profiling.span(f"s{k}") as sp:
            made.append(sp)
    rec = profiling.records()
    assert [s.name for s in rec.spans] == ["s2", "s3", "s4", "s5"]
    assert rec.dropped == 2 and not rec.complete
    # a window that s1 (dropped) ended in is not complete; one after it is
    assert not profiling.records(made[1].end_ns).complete
    after = profiling.records(made[1].end_ns + 1)
    assert after.complete and [s.name for s in after.spans] == [
        "s2", "s3", "s4", "s5"]


@pytest.mark.parametrize("ring", [1 << 17, 1000], ids=["whole", "full"])
def test_threads_record_every_span_once(ring):
    """24 threads (more than cores) with a 1 us switch interval open nested
    spans and count: every span is kept or counted as dropped, once, with
    its thread's parent and request, and no count is lost."""
    profiling._reset(size=ring)
    n, threads = 300, 24
    errors = []

    def work():
        try:
            for _ in range(n):
                with profiling.span("outer") as outer:
                    with profiling.span("inner") as inner:
                        profiling.count("spans", 2)
                    assert inner.parent == outer.id
                    assert inner.request == outer.request
        except AssertionError as e:
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ths = [threading.Thread(target=work) for _ in range(threads)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not errors and not any(t.is_alive() for t in ths)
    rec = profiling.records()
    total = 2 * n * threads
    assert rec.counters == {"spans": total}
    assert len(rec.spans) + rec.dropped == total
    assert len(rec.spans) == min(ring, total)
    assert len({s.id for s in rec.spans}) == len(rec.spans)
    outers = {s.id: s for s in rec.spans if s.name == "outer"}
    for s in rec.spans:
        if s.name == "inner" and s.parent in outers:
            o = outers[s.parent]
            assert (o.thread, o.request) == (s.thread, s.request)
    assert rec.complete is (ring >= total)


def test_windows_select_whole_spans():
    with profiling.span("outer") as outer:
        with profiling.span("inner") as inner:
            pass
    names = lambda rec: [s.name for s in rec.spans]   # noqa: E731
    assert names(profiling.records(outer.start_ns, outer.end_ns)) == [
        "inner", "outer"]
    assert names(profiling.records(inner.start_ns, inner.end_ns)) == [
        "inner"]
    assert names(profiling.records(outer.start_ns + 1, inner.end_ns)) == [
        "inner"]


def test_counters_add_and_are_read_with_the_records():
    profiling.count("x")
    profiling.count("x", 4)
    profiling.count("y", 2)
    assert profiling.records().counters == {"x": 5, "y": 2}


def test_recording_off_records_and_counts_nothing():
    assert profiling.recording(False) is True
    with profiling.span("off") as sp:
        time.sleep(0.001)
    profiling.count("off")
    assert sp.seconds >= 0.001             # still the caller's stopwatch
    assert profiling.recording(True) is False
    rec = profiling.records()
    assert rec.spans == [] and rec.counters == {} and rec.dropped == 0


# --- under a profiler ---------------------------------------------------------


def test_spans_open_ranges_only_under_a_profiler(monkeypatch):
    opened = []
    real = profiling._Range

    def opening(name):
        opened.append(name)
        return real(name)

    monkeypatch.setattr(profiling, "_Range", opening)
    with profiling.span("vo.unprofiled"):
        torch.ones(8).sum()
    assert opened == []
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    try:
        with profiling.span("vo.profiled"):
            with profiling.span("vo.profiled_inner"):
                torch.ones(64).cumsum(0)
    finally:
        prof.stop()
    with profiling.span("vo.after"):
        pass
    assert opened == ["vo.profiled", "vo.profiled_inner"]
    names = {e.key for e in prof.key_averages()}
    assert {"vo.profiled", "vo.profiled_inner"} <= names
    assert "vo.unprofiled" not in names and "vo.after" not in names
    # ops, not user annotations: nothing mirrored onto a device's timeline
    ranges = [e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("vo.")]
    assert len(ranges) == 2 and not any(e.is_user_annotation()
                                        for e in ranges)
    # the recorder kept all four, profiled or not
    assert [s.name for s in profiling.records().spans] == [
        "vo.unprofiled", "vo.profiled_inner", "vo.profiled", "vo.after"]


# --- the batched runner and its uploaders -------------------------------------


def _runner_spans(t0):
    spans = _since(t0)
    (call,) = [s for s in spans if s.name == "runner.call"]
    mine = [s for s in spans if s.request == call.request]
    return call, _by_name(mine), spans


@pytest.mark.parametrize("chunk", [2, 0], ids=["chunked", "stepwise"])
def test_batched_runner_records_its_spans(setup, chunk):
    cfg, intr, frames = setup
    t0 = time.perf_counter_ns()
    _, _, wall = run_sequences_batched(frames, cfg, intr, seed=3,
                                       chunk=chunk, device="cpu")
    call, by, spans = _runner_spans(t0)
    n_steps = N_FRAMES - 1
    waits = n_steps // chunk if chunk else n_steps
    assert call.parent == 0 and call.thread == threading.get_ident()
    assert {k: len(v) for k, v in by.items() if k.startswith("runner.")} == {
        "runner.call": 1, "runner.setup": 1, "runner.loop": 1,
        "runner.wait_upload": waits, "runner.enqueue": waits,
        "runner.fetch": 1, "runner.chain": 1}
    (setup_sp,), (loop,), (chain,) = (by["runner.setup"], by["runner.loop"],
                                      by["runner.chain"])
    for s in (setup_sp, loop, chain):
        assert s.parent == call.id
    for name in ("runner.wait_upload", "runner.enqueue", "runner.fetch"):
        assert all(s.parent == loop.id for s in by[name])
    assert setup_sp.end_ns <= loop.start_ns and loop.end_ns <= chain.start_ns
    assert wall == (loop.end_ns - loop.start_ns) / 1e9
    # the uploader's (or prefetcher's) spans: another thread, the call's
    # request, top-level there
    ups = [s for k, v in by.items() if k.startswith("upload.") for s in v]
    assert ups and all(s.parent == 0 and s.thread != call.thread
                       for s in ups)
    if chunk:
        assert len(by["upload.copy"]) == n_steps // chunk
        assert len(by["upload.stack"]) == n_steps // chunk + 1   # and None
    else:
        assert set(by) - {"upload.stack"} == {
            k for k in by if k.startswith("runner.")}
        assert len(by["upload.stack"]) == n_steps
    assert all(call.start_ns <= s.start_ns and s.end_ns <= call.end_ns
               for s in spans if s.request == call.request)


def _chunks(n):
    for i in range(n):
        a = np.full((2, 3, 5), i, np.uint8)
        yield a, a + 1, 2


@pytest.mark.parametrize("on", [True, False], ids=["on", "off"])
@pytest.mark.parametrize("threads", [1, 3])
def test_uploader_stats_come_from_its_spans(on, threads):
    profiling.recording(on)
    stats = {}
    t0 = time.perf_counter_ns()
    with profiling.span("caller") as caller:
        up = pipeline._uploader(_chunks(6), torch.device("cpu"), threads,
                                stats)
    got = [int(item[0][0, 0, 0]) for item in iter(up.get, None)]
    up.finish()
    assert got == list(range(6))
    keys = {"decode_s", "upload_s", "upload_bytes", "thread_wall_s",
            "chunks", "busy_frac", "upload_mb_s"}
    if threads > 1:
        for t in stats["per_thread"]:
            assert set(t) == keys
        assert stats["pool_wall_s"] >= max(t["thread_wall_s"]
                                           for t in stats["per_thread"])
        keys = keys - {"thread_wall_s"} | {
            "threads", "pool_wall_s", "per_thread", "agg_upload_mb_s"}
    assert set(stats) == keys
    assert stats["chunks"] == 6 and stats["upload_bytes"] == 6 * 2 * 30
    assert 0.0 <= stats["busy_frac"] <= 1.0
    if threads == 1:
        assert stats["thread_wall_s"] >= stats["decode_s"] + stats["upload_s"]
    spans = [s for s in _since(t0) if s.name.startswith("upload.")]
    if not on:
        assert spans == []
        return
    by = _by_name(spans)
    assert len(by["upload.copy"]) == 6
    assert all(s.request == caller.request for s in spans)
    copy_s = sum(s.end_ns - s.start_ns for s in by["upload.copy"]) / 1e9
    assert stats["upload_s"] == pytest.approx(copy_s, rel=1e-9)
    if threads == 1:
        stack_s = sum(s.end_ns - s.start_ns for s in by["upload.stack"]) / 1e9
        assert stats["decode_s"] == pytest.approx(stack_s, rel=1e-9)


def test_a_blocked_put_is_a_queue_full_span():
    """A consumer that takes its first chunk late: the uploader's puts
    wait on the full queue, as ``upload.queue_full`` spans."""
    t0 = time.perf_counter_ns()
    stats = {}
    up = pipeline._ChunkUploader(_chunks(5), torch.device("cpu"), maxsize=1,
                                 stats_out=stats)
    time.sleep(0.05)
    got = [int(item[0][0, 0, 0]) for item in iter(up.get, None)]
    up.finish()
    assert got == list(range(5))
    full = [s for s in _since(t0) if s.name == "upload.queue_full"]
    assert full and full[0].end_ns - full[0].start_ns >= 0.03e9
    assert stats["busy_frac"] < 0.5


# --- the live door ------------------------------------------------------------


@pytest.fixture
def graph_form(monkeypatch):
    """``VisualOdometry`` through its graph path in the CPU form."""
    def graphed_step(config, intrinsics, with_tracks, device):
        return cudagraph.GraphedStep(pipeline.make_step_fn(
            config, intrinsics, with_tracks=with_tracks, device=device),
            device, _replay_body=True)

    monkeypatch.setattr(pipeline, "use_graph",
                        lambda device, graphed=None: graphed is not False)
    monkeypatch.setattr(pipeline, "_graphed_step", graphed_step)


def _live(setup, n=3):
    cfg, intr, frames = setup
    vo = pipeline.VisualOdometry(cfg, intr, seed=5, device="cpu")
    t0 = time.perf_counter_ns()
    vo.initialize(*frames[0][0])
    results = [vo.process_frame(*frames[0][i]) for i in range(1, n + 1)]
    return vo, results, _since(t0)


GRAPH_SPANS = ("graph.input", "graph.replay", "graph.fetch", "graph.snapshot")


@pytest.mark.parametrize("form", ["eager", "graph"])
def test_live_door_records_its_spans(setup, request, form):
    if form == "graph":
        request.getfixturevalue("graph_form")
    vo, results, spans = _live(setup)
    assert (vo._graphed is not None) == (form == "graph")
    (init,) = [s for s in spans if s.name == "vo.initialize"]
    frames = [s for s in spans if s.name == "vo.process_frame"]
    assert len(frames) == len(results) == 3
    reqs = {init.request} | {f.request for f in frames}
    assert len(reqs) == 4                    # a request each
    for f, r in zip(frames, results):
        assert f.parent == 0
        assert r.frame_time_ms == pytest.approx(
            (f.end_ns - f.start_ns) / 1e6, rel=1e-12)
        inside = _by_name(s for s in spans if s.request == f.request
                          and s is not f)
        want = {"vo.chain": 1}
        if form == "graph":
            want.update({k: 1 for k in GRAPH_SPANS})
            if f is frames[0]:
                want["graph.capture"] = 1
        assert {k: len(v) for k, v in inside.items()} == want
        assert all(s.parent == f.id for v in inside.values() for s in v)
        if form == "graph":
            order = [inside[k][0] for k in GRAPH_SPANS + ("vo.chain",)]
            assert all(a.end_ns <= b.start_ns
                       for a, b in zip(order, order[1:]))
    if form == "graph":
        (cap,) = [s for s in spans if s.name == "graph.capture"]
        assert cap.label == "make_step_fn.<locals>.step"
        assert profiling.records().counters == {"graph.captures": 1}
