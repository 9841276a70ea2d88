"""The traffic generator's draws, the window's job-rate rule, the all-frames
p95, the trace's union-based idle share and the check's per-frame gaps,
on synthetic inputs."""

import types

import numpy as np
import pytest

from vobench import check, doors, run, trace

TRAFFIC = {"door": "batched", "clips": 11, "clip_frames": 257,
           "offset_max": 256, "chunk": 32}
BIG = 2 ** 31 + 12345


@pytest.mark.parametrize("seed", [0, 7, BIG])
def test_clip_starts_repeat_for_a_seed(seed):
    a = doors.draw_job(seed, 0, 3, TRAFFIC)
    b = doors.draw_job(seed, 0, 3, TRAFFIC)
    assert a == b
    starts, rs = a
    assert len(starts) == 11 and all(0 <= s <= 256 for s in starts)
    assert 0 <= rs < 2 ** 31


def test_clip_starts_differ_between_seeds_jobs_and_streams():
    draws = {doors.draw_job(s, stream, j, TRAFFIC)[1]
             for s in (1, 2, BIG) for stream in (0, 1) for j in (0, 1)}
    assert len(draws) == 12
    assert (doors.draw_job(1, 0, 0, TRAFFIC)[0]
            != doors.draw_job(2, 0, 0, TRAFFIC)[0])


def test_accepts_from_poses():
    poses = np.stack([np.eye(4)] * 4)
    poses[2, 0, 3] = 1.0
    poses[3] = poses[2]
    assert doors.accepts_from_poses(poses).tolist() == [False, True, False]


class _FakeDoor:
    """Jobs of fixed durations on a fake clock."""

    def __init__(self, durations, steps=100):
        self.durations = durations
        self.steps = steps
        self.clock = 0.0

    def job(self, seed, index, traced):
        t0 = self.clock
        self.clock += self.durations[index]
        return types.SimpleNamespace(t0=t0, t1=self.clock, steps=self.steps,
                                     counters={})


def test_window_finishes_the_job_running_at_the_close(monkeypatch):
    door = _FakeDoor([4.0, 4.0, 4.0, 4.0])
    monkeypatch.setattr(run.time, "perf_counter", lambda: door.clock)
    jobs, window_s = run.window(door, 0, 10.0)
    assert len(jobs) == 3 and window_s == 12.0
    values = run.end_to_end(jobs, window_s, 1.5)
    assert values["frames_per_s"] == 300 / 12.0
    assert values["setup_s"] == 1.5
    assert "frame_latency_p95_ms" not in values


def test_window_runs_one_job_at_least(monkeypatch):
    door = _FakeDoor([30.0])
    monkeypatch.setattr(run.time, "perf_counter", lambda: door.clock)
    jobs, window_s = run.window(door, 0, 10.0)
    assert len(jobs) == 1 and window_s == 30.0


def test_p95_is_over_every_frame_of_every_job():
    lat_a = [0.010] * 90 + [0.020] * 10
    lat_b = [0.010] * 100
    jobs = [types.SimpleNamespace(steps=100, counters={"latencies": lat_a}),
            types.SimpleNamespace(steps=100, counters={"latencies": lat_b})]
    values = run.end_to_end(jobs, 2.0, 0.0)
    everything = np.percentile(np.array(lat_a + lat_b) * 1e3, 95)
    assert values["frame_latency_p95_ms"] == pytest.approx(everything)
    assert values["frame_latency_p95_ms"] == pytest.approx(10.0 + 0.05 * 10)


def test_union_and_gaps_do_not_double_count():
    iv = sorted([(0, 5), (3, 8), (10, 12), (11, 11), (15, 30)])
    assert trace.union_ns(iv, 2, 20) == 13
    assert trace.gaps_ns(iv, 2, 20) == [(8, 10), (12, 15)]
    assert trace.union_ns([(0, 10), (0, 10), (2, 3)], 0, 20) == 10
    assert trace.gaps_ns([], 0, 5) == [(0, 5)]


class _Event:
    def __init__(self, name, start, dur, device):
        self._n, self._s, self._d, self._dev = name, start, dur, device

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        import torch

        return (torch.autograd.DeviceType.CUDA if self._dev
                else torch.autograd.DeviceType.CPU)


def test_reduce_trace_on_synthetic_events():
    w = trace.SubWindow()
    w.host_start_ns = 1_000
    w.events = [
        _Event(trace.WINDOW, 1_000, 100, False),
        _Event(trace.WINDOW, 1_000, 100, True),      # device-side mirror
        _Event("cudaGraphLaunch", 1_005, 2, False),
        _Event("cudaMemcpyAsync", 1_007, 2, False),
        _Event("aten::add", 1_008, 2, False),
        _Event("kern_a", 1_010, 20, True),
        _Event("kern_b", 1_020, 20, True),           # overlaps kern_a
        _Event("lk_quad_kernel<true>", 1_060, 10, True),
        _Event("Memcpy HtoD (Pinned -> Device)", 1_080, 5, True),
        _Event("kern_a", 1_200, 5, True),            # after the window
    ]
    spans = [trace.Interval("runner", 1_000, 1_100),
             trace.Interval("process_frame", 1_040, 1_060)]
    d = trace.reduce_trace(w, spans)
    assert d.window_s == 100e-9
    assert d.busy_s == pytest.approx((30 + 10 + 5) * 1e-9)
    assert d.kernels == 3 and d.kernel_s == pytest.approx(50e-9)
    assert d.lk_kernels == 1 and d.lk_kernel_s == pytest.approx(10e-9)
    assert d.runtime_calls == 2
    assert d.device_ops[0][0] in ("kern_a", "kern_b")
    assert d.idle_gaps[0] == ["process_frame", pytest.approx(20e-9)]
    assert [g[0] for g in d.idle_gaps[1:]] == ["runner"] * 3
    assert sum(g[1] for g in d.idle_gaps) == pytest.approx(55e-9)


def _walk(steps):
    """Chained poses of (x translation, accepted) steps, and the
    reference's output of the same steps: T_inv is each frame delta, as
    ``chain_poses`` chains it."""
    poses, T_inv, accept = [np.eye(4)], [], []
    for dx, acc in steps:
        d = np.eye(4)
        d[0, 3] = dx
        poses.append(poses[-1] @ d if acc else poses[-1])
        T_inv.append(d)
        accept.append(acc)
    return np.stack(poses), np.asarray(T_inv), np.asarray(accept)


def test_frame_gaps_count_a_one_sided_accept_as_infinite():
    prog, _, acc_p = _walk([(1.0, True), (1.0, True), (1.0, False),
                            (1.0, False), (1.0, True)])
    _, T_inv, acc_r = _walk([(1.0, True), (1.5, True), (1.0, False),
                             (1.0, True), (1.0, True)])
    job = types.SimpleNamespace(starts=[0], poses=[prog], accept=[acc_p])
    ref = types.SimpleNamespace(T_inv=T_inv[:, None], accept=acc_r[:, None])
    t, r = check.frame_gaps(job, ref)
    assert t.shape == (1, 5)
    assert t[0].tolist() == [0.0, pytest.approx(0.5), 0.0, np.inf, 0.0]
    assert r[0, 3] == np.inf and np.all(r[0, [0, 1, 2, 4]] == 0.0)


def test_clip_quantile_sees_a_minority_the_median_does_not():
    gaps = np.zeros((3, 100))
    gaps[1, :30] = 2e-3               # 30 % of one clip's frames
    assert check.clip_quantile(gaps, 0.5) == 0.0
    assert check.clip_quantile(gaps, 0.75) == 2e-3
    gaps[2, :26] = np.inf             # never averaged away
    assert check.clip_quantile(gaps, 0.75) == np.inf
