"""The ranks door on 4 gloo ranks on the CPU, at a tiny size: a whole run
is correct against the reference, the ranks' poses are equal, the span
readers read numbers and the device readers None; a rank that raises or
dies makes the job raise here with its reason, within a minute, and leaves
no rank behind; each data row's poses equal its clips run alone. On
synthetic events: the trace a rank ships counts an all-gather once."""

import math
import multiprocessing
import os
import time

import pytest
import torch

from vobench import bank as bank_mod, spec
from vobench.doors import ranks
from vobench.run import run_cell
from vobench.tests.test_vobench_run import H, W, program
from vobench.trace import Spans

torch.set_num_threads(1)

TRAFFIC = {"door": "ranks", "clips": 4, "clip_frames": 5, "offset_max": 12,
           "chunk": 2, "ranks": 4, "mesh": [4, 1]}
SEED = 2 ** 31 + 23
SPAN_READERS = ("ranks.upload_busy_share", "ranks.upload_mb_per_frame")
DEVICE_READERS = ("ranks.collective_share", "ranks.device_ms_per_frame")


@pytest.fixture(scope="module")
def bank():
    return bank_mod.render(20, H, W, course_frames=60, workers=1)


def tiny() -> spec.Cell:
    return spec.load_cell("ranks4.batch44")._replace(traffic=TRAFFIC)


def test_a_traced_run_is_correct_and_the_ranks_agree(bank, monkeypatch):
    jobs = []
    real = ranks.Door.run

    def kept(self, *args, **kwargs):
        jobs.append(real(self, *args, **kwargs))
        return jobs[-1]

    monkeypatch.setattr(ranks.Door, "run", kept)
    res = run_cell(tiny(), SEED, 0.01, True, "cpu", bank=bank,
                   program=program())
    assert res["correct"] is True
    assert res["device"]["count"] == 4
    for job in jobs:
        digests = {r["digest"] for r in job.counters["ranks"]}
        assert len(digests) == 1
        assert digests == {ranks._digest(
            job.poses, [{"mean_inliers": m} for m in job.mean_inliers])}
    metrics = res["metrics"]
    for name in SPAN_READERS:
        assert math.isfinite(metrics[name]["value"])
    assert 0 < metrics["ranks.upload_busy_share"]["value"] <= 100
    # between a row's frame pair and every clip's
    frame_mb = 2 * H * W / 1e6
    assert (frame_mb - 1e-12 <= metrics["ranks.upload_mb_per_frame"]["value"]
            <= TRAFFIC["clips"] * frame_mb + 1e-12)
    assert not set(DEVICE_READERS) & set(metrics)
    assert multiprocessing.active_children() == []


def _raises(conn, rank, *args):
    """``ranks._serve`` whose rank 1 raises in its first job."""
    if rank == 1:
        def broken(*a, **k):
            raise ValueError("a fault put into rank 1")

        ranks._job = broken
    ranks._serve(conn, rank, *args)


def _dies(conn, rank, *args):
    """``ranks._serve`` whose rank 2 dies in its first job."""
    if rank == 2:
        ranks._job = lambda *a, **k: os._exit(3)
    ranks._serve(conn, rank, *args)


@pytest.mark.parametrize("serve,reason", [
    (_raises, "ValueError: a fault put into rank 1"),
    (_dies, "rank 2 died (exit code 3)")], ids=["raises", "dies"])
def test_a_failing_rank_fails_the_job_and_leaves_no_rank(bank, serve,
                                                         reason):
    class Door(ranks.Door):
        pass

    Door.serve = staticmethod(serve)
    cfg, intr = program()
    door = Door(TRAFFIC, bank, cfg, intr, torch.device("cpu"), Spans())
    t = time.monotonic()
    with pytest.raises(RuntimeError, match="the ranks door") as err:
        door.job(SEED, 0, traced=False)
    assert time.monotonic() - t < 60
    assert reason in str(err.value)
    assert multiprocessing.active_children() == []
    with pytest.raises(RuntimeError, match="have ended"):
        door.job(SEED, 1, traced=False)


def test_each_row_equals_its_clips_run_alone(bank):
    """A job's poses on the ranks against ``run_sequences_batched`` of each
    data row's clips on one device, seeded as the row's rank seeds them:
    bit for bit."""
    import numpy as np

    from visual_odom_tpu_torch.parallel.batch_eval import \
        run_sequences_batched

    cfg, intr = program()
    door = ranks.Door(TRAFFIC, bank, cfg, intr, torch.device("cpu"),
                      Spans())
    job = door.job(SEED, 0, traced=False)
    del door
    per_row = TRAFFIC["clips"] // TRAFFIC["mesh"][0]
    for a in range(0, TRAFFIC["clips"], per_row):
        clips = [bank_mod.Clip(bank, s, TRAFFIC["clip_frames"])
                 for s in job.starts[a:a + per_row]]
        poses, stats, _ = run_sequences_batched(
            clips, cfg, intr, seed=job.ransac_seed + a,
            chunk=TRAFFIC["chunk"], device="cpu")
        for p, q in zip(poses, job.poses[a:a + per_row]):
            np.testing.assert_array_equal(p, q)
        assert [s["mean_inliers"] for s in stats] == job.mean_inliers[
            a:a + per_row]


class _Kineto:
    """A profiler event as the profiler hands them out."""

    def __init__(self, name, start, dur, cuda, annotation=False):
        self._n, self._s, self._d = name, start, dur
        self._t = (torch.autograd.DeviceType.CUDA if cuda
                   else torch.autograd.DeviceType.CPU)
        self._a = annotation

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return self._t

    def is_user_annotation(self):
        return self._a


def test_the_shipped_trace_counts_an_all_gather_once():
    """A collective's annotation on the device spans its kernel: the door
    ships the kernel alone, so the reduction and the NCCL sum count it
    once."""
    from types import SimpleNamespace

    from vobench.trace import WINDOW, reduce_trace

    window = SimpleNamespace(host_start_ns=0, events=[
        _Kineto(WINDOW, 0, 1000, cuda=False),
        _Kineto(WINDOW, 0, 1000, cuda=True, annotation=True),
        _Kineto("cudaGraphLaunch", 5, 2, cuda=False),
        _Kineto("aten::add", 6, 1, cuda=False),
        _Kineto("fast_kernel", 10, 100, cuda=True),
        _Kineto("nccl:all_gather", 200, 300, cuda=True, annotation=True),
        _Kineto("ncclDevKernel_AllGather_RING_LL", 200, 300, cuda=True)])
    compact = ranks._compact(window)
    assert sorted(compact["names"]) == sorted(
        [WINDOW, "cudaGraphLaunch", "fast_kernel",
         "ncclDevKernel_AllGather_RING_LL"])
    d = reduce_trace(ranks.RankTrace(compact))
    assert (d.kernels, d.kernel_s, d.runtime_calls) == (2, 400e-9, 1)
    assert ranks._nccl(compact) == (300e-9, 1)


def test_the_configuration_states_the_layout_the_traffic_runs():
    """The cell's configuration names the mesh of ranks its traffic
    spawns, and keeps the one-card stereo configuration's step and camera."""
    cell = spec.load_cell("ranks4.batch44")
    conf, traffic = cell.config, cell.traffic
    assert conf["ranks"] == traffic["ranks"]
    assert conf["mesh"] == traffic["mesh"]
    assert conf["clips_per_rank"] * conf["mesh"][0] == traffic["clips"]
    assert conf["backend"] == "nccl"
    one_card = spec.load_cell("stereo.batch11").config
    assert conf["vo"] == one_card["vo"]
    assert conf["intrinsics"] == one_card["intrinsics"]
