"""The per-layer metrics read from the program's span recorder
(``runner.upload_wait_share``, ``upload.busy_share``,
``door.host_ms_per_frame``), on the CPU at a tiny size: a traced run of
each door reports its metrics, finite; each reads None with the recorder
off and with a record of its window dropped. The live door runs its graph
path in the CPU form (``GraphedStep(_replay_body=True)``), whose spans the
live metric reads."""

import math

import pytest
import torch

from visual_odom_tpu_torch.runner import pipeline
from visual_odom_tpu_torch.utils import cudagraph, profiling
from vobench import bank as bank_mod, spec
from vobench.run import Run, run_cell, setup
from vobench.tests.test_vobench_run import H, W, program, tiny

torch.set_num_threads(1)

METRICS = {"batched": ["runner.upload_wait_share", "upload.busy_share"],
           "live": ["door.host_ms_per_frame"]}
SEED = 2 ** 31 + 7


@pytest.fixture(scope="module")
def bank():
    return bank_mod.render(20, H, W, course_frames=60, workers=1)


@pytest.fixture(autouse=True)
def recorder():
    profiling._reset()
    was = profiling.recording(True)
    yield
    profiling.recording(was)
    profiling._reset()


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


@pytest.mark.parametrize("door", ["batched", "live"])
def test_a_traced_run_reports_them(bank, graph_form, door):
    cell = tiny(door)
    assert set(METRICS[door]) <= {m["name"] for m in cell.per_layer}
    res = run_cell(cell, SEED, 0.01, True, "cpu", bank=bank,
                   program=program())
    assert res["correct"] is True
    for name in METRICS[door]:
        value = res["metrics"][name]["value"]
        assert math.isfinite(value) and value > 0
        if name.endswith("_share"):
            assert value <= 100.0


def _job(bank, door):
    d = setup(tiny(door), torch.device("cpu"), bank, program()).door
    job = d.job(SEED, 0, traced=False)
    return Run([job], job.t1 - job.t0, None, None, None)


@pytest.mark.parametrize("door", ["batched", "live"])
def test_none_with_the_recorder_off_or_a_record_dropped(bank, graph_form,
                                                        door):
    readers = {n: spec.metric_reader(n) for n in METRICS[door]}
    run = _job(bank, door)
    assert all(r(run) is not None for r in readers.values())
    profiling.recording(False)
    run = _job(bank, door)
    profiling.recording(True)
    assert all(r(run) is None for r in readers.values())
    profiling._reset(size=3)
    run = _job(bank, door)
    assert profiling.records().dropped > 0
    assert all(r(run) is None for r in readers.values())
