"""The spans and counters of the port's collectives between ranks and of
its chunk uploader, on gloo ranks on the CPU. This file is also each rank:

    python tests/test_torch_rank_spans.py <host:port> <world> <rank> <dir>

A chunked ``run_sequences_batched`` over a (2, 1) and a (4, 1) mesh of
ranks (B = world + 1: the rows split unevenly), recorded on every rank
(``utils.profiling``):

- the ``collective.gather`` spans, labelled with their bytes, add up to the
  counter ``collective.bytes``, which is the bytes the all-gathers wrote;
- ``collective.calls`` counts every all-gather issued, and those over the
  data group are one per chunk and output field;
- ``upload.bytes`` equals the bytes of the chunks the uploader was handed,
  whatever part of B a rank uploads;
- with ``profiling.recording(False)`` nothing is recorded;
- a gather noted inside a capture (``utils.cudagraph``'s list of issued
  collectives) records nothing.

Each rank has a time limit and is killed in a ``finally``; about 1 minute
alone.
"""

import math
import os
import socket
import subprocess
import sys
import time

import pytest
import torch

torch.set_num_threads(1)

from visual_odom_tpu_torch.config import CameraIntrinsics, VOConfig  # noqa: E402
from visual_odom_tpu_torch.io.synthetic import (  # noqa: E402
    SyntheticStereoSequence)
from visual_odom_tpu_torch.parallel import collectives  # noqa: E402
from visual_odom_tpu_torch.parallel.batch_eval import (  # noqa: E402
    run_sequences_batched)
from visual_odom_tpu_torch.parallel.mesh import (  # noqa: E402
    initialize_distributed, make_mesh, mesh_axis, visible_devices)
from visual_odom_tpu_torch.runner import pipeline  # noqa: E402
from visual_odom_tpu_torch.utils import cudagraph, profiling  # noqa: E402

H, W = 120, 160
INTR = dict(fx=120.0, fy=120.0, cx=W / 2, cy=H / 2, bf=-120.0 * 0.54,
            width=W, height=H)
STEPS, CHUNK = 4, 3
TIMEOUT = 120
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---- one rank ----------------------------------------------------------------


def _run(world: int, mesh):
    intr = CameraIntrinsics(**INTR)
    sequences = [list(SyntheticStereoSequence(intr, num_frames=STEPS + 1,
                                              seed=s, speed=0.5))
                 for s in range(world + 1)]
    cfg = VOConfig.for_image(H, W, ransac_iterations=100, lk_max_iters=10)
    run_sequences_batched(sequences, cfg, intr, seed=1, chunk=CHUNK,
                          mesh=mesh)


def rank_main(coordinator: str, world: str, rank: str, where: str) -> int:
    world, rank = int(world), int(rank)
    initialize_distributed(coordinator=coordinator, num_processes=world,
                           process_id=rank, device="cpu")
    mesh = make_mesh({"data": world, "model": 1}, visible_devices())
    data = mesh_axis(mesh, "data").group
    mesh_axis(mesh, "model")
    handed, gathers = [], []
    upload, all_gather = pipeline._upload, torch.distributed.all_gather

    def counted_upload(host, dev, stream):
        handed.append(sum(a.nbytes for a in host))
        return upload(host, dev, stream)

    def counted_gather(out, x, group=None, **kw):
        gathers.append((group is data, sum(t.nbytes for t in out)))
        return all_gather(out, x, group=group, **kw)

    pipeline._upload = counted_upload
    torch.distributed.all_gather = counted_gather
    profiling._reset()
    _run(world, mesh)
    on = profiling.records()
    res = {"spans": [tuple(s) for s in on.spans], "counters": on.counters,
           "handed": sum(handed), "gathers": list(gathers)}
    profiling._reset()
    was = profiling.recording(False)
    _run(world, mesh)
    off = profiling.records()
    profiling.recording(was)
    res["off"] = (len(off.spans), off.counters)
    profiling._reset()
    with cudagraph._issuing() as issued:
        collectives.gather([torch.arange(3.0)], mesh_axis(mesh, "data"))
    inside = profiling.records()
    res["captured"] = (len(issued), len(inside.spans), inside.counters)
    torch.distributed.all_gather = all_gather
    torch.distributed.destroy_process_group()
    torch.save(res, os.path.join(where, f"rank{rank}.pt"))
    return 0


# ---- the launcher --------------------------------------------------------------


def _ranks(world: int, where: str) -> list:
    """Each rank's results; every rank killed at TIMEOUT. Retries once on
    a port taken between choosing and binding it."""
    env = dict(os.environ, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    for attempt in (0, 1):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            coordinator = f"127.0.0.1:{s.getsockname()[1]}"
        logs = [os.path.join(where, f"rank{r}.log") for r in range(world)]
        procs = []
        try:
            for r in range(world):
                with open(logs[r], "w") as log:
                    procs.append(subprocess.Popen(
                        [sys.executable, os.path.abspath(__file__),
                         coordinator, str(world), str(r), where], env=env,
                        stdout=log, stderr=subprocess.STDOUT))
            deadline = time.monotonic() + TIMEOUT
            for p in procs:
                try:
                    p.wait(timeout=max(0.1, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    break
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if all(p.returncode == 0 for p in procs):
            return [torch.load(os.path.join(where, f"rank{r}.pt"),
                               weights_only=False) for r in range(world)]
        text = [open(f).read() for f in logs]
        if attempt == 0 and any("ddress already in use" in t for t in text):
            continue
        raise AssertionError(f"{world} ranks failed:\n"
                             + "\n".join(t[-3000:] for t in text))


@pytest.fixture(scope="module", params=[2, 4], ids=["2ranks", "4ranks"])
def ranks(request, tmp_path_factory):
    world = request.param
    return world, _ranks(world, str(tmp_path_factory.mktemp(f"r{world}")))


def _gather_spans(res) -> list:
    return [s for s in res["spans"] if s[0] == "collective.gather"]


def test_gather_spans_add_up_to_the_bytes_counter(ranks):
    _, results = ranks
    for res in results:
        spans = _gather_spans(res)
        assert spans
        assert sum(int(s[1]) for s in spans) == res["counters"][
            "collective.bytes"]
        assert res["counters"]["collective.bytes"] == sum(
            b for _, b in res["gathers"])
        assert {s[0] for s in res["spans"]
                if s[0].startswith("collective.")} == {"collective.gather"}


def test_calls_count_one_data_gather_per_chunk_and_field(ranks):
    _, results = ranks
    chunks = math.ceil(STEPS / CHUNK)
    for res in results:
        assert res["counters"]["collective.calls"] == len(res["gathers"])
        assert len(_gather_spans(res)) == len(res["gathers"])
        over_data = sum(d for d, _ in res["gathers"])
        assert over_data == chunks * len(pipeline.StepOutput._fields)


def test_upload_bytes_count_the_chunks_the_uploader_was_handed(ranks):
    _, results = ranks
    frame = 2 * H * W                   # a left and a right, uint8
    for res in results:
        assert res["counters"]["upload.bytes"] == res["handed"]
        # whole chunks of whole frames, every chunk of the run
        per_chunk, rest = divmod(res["handed"],
                                 math.ceil(STEPS / CHUNK) * CHUNK * frame)
        assert per_chunk >= 1 and rest == 0


def test_nothing_is_recorded_with_the_recorder_off(ranks):
    _, results = ranks
    for res in results:
        assert res["off"] == (0, {})


def test_a_gather_inside_a_capture_records_nothing(ranks):
    _, results = ranks
    for res in results:
        assert res["captured"] == (1, 0, {})


if __name__ == "__main__":
    sys.exit(rank_main(*sys.argv[1:5]))
