"""The ranks door: a job's clips over a (data, model) mesh of
``torch.distributed`` ranks, one process a card, launched as ``torchrun``
launches ranks (``env://`` on localhost; NCCL, rank r on ``cuda:r``, or gloo
where the door's device is the CPU). Every rank calls
``parallel.batch_eval.run_sequences_batched(clips, ..., mesh=,
chunk=traffic["chunk"])`` on all of a job's clips: it steps its own data
row and receives every clip's poses through the all-gathers over its data
group.

The door loads the bank before it spawns ``traffic["ranks"]`` ranks (the
spawn start method), so that they do not render it at once; each rank
loads it again (``vobench.bank.load``; a bank of another size, a test's,
is handed over whole), builds its mesh of ``traffic["mesh"]`` once and
serves jobs until the door is collected or this process exits. A job's
``t0`` and ``t1`` are taken here, from handing the job over to receiving
rank 0's result. Every rank answers with a digest of its poses and mean
inliers (the door raises where two differ), its program spans of the job
(``utils.profiling.records`` over the job's ``perf_counter_ns`` range, one
clock on the host), the counters the job added and the frames it
stepped; they are the job's ``counters["ranks"][r]``, beside rank 0's
``runner_wall`` and ``fallback_frames``.

A traced job is profiled on every rank (``vobench.trace.SubWindow``) and
reduced there (``reduce_trace``). Each rank's reduction and its NCCL
kernels' seconds and count (a kernel whose name holds "nccl") are kept in
``TRACED`` for the device readers, since ``vobench.run.Run`` carries one
trace; rank 0's events come back as ``self.trace``, which ``vobench.run``
reduces as it reduces a ``SubWindow``. A rank that raises or dies makes the
job raise here with its traceback, and every rank is ended.
"""

from __future__ import annotations

import hashlib
import multiprocessing
import multiprocessing.connection
import os
import socket
import sys
import threading
import time
import traceback
import weakref
from typing import NamedTuple, Optional

import numpy as np
import torch

from vobench import bank as bank_mod
from vobench.doors import FrontDoor, Job, accepts_from_poses
from vobench.trace import RUNTIME_CALL, WINDOW, SubWindow, reduce_trace

#: seconds the ranks may take to start, a job to come back (the first
#: builds the kernels and captures the graphs) and the ranks to stop
START_S = 600
JOB_S = 1800
STOP_S = 60
#: per rank, the last traced job's ``RankTraced``
TRACED: list = []


class RankTraced(NamedTuple):
    trace: object          # vobench.trace.DeviceTrace of the rank's job
    nccl_s: float          # its NCCL kernels inside the window
    nccl_kernels: int


class RankWindow(NamedTuple):
    """What one rank shipped over the window's jobs."""

    spans: list            # utils.profiling.SpanRecords
    counters: dict         # summed over the jobs
    steps: int             # frames the rank stepped
    complete: bool         # no record of a job dropped


def window_ranks(run) -> Optional[list]:
    """Each rank's ``RankWindow`` over ``run.jobs``; None where a job was
    not run through this door."""
    per = [j.counters.get("ranks") for j in run.jobs]
    if not per or any(p is None for p in per):
        return None
    out = []
    for r in range(len(per[0])):
        counters = {}
        for p in per:
            for k, v in p[r]["counters"].items():
                counters[k] = counters.get(k, 0) + v
        out.append(RankWindow([s for p in per for s in p[r]["spans"]],
                              counters, sum(p[r]["steps"] for p in per),
                              all(p[r]["complete"] for p in per)))
    return out


# ---- the events of a traced job, shipped -----------------------------------


class _Event:
    """A profiler event as ``reduce_trace`` reads one."""

    __slots__ = ("_name", "_start", "_dur", "_type")

    def __init__(self, name, start, dur, device_type):
        self._name, self._start, self._dur = name, start, dur
        self._type = device_type

    def name(self) -> str:
        return self._name

    def start_ns(self) -> int:
        return self._start

    def duration_ns(self) -> int:
        return self._dur

    def device_type(self):
        return self._type


def _compact(window: SubWindow) -> dict:
    """The events of ``window`` that ``reduce_trace`` reads (the device's
    kernels, copies and sets, the window's range and the CUDA runtime
    calls), as arrays a pipe carries. A user annotation's image on the
    device is left out: ``torch.distributed`` wraps each NCCL collective
    in one (``nccl:all_gather``) spanning its kernel, which would count the
    kernel twice."""
    cuda = torch.autograd.DeviceType.CUDA
    events = window.events
    ns = hasattr(events[0], "start_ns") if events else True
    names, index, rows = [], {}, []
    for e in events:
        name = e.name()
        on_device = e.device_type() == cuda
        if on_device and e.is_user_annotation() and name != WINDOW:
            continue
        if not (on_device or name == WINDOW or RUNTIME_CALL.match(name)):
            continue
        if ns:
            s, d = e.start_ns(), e.duration_ns()
        else:
            s, d = int(e.start_us() * 1000), int(e.duration_us() * 1000)
        k = index.get(name)
        if k is None:
            k = index[name] = len(names)
            names.append(name)
        rows.append((k, s, d, on_device))
    return {"names": names, "host_start_ns": window.host_start_ns,
            "events": np.array(rows, dtype=[("name", "i4"), ("start", "i8"),
                                            ("dur", "i8"), ("cuda", "?")])}


class RankTrace:
    """A rank's traced job, read as ``reduce_trace`` reads a
    ``SubWindow``: ``events`` and ``host_start_ns``."""

    def __init__(self, compact: dict):
        types = {True: torch.autograd.DeviceType.CUDA,
                 False: torch.autograd.DeviceType.CPU}
        names = compact["names"]
        self.events = [_Event(names[k], s, d, types[c])
                       for k, s, d, c in compact["events"].tolist()]
        self.host_start_ns = compact["host_start_ns"]


def _nccl(compact: dict) -> tuple:
    """(seconds, count) of the NCCL kernels that started inside the traced
    window, as ``reduce_trace`` counts kernels."""
    ev, names = compact["events"], compact["names"]
    if WINDOW not in names:
        return 0.0, 0
    bounds = ev[(ev["name"] == names.index(WINDOW)) & ~ev["cuda"]][0]
    lo, hi = bounds["start"], bounds["start"] + bounds["dur"]
    nccl = np.array(["nccl" in n.lower() for n in names])
    mine = (ev["cuda"] & nccl[ev["name"]] & (ev["start"] >= lo)
            & (ev["start"] < hi))
    return float(ev["dur"][mine].sum()) / 1e9, int(mine.sum())


# ---- one rank ---------------------------------------------------------------


def _orphaned(parent: int) -> None:
    """End this rank once the door's process is gone."""
    while os.getppid() == parent:
        time.sleep(1.0)
    os._exit(1)


def _digest(poses, stats) -> str:
    h = hashlib.sha256()
    for p in poses:
        h.update(np.ascontiguousarray(p).tobytes())
    h.update(np.asarray([s["mean_inliers"] for s in stats]).tobytes())
    return h.hexdigest()


def _job(rank, mesh, bank, config, intrinsics, chunk, starts, rs, frames,
         traced) -> dict:
    """One job on this rank: what it ships to the door."""
    from visual_odom_tpu_torch.parallel.batch_eval import \
        run_sequences_batched
    from visual_odom_tpu_torch.parallel.mesh import position, split_ranges
    from visual_odom_tpu_torch.utils import profiling

    clips = [bank_mod.Clip(bank, s, frames) for s in starts]
    before = profiling.records(1, 0).counters
    window = SubWindow() if traced else None
    t0 = time.perf_counter_ns()
    if window is not None:
        window.start()
    poses, stats, wall = run_sequences_batched(
        clips, config, intrinsics, seed=rs, chunk=chunk, mesh=mesh)
    if window is not None:
        window.stop()
    rec = profiling.records(t0, time.perf_counter_ns())
    a, b = split_ranges(len(clips), mesh.devices.shape[0])[position(mesh)[0]]
    out = {"digest": _digest(poses, stats), "spans": rec.spans,
           "complete": rec.complete, "steps": (frames - 1) * (b - a),
           "counters": {k: v - before.get(k, 0)
                        for k, v in rec.counters.items()
                        if v != before.get(k, 0)}}
    if rank == 0:
        out.update(poses=poses, wall=wall,
                   mean_inliers=[s["mean_inliers"] for s in stats],
                   fallback_frames=sum(s["fallback_frames"] for s in stats))
    if window is not None:
        compact = _compact(window)
        out["traced"] = RankTraced(reduce_trace(RankTrace(compact)),
                                   *_nccl(compact))
        if rank == 0:
            out["events"] = compact
    return out


def _serve(conn, rank: int, world: int, port: int, cuda: bool, shape,
           chunk: int, config, intrinsics, bank) -> None:
    """A rank: join the group, build the mesh, then answer the door's
    messages until it says stop. An error is sent to the door with its
    traceback and ends the process at once: a rank left in a collective
    would never return."""
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank))
    threading.Thread(target=_orphaned, args=(os.getppid(),),
                     daemon=True).start()
    try:
        from visual_odom_tpu_torch.parallel.mesh import (
            data_model_mesh, initialize_distributed)
        from visual_odom_tpu_torch.utils import cudagraph

        torch.set_num_threads(1)
        device = torch.device(f"cuda:{rank}" if cuda else "cpu")
        initialize_distributed(device=device)
        mesh = data_model_mesh(data=shape[0])
        if mesh.devices.shape != tuple(shape):
            raise ValueError(f"{world} ranks make a {mesh.devices.shape} "
                             f"mesh, not {tuple(shape)}")
        if bank is None:
            bank = bank_mod.load()
        conn.send(("ready", None))
        while True:
            msg = conn.recv()
            if msg[0] == "stop":
                break
            if msg[0] == "memory":
                conn.send(("memory", torch.cuda.max_memory_allocated(device)
                           if cuda else 0))
            else:
                conn.send(("done", _job(rank, mesh, bank, config, intrinsics,
                                        chunk, *msg[1:])))
        cudagraph.release()
        torch.distributed.destroy_process_group()
    except Exception:  # noqa: BLE001 - reported to the door, then ended
        try:
            conn.send(("error", f"rank {rank}:\n{traceback.format_exc()}"))
        finally:
            os._exit(1)


def _end(procs, conns, grace: float) -> None:
    """Ask every rank to stop, wait ``grace`` seconds, kill the rest."""
    for p, c in zip(procs, conns):
        if p.is_alive():
            try:
                c.send(("stop",))
            except (OSError, ValueError):
                pass
    deadline = time.monotonic() + grace
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    for c in conns:
        c.close()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# ---- the door ---------------------------------------------------------------


class Door(FrontDoor):
    warm_frames = 2
    #: what each rank runs; a picklable function of ``_serve``'s arguments
    serve = staticmethod(_serve)

    def __init__(self, traffic, bank, config, intrinsics, device, spans):
        super().__init__(traffic, bank, config, intrinsics, device, spans)
        TRACED.clear()
        world, shape = traffic["ranks"], tuple(traffic["mesh"])
        if world != shape[0] * shape[1]:
            raise SystemExit(f"{world} ranks do not fill a {shape} mesh")
        default = (bank_mod.BANK_FRAMES, bank_mod.HEIGHT, bank_mod.WIDTH)
        handed = None if bank.lefts.shape == default else bank
        cuda = torch.device(device).type == "cuda"
        ctx = multiprocessing.get_context("spawn")
        for attempt in (0, 1):
            port = _free_port()
            self._procs, self._conns = [], []
            for r in range(world):
                here, there = ctx.Pipe()
                p = ctx.Process(target=self.serve, name=f"vobench-rank{r}",
                                daemon=True,
                                args=(there, r, world, port, cuda, shape,
                                      traffic["chunk"], config, intrinsics,
                                      handed))
                p.start()
                there.close()
                self._procs.append(p)
                self._conns.append(here)
            self._finalizer = weakref.finalize(self, _end, self._procs,
                                               self._conns, STOP_S)
            try:
                self._ask(None, START_S)
                break
            except RuntimeError as e:
                if attempt or "ddress already in use" not in str(e):
                    raise

    def _fail(self, why: str):
        self._finalizer.detach()
        _end(self._procs, self._conns, 0.0)
        raise RuntimeError(f"the ranks door: {why}")

    def _ask(self, msg, limit: float) -> tuple:
        """Send ``msg`` to every rank (None: only wait for them to start)
        and take each rank's answer: (answers by rank, ``perf_counter`` at
        rank 0's). Raises, ending every rank, where one answers with an
        error, dies or lets ``limit`` seconds pass."""
        if not self._finalizer.alive:
            raise RuntimeError("the ranks door: its ranks have ended")
        if msg is not None:
            for c in self._conns:
                c.send(msg)
        got, t_first = {}, None
        pending = dict(enumerate(self._conns))
        deadline = time.monotonic() + limit
        while pending:
            left = deadline - time.monotonic()
            if left <= 0:
                self._fail(f"no answer from ranks {sorted(pending)} in "
                           f"{limit} s")
            ready = multiprocessing.connection.wait(
                list(pending.values())
                + [self._procs[r].sentinel for r in pending],
                timeout=min(left, 5.0))
            for r, c in list(pending.items()):
                try:
                    if not (c in ready or c.poll()):
                        if self._procs[r].sentinel in ready:
                            raise EOFError
                        continue
                    kind, value = c.recv()
                except EOFError:
                    self._procs[r].join(STOP_S)
                    self._fail(f"rank {r} died (exit code "
                               f"{self._procs[r].exitcode})")
                if kind == "error":
                    self._fail(value)
                got[r] = value
                if r == 0:
                    t_first = time.perf_counter()
                del pending[r]
        return [got[r] for r in range(len(self._conns))], t_first

    def run(self, index, starts, rs, frames, traced) -> Job:
        t0 = time.perf_counter()
        with self.spans("job"), self.spans("runner"):
            outs, t1 = self._ask(("job", starts, rs, frames, traced), JOB_S)
        first = outs[0]
        differ = [r for r, o in enumerate(outs)
                  if o["digest"] != first["digest"]]
        if differ:
            self._fail(f"job {index}: the poses of ranks {differ} differ "
                       f"from rank 0's")
        if traced:
            TRACED[:] = [o["traced"] for o in outs]
            self.trace = RankTrace(first["events"])
        ranks = [{k: o[k] for k in ("digest", "spans", "counters", "steps",
                                    "complete")} for o in outs]
        print(f"ranks: job {index}, {frames} frames, {t1 - t0:.3f} s; "
              f"graph.captures by rank "
              f"{[r['counters'].get('graph.captures', 0) for r in ranks]}",
              file=sys.stderr)
        return Job(index, starts, rs, t0, t1, (frames - 1) * len(starts),
                   first["poses"], [accepts_from_poses(p)
                                    for p in first["poses"]],
                   first["mean_inliers"],
                   {"runner_wall": first["wall"],
                    "fallback_frames": first["fallback_frames"],
                    "ranks": ranks})

    def memory_peak_bytes(self, chips: int) -> int:
        """The largest ``torch.cuda.max_memory_allocated`` over the ranks,
        each read on its own card (0 on the CPU)."""
        return int(max(self._ask(("memory",), STOP_S)[0]))
