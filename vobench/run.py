"""Run one cell of the benchmark once.

    python3 -m vobench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. The run loads the cell's configuration and
traffic by name (``vobench.spec``), loads the frame bank (rendered on the
first run in a checkout), warms up every shape the cell's jobs use, runs
jobs for ``--seconds`` (the job running at the close is finished and
counted), then checks the output against the reference and prints one JSON
line last on standard output. With ``--trace 0`` its metrics are the
cell's end-to-end metrics; with ``--trace 1`` one more job after the
window is profiled whole and the metrics are the cell's per-layer ones.

The run needs the cards the cell asks for: without them it exits 2 and
prints no result. It exits 3 and prints no result if the JAX package, JAX
or Flax was loaded. It reads and writes only inside the checkout (the
bank and the caches under ``vobench/``) and the temporary and cache
directories of its environment.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import subprocess
import sys
import time
from typing import NamedTuple, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(HERE, "_cache")
#: top-level module names the run must not have loaded
FORBIDDEN = ("jax", "jaxlib", "flax", "visual_odom_tpu")


def _process_age_s() -> float:
    """Seconds since this process started (Linux), for ``setup_s``."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def _set_environment() -> None:
    """Every build and kernel cache at a fixed path inside the checkout,
    and one intra-op thread, so that the host carries the program's own
    launches and copies and no idle pool beside them (runs with torch's
    default pool swung by 7 %). Before torch is imported."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(CACHE, sub)
    os.environ["OMP_NUM_THREADS"] = "1"
    os.environ["MKL_NUM_THREADS"] = "1"


class Run(NamedTuple):
    """What the per-layer readers read."""

    jobs: list
    window_s: float
    trace: object                  # trace.DeviceTrace or None
    traced_steps: Optional[int]    # frames of the traced job
    lk_bound_s: Optional[float]    # roofline time of one LK launch, mean


def window(door, seed: int, seconds: float) -> tuple:
    """(jobs, window_s): jobs run one after another until ``seconds`` have
    passed; the job running at the close is finished and counted, and the
    window ends with it, so no job's frames are counted without its
    time."""
    jobs = []
    t0 = time.perf_counter()
    while not jobs or jobs[-1].t1 - t0 < seconds:
        jobs.append(door.job(seed, len(jobs), traced=False))
    return jobs, jobs[-1].t1 - t0


def end_to_end(jobs, window_s: float, setup_s: float) -> dict:
    """The end-to-end metrics: frames (steps) of every job over the
    window, the 95th percentile of every frame's latency (live door) and
    the set-up time."""
    import numpy as np

    values = {"frames_per_s": sum(j.steps for j in jobs) / window_s,
              "setup_s": setup_s}
    lat = [x for j in jobs for x in j.counters.get("latencies", ())]
    if lat:
        values["frame_latency_p95_ms"] = float(
            np.percentile(np.asarray(lat) * 1e3, 95))
    return values


def loaded_forbidden() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def _lk_bound(records, window: int) -> Optional[float]:
    """Mean roofline time of one LK launch over the recorded quads."""
    from vobench import lkwork

    import torch

    if not records:
        return None
    work = [lkwork.quad_work(rec, window) for _, rec in records]
    flops, nbytes = (torch.stack([w[i] for w in work]).double().cpu().numpy()
                     for i in range(2))
    return float(lkwork.bound_seconds(flops, nbytes).mean())


class Setup(NamedTuple):
    door: object
    bank: object
    ref_config: object
    ref_intrinsics: object
    spans: object


def setup(cell, device, bank=None, program=None) -> Setup:
    """The cell's door on ``device`` over the bank (default: the
    checkout's), with the program's configuration and camera from the
    configuration file (or ``program``, a (VOConfig, intrinsics) pair, for
    tests at a small size) and the reference's copies of them."""
    from visual_odom_tpu_torch.config import CameraIntrinsics, VOConfig
    from vobench import bank as bank_mod, doors, spec
    from vobench.reference.config import CameraIntrinsics as RefIntrinsics
    from vobench.reference.config import VOConfig as RefConfig
    from vobench.trace import Spans

    if bank is None:
        bank = bank_mod.load()
    if program is None:
        cfg = spec.vo_config(cell.config, VOConfig)
        intr = spec.intrinsics(cell.config, CameraIntrinsics)
        camera = dataclasses.asdict(bank_mod.intrinsics(cfg.height, cfg.width))
        if cell.config["intrinsics"] != camera:
            raise SystemExit("the configuration's camera is not the bank's")
    else:
        cfg, intr = program
    ref_cfg = RefConfig(**{k: getattr(cfg, k) for k in
                           RefConfig.__dataclass_fields__})
    ref_intr = RefIntrinsics(**{k: getattr(intr, k) for k in
                                RefIntrinsics.__dataclass_fields__})
    spans = Spans()
    door = doors.make(cell.traffic, bank, cfg, intr, device, spans)
    return Setup(door, bank, ref_cfg, ref_intr, spans)


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             bank=None, program=None, log=sys.stderr) -> dict:
    """One run of ``cell``; returns the result line as a dict. ``bank`` and
    ``program`` as ``setup`` takes them."""
    import torch

    from vobench import check, spec
    from vobench.trace import SubWindow, reduce_trace

    traffic = cell.traffic
    dev = torch.device(device)
    door, bank, ref_cfg, ref_intr, spans = setup(cell, dev, bank, program)
    door.warm(seed)
    if trace:
        # the profiler's first start initialises CUPTI: not in the window
        w = SubWindow()
        w.start()
        w.stop()
    setup_s = _process_age_s()

    jobs, window_s = window(door, seed, seconds)
    peak = door.memory_peak_bytes(cell.chips)
    if dev.type == "cuda":
        print(f"after the window: {_card_state()}", file=log)

    dtrace = traced = None
    if trace:
        # one more job, profiled whole: the device numbers come from it,
        # the host's from the window, which the profiler would slow
        traced = door.job(seed, len(jobs), traced=True)
        tr = time.perf_counter()
        dtrace = reduce_trace(door.trace, spans.done)
        print(f"trace: {len(door.trace.events)} events, {dtrace.kernels} "
              f"kernels, reduced in {time.perf_counter() - tr:.3f} s",
              file=log)
    del door
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the reference recomputes the traced job, whose LK work it counts,
    # or a job of the window drawn from the seed
    job = traced or check.draw_job(seed, jobs)
    record = range(1, traffic["clip_frames"]) if trace else ()
    tr = time.perf_counter()
    ref_out, records = check.reference_run(
        job, bank, ref_cfg, ref_intr, traffic["clip_frames"], dev,
        record_steps=record)
    numbers = check.compare(job, ref_out)
    correct, shown = check.judge(numbers, cell.limits)
    print(f"reference: {len(job.starts)} clips of job {job.index} in "
          f"{time.perf_counter() - tr:.3f} s", file=log)

    steps = sum(j.steps for j in jobs)
    result = {"correct": correct, "attempted": steps, "failed": 0}
    if trace:
        tr = time.perf_counter()
        run = Run(jobs, window_s, dtrace, traced.steps,
                  _lk_bound(records, ref_cfg.lk_window))
        print(f"LK work of {len(records)} quads in "
              f"{time.perf_counter() - tr:.3f} s", file=log)
        metrics = {}
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = end_to_end(jobs, window_s, setup_s)
        print(f"end to end: {json.dumps(values)}", file=log)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    result["metrics"] = metrics
    result["device"] = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else "cpu"),
        "count": cell.chips, "memory_peak_bytes": peak}
    if trace:
        result["device"].update(busy_s=dtrace.busy_s,
                                window_s=dtrace.window_s)
        result["breakdown"] = {"device_ops": dtrace.device_ops,
                               "idle_gaps": dtrace.idle_gaps}
    result["checks"] = shown
    print(f"jobs {len(jobs)}, window {window_s:.3f} s, setup {setup_s:.3f} s,"
          f" numbers {json.dumps(numbers)}", file=log)
    return result


def _nvidia_smi(query: str) -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def _card_state() -> str:
    """The card's clocks, power and temperature, the host's load and the
    cores this process may run on: read beside a window, so that a run
    that reads slow can be told apart by them."""
    with open("/proc/loadavg") as f:
        load = " ".join(f.read().split()[:3])
    return (_nvidia_smi("clocks.sm,clocks.mem,power.draw,temperature.gpu")
            + f"; load {load}; cores {sorted(os.sched_getaffinity(0))}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    _set_environment()
    from vobench import spec

    cell = spec.load_cell(args.workload)
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"vobench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              , file=sys.stderr)
        return 2
    print(f"card: {_nvidia_smi('name,power.limit')}", file=sys.stderr)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda")
    found = loaded_forbidden()
    if found:
        print(f"vobench: the run loaded {found}", file=sys.stderr)
        return 3
    for k, v in result["checks"].items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
