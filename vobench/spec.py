"""What a run measures, found by name: the cell in ``BENCHMARK.json``, its
configuration (``configs/<name>.json``), its traffic mix
(``traffic/<name>.json``), the front door its traffic names
(``doors/<door>.py``), its correctness limits (``limits/<cell>.json``) and
the per-layer metrics' readers (``metrics/<metric>.py``).

A later change adds a cell, a configuration, a traffic mix, a door or a
metric by adding such a file and an entry in ``BENCHMARK.json``; nothing here names
one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import NamedTuple

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

#: the traffic keys a mix must give, with their meaning
TRAFFIC_KEYS = {
    "door": "which front door a job goes through: doors/<door>.py",
    "clips": "clips a job runs (B for the batched door, 1 for live)",
    "clip_frames": "frames of a clip (its steps are one fewer)",
    "offset_max": "a clip starts at a frame drawn from 0..offset_max",
    "chunk": "frames per upload of the batched runner (0: stepwise)",
}


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict          # the configuration file, as written
    traffic: dict
    limits: dict          # number -> limit
    end_to_end: list      # BENCHMARK.json entries reported with --trace 0
    per_layer: list       # ... with --trace 1


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json`` with its files."""
    bench = _read_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                         f"(have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    conf = _read_json(os.path.join(root, configs[w["config"]]["file"]))
    traffic = _read_json(os.path.join(HERE, "traffic", w["traffic"] + ".json"))
    missing = sorted(set(TRAFFIC_KEYS) - set(traffic))
    if missing:
        raise SystemExit(f"traffic {w['traffic']!r} lacks {missing}")
    limits = _read_json(os.path.join(HERE, "limits", name + ".json"))
    return Cell(name=name, chips=int(w["chips"]), config=conf,
                traffic=traffic,
                limits=limits["limits"],
                end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"] if _applies(m, name)])


def vo_config(config: dict, cls):
    """``cls`` (a ``VOConfig`` class, the program's or the reference's)
    built from every field the configuration file states under ``vo``; a
    field the class has and the file does not state is refused, so a
    change of a default cannot change what a cell runs."""
    fields = {f.name for f in dataclasses.fields(cls)}
    given = config["vo"]
    if set(given) != fields:
        raise SystemExit(f"configuration fields differ from {cls.__module__}."
                         f"VOConfig: missing {sorted(fields - set(given))}, "
                         f"unknown {sorted(set(given) - fields)}")
    return cls(**given)


def intrinsics(config: dict, cls):
    return cls(**config["intrinsics"])


def metric_reader(name: str):
    """``read(run) -> float or None`` of the per-layer metric ``name``,
    from ``metrics/<name>.py``."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "vobench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
