"""The benchmark's files, found by name, and BENCHMARK.json's contract.

Run from the repository root: ``python -m pytest vobench/tests -q``.
"""

import dataclasses
import json
import os
import re

import pytest

from vobench import spec

BENCH = json.load(open(os.path.join(spec.ROOT, "BENCHMARK.json")))
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["vobench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    cells = len(BENCH["workloads"])
    total = (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200
    assert total <= 43200 and cells <= 24
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_keys():
    allowed = {"configs": {"name", "source", "file", "reduced", "why"},
               "workloads": {"name", "config", "traffic", "chips", "why"},
               "end_to_end": {"name", "unit", "better", "bound", "source",
                              "workloads"},
               "per_layer": {"name", "unit", "better", "source", "layer",
                             "moves", "workloads"}}
    for group, keys in allowed.items():
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
        for e in BENCH[group]:
            assert set(e) <= keys, (group, e["name"])
            assert NAME.match(e["name"])
            if "unit" in e:
                assert UNIT.match(e["unit"])
                assert e["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s"}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_loads_by_name(cell):
    c = spec.load_cell(cell)
    assert c.chips in (1, 4)
    assert set(spec.TRAFFIC_KEYS) <= set(c.traffic)
    assert c.limits and all(v > 0 for v in c.limits.values())
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_found_by_name(metric):
    read = spec.metric_reader(metric)
    assert callable(read)


def test_per_layer_metrics_move_metrics_their_cells_report():
    for m in BENCH["per_layer"]:
        moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        for cell in m["workloads"]:
            assert cell in CELLS
            assert spec._applies(moved, cell)


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_states_every_field(config):
    from visual_odom_tpu_torch.config import CameraIntrinsics, VOConfig
    from vobench import bank
    from vobench.reference.config import VOConfig as RefConfig

    doc = json.load(open(os.path.join(spec.ROOT, config["file"])))
    prog = spec.vo_config(doc, VOConfig)
    ref = spec.vo_config(doc, RefConfig)
    assert dataclasses.asdict(prog) == dataclasses.asdict(ref)
    assert spec.intrinsics(doc, CameraIntrinsics) == CameraIntrinsics(
        **dataclasses.asdict(bank.intrinsics(prog.height, prog.width)))
    assert set(config["reduced"]) <= set(doc)
    assert config["file"].startswith("vobench/configs/")


def test_a_missing_field_is_refused():
    from visual_odom_tpu_torch.config import VOConfig

    doc = json.load(open(os.path.join(spec.ROOT,
                                      BENCH["configs"][0]["file"])))
    del doc["vo"]["lk_window"]
    with pytest.raises(SystemExit):
        spec.vo_config(doc, VOConfig)


def test_every_traffic_names_a_door_found_by_file():
    from vobench import doors

    assert {"batched", "live"} <= set(doors.names())
    for cell in CELLS:
        c = spec.load_cell(cell)
        assert c.traffic["door"] in doors.names()
        mod = __import__(f"vobench.doors.{c.traffic['door']}",
                         fromlist=["Door"])
        assert issubclass(mod.Door, doors.FrontDoor)


def test_an_unknown_door_is_refused():
    from vobench import doors

    with pytest.raises(SystemExit):
        doors.make({"door": "no_such_door"}, None, None, None, "cpu", None)


def test_unknown_cell_is_refused():
    with pytest.raises(SystemExit):
        spec.load_cell("no.such.cell")
