"""The port's bench harness (``visual_odom_tpu_torch/bench.py``) against the
JAX package's ``bench.py``, loaded from the repository root as it is.

- ``render_course``: each of the five gauntlet courses at 120x160 equals
  JAX's bit for bit (frames, ground truth, intrinsics), each package on its
  own cache directory; a second call reads the cache back unchanged without
  rendering; a corrupt cache file is rendered again; a course rendered on a
  pool of spawned processes equals the in-process render.
- Scoring, key for key: both benches' ``bench_course`` on stubbed scans and
  loop closures fed the same poses, outputs and ground truth (a course
  under 100 m, one of ~112 m so the devkit segments run, ``loop`` with one
  edge and with none) give the same metrics dict.
- The port's ``bench_course`` on the CPU: its streamed rep's poses equal
  its pre-uploaded rep's bit for bit, and its metrics are what
  ``score_course`` gives for its own scan.
- ``bench_lk`` on the same frames in both packages (JAX's plain branch):
  survivors within STATUS_MISMATCH_MAX, both over the 70 % floor.
- ``main --quick`` at 120x160 on the CPU prints a last line with exactly
  the keys of JAX's, three courses; both mains build the same keys; without
  a card and without ``--device cpu`` the bench raises.

Alone: ~80 s on one core.
"""

import ast
import concurrent.futures
import dataclasses
import importlib.util
import io
import json
import os
import pathlib
import types
from contextlib import redirect_stderr, redirect_stdout
from typing import NamedTuple

import numpy as np
import pytest
import torch

import visual_odom_tpu.runner.loopclosure as jloopclosure
import visual_odom_tpu.runner.pipeline as jpipeline
import visual_odom_tpu_torch.runner.loopclosure as loopclosure
import visual_odom_tpu_torch.runner.pipeline as pipeline
from visual_odom_tpu_torch import bench
from visual_odom_tpu_torch.io import synthetic

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
H, W = 120, 160
#: hard LK thresholds can flip a feature or two between platforms
STATUS_MISMATCH_MAX = 2
#: frames per course in the render test; the loop course needs 149
RENDER_FRAMES = {"straight": 3, "turning": 3, "stress": 3, "long": 3,
                 "loop": 149}


def _load_jax_bench():
    spec = importlib.util.spec_from_file_location("_jax_bench",
                                                  ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jbench = _load_jax_bench()


@pytest.fixture
def caches(tmp_path, monkeypatch):
    """Each package's course cache in its own directory under tmp_path."""
    port, jax_dir = tmp_path / "port", tmp_path / "jax"
    monkeypatch.setenv("VO_COURSE_CACHE", str(port))
    monkeypatch.setattr(jbench, "_COURSE_CACHE", str(jax_dir))
    return port, jax_dir


def _same_frames(a, b) -> bool:
    return len(a) == len(b) and all(
        np.array_equal(x[0], y[0]) and np.array_equal(x[1], y[1])
        and x[0].dtype == y[0].dtype == np.uint8 for x, y in zip(a, b))


# --- render_course --------------------------------------------------------------


@pytest.mark.parametrize("course", sorted(RENDER_FRAMES))
def test_render_course_matches_jax(course, caches, monkeypatch):
    n = RENDER_FRAMES[course]
    frames, gt, intr = bench.render_course(course, n, H, W)
    jframes, jgt, jintr = jbench.render_course(course, n, H, W)
    assert len(frames) == n
    assert _same_frames(frames, jframes)
    assert np.array_equal(gt, jgt)
    assert dataclasses.astuple(intr) == dataclasses.astuple(jintr)
    key = f"{course}_{W}x{H}_{n}_v3.npz"
    assert sorted(os.listdir(caches[0])) == [key]

    # the second call reads the cache: nothing is rendered
    def no_render(*a, **k):
        raise AssertionError("rendered although the cache holds the course")

    monkeypatch.setattr(synthetic, "make_course", no_render)
    again, gt2, intr2 = bench.render_course(course, n, H, W)
    assert _same_frames(again, frames)
    assert np.array_equal(gt2, gt) and intr2 == intr


def test_corrupt_cache_is_rendered_again(caches):
    frames, gt, _ = bench.render_course("straight", 3, H, W)
    path = caches[0] / f"straight_{W}x{H}_3_v3.npz"
    path.write_bytes(path.read_bytes()[:100])     # a cut-off write
    again, gt2, _ = bench.render_course("straight", 3, H, W)
    assert _same_frames(again, frames) and np.array_equal(gt2, gt)
    with np.load(path) as z:                      # written whole again
        assert z["lefts"].shape == (3, H, W)
    path.write_bytes(b"not an npz")
    again, _, _ = bench.render_course("straight", 3, H, W)
    assert _same_frames(again, frames)
    assert not [p for p in os.listdir(caches[0]) if ".tmp" in p]


def test_pool_render_equals_in_process_render(caches, monkeypatch):
    n = 4
    ref, _, _ = bench.render_course("turning", n, H, W)
    os.remove(caches[0] / f"turning_{W}x{H}_{n}_v3.npz")
    # two spawned workers, two frames each
    monkeypatch.setattr(bench, "_PIXELS_PER_WORKER", n * H * W // 2)
    pools = []

    class Recorded(concurrent.futures.ProcessPoolExecutor):
        def __init__(self, workers, **kw):
            pools.append(workers)
            super().__init__(workers, **kw)

    monkeypatch.setattr(concurrent.futures, "ProcessPoolExecutor", Recorded)
    pooled, _, _ = bench.render_course("turning", n, H, W)
    assert pools == [2]
    assert _same_frames(pooled, ref)


# --- scoring, key for key ---------------------------------------------------------


class _Fetched(NamedTuple):
    accept: np.ndarray
    num_matched: np.ndarray


#: what the stubbed streamed rep reports, in both packages
_STREAM_STATS = dict(upload_mb_s=812.345, busy_frac=0.41234, upload_s=0.4567,
                     decode_s=0.0123, agg_upload_mb_s=1523.45, threads=4)


def _scenario(course, n, rng):
    """(frames, gt, poses, fetched, pg_poses) of an n-frame course: tiny
    placeholder frames, the course's ground truth, a drifting estimate."""
    from visual_odom_tpu_torch.io.synthetic import make_course

    gt = make_course(course, bench._kitti_intrinsics(H, W), num_frames=n).poses
    poses = gt.copy()
    drift = np.cumsum(rng.normal(0.0, 0.02, (n, 3)), axis=0)
    poses[:, :3, 3] += drift
    ang = np.cumsum(rng.normal(0.0, 2e-4, n))
    c, s = np.cos(ang), np.sin(ang)
    rot = np.zeros((n, 3, 3))
    rot[:, 0, 0], rot[:, 0, 2], rot[:, 1, 1] = c, s, 1.0
    rot[:, 2, 0], rot[:, 2, 2] = -s, c
    poses[:, :3, :3] = poses[:, :3, :3] @ rot
    poses[0] = np.eye(4)
    accept = rng.random(n - 1) > 0.05
    fetched = _Fetched(accept=accept,
                       num_matched=rng.integers(150, 300, n - 1))
    pg_poses = gt.copy()
    pg_poses[:, :3, 3] += drift * 0.3
    frames = [(np.zeros((H, W), np.uint8),) * 2 for _ in range(n)]
    return frames, gt, poses, fetched, pg_poses


def _stubs(frames, gt, intr, poses, fetched, pg_poses, edges):
    """(render_course, run_sequence_scan, close_loops) stubs that hand
    either bench the same course, scans and loop closure."""
    calls = {"close_loops": []}

    def render_course(name, num_frames, height, width):
        return frames, gt, intr

    def run_sequence_scan(frames_, cfg, intr_, chunk=32, preupload=False,
                          upload_threads=1, stats_out=None, **kw):
        if stats_out is not None:
            stats_out.update(_STREAM_STATS)
        return poses, fetched, 2.5, len(frames_) - 1

    def close_loops(poses_, frame_of, cfg, intr_, gt_loop_pair=None, **kw):
        calls["close_loops"].append(gt_loop_pair)
        info = types.SimpleNamespace(edges=list(edges),
                                     closure_after_m=0.2345678)
        return (pg_poses if edges else poses_), info

    return render_course, run_sequence_scan, close_loops, calls


@pytest.mark.parametrize("case", ["short", "long", "loop_edge", "loop_none"])
def test_scoring_matches_jax_key_for_key(case, monkeypatch):
    rng = np.random.default_rng(12)
    course, n, stream = {"short": ("straight", 20, True),
                         "long": ("long", 90, False),
                         "loop_edge": ("loop", 149, False),
                         "loop_none": ("loop", 149, False)}[case]
    edges = [(0, 148, 55)] if case == "loop_edge" else []
    frames, gt, poses, fetched, pg = _scenario(course, n, rng)
    results = {}
    for name, mod, pipe, lc in (("port", bench, pipeline, loopclosure),
                                ("jax", jbench, jpipeline, jloopclosure)):
        intr = mod._kitti_intrinsics(H, W)
        render, scan, close, calls = _stubs(frames, gt, intr, poses, fetched,
                                            pg, edges)
        with monkeypatch.context() as mp:
            mp.setattr(mod, "render_course", render)
            mp.setattr(pipe, "run_sequence_scan", scan)
            mp.setattr(lc, "close_loops", close)
            kw = {"device": "cpu"} if name == "port" else {}
            fps, m = mod.bench_course(course, n, H, W, reps=2,
                                      stream_rep=stream, **kw)
        results[name] = (fps, m, calls["close_loops"])
    (fps, m, loops), (jfps, jm, jloops) = results["port"], results["jax"]
    assert fps == jfps
    assert m == jm
    assert json.dumps(m) == json.dumps(jm)
    assert loops == jloops
    if course == "loop":
        assert loops == [(0, 148)]
        assert ("loop_closure_pg_m" in m) == bool(edges)
        assert m["loop_edges"] == edges
    if case == "long":
        assert m["course_len_m"] >= 100 and "per_length" in m
    if case == "short":
        assert m["course_len_m"] < 100 and "per_length" not in m
        assert m["link_ceiling_fps"] == jm["link_ceiling_fps"]


# --- the port's bench_course on the CPU ----------------------------------------------


def test_bench_course_on_cpu_streamed_equals_preuploaded(tmp_path,
                                                         monkeypatch):
    monkeypatch.setenv("VO_COURSE_CACHE", str(tmp_path))
    real = pipeline.run_sequence_scan
    runs = []

    def recording(frames, cfg, intr, **kw):
        out = real(frames, cfg, intr, **kw)
        runs.append((cfg, intr, kw, out))
        return out

    monkeypatch.setattr(pipeline, "run_sequence_scan", recording)
    n = 5
    fps, m = bench.bench_course("straight", n, H, W, reps=1, chunk=2,
                                stream_rep=True, device="cpu")
    assert len(runs) == 2
    (cfg, intr, kw0, pre), (_, _, kw1, streamed) = runs
    assert kw0["preupload"] is True and kw1["preupload"] is False
    assert kw1["upload_threads"] == 4
    assert np.array_equal(streamed[0], pre[0])
    for a, b in zip(streamed[1], pre[1]):
        assert np.array_equal(a, b)
    frames, gt, _ = bench.render_course("straight", n, H, W)
    assert fps == pre[3] / pre[2]
    want = bench.score_course("straight", n, pre[0], pre[1], gt, frames, cfg,
                              intr, fps, streamed[3] / streamed[2],
                              kw1["stats_out"], device="cpu")
    assert m == want
    assert m["stream_threads"] == 4 and m["fps_streamed"] > 0
    assert pre[0].shape == (n, 4, 4) and np.isfinite(pre[0]).all()


# --- bench_lk ----------------------------------------------------------------


@pytest.mark.parametrize("size", [(120, 160), (96, 128)])
def test_bench_lk_survivors_match_jax(size, tmp_path, monkeypatch):
    h, w = size
    monkeypatch.setenv("VO_COURSE_CACHE", str(tmp_path))
    frames, _, _ = bench.render_course("straight", 12, h, w)
    rate, survivors = bench.bench_lk(512, h, w, iters=1, frames=frames,
                                     device="cpu")
    jrate, jsurvivors = jbench.bench_lk(512, h, w, iters=1, frames=frames)
    assert abs(survivors - jsurvivors) <= STATUS_MISMATCH_MAX
    assert survivors > 0 and rate > 0 and jrate > 0


def test_bench_lk_renders_the_pair_when_frames_are_too_few(tmp_path,
                                                           monkeypatch):
    monkeypatch.setenv("VO_COURSE_CACHE", str(tmp_path))
    few, _, _ = bench.render_course("straight", 5, H, W)
    frames, _, _ = bench.render_course("straight", 12, H, W)
    assert bench.bench_lk(512, H, W, iters=1, frames=few, device="cpu")[1] \
        == bench.bench_lk(512, H, W, iters=1, frames=frames, device="cpu")[1]


# --- main ----------------------------------------------------------------------


def _result_keys(path: pathlib.Path) -> list:
    """The keys ``main`` writes into its ``result`` dict, in order: the dict
    literal's and the later ``result[...] = ...`` assignments'."""
    tree = ast.parse(path.read_text())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    keys = []
    for node in ast.walk(main):
        if isinstance(node, ast.Assign):
            tgt = node.targets[0]
            if isinstance(tgt, ast.Name) and tgt.id == "result":
                keys += [k.value for k in node.value.keys]
            elif (isinstance(tgt, ast.Subscript)
                  and isinstance(tgt.value, ast.Name)
                  and tgt.value.id == "result"):
                keys.append(tgt.slice.value)
    return keys


def test_both_mains_build_the_same_keys():
    keys = _result_keys(ROOT / "bench.py")
    assert keys == _result_keys(ROOT / "visual_odom_tpu_torch" / "bench.py")
    assert "fps_fast_mode_skip2" in keys and "vs_baseline" in keys


def test_main_quick_prints_jax_keys(tmp_path, monkeypatch):
    monkeypatch.setenv("VO_COURSE_CACHE", str(tmp_path))
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = bench.main(["--quick", "--frames", "5", "--height", str(H),
                         "--width", str(W), "--device", "cpu"])
    assert rc == 0
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    quick_keys = [k for k in _result_keys(ROOT / "bench.py")
                  if k not in ("fps_fast_mode_skip2", "fast_mode_ok")]
    assert list(line) == quick_keys
    assert list(line["courses"]) == ["straight", "turning", "stress"]
    assert line["metric"] == "vo_fps_per_chip" and line["frames"] == 5
    assert line["image"] == f"{W}x{H}" and line["value"] > 0
    assert line["vs_baseline"] == (round(line["value"] / 80.0, 3)
                                   if line["accuracy_ok"] else 0.0)
    for name in line["courses"]:
        assert f"[bench] {name}: " in err.getvalue()
    assert "[bench] card" not in err.getvalue()


def test_main_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--quick"])
