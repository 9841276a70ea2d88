"""The port's command line (``visual_odom_tpu_torch/runner/cli.py``) against
the JAX package's and against the port's entry points called directly.

- The parser of every subcommand equals JAX's (option strings, dests,
  types, defaults, nargs, consts, required), apart from the port's own
  ``--device``; ``config_from_args`` on tests/test_cli_batch.py:67-104's
  argv gives the same ``VOConfig`` fields in both packages.
- ``run synthetic --device cpu`` in each variant (the interactive runner,
  ``--metrics``, ``--tracks-dir``, ``--chunk``, ``--checkpoint`` with and
  without ``--chunk``, run twice so the second call resumes, ``--ba-window
  4`` with and without ``--chunk``, ``--loop-close``) writes the pose file
  of the port's door called directly, byte for byte, and its scorecard
  stays within tests/test_e2e.py's bars, as JAX's CLI does on the same
  calibration.
- ``eval`` and ``eval-all``: both packages' CLIs print the same JSON
  (1e-9) and write the same errors file and ``summary.json``.
- ``run-batch`` over two KITTI directories of PNGs equals
  ``run_sequences_batched`` called directly, also on a patched device list
  of two CPU devices as a (2, 1) and a (1, 2) mesh.
- ``run --ba-ring``: on a patched list of four CPU devices its pose file
  equals ``smooth_trajectory_ba`` with ``make_ring_window_solver`` on the
  same snapshots (the ring branch taken where the window affords the
  halo); on ``--device cpu`` the ring has one device and the file equals
  ``--ba-window`` alone.
- The kill-and-resume subprocess test of
  tests/test_fault_injection.py:59-106, with ``--device cpu``.
- ``bench``: the command it hands to ``subprocess.call`` is JAX's with
  ``python -m visual_odom_tpu_torch.bench`` in place of ``bench.py``, plus
  ``--device``; a real ``bench --quick --device cpu`` at 120x160 prints a
  last line that parses, with three courses.
- Refusals: a ``run-batch`` mesh of more data rows than devices exits 2.
  Without a card and without ``--device cpu`` the stepping subcommands and
  ``bench`` exit 1 with ``resolve_device``'s message; ``--live`` without a
  display exits 1; ``rgbd`` without a camera raises.
"""

import argparse
import dataclasses
import json
import math
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from visual_odom_tpu.runner import cli as jcli
from visual_odom_tpu_torch.ba.window import smooth_trajectory_ba
from visual_odom_tpu_torch.config import CameraIntrinsics, VOConfig
from visual_odom_tpu_torch.io.kitti import KittiSequence, save_poses_kitti
from visual_odom_tpu_torch.io.synthetic import SyntheticStereoSequence
from visual_odom_tpu_torch.parallel import mesh
from visual_odom_tpu_torch.parallel.batch_eval import run_sequences_batched
from visual_odom_tpu_torch.runner import cli, pipeline

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 120, 160
INTR = dict(fx=120.0, fy=120.0, cx=80.0, cy=60.0, bf=-64.8, width=W,
            height=H)
CALIB = ("%YAML:1.0\n"
         "Camera.fx: 120.0\nCamera.fy: 120.0\n"
         "Camera.cx: 80.0\nCamera.cy: 60.0\n"
         "Camera.bf: -64.8\nCamera.width: 160\nCamera.height: 120\n")
N_FRAMES = 8
#: the plain LK quad makes a CPU step ~0.4 s at this size; neither count
#: changes what the command must reproduce
FAST = ["--ransac-iters", "100", "--lk-iters", "10"]
CFG = dict(ransac_iterations=100, lk_max_iters=10)
#: tests/test_e2e.py's bars: ATE (m), travelled distance (fraction)
ATE_BAR, DIST_BAR = 0.12, 0.1


class _Captured(Exception):
    pass


def _parser_of(main, monkeypatch) -> argparse.ArgumentParser:
    """The parser ``main`` builds, captured at ``parse_args`` before any
    command runs."""
    seen = []

    def capture(self, args=None, namespace=None):
        seen.append(self)
        raise _Captured

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", capture)
        with pytest.raises(_Captured):
            main([])
    return seen[0]


def _describe(parser) -> dict:
    """{subcommand: {dest: (option strings, type, default, nargs, const,
    required, choices, action)}}"""
    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))
    return {name: {a.dest: (tuple(a.option_strings), a.type, a.default,
                            a.nargs, a.const, a.required, a.choices,
                            type(a).__name__)
                   for a in sp._actions
                   if not isinstance(a, argparse._HelpAction)}
            for name, sp in sub.choices.items()}


def test_parser_equals_jax(monkeypatch):
    ref = _describe(_parser_of(jcli.main, monkeypatch))
    got = _describe(_parser_of(cli.main, monkeypatch))
    assert got.keys() == ref.keys() == {"run", "run-batch", "eval",
                                        "eval-all", "bench"}
    for name in ("run", "run-batch", "bench"):
        device = got[name].pop("device")
        assert device[0] == ("--device",) and device[2] == "cuda"
    assert got == ref


def test_config_from_args_equals_jax():
    """tests/test_cli_batch.py:67-104's overrides, parsed by each
    package's config flags."""
    argv = ["run", "x", "y",
            "--fast-threshold", "15", "--lk-window", "17", "--lk-levels", "2",
            "--lk-iters", "20", "--ransac-iters", "123", "--ransac-reproj",
            "0.7", "--max-rotation", "0.2", "--min-scale", "0.01",
            "--max-scale", "20", "--features-per-bucket", "2",
            "--replenish-below", "999", "--age-threshold", "7",
            "--circle-threshold", "1.0", "--lk-backend", "xla",
            "--mono-rotation"]
    cfgs = []
    for mod in (jcli, cli):
        parser = argparse.ArgumentParser()
        pr = parser.add_subparsers(dest="cmd").add_parser("run")
        pr.add_argument("sequence")
        pr.add_argument("calibration")
        mod.add_config_flags(pr)
        cfgs.append(mod.config_from_args(parser.parse_args(argv), H, W))
    ref, got = (dataclasses.asdict(c) for c in cfgs)
    assert got == ref
    assert got["ransac_iterations"] == 123 and got["mono_rotation"]
    assert cfgs[1].resolved_lk_backend() == "xla"


# --- run synthetic ------------------------------------------------------------


@pytest.fixture(scope="module")
def calib(tmp_path_factory):
    path = tmp_path_factory.mktemp("calib") / "calib.yaml"
    path.write_text(CALIB)
    return str(path)


@pytest.fixture(scope="module")
def direct(tmp_path_factory):
    """The doors the CLI drives, called directly on the course ``run
    synthetic --max-frames 8`` builds: ``run_sequence`` (metrics, poses
    file, overlays every 2 frames, collected tracks) and
    ``run_sequence_scan`` (chunk 4, collected tracks), and windowed BA on
    each one's snapshots."""
    d = tmp_path_factory.mktemp("direct")
    intr = CameraIntrinsics(**INTR)
    seq = SyntheticStereoSequence(intr, num_frames=N_FRAMES)
    cfg = VOConfig.for_image(H, W, **CFG)
    poses, results, snaps = pipeline.run_sequence(
        iter(seq), cfg, intr, metrics_path=str(d / "metrics.jsonl"),
        poses_path=str(d / "poses.txt"), tracks_dir=str(d / "tracks"),
        tracks_every=2, collect_tracks=True, device="cpu")
    scan = pipeline.run_sequence_scan(iter(seq), cfg, intr, chunk=4,
                                      collect_tracks=True, upload_threads=4,
                                      device="cpu")
    ba = dict(window=4, max_landmarks=256, min_track_len=3, huber_delta=1.5,
              device="cpu")
    return {"seq": seq, "dir": d, "run": poses, "results": results,
            "scan": scan[0], "run_snaps": snaps,
            "scan_snaps": (scan[0][:len(scan[4]) + 1], scan[4]),
            "run_ba": smooth_trajectory_ba(snaps, poses, intr, **ba),
            "scan_ba": smooth_trajectory_ba(
                scan[4], scan[0][:len(scan[4]) + 1], intr, **ba)}


def _file_of(poses, path):
    save_poses_kitti(str(path), poses)
    return path.read_bytes()


def _score(out: str) -> dict:
    return json.loads(out[out.index("{"):])


def _within_bars(score, poses, gt):
    dist_gt = np.linalg.norm(np.diff(gt[:, :3, 3], axis=0), axis=1).sum()
    dist = np.linalg.norm(np.diff(poses[:, :3, 3], axis=0), axis=1).sum()
    return score["ate_rmse_m"] < ATE_BAR and abs(dist - dist_gt) / dist_gt < DIST_BAR


@pytest.fixture(scope="module")
def jax_score(calib, tmp_path_factory):
    """JAX's CLI on the same calibration and flags: its scorecard."""
    import contextlib
    import io

    out = tmp_path_factory.mktemp("jax") / "poses.txt"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = jcli.main(["run", "synthetic", calib, "--max-frames",
                        str(N_FRAMES), "--quiet", "--output", str(out)]
                       + FAST)
    assert rc == 0
    return _score(buf.getvalue()), np.loadtxt(out)


#: variant: (extra argv, the direct result the pose file must equal)
VARIANTS = {
    "run": ([], "run"),
    "metrics": (["--metrics", "{d}/m.jsonl"], "run"),
    "tracks_dir": (["--tracks-dir", "{d}/tracks", "--tracks-every", "2"],
                   "run"),
    "checkpoint": (["--checkpoint", "{d}/vo.npz", "--checkpoint-every", "3"],
                   "run"),
    "ba_window": (["--ba-window", "4"], "run_ba"),
    "chunk": (["--chunk", "4"], "scan"),
    "chunk_checkpoint": (["--chunk", "4", "--checkpoint", "{d}/scan.npz",
                          "--checkpoint-every", "4"], "scan"),
    "chunk_ba_window": (["--chunk", "4", "--ba-window", "4"], "scan_ba"),
    "chunk_loop_close": (["--chunk", "4", "--loop-close"], "scan"),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_run_synthetic_equals_door(variant, calib, direct, jax_score,
                                   tmp_path, capsys):
    extra, ref_key = VARIANTS[variant]
    extra = [a.format(d=tmp_path) for a in extra]
    out = tmp_path / "poses.txt"
    argv = (["run", "synthetic", calib, "--max-frames", str(N_FRAMES),
             "--quiet", "--device", "cpu", "--output", str(out)]
            + FAST + extra)
    calls = 2 if "--checkpoint" in extra else 1    # the second resumes
    for _ in range(calls):
        out.unlink(missing_ok=True)
        assert cli.main(argv) == 0
        stdout = capsys.readouterr().out
        assert out.read_bytes() == _file_of(direct[ref_key],
                                            tmp_path / "ref.txt"), variant
    gt = direct["seq"].poses
    assert _within_bars(_score(stdout), direct[ref_key], gt)
    jscore, jposes = jax_score
    jp = np.concatenate([jposes.reshape(-1, 3, 4),
                         np.tile([[[0, 0, 0, 1.0]]], (len(jposes), 1, 1))],
                        axis=1)
    assert _within_bars(jscore, jp, gt)
    if variant == "metrics":
        got = [json.loads(x) for x in (tmp_path / "m.jsonl").open()]
        ref = [json.loads(x) for x in (direct["dir"] / "metrics.jsonl").open()]
        drop = {"t", "frame_time_ms"}   # wall-clock stamps
        assert [{k: v for k, v in r.items() if k not in drop} for r in got] \
            == [{k: v for k, v in r.items() if k not in drop} for r in ref]
    if variant == "tracks_dir":
        names = sorted(os.listdir(tmp_path / "tracks"))
        assert names == sorted(os.listdir(direct["dir"] / "tracks"))
        assert "tracks_000001.png" in names and "tracks_000002.png" in names
        for n in names:
            assert ((tmp_path / "tracks" / n).read_bytes()
                    == (direct["dir"] / "tracks" / n).read_bytes())


# --- eval and eval-all ------------------------------------------------------


@pytest.fixture(scope="module")
def trajectories(tmp_path_factory):
    """A 240 m ground truth (the straight course's poses, nothing rendered)
    and a drifting estimate, as KITTI files under gt/ and results/."""
    d = tmp_path_factory.mktemp("eval")
    gt = SyntheticStereoSequence(CameraIntrinsics(**INTR), num_frames=301,
                                 seed=3).poses
    rng = np.random.default_rng(0)
    res = gt.copy()
    res[:, :3, 3] += np.cumsum(rng.normal(0, 0.02, (len(gt), 3)), axis=0)
    for sub in ("gt", "results"):
        os.makedirs(d / sub)
    save_poses_kitti(str(d / "gt" / "07.txt"), gt)
    save_poses_kitti(str(d / "results" / "07.txt"), res)
    return d


def _close(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_close(a[k], b[k]) for k in a)
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    if isinstance(a, (int, float)):
        return abs(a - b) <= 1e-9
    return a == b


def _run_both(argv, capsys, tmp_path, name):
    """Each package's CLI on ``argv`` ({out} → its own directory)."""
    outs = []
    for mod, who in ((jcli, "jax"), (cli, "port")):
        d = tmp_path / f"{name}_{who}"
        os.makedirs(d)
        assert mod.main([a.format(out=d) for a in argv]) == 0
        outs.append((capsys.readouterr().out, d))
    return outs


def test_eval_equals_jax(trajectories, tmp_path, capsys):
    d = trajectories
    (ref, rd), (got, gd) = _run_both(
        ["eval", "--gt", str(d / "gt" / "07.txt"), "--result",
         str(d / "results" / "07.txt"), "--errors-out", "{out}/errors.txt"],
        capsys, tmp_path, "eval")
    assert _close(json.loads(got), json.loads(ref))
    assert json.loads(got)["num_segments"] > 0
    assert (gd / "errors.txt").read_bytes() == (rd / "errors.txt").read_bytes()


def test_eval_refuses_pose_count_mismatch(trajectories, tmp_path, capsys):
    d = trajectories
    short = tmp_path / "short.txt"
    short.write_text("".join((d / "results" / "07.txt").open().readlines()[:50]))
    argv = ["eval", "--gt", str(d / "gt" / "07.txt"), "--result", str(short)]
    assert cli.main(argv) == 2
    assert "pose count mismatch: gt=301 result=50" in capsys.readouterr().out
    assert cli.main(argv + ["--allow-partial"]) == 0


def test_eval_all_equals_jax(trajectories, tmp_path, capsys):
    d = trajectories
    (ref, rd), (got, gd) = _run_both(
        ["eval-all", "--gt-dir", str(d / "gt"), "--result-dir",
         str(d / "results"), "--out-dir", "{out}", "--no-plots"],
        capsys, tmp_path, "eval_all")
    assert got == ref
    summary = json.loads((gd / "summary.json").read_text())
    assert _close(summary, json.loads((rd / "summary.json").read_text()))
    assert summary["07"]["t_err"] > 0
    assert sorted(os.listdir(gd)) == sorted(os.listdir(rd))
    for f in os.listdir(gd):
        if os.path.isfile(gd / f) and f != "summary.json":
            assert (gd / f).read_bytes() == (rd / f).read_bytes(), f


# --- run-batch --------------------------------------------------------------


def _png(path, img):
    """An 8-bit grayscale PNG written with the standard library alone."""
    import struct
    import zlib

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    h, w = img.shape
    raw = b"".join(b"\0" + img[r].tobytes() for r in range(h))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 1)) + chunk(b"IEND", b""))


@pytest.fixture(scope="module")
def kitti_dirs(tmp_path_factory):
    """Two KITTI directories of 5 frames (seeds 0 and 1, as
    tests/test_cli_batch.py) and their ground truth under gt/."""
    root = tmp_path_factory.mktemp("kitti")
    intr = CameraIntrinsics(**INTR)
    os.makedirs(root / "gt")
    dirs = []
    for name, seed in (("05", 0), ("06", 1)):
        seq = SyntheticStereoSequence(intr, num_frames=5, seed=seed)
        for side, sub in enumerate(("image_0", "image_1")):
            os.makedirs(root / name / sub)
            for i in range(5):
                _png(str(root / name / sub / f"{i:06d}.png"),
                     np.asarray(seq.frame(i)[side], np.uint8))
        save_poses_kitti(str(root / "gt" / f"{name}.txt"), seq.poses)
        dirs.append(str(root / name))
    return root, dirs


def test_run_batch_equals_batched_runner(kitti_dirs, calib, tmp_path, capsys):
    root, dirs = kitti_dirs
    out = tmp_path / "out"
    argv = ["run-batch", *dirs, "--calibration", calib, "--out-dir",
            str(out), "--gt-dir", str(root / "gt"), "--device", "cpu",
            "--data-parallel", "1", "--chunk", "2", "--checkpoint",
            str(tmp_path / "batch.npz"), "--checkpoint-every", "2"] + FAST
    assert cli.main(argv) == 0
    stdout = capsys.readouterr().out
    assert "frames/s aggregate" in stdout
    summary = json.loads(stdout[stdout.index("{"):])
    assert set(summary) == {"05", "06"}
    cfg = VOConfig.for_image(H, W, **CFG)
    ref, _, _ = run_sequences_batched([KittiSequence(d) for d in dirs], cfg,
                                      CameraIntrinsics(**INTR), chunk=2,
                                      device="cpu")
    for name, poses in zip(("05", "06"), ref):
        assert (out / f"{name}.txt").read_bytes() == _file_of(
            poses, tmp_path / "ref.txt")
        assert len(poses) == 5


# --- a killed run resumes ---------------------------------------------------


def _env():
    return dict(os.environ, PYTHONPATH=ROOT + os.pathsep
                + os.environ.get("PYTHONPATH", ""))


def test_kill_and_resume_matches_uninterrupted(calib, tmp_path):
    """SIGKILL the run once a snapshot exists; the resumed run's poses are
    an uninterrupted run's, byte for byte."""
    ck = tmp_path / "ck.npz"
    out_resumed, out_clean = tmp_path / "resumed.txt", tmp_path / "clean.txt"
    base = [sys.executable, "-m", "visual_odom_tpu_torch.runner.cli", "run",
            "synthetic", calib, "--max-frames", str(N_FRAMES), "--quiet",
            "--device", "cpu"] + FAST
    cmd = base + ["--checkpoint", str(ck), "--checkpoint-every", "2",
                  "--output", str(out_resumed)]
    p = subprocess.Popen(cmd, env=_env(), stdout=subprocess.DEVNULL,
                         stderr=subprocess.DEVNULL)
    deadline = time.time() + 120
    while time.time() < deadline and p.poll() is None:
        if ck.exists() and ck.stat().st_size > 0:
            break
        time.sleep(0.05)
    if p.poll() is None:
        os.kill(p.pid, signal.SIGKILL)
        p.wait()
        assert ck.exists(), "no checkpoint was written before the kill"
    r = subprocess.run(cmd, env=_env(), capture_output=True, text=True,
                       timeout=240)
    assert r.returncode == 0, r.stderr[-2000:]
    r2 = subprocess.run(base + ["--output", str(out_clean)], env=_env(),
                        capture_output=True, text=True, timeout=240)
    assert r2.returncode == 0, r2.stderr[-2000:]
    assert out_resumed.read_bytes() == out_clean.read_bytes()
    assert np.loadtxt(out_clean).shape == (N_FRAMES, 12)


# --- refusals -----------------------------------------------------------------


def test_run_batch_mesh_of_more_data_rows_than_devices(kitti_dirs, calib,
                                                       tmp_path, capsys):
    _, dirs = kitti_dirs
    rc = cli.main(["run-batch", *dirs, "--calibration", calib, "--out-dir",
                   str(tmp_path), "--device", "cpu", "--data-parallel", "2"])
    assert rc == 2
    err = capsys.readouterr().err
    assert "mesh wants 2 devices, only 1 available" in err


# --- bench ---------------------------------------------------------------------


@pytest.mark.parametrize("device", [None, "cpu"])
@pytest.mark.parametrize("flags", [
    [], ["--quick"], ["--quick", "--frames", "5"],
    ["--frames", "33", "--height", "120", "--width", "160"]],
    ids=["defaults", "quick", "quick_frames", "frames_size"])
def test_bench_argv_equals_jax(flags, device, monkeypatch):
    """The port's ``bench`` hands ``subprocess.call`` JAX's command with
    the port's harness in place of ``bench.py``, plus ``--device``, and
    returns its exit code."""
    calls = []
    monkeypatch.setattr(subprocess, "call",
                        lambda cmd: calls.append(cmd) or 7)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert jcli.main(["bench", *flags]) == 7
    dev = [] if device is None else ["--device", device]
    assert cli.main(["bench", *flags, *dev]) == 7
    jax_cmd, port_cmd = calls
    assert jax_cmd[:2] == [sys.executable, "bench.py"]
    assert port_cmd == ([sys.executable, "-m", "visual_odom_tpu_torch.bench"]
                        + jax_cmd[2:] + ["--device", device or "cuda"])


def test_bench_needs_a_card_or_cpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = []
    monkeypatch.setattr(subprocess, "call",
                        lambda cmd: calls.append(cmd) or 0)
    assert cli.main(["bench", "--quick"]) == 1
    err = capsys.readouterr().err
    assert "no CUDA device is available" in err and "--device cpu" in err
    assert not calls


def test_bench_subprocess_on_cpu(tmp_path):
    """``vo bench`` for real, from outside the repository: the harness's
    last line parses, with JAX's quick gauntlet."""
    r = subprocess.run(
        [sys.executable, "-m", "visual_odom_tpu_torch.runner.cli", "bench",
         "--quick", "--frames", "5", "--height", str(H), "--width", str(W),
         "--device", "cpu"],
        env=dict(_env(), VO_COURSE_CACHE=str(tmp_path / "cache"),
                 OMP_NUM_THREADS="1"),
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["metric"] == "vo_fps_per_chip" and line["value"] > 0
    assert list(line["courses"]) == ["straight", "turning", "stress"]
    assert line["image"] == f"{W}x{H}" and line["frames"] == 5
    assert "[bench] straight: " in r.stderr


# --- the multi-device paths on patched CPU device lists ------------------------


def _cpus(n):
    return lambda device: [torch.device("cpu")] * n


@pytest.mark.parametrize("data", [2, 1])
def test_run_batch_on_a_mesh_equals_one_device(kitti_dirs, calib, tmp_path,
                                               monkeypatch, capsys, data):
    """Two devices make a (2, 1) mesh (the default data axis) or, with
    ``--data-parallel 1``, a (1, 2) one; the pose files are the one-device
    run's, byte for byte."""
    _, dirs = kitti_dirs
    monkeypatch.setattr(cli, "_mesh_devices", _cpus(2))
    out = tmp_path / "out"
    argv = ["run-batch", *dirs, "--calibration", calib, "--out-dir",
            str(out), "--chunk", "2", "--device", "cpu"] + FAST
    if data == 1:
        argv += ["--data-parallel", "1"]
    assert cli.main(argv) == 0
    assert "frames/s aggregate" in capsys.readouterr().out
    ref, _, _ = run_sequences_batched([KittiSequence(d) for d in dirs],
                                      VOConfig.for_image(H, W, **CFG),
                                      CameraIntrinsics(**INTR), chunk=2,
                                      device="cpu")
    for name, poses in zip(("05", "06"), ref):
        assert (out / f"{name}.txt").read_bytes() == _file_of(
            poses, tmp_path / "ref.txt")


@pytest.mark.parametrize("chunk", [True, False], ids=["chunk", "run"])
def test_ba_ring_on_four_devices_equals_ring_smoothing(calib, direct,
                                                       tmp_path, monkeypatch,
                                                       chunk):
    """``--ba-ring`` over a patched list of four CPU devices: the pose file
    is ``smooth_trajectory_ba`` with the ring solver on a four-device "seq"
    mesh, on the door's own snapshots (4-frame windows: every window falls
    back to ``ba_solve``, as JAX's solver does)."""
    from visual_odom_tpu_torch.parallel.ring_ba import make_ring_window_solver

    monkeypatch.setattr(cli, "_mesh_devices", _cpus(4))
    out = tmp_path / "poses.txt"
    argv = (["run", "synthetic", calib, "--max-frames", str(N_FRAMES),
             "--quiet", "--device", "cpu", "--output", str(out),
             "--ba-window", "4", "--ba-ring"] + FAST
            + (["--chunk", "4"] if chunk else []))
    assert cli.main(argv) == 0
    intr = CameraIntrinsics(**INTR)
    poses, snaps = (direct["scan_snaps"] if chunk
                    else (direct["run"], direct["run_snaps"]))
    solver = make_ring_window_solver(mesh.make_mesh(
        {"seq": 4}, devices=["cpu"] * 4))
    ref = smooth_trajectory_ba(snaps, poses, intr, window=4, solver=solver,
                               max_landmarks=256, min_track_len=3,
                               device="cpu")
    assert solver.branches["single"] == N_FRAMES // 4
    assert out.read_bytes() == _file_of(ref, tmp_path / "ref.txt")


def test_ba_ring_engages_the_ring_branch(calib, tmp_path, monkeypatch):
    """``--ba-ring 2`` with 16-frame windows of short tracks (age cap 4):
    the window's solve runs on a two-window ring, and the pose file is
    ``smooth_trajectory_ba`` with that ring solver on the snapshots the
    command collected."""
    from visual_odom_tpu_torch.ba import window
    from visual_odom_tpu_torch.parallel import ring_ba

    monkeypatch.setattr(cli, "_mesh_devices", _cpus(4))
    solves, inputs = [], []
    real_solve, real_smooth = ring_ba.ring_ba_solve, window.smooth_trajectory_ba

    def counted(problem, mesh_, **kw):
        solves.append(mesh_.shape)
        return real_solve(problem, mesh_, **kw)

    def recorded(snaps, poses, *args, **kw):
        inputs.append((snaps, poses.copy()))
        return real_smooth(snaps, poses, *args, **kw)

    monkeypatch.setattr(ring_ba, "ring_ba_solve", counted)
    monkeypatch.setattr(window, "smooth_trajectory_ba", recorded)
    out = tmp_path / "poses.txt"
    argv = ["run", "synthetic", calib, "--max-frames", "17", "--quiet",
            "--device", "cpu", "--output", str(out), "--chunk", "8",
            "--ba-window", "16", "--ba-ring", "2", "--age-threshold", "4"] + FAST
    assert cli.main(argv) == 0
    assert solves == [{"seq": 2}]
    (snaps, poses), = inputs
    solver = ring_ba.make_ring_window_solver(
        mesh.make_mesh({"seq": 2}, devices=["cpu"] * 2))
    ref = real_smooth(snaps, poses, CameraIntrinsics(**INTR), window=16,
                      solver=solver, max_landmarks=256, min_track_len=3,
                      device="cpu")
    assert solver.branches == {"ring": 1, "single": 0}
    assert out.read_bytes() == _file_of(ref, tmp_path / "ref.txt")


def test_ba_ring_on_cpu_is_the_window_alone(calib, direct, tmp_path):
    """On ``--device cpu`` the ring has one device: the solver takes its
    ``ba_solve`` branch at the default solver's settings, so the pose file
    equals ``--ba-window`` alone, byte for byte."""
    out = tmp_path / "poses.txt"
    argv = (["run", "synthetic", calib, "--max-frames", str(N_FRAMES),
             "--quiet", "--device", "cpu", "--output", str(out),
             "--ba-window", "4", "--ba-ring", "--chunk", "4"] + FAST)
    assert cli.main(argv) == 0
    assert out.read_bytes() == _file_of(direct["scan_ba"],
                                        tmp_path / "ref.txt")


@pytest.mark.parametrize("command", ["run", "run-batch"])
def test_stepping_commands_need_a_card_or_cpu(command, kitti_dirs, calib,
                                              tmp_path, monkeypatch, capsys):
    _, dirs = kitti_dirs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = (["run", "synthetic", calib, "--output", str(tmp_path / "p.txt")]
            if command == "run"
            else ["run-batch", *dirs, "--calibration", calib, "--out-dir",
                  str(tmp_path / "out")])
    assert cli.main(argv) == 1
    err = capsys.readouterr().err
    assert "no CUDA device is available" in err and "--device cpu" in err
    assert not os.listdir(tmp_path)


def test_stepping_command_exits_nonzero_without_card(calib):
    r = subprocess.run([sys.executable, "-m",
                        "visual_odom_tpu_torch.runner.cli", "run",
                        "synthetic", calib, "--max-frames", "2"],
                       env=dict(_env(), CUDA_VISIBLE_DEVICES=""),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 1
    assert "no CUDA device" in r.stderr


def test_live_without_display(calib, monkeypatch, capsys):
    monkeypatch.delenv("DISPLAY", raising=False)
    monkeypatch.delenv("WAYLAND_DISPLAY", raising=False)
    rc = cli.main(["run", "synthetic", calib, "--device", "cpu",
                   "--max-frames", "2", "--live"])
    assert rc == 1
    assert "needs a display server" in capsys.readouterr().out


def test_rgbd_without_camera_fails_fast(calib):
    with pytest.raises(FileNotFoundError, match="not present"):
        cli.main(["run", "rgbd", calib, "--device", "cpu"])
