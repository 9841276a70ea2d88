"""A whole run on the CPU at a tiny size: the reference against the
program's eager path, the last line's keys, and ``correct`` coming out
false with the timed path broken underneath (the harness's look for a
card is skipped: ``run_cell`` is called on the CPU)."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from vobench import bank as bank_mod, spec
from vobench.run import run_cell

torch.set_num_threads(1)

H, W = 120, 160
BENCH = json.load(open(os.path.join(spec.ROOT, "BENCHMARK.json")))
TRAFFIC = {
    "batched": {"door": "batched", "clips": 3, "clip_frames": 7,
                "offset_max": 12, "chunk": 2},
    "live": {"door": "live", "clips": 1, "clip_frames": 7,
             "offset_max": 12, "chunk": 0},
}
#: the real cell whose metrics and limits a tiny cell takes
CELL = {"batched": "stereo.batch11", "live": "stereo.live"}


@pytest.fixture(scope="module")
def bank():
    return bank_mod.render(20, H, W, course_frames=60, workers=1)


@pytest.fixture(scope="module")
def checker_bank():
    from vobench import synthetic

    intr = bank_mod.intrinsics(H, W)
    seq = synthetic.make_course("straight", intr, num_frames=20,
                                texture_family="checker")
    frames = [seq.frame(i) for i in range(20)]
    return bank_mod.Bank(np.stack([f[0] for f in frames]),
                         np.stack([f[1] for f in frames]), seq.poses)


def program(mono=False):
    from visual_odom_tpu_torch.config import CameraIntrinsics, VOConfig

    cfg = VOConfig.for_image(H, W, ransac_iterations=50, lk_max_iters=10,
                             mono_rotation=mono)
    intr = CameraIntrinsics(**dataclasses.asdict(bank_mod.intrinsics(H, W)))
    return cfg, intr


def tiny(door: str) -> spec.Cell:
    real = spec.load_cell(CELL[door])
    return real._replace(traffic=TRAFFIC[door])


def run(door, bank, mono=False, trace=False):
    return run_cell(tiny(door), 2 ** 31 + 99, 0.01, trace, "cpu", bank=bank,
                    program=program(mono))


@pytest.mark.parametrize("door", ["batched", "live"])
@pytest.mark.parametrize("trace", [False, True])
def test_run_is_correct_and_its_line_has_the_keys(bank, door, trace):
    res = run(door, bank, trace=trace)
    assert res["correct"] is True
    assert list(res)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(res)
    assert res["attempted"] > 0 and res["failed"] == 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        res["device"])
    cell = tiny(door)
    wanted = {m["name"] for m in (cell.per_layer if trace else
                                  cell.end_to_end)}
    assert set(res["metrics"]) <= wanted
    if trace:
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(res["metrics"]) == wanted
    for v in res["checks"].values():
        assert v["value"] <= v["limit"]


@pytest.mark.parametrize("mono", [False, True])
@pytest.mark.parametrize("texture", ["value", "checker"])
def test_reference_matches_the_programs_eager_path(bank, checker_bank, mono,
                                                   texture):
    """The reference against the program's plain path on the CPU, bit for
    bit, also where the adaptive skip re-tracks at the safe level."""
    from visual_odom_tpu_torch.parallel.batch_eval import \
        run_sequences_batched
    from vobench.reference import step as ref_step
    from vobench.reference.config import CameraIntrinsics, VOConfig

    b = checker_bank if texture == "checker" else bank
    cfg, intr = program(mono)
    clips = [bank_mod.Clip(b, s, 9) for s in (0, 5)]
    poses, stats, _ = run_sequences_batched(clips, cfg, intr, seed=11,
                                            chunk=4, device="cpu")
    ref_cfg = VOConfig(**dataclasses.asdict(cfg))
    ref_intr = CameraIntrinsics(**dataclasses.asdict(intr))
    out, records = ref_step.run_clips(
        ref_cfg, ref_intr, np.stack([c.stacks()[0] for c in clips]),
        np.stack([c.stacks()[1] for c in clips]), [11, 12], "cpu",
        record_steps=(3,))
    for k in range(2):
        ref = ref_step.chain_poses(out.T_inv[:, k], out.accept[:, k])
        np.testing.assert_array_equal(ref, poses[k])
        assert stats[k]["fallback_frames"] == int(out.fallback[:, k].sum())
    if texture == "checker":
        assert out.fallback.any()
    assert [r.start_level for _, r in records] == [1, 2, 2]


def _state_unchanged(monkeypatch):
    from visual_odom_tpu_torch.runner import pipeline

    real = pipeline.make_step_fn

    def make(*a, **k):
        step = real(*a, **k)

        def broken(state, *args, **kw):
            _, *rest = step(state, *args, **kw)
            return (state, *rest)

        return broken

    monkeypatch.setattr(pipeline, "make_step_fn", make)


def _answer_altered(monkeypatch):
    from visual_odom_tpu_torch.runner import pipeline

    real = pipeline.make_step_fn

    def make(*a, **k):
        step = real(*a, **k)

        def broken(state, *args, **kw):
            new, out, *rest = step(state, *args, **kw)
            bump = torch.zeros_like(out.T_inv)
            bump[..., 0, 3] = 0.01
            return (new, out._replace(T_inv=out.T_inv + bump), *rest)

        return broken

    monkeypatch.setattr(pipeline, "make_step_fn", make)


def _answer_altered_sometimes(monkeypatch):
    """A translation altered on every third step only: a minority of a
    clip's frames, which a clip's median does not see."""
    from visual_odom_tpu_torch.runner import pipeline

    real = pipeline.make_step_fn
    calls = [0]

    def make(*a, **k):
        step = real(*a, **k)

        def broken(state, *args, **kw):
            new, out, *rest = step(state, *args, **kw)
            calls[0] += 1
            if calls[0] % 3:
                return (new, out, *rest)
            bump = torch.zeros_like(out.T_inv)
            bump[..., 0, 3] = 0.01
            return (new, out._replace(T_inv=out.T_inv + bump), *rest)

        return broken

    monkeypatch.setattr(pipeline, "make_step_fn", make)


def _half_batch(monkeypatch):
    from visual_odom_tpu_torch.parallel import batch_eval

    real = batch_eval.run_sequences_batched

    def broken(sequences, *a, **k):
        half = max(1, len(sequences) // 2)
        poses, stats, wall = real(sequences[:half], *a, **k)
        rest = len(sequences) - half
        mean = np.mean(np.stack(poses), axis=0)
        return (poses + [mean] * rest, stats + [stats[0]] * rest, wall)

    monkeypatch.setattr(batch_eval, "run_sequences_batched", broken)


@pytest.mark.parametrize("door,fault", [
    ("batched", _state_unchanged), ("batched", _answer_altered),
    ("batched", _answer_altered_sometimes), ("batched", _half_batch),
    ("live", _state_unchanged), ("live", _answer_altered),
    ("live", _answer_altered_sometimes)],
    ids=["batched-state", "batched-answer", "batched-answer-minority",
         "batched-half", "live-state", "live-answer", "live-answer-minority"])
def test_a_broken_timed_path_is_not_correct(bank, monkeypatch, door, fault):
    fault(monkeypatch)
    res = run(door, bank)
    assert res["correct"] is False
    if fault is _answer_altered_sometimes:
        # the median holds; a number that sees a minority of frames fails
        checks = res["checks"]
        assert checks["delta_t_median_um"]["value"] <= checks[
            "delta_t_median_um"]["limit"]
        assert any(v["value"] > v["limit"] for k, v in checks.items()
                   if "median" not in k)
