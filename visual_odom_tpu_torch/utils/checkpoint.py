"""Checkpoints of the scan runner, the batched runner and ``VisualOdometry``.

Port of ``visual_odom_tpu/utils/checkpoint.py``. A snapshot is one
``.npz`` holding the device state's resumable arrays. A scan snapshot adds
the absolute step cursor, every per-frame output fetched so far (``out_*``)
and, for a run that collects them, every track snapshot (``trk_*``); a
batched snapshot (``run_sequences_batched``) holds the same for all B
lockstep sequences, every array with a leading B (outputs (steps, B,
...)), and the device kind it was taken on; a ``VisualOdometry`` snapshot
adds the integrated pose, the frame index and the caller's ``extra_*``
arrays.
Pyramids are not stored: they are a pure function of frame t0 and are
rebuilt at resume. It is written to a temporary file in the same
directory and moved into place, so a crash never leaves a torn snapshot.

The JAX package stores its PRNG key; the port stores the RANSAC
generator's state instead (``gen_state``: ``torch.Generator.get_state()``,
a uint8 tensor on the host whatever the generator's device; one row per
sequence in a batched snapshot), and the ``fallback`` output its
``StepOutput`` carries beside JAX's fields. A generator's state fits only
a generator of the device kind that saved it (16 bytes of Philox seed and
offset on the card, 5,056 of mt19937 on the CPU), so a snapshot taken on
the card resumes on the card.
"""

from __future__ import annotations

import os
import tempfile
from typing import Optional

import numpy as np

#: the state's resumable arrays, as the runner hands them over
STATE_KEYS = ("points", "ages", "valid", "ids", "next_id", "flow", "disp",
              "tvec", "gen_state")
_SCAN_REQUIRED = (("frames_done",) + STATE_KEYS
                  + ("out_T_inv", "out_accept", "out_scale", "out_euler",
                     "out_rvec", "out_tvec", "out_num_inliers",
                     "out_num_matched", "out_num_bucketed", "out_fallback"))
_REQUIRED_KEYS = ("frame_pose", "frame_id", "points", "ages", "valid", "ids",
                  "next_id", "tvec", "gen_state")
#: motion-prior LK seeds that the JAX package's first snapshot format
#: lacked; zero seeds are benign (the closure check still validates every
#: track), so a snapshot without them restores them as zeros
_OPTIONAL_ZERO_KEYS = ("flow", "disp")


class CorruptCheckpoint(ValueError):
    """A checkpoint that cannot be trusted (torn write, truncation, missing
    keys, a cursor that does not fit). Callers treat it as absent rather
    than resume from garbage."""


def _atomic_savez(path: str, payload: dict) -> int:
    """``np.savez`` to a temporary file beside ``path``, then
    ``os.replace``. Returns the bytes written."""
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)
        size = os.path.getsize(tmp)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return size


def save_scan_checkpoint(path: str, frames_done: int, state_arrays: dict,
                         fetched_outputs, tracks=None) -> int:
    """Snapshot a scan run at a chunk boundary. ``state_arrays`` holds
    STATE_KEYS as host numpy; ``fetched_outputs`` is the numpy
    ``StepOutput`` stack of the ``frames_done`` steps so far; ``tracks``
    (a stacked numpy ``TrackSnapshot``, optional) the per-frame track
    snapshots of a ``collect_tracks`` run. Returns the file's bytes."""
    payload = {"frames_done": np.int64(frames_done)}
    for k in STATE_KEYS:
        payload[k] = np.asarray(state_arrays[k])
    for k, v in fetched_outputs._asdict().items():
        payload["out_" + k] = np.asarray(v)
    if tracks is not None:
        for k, v in tracks._asdict().items():
            payload["trk_" + k] = np.asarray(v)
    return _atomic_savez(path, payload)


def load_scan_checkpoint(path: str) -> dict:
    """Load and validate a scan snapshot; raises CorruptCheckpoint on a
    torn or incomplete file, naming the first missing key."""
    try:
        with np.load(path) as z:
            ckpt = {k: z[k] for k in z.files}
    except Exception as e:
        raise CorruptCheckpoint(f"{path}: unreadable ({e!r})") from e
    missing = [k for k in _SCAN_REQUIRED if k not in ckpt]
    if missing:
        raise CorruptCheckpoint(f"{path}: missing keys {missing}")
    if int(ckpt["frames_done"]) != len(ckpt["out_accept"]):
        raise CorruptCheckpoint(
            f"{path}: cursor/output mismatch "
            f"({int(ckpt['frames_done'])} vs {len(ckpt['out_accept'])})")
    return ckpt


def save_checkpoint(path: str, vo, extra: Optional[dict] = None) -> int:
    """Snapshot a ``VisualOdometry``'s resumable state: its integrated
    pose, frame index and state arrays (one device-to-host copy), and each
    ``extra`` array as ``extra_<key>``. Returns the file's bytes."""
    from visual_odom_tpu_torch.runner.pipeline import state_arrays

    payload = {"frame_pose": np.asarray(vo.frame_pose, np.float64),
               "frame_id": np.int64(vo.frame_id), **state_arrays(vo.state)}
    for k, v in (extra or {}).items():
        payload["extra_" + k] = np.asarray(v)
    return _atomic_savez(path, payload)


def load_checkpoint(path: str) -> dict:
    """Load and validate a ``VisualOdometry`` snapshot; raises
    CorruptCheckpoint on a torn or incomplete file, naming the missing
    keys. ``flow`` and ``disp``, where absent, are zeros."""
    try:
        with np.load(path) as z:
            ckpt = {k: z[k] for k in z.files}
    except Exception as e:
        raise CorruptCheckpoint(f"{path}: unreadable ({e!r})") from e
    missing = [k for k in _REQUIRED_KEYS if k not in ckpt]
    if missing:
        raise CorruptCheckpoint(f"{path}: missing keys {missing}")
    for k in _OPTIONAL_ZERO_KEYS:
        if k not in ckpt:
            ckpt[k] = np.zeros_like(ckpt["points"])
    return ckpt


def restore_vo(vo, ckpt: dict, left_t0, right_t0) -> int:
    """Restore a ``VisualOdometry`` from a loaded snapshot and the images
    of the checkpointed frame (its pyramids are rebuilt from them, as the
    step builds them); the generator is rebuilt on ``vo.device``. Returns
    the next frame index."""
    from visual_odom_tpu_torch.runner.pipeline import restore_scan_state

    vo.frame_pose = np.asarray(ckpt["frame_pose"], np.float64)
    vo.frame_id = int(ckpt["frame_id"])
    vo.state = restore_scan_state(vo.config, vo.intrinsics, ckpt, left_t0,
                                  right_t0, device=vo.device)
    return vo.frame_id + 1


# --- batched (B sequences in lockstep) chunk-boundary checkpoints ----------

#: the batched runner's outputs kept in a snapshot (``out_<name>``)
BATCH_OUTPUTS = ("T_inv", "accept", "num_inliers", "fallback")
_BATCH_REQUIRED = (("frames_done", "device") + STATE_KEYS
                   + tuple("out_" + k for k in BATCH_OUTPUTS))


def _device_kind(device) -> str:
    """``"cuda"`` or ``"cpu"`` for a ``torch.device`` or its name."""
    return getattr(device, "type", str(device).split(":")[0])


def save_batch_checkpoint(path: str, frames_done: int, state_arrays: dict,
                          outs: dict, device="cpu") -> int:
    """Snapshot the batched scan at a chunk boundary. ``state_arrays``
    holds STATE_KEYS with a leading B (``gen_state`` (B, bytes));
    ``outs`` the BATCH_OUTPUTS stacks (steps, B, ...) of the
    ``frames_done`` steps; ``device`` the device the run is on. Returns
    the file's bytes."""
    payload = {"frames_done": np.int64(frames_done),
               "device": np.array(_device_kind(device))}
    for k in STATE_KEYS:
        payload[k] = np.asarray(state_arrays[k])
    for k in BATCH_OUTPUTS:
        payload["out_" + k] = np.asarray(outs[k])
    return _atomic_savez(path, payload)


def load_batch_checkpoint(path: str, batch: int, device=None) -> dict:
    """Load and validate a batched snapshot for a run of ``batch``
    sequences (on ``device``, when given); raises CorruptCheckpoint on a
    torn file, a missing key, a cursor that does not fit its outputs, a
    batch size other than the run's, or a snapshot taken on another device
    kind (its generators' states restore only there)."""
    try:
        with np.load(path) as z:
            ckpt = {k: z[k] for k in z.files}
    except Exception as e:
        raise CorruptCheckpoint(f"{path}: unreadable ({e!r})") from e
    missing = [k for k in _BATCH_REQUIRED if k not in ckpt]
    if missing:
        raise CorruptCheckpoint(f"{path}: missing keys {missing}")
    if int(ckpt["frames_done"]) != len(ckpt["out_accept"]):
        raise CorruptCheckpoint(
            f"{path}: cursor/output mismatch "
            f"({int(ckpt['frames_done'])} vs {len(ckpt['out_accept'])})")
    if ckpt["points"].shape[0] != batch:
        raise CorruptCheckpoint(
            f"{path}: batch mismatch (snapshot B={ckpt['points'].shape[0]},"
            f" run B={batch})")
    saved = str(ckpt["device"])
    if device is not None and saved != _device_kind(device):
        raise CorruptCheckpoint(
            f"{path}: snapshot taken on {saved}, run on "
            f"{_device_kind(device)}: a RANSAC generator's state "
            f"restores only on the device kind that saved it")
    return ckpt
