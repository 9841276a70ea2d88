"""Chunk-boundary checkpoints of the scan runner.

Port of the scan half of ``visual_odom_tpu/utils/checkpoint.py``
(``CorruptCheckpoint``, ``_atomic_savez``, ``save_scan_checkpoint``,
``load_scan_checkpoint``). A snapshot is one ``.npz``: the absolute step
cursor, the device state's resumable arrays, every per-frame output fetched
so far (``out_*``) and, for a run that collects them, every track snapshot
(``trk_*``). Pyramids are not stored: they are a pure function of frame t0
and are rebuilt at resume. It is written to a temporary file in the same
directory and moved into place, so a crash never leaves a torn snapshot.

The JAX package stores its PRNG key; the port stores the RANSAC
generator's state instead (``gen_state``: ``torch.Generator.get_state()``,
a uint8 tensor on the host whatever the generator's device), and the
``fallback`` output its ``StepOutput`` carries beside JAX's fields.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np

#: the state's resumable arrays, as the runner hands them over
STATE_KEYS = ("points", "ages", "valid", "ids", "next_id", "flow", "disp",
              "tvec", "gen_state")
_SCAN_REQUIRED = (("frames_done",) + STATE_KEYS
                  + ("out_T_inv", "out_accept", "out_scale", "out_euler",
                     "out_rvec", "out_tvec", "out_num_inliers",
                     "out_num_matched", "out_num_bucketed", "out_fallback"))


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
