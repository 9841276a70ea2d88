"""Camera sources: the protocol and its implementations.

Port of ``visual_odom_tpu/io/camera.py``. The reference's CameraBase HAL
(src/camera_object.h:7-41: an abstract getLRFrames and frame dumping gated
by an environment variable) becomes a host-side protocol that feeds the
pipeline. ``V4L2StereoCamera`` is the reference's Intel_V4L2 capture
(src/rgbd_standalone.cpp) through ``io.native``; on a host without the
device node it raises at construction. ``FakeCamera`` replays frames in
memory and ``ImageDirCamera`` a KITTI-layout directory.
"""

from __future__ import annotations

import os
from typing import Protocol, Sequence

import numpy as np


class CameraSource(Protocol):
    """Protocol version of reference CameraBase (src/camera_object.h:7-41)."""

    def get_lr_frames(self) -> tuple[np.ndarray, np.ndarray]:
        """Next (left, right) grayscale uint8 pair."""
        ...


class _SaveFramesMixin:
    """With ``SAVE_FRAMES`` set, every pair handed out is written as
    ``left%06d.png`` / ``right%06d.png`` into ``SAVE_FRAMES_DIR`` (default
    ``images``; reference src/camera_object.h:9-37)."""

    _save_count = 0

    def _maybe_save(self, left: np.ndarray, right: np.ndarray) -> None:
        if not os.environ.get("SAVE_FRAMES"):
            return
        outdir = os.environ.get("SAVE_FRAMES_DIR", "images")
        os.makedirs(outdir, exist_ok=True)
        idx = self._save_count
        self._save_count += 1
        try:
            import cv2

            cv2.imwrite(os.path.join(outdir, f"left{idx:06d}.png"), left)
            cv2.imwrite(os.path.join(outdir, f"right{idx:06d}.png"), right)
        except ImportError:
            from PIL import Image

            Image.fromarray(left).save(
                os.path.join(outdir, f"left{idx:06d}.png"))
            Image.fromarray(right).save(
                os.path.join(outdir, f"right{idx:06d}.png"))


class FakeCamera(_SaveFramesMixin):
    """Replays a list of (left, right) pairs; with ``loop`` it starts over
    at the end, else it raises StopIteration there."""

    def __init__(self, frames: Sequence[tuple[np.ndarray, np.ndarray]],
                 loop=False):
        self._frames = list(frames)
        self._i = 0
        self._loop = loop

    def get_lr_frames(self) -> tuple[np.ndarray, np.ndarray]:
        if self._i >= len(self._frames):
            if not self._loop:
                raise StopIteration
            self._i = 0
        left, right = self._frames[self._i]
        self._i += 1
        self._maybe_save(left, right)
        return left, right


class ImageDirCamera(_SaveFramesMixin):
    """Replays a KITTI-layout directory (``io.kitti.KittiSequence``)
    through the camera protocol."""

    def __init__(self, path: str):
        from visual_odom_tpu_torch.io.kitti import KittiSequence

        self._seq = KittiSequence(path)
        self._i = 0

    def get_lr_frames(self) -> tuple[np.ndarray, np.ndarray]:
        if self._i >= len(self._seq):
            raise StopIteration
        pair = self._seq.frame(self._i)
        self._i += 1
        self._maybe_save(*pair)
        return pair


class V4L2StereoCamera(_SaveFramesMixin):
    """Live interleaved-stereo capture, the reference's Intel_V4L2
    (src/rgbd_standalone.cpp:57-228): a Y8I /dev/video stream split into
    left (low byte) and right (high byte) planes, captured by the native
    V4L2 unit (``io.native.NativeV4L2Camera``: MMAP streaming and poll).
    Without the device node it raises FileNotFoundError at construction.
    """

    def __init__(self, device: str = "/dev/video1", width: int = 640,
                 height: int = 480, warmup_frames: int = 10):
        if not os.path.exists(device):
            raise FileNotFoundError(
                f"V4L2 device {device} not present on this host")
        from visual_odom_tpu_torch.io.native import NativeV4L2Camera

        self._cam = NativeV4L2Camera(device, width, height,
                                     discard=warmup_frames)

    def get_lr_frames(self) -> tuple[np.ndarray, np.ndarray]:
        pair = self._cam.get_lr_frames()
        self._maybe_save(*pair)
        return pair

    def close(self) -> None:
        self._cam.close()

    @staticmethod
    def split_y8i(packed: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Split a (H, W) uint16 Y8I frame into (left, right) uint8 planes
        (reference src/rgbd_standalone.cpp:186-193: left = low byte, right
        = high byte)."""
        packed = np.asarray(packed, dtype=np.uint16)
        left = (packed & 0xFF).astype(np.uint8)
        right = (packed >> 8).astype(np.uint8)
        return left, right
