"""Headless trajectory visualization.

A copy of ``visual_odom_tpu/eval/plot.py`` (NumPy, and cv2 where it is
installed). It replaces the reference's interactive OpenCV windows
(display, src/utils.cpp:19-48: a 600x1200 canvas with the estimated
trajectory in red at (x+300, z+100) and GT in yellow; displayTracking,
src/visualOdometry.cpp:195-224: green t0 / red t1 circles with green track
lines) with arrays and PNG artifacts; no display server is required.
Without cv2, ``render_tracks`` marks single pixels and ``save_png`` writes
through PIL.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def render_trajectory(
    poses: np.ndarray,
    poses_gt: Optional[np.ndarray] = None,
    size: tuple[int, int] = (600, 1200),
    offset: tuple[int, int] = (300, 100),
) -> np.ndarray:
    """(H, W, 3) uint8 bird's-eye canvas, reference color scheme
    (estimate red, GT yellow; reference src/utils.cpp:19-37)."""
    H, W = size
    canvas = np.zeros((H, W, 3), np.uint8)

    def draw(ps, color):
        xs = np.round(ps[:, 0, 3] + offset[0]).astype(int)
        ys = np.round(ps[:, 2, 3] + offset[1]).astype(int)
        ok = (xs >= 1) & (xs < W - 1) & (ys >= 1) & (ys < H - 1)
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                canvas[ys[ok] + dy, xs[ok] + dx] = color

    if poses_gt is not None:
        draw(np.asarray(poses_gt), (0, 255, 255))  # BGR yellow
    draw(np.asarray(poses), (0, 0, 255))           # BGR red
    return canvas


def render_tracks(
    image: np.ndarray,
    points_t0: np.ndarray,
    points_t1: np.ndarray,
    valid: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Track overlay (displayTracking, reference src/visualOdometry.cpp:195-224):
    green t0 circles, red t1 circles, green lines."""
    try:
        import cv2
    except ImportError:
        cv2 = None
    vis = np.stack([image] * 3, axis=-1).astype(np.uint8).copy()
    if valid is None:
        valid = np.ones(len(points_t0), bool)
    p0 = np.asarray(points_t0)[valid]
    p1 = np.asarray(points_t1)[valid]
    if cv2 is not None:
        for a, b in zip(p0, p1):
            cv2.circle(vis, (int(a[0]), int(a[1])), 2, (0, 255, 0))
            cv2.circle(vis, (int(b[0]), int(b[1])), 2, (0, 0, 255))
            cv2.line(vis, (int(a[0]), int(a[1])), (int(b[0]), int(b[1])),
                     (0, 255, 0))
    else:
        for (x, y), c in [(p, (0, 255, 0)) for p in p0] + [
            (p, (0, 0, 255)) for p in p1
        ]:
            xi, yi = int(round(x)), int(round(y))
            if 0 <= yi < vis.shape[0] and 0 <= xi < vis.shape[1]:
                vis[yi, xi] = c
    return vis


class LiveDisplay:
    """Interactive twin of the reference's display windows: the persistent
    'Trajectory' bird's-eye canvas (src/utils.cpp:19-48 — estimate red, GT
    yellow, cv::imshow + waitKey(1)) and the 'Road facing camera' track
    overlay (src/visualOdometry.cpp:195-224). The headless PNG artifacts
    remain the default (SURVEY.md section 5's stance for display-less
    hosts); this class exists for workstations with a display server.

    ``offscreen=True`` renders every frame without opening windows — the
    mode tests (and headless CI) exercise; construction on a host whose
    OpenCV lacks GUI support raises RuntimeError with guidance unless
    offscreen is set.
    """

    def __init__(self, poses_gt: Optional[np.ndarray] = None,
                 size: tuple[int, int] = (600, 1200),
                 offset: tuple[int, int] = (300, 100),
                 offscreen: bool = False):
        self._size = size
        self._offset = offset
        self._offscreen = offscreen
        self.canvas = np.zeros((size[0], size[1], 3), np.uint8)
        if poses_gt is not None and len(poses_gt):
            self._draw(np.asarray(poses_gt), (0, 255, 255))  # GT once, yellow
        self.frames_shown = 0
        self.last_tracks_vis: Optional[np.ndarray] = None
        self._cv2 = None
        if not offscreen:
            import os

            # Pre-check the display server: cv2.namedWindow on a
            # display-less host ABORTS the process inside Qt (not an
            # exception), so this must be refused before touching cv2 GUI.
            if not (os.environ.get("DISPLAY")
                    or os.environ.get("WAYLAND_DISPLAY")):
                raise RuntimeError(
                    "LiveDisplay needs a display server (no DISPLAY/"
                    "WAYLAND_DISPLAY set); use the headless "
                    "--trajectory-png/--tracks-dir artifacts instead")
            try:
                import cv2

                cv2.namedWindow("Trajectory", cv2.WINDOW_AUTOSIZE)
                self._cv2 = cv2
            except Exception as e:
                raise RuntimeError(
                    "LiveDisplay needs GUI-enabled OpenCV; use the "
                    "headless --trajectory-png/--tracks-dir artifacts "
                    f"instead ({e!r})") from e

    def _draw(self, poses: np.ndarray, color) -> None:
        H, W = self._size
        ps = np.asarray(poses).reshape(-1, 4, 4)
        xs = np.round(ps[:, 0, 3] + self._offset[0]).astype(int)
        ys = np.round(ps[:, 2, 3] + self._offset[1]).astype(int)
        ok = (xs >= 1) & (xs < W - 1) & (ys >= 1) & (ys < H - 1)
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                self.canvas[ys[ok] + dy, xs[ok] + dx] = color

    def update(self, pose: np.ndarray, left: Optional[np.ndarray] = None,
               tracks=None) -> None:
        """Per-frame hook: draws the new pose onto the persistent canvas
        (reference redraws incrementally the same way) and, when the frame
        image + TrackSnapshot are given, the track overlay window."""
        self._draw(pose[None], (0, 0, 255))
        if left is not None and tracks is not None:
            self.last_tracks_vis = render_tracks(
                np.asarray(left), tracks.points_l0, tracks.points_l1,
                np.asarray(tracks.valid))
        self.frames_shown += 1
        if self._cv2 is not None:
            self._cv2.imshow("Trajectory", self.canvas)
            if self.last_tracks_vis is not None:
                self._cv2.imshow("Road facing camera", self.last_tracks_vis)
            self._cv2.waitKey(1)  # reference src/main.cpp display loop

    def close(self) -> None:
        if self._cv2 is not None:
            self._cv2.destroyAllWindows()


def save_png(path: str, image: np.ndarray) -> None:
    try:
        import cv2

        cv2.imwrite(path, image)
    except ImportError:
        from PIL import Image

        Image.fromarray(image[..., ::-1]).save(path)
