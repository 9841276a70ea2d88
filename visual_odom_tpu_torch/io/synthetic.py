"""Synthetic stereo sequence generator with exact ground truth.

A copy of ``visual_odom_tpu/io/synthetic.py`` (NumPy only), kept in the
port so that it renders the same courses without the JAX package.

There is no public imagery in this environment, so integration tests and
benchmarks render their own: a rigid 3-D scene ray-cast through the stereo
rig at each ground-truth pose. This plays the role of SURVEY.md section 4's
"short synthetic stereo sequence" — end-to-end trajectories are scored
against the exact poses used for rendering.

Scene design (a *fair* course — every frame must be trackable):

- A corridor of textured wall segments placed along the ground-truth path at
  +-16 m lateral offset, each segment aligned with the local heading, so the
  camera never approaches or passes through scene geometry no matter how
  long the course is (the round-1 scene put fronto-parallel billboards ON
  the path; the camera flew through them and FAST starved, VERDICT.md
  weak #1).
- A ground plane and a far backdrop beyond the course end.
- Textures are multi-octave value noise with near-flat persistence
  (8 octaves, 0.95), so there is gradient structure at EVERY magnification:
  approaching geometry never smooths out below the FAST threshold.
- Texture scale is normalized by the camera's angular resolution
  (718.856 / fx), so reduced-resolution test cameras see the same
  pixels-per-texel statistics as the KITTI-sized bench camera.

Rendering is plain vectorized NumPy on the host (it is test/bench input
generation, not part of the pipeline).
"""

from __future__ import annotations

import numpy as np

from visual_odom_tpu_torch.config import CameraIntrinsics


def _smooth_noise(h, w, rng, octaves=8, persistence=0.95):
    """Multi-octave value noise in [0, 255].

    Near-flat persistence keeps the fine octaves strong: local contrast
    stays above the FAST threshold at any viewing magnification.
    """
    img = np.zeros((h, w), np.float64)
    amp = 1.0
    for o in range(octaves):
        s = max(2, 2 ** (octaves - o))
        small = rng.uniform(0, 1, (h // s + 2, w // s + 2))
        ys = np.linspace(0, small.shape[0] - 1.001, h)
        xs = np.linspace(0, small.shape[1] - 1.001, w)
        y0 = ys.astype(int)
        x0 = xs.astype(int)
        fy = (ys - y0)[:, None]
        fx = (xs - x0)[None, :]
        a = small[np.ix_(y0, x0)]
        b = small[np.ix_(y0, x0 + 1)]
        c = small[np.ix_(y0 + 1, x0)]
        d = small[np.ix_(y0 + 1, x0 + 1)]
        up = (1 - fy) * (1 - fx) * a + (1 - fy) * fx * b + fy * (1 - fx) * c + fy * fx * d
        img += up * amp
        amp *= persistence
    img -= img.min()
    img /= img.max()
    return img * 255.0


def _checker_interference(h, w, rng):
    """Alternative texture family ("checker") for the level-skip ablation
    (VERDICT r4 next-step #9): a soft checkerboard + a handful of
    band-limited sinusoid gratings + sparse Gaussian blobs. Spectrally
    disjoint from _smooth_noise's near-1/f value-noise stack — energy
    concentrated at a few scales with periodic self-similarity, exactly the
    structure that tempts coarse-to-fine LK toward wrong (aliased) minima
    when coarse levels are skipped."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = 0.45 * np.sin(2 * np.pi * xx / 24) * np.sin(2 * np.pi * yy / 24)
    for _ in range(6):
        fx_, fy_ = rng.uniform(0.02, 0.25, 2)
        img += 0.12 * np.sin(2 * np.pi * (fx_ * xx + fy_ * yy)
                             + rng.uniform(0, 2 * np.pi))
    # Sparse blobs: isolated corners so the detector is never starved.
    for _ in range(max(200, h * w // 1600)):
        cx, cy = rng.integers(0, w), rng.integers(0, h)
        sig = rng.uniform(1.5, 4.0)
        r = int(3 * sig)
        y0, y1 = max(0, cy - r), min(h, cy + r + 1)
        x0, x1 = max(0, cx - r), min(w, cx + r + 1)
        py, px = np.mgrid[y0:y1, x0:x1].astype(np.float64)
        img[y0:y1, x0:x1] += rng.uniform(-1.2, 1.2) * np.exp(
            -((py - cy) ** 2 + (px - cx) ** 2) / (2 * sig * sig))
    img -= img.min()
    img /= max(img.max(), 1e-9)
    return img * 255.0


_TEXTURE_FAMILIES = {"value": _smooth_noise,
                     "checker": _checker_interference}


class _Plane:
    def __init__(self, p0, e1, e2, extent1, extent2, texture, tex_scale,
                 path_s=None):
        self.p0 = np.asarray(p0, np.float64)
        e1 = np.asarray(e1, np.float64)
        e2 = np.asarray(e2, np.float64)
        self.e1 = e1 / np.linalg.norm(e1)
        self.e2 = e2 / np.linalg.norm(e2)
        self.n = np.cross(self.e1, self.e2)
        self.extent1 = extent1
        self.extent2 = extent2
        self.texture = texture
        self.tex_scale = tex_scale
        # Arc-length interval along the path this plane is relevant to
        # (None = always rendered). Used only for render culling.
        self.path_s = path_s

    def sample(self, a, b):
        th, tw = self.texture.shape
        u = (a / self.tex_scale) % 1.0 * (tw - 1)
        v = (b / self.tex_scale) % 1.0 * (th - 1)
        u0 = u.astype(int)
        v0 = v.astype(int)
        u1 = np.minimum(u0 + 1, tw - 1)
        v1 = np.minimum(v0 + 1, th - 1)
        fu = u - u0
        fv = v - v0
        t = self.texture
        return ((1 - fv) * (1 - fu) * t[v0, u0] + (1 - fv) * fu * t[v0, u1]
                + fv * (1 - fu) * t[v1, u0] + fv * fu * t[v1, u1])


class SyntheticStereoSequence:
    """Renders (left, right) uint8 frames along a smooth forward trajectory.

    Poses follow the KITTI convention: ``poses[i]`` maps camera-i coordinates
    to world coordinates (T_w_cam); camera looks down +z, x right, y down.
    """

    #: corridor half-width in meters (camera to wall)
    WALL_OFFSET = 16.0
    #: wall segment spacing along the path, meters
    SEG_SPACING = 8.0
    #: how far past the course end the corridor + backdrop extend, meters
    OVERRUN = 40.0

    def __init__(
        self,
        intrinsics: CameraIntrinsics,
        num_frames: int = 20,
        seed: int = 0,
        speed: float = 0.8,
        yaw_rate: float = 0.004,
        course: str = "straight",
        photometric: bool = False,
        noise_sigma: float = 0.0,
        occluders: bool = False,
        lowtex_span: tuple[float, float] | None = None,
        texture_family: str = "value",
    ):
        """Args beyond the round-2 surface (all default OFF — the gentle
        straight corridor is unchanged):

        course: "straight" (gentle wander, the round-2 course), "turning"
          (KITTI-style 90-degree intersections whose peak per-frame yaw
          approaches the reference's 0.1 rad rejection gate,
          reference src/main.cpp:201-208 — VERDICT.md round-2 missing #1),
          "long" (a non-self-intersecting snake of exact alternating
          90-degree turns between ~150 m straights — the >= 800 m endurance
          course that populates every devkit segment-length bucket,
          reference src/evaluate/evaluate_odometry.cpp:12-15), or "loop"
          (a closed square circuit of four exact +90-degree turns that
          returns to its start pose — the strongest self-check synthetic
          ground truth allows; ``self.loop_frame`` is the frame index where
          the ground-truth pose closes the loop).
        photometric: per-frame exposure drift (+-12% gain, +-8 DN bias over
          ~40-frame periods), a 2% left/right gain mismatch, and a static
          25% corner vignette — violations of LK's brightness-constancy
          assumption in the shapes real sensors produce.
        noise_sigma: additive Gaussian sensor noise (DN), fresh per frame.
        occluders: textured pillars beside the path that sweep across the
          image during passage, occluding and disoccluding the corridor.
        lowtex_span: (lo, hi) arc-length interval (m) where wall texture
          contrast collapses to 18% — a feature-starvation stretch.
        """
        self.K = intrinsics
        self.num_frames = num_frames
        self.speed = speed
        self.photometric = photometric
        self.noise_sigma = noise_sigma
        self._seed = seed
        rng = np.random.default_rng(seed)

        # Ground-truth trajectory: forward along +z.
        # Extrapolate past the course end so the corridor keeps going.
        extra = int(np.ceil(self.OVERRUN / max(speed, 1e-6)))
        if course == "loop":
            # The corridor wraps around onto its own start; no overrun needed
            # (and an overrun straight would drive walls through the loop's
            # interior).
            extra = 0
            self.loop_frame = self._loop_schedule(num_frames)[2]
        n_all = num_frames + extra
        all_poses = np.zeros((n_all, 4, 4))
        T = np.eye(4)
        for i in range(n_all):
            all_poses[i] = T
            if course == "turning":
                yaw = self._turning_yaw_rate(i, num_frames)
                pitch = 0.0025 * np.sin(i * 0.37)   # road vibration
            elif course == "long":
                yaw = self._long_yaw_rate(i, num_frames)
                pitch = 0.0025 * np.sin(i * 0.37)
            elif course == "loop":
                yaw = self._loop_yaw_rate(i, num_frames)
                pitch = 0.0015 * np.sin(i * 0.37)
            elif course == "gatespike":
                # Straight corridor with a 3-frame yaw spike of 0.15
                # rad/frame at mid-course — beyond the reference's 0.1 rad
                # rejection gate (src/main.cpp:201-208). The CORRECT
                # behavior is to reject exactly those frames (skip pose
                # integration, keep tracking) and re-acquire afterwards.
                mid = num_frames // 2
                spike = mid <= i < mid + 3
                yaw = 0.15 if spike else yaw_rate
                pitch = 0.0
            else:
                yaw = yaw_rate * (1.0 + 0.3 * np.sin(i * 0.21))
                pitch = 0.0
            cy_, sy_ = np.cos(yaw), np.sin(yaw)
            R_step = np.array([[cy_, 0, sy_], [0, 1, 0], [-sy_, 0, cy_]])
            if pitch != 0.0:
                cp, sp = np.cos(pitch), np.sin(pitch)
                R_pitch = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
                R_step = R_step @ R_pitch
            step = np.eye(4)
            step[:3, :3] = R_step
            step[:3, 3] = [0.02 * np.sin(i * 0.13), 0.0, speed]
            T = T @ step
        self.poses = all_poses[:num_frames]

        # Angular-resolution normalization: texture detail sized so a
        # 718.856-focal-length camera sees ~1 px texels where intended.
        ts = 718.856 / max(intrinsics.fx, 1e-6)

        if texture_family not in _TEXTURE_FAMILIES:
            raise ValueError(f"texture_family must be one of "
                             f"{sorted(_TEXTURE_FAMILIES)}, "
                             f"got {texture_family!r}")
        _gen = _TEXTURE_FAMILIES[texture_family]
        ground_tex = _gen(768, 768, rng)
        wall_texs = [_gen(640, 640, rng) for _ in range(4)]
        backdrop_tex = _gen(768, 768, rng)
        # Low-texture variants: contrast collapsed to 18% around mid-gray —
        # local gradients drop below the FAST threshold over most of the
        # wall, starving the detector through the lowtex_span stretch.
        lowtex_walls = [128.0 + 0.18 * (t - 128.0) for t in wall_texs]

        # Static 25% corner vignette (photometric mode): radial gain
        # applied to both cameras.
        H, W = intrinsics.height, intrinsics.width
        if H and W:
            vy = (np.arange(H) - H / 2.0) / (H / 2.0)
            vx = (np.arange(W) - W / 2.0) / (W / 2.0)
            r2 = vy[:, None] ** 2 + vx[None, :] ** 2
            self._vignette = 1.0 - 0.25 * (r2 / 2.0)
        else:
            self._vignette = None

        if course in ("long", "loop"):
            # These paths range far beyond the fixed 520 m ground square the
            # short courses use: size the ground plane from the actual path
            # bounding box (+60 m margin) instead. The short courses keep
            # the original fixed plane so their round-3-validated renders
            # are bit-identical.
            pos_all = all_poses[:, :3, 3]
            lo = pos_all.min(axis=0) - 60.0
            hi = pos_all.max(axis=0) + 60.0
            ground = _Plane(
                p0=[lo[0], 1.6, lo[2]], e1=[1, 0, 0], e2=[0, 0, 1],
                extent1=hi[0] - lo[0], extent2=hi[2] - lo[2],
                texture=ground_tex, tex_scale=18.0 * ts,
            )
        else:
            ground = _Plane(  # ground: y = +1.6 (camera ~1.6 m above ground)
                p0=[-250, 1.6, -80], e1=[1, 0, 0], e2=[0, 0, 1],
                extent1=520, extent2=520,
                texture=ground_tex, tex_scale=18.0 * ts,
            )
        self.planes = [ground]

        # Corridor walls: segments along the path every SEG_SPACING meters,
        # aligned with the local heading, on both sides.
        k = max(1, int(round(self.SEG_SPACING / max(speed, 1e-6))))
        seg_len = k * speed + 4.0
        for j, i in enumerate(range(0, n_all, k)):
            P = all_poses[min(i, n_all - 1)]
            pos = P[:3, 3]
            h = P[:3, 2] / np.linalg.norm(P[:3, 2])   # heading
            r = P[:3, 0] / np.linalg.norm(P[:3, 0])   # right
            s_arc = i * speed
            in_lowtex = (lowtex_span is not None
                         and lowtex_span[0] <= s_arc < lowtex_span[1])
            texs = lowtex_walls if in_lowtex else wall_texs
            for side, tex in ((-1.0, texs[j % 4]),
                              (1.0, texs[(j + 2) % 4])):
                p0 = pos + side * self.WALL_OFFSET * r - 2.0 * h
                p0 = p0 + np.array([0.0, -9.0, 0.0])  # top 9 m above camera
                self.planes.append(_Plane(
                    p0=p0, e1=h, e2=[0, 1, 0],
                    extent1=seg_len, extent2=10.6,     # down to ground level
                    texture=tex, tex_scale=14.0 * ts,
                    path_s=(s_arc - 4.0, s_arc + seg_len),
                ))

        # Occluding pillars: textured verticals 3.5 m beside the path every
        # ~22 m, alternating sides. Approaching, they occlude corridor
        # texture; during passage they sweep across the image with large
        # parallax, killing their tracks (the closure check must catch the
        # resulting drag-along failures).
        if occluders:
            pk = max(1, int(round(22.0 / max(speed, 1e-6))))
            for j, i in enumerate(range(pk, n_all, pk)):
                P = all_poses[min(i, n_all - 1)]
                pos = P[:3, 3]
                r = P[:3, 0] / np.linalg.norm(P[:3, 0])
                side = -1.0 if j % 2 == 0 else 1.0
                s_arc = i * speed
                p0 = (pos + side * 3.5 * r
                      + np.array([0.0, -6.4, 0.0]))   # top 6.4 m above cam
                self.planes.append(_Plane(
                    p0=p0, e1=side * r, e2=[0, 1, 0],
                    extent1=2.2, extent2=8.0,          # down to ground
                    texture=wall_texs[j % 4], tex_scale=3.0 * ts,
                    path_s=(s_arc - 1.0, s_arc + 1.0),
                ))

        # Far backdrop: perpendicular wall past the course end. A loop's end
        # is its start — a backdrop there would stand 30 m in front of frame
        # 0's camera, on the path; the wrapped corridor already fills the
        # view, so the loop course has none.
        if course == "loop":
            return
        P_end = all_poses[-1]
        pos_e = P_end[:3, 3]
        h_e = P_end[:3, 2] / np.linalg.norm(P_end[:3, 2])
        r_e = P_end[:3, 0] / np.linalg.norm(P_end[:3, 0])
        center = pos_e + 30.0 * h_e
        self.planes.append(_Plane(
            p0=center - 180.0 * r_e + np.array([0.0, -50.0, 0.0]),
            e1=r_e, e2=[0, 1, 0],
            extent1=360.0, extent2=51.6,
            texture=backdrop_tex, tex_scale=40.0 * ts,
        ))

    @staticmethod
    def _turning_yaw_rate(i: int, n: int) -> float:
        """Per-frame yaw (rad) for the "turning" course: two KITTI-style
        intersection turns, sin^2-ramped, scaled to the course length.

        Episode 1 (frames 0.27n..0.55n): +90 degrees total, peak 0.070
        rad/frame. Episode 2 (0.62n..0.80n): about -68 degrees, peak 0.082
        rad/frame — deliberately approaching (but staying under) the
        reference's 0.1 rad per-frame rejection gate
        (src/main.cpp:201-208)."""
        base = 0.004 * (1.0 + 0.3 * np.sin(i * 0.21))
        for lo, hi, peak in ((0.27, 0.55, 0.070), (0.62, 0.80, -0.082)):
            a, b = lo * n, hi * n
            if a <= i < b:
                t = (i - a) / (b - a)
                return base + peak * np.sin(np.pi * t) ** 2
        return base

    #: frames per exact-90-degree turn. sin^2 profile -> peak per-frame yaw
    #: pi/TURN_FRAMES = 0.0952 rad, deliberately just under the reference's
    #: 0.1 rad rejection gate (src/main.cpp:201-208).
    TURN_FRAMES = 33

    @classmethod
    def _turn_step(cls, t_idx: int, sign: float) -> float:
        """Per-frame yaw inside a turn: sin^2-ramped and EXACT — the T
        half-sample-offset sin^2 values sum to exactly T/2, so each turn
        integrates to precisely sign * pi/2 (what makes the loop course
        close and the long course's snake lattice stay parallel)."""
        T = cls.TURN_FRAMES
        return sign * (np.pi / 2.0) * (2.0 / T) * (
            np.sin(np.pi * (t_idx + 0.5) / T) ** 2)

    @classmethod
    def _long_yaw_rate(cls, i: int, n: int) -> float:
        """"long" course: alternating exact +-90-degree turns between long
        straights — a snake that never self-intersects (parallel legs sit
        ~a full straight apart, far beyond the 2 x 16 m corridor width), so
        arbitrarily long courses stay fair. Straights carry a small
        zero-mean yaw wander (unlike the straight course's biased 0.004
        arc, which would curl a km-scale path onto itself)."""
        gap = max(120, n // 9)          # frames between turn starts
        t_idx = i % gap
        turn_no = i // gap
        if turn_no >= 1 and t_idx < cls.TURN_FRAMES:
            sign = 1.0 if turn_no % 2 == 1 else -1.0
            return cls._turn_step(t_idx, sign)
        return 0.002 * np.sin(i * 0.21)

    @classmethod
    def _loop_schedule(cls, n: int) -> tuple[int, int, int]:
        """(straight_frames, turn_frames, loop_frame) for an n-frame loop:
        four (straight + exact 90-degree turn) units; the ground-truth pose
        returns to the start at frame 4 * (S + T)."""
        T = cls.TURN_FRAMES
        S = (n - 1) // 4 - T            # closure frame must exist: <= n-1
        if S < 4:
            raise ValueError(
                f"loop course needs >= {4 * (T + 4) + 1} frames (got {n})")
        return S, T, 4 * (S + T)

    @classmethod
    def _loop_yaw_rate(cls, i: int, n: int) -> float:
        """"loop" course: four straight+turn units of exact +90 degrees.
        Up to the small lateral wobble, the four 90-degree-rotated copies of
        one unit's displacement sum to zero, so the ground-truth pose at
        ``loop_frame`` coincides with the start pose — end-to-end loop
        closure becomes a direct self-check of the whole pipeline."""
        S, T, close = cls._loop_schedule(n)
        if i >= close:
            return 0.0                   # past closure: continue straight
        t_idx = i % (S + T)
        if t_idx >= S:
            return cls._turn_step(t_idx - S, 1.0)
        return 0.0

    def _apply_photometric(self, img: np.ndarray, i: int,
                           right: bool) -> np.ndarray:
        """Exposure drift + L/R gain mismatch + vignette + sensor noise,
        applied to the clean render (float in, float out)."""
        out = img.astype(np.float64)
        if self.photometric:
            gain = 1.0 + 0.12 * np.sin(2.0 * np.pi * i / 43.0)
            bias = 8.0 * np.sin(2.0 * np.pi * i / 31.0 + 1.0)
            if right:
                gain *= 1.02
            out = out * gain + bias
            if self._vignette is not None:
                out = out * self._vignette
        if self.noise_sigma > 0.0:
            nrng = np.random.default_rng(
                (self._seed * 1_000_003 + i * 2 + int(right)) & 0x7FFFFFFF)
            out = out + nrng.normal(0.0, self.noise_sigma, out.shape)
        return out

    def _visible_planes(self, frame_idx: int):
        """Cull corridor segments far behind/ahead of the camera (render-time
        optimization only; does not change what the camera can see)."""
        s = frame_idx * self.speed
        out = []
        for pl in self.planes:
            if pl.path_s is None:
                out.append(pl)
            else:
                lo, hi = pl.path_s
                if hi >= s - 6.0 and lo <= s + 320.0:
                    out.append(pl)
        return out

    def _render(self, T_w_cam: np.ndarray, right: bool,
                frame_idx: int | None = None) -> np.ndarray:
        K = self.K
        H, W = K.height, K.width
        # Right camera sits +baseline along the left camera's x axis.
        T = T_w_cam.copy()
        if right:
            T = T @ np.array(
                [[1, 0, 0, K.baseline], [0, 1, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1.0]]
            )
        R_wc = T[:3, :3]
        origin = T[:3, 3]

        us, vs = np.meshgrid(np.arange(W, dtype=np.float64),
                             np.arange(H, dtype=np.float64))
        d_cam = np.stack(
            [(us - K.cx) / K.fx, (vs - K.cy) / K.fy, np.ones_like(us)], axis=-1
        )
        d_world = d_cam @ R_wc.T  # (H, W, 3)

        planes = (self.planes if frame_idx is None
                  else self._visible_planes(frame_idx))
        img = np.full((H, W), 40.0)
        zbuf = np.full((H, W), np.inf)
        R_cw = R_wc.T  # world -> camera
        for pl in planes:
            # Conservative screen-space bounding box from the plane's four
            # corners (render-time culling only). If any corner is at or
            # behind the camera plane the box is the full image.
            corners = np.stack([
                pl.p0,
                pl.p0 + pl.extent1 * pl.e1,
                pl.p0 + pl.extent2 * pl.e2,
                pl.p0 + pl.extent1 * pl.e1 + pl.extent2 * pl.e2,
            ])
            cc = (corners - origin) @ R_cw.T  # camera frame
            if np.all(cc[:, 2] <= 0.1):
                continue  # entirely behind the camera
            if np.any(cc[:, 2] <= 0.1):
                y0i, y1i, x0i, x1i = 0, H, 0, W
            else:
                u = cc[:, 0] / cc[:, 2] * K.fx + K.cx
                v = cc[:, 1] / cc[:, 2] * K.fy + K.cy
                x0i = max(0, int(np.floor(u.min())) - 1)
                x1i = min(W, int(np.ceil(u.max())) + 2)
                y0i = max(0, int(np.floor(v.min())) - 1)
                y1i = min(H, int(np.ceil(v.max())) + 2)
                if x0i >= x1i or y0i >= y1i:
                    continue
            dw = d_world[y0i:y1i, x0i:x1i]
            denom = dw @ pl.n
            denom = np.where(np.abs(denom) < 1e-12, 1e-12, denom)
            t = ((pl.p0 - origin) @ pl.n) / denom
            hit = origin[None, None] + t[..., None] * dw
            rel = hit - pl.p0
            a = rel @ pl.e1
            b = rel @ pl.e2
            zb = zbuf[y0i:y1i, x0i:x1i]
            ok = (
                (t > 0.1) & (t < zb)
                & (a >= 0) & (a < pl.extent1) & (b >= 0) & (b < pl.extent2)
            )
            if not ok.any():
                continue
            vals = pl.sample(np.where(ok, a, 0.0), np.where(ok, b, 0.0))
            img[y0i:y1i, x0i:x1i] = np.where(ok, vals, img[y0i:y1i, x0i:x1i])
            zbuf[y0i:y1i, x0i:x1i] = np.where(ok, t, zb)
        return np.clip(img, 0, 255).astype(np.uint8)

    def frame(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        T = self.poses[i]
        left = self._render(T, right=False, frame_idx=i)
        right = self._render(T, right=True, frame_idx=i)
        if self.photometric or self.noise_sigma > 0.0:
            left = np.clip(self._apply_photometric(left, i, False),
                           0, 255).astype(np.uint8)
            right = np.clip(self._apply_photometric(right, i, True),
                            0, 255).astype(np.uint8)
        return left, right

    def __len__(self):
        return self.num_frames

    def __iter__(self):
        for i in range(self.num_frames):
            yield self.frame(i)


#: Gauntlet course registry (VERDICT.md round-2 missing #1): the bench and
#: e2e tests gate accuracy on MULTIPLE courses, not just the gentle straight
#: corridor the tracker was tuned on.
COURSES = ("straight", "turning", "stress", "gatespike", "long", "loop")


def make_course(name: str, intrinsics: CameraIntrinsics, num_frames: int,
                seed: int = 0, speed: float = 0.8,
                texture_family: str = "value") -> SyntheticStereoSequence:
    """Named adversarial courses for the accuracy gauntlet.

    ``texture_family``: "value" (default, the 8-octave value-noise renders
    every round's artifacts use) or "checker" (periodic checker +
    interference gratings + sparse blobs — the spectrally-disjoint family
    for the level-skip ablation, VERDICT r4 next-step #9).

    - "straight": the round-2 gentle corridor (baseline).
    - "turning": two near-gate 90-degree intersection turns + road pitch
      vibration (geometry stress only).
    - "stress": the turning geometry PLUS exposure drift, L/R gain
      mismatch, vignette, sensor noise, occluding pillars, and a
      low-texture stretch over the middle third of the course.
    - "gatespike": straight corridor with a 3-frame 0.15 rad/frame yaw
      spike at mid-course — frames the 0.1 rad gate must REJECT
      (reference src/main.cpp:201-208); exercises rejection + recovery,
      not trajectory accuracy (the skipped motion is unrecoverable by
      design, for the reference too).
    - "long": the endurance snake (alternating exact 90-degree turns,
      non-self-intersecting) at 1.25 m/frame, so >= 800 m — every devkit
      segment-length bucket (reference evaluate_odometry.cpp:12-15) —
      takes ~650 frames and a 1,000+ frame soak covers ~1.3 km.
    - "loop": closed square circuit returning exactly to the start pose
      (``seq.loop_frame``); end-to-end loop-closure error is the strongest
      self-check synthetic ground truth allows.
    """
    import functools

    _Seq = functools.partial(SyntheticStereoSequence,
                             texture_family=texture_family)

    if name == "long":
        return _Seq(
            intrinsics, num_frames=num_frames, seed=seed, speed=1.25,
            course="long")
    if name == "loop":
        return _Seq(
            intrinsics, num_frames=num_frames, seed=seed, speed=speed,
            course="loop")
    if name == "straight":
        return _Seq(
            intrinsics, num_frames=num_frames, seed=seed, speed=speed)
    if name == "turning":
        return _Seq(
            intrinsics, num_frames=num_frames, seed=seed, speed=speed,
            course="turning")
    if name == "gatespike":
        return _Seq(
            intrinsics, num_frames=num_frames, seed=seed, speed=speed,
            course="gatespike")
    if name == "stress":
        total = num_frames * speed
        return _Seq(
            intrinsics, num_frames=num_frames, seed=seed, speed=speed,
            course="turning", photometric=True, noise_sigma=2.0,
            occluders=True, lowtex_span=(0.40 * total, 0.55 * total))
    raise ValueError(f"unknown course {name!r}; one of {COURSES}")
