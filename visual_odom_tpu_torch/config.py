"""Configuration for the stereo VO pipeline (PyTorch/CUDA port).

A copy of ``visual_odom_tpu/config.py`` without the LK backend switch: in
the port the tensors' device chooses, the CUDA kernel for CUDA tensors and
its plain PyTorch version for CPU tensors.

All numeric defaults reproduce the reference's hard-coded constants exactly
(see SURVEY.md fidelity ledger):

- FAST threshold 20, nonmax suppression (reference src/feature.cpp:43-45)
- LK window 21x21, 3 pyramid levels, <=30 iterations, eps 0.01,
  minEigThreshold 0.001 (reference src/feature.cpp:127-139)
- replenish below 2000 features (reference src/visualOdometry.cpp:95)
- bucket size rows/10, 1 feature/bucket, age cap 10
  (reference src/visualOdometry.cpp:106-108, src/bucket.cpp:16)
- circular-match closure threshold 0 px Chebyshev
  (reference src/visualOdometry.cpp:120)
- PnP-RANSAC: 500 iterations, 0.5 px reprojection, confidence 0.999,
  warm start (reference src/visualOdometry.cpp:168-172)
- gates: |euler| < 0.1 rad (reference src/main.cpp:201), translation scale
  in (0.05, 10) (reference src/utils.cpp:80)

Calibration is read from the same OpenCV-YAML schema as the reference
(`Camera.fx/fy/cx/cy/bf`, reference src/main.cpp:64-76).
"""

from __future__ import annotations

import dataclasses
import re


@dataclasses.dataclass(frozen=True)
class CameraIntrinsics:
    """Stereo pinhole calibration, matching reference src/main.cpp:64-76.

    ``bf`` is the value stored in the calibration YAML: it lands in
    P_right[0, 3], i.e. bf = -fx * baseline (kitti00: bf = -386.1448 ->
    baseline 0.537 m, calibration/kitti00.yaml:14).
    """

    fx: float
    fy: float
    cx: float
    cy: float
    bf: float
    width: int = 0
    height: int = 0

    @property
    def baseline(self) -> float:
        """Stereo baseline in meters (positive)."""
        return -self.bf / self.fx

    def proj_left(self):
        """3x4 left projection matrix (reference src/main.cpp:73)."""
        import numpy as np

        return np.array(
            [
                [self.fx, 0.0, self.cx, 0.0],
                [0.0, self.fy, self.cy, 0.0],
                [0.0, 0.0, 1.0, 0.0],
            ],
            dtype=np.float32,
        )

    def proj_right(self):
        """3x4 right projection matrix (reference src/main.cpp:74)."""
        import numpy as np

        P = self.proj_left()
        P[0, 3] = self.bf
        return P

    def intrinsic_matrix(self):
        """3x3 K matrix (reference src/visualOdometry.cpp:163-165)."""
        import numpy as np

        return np.array(
            [
                [self.fx, 0.0, self.cx],
                [0.0, self.fy, self.cy],
                [0.0, 0.0, 1.0],
            ],
            dtype=np.float32,
        )


# Values an OpenCV FileStorage YAML may contain that we care about.
_CALIB_KEYS = ("Camera.fx", "Camera.fy", "Camera.cx", "Camera.cy", "Camera.bf",
               "Camera.width", "Camera.height", "Camera.fps", "ThDepth")


def load_calibration(path: str) -> CameraIntrinsics:
    """Parse an OpenCV FileStorage calibration YAML.

    Accepts the reference's calibration files verbatim
    (calibration/{kitti00,zed,rgbd}.yaml) without depending on OpenCV: the
    files are flat `key: value` documents with an optional `%YAML:1.0` header
    that stock YAML parsers reject.
    """
    values = {}
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            m = re.match(r"^([A-Za-z._0-9]+)\s*:\s*(-?[0-9.eE+-]+)\s*$", line)
            if m:
                values[m.group(1)] = float(m.group(2))
    try:
        return CameraIntrinsics(
            fx=values["Camera.fx"],
            fy=values["Camera.fy"],
            cx=values["Camera.cx"],
            cy=values["Camera.cy"],
            bf=values["Camera.bf"],
            width=int(values.get("Camera.width", 0)),
            height=int(values.get("Camera.height", 0)),
        )
    except KeyError as e:
        raise ValueError(f"calibration file {path} missing key {e}") from e


@dataclasses.dataclass(frozen=True)
class VOConfig:
    """Static pipeline configuration. Every shape of the per-frame step is
    derived from here and fixed for a run."""

    # --- image geometry (static; required for fixed shapes) ---
    height: int = 376
    width: int = 1241

    # --- detection ---
    # "fast" = FAST-9/16 (the reference's main path, src/feature.cpp:43-45);
    # "shi-tomasi" = goodFeaturesToTrack min-eigenvalue detector (the
    # reference's alternative API surface, src/feature.cpp:49-62).
    detector: str = "fast"
    fast_threshold: int = 20
    fast_nonmax: bool = True
    shi_tomasi_quality: float = 0.01   # reference src/feature.cpp:55
    shi_tomasi_min_distance: float = 5.0  # reference src/feature.cpp:56

    # --- bucketing (reference src/visualOdometry.cpp:106-108) ---
    bucket_rows: int = 10          # bucket_size = height // bucket_rows
    features_per_bucket: int = 1
    age_threshold: int = 10        # reference src/bucket.cpp:16

    # --- replenish policy (reference src/visualOdometry.cpp:95) ---
    replenish_below: int = 2000

    # --- LK tracker (reference src/feature.cpp:127-139) ---
    lk_window: int = 21
    lk_levels: int = 3             # maxLevel=3 -> 4 pyramid levels 0..3
    lk_max_iters: int = 30
    lk_eps: float = 0.01
    lk_min_eig_threshold: float = 0.001

    # --- circular matching closure (reference src/visualOdometry.cpp:120) ---
    circle_threshold: float = 0.0

    # --- PnP-RANSAC (reference src/visualOdometry.cpp:168-172) ---
    ransac_iterations: int = 500
    ransac_reproj_threshold: float = 0.5
    ransac_confidence: float = 0.999
    ransac_sample_size: int = 6
    # Damped-GN steps per RANSAC hypothesis (the final polish runs 2x this
    # on the inlier set). Minimal 6-point solves converge by ~5 steps; on
    # the JAX package's 161-frame bench, 6 vs 10 is ATE-identical (0.1774
    # vs 0.1780 m).
    pnp_refine_iters: int = 6
    use_extrinsic_guess: bool = True
    mono_rotation: bool = False    # reference src/main.cpp:181 passes false

    # --- gating + integration (src/main.cpp:201, src/utils.cpp:80) ---
    max_rotation_rad: float = 0.1
    min_scale: float = 0.05
    max_scale: float = 10.0
    # Beyond-reference failure detection: also require >= this many PnP
    # inliers to accept a frame. The reference's gates (rotation + scale)
    # are blind to scene cuts / total tracking loss — a teleport can
    # produce a small-motion consensus of ~nothing that passes both
    # (measured in the round-4 multi-lap soak; the reference would accept
    # it too). Default -1 = AUTO: padded_features // 16, floored at 8 —
    # 24 at KITTI scale, inside the floor band the round-5 sweep measured
    # as FREE (INLIER_FLOOR_r05.json: floors {10,20,30} leave every healthy
    # gauntlet course bit-identical — the weakest accepted frame carries
    # 89+ inliers — while rejecting the scene-cut seam (2 inliers) and the
    # gatespike's 0-inlier junk accepts). The floor scales with the feature
    # budget because expected inlier counts do (reduced-resolution test
    # cameras track ~a quarter the features). 0 = reference semantics
    # (opt out via --min-accept-inliers 0).
    min_accept_inliers: int = -1

    # --- capacity knobs (no reference counterpart: fixed-shape design) ---
    # Max tracked features through LK = padded bucket-cell count.
    # Computed from the grid; this is an upper bound for padding.
    feature_capacity: int = 512

    # --- precision ---
    compute_dtype: str = "float32"

    # --- motion-prior LK seeding (beyond-reference): start each LK leg
    # from the feature's previous flow/disparity instead of the identity.
    # Same converged minima, roughly half the solver iterations; the
    # circular-closure check still validates every track. ---
    predictive_seeding: bool = True
    # Coarse pyramid levels to SKIP when seeding is on: the priors already
    # absorb the large displacement the coarse levels exist for, so the
    # refinement starts at level (lk_levels - lk_seed_skip_levels). Tracks
    # whose prior was wrong fail the closure check and are replenished.
    # 0 = all levels (the reference's behavior).
    #
    # Default 1, settled by the JAX package's texture ablation
    # (TEXTURE_ABLATION_r05.json): skip=2 is accuracy-green on every
    # value-noise gauntlet course but FAILS catastrophically on the
    # periodic "checker" family (ATE 13-15 m vs a 1.28 m budget —
    # lattice-aliased matches shift all four circular legs by the same
    # period, so the closure check cannot catch them and PnP locks a
    # coherent wrong pose). skip=1 is green on BOTH families.
    lk_seed_skip_levels: int = 1
    # --- self-verifying adaptive skip (beyond-reference) ---
    # "adaptive": every frame runs the FAST quad (lk_fast_skip_levels
    # coarse levels skipped) plus a compact 64-feature PROBE tracked at the
    # safe skip level; where the two disagree (> lk_probe_px on >
    # lk_probe_disagree_frac of comparable probe tracks — the lattice-
    # aliasing signature TEXTURE_ABLATION_r05.json measured), the frame
    # falls back to a full safe-level re-track, chosen on the device
    # (frontend/matching.skip_mode_match). Fast on natural content,
    # safe-quality on adversarial-periodic content, zero host involvement.
    # "fixed" = always lk_seed_skip_levels.
    #
    # Default "adaptive": in the JAX package's ablation the checker-family
    # courses stay green at safe-level quality (ATE 0.83/0.12 m vs the
    # unguarded fast mode's 13-15 m).
    lk_skip_mode: str = "adaptive"
    lk_fast_skip_levels: int = 2
    lk_probe_px: float = 0.3
    lk_probe_disagree_frac: float = 0.05

    def __post_init__(self):
        if self.detector not in ("fast", "shi-tomasi"):
            raise ValueError(
                f"detector must be 'fast' or 'shi-tomasi', got "
                f"{self.detector!r}")
        if not 0 <= self.lk_seed_skip_levels <= self.lk_levels:
            # skip > levels would make seed_start_level negative: the level
            # loop becomes empty and every track silently "converges" at its
            # scaled seed (ADVICE r4) — reject the config instead.
            raise ValueError(
                f"lk_seed_skip_levels must be in [0, lk_levels="
                f"{self.lk_levels}], got {self.lk_seed_skip_levels}")
        if self.lk_skip_mode not in ("fixed", "adaptive"):
            raise ValueError(f"lk_skip_mode must be 'fixed' or 'adaptive', "
                             f"got {self.lk_skip_mode!r}")
        if not 0 <= self.lk_fast_skip_levels <= self.lk_levels:
            raise ValueError(
                f"lk_fast_skip_levels must be in [0, lk_levels="
                f"{self.lk_levels}], got {self.lk_fast_skip_levels}")

    # ------------------------------------------------------------------
    @property
    def bucket_size(self) -> int:
        """Bucket edge in pixels (reference src/visualOdometry.cpp:106)."""
        return max(1, self.height // self.bucket_rows)

    @property
    def grid_h(self) -> int:
        """Number of bucket rows. Reference allocates an aliased extra
        row/col (src/feature.cpp:221-227, a known bug); we use the exact
        grid (SURVEY.md fidelity ledger: deliberately fixed)."""
        return self.height // self.bucket_size

    @property
    def grid_w(self) -> int:
        return self.width // self.bucket_size

    @property
    def num_buckets(self) -> int:
        return self.grid_h * self.grid_w

    @property
    def padded_features(self) -> int:
        """Feature-axis padding: smallest multiple of 128 holding every
        bucket cell (kept as in the JAX package, so slot layouts match)."""
        n = self.num_buckets * self.features_per_bucket
        return max(128, -(-n // 128) * 128)

    def resolved_min_accept_inliers(self) -> int:
        """The effective inlier floor (min_accept_inliers docstring):
        explicit value, or the feature-budget-scaled auto default."""
        if self.min_accept_inliers >= 0:
            return self.min_accept_inliers
        return max(8, self.padded_features // 16)

    def validate(self) -> "VOConfig":
        if self.padded_features > self.feature_capacity:
            object.__setattr__(self, "feature_capacity", self.padded_features)
        return self

    @classmethod
    def for_image(cls, height: int, width: int, **kw) -> "VOConfig":
        cfg = cls(height=height, width=width, **kw)
        if cfg.padded_features > cfg.feature_capacity:
            cfg = dataclasses.replace(cfg, feature_capacity=cfg.padded_features)
        return cfg


# Named configurations mirroring the reference's calibration files.
KITTI00 = CameraIntrinsics(fx=718.856, fy=718.856, cx=607.1928, cy=185.2157,
                           bf=-386.1448, width=1241, height=376)
