"""PyTorch port vs the JAX package: detection + bucketing, circular match
and the adaptive skip policy (JAX side on the CPU, XLA LK backend)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from visual_odom_tpu.config import VOConfig as JVOConfig
from visual_odom_tpu.frontend.bucketing import detect_and_bucket as jax_bucket
from visual_odom_tpu.frontend.featureset import FeatureState as JFeatureState
from visual_odom_tpu.frontend.matching import circular_match as jax_circular
from visual_odom_tpu.frontend.matching import skip_mode_match as jax_skip
from visual_odom_tpu.ops.lk import LKParams as JLKParams
from visual_odom_tpu.ops.lk import prepare_lk_image as jax_prepare
from visual_odom_tpu_torch.config import CameraIntrinsics, VOConfig
from visual_odom_tpu_torch.frontend.bucketing import detect_and_bucket
from visual_odom_tpu_torch.frontend.featureset import FeatureState
from visual_odom_tpu_torch.frontend.matching import (circular_match,
                                                     skip_mode_match)
from visual_odom_tpu_torch.io.synthetic import SyntheticStereoSequence
from visual_odom_tpu_torch.ops.lk import LKImage, LKParams

# Small tensors: one intra-op thread each keeps the parallel test workers
# from oversubscribing the cores.
torch.set_num_threads(1)

H, W = 120, 160
#: |delta| bound on matched positions and carried priors
PT_TOL = 1e-3
PRIOR_TOL = 1e-5


@pytest.fixture(scope="module")
def frames():
    intr = CameraIntrinsics(fx=120.0, fy=120.0, cx=W / 2, cy=H / 2,
                            bf=-120.0 * 0.54, width=W, height=H)
    seq = SyntheticStereoSequence(intr, num_frames=3, seed=0, speed=0.5)
    return [seq.frame(i) for i in range(3)]


def _random_state(P, seed, n_live=120):
    """A FeatureState with live tracked features at random positions, ages,
    ids and motion priors (numpy, from a seed)."""
    rng = np.random.default_rng(seed)
    valid = np.zeros(P, bool)
    valid[rng.choice(P, n_live, replace=False)] = True
    return dict(
        points=np.stack([rng.uniform(-3, W + 3, P), rng.uniform(-3, H + 3, P)],
                        axis=1).astype(np.float32),
        ages=rng.integers(0, 14, P).astype(np.int32),
        valid=valid,
        ids=np.where(valid, rng.integers(0, 5000, P), -1).astype(np.int32),
        next_id=np.int32(7000),
        flow=rng.uniform(-3, 3, (P, 2)).astype(np.float32),
        disp=rng.uniform(-8, 0, (P, 2)).astype(np.float32))


def _jax_state(d):
    return JFeatureState(**{k: jnp.asarray(v) for k, v in d.items()})


def _port_state(d):
    return FeatureState(**{k: torch.tensor(np.asarray(v)) for k, v in d.items()})


@pytest.mark.parametrize("case", ["empty", "tracked", "tracked_k2",
                                  "no_replenish"])
def test_detect_and_bucket_matches_jax(frames, case):
    kw = {"features_per_bucket": 2} if case == "tracked_k2" else {}
    if case == "no_replenish":
        kw["replenish_below"] = 50
    jcfg = JVOConfig.for_image(H, W, **kw)
    cfg = VOConfig.for_image(H, W, **kw)
    P = cfg.padded_features
    d = _random_state(P, seed=1, n_live=0 if case == "empty" else 120)
    img = frames[0][0].astype(np.float32)
    ref = jax_bucket(jnp.asarray(img), _jax_state(d), jcfg)
    got = detect_and_bucket(torch.from_numpy(img), _port_state(d), cfg)
    for name in ("points", "ages", "valid", "ids", "next_id"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)), name)
    for name in ("flow", "disp"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   atol=PRIOR_TOL, err_msg=name)
    assert got.valid.sum() > 30


def _images(frames):
    """(jax, port) prepared images in quad order l0, r0, l1, r1, on the
    same planes."""
    jimgs = [jax_prepare(jnp.asarray(x, jnp.float32), JLKParams())
             for x in (frames[0][0], frames[0][1], frames[1][0], frames[1][1])]
    pimgs = [LKImage(tuple(torch.tensor(np.asarray(p)) for p in im.pyramid),
                     im.shapes, im.pad) for im in jimgs]
    return jimgs, pimgs


@pytest.fixture(scope="module")
def bucketed(frames):
    """Fresh bucketed features of frame 0 with a plausible stereo prior."""
    cfg = JVOConfig.for_image(H, W)
    d = _random_state(cfg.padded_features, seed=2, n_live=0)
    st = jax_bucket(jnp.asarray(frames[0][0], jnp.float32), _jax_state(d), cfg)
    out = {k: np.asarray(v) for k, v in st._asdict().items()}
    out["disp"] = np.where(out["valid"][:, None], np.float32([-6.0, 0.0]),
                           0.0).astype(np.float32)
    out["flow"] = np.where(out["valid"][:, None], np.float32([0.3, 0.2]),
                           0.0).astype(np.float32)
    return out


def _assert_match_close(got, ref):
    v = np.asarray(ref.valid)
    got_v = got.valid.numpy()
    assert (got_v != v).sum() <= 1
    assert v.sum() > 30
    both = v & got_v
    for name in ("points_r0", "points_r1", "points_l1", "points_l0_return"):
        d = np.abs(getattr(got, name).numpy() - np.asarray(getattr(ref, name)))
        assert d[both].max() < PT_TOL, name
    np.testing.assert_array_equal(got.ages.numpy(), np.asarray(ref.ages))


@pytest.mark.parametrize("start_level", [1, 2])
def test_circular_match_matches_jax(frames, bucketed, start_level):
    jimgs, pimgs = _images(frames)
    ref = jax_circular(*jimgs, _jax_state(bucketed), JLKParams(), 0.0, "xla",
                       seeding=True, seed_start_level=start_level)
    got = circular_match(*pimgs, _port_state(bucketed), LKParams(), 0.0,
                         seeding=True, seed_start_level=start_level)
    _assert_match_close(got, ref)


@pytest.mark.parametrize("branch,probe_px", [("fast", 1e6), ("safe", -1.0)])
def test_skip_mode_match_both_branches(frames, bucketed, branch, probe_px):
    """lk_probe_px at its extremes forces each side of the adaptive choice;
    the port picks it on the device and reports it as ``fallback``."""
    jimgs, pimgs = _images(frames)
    jcfg = JVOConfig.for_image(H, W, lk_probe_px=probe_px)
    cfg = VOConfig.for_image(H, W, lk_probe_px=probe_px)
    ref = jax_skip(*jimgs, _jax_state(bucketed), JLKParams(), jcfg, "xla")
    got, fallback = skip_mode_match(*pimgs, _port_state(bucketed), LKParams(),
                                    cfg)
    assert bool(fallback) == (branch == "safe")
    _assert_match_close(got, ref)
