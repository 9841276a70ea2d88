"""The port's Shi-Tomasi detector against the JAX package: ``_sep_filter2``,
``shi_tomasi_score_map``, ``shi_tomasi_corner_map``,
``good_features_to_track`` and ``fast_corners`` (compared as sets of
(x, y, score): top-k on CUDA does not promise the lowest index first among
ties), ``detect_and_bucket`` with ``detector="shi-tomasi"`` slot by slot,
single and batched, and the sequence through ``run_sequence_scan``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_odom_tpu.config import VOConfig as JVOConfig
from visual_odom_tpu.eval.kitti_eval import ate_rmse
from visual_odom_tpu.frontend.bucketing import detect_and_bucket as jax_bucket
from visual_odom_tpu.frontend.featureset import empty_feature_state as jax_empty
from visual_odom_tpu.ops import fast as jfast
from visual_odom_tpu.ops.pyramid import _sep_filter2 as jax_sep_filter2
from visual_odom_tpu_torch.config import CameraIntrinsics, VOConfig
from visual_odom_tpu_torch.frontend.bucketing import detect_and_bucket
from visual_odom_tpu_torch.frontend.featureset import (FeatureState,
                                                       empty_feature_state)
from visual_odom_tpu_torch.io.synthetic import SyntheticStereoSequence
from visual_odom_tpu_torch.ops import fast, pyramid
from visual_odom_tpu_torch.runner import pipeline

torch.set_num_threads(1)

H, W = 120, 160
INTR = dict(fx=120.0, fy=120.0, cx=W / 2, cy=H / 2, bf=-120.0 * 0.54,
            width=W, height=H)
#: corner-map pixels whose score lies within rounding of the quality
#: threshold (|score - q max| <= GATE_EPS * max) may flip between packages
GATE_EPS = 1e-5


@pytest.fixture(scope="module")
def images():
    """Three frames of the synthetic course and one of smoothed noise."""
    seq = SyntheticStereoSequence(CameraIntrinsics(**INTR), num_frames=3,
                                  seed=0, speed=0.5)
    ims = [seq.frame(i)[0].astype(np.float32) for i in range(3)]
    rng = np.random.default_rng(0)
    noise = rng.uniform(0, 255, (H, W))
    for _ in range(3):
        noise = (noise + np.roll(noise, 1, 0) + np.roll(noise, -1, 0)
                 + np.roll(noise, 1, 1) + np.roll(noise, -1, 1)) / 5.0
    return np.stack(ims + [noise.astype(np.float32)])


@pytest.mark.parametrize("kernels", [
    ((1, 2, 1), (-1, 0, 1)), ((-1, 0, 1), (1, 2, 1)), ((1, 1, 1), (1, 1, 1)),
    ((1, 4, 6, 4, 1), (1, 4, 6, 4, 1))], ids=["sobel_x", "sobel_y", "box3",
                                              "gauss5"])
def test_sep_filter2_matches_jax(images, kernels):
    kr, kc = (np.asarray(k, np.float32) for k in kernels)
    for im in images:
        ref = np.asarray(jax_sep_filter2(jnp.asarray(im), kr, kc))
        got = pyramid._sep_filter2(torch.from_numpy(im), kr, kc).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * np.abs(
            ref).max())
    got = pyramid._sep_filter2(torch.from_numpy(images), kr, kc).numpy()
    assert got.shape == images.shape


def test_score_map_matches_jax(images):
    for im in images:
        ref = np.asarray(jfast.shi_tomasi_score_map(jnp.asarray(im)))
        got = fast.shi_tomasi_score_map(torch.from_numpy(im)).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-3,
                                   atol=1e-3 * np.abs(ref).max())


def _gate_band(score, quality):
    m = score.max()
    return np.abs(score - quality * m) <= GATE_EPS * m


@pytest.mark.parametrize("quality,min_distance", [(0.01, 5.0), (0.05, 3.0)])
def test_corner_map_matches_jax(images, quality, min_distance):
    """The nonzero sets are equal but for pixels inside the quality gate's
    rounding band; where both keep a pixel their scores agree."""
    flips = 0
    for im in images:
        ref = np.asarray(jfast.shi_tomasi_corner_map(
            jnp.asarray(im), quality_level=quality,
            min_distance=min_distance))
        got = fast.shi_tomasi_corner_map(torch.from_numpy(im), quality,
                                         min_distance).numpy()
        differ = (ref > 0) != (got > 0)
        score = np.asarray(jfast.shi_tomasi_score_map(jnp.asarray(im)))
        assert not (differ & ~_gate_band(score, quality)).any()
        flips += int(differ.sum())
        both = (ref > 0) & (got > 0)
        np.testing.assert_allclose(got[both], ref[both], rtol=1e-3)
        assert (ref > 0).sum() > 20
    assert flips <= 2


def test_corner_map_gates_each_image_on_its_own_maximum(images):
    """A batch gives each image's own map: the quality gate divides by that
    image's maximum, not the batch's."""
    batch = images.copy()
    batch[1] *= 0.05                    # a dim frame beside bright ones
    got = fast.shi_tomasi_corner_map(torch.from_numpy(batch)).numpy()
    for b, im in enumerate(batch):
        one = fast.shi_tomasi_corner_map(torch.from_numpy(im)).numpy()
        np.testing.assert_array_equal(got[b], one)
    assert (got[1] > 0).sum() > 20


def _as_set(pts, scores, valid):
    return {(float(x), float(y), float(s))
            for (x, y), s, v in zip(pts, scores, valid) if v}


def test_good_features_to_track_matches_jax(images):
    for im in images:
        ref = jfast.good_features_to_track(jnp.asarray(im), max_corners=500)
        got = fast.good_features_to_track(torch.from_numpy(im),
                                          max_corners=500)
        rs = {(x, y) for x, y, _ in _as_set(*(np.asarray(a) for a in ref))}
        gs = {(x, y) for x, y, _ in _as_set(*(a.numpy() for a in got))}
        score = np.asarray(jfast.shi_tomasi_score_map(jnp.asarray(im)))
        band = _gate_band(score, 0.01)
        assert all(band[int(y), int(x)] for x, y in rs ^ gs)
        s = got[1].numpy()
        assert (np.diff(s) <= 0).all()


@pytest.mark.parametrize("nonmax", [True, False])
def test_fast_corners_matches_jax(images, nonmax):
    for im in images:
        ref = jfast.fast_corners(jnp.asarray(im), nonmax=nonmax,
                                 max_corners=1024)
        got = fast.fast_corners(torch.from_numpy(im), nonmax=nonmax,
                                max_corners=1024)
        rset = _as_set(*(np.asarray(a) for a in ref))
        gset = _as_set(*(a.numpy() for a in got))
        full = int(np.asarray(ref[2]).sum()) == 1024
        if full:
            # the last score's ties may be cut at another index
            last = float(np.asarray(ref[1])[-1])
            rset = {c for c in rset if c[2] > last}
            gset = {c for c in gset if c[2] > last}
        assert rset == gset


def test_fast_corners_is_exported():
    from visual_odom_tpu_torch import ops

    assert ops.fast_corners is fast.fast_corners
    assert "fast_corners" in ops.__all__


def _jax_state(st):
    return {k: np.asarray(v) for k, v in st._asdict().items()}


def test_detect_and_bucket_shi_tomasi_matches_jax(images):
    """Slot by slot from an empty state (fresh corners fill every cell),
    single and as a batch of the four images."""
    jcfg = JVOConfig.for_image(H, W, detector="shi-tomasi")
    cfg = VOConfig.for_image(H, W, detector="shi-tomasi")
    outs = []
    for im in images:
        ref = _jax_state(jax_bucket(jnp.asarray(im),
                                    jax_empty(jcfg.padded_features), jcfg))
        got = detect_and_bucket(torch.from_numpy(im),
                                empty_feature_state(cfg.padded_features),
                                cfg)
        for name in FeatureState._fields:
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          ref[name], err_msg=name)
        outs.append(got)
    st = empty_feature_state(cfg.padded_features, batch=(len(images),))
    got = detect_and_bucket(torch.from_numpy(images), st, cfg)
    for name in FeatureState._fields:
        np.testing.assert_array_equal(
            getattr(got, name).numpy(),
            np.stack([getattr(o, name).numpy() for o in outs]), err_msg=name)


def test_shi_tomasi_detector_tracks_sequence():
    """tests/test_e2e.py::test_shi_tomasi_detector_tracks_sequence through
    the port's ``run_sequence_scan``."""
    intr = CameraIntrinsics(**INTR)
    cfg = VOConfig.for_image(H, W, ransac_iterations=200,
                             detector="shi-tomasi")
    seq = SyntheticStereoSequence(intr, num_frames=10, seed=0, speed=0.5)
    poses, fetched, _, n = pipeline.run_sequence_scan(
        iter(seq), cfg, intr, chunk=9, warmup=False, device="cpu")
    assert n == 9
    assert ate_rmse(seq.poses[:len(poses)], poses) < 0.15
    assert np.mean(fetched.accept) >= 0.8
    assert (fetched.num_matched > 20).all()


def test_unknown_detector_rejected():
    with pytest.raises(ValueError, match="detector"):
        VOConfig.for_image(H, W, detector="orb")
