"""The port's pipelined runner (``parallel/pipe.py``) in the three cases
of tests/test_pipe.py: the default step, ``mono_rotation``, and 376x512.

- On ``devices=["cpu", "cpu"]`` it equals the port's
  ``run_sequence_scan(device="cpu")`` bit for bit in every output field,
  but ``num_bucketed``, which is ``num_matched`` as in the JAX package's
  pipe (``pipe.py:149-150``).
- Against JAX's ``run_sequence_pipelined`` on two of conftest's CPU
  devices, the port fed JAX's RANSAC draws (as tests/test_torch_pipeline.py
  feeds them to one step): the same accept flags and matched counts,
  inlier counts within COUNT_FRAC, every frame's rotation within ROT_TOL,
  and its translation within TRANS_TOL where the two inlier counts agree.
  Where one inlier flips at the reprojection threshold, PnP on ~85
  inliers moves the translation by up to ~5 cm on this course (measured:
  0.054 m, 86 against 85 inliers; the JAX package's own jitted and eager
  steps differ by 1.2 cm on it, tests/test_torch_pipeline.py), so such a
  frame is held to the counts and the rotation.
- ``devices=None`` takes the visible CUDA devices: without two of them
  (here, without any) it raises, as it does given one device.
"""

import jax
import numpy as np
import pytest
import torch

from visual_odom_tpu.config import CameraIntrinsics as JIntrinsics
from visual_odom_tpu.config import VOConfig as JVOConfig
from visual_odom_tpu.parallel.pipe import run_sequence_pipelined as jax_pipe
from visual_odom_tpu_torch.config import CameraIntrinsics, VOConfig
from visual_odom_tpu_torch.io.synthetic import SyntheticStereoSequence
from visual_odom_tpu_torch.parallel import pipe
from visual_odom_tpu_torch.runner import pipeline

torch.set_num_threads(1)

#: tests/test_torch_pipeline.py's step bounds; the essential RANSAC's draw
#: count (backend/essential.py)
COUNT_FRAC, ROT_TOL, TRANS_TOL = 0.03, 2e-3, 2e-2
ESS_ITERS = 200


def _case(name):
    """tests/test_pipe.py's three cases: (intrinsics kwargs, config kwargs,
    frames, chunk)."""
    if name == "real_aspect":
        h, w = 376, 512
        f = 718.856 * w / 1241.0
        intr = dict(fx=f, fy=f, cx=w / 2, cy=h / 2, bf=-f * 0.537, width=w,
                    height=h)
        cfg = dict(ransac_iterations=100)
        n, speed, chunk = 4, 0.8, 4
    else:
        h, w = 120, 160
        intr = dict(fx=120.0, fy=120.0, cx=w / 2, cy=h / 2,
                    bf=-120.0 * 0.54, width=w, height=h)
        cfg = dict(ransac_iterations=100, mono_rotation=name == "mono")
        n, speed, chunk = 6, 0.5, 8
    seq = SyntheticStereoSequence(CameraIntrinsics(**intr), num_frames=n,
                                  seed=0, speed=speed)
    return (h, w), intr, cfg, [seq.frame(i) for i in range(n)], chunk


def _jax_draws(cfg: VOConfig, n_steps: int, seed: int = 0):
    """The uniforms JAX's pipe draws per frame: PnP's from the first split
    of the key, the essential RANSAC's from a second (pipe.py:106-132)."""
    key, draws = jax.random.PRNGKey(seed), []
    for _ in range(n_steps):
        key, sub = jax.random.split(key)
        u = torch.tensor(np.asarray(jax.random.uniform(
            sub, (cfg.ransac_iterations, cfg.padded_features))))
        ue = None
        if cfg.mono_rotation:
            key, sub2 = jax.random.split(key)
            ue = torch.tensor(np.asarray(jax.random.uniform(
                sub2, (ESS_ITERS, cfg.padded_features))))
        draws.append((u, ue))
    return draws


@pytest.fixture(scope="module", params=["default", "mono", "real_aspect"])
def runs(request):
    (h, w), intr, ckw, frames, chunk = _case(request.param)
    cfg = VOConfig.for_image(h, w, **ckw)
    scan = pipeline.run_sequence_scan(frames, cfg, CameraIntrinsics(**intr),
                                      chunk=chunk, warmup=False, device="cpu")
    piped = pipe.run_sequence_pipelined(frames, cfg, CameraIntrinsics(**intr),
                                        devices=["cpu", "cpu"])
    return request.param, (h, w), intr, ckw, frames, cfg, scan, piped


def test_pipe_equals_scan_bitwise(runs):
    *_, scan, piped = runs
    poses_scan, out_scan = scan[0], scan[1]
    poses_pipe, out_pipe, wall = piped
    np.testing.assert_array_equal(poses_pipe, poses_scan)
    for field in out_scan._fields:
        ref = getattr(out_scan, field)
        if field == "num_bucketed":
            ref = out_scan.num_matched
        got = getattr(out_pipe, field)
        assert got.dtype == ref.dtype and got.shape == ref.shape, field
        np.testing.assert_array_equal(got, ref, err_msg=field)
    assert wall > 0 and out_pipe.accept.mean() >= 0.8


def test_pipe_agrees_with_jax_pipe(runs, monkeypatch):
    name, (h, w), intr, ckw, frames, cfg, _, _ = runs
    ref_poses, ref, _ = jax_pipe(frames, JVOConfig.for_image(h, w, **ckw),
                                 JIntrinsics(**intr),
                                 devices=jax.devices()[:2])
    draws = iter(_jax_draws(cfg, len(frames) - 1))
    real = pipe.make_backend_fn

    def fed_backend(*args, **kwargs):
        backend = real(*args, **kwargs)

        def fed(*xs):
            u, ue = next(draws)
            return backend(*xs, uniforms=u, ess_uniforms=ue)

        return fed

    monkeypatch.setattr(pipe, "make_backend_fn", fed_backend)
    _, got, _ = pipe.run_sequence_pipelined(
        frames, cfg, CameraIntrinsics(**intr), devices=["cpu", "cpu"])
    ref = jax.tree.map(np.asarray, ref)
    np.testing.assert_array_equal(got.accept, ref.accept)
    np.testing.assert_array_equal(got.num_matched, ref.num_matched)
    assert (np.abs(got.num_inliers - ref.num_inliers)
            <= COUNT_FRAC * ref.num_inliers).all()
    d = np.abs(got.T_inv - ref.T_inv)
    assert d[:, :3, :3].max() < ROT_TOL, name
    same = got.num_inliers == ref.num_inliers
    assert same.sum() >= len(same) - 1, (got.num_inliers, ref.num_inliers)
    assert d[same, :3, 3].max() < TRANS_TOL, (name, d[:, :3, 3].max(axis=1))


def test_pipe_needs_two_devices(monkeypatch):
    _, intr, ckw, frames, _ = _case("default")
    cfg = VOConfig.for_image(120, 160, **ckw)
    with pytest.raises(ValueError, match="needs two devices"):
        pipe.run_sequence_pipelined(frames, cfg, CameraIntrinsics(**intr),
                                    devices=["cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipe.run_sequence_pipelined(frames, cfg, CameraIntrinsics(**intr))
