"""PyTorch port vs the JAX package: pyramids, FAST and the circular LK quad.

The JAX side runs on the CPU as its own tests run it: the Pallas quad in
interpret mode (as tests/test_lk_pallas.py does) and the XLA twin. The
port's LK here is the plain PyTorch version of the CUDA kernel (the wrapper
takes it for CPU tensors); the kernel itself is held against that plain
version on the card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from conftest import make_textured_image, warp_translate
from visual_odom_tpu.ops.fast import fast_score_map as jax_fast
from visual_odom_tpu.ops.lk import (LKParams as JLKParams, lk_track_pyramid,
                                    prepare_lk_image as jax_prepare)
from visual_odom_tpu.ops.lk_pallas import lk_circular_quad_pallas
from visual_odom_tpu_torch.ops import lk_cuda
from visual_odom_tpu_torch.ops.fast import fast_score_map
from visual_odom_tpu_torch.ops.lk import LKImage, LKParams, prepare_lk_image

# Small tensors: one intra-op thread each keeps the parallel test workers
# from oversubscribing the cores.
torch.set_num_threads(1)

#: |delta pt| bound on tracks whose status agrees (px)
PT_TOL = 1e-3
#: pyramid planes: 2 float32 ulps at 255 (2**-15 ~ 3.05e-5); the band
#: matmuls sum in another order than XLA's
PLANE_TOL = 2.0 ** -15


def to_port_image(im) -> LKImage:
    """JAX LKImage -> port LKImage on the same planes."""
    return LKImage(tuple(torch.tensor(np.asarray(p)) for p in im.pyramid),
                   im.shapes, im.pad)


@pytest.mark.parametrize("shape", [(120, 160), (376, 1241)])
def test_pyramid_planes_match_jax(shape):
    """Every plane (pad and zero tail included) within PLANE_TOL on
    [0, 255] images."""
    img = np.random.default_rng(3).uniform(0, 255, shape).astype(np.float32)
    ref = jax_prepare(jnp.asarray(img), JLKParams(), with_derivs=False)
    got = prepare_lk_image(torch.from_numpy(img), LKParams())
    assert got.shapes == ref.shapes and got.pad == ref.pad
    for g, r in zip(got.pyramid, ref.pyramid):
        r = np.asarray(r)
        assert g.shape == r.shape
        assert np.abs(g.numpy() - r).max() <= PLANE_TOL


@pytest.mark.parametrize("source", ["textured", "synthetic"])
def test_fast_score_map_equal(source):
    if source == "textured":
        img = np.round(make_textured_image(120, 160, seed=5))
    else:
        from visual_odom_tpu_torch.config import CameraIntrinsics
        from visual_odom_tpu_torch.io.synthetic import SyntheticStereoSequence

        intr = CameraIntrinsics(fx=120.0, fy=120.0, cx=80.0, cy=60.0,
                                bf=-64.8, width=160, height=120)
        img = SyntheticStereoSequence(intr, num_frames=2, seed=0).frame(1)[0]
    ref = np.asarray(jax_fast(jnp.asarray(img, jnp.float32)))
    got = fast_score_map(torch.as_tensor(np.asarray(img, np.float32))).numpy()
    assert (ref > 0).sum() > 20
    np.testing.assert_array_equal(got, ref)


@pytest.fixture(scope="module")
def quad_inputs():
    """L0 = I, R0 = J, R1 = I, L1 = J with J a (2.7, -1.9) px shift of I,
    64 features (4 invalid) and seeds within +-1.5 px."""
    img0 = make_textured_image(240, 320, seed=31)
    img1 = warp_translate(img0, 2.7, -1.9)
    p = JLKParams()
    li = jax_prepare(jnp.asarray(img0), p)
    lj = jax_prepare(jnp.asarray(img1), p)
    rng = np.random.default_rng(0)
    pts = np.stack([rng.uniform(30, 290, 64), rng.uniform(30, 210, 64)],
                   axis=1).astype(np.float32)
    valid = np.ones(64, bool)
    valid[-4:] = False
    flow = rng.uniform(-1.5, 1.5, (64, 2)).astype(np.float32)
    disp = rng.uniform(-1.5, 1.5, (64, 2)).astype(np.float32)
    return li, lj, pts, valid, flow, disp


def _port_quad(quad_inputs, sl):
    li, lj, pts, valid, flow, disp = quad_inputs
    ti, tj = to_port_image(li), to_port_image(lj)
    out = lk_cuda.lk_circular_quad(
        ti, tj, ti, tj, torch.from_numpy(pts), torch.from_numpy(valid),
        LKParams(), flow=torch.from_numpy(flow), disp=torch.from_numpy(disp),
        start_level=sl)
    return [o.numpy() for o in out]


def _assert_quad_close(got, ref):
    status = ref[4]
    np.testing.assert_array_equal(got[4], status)
    assert status.sum() > 40
    for g, r in zip(got[:4], ref[:4]):
        assert np.abs(g - r)[status].max() < PT_TOL


@pytest.mark.parametrize("start_level", [1, 2])
def test_plain_quad_matches_pallas_interpret(quad_inputs, start_level):
    li, lj, pts, valid, flow, disp = quad_inputs
    ref = lk_circular_quad_pallas(
        li, lj, li, lj, jnp.asarray(pts), jnp.asarray(valid), JLKParams(),
        interpret=True, flow=jnp.asarray(flow), disp=jnp.asarray(disp),
        start_level=start_level)
    _assert_quad_close(_port_quad(quad_inputs, start_level),
                       [np.asarray(r) for r in ref])


@pytest.mark.parametrize("start_level", [1, 2])
def test_plain_quad_matches_xla_legs(quad_inputs, start_level):
    """Four chained XLA legs seeded as circular_match seeds them."""
    li, lj, pts, valid, flow, disp = quad_inputs
    p = JLKParams()
    v = jnp.asarray(valid)
    f, d = jnp.asarray(flow), jnp.asarray(disp)

    def track(I, J, x, init):
        return lk_track_pyramid(I, J, x, v, p, init_pts=init,
                                start_level=start_level)

    x0 = jnp.asarray(pts)
    r0, s0 = track(li, lj, x0, x0 + d)
    r1, s1 = track(lj, li, r0, r0 + f)
    l1, s2 = track(li, lj, r1, r1 - d)
    ret, s3 = track(lj, li, l1, l1 - f)
    ref = [np.asarray(x) for x in (r0, r1, l1, ret, s0 & s1 & s2 & s3)]
    _assert_quad_close(_port_quad(quad_inputs, start_level), ref)


def test_plain_quad_invalid_passthrough(quad_inputs):
    _, _, pts, valid, _, _ = quad_inputs
    got = _port_quad(quad_inputs, 1)
    assert not got[4][~valid].any()
    for g in got[:4]:
        np.testing.assert_array_equal(g[~valid], pts[~valid])


def test_cpu_tensors_take_the_plain_version(quad_inputs):
    before = lk_cuda.lk_circular_quad.launches
    _port_quad(quad_inputs, 2)
    assert lk_cuda.lk_circular_quad.launches == before


def test_plain_quad_reports_iterations(quad_inputs):
    li, lj, pts, valid, flow, disp = quad_inputs
    ti, tj = to_port_image(li), to_port_image(lj)
    planes = [ti.pyramid, tj.pyramid, ti.pyramid, tj.pyramid]
    _, _, iters = lk_cuda.lk_quad_plain(
        planes, ti.shapes, ti.pad, torch.from_numpy(pts),
        torch.from_numpy(valid), torch.from_numpy(flow),
        torch.from_numpy(disp), LKParams(), 1)
    assert iters.shape == (4, 2, 64)
    assert (iters[..., ~torch.from_numpy(valid)] == 0).all()
    assert 0 < iters.max() <= LKParams().max_iters
