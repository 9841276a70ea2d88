"""The CUDA LK kernels on the card: each against its plain PyTorch version,
each batched launch against B unbatched launches, and four chained legs of
level launches (the per-leg route) against one quad launch, bit for bit.

Every test here needs an NVIDIA GPU and nvcc: they carry the ``cuda`` marker
and skip where there is no card. This file imports neither JAX nor the
tests' conftest helpers, so on the card it runs without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from visual_odom_tpu_torch.ops import lk_cuda
from visual_odom_tpu_torch.ops.lk import (LKImage, LKParams, lk_track_pyramid,
                                          prepare_lk_image)

#: |delta pt| bound on tracks whose statuses agree (px); statuses may differ
#: on at most STATUS_MISMATCH_MAX features (hard min-eig / closure
#: thresholds)
PT_TOL = 1e-3
STATUS_MISMATCH_MAX = 1

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _textured(h, w, seed):
    r = np.random.default_rng(seed)
    img = r.uniform(0, 255, (h, w))
    for _ in range(3):
        img = (img + np.roll(img, 1, 0) + np.roll(img, -1, 0)
               + np.roll(img, 1, 1) + np.roll(img, -1, 1)) / 5.0
    img -= img.min()
    return (img / img.max() * 255.0).astype(np.float32)


def _shift(img, dx, dy):
    """Bilinear translation: out[y, x] = img[y - dy, x - dx] (edge clamp)."""
    h, w = img.shape
    ys = np.clip(np.arange(h) - dy, 0, h - 1)
    xs = np.clip(np.arange(w) - dx, 0, w - 1)
    y0, x0 = np.floor(ys).astype(int), np.floor(xs).astype(int)
    y1, x1 = np.minimum(y0 + 1, h - 1), np.minimum(x0 + 1, w - 1)
    fy, fx = (ys - y0)[:, None], (xs - x0)[None, :]
    return ((1 - fy) * (1 - fx) * img[np.ix_(y0, x0)]
            + (1 - fy) * fx * img[np.ix_(y0, x1)]
            + fy * (1 - fx) * img[np.ix_(y1, x0)]
            + fy * fx * img[np.ix_(y1, x1)]).astype(np.float32)


def _inputs(dev, n=256, instance=0):
    img0 = _textured(240, 320, seed=31 + instance)
    img1 = _shift(img0, 2.7 - instance, -1.9 + 0.5 * instance)
    li = prepare_lk_image(torch.from_numpy(img0).to(dev))
    lj = prepare_lk_image(torch.from_numpy(img1).to(dev))
    rng = np.random.default_rng(instance)
    pts = np.stack([rng.uniform(-10, 330, n), rng.uniform(-10, 250, n)],
                   axis=1).astype(np.float32)
    valid = rng.random(n) < 0.85
    flow = rng.uniform(-1.5, 1.5, (n, 2)).astype(np.float32)
    disp = rng.uniform(-1.5, 1.5, (n, 2)).astype(np.float32)
    planes = [li.pyramid, lj.pyramid, li.pyramid, lj.pyramid]
    t = [torch.from_numpy(x).to(dev) for x in (pts, valid, flow, disp)]
    return planes, li.shapes, li.pad, t


@pytest.mark.parametrize("start_level", [0, 1, 2, 3])
def test_kernel_matches_plain(cuda_device, start_level):
    planes, shapes, pad, (pts, valid, flow, disp) = _inputs(cuda_device)
    args = (planes, shapes, pad, pts, valid, flow, disp, LKParams(),
            start_level)
    out_k, st_k = lk_cuda.lk_quad_cuda(*args)
    out_p, st_p, _ = lk_cuda.lk_quad_plain(*args)
    torch.cuda.synchronize()
    assert int((st_k != st_p).sum()) <= STATUS_MISMATCH_MAX
    both = st_k & st_p
    assert int(both.sum()) > 100
    assert float((out_k - out_p).abs()[:, both].max()) < PT_TOL
    # invalid slots pass their input through, status 0
    assert not bool(st_k[~valid].any())
    assert torch.equal(out_k[:, ~valid], pts[~valid][None].expand(4, -1, -1))


def test_wrapper_counts_launches_and_routes_to_kernel(cuda_device):
    planes, shapes, pad, (pts, valid, flow, disp) = _inputs(cuda_device, n=64)
    imgs = [lk_cuda.LKImage(p, shapes, pad) for p in planes]
    before = lk_cuda.lk_circular_quad.launches
    out = lk_cuda.lk_circular_quad(*imgs, pts, valid, LKParams(), flow=flow,
                                   disp=disp, start_level=1)
    torch.cuda.synchronize()
    assert lk_cuda.lk_circular_quad.launches == before + 1
    assert all(o.is_cuda for o in out)


def test_kernel_rejects_what_it_was_not_built_for(cuda_device):
    planes, shapes, pad, (pts, valid, flow, disp) = _inputs(cuda_device, n=32)
    with pytest.raises(ValueError, match="window"):
        lk_cuda.lk_quad_cuda(planes, shapes, pad, pts, valid, flow, disp,
                             LKParams(window=15), 1)
    with pytest.raises(ValueError, match="pts"):
        lk_cuda.lk_quad_cuda(planes, shapes, pad, pts.double(), valid, flow,
                             disp, LKParams(), 1)


def _batched_inputs(dev, batch=3, n=128):
    """``batch`` instances of ``_inputs`` (other textures, shifts and
    features each), stacked along a leading batch dim."""
    runs = [_inputs(dev, n, instance=b) for b in range(batch)]
    shapes, pad = runs[0][1], runs[0][2]
    planes = [[torch.stack([r[0][im][lv] for r in runs]) for lv in range(4)]
              for im in range(4)]
    feats = [torch.stack([r[3][k] for r in runs]) for k in range(4)]
    # one sequence masked off entirely, as the safe quad is on a frame that
    # sequence does not fall back on
    feats[1][1] = False
    return planes, shapes, pad, feats


@pytest.mark.parametrize("start_level", [1, 2])
def test_batched_launch_equals_unbatched_launches(cuda_device, start_level):
    """Sequence b of one batched launch is bit for bit an unbatched launch
    on sequence b."""
    planes, shapes, pad, (pts, valid, flow, disp) = _batched_inputs(cuda_device)
    before = (lk_cuda.lk_circular_quad.launches,
              lk_cuda.lk_circular_quad.batched_launches)
    out, st = lk_cuda.lk_quad_cuda(planes, shapes, pad, pts, valid, flow,
                                   disp, LKParams(), start_level)
    assert (lk_cuda.lk_circular_quad.launches,
            lk_cuda.lk_circular_quad.batched_launches) == (before[0],
                                                           before[1] + 1)
    assert out.shape == (4,) + tuple(pts.shape) and st.shape == valid.shape
    for b in range(pts.shape[0]):
        o1, s1 = lk_cuda.lk_quad_cuda(
            [[p[b].contiguous() for p in im] for im in planes], shapes, pad,
            pts[b].contiguous(), valid[b].contiguous(), flow[b].contiguous(),
            disp[b].contiguous(), LKParams(), start_level)
        assert torch.equal(out[:, b], o1) and torch.equal(st[b], s1)
    torch.cuda.synchronize()


@pytest.mark.parametrize("start_level", [1, 2])
def test_batched_kernel_matches_plain_batched(cuda_device, start_level):
    planes, shapes, pad, (pts, valid, flow, disp) = _batched_inputs(cuda_device)
    args = (planes, shapes, pad, pts, valid, flow, disp, LKParams(),
            start_level)
    out_k, st_k = lk_cuda.lk_quad_cuda(*args)
    out_p, st_p, _ = lk_cuda.lk_quad_plain_batched(*args)
    torch.cuda.synchronize()
    for b in range(pts.shape[0]):
        assert int((st_k[b] != st_p[b]).sum()) <= STATUS_MISMATCH_MAX
    both = st_k & st_p
    assert int(both.sum()) > 150 and not bool(st_k[1].any())
    assert float((out_k - out_p).abs()[:, both].max()) < PT_TOL
    assert torch.equal(out_k[:, ~valid], pts[~valid][None].expand(4, -1, -1))


def _level_args(planes, shapes, pad, feats, level, finest=None):
    """One level of leg L0 -> R0 at ``level``: template corners at the
    points, start estimates at points + disp, both in the level's
    coordinates (window corner)."""
    pts, valid, _, disp = feats
    half = (LKParams().window - 1) * 0.5
    scale = 2.0 ** level
    rows, cols = shapes[level]
    return (planes[0][level], planes[1][level], rows, cols, pad,
            pts / scale - half, (pts + disp) / scale - half, valid, LKParams(),
            level == 0 if finest is None else finest)


@pytest.mark.parametrize("level", [0, 1, 2, 3])
def test_level_kernel_matches_plain(cuda_device, level):
    planes, shapes, pad, feats = _inputs(cuda_device)
    args = _level_args(planes, shapes, pad, feats, level)
    out_k, ok_k = lk_cuda.lk_level_cuda(*args)
    out_p, ok_p, _ = lk_cuda.lk_level_plain(*args)
    torch.cuda.synchronize()
    assert int((ok_k != ok_p).sum()) <= STATUS_MISMATCH_MAX
    both = ok_k & ok_p
    assert int(both.sum()) > 50
    assert float((out_k - out_p).abs()[both].max()) < PT_TOL
    # invalid slots fail the level: init passes through, status 0
    valid, init = feats[1], args[6]
    assert not bool(ok_k[~valid].any())
    assert torch.equal(out_k[~valid], init[~valid])


@pytest.mark.parametrize("level", [0, 2])
def test_batched_level_launch_equals_unbatched_launches(cuda_device, level):
    planes, shapes, pad, feats = _batched_inputs(cuda_device)
    args = _level_args(planes, shapes, pad, feats, level)
    before = (lk_track_pyramid.launches,
              lk_track_pyramid.batched_launches)
    out, ok = lk_cuda.lk_level_cuda(*args)
    assert (lk_track_pyramid.launches,
            lk_track_pyramid.batched_launches) == (before[0],
                                                        before[1] + 1)
    assert out.shape == args[5].shape and ok.shape == feats[1].shape
    for b in range(out.shape[0]):
        one = [a[b].contiguous() if torch.is_tensor(a) else a for a in args]
        o1, k1 = lk_cuda.lk_level_cuda(*one)
        assert torch.equal(out[b], o1) and torch.equal(ok[b], k1)
    torch.cuda.synchronize()


@pytest.mark.parametrize("batched", [False, True], ids=["single", "batched"])
@pytest.mark.parametrize("start_level", [1, 2])
def test_chained_level_legs_equal_quad_kernel(cuda_device, start_level,
                                              batched):
    """Four lk_track_pyramid legs seeded as circular_match seeds them give
    one lk_quad_kernel launch's positions and status bit for bit."""
    planes, shapes, pad, (pts, valid, flow, disp) = (
        _batched_inputs(cuda_device) if batched else _inputs(cuda_device))
    imgs = [LKImage(tuple(p), shapes, pad) for p in planes]
    out_q, st_q = lk_cuda.lk_quad_cuda(planes, shapes, pad, pts, valid, flow,
                                       disp, LKParams(), start_level)
    p, status = pts, valid
    for leg, (seed, sgn) in enumerate(lk_cuda.QUAD_SEEDS):
        s = disp if seed == "disp" else flow
        p, ok = lk_track_pyramid(imgs[leg], imgs[(leg + 1) % 4], p, valid,
                                 LKParams(), init_pts=p + s if sgn > 0 else p - s,
                                 start_level=start_level)
        assert torch.equal(p, out_q[leg]), f"leg {leg}"
        status = status & ok
    assert torch.equal(status, st_q)
    torch.cuda.synchronize()


def test_level_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    planes, shapes, pad, feats = _inputs(cuda_device, n=32)
    args = list(_level_args(planes, shapes, pad, feats, 0))
    for i, bad, match in ((5, args[5].double(), "prev"),
                          (6, args[6][:-1].contiguous(), "init"),
                          (5, args[5].cpu(), "CUDA tensors"),
                          (0, args[0].cpu(), "^I: "),
                          (8, LKParams(window=15), "window")):
        wrong = list(args)
        wrong[i] = bad
        with pytest.raises(ValueError, match=match):
            lk_cuda.lk_level_cuda(*wrong)


@pytest.mark.parametrize("start_level", [1, 2, None])
def test_leg_on_cuda_counts_one_launch_per_level(cuda_device, start_level):
    planes, shapes, pad, (pts, valid, _, disp) = _inputs(cuda_device, n=64)
    li, lj = LKImage(planes[0], shapes, pad), LKImage(planes[1], shapes, pad)
    before = lk_track_pyramid.launches
    out, status = lk_track_pyramid(li, lj, pts, valid, LKParams(),
                                   init_pts=pts + disp,
                                   start_level=start_level)
    torch.cuda.synchronize()
    levels = LKParams().levels if start_level is None else start_level
    assert lk_track_pyramid.launches == before + levels + 1
    assert out.is_cuda and status.is_cuda and int(status.sum()) > 20
