"""The CUDA LK kernel on the card, against its plain PyTorch version, and
its batched launch against B unbatched launches.

Every test here needs an NVIDIA GPU and nvcc: they carry the ``cuda`` marker
and skip where there is no card. This file imports neither JAX nor the
tests' conftest helpers, so on the card it runs without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from visual_odom_tpu_torch.ops import lk_cuda
from visual_odom_tpu_torch.ops.lk import LKParams, prepare_lk_image

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
