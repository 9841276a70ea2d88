"""The CUDA LK kernels on the card: each against its plain PyTorch version,
each batched launch against B unbatched launches, and four chained legs of
level launches (the per-leg route) against one quad launch, bit for bit.
Every instance (doublestep x packed) is held to the plain version, and
doublestep on equals doublestep off bit for bit, also from the top of the
pyramid with zero flow and disparity, as a loop-edge measurement launches
them. The back end's solves (``ba_solve``, ``posegraph_solve``) on the card
against the same solves on the CPU. The mono-rotation step and the
Shi-Tomasi step on the card against the same steps on the CPU, neither
waiting for the device; a crashed scan resumed from its snapshot on the
card, bit for bit the uninterrupted run; the same for the restartable
batched runner, whose chunks between snapshots never wait for the card and
whose card snapshot a CPU run refuses; and a KITTI directory of PNGs
streamed through the native prefetcher and two upload threads, bit for bit
the in-memory scan. The pipelined runner on two streams of one card, bit
for bit the scan and never waiting for the card in its loop, and the
command line's chunked run on the card. The multi-device paths on meshes
of this card and, with several cards, across them: from one process, and
with one rank per card over NCCL (tests/torch_dist_worker.py spawns the
ranks), each rank's result bit for bit the one-process run's.

Every test here needs an NVIDIA GPU and nvcc: they carry the ``cuda`` marker
and skip where there is no card. This file imports neither JAX nor the
tests' conftest helpers, so on the card it runs without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import os

import numpy as np
import pytest
import torch

from visual_odom_tpu_torch.ba import posegraph, problem, schur
from visual_odom_tpu_torch.backend import pnp
from visual_odom_tpu_torch.config import CameraIntrinsics, VOConfig
from visual_odom_tpu_torch.core.lie import rodrigues, rodrigues_inverse
from visual_odom_tpu_torch.io.pnp_scene import pnp_scene
from visual_odom_tpu_torch.io.synthetic import SyntheticStereoSequence
from visual_odom_tpu_torch.ops import lk_cuda
from visual_odom_tpu_torch.ops.lk import (LKImage, LKParams, lk_track_pyramid,
                                          prepare_lk_image)
from visual_odom_tpu_torch.runner import pipeline

#: |delta pt| bound on tracks whose statuses agree (px); statuses may differ
#: on at most STATUS_MISMATCH_MAX features (hard min-eig / closure
#: thresholds)
PT_TOL = 1e-3
STATUS_MISMATCH_MAX = 1
#: px; a track the plain version moves by PT_TOL or more when its points
#: shift by +-KNIFE_SHIFT sits on a knife edge
KNIFE_SHIFT = 1e-5
#: card against CPU: BA poses, the JAX package's ring-vs-single bound
#: (tests/test_ba_window.py:122); pose-graph nodes, its sharded-vs-single
#: bound (tests/test_posegraph.py:106)
BA_TOL = 5e-4
NODE_TOL = 2e-4

pytestmark = pytest.mark.cuda

#: (doublestep, packed) of each built instance
INSTANCES = [(d, p) for p in (False, True) for d in (False, True)]


def _instance_id(inst):
    return f"doublestep{int(inst[0])}-packed{int(inst[1])}"


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


@pytest.mark.parametrize("instance", INSTANCES, ids=_instance_id)
@pytest.mark.parametrize("batched", [False, True], ids=["single", "batched"])
@pytest.mark.parametrize("start_level", [1, 2])
def test_chained_level_legs_equal_quad_kernel(cuda_device, start_level,
                                              batched, instance, monkeypatch):
    """Four lk_track_pyramid legs seeded as circular_match seeds them give
    one lk_quad_kernel launch's positions and status bit for bit, with both
    kernels on the same instance (the module's defaults, as on the main
    path)."""
    monkeypatch.setattr(lk_cuda, "DEFAULT_DOUBLESTEP", instance[0])
    monkeypatch.setattr(lk_cuda, "DEFAULT_PACKED", instance[1])
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


def _quad_or_level(kernel, dev, batched, n=256):
    """(launch, plain, valid) for one kernel on the inputs above: the quad
    at start level 2, or level 0 of leg L0 -> R0. ``plain(shift)`` runs the
    plain version with the points moved by ``shift`` px."""
    planes, shapes, pad, feats = (_batched_inputs(dev, n=n // 2) if batched
                                  else _inputs(dev, n))
    if kernel == "quad":
        args = (planes, shapes, pad) + tuple(feats) + (LKParams(), 2)
        plain = (lk_cuda.lk_quad_plain_batched if batched
                 else lk_cuda.lk_quad_plain)
        return (lambda **kw: lk_cuda.lk_quad_cuda(*args, **kw),
                lambda shift=0.0: plain(args[0], args[1], args[2],
                                        args[3] + shift, *args[4:])[:2],
                feats[1])
    args = _level_args(planes, shapes, pad, feats, 0)
    plain = (lk_cuda.lk_level_plain_batched if batched
             else lk_cuda.lk_level_plain)
    return (lambda **kw: lk_cuda.lk_level_cuda(*args, **kw),
            lambda shift=0.0: plain(*args[:5], args[5] + shift,
                                    args[6] + shift, *args[7:])[:2],
            feats[1])


@pytest.mark.parametrize("batched", [False, True], ids=["single", "batched"])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("kernel", ["quad", "level"])
def test_doublestep_is_bit_exact(cuda_device, kernel, packed, batched):
    """The window-reuse instance reads the same pixels into the same
    arithmetic in the same order as the instance that reads global memory:
    equal bit for bit."""
    launch, _, _ = _quad_or_level(kernel, cuda_device, batched)
    out_a, st_a = launch(doublestep=False, packed=packed)
    out_b, st_b = launch(doublestep=True, packed=packed)
    torch.cuda.synchronize()
    assert torch.equal(out_a, out_b) and torch.equal(st_a, st_b)
    assert int(st_a.sum()) > 50


@pytest.mark.parametrize("batched", [False, True], ids=["single", "batched"])
@pytest.mark.parametrize("instance", INSTANCES, ids=_instance_id)
@pytest.mark.parametrize("kernel", ["quad", "level"])
def test_instance_matches_plain(cuda_device, kernel, instance, batched):
    launch, plain, valid = _quad_or_level(kernel, cuda_device, batched)
    _hold_to_plain(kernel, instance, launch, plain, valid)


def _hold_to_plain(kernel, instance, launch, plain, valid):
    """One instance against the plain version: agreed tracks within PT_TOL
    and invalid slots untouched. A packed instance sums in another order,
    which can move a knife-edge track (one the plain version itself moves
    by PT_TOL or more when its points shift by KNIFE_SHIFT px): such a track
    counts as a status flip. Flips: at most STATUS_MISMATCH_MAX per
    sequence."""
    out_k, st_k = launch(doublestep=instance[0], packed=instance[1])
    out_p, st_p = plain()
    both = st_k & st_p
    err = (out_k - out_p).abs().amax(dim=-1)
    if kernel == "quad":
        err = err.amax(dim=0)
    diverged = both & (err >= PT_TOL)
    if instance[1]:
        knife = torch.zeros_like(st_p)
        for shift in (KNIFE_SHIFT, -KNIFE_SHIFT):
            o, st = plain(shift)
            d = (o - out_p).abs().amax(dim=-1)
            knife |= (st != st_p) | ((d.amax(dim=0) if kernel == "quad" else d)
                                     >= PT_TOL)
        assert not bool((diverged & ~knife).any())
        flips = (st_k != st_p) | diverged
    else:
        assert not bool(diverged.any()), float(err[both].max())
        flips = st_k != st_p
    torch.cuda.synchronize()
    assert int(flips.sum(dim=-1).max()) <= STATUS_MISMATCH_MAX
    assert int(both.sum()) > 50
    assert not bool(st_k[~valid].any())
    # invalid slots pass their input (quad) or init (level) through
    inv = (lambda t: t[:, ~valid]) if kernel == "quad" else (lambda t: t[~valid])
    assert torch.equal(inv(out_k), inv(out_p))


def _full_pyramid_inputs(dev, n=256):
    """``_inputs`` with zero flow and disparity: what a loop-edge
    measurement gives the kernels, which then start at level ``levels``."""
    planes, shapes, pad, (pts, valid, flow, _) = _inputs(dev, n)
    zero = torch.zeros_like(flow)
    return planes, shapes, pad, (pts, valid, zero, zero)


@pytest.mark.parametrize("instance", INSTANCES, ids=_instance_id)
def test_quad_from_pyramid_top_matches_plain(cuda_device, instance):
    planes, shapes, pad, feats = _full_pyramid_inputs(cuda_device)
    args = (planes, shapes, pad) + tuple(feats) + (LKParams(),
                                                   LKParams().levels)
    _hold_to_plain(
        "quad", instance, lambda **kw: lk_cuda.lk_quad_cuda(*args, **kw),
        lambda shift=0.0: lk_cuda.lk_quad_plain(
            *args[:3], args[3] + shift, *args[4:])[:2], feats[1])


@pytest.mark.parametrize("instance", INSTANCES, ids=_instance_id)
def test_level_launches_from_pyramid_top_match_plain(cuda_device, instance,
                                                     monkeypatch):
    """Every level launch of leg L0 -> R0 from the pyramid top (start level
    None, seeded at the points) against the plain version on the inputs
    ``lk_track_pyramid`` gives it."""
    planes, shapes, pad, (pts, valid, _, _) = _full_pyramid_inputs(cuda_device)
    calls, real = [], lk_cuda.lk_level_cuda

    def record(*args, **kw):
        calls.append(args)
        return real(*args, **kw)

    monkeypatch.setattr(lk_cuda, "lk_level_cuda", record)
    lk_track_pyramid(LKImage(planes[0], shapes, pad),
                     LKImage(planes[1], shapes, pad), pts, valid, LKParams(),
                     init_pts=pts)
    monkeypatch.undo()
    assert len(calls) == LKParams().levels + 1
    for a in calls:
        _hold_to_plain(
            "level", instance, lambda a=a, **kw: lk_cuda.lk_level_cuda(*a, **kw),
            lambda shift=0.0, a=a: lk_cuda.lk_level_plain(
                *a[:5], a[5] + shift, a[6] + shift, a[7] > 0, *a[8:])[:2],
            a[7] > 0)


def test_ba_solve_on_card_matches_cpu(cuda_device):
    """A window-sized problem (8 poses, 256 landmarks, tracks of <= 5
    frames) solved with the CLI's defaults on the card and on the CPU."""
    p, _, _ = problem.synthetic_ba_problem(num_poses=8, num_landmarks=256,
                                           obs_window=2, device="cpu")
    card = p._replace(**{k: getattr(p, k).to(cuda_device) for k in (
        "poses", "landmarks", "observations", "mask")})
    got = schur.ba_solve(card, iterations=8, huber_delta=1.5)
    ref = schur.ba_solve(p, iterations=8, huber_delta=1.5)
    assert got.poses.is_cuda
    assert float((got.poses.cpu() - ref.poses).abs().max()) < BA_TOL


def test_posegraph_solve_on_card_matches_cpu(cuda_device):
    """A drifted circle of 40 nodes closed by one loop edge, solved on the
    card and on the CPU."""
    rng = np.random.default_rng(3)
    n = 40
    th = 2 * np.pi * np.arange(n) / n
    truth = np.tile(np.eye(4), (n, 1, 1))
    truth[:, :3, :3] = rodrigues(torch.tensor(
        np.stack([0 * th, th, 0 * th], 1))).numpy()
    truth[:, 0, 3], truth[:, 2, 3] = 10 * np.sin(th), 10 * (1 - np.cos(th))
    est = [truth[0]]
    for k in range(n - 1):
        D = np.eye(4)
        D[:3, :3] = rodrigues(torch.tensor(rng.normal(0, 0.004, 3))).numpy()
        D[:3, 3] = rng.normal(0, 0.02, 3)
        est.append(est[-1] @ np.linalg.inv(truth[k]) @ truth[k + 1] @ D)
    est = np.stack(est)
    loop = [(0, n - 1, np.linalg.inv(truth[0]) @ truth[-1], 10.0)]
    ref = posegraph.posegraph_solve(posegraph.build_keyframe_graph(
        est, np.arange(n), loop, device="cpu")).nodes
    got = posegraph.posegraph_solve(posegraph.build_keyframe_graph(
        est, np.arange(n), loop, device=cuda_device)).nodes
    assert got.is_cuda
    assert float((got.cpu() - ref).abs().max()) < NODE_TOL
    assert (np.linalg.norm(ref[-1, :3, 3].numpy() - truth[-1, :3, 3])
            < 0.2 * np.linalg.norm(est[-1, :3, 3] - truth[-1, :3, 3]))


def test_wrappers_reject_flags_they_were_not_built_for(cuda_device):
    launch_q, _, _ = _quad_or_level("quad", cuda_device, False, n=32)
    launch_l, _, _ = _quad_or_level("level", cuda_device, False, n=32)
    for launch in (launch_q, launch_l):
        for bad in ({"packed": 2}, {"doublestep": "yes"}, {"packed": 1},
                    {"doublestep": None, "packed": np.bool_(True)}):
            with pytest.raises(ValueError, match="built for True or False"):
                launch(**bad)


def test_doublestep_rejects_planes_it_cannot_stage(cuda_device):
    """The window-reuse instance stages 16-byte copies: a plane whose rows
    are not a multiple of 4 floats is refused, the other instance takes
    it."""
    planes, shapes, pad, feats = _inputs(cuda_device, n=32)
    args = list(_level_args(planes, shapes, pad, feats, 0))
    stride = args[1].shape[-1]
    args[0] = args[0][:, :stride - 2].contiguous()
    args[1] = args[1][:, :stride - 2].contiguous()
    with pytest.raises(ValueError, match="doublestep"):
        lk_cuda.lk_level_cuda(*args, doublestep=True)
    lk_cuda.lk_level_cuda(*args, doublestep=False)
    torch.cuda.synchronize()


@pytest.mark.parametrize("instance", INSTANCES, ids=_instance_id)
def test_kernel_info_reports_resources(cuda_device, instance):
    for level in (False, True):
        info = lk_cuda.kernel_info(level, *instance)
        assert info["features_per_block"] == (4 if instance[1] else 2)
        assert info["blocks_per_sm"] >= 1 and info["registers"] > 0
        assert info["shared_bytes"] == info["features_per_block"] * 6560


SMALL = dict(fx=120.0, fy=120.0, cx=80.0, cy=60.0, bf=-64.8, width=160,
             height=120)
#: MODES: the two configuration options this file holds on the card
MODES = {"mono": dict(mono_rotation=True), "shi_tomasi": dict(
    detector="shi-tomasi")}


def _small(mode, frames=4):
    intr = CameraIntrinsics(**SMALL)
    cfg = VOConfig.for_image(120, 160, ransac_iterations=200, **MODES[mode])
    seq = SyntheticStereoSequence(intr, num_frames=frames, seed=0, speed=0.5)
    return intr, cfg, [seq.frame(i) for i in range(frames)]


@pytest.mark.parametrize("mode", sorted(MODES))
def test_step_on_card_matches_cpu(cuda_device, mode):
    """Three steps on the card and on the CPU, fed the same draws (PnP's
    and the essential RANSAC's): equal counts (3 % on matches and
    inliers), T^-1 within tests/test_torch_pipeline.py's step bounds."""
    intr, cfg, frames = _small(mode)
    rng = np.random.default_rng(0)
    draws = [(rng.random((200, cfg.padded_features), dtype=np.float32),
              rng.random((200, cfg.padded_features), dtype=np.float32))
             for _ in frames[1:]]
    outs = {}
    for dev in ("cpu", cuda_device):
        step = pipeline.make_step_fn(cfg, intr, device=dev)
        st = pipeline.init_vo_state(cfg, intr, *frames[0], device=dev)
        outs[str(dev)] = []
        for (l, r), (u, ue) in zip(frames[1:], draws):
            st, out = step(st, torch.from_numpy(l).to(dev),
                           torch.from_numpy(r).to(dev),
                           uniforms=torch.from_numpy(u).to(dev),
                           ess_uniforms=torch.from_numpy(ue).to(dev))
            outs[str(dev)].append(pipeline._fetch(out))
    for ref, got in zip(outs["cpu"], outs[str(cuda_device)]):
        assert int(got.num_bucketed) == int(ref.num_bucketed)
        for k in ("num_matched", "num_inliers"):
            r, g = int(getattr(ref, k)), int(getattr(got, k))
            assert abs(g - r) <= 0.03 * r, (k, g, r)
        d = np.abs(got.T_inv - ref.T_inv)
        assert d[:3, :3].max() < 2e-3 and d[:3, 3].max() < 2e-2
        assert bool(got.accept) == bool(ref.accept)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_step_never_waits_for_the_card(cuda_device, mode):
    """The step draws from the generator and runs the essential RANSAC or
    the Shi-Tomasi map without one host synchronisation."""
    intr, cfg, frames = _small(mode)
    step = pipeline.make_step_fn(cfg, intr, device=cuda_device)
    st = pipeline.init_vo_state(cfg, intr, *frames[0], device=cuda_device)
    up = [tuple(torch.from_numpy(x).to(cuda_device) for x in f)
          for f in frames[1:]]
    st, _ = step(st, *up[0])        # first use: kernel build and load
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for l, r in up[1:]:
            st, out = step(st, l, r)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(torch.isfinite(out.T_inv).all())


# --- PnP-RANSAC's refinement kernels (csrc/pnp_gn.cu) ------------------------

KITTI_K = ((718.856, 0.0, 607.1928), (0.0, 718.856, 185.2157),
           (0.0, 0.0, 1.0))
SMALL_K = ((SMALL["fx"], 0.0, SMALL["cx"]), (0.0, SMALL["fy"], SMALL["cy"]),
           (0.0, 0.0, 1.0))
#: (B, slots, hypotheses, sample size, GN iterations, camera): the main path
#: at B = 1 (the live door) and B = 11 (the batched runner), and the
#: 200-iteration configuration of ``_small`` with another sample size and
#: iteration count
PNP_SHAPES = {"b1": (1, 384, 500, 6, 6, KITTI_K),
              "b11": (11, 384, 500, 6, 6, KITTI_K),
              "small": (2, 256, 200, 8, 4, SMALL_K)}
#: the polish against its plain twin, relative to 1 + |pose|: the two differ
#: only in the order of the sums of G and g, a few ulps of the normal
#: equations, and a converged GN moves the pose by the conditioning times
#: that (6.4e-7 at most on an H100, B = 1 and 11)
POLISH_TOL = 1e-5


def _f64(t):
    return t.cpu().double() if t.is_floating_point() else t.cpu()


def _pnp_errors(got, plain, ref):
    """The same poses finite on both sides; then each side's largest
    component distance to the float64 evaluation, over those poses."""
    got, plain, ref = (t.cpu().double() for t in (got, plain, ref))
    finite = torch.isfinite(got).all(-1)
    assert torch.equal(finite, torch.isfinite(plain).all(-1))
    return ((got - ref).abs().amax(-1)[finite],
            (plain - ref).abs().amax(-1)[finite])


@pytest.mark.parametrize("shape", sorted(PNP_SHAPES))
def test_pnp_hypotheses_kernel_matches_plain(cuda_device, shape):
    """One launch refines every hypothesis of every sequence as the plain
    twin on the card does. The two are float32 evaluations of one function
    that differ only in the order of the sums (G's and g's, the transform's
    three terms, the 3x3 products), so they leave the same poses non-finite
    and lie alike from the float64 evaluation: at the median and the 90th
    percentile of the hypotheses the kernel's distance is at most twice
    the plain twin's. Single hypotheses are not held: the ~1 % whose GN
    diverges on an outlier sample amplify any rounding without bound (the
    plain twins on the CPU and on the card differ there as much)."""
    B, n, H, k, iters, cam = PNP_SHAPES[shape]
    d = pnp_scene(cuda_device, B, n, H, k, cam, seed=B)
    args = (d["pose0"], d["X"], d["x"], d["idx"], d["K"])
    got = pnp.refine_hypotheses(*args, iters)
    plain = pnp._refine_hypotheses_plain(*args, iters)
    ref = pnp._refine_hypotheses_plain(*map(_f64, args), iters)
    assert got.shape == (B * H, 6)
    mine, twin = _pnp_errors(got, plain, ref)
    assert mine.numel() >= 0.9 * B * H
    for q in (0.5, 0.9):
        assert (torch.quantile(mine, q) <= 2 * torch.quantile(twin, q) + 1e-7
                ), (q, torch.quantile(mine, q), torch.quantile(twin, q))


@pytest.mark.parametrize("shape", sorted(PNP_SHAPES))
def test_pnp_polish_kernel_matches_plain(cuda_device, shape):
    """One launch polishes each sequence's pose on its weighted slots
    (twice the hypotheses' iterations), within POLISH_TOL of the plain
    twin on the card."""
    B, n, H, k, iters, cam = PNP_SHAPES[shape]
    d = pnp_scene(cuda_device, B, n, H, k, cam, seed=B)
    args = (d["polish"], d["X"], d["x"], d["w"], d["K"], 2 * iters)
    got = pnp.refine_polish(*args)
    plain = pnp._gn_refine(*args)
    assert bool(torch.isfinite(plain).all())
    err = (got - plain).abs() / (1.0 + plain.abs())
    assert float(err.max()) < POLISH_TOL, float(err.max())


def _degenerate(dev, case):
    """Hypotheses (and a polish) all on slots 0-5, made degenerate: points
    at z = 0 or ~1e-12 in the camera (the Jacobians overflow, so no step is
    finite), a NaN point (the normal equations are NaN), or a NaN warm
    start (the even hypotheses start and stay NaN)."""
    d = pnp_scene(dev, 1, 64, 8, 6, KITTI_K, seed=5)
    d["pose0"][:, :3] = 0.0
    d["idx"] = torch.arange(6, device=dev).expand(1, 8, 6).contiguous()
    if case in ("z0", "z_tiny"):
        d["pose0"][:, 3:] = 0.0
        d["X"][0, :6, 2] = 0.0 if case == "z0" else 1e-12
    elif case == "nan_point":
        d["X"][0, 3] = float("nan")
    else:
        d["pose0"][:] = float("nan")
    d["w"] = (torch.arange(64, device=dev) < 6).to(torch.float32)[None]
    d["polish"] = d["pose0"].clone()
    return d


@pytest.mark.parametrize("case", ["z0", "z_tiny", "nan_point", "nan_start"])
def test_pnp_kernels_leave_degenerate_poses_where_plain_does(cuda_device,
                                                             case):
    """On a degenerate sample no step is taken, by either kernel or by the
    plain twin: the pose comes back where it started, bit for bit the plain
    twin's; a NaN start stays NaN (the odd hypotheses, started from the
    identity, then move as the plain twin's do: finite)."""
    d = _degenerate(cuda_device, case)
    hyp = (d["pose0"], d["X"], d["x"], d["idx"], d["K"], 6)
    pol = (d["polish"], d["X"], d["x"], d["w"], d["K"], 12)
    for got, plain in ((pnp.refine_hypotheses(*hyp),
                        pnp._refine_hypotheses_plain(*hyp)),
                       (pnp.refine_polish(*pol), pnp._gn_refine(*pol))):
        even = (torch.arange(got.shape[0], device=cuda_device) % 2 == 0)
        start = torch.where(even[:, None], d["pose0"], 0.0)
        if case == "nan_start":
            for side in (got, plain):
                assert torch.equal(torch.isnan(side).all(-1), even)
                assert bool(torch.isfinite(side[~even]).all())
            got, plain, start = got[even], plain[even], start[even]
        assert torch.allclose(got, plain, rtol=0, atol=0, equal_nan=True), (
            got, plain)
        assert torch.allclose(got, start, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("kind", ["small", "generic", "near_pi"])
def test_pnp_kernel_rodrigues_round_trip_matches_plain(cuda_device, kind):
    """With no iteration a pose is its Rodrigues round trip, through the
    log map's near-pi branch where theta is within 1e-3 of pi; relative to
    1 + |w|, 1e-5 off pi and 2e-3 near it, where the log map is
    ill-conditioned (d theta ~ dR / sin theta), as the CPU tests hold the
    port to the JAX package."""
    rng = np.random.default_rng(4)
    axis = rng.normal(size=(64, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    angle = {"small": rng.uniform(0, 1e-5, 64),
             "generic": rng.uniform(0.01, 3.0, 64),
             "near_pi": np.pi - rng.uniform(0, 5e-4, 64)}[kind]
    pose = np.concatenate([axis * angle[:, None], rng.normal(size=(64, 3))],
                          axis=-1)
    pose = torch.tensor(pose, dtype=torch.float32, device=cuda_device)
    d = pnp_scene(cuda_device, 64, 1, 1, 1, KITTI_K, seed=6)
    args = (pose, d["X"], d["x"], d["w"], d["K"], 0)
    got, plain = pnp.refine_polish(*args), pnp._gn_refine(*args)
    tol = 2e-3 if kind == "near_pi" else 1e-5
    assert float(((got - plain).abs() / (1.0 + plain.abs())).max()) < tol
    assert torch.equal(got[:, 3:], pose[:, 3:])
    if kind == "near_pi":
        trip = rodrigues_inverse(rodrigues(pose[:, :3]))
        assert bool((trip.norm(dim=-1) > np.pi - 1e-3).all())


def test_pnp_graph_replay_equals_eager_launch(cuda_device):
    """Both launches captured in one CUDA graph: a replay gives the eager
    launches' poses bit for bit (the polish sums in a fixed order)."""
    d = pnp_scene(cuda_device, 11, 384, 500, 6, KITTI_K, seed=11)
    hyp = (d["pose0"], d["X"], d["x"], d["idx"], d["K"], 6)
    pol = (d["polish"], d["X"], d["x"], d["w"], d["K"], 12)
    eager = (pnp.refine_hypotheses(*hyp), pnp.refine_polish(*pol))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        pnp.refine_hypotheses(*hyp)
        pnp.refine_polish(*pol)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = (pnp.refine_hypotheses(*hyp), pnp.refine_polish(*pol))
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(eager, captured))


def test_pnp_ransac_launches_each_kernel_once(cuda_device):
    """A ``pnp_ransac`` call on the card, single or batched, is one launch
    of each kernel and never the plain twin."""
    d = pnp_scene(cuda_device, 3, 384, 500, 6, KITTI_K, seed=3)
    before = (pnp.refine_hypotheses.launches, pnp.refine_polish.launches)
    zero3 = torch.zeros(3, device=cuda_device)
    gens = [torch.Generator(device=cuda_device).manual_seed(b)
            for b in range(3)]
    single = pnp.pnp_ransac(d["X"][0], d["x"][0], d["valid"][0], d["K"],
                            zero3, d["pose0"][0, 3:], generator=gens[0],
                            refine_iters=6)
    batched = pnp.pnp_ransac(d["X"], d["x"], d["valid"], d["K"], zero3,
                             d["pose0"][:, 3:], generator=gens,
                             refine_iters=6)
    torch.cuda.synchronize()
    assert (pnp.refine_hypotheses.launches - before[0],
            pnp.refine_polish.launches - before[1]) == (2, 2)
    assert int(single.num_inliers) > 100
    assert bool((batched.num_inliers > 100).all())


def test_pnp_kernels_on_another_card(cuda_device):
    """Operands on a card other than the current one launch there, with the
    results of the same launches on the first card."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    outs = []
    for dev in (torch.device("cuda", 0), torch.device("cuda", 1)):
        d = pnp_scene(dev, 11, 384, 500, 6, KITTI_K, seed=11)
        outs.append((pnp.refine_hypotheses(d["pose0"], d["X"], d["x"],
                                           d["idx"], d["K"], 6),
                     pnp.refine_polish(d["polish"], d["X"], d["x"], d["w"],
                                       d["K"], 12)))
        assert outs[-1][0].device == dev
    torch.cuda.synchronize(0)
    torch.cuda.synchronize(1)
    assert all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(*outs))


class _Flaky:
    def __init__(self, frames, crash_at):
        self.frames, self.crash_at, self.armed = frames, crash_at, True

    def __len__(self):
        return len(self.frames)

    def frame(self, i):
        if self.armed and i >= self.crash_at:
            self.armed = False
            raise RuntimeError("injected decode failure")
        return self.frames[i]


@pytest.mark.parametrize("tracks", [False, True], ids=["outputs", "tracks"])
def test_scan_resume_on_card_is_bitwise(cuda_device, tmp_path, tracks):
    """Mono rotation, crash at frame 14 (last snapshot at step 8: chunk 4,
    every 8),
    resume: poses, outputs (and track snapshots) equal the uninterrupted
    run's bit for bit, and ``run_sequence_scan``'s at the same chunk."""
    # mono: two draws a frame, so the restored generator must stand
    # after both draws of the snapshot's last frame
    intr, cfg, frames = _small("mono", frames=21)
    kw = dict(checkpoint_every=8, chunk=4, collect_tracks=tracks,
              device=cuda_device)
    ref = pipeline.run_sequence_scan(iter(frames), cfg, intr, chunk=4,
                                     collect_tracks=tracks, device=cuda_device)
    ck = str(tmp_path / "ck.npz")
    with pytest.raises(RuntimeError, match="injected"):
        pipeline.run_sequence_scan_resumable(_Flaky(frames, 14), cfg, intr,
                                             ck, **kw)
    got = pipeline.run_sequence_scan_resumable(_Flaky(frames, 99), cfg, intr,
                                               ck, **kw)
    assert got[3] == 12
    np.testing.assert_array_equal(got[0], ref[0])
    for a, b in zip(got[1], ref[1]):
        np.testing.assert_array_equal(a, b)
    if tracks:
        for sa, sb in zip(got[4], ref[4]):
            for a, b in zip(sa, sb):
                np.testing.assert_array_equal(a, b)


# --- the front doors on the card --------------------------------------------

#: the doors ``run_sequence_scan`` must equal, bit for bit, on one device
DOORS = ("run_sequence", "visual_odometry", "resumable", "buffered",
         "buffered_streamed", "scan_preupload", "scan_threads2",
         "scan_resumable_threads2")


def _door_poses(door, frames, cfg, intr, dev, tmp_path):
    if door == "run_sequence":
        return pipeline.run_sequence(iter(frames), cfg, intr, device=dev)[0]
    if door == "visual_odometry":
        vo = pipeline.VisualOdometry(cfg, intr, device=dev)
        vo.initialize(*frames[0])
        return np.stack([np.eye(4)] + [vo.process_frame(*f).pose
                                       for f in frames[1:]])
    if door == "resumable":
        return pipeline.run_sequence_resumable(
            _Flaky(frames, 99), cfg, intr, str(tmp_path / "vo.npz"),
            checkpoint_every=3, device=dev)[0]
    if door.startswith("buffered"):
        return pipeline.run_sequence_buffered(
            frames, cfg, intr, preupload=door == "buffered", device=dev)[0]
    if door == "scan_resumable_threads2":
        return pipeline.run_sequence_scan_resumable(
            _Flaky(frames, 99), cfg, intr, str(tmp_path / "scan.npz"),
            checkpoint_every=4, chunk=2, upload_threads=2, device=dev)[0]
    return pipeline.run_sequence_scan(
        frames, cfg, intr, chunk=2, preupload=door == "scan_preupload",
        upload_threads=2, device=dev)[0]


@pytest.mark.parametrize("door", DOORS)
def test_door_equals_scan_on_card(cuda_device, tmp_path, door):
    """Every front door steps the same ``make_step_fn`` with the same draws:
    its poses equal ``run_sequence_scan``'s bit for bit on the card."""
    intr, _, frames = _small("mono", frames=9)
    cfg = VOConfig.for_image(120, 160, ransac_iterations=200)   # default
    ref = pipeline.run_sequence_scan(frames, cfg, intr, chunk=4,
                                     device=cuda_device)[0]
    got = _door_poses(door, frames, cfg, intr, cuda_device, tmp_path)
    np.testing.assert_array_equal(got, ref)


def test_vo_snapshot_on_card_resumes_bitwise(cuda_device, tmp_path):
    """A ``VisualOdometry`` snapshot taken on the card (mono: two draws a
    frame from the card's generator) resumes on the card bit for bit."""
    intr, cfg, frames = _small("mono", frames=9)
    kw = dict(checkpoint_every=3, device=cuda_device)
    full, _ = pipeline.run_sequence_resumable(_Flaky(frames, 99), cfg, intr,
                                              str(tmp_path / "full.npz"),
                                              **kw)
    ck = str(tmp_path / "crash.npz")
    with pytest.raises(RuntimeError, match="injected"):
        pipeline.run_sequence_resumable(_Flaky(frames, 7), cfg, intr, ck,
                                        **kw)
    got, results = pipeline.run_sequence_resumable(_Flaky(frames, 99), cfg,
                                                   intr, ck, **kw)
    assert [r.frame_id for r in results] == [7, 8]
    np.testing.assert_array_equal(got, full)


def test_buffered_step_and_uploaded_chunk_never_wait(cuda_device):
    """A buffered step, and a scan chunk fed by two upload threads, under
    sync-debug "error": neither waits for the card. (Each uploader thread
    waits for its own copies on an event, which the debug mode does not
    count.)"""
    intr, _, frames = _small("mono", frames=9)
    cfg = VOConfig.for_image(120, 160, ransac_iterations=200)   # default
    step = pipeline.make_buffered_step_fn(cfg, intr, device=cuda_device)
    scan_chunk = pipeline.make_scan_step_fn(cfg, intr, device=cuda_device)
    st = pipeline.init_vo_state(cfg, intr, *frames[0], device=cuda_device)
    bufs = pipeline.make_output_buffers(2, device=cuda_device)
    up = [tuple(torch.from_numpy(x).to(cuda_device) for x in f)
          for f in frames[1:3]]
    st, bufs = step(st, *up[0], bufs)      # first use: kernel build and load
    torch.cuda.synchronize()
    chunks = pipeline._frame_chunks(iter(frames[3:]), 2)
    uploader = pipeline._ParallelChunkUploader(chunks, cuda_device, threads=2)
    torch.cuda.set_sync_debug_mode("error")
    try:
        st, bufs = step(st, *up[1], bufs)
        n = 0
        for dl, dr, k in iter(uploader.get, None):
            st, out = scan_chunk(st, pipeline._on_current_stream(dl),
                                 pipeline._on_current_stream(dr))
            n += k
    finally:
        torch.cuda.set_sync_debug_mode("default")
    uploader.finish()
    assert n == 6 and bufs.idx.tolist() == [2]
    assert bool(torch.isfinite(out.T_inv).all())


# --- KITTI input and the restartable batched runner on the card ------------


def _png(path, img):
    """An 8-bit grayscale PNG written with the standard library alone."""
    import struct
    import zlib

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    h, w = img.shape
    raw = b"".join(b"\0" + img[r].tobytes() for r in range(h))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 1)) + chunk(b"IEND", b""))


def _batch(frames=13):
    intr = CameraIntrinsics(**SMALL)
    cfg = VOConfig.for_image(120, 160, ransac_iterations=200)
    seqs = [SyntheticStereoSequence(intr, num_frames=frames, seed=s,
                                    speed=0.5) for s in (0, 1)]
    return intr, cfg, [[q.frame(i) for i in range(frames)] for q in seqs]


def test_batched_resume_on_card_is_bitwise(cuda_device, tmp_path):
    """Two sequences, chunk 2, a snapshot every 4 steps, a failure at frame
    7 (last snapshot at step 4): the resumed poses and stats equal the
    uninterrupted run's bit for bit; a CPU run refuses the card's
    snapshot (its generators' states are the card's) and starts fresh."""
    from visual_odom_tpu_torch.parallel.batch_eval import run_sequences_batched
    from visual_odom_tpu_torch.utils.checkpoint import (CorruptCheckpoint,
                                                        load_batch_checkpoint)

    intr, cfg, seqs = _batch()
    kw = dict(chunk=2, checkpoint_every=4, device=cuda_device)
    ref = run_sequences_batched(seqs, cfg, intr, chunk=2, device=cuda_device)
    ck = str(tmp_path / "batch.npz")
    with pytest.raises(RuntimeError, match="injected"):
        run_sequences_batched([_Flaky(seqs[0], 7), seqs[1]], cfg, intr,
                              checkpoint_path=ck, **kw)
    snap = load_batch_checkpoint(ck, batch=2, device=cuda_device)
    assert int(snap["frames_done"]) == 4 and snap["gen_state"].shape == (2, 16)
    got = run_sequences_batched(seqs, cfg, intr, checkpoint_path=ck, **kw)
    for a, b in zip(got[0], ref[0]):
        np.testing.assert_array_equal(a, b)
    assert got[1] == ref[1]
    with pytest.raises(CorruptCheckpoint, match="taken on cuda, run on cpu"):
        load_batch_checkpoint(ck, batch=2, device="cpu")


def test_card_batch_snapshot_refused_by_cpu_run(cuda_device, tmp_path,
                                                capsys):
    """A CPU run given the card's snapshot warns that it was taken on the
    card and starts fresh: its poses equal a fresh CPU run's."""
    from visual_odom_tpu_torch.parallel.batch_eval import run_sequences_batched

    intr, cfg, seqs = _batch(frames=5)
    ck = str(tmp_path / "batch.npz")
    run_sequences_batched(seqs, cfg, intr, chunk=2, checkpoint_path=ck,
                          checkpoint_every=2, device=cuda_device)
    assert os.path.exists(ck)
    capsys.readouterr()
    got = run_sequences_batched(seqs, cfg, intr, chunk=2, checkpoint_path=ck,
                                checkpoint_every=2, device="cpu")
    assert "taken on cuda, run on cpu" in capsys.readouterr().err
    fresh = run_sequences_batched(seqs, cfg, intr, chunk=2, device="cpu")
    for a, b in zip(got[0], fresh[0]):
        np.testing.assert_array_equal(a, b)


def test_batched_chunks_between_snapshots_never_wait(cuda_device, tmp_path,
                                                     monkeypatch):
    """Every chunk of a restartable batched run is stepped under sync-debug
    "error" (the snapshots' fetches, outside the chunks, are the run's only
    waits), and the run equals an unchecked one bit for bit."""
    from visual_odom_tpu_torch.parallel import batch_eval

    intr, cfg, seqs = _batch()
    ref = batch_eval.run_sequences_batched(seqs, cfg, intr, chunk=2,
                                           device=cuda_device)
    real = batch_eval.make_batched_scan_fn
    strict_calls = []

    def strict_scan_fn(*args, **kwargs):
        scan = real(*args, **kwargs)

        def strict(state, lefts, rights):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return scan(state, lefts, rights)
            finally:
                torch.cuda.set_sync_debug_mode("default")
                strict_calls.append(lefts.shape[0])

        return strict

    monkeypatch.setattr(batch_eval, "make_batched_scan_fn", strict_scan_fn)
    stats = []
    got = batch_eval.run_sequences_batched(
        seqs, cfg, intr, chunk=2, checkpoint_path=str(tmp_path / "b.npz"),
        checkpoint_every=4, snapshot_stats=stats, device=cuda_device)
    assert strict_calls == [2] * 6
    assert [s["step"] for s in stats] == [4, 8]
    for a, b in zip(got[0], ref[0]):
        np.testing.assert_array_equal(a, b)


def test_kitti_stream_on_card_equals_scan(cuda_device, tmp_path):
    """A KITTI directory of PNGs, decoded by the native prefetcher and
    uploaded by two threads, gives ``run_sequence_scan`` the in-memory
    scan's poses and outputs bit for bit."""
    from visual_odom_tpu_torch.io import native
    from visual_odom_tpu_torch.io.kitti import KittiSequence

    assert native.available(), "the native runtime did not build"
    intr, _, frames = _small("mono", frames=9)
    cfg = VOConfig.for_image(120, 160, ransac_iterations=200)   # default
    for side, d in enumerate(("image_0", "image_1")):
        os.makedirs(tmp_path / d)
        for i, pair in enumerate(frames):
            _png(str(tmp_path / d / f"{i:06d}.png"), pair[side])
    ref = pipeline.run_sequence_scan(frames, cfg, intr, chunk=4,
                                     device=cuda_device)
    seq = KittiSequence(str(tmp_path))
    got = pipeline.run_sequence_scan(seq.iter_prefetched(n_threads=2), cfg,
                                     intr, chunk=4, upload_threads=2,
                                     device=cuda_device)
    assert got[3] == ref[3] == 8
    np.testing.assert_array_equal(got[0], ref[0])
    for a, b in zip(got[1], ref[1]):
        np.testing.assert_array_equal(a, b)


# --- the pipelined runner and the command line on the card ----------------


@pytest.mark.parametrize("route", ["pallas", "xla"])
@pytest.mark.parametrize("mode", ["default", "mono"])
def test_pipe_on_one_card_equals_scan(cuda_device, monkeypatch, route, mode):
    """The two stages on two streams of one card: every output equals the
    scan's bit for bit (``num_bucketed`` is ``num_matched``, as in the JAX
    package's pipe), and the whole loop runs under sync-debug "error": no
    host sync between its first upload and its last backend stage."""
    from visual_odom_tpu_torch.parallel import pipe

    intr, _, frames = _small("mono", frames=9)
    cfg = VOConfig.for_image(120, 160, ransac_iterations=200,
                             mono_rotation=mode == "mono", lk_backend=route)
    ref = pipeline.run_sequence_scan(frames, cfg, intr, chunk=4,
                                     device=cuda_device)
    real = pipe._pipeline_loop
    strict = []

    def strict_loop(*args, **kwargs):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return real(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode("default")
            strict.append(True)

    monkeypatch.setattr(pipe, "_pipeline_loop", strict_loop)
    poses, out, wall = pipe.run_sequence_pipelined(
        frames, cfg, intr, devices=[cuda_device, cuda_device])
    assert strict == [True] and wall > 0
    np.testing.assert_array_equal(poses, ref[0])
    for field in out._fields:
        want = getattr(ref[1], "num_matched" if field == "num_bucketed"
                       else field)
        np.testing.assert_array_equal(getattr(out, field), want,
                                      err_msg=field)


def test_pipe_across_two_cards_equals_scan(cuda_device):
    """Frontend on card 0, backend on card 1 (the packet copied between
    them, ordered by both stages' streams): the outputs equal the scan's on
    card 0 bit for bit, but ``num_bucketed``; skips with fewer than two
    cards."""
    from visual_odom_tpu_torch.parallel import pipe

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    intr, _, frames = _small("mono", frames=9)
    cfg = VOConfig.for_image(120, 160, ransac_iterations=200)
    ref = pipeline.run_sequence_scan(frames, cfg, intr, chunk=4,
                                     device="cuda:0")
    poses, out, _ = pipe.run_sequence_pipelined(frames, cfg, intr)
    np.testing.assert_array_equal(poses, ref[0])
    for field in out._fields:
        want = getattr(ref[1], "num_matched" if field == "num_bucketed"
                       else field)
        np.testing.assert_array_equal(getattr(out, field), want,
                                      err_msg=field)


def test_pipe_with_one_visible_card_raises(cuda_device, monkeypatch):
    from visual_odom_tpu_torch.parallel import pipe

    intr, cfg, frames = _small("mono")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="needs two devices"):
        pipe.run_sequence_pipelined(frames, cfg, intr)


def test_cli_chunked_run_on_card_equals_scan(cuda_device, tmp_path):
    """``run synthetic --chunk 8`` on the card (the default ``--device``)
    writes ``run_sequence_scan``'s poses."""
    from visual_odom_tpu_torch.io.kitti import load_poses, save_poses_kitti
    from visual_odom_tpu_torch.runner import cli

    calib = tmp_path / "calib.yaml"
    calib.write_text("%YAML:1.0\n" + "".join(
        f"Camera.{k}: {v!r}\n" for k, v in SMALL.items()))
    out = tmp_path / "poses.txt"
    assert cli.main(["run", "synthetic", str(calib), "--max-frames", "17",
                     "--chunk", "8", "--quiet", "--output", str(out)]) == 0
    intr = CameraIntrinsics(**SMALL)
    seq = SyntheticStereoSequence(intr, num_frames=17)
    ref = pipeline.run_sequence_scan(iter(seq), VOConfig.for_image(120, 160),
                                     intr, chunk=8, device=cuda_device)
    ref_file = tmp_path / "ref.txt"
    save_poses_kitti(str(ref_file), ref[0])
    assert out.read_bytes() == ref_file.read_bytes()
    assert load_poses(str(out)).shape == (17, 4, 4)


# ---- the multi-device paths (parallel/) ----------------------------------------


def _cards(n):
    """The first ``n`` cards; skips with fewer visible."""
    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA devices")
    return [torch.device("cuda", i) for i in range(n)]


def _ring_problem(dev, num_poses=16):
    return problem.synthetic_ba_problem(
        num_poses=num_poses, num_landmarks=128, pixel_noise=0.2,
        pose_perturb=0.015, landmark_perturb=0.08, seed=3, obs_window=1,
        device=dev)[0]


def test_sharded_ba_and_ring_on_one_card(cuda_device):
    """Four landmark shards and a four-window ring, each on ``cuda:0``
    named four times, against ``ba_solve`` on the card (poses 1e-4,
    landmarks 1e-3; tests/test_parallel.py:32-37, test_ring_ba.py:71)."""
    from visual_odom_tpu_torch.parallel.mesh import make_mesh
    from visual_odom_tpu_torch.parallel.ring_ba import ring_ba_solve
    from visual_odom_tpu_torch.parallel.sharded_ba import sharded_ba_solve

    dev = torch.device("cuda", 0)
    p = problem.synthetic_ba_problem(num_poses=8, num_landmarks=256, seed=7,
                                     device=dev)[0]
    ref = schur.ba_solve(p, iterations=4)
    got = sharded_ba_solve(p, make_mesh({"data": 1, "model": 4},
                                        devices=[dev] * 4), iterations=4)
    assert float((got.poses - ref.poses).abs().max()) < 1e-4
    assert float((got.landmarks - ref.landmarks).abs().max()) < 1e-3
    p = _ring_problem(dev)
    ref = schur.ba_solve(p, iterations=10)
    got = ring_ba_solve(p, make_mesh({"seq": 4}, devices=[dev] * 4), halo=2,
                        rounds=10)
    assert float((got.poses - ref.poses).abs().max()) < 1e-4
    assert torch.equal(got.poses[0], p.poses[0])


@pytest.mark.parametrize("n", [2, 4])
def test_ring_across_cards_matches_ba_solve(cuda_device, n):
    """The ring over ``n`` cards, its halos and sums copied between them."""
    from visual_odom_tpu_torch.parallel.mesh import make_mesh
    from visual_odom_tpu_torch.parallel.ring_ba import ring_ba_solve

    cards = _cards(n)
    p = _ring_problem(cards[0])
    ref = schur.ba_solve(p, iterations=10)
    got = ring_ba_solve(p, make_mesh({"seq": n}, devices=cards), halo=2,
                        rounds=10)
    assert got.poses.device == cards[0]
    assert float((got.poses - ref.poses).abs().max()) < 1e-4


def _mesh_run(cfg, intr, frames, mesh=None, device=None, seed=0):
    from visual_odom_tpu_torch.parallel.batch_eval import run_sequences_batched

    return run_sequences_batched(frames, cfg, intr, chunk=4, mesh=mesh,
                                 device=device, seed=seed)


def _row_runs(cfg, intr, frames, rows, dev):
    """The one-device runs of each data row's sequences, seeded as the row
    seeds them: a mesh's reference (cuBLAS picks its kernels by batch
    size, so a row of 2 is not bit for bit the same rows of a batch of 3
    or 4)."""
    from visual_odom_tpu_torch.parallel.mesh import split_ranges

    return [p for a, b in split_ranges(len(frames), rows)
            for p in _mesh_run(cfg, intr, frames[a:b], device=dev,
                               seed=a)[0]]


def test_batch_mesh_on_one_card_never_waits(cuda_device, monkeypatch):
    """A (2, 2) mesh of ``cuda:0`` named four times over three sequences:
    every chunk stepped under sync-debug "error", each row's quads split
    into two launches, the poses of its rows' one-device runs bit for
    bit."""
    from visual_odom_tpu_torch.parallel import batch_eval
    from visual_odom_tpu_torch.parallel.mesh import make_mesh

    dev = torch.device("cuda", 0)
    intr, cfg, frames = _batch(frames=9)
    frames = frames + [frames[0]]
    ref = _row_runs(cfg, intr, frames, 2, dev)
    real = batch_eval.make_batched_scan_fn
    strict = []

    def strict_scan_fn(*args, **kwargs):
        scan = real(*args, **kwargs)

        def run(state, lefts, rights):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return scan(state, lefts, rights)
            finally:
                torch.cuda.set_sync_debug_mode("default")
                strict.append(lefts.shape[0])

        return run

    monkeypatch.setattr(batch_eval, "make_batched_scan_fn", strict_scan_fn)
    before = lk_cuda.lk_circular_quad.batched_launches
    got = _mesh_run(cfg, intr, frames, mesh=make_mesh(
        {"data": 2, "model": 2}, devices=[dev] * 4))
    assert strict == [4, 4]
    assert lk_cuda.lk_circular_quad.batched_launches - before == 3 * 4 * 8
    for a, b in zip(got[0], ref):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shape, route", [((2, 1), "pallas"),
                                          ((2, 2), "pallas"),
                                          ((2, 1), "xla")],
                         ids=["2x1", "2x2", "2x1-xla"])
def test_batch_mesh_across_cards_equals_row_runs(cuda_device, shape, route):
    """Two data rows (and two model columns) on separate cards, so the LK
    kernels launch on cards other than the current one: the poses of each
    row's one-device run on card 0, bit for bit."""
    import dataclasses

    from visual_odom_tpu_torch.parallel.mesh import make_mesh

    cards = _cards(shape[0] * shape[1])
    intr, cfg, frames = _batch(frames=9)
    cfg = dataclasses.replace(cfg, lk_backend=route)
    ref = _row_runs(cfg, intr, frames, shape[0], cards[0])
    got = _mesh_run(cfg, intr, frames, mesh=make_mesh(
        {"data": shape[0], "model": shape[1]}, devices=cards))
    for a, b in zip(got[0], ref):
        np.testing.assert_array_equal(a, b)


def test_sharded_posegraph_across_two_cards(cuda_device):
    """The drifted-circle graph edge-sharded over two cards against the
    one-card solve (2e-4, tests/test_posegraph.py:106); ``close_loops``'s
    solve takes the same path with ``mesh=``."""
    from visual_odom_tpu_torch.parallel.mesh import make_mesh

    cards = _cards(2)
    n = 40
    th = 2 * np.pi * np.arange(n) / n
    truth = np.tile(np.eye(4), (n, 1, 1))
    truth[:, 0, 0] = truth[:, 2, 2] = np.cos(th)
    truth[:, 0, 2], truth[:, 2, 0] = np.sin(th), -np.sin(th)
    truth[:, 0, 3], truth[:, 2, 3] = 10 * np.sin(th), 10 * (1 - np.cos(th))
    rng = np.random.default_rng(3)
    est = truth.copy()
    est[:, :3, 3] += np.cumsum(rng.normal(0, 0.02, (n, 3)), axis=0)
    graph = posegraph.build_keyframe_graph(
        est, np.arange(n), [(0, n - 1, np.linalg.inv(truth[0]) @ truth[-1],
                             10.0)], device=cards[0])
    ref = posegraph.posegraph_solve(graph, iterations=8).nodes
    got = posegraph.sharded_posegraph_solve(
        graph, make_mesh({"model": 2}, devices=cards), iterations=8).nodes
    assert got.device == cards[0]
    assert float((got - ref).abs().max()) < NODE_TOL


# ---- the same paths across processes: one rank per card over NCCL ------------


def _worker():
    """tests/torch_dist_worker.py, which runs each rank and spawns them."""
    import torch_dist_worker

    return torch_dist_worker


def _cpu(x):
    if isinstance(x, dict):
        return {k: _cpu(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_cpu(v) for v in x]
    return x.cpu() if isinstance(x, torch.Tensor) else x


def _same(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    return a == b


@pytest.mark.parametrize("n", [2, 4])
def test_solvers_across_cards_over_nccl_ranks(cuda_device, tmp_path, n):
    """One rank per card over NCCL: the LK quad and leg with their slots
    split over the ranks, ``sharded_ba_solve`` (on a (1, n) and a (2, n/2)
    mesh), ``ring_ba_solve`` (halo 2; auto halo, Huber) and
    ``sharded_posegraph_solve``: every rank's result equals the one-process
    run over the same cards bit for bit (the split LK launches also the
    unsplit call's)."""
    wk = _worker()
    cards = _cards(n)

    def one_process():
        return _cpu({"lk": wk.run_lk(cards, device=cards[0]),
                     "lk_unsplit": wk.run_lk(None, device=cards[0]),
                     **wk.run_solvers(cards, n)})

    ranks, ref = wk.run_ranks("card_core", n, str(tmp_path),
                              during=one_process)
    assert _same(ref["lk"], ref["lk_unsplit"])
    for res in ranks:
        assert res.keys() == ref.keys() - {"lk_unsplit"}
        for key in res:
            assert _same(_cpu(res[key]), ref[key]), key


@pytest.mark.parametrize("n", [2, 4])
def test_batch_mesh_across_cards_over_nccl_ranks(cuda_device, tmp_path, n):
    """``run_sequences_batched`` with one rank per card over NCCL, on
    (2, 1) and (1, 2) meshes of 2 ranks or a (2, 2) mesh of 4, both LK
    routes: every rank's poses equal the one-process mesh run over the
    same cards bit for bit."""
    from visual_odom_tpu_torch.parallel.batch_eval import (
        run_sequences_batched)
    from visual_odom_tpu_torch.parallel.mesh import make_mesh

    wk = _worker()
    cards = _cards(n)
    seqs = wk.batch_sequences()

    def one_process():
        out = {}
        for shape in wk.CARD_MESHES[n]:
            for route in wk.ROUTES:
                poses, _, _ = run_sequences_batched(
                    seqs, wk.batch_config(route),
                    CameraIntrinsics(**wk.INTR), seed=1,
                    chunk=wk.BATCH_CHUNK, mesh=make_mesh(
                        {"data": shape[0], "model": shape[1]},
                        devices=cards))
                out[f"{shape[0]}x{shape[1]}_{route}"] = poses
        return out

    ranks, ref = wk.run_ranks("card_batch", n, str(tmp_path),
                              during=one_process)
    for res in ranks:
        assert res["runs"].keys() == ref.keys()
        for key, want in ref.items():
            got = [p.numpy() for p in res["runs"][key]["poses"]]
            assert _same(got, want), key
