"""The per-leg LK route on the CPU: ``ops.lk.lk_track_pyramid`` over the
plain version of the level kernel, ``circular_match(backend="xla")`` and the
step on ``lk_backend="xla"``.

The JAX side runs on the CPU as its own tests run it: the Pallas per-leg
tracker in interpret mode (as tests/test_lk_pallas.py does) and the XLA
``lk_track_pyramid`` with ``init_pts`` / ``start_level``. Against JAX the
tolerance is that of tests/test_lk_pallas.py: statuses equal, positions
within PT_TOL on tracked features. Against the port's own quad route the
rule is bit for bit: both routes run the same ``_template`` / ``_solve``
per level, and the glue between levels scales by powers of two. The level
kernel itself is held against its plain version on the card by
tests/test_torch_cuda.py and chip_smoke.py.

The per-leg route split over a mesh row's "model" devices (ROADMAP item
18d; ``slot_devices=["cpu"] * 2`` and ``* 3``, an uneven split): each leg,
and the circular match on the "xla" route, equals the unsplit leg and the
quad route bit for bit.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from conftest import make_textured_image, warp_translate
from visual_odom_tpu.frontend.featureset import FeatureState as JFeatureState
from visual_odom_tpu.frontend.matching import circular_match as jax_circular
from visual_odom_tpu.ops.lk import LKParams as JLKParams
from visual_odom_tpu.ops.lk import lk_track_pyramid as jax_leg
from visual_odom_tpu.ops.lk import prepare_lk_image as jax_prepare
from visual_odom_tpu.ops.lk_pallas import lk_track_pyramid_pallas
from visual_odom_tpu_torch.config import CameraIntrinsics, VOConfig
from visual_odom_tpu_torch.frontend.featureset import FeatureState
from visual_odom_tpu_torch.frontend.matching import circular_match
from visual_odom_tpu_torch.io.synthetic import SyntheticStereoSequence
from visual_odom_tpu_torch.ops import lk_cuda
from visual_odom_tpu_torch.ops import LKParams, lk_track, lk_track_pyramid
from visual_odom_tpu_torch.ops.lk import LKImage
from visual_odom_tpu_torch.parallel import batch
from visual_odom_tpu_torch.runner import pipeline

# Small tensors: one intra-op thread each keeps the parallel test workers
# from oversubscribing the cores.
torch.set_num_threads(1)

#: |delta pt| bound on tracks whose status agrees (px)
PT_TOL = 1e-3
SHIFT = (2.7, -1.9)


def to_port_image(im) -> LKImage:
    """JAX LKImage -> port LKImage on the same planes."""
    return LKImage(tuple(torch.tensor(np.asarray(p)) for p in im.pyramid),
                   im.shapes, im.pad)


def _leg_case(seed):
    """I, J = a texture and its SHIFT translation (JAX images), 64 features
    (4 invalid) and seeds within +-1.5 px."""
    img0 = make_textured_image(240, 320, seed=seed)
    img1 = warp_translate(img0, *SHIFT)
    li = jax_prepare(jnp.asarray(img0), JLKParams())
    lj = jax_prepare(jnp.asarray(img1), JLKParams())
    rng = np.random.default_rng(seed - 31)
    pts = np.stack([rng.uniform(30, 290, 64), rng.uniform(30, 210, 64)],
                   axis=1).astype(np.float32)
    valid = np.ones(64, bool)
    valid[-4:] = False
    flow = rng.uniform(-1.5, 1.5, (64, 2)).astype(np.float32)
    disp = rng.uniform(-1.5, 1.5, (64, 2)).astype(np.float32)
    return (img0, img1), (li, lj), pts, valid, flow, disp


@pytest.fixture(scope="module")
def leg_inputs():
    return _leg_case(31)


def _port_leg(li, lj, pts, valid, init=None, start_level=None):
    out = lk_track_pyramid(
        to_port_image(li), to_port_image(lj), torch.from_numpy(pts),
        torch.from_numpy(valid), LKParams(),
        init_pts=None if init is None else torch.from_numpy(init),
        start_level=start_level)
    return [o.numpy() for o in out]


def _assert_leg_close(got, ref):
    status = np.asarray(ref[1])
    np.testing.assert_array_equal(got[1], status)
    assert status.sum() > 40
    assert np.abs(got[0] - np.asarray(ref[0]))[status].max() < PT_TOL


def test_leg_matches_pallas_interpret(leg_inputs):
    """Default seeding (init = pts, from the pyramid top)."""
    _, (li, lj), pts, valid, _, _ = leg_inputs
    ref = lk_track_pyramid_pallas(li, lj, jnp.asarray(pts), jnp.asarray(valid),
                                  JLKParams(), interpret=True)
    _assert_leg_close(_port_leg(li, lj, pts, valid), ref)


@pytest.mark.parametrize("start_level", [1, 2, None])
def test_leg_matches_xla_seeded(leg_inputs, start_level):
    _, (li, lj), pts, valid, _, disp = leg_inputs
    init = pts + disp
    ref = jax_leg(li, lj, jnp.asarray(pts), jnp.asarray(valid), JLKParams(),
                  init_pts=jnp.asarray(init), start_level=start_level)
    _assert_leg_close(_port_leg(li, lj, pts, valid, init, start_level), ref)


def test_leg_invalid_passthrough(leg_inputs):
    _, (li, lj), pts, valid, _, disp = leg_inputs
    got, status = _port_leg(li, lj, pts, valid, pts + disp, 1)
    assert not status[~valid].any()
    np.testing.assert_array_equal(got[~valid], pts[~valid])


def test_cpu_tensors_take_the_plain_version(leg_inputs):
    _, (li, lj), pts, valid, _, _ = leg_inputs
    before = (lk_track_pyramid.launches,
              lk_track_pyramid.batched_launches)
    _port_leg(li, lj, pts, valid, start_level=2)
    assert before == (lk_track_pyramid.launches,
                      lk_track_pyramid.batched_launches)


def test_lk_track_recovers_translation(leg_inputs):
    (img0, img1), _, pts, _, _, _ = leg_inputs
    got, status = lk_track(torch.from_numpy(img0), torch.from_numpy(img1),
                           torch.from_numpy(pts))
    assert status.sum() > 50
    flow = (got - torch.from_numpy(pts))[status].numpy()
    assert np.all(np.median(np.abs(flow - np.float32(SHIFT)), axis=0) < 0.1)


def test_batched_leg_matches_vmapped_xla_and_single_legs(leg_inputs):
    """Two sequences: the batched plain leg against ``jax.vmap`` of the XLA
    leg, and bit for bit against the unbatched plain leg per sequence."""
    cases = [leg_inputs, _leg_case(32)]
    jimgs = [jax.tree.map(lambda *xs: jnp.stack(xs), *[c[1][k] for c in cases])
             for k in range(2)]
    pts, valid, disp = (np.stack([c[k] for c in cases]) for k in (2, 3, 5))
    init = pts + disp

    def leg(I, J, p, v, i):
        return jax_leg(I, J, p, v, JLKParams(), init_pts=i, start_level=2)

    ref = jax.vmap(leg)(*jimgs, *(jnp.asarray(x) for x in (pts, valid, init)))
    got = _port_leg(*jimgs, pts, valid, init, 2)
    assert got[0].shape == (2, 64, 2) and got[1].shape == (2, 64)
    _assert_leg_close(got, ref)
    for b, c in enumerate(cases):
        one = _port_leg(*c[1], pts[b], valid[b], init[b], 2)
        np.testing.assert_array_equal(got[0][b], one[0])
        np.testing.assert_array_equal(got[1][b], one[1])


def _feature_state(pts, valid, flow, disp, cls, as_array):
    """A FeatureState (JAX's or the port's, by ``cls``) of the leg inputs."""
    ids = np.arange(len(pts), dtype=np.int32)
    return cls(points=as_array(pts), ages=as_array(ids % 5),
               valid=as_array(valid), ids=as_array(ids),
               next_id=as_array(np.int32(len(pts))), flow=as_array(flow),
               disp=as_array(disp))


@pytest.mark.parametrize("start_level", [1, 2])
def test_circular_match_xla_matches_jax(leg_inputs, start_level):
    """The quad L0 = I, R0 = J, R1 = I, L1 = J, each leg seeded by its
    prior."""
    _, (li, lj), pts, valid, flow, disp = leg_inputs
    ref = jax_circular(li, lj, lj, li,
                       _feature_state(pts, valid, flow, disp, JFeatureState,
                                      jnp.asarray),
                       JLKParams(), 0.0, "xla", seeding=True,
                       seed_start_level=start_level)
    ti, tj = to_port_image(li), to_port_image(lj)
    got = circular_match(ti, tj, tj, ti,
                         _feature_state(pts, valid, flow, disp, FeatureState,
                                        torch.tensor),
                         LKParams(), 0.0, "xla", seeding=True,
                         seed_start_level=start_level)
    v = np.asarray(ref.valid)
    np.testing.assert_array_equal(got.valid.numpy(), v)
    assert v.sum() > 30
    for name in ("points_r0", "points_r1", "points_l1", "points_l0_return"):
        d = np.abs(getattr(got, name).numpy() - np.asarray(getattr(ref, name)))
        assert d[v].max() < PT_TOL, name


@pytest.mark.parametrize("start_level", [1, 2])
def test_chained_plain_legs_equal_plain_quad(leg_inputs, start_level):
    """Four legs seeded as circular_match seeds them give lk_quad_plain's
    positions and status bit for bit."""
    _, (li, lj), pts, valid, flow, disp = leg_inputs
    ti, tj = to_port_image(li), to_port_image(lj)
    p, v, f, d = (torch.from_numpy(x) for x in (pts, valid, flow, disp))
    outs, status = [], v
    for (I, J), init in zip(((ti, tj), (tj, ti), (ti, tj), (tj, ti)),
                            (lambda x: x + d, lambda x: x + f,
                             lambda x: x - d, lambda x: x - f)):
        p, s = lk_track_pyramid(I, J, p, v, LKParams(), init_pts=init(p),
                                start_level=start_level)
        outs.append(p)
        status = status & s
    quad, quad_status, _ = lk_cuda.lk_quad_plain(
        [ti.pyramid, tj.pyramid, ti.pyramid, tj.pyramid], ti.shapes, ti.pad,
        *(torch.from_numpy(x) for x in (pts, valid, flow, disp)), LKParams(),
        start_level)
    assert torch.equal(torch.stack(outs), quad)
    assert torch.equal(status, quad_status) and int(status.sum()) > 40


@pytest.mark.parametrize("model", [2, 3])
@pytest.mark.parametrize("start_level", [1, 2])
def test_split_leg_equals_unsplit_leg(leg_inputs, start_level, model):
    """The slots cut into ``model`` contiguous slices (64 slots: 32 + 32,
    or 22 + 21 + 21), each tracked through every level, gathered back:
    the unsplit leg bit for bit, single and batched."""
    _, (li, lj), pts, valid, flow, _ = leg_inputs
    ti, tj = to_port_image(li), to_port_image(lj)
    p, v, f = (torch.from_numpy(x) for x in (pts, valid, flow))
    before = lk_track_pyramid.launches
    for I, J, x, ok, init in ((ti, tj, p, v, p + f),
                              (*(im._replace(pyramid=tuple(
                                  torch.stack([q, q]) for q in im.pyramid))
                                 for im in (ti, tj)),
                               torch.stack([p, p + 0.25]),
                               torch.stack([v, v.flip(0)]),
                               torch.stack([p + f, p - f]))):
        ref = lk_track_pyramid(I, J, x, ok, LKParams(), init_pts=init,
                               start_level=start_level)
        got = lk_track_pyramid(I, J, x, ok, LKParams(), init_pts=init,
                               start_level=start_level,
                               slot_devices=[torch.device("cpu")] * model)
        assert int(ref[1].sum()) > 40
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
    # CPU tensors take the plain version: nothing counts as a launch
    assert lk_track_pyramid.launches == before


@pytest.mark.parametrize("model", [2, 3])
@pytest.mark.parametrize("start_level", [1, 2])
def test_split_xla_match_equals_quad_route(leg_inputs, start_level, model):
    """``circular_match`` on the "xla" route with its legs split over
    ``model`` devices equals the unsplit "xla" match and the "pallas"
    match (quad split the same way, and unsplit) bit for bit."""
    _, (li, lj), pts, valid, flow, disp = leg_inputs
    ti, tj = to_port_image(li), to_port_image(lj)
    feats = _feature_state(pts, valid, flow, disp, FeatureState,
                           torch.tensor)
    devs = [torch.device("cpu")] * model

    def match(backend, slot_devices):
        return circular_match(ti, tj, tj, ti, feats, LKParams(), 0.0,
                              backend, seeding=True,
                              seed_start_level=start_level,
                              slot_devices=slot_devices)

    ref = match("xla", None)
    assert int(ref.valid.sum()) > 30
    for got in (match("xla", devs), match("pallas", None),
                match("pallas", devs)):
        for a, b in zip(got, ref):
            assert torch.equal(a, b)


H, W = 120, 160
RANSAC = 100


def _small_course(n_seqs):
    intr = CameraIntrinsics(fx=120.0, fy=120.0, cx=W / 2, cy=H / 2,
                            bf=-120.0 * 0.54, width=W, height=H)
    frames = [[seq.frame(i) for i in range(4)] for seq in
              (SyntheticStereoSequence(intr, num_frames=4, seed=s, speed=0.5)
               for s in range(n_seqs))]
    return intr, frames


def _run_route(backend, intr, frames, batched):
    """Three steps on one route, fed draws made from one seed; returns the
    outputs and the final features."""
    cfg = VOConfig.for_image(H, W, ransac_iterations=RANSAC,
                             lk_backend=backend)
    rng = np.random.default_rng(5)
    step = pipeline.make_step_fn(cfg, intr, device="cpu")
    if batched:
        pairs = [tuple(np.stack([f[i][k] for f in frames]) for k in (0, 1))
                 for i in range(4)]
        st = batch.batched_init_state(cfg, *pairs[0], device="cpu")
        shape = (len(frames), RANSAC, cfg.padded_features)
    else:
        pairs = frames[0]
        st = pipeline.init_vo_state(cfg, intr, *pairs[0], device="cpu")
        shape = (RANSAC, cfg.padded_features)
    outs = []
    for i in range(1, 4):
        u = torch.from_numpy(rng.random(shape, dtype=np.float32))
        st, out = step(st, *(torch.from_numpy(x) for x in pairs[i]),
                       uniforms=u)
        outs.append(out)
    return outs, st.features


@pytest.mark.parametrize("n_seqs", [1, 2], ids=["single", "batched"])
def test_step_routes_equal(n_seqs):
    """The step on lk_backend="xla" equals the step on "pallas" bit for
    bit, single and for two sequences in lockstep."""
    intr, frames = _small_course(n_seqs)
    batched = n_seqs > 1
    ref, ref_feats = _run_route("pallas", intr, frames, batched)
    got, got_feats = _run_route("xla", intr, frames, batched)
    assert int(ref[-1].num_matched.sum()) > 30
    for r, g in zip(ref, got):
        for name, x in r._asdict().items():
            assert torch.equal(getattr(g, name), x), name
    for name, x in ref_feats._asdict().items():
        assert torch.equal(getattr(got_feats, name), x), name


def test_config_rejects_unknown_backend():
    with pytest.raises(ValueError, match="lk_backend"):
        VOConfig(lk_backend="bogus")
    assert VOConfig().resolved_lk_backend() == "pallas"
    assert VOConfig(lk_backend="xla").resolved_lk_backend() == "xla"
