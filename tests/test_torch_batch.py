"""The port's batched lockstep path (``parallel/batch.py``,
``parallel/batch_eval.py`` and the batched LK quad) on the CPU.

- (a) The plain batched quad against ``jax.vmap`` of the Pallas quad in
  interpret mode, which lowers through the batch-gridded kernel.
- (b) The port's batched step against the JAX package's
  ``make_batched_step_fn`` on a 2-sequence CPU mesh, the port fed each
  sequence's JAX draws.
- (c) Sequence b of a batched step against the port's single-sequence step
  seeded ``seed + b``.
- (d), (e) ``run_sequences_batched``: unequal lengths, and the chunked path
  against the per-frame path.
- (f) The batched entry points default to CUDA.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from conftest import make_textured_image, warp_translate
from visual_odom_tpu.config import CameraIntrinsics as JIntrinsics
from visual_odom_tpu.config import VOConfig as JVOConfig
from visual_odom_tpu.ops.lk import LKParams as JLKParams
from visual_odom_tpu.ops.lk import prepare_lk_image as jax_prepare
from visual_odom_tpu.ops.lk_pallas import lk_circular_quad_pallas
from visual_odom_tpu.parallel.batch import batched_init_state as jax_batched_init
from visual_odom_tpu.parallel.batch import make_batched_step_fn as jax_batched_step
from visual_odom_tpu.parallel.mesh import make_mesh
from visual_odom_tpu_torch.config import CameraIntrinsics, VOConfig
from visual_odom_tpu_torch.interop import state_from_numpy
from visual_odom_tpu_torch.io.synthetic import SyntheticStereoSequence
from visual_odom_tpu_torch.ops import lk_cuda
from visual_odom_tpu_torch.ops.lk import LKImage, LKParams
from visual_odom_tpu_torch.parallel import batch
from visual_odom_tpu_torch.parallel.batch_eval import run_sequences_batched
from visual_odom_tpu_torch.runner import pipeline

# Small tensors: one intra-op thread each keeps the parallel test workers
# from oversubscribing the cores.
torch.set_num_threads(1)

H, W = 120, 160
INTR = dict(fx=120.0, fy=120.0, cx=W / 2, cy=H / 2, bf=-120.0 * 0.54,
            width=W, height=H)
RANSAC = 100
#: |delta pt| bound on LK tracks whose statuses agree (px), as
#: tests/test_torch_ops.py holds the unbatched quad
PT_TOL = 1e-3
#: batched step vs JAX: T^-1 within ROT_TOL (rotation entries) and
#: TRANS_TOL (metres), the bounds tests/test_torch_pipeline.py holds the
#: single step to (the JAX package's own jit/eager spread on that course)
ROT_TOL = 2e-3
TRANS_TOL = 2e-2
#: batched vs single-sequence port step: the same per-sequence arithmetic;
#: only the batched matmuls of the pyramid and the cell priors may sum in
#: another order
SAME_TOL = 1e-5
LENGTHS = (7, 11)


def _seqs(lengths=LENGTHS):
    intr = CameraIntrinsics(**INTR)
    return [list(SyntheticStereoSequence(intr, num_frames=n, seed=s,
                                         speed=0.5))
            for s, n in enumerate(lengths)]


def _cfg():
    return VOConfig.for_image(H, W, ransac_iterations=RANSAC)


def _stack(frames, i):
    return (np.stack([f[i][0] for f in frames]),
            np.stack([f[i][1] for f in frames]))


# ---- (a) plain batched quad vs vmapped Pallas quad -----------------------


@pytest.fixture(scope="module")
def batched_quad():
    """Two instances, each a quad L0, R0, R1, L1 of shifted textures, 32
    features (some invalid) with seeds within +-1.5 px."""
    rng = np.random.default_rng(0)
    p = JLKParams()
    imgs, feats = [], []
    for b in range(2):
        base = make_textured_image(H, W, seed=b + 1)
        quad = (base, warp_translate(base, -2.0, 0.0),
                warp_translate(base, -1.0, 0.5), warp_translate(base, 1.0, 0.5))
        imgs.append([jax_prepare(jnp.asarray(x), p, with_derivs=False)
                     for x in quad])
        valid = rng.random(32) < 0.85
        feats.append((np.stack([rng.uniform(15, W - 15, 32),
                                rng.uniform(15, H - 15, 32)],
                               axis=1).astype(np.float32), valid,
                      rng.uniform(-1.5, 1.5, (32, 2)).astype(np.float32),
                      rng.uniform(-1.5, 1.5, (32, 2)).astype(np.float32)))
    return imgs, [np.stack(x) for x in zip(*feats)]


@pytest.mark.parametrize("start_level", [1, 2])
def test_plain_batched_quad_matches_vmapped_pallas(batched_quad, start_level):
    imgs, (pts, valid, flow, disp) = batched_quad

    def quad(il0, ir0, ir1, il1, p, v, f, d):
        return lk_circular_quad_pallas(il0, ir0, ir1, il1, p, v, JLKParams(),
                                       interpret=True, flow=f, disp=d,
                                       start_level=start_level)

    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *[tuple(i) for i in imgs])
    ref = [np.asarray(r) for r in jax.vmap(quad)(
        *stacked, *(jnp.asarray(x) for x in (pts, valid, flow, disp)))]
    port_imgs = [LKImage(tuple(torch.tensor(np.asarray(p)) for p in im.pyramid),
                         im.shapes, im.pad) for im in stacked]
    got = [o.numpy() for o in lk_cuda.lk_circular_quad(
        *port_imgs, *(torch.from_numpy(x) for x in (pts, valid)), LKParams(),
        flow=torch.from_numpy(flow), disp=torch.from_numpy(disp),
        start_level=start_level)]
    status = ref[4]
    assert status.shape == (2, 32) and status.sum() > 30
    np.testing.assert_array_equal(got[4], status)
    for g, r in zip(got[:4], ref[:4]):
        assert g.shape == (2, 32, 2)
        assert np.abs(g - r)[status].max() < PT_TOL
        np.testing.assert_array_equal(g[~valid], pts[~valid])


def test_plain_batched_quad_is_per_sequence_plain(batched_quad):
    """The batched plain version is the unbatched one on each sequence;
    CPU tensors never count as kernel launches."""
    imgs, (pts, valid, flow, disp) = batched_quad
    planes = [tuple(torch.stack([torch.tensor(np.asarray(imgs[b][k].pyramid[lv]))
                                 for b in range(2)]) for lv in range(3))
              for k in range(4)]
    shapes, pad = imgs[0][0].shapes, imgs[0][0].pad
    t = [torch.from_numpy(x) for x in (pts, valid, flow, disp)]
    before = (lk_cuda.lk_circular_quad.launches,
              lk_cuda.lk_circular_quad.batched_launches)
    out, status, iters = lk_cuda.lk_quad_plain_batched(
        planes, shapes, pad, *t, LKParams(), 2)
    assert out.shape == (4, 2, 32, 2) and iters.shape == (2, 4, 3, 32)
    for b in range(2):
        o1, s1, i1 = lk_cuda.lk_quad_plain(
            [[p[b] for p in im] for im in planes], shapes, pad,
            *(x[b] for x in t), LKParams(), 2)
        assert torch.equal(out[:, b], o1) and torch.equal(status[b], s1)
        assert torch.equal(iters[b], i1)
    assert before == (lk_cuda.lk_circular_quad.launches,
                      lk_cuda.lk_circular_quad.batched_launches)


# ---- (b) batched step vs JAX's batched step ------------------------------


def _numpy_state(st):
    def image(im):
        return {"pyramid": [np.asarray(p) for p in im.pyramid],
                "shapes": im.shapes, "pad": im.pad}

    return {"features": {k: np.asarray(v)
                         for k, v in st.features._asdict().items()},
            "lk_l0": image(st.lk_l0), "lk_r0": image(st.lk_r0),
            "tvec": np.asarray(st.tvec)}


@pytest.fixture(scope="module")
def jax_batched_pair():
    """Per-frame batched StepOutputs of JAX and of the port over frames
    4..6 of two sequences, both started from JAX's batched state after
    frame 3; the port gets each sequence's JAX draws."""
    frames = _seqs((10, 10))
    jintr = JIntrinsics(**INTR)
    jcfg = JVOConfig.for_image(H, W, ransac_iterations=RANSAC)
    cfg = _cfg()
    mesh = make_mesh({"data": 2, "model": 1})
    jstep = jax_batched_step(jcfg, jintr, mesh)
    jst = jax_batched_init(jcfg, *_stack(frames, 0), mesh, seed=0)
    for i in (1, 2, 3):
        jst, _ = jstep(jst, *(jnp.asarray(x) for x in _stack(frames, i)))
    st = state_from_numpy(_numpy_state(jst), device="cpu")
    step = batch.make_batched_step_fn(cfg, CameraIntrinsics(**INTR),
                                      device="cpu")
    outs = []
    for i in (4, 5, 6):
        u = torch.stack([torch.tensor(np.asarray(jax.random.uniform(
            jax.random.split(k)[1], (RANSAC, cfg.padded_features))))
            for k in jst.key])
        lefts, rights = _stack(frames, i)
        jst, jout = jstep(jst, jnp.asarray(lefts), jnp.asarray(rights))
        st, out = step(st, torch.from_numpy(lefts), torch.from_numpy(rights),
                       uniforms=u)
        outs.append((jax.tree.map(np.asarray, jout),
                     pipeline.StepOutput(*(x.numpy() for x in out))))
    return outs


@pytest.mark.parametrize("frame", [0, 1, 2])
def test_batched_step_matches_jax(jax_batched_pair, frame):
    ref, got = jax_batched_pair[frame]
    assert got.T_inv.shape == (2, 4, 4) and got.fallback.shape == (2,)
    for name in ("num_bucketed", "num_matched", "num_inliers", "accept"):
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name),
                                      name)
    d = np.abs(got.T_inv - ref.T_inv)
    assert d[:, :3, :3].max() < ROT_TOL and d[:, :3, 3].max() < TRANS_TOL


# ---- (c) batched sequence b vs single-sequence step seeded seed + b ------


@pytest.mark.parametrize("draws", ["injected", "generators"])
def test_batched_sequence_matches_single_step(draws):
    frames = _seqs((5, 5))
    cfg, intr, seed = _cfg(), CameraIntrinsics(**INTR), 3
    rng = np.random.default_rng(7)
    uniforms = [torch.from_numpy(rng.random((2, RANSAC, cfg.padded_features),
                                            dtype=np.float32))
                for _ in range(4)]
    step = batch.make_batched_step_fn(cfg, intr, device="cpu")
    st = batch.batched_init_state(cfg, *_stack(frames, 0), seed=seed,
                                  device="cpu")
    batched = []
    for i in range(1, 5):
        u = uniforms[i - 1] if draws == "injected" else None
        st, out = step(st, *(torch.from_numpy(x) for x in _stack(frames, i)),
                       uniforms=u)
        batched.append(out)
    single_step = pipeline.make_step_fn(cfg, intr, device="cpu")
    for b in range(2):
        s1 = pipeline.init_vo_state(cfg, intr, *frames[b][0], seed=seed + b,
                                    device="cpu")
        for i in range(1, 5):
            u = uniforms[i - 1][b] if draws == "injected" else None
            s1, o1 = single_step(s1, *(torch.from_numpy(x)
                                       for x in frames[b][i]), uniforms=u)
            ob = batched[i - 1]
            for name in ("num_bucketed", "num_matched", "num_inliers",
                         "accept", "fallback"):
                assert int(getattr(ob, name)[b]) == int(getattr(o1, name)), name
            np.testing.assert_allclose(ob.T_inv[b].numpy(), o1.T_inv.numpy(),
                                       atol=SAME_TOL)


# ---- (d), (e) run_sequences_batched --------------------------------------


@pytest.fixture(scope="module")
def per_frame_run():
    seqs = _seqs()
    return seqs, run_sequences_batched(seqs, _cfg(), CameraIntrinsics(**INTR),
                                       seed=0, device="cpu")


@pytest.mark.parametrize("b", [0, 1])
def test_unequal_lengths_cut_at_each_end(per_frame_run, b):
    """Sequence b's poses and stats are those of a single-sequence run of
    it alone (seeded seed + b): the padded steps past its end are neither
    chained nor counted."""
    seqs, (poses, stats, wall) = per_frame_run
    assert wall > 0 and len(poses) == len(stats) == 2
    n = LENGTHS[b]
    ref, fetched, _, steps = pipeline.run_sequence_scan(
        seqs[b], _cfg(), CameraIntrinsics(**INTR), seed=b, chunk=4,
        warmup=False, device="cpu")
    assert steps == n - 1 and poses[b].shape == (n, 4, 4)
    np.testing.assert_allclose(poses[b], ref, atol=SAME_TOL)
    assert stats[b]["frames"] == n
    assert stats[b]["accept_ratio"] == float(fetched.accept.mean())
    assert stats[b]["mean_inliers"] == float(fetched.num_inliers.mean())
    assert stats[b]["fallback_frames"] == int(fetched.fallback.sum())


@pytest.mark.parametrize("chunk", [4, 16])
def test_chunked_matches_per_frame(per_frame_run, chunk):
    """As tests/test_parallel.py holds the JAX runner's two paths; chunk 16
    is longer than the run, so its tail is all padding."""
    seqs, (poses_a, stats_a, _) = per_frame_run
    poses_b, stats_b, _ = run_sequences_batched(
        seqs, _cfg(), CameraIntrinsics(**INTR), chunk=chunk, device="cpu")
    for pa, pb in zip(poses_a, poses_b):
        np.testing.assert_allclose(pa, pb, atol=1e-5)
    assert stats_a == stats_b
    assert [s["accept_ratio"] for s in stats_a] == [1.0, 1.0]


# ---- (f) CUDA by default -------------------------------------------------


@pytest.mark.parametrize("entry", ["batched_init_state", "make_batched_step_fn",
                                   "make_batched_scan_fn",
                                   "run_sequences_batched"])
def test_batched_entry_points_default_to_cuda(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    seqs = _seqs((2, 2))
    cfg, intr = _cfg(), CameraIntrinsics(**INTR)
    calls = {
        "batched_init_state": lambda: batch.batched_init_state(
            cfg, *_stack(seqs, 0)),
        "make_batched_step_fn": lambda: batch.make_batched_step_fn(cfg, intr),
        "make_batched_scan_fn": lambda: batch.make_batched_scan_fn(cfg, intr, 4),
        "run_sequences_batched": lambda: run_sequences_batched(seqs, cfg, intr),
    }
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()
