"""The port's batched step on a (data, model) mesh (``parallel/batch.py``,
``parallel/batch_eval.py``, ``ops/lk_cuda._split_slots``) on CPU device
lists.

- The LK quad with its slots split over 2, 3 and 5 "model" devices equals
  the unsplit quad bit for bit, single and batched (LK is per feature).
- ``make_batched_step_fn`` and ``make_batched_scan_fn`` on (1, 1), (2, 1),
  (1, 2) and (2, 2) meshes, three sequences (an uneven row split on two
  data rows), against the port's one-device batched step: every output and
  the carried state bit for bit (so within SAME_TOL of
  tests/test_torch_batch.py:59, the bound the repo allows).
- The (2, 1) mesh step from JAX's batched state, fed JAX's draws, against
  JAX's ``make_batched_step_fn`` on a (2, 1) mesh: the counts equal and
  T^-1 within tests/test_torch_batch.py's step bounds (ROT_TOL,
  TRANS_TOL).
- ``run_sequences_batched(mesh=)`` failed and resumed on the same (2, 2)
  mesh equals the uninterrupted mesh run and the one-device run bit for
  bit; a mesh with more data rows than sequences and a call naming both a
  device and a mesh raise.

About 60 s alone.
"""

import shutil

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_batch import (INTR, RANSAC, ROT_TOL, TRANS_TOL, H, W,
                              _numpy_state, _stack)
from visual_odom_tpu.config import CameraIntrinsics as JIntrinsics
from visual_odom_tpu.config import VOConfig as JVOConfig
from visual_odom_tpu.parallel.batch import batched_init_state as jax_init
from visual_odom_tpu.parallel.batch import make_batched_step_fn as jax_step
from visual_odom_tpu.parallel.mesh import make_mesh as jax_mesh
from visual_odom_tpu_torch.config import CameraIntrinsics, VOConfig
from visual_odom_tpu_torch.interop import state_from_numpy
from visual_odom_tpu_torch.io.synthetic import SyntheticStereoSequence
from visual_odom_tpu_torch.ops import lk_cuda
from visual_odom_tpu_torch.ops.lk import LKParams, prepare_lk_image
from visual_odom_tpu_torch.parallel import batch
from visual_odom_tpu_torch.parallel.batch_eval import run_sequences_batched
from visual_odom_tpu_torch.parallel.mesh import make_mesh
from visual_odom_tpu_torch.runner.pipeline import StepOutput
from visual_odom_tpu_torch.utils.checkpoint import load_batch_checkpoint

torch.set_num_threads(1)

CPU = torch.device("cpu")
MESHES = [(1, 1), (2, 1), (1, 2), (2, 2)]
#: LK capped at 10 iterations keeps the CPU steps short; it changes nothing
#: a split must reproduce
CFG = dict(ransac_iterations=RANSAC, lk_max_iters=10)
STEPS = 3


def _mesh(data, model):
    return make_mesh({"data": data, "model": model},
                     devices=[CPU] * (data * model))


def _cfg():
    return VOConfig.for_image(H, W, **CFG)


def _seqs(lengths=(STEPS + 1,) * 3):
    intr = CameraIntrinsics(**INTR)
    return [list(SyntheticStereoSequence(intr, num_frames=n, seed=s,
                                         speed=0.5))
            for s, n in enumerate(lengths)]


def _rows_of(state):
    """A state's per-sequence tensors (features, warm start), in sequence
    order, whichever form it has."""
    rows = state.rows if isinstance(state, batch.MeshState) else (state,)
    return [torch.cat([getattr(s.features, k) for s in rows])
            for k in state_fields()] + [torch.cat([s.tvec for s in rows])]


def state_fields():
    return ("points", "ages", "valid", "ids", "next_id", "flow", "disp")


# ---- the split quad ----------------------------------------------------------


@pytest.fixture(scope="module")
def quad():
    """A batched quad of two sequences' frames 0 and 1 at 120x160, 48 slots
    (some invalid), seeds within +-1.5 px."""
    frames = _seqs((2, 2))
    params = LKParams(max_iters=10)
    imgs = [prepare_lk_image(torch.from_numpy(np.stack(
        [f[t][s] for f in frames[:2]]).astype(np.float32)), params)
        for t, s in ((0, 0), (0, 1), (1, 1), (1, 0))]
    rng = np.random.default_rng(0)
    pts = torch.from_numpy(np.stack([rng.uniform(15, W - 15, (2, 48)),
                                     rng.uniform(15, H - 15, (2, 48))],
                                    axis=-1).astype(np.float32))
    valid = torch.from_numpy(rng.random((2, 48)) < 0.85)
    flow = torch.from_numpy(rng.uniform(-1.5, 1.5, (2, 48, 2))
                            .astype(np.float32))
    return imgs, pts, valid, flow, params


@pytest.mark.parametrize("model", [2, 3, 5])
@pytest.mark.parametrize("batched", [False, True])
def test_split_quad_equals_unsplit(quad, model, batched):
    imgs, pts, valid, flow, params = quad
    if not batched:
        imgs = [im._replace(pyramid=tuple(p[0] for p in im.pyramid))
                for im in imgs]
        pts, valid, flow = pts[0], valid[0], flow[0]
    kw = dict(flow=flow, disp=-flow, start_level=2)
    ref = lk_cuda.lk_circular_quad(*imgs, pts, valid, params, **kw)
    got = lk_cuda.lk_circular_quad(*imgs, pts, valid, params,
                                   slot_devices=[CPU] * model, **kw)
    assert ref[4].sum() > 10
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


# ---- the mesh step and scan --------------------------------------------------


@pytest.fixture(scope="module")
def one_device():
    """STEPS batched steps of three sequences on the CPU, and the state."""
    frames = _seqs()
    cfg, intr = _cfg(), CameraIntrinsics(**INTR)
    step = batch.make_batched_step_fn(cfg, intr, device="cpu")
    st = batch.batched_init_state(cfg, *_stack(frames, 0), seed=5,
                                  device="cpu")
    outs = []
    for i in range(1, STEPS + 1):
        st, out = step(st, *(torch.from_numpy(x) for x in _stack(frames, i)))
        outs.append(out)
    return frames, outs, st


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_mesh_step_equals_one_device_step(one_device, shape):
    frames, ref, ref_state = one_device
    cfg, intr, mesh = _cfg(), CameraIntrinsics(**INTR), _mesh(*shape)
    step = batch.make_batched_step_fn(cfg, intr, mesh=mesh)
    st = batch.batched_init_state(cfg, *_stack(frames, 0), seed=5, mesh=mesh)
    assert isinstance(st, batch.MeshState) == (mesh.size > 1)
    for i in range(1, STEPS + 1):
        st, out = step(st, *(torch.from_numpy(x) for x in _stack(frames, i)))
        for name in StepOutput._fields:
            assert torch.equal(getattr(out, name), getattr(ref[i - 1], name)), name
    for a, b in zip(_rows_of(st), _rows_of(ref_state)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_mesh_scan_equals_one_device_step(one_device, shape):
    frames, ref, _ = one_device
    cfg, intr, mesh = _cfg(), CameraIntrinsics(**INTR), _mesh(*shape)
    scan = batch.make_batched_scan_fn(cfg, intr, STEPS, mesh=mesh)
    st = batch.batched_init_state(cfg, *_stack(frames, 0), seed=5, mesh=mesh)
    stacks = [np.stack(x) for x in zip(*(_stack(frames, i)
                                         for i in range(1, STEPS + 1)))]
    st, out = scan(st, *stacks)
    for name in StepOutput._fields:
        want = torch.stack([getattr(o, name) for o in ref])
        assert torch.equal(getattr(out, name), want), name
    with pytest.raises(ValueError, match="chunks of"):
        scan(st, stacks[0][:1], stacks[1][:1])


def test_mesh_needs_a_sequence_per_data_row():
    frames = _seqs((2,))
    with pytest.raises(ValueError, match="every row needs a sequence"):
        batch.batched_init_state(_cfg(), *_stack(frames, 0), mesh=_mesh(2, 1))


# ---- against JAX's sharded batched step ---------------------------------------


def _row_state(d, a, b):
    """Rows a..b of a JAX batched state's numpy form."""
    def rows(x):
        return x[a:b]

    def image(m):
        return dict(m, pyramid=[rows(p) for p in m["pyramid"]])

    return {"features": {k: rows(v) for k, v in d["features"].items()},
            "lk_l0": image(d["lk_l0"]), "lk_r0": image(d["lk_r0"]),
            "tvec": rows(d["tvec"])}


def test_2x1_mesh_step_matches_jax_2x1_mesh():
    """Frames 4..6 of two sequences from JAX's batched state after frame 3,
    the port's (2, 1) mesh step fed each sequence's JAX draws (the course
    and frames of tests/test_torch_batch.py::test_batched_step_matches_jax)."""
    frames = _seqs((10, 10))
    jcfg = JVOConfig.for_image(H, W, ransac_iterations=RANSAC)
    cfg = VOConfig.for_image(H, W, ransac_iterations=RANSAC)
    jm = jax_mesh({"data": 2, "model": 1})
    jstep = jax_step(jcfg, JIntrinsics(**INTR), jm)
    jst = jax_init(jcfg, *_stack(frames, 0), jm, seed=0)
    for i in (1, 2, 3):
        jst, _ = jstep(jst, *(jnp.asarray(x) for x in _stack(frames, i)))
    d = _numpy_state(jst)
    st = batch.MeshState(tuple(state_from_numpy(_row_state(d, b, b + 1),
                                                seed=b, device="cpu")
                               for b in range(2)))
    step = batch.make_batched_step_fn(cfg, CameraIntrinsics(**INTR),
                                      mesh=_mesh(2, 1))
    for i in (4, 5, 6):
        u = torch.stack([torch.tensor(np.asarray(jax.random.uniform(
            jax.random.split(k)[1], (RANSAC, cfg.padded_features))))
            for k in jst.key])
        lefts, rights = _stack(frames, i)
        jst, ref = jstep(jst, jnp.asarray(lefts), jnp.asarray(rights))
        st, out = step(st, torch.from_numpy(lefts), torch.from_numpy(rights),
                       uniforms=u)
        for name in ("num_bucketed", "num_matched", "num_inliers", "accept"):
            np.testing.assert_array_equal(getattr(out, name).numpy(),
                                          np.asarray(getattr(ref, name)),
                                          name)
        dT = np.abs(out.T_inv.numpy() - np.asarray(ref.T_inv))
        assert dT[:, :3, :3].max() < ROT_TOL and dT[:, :3, 3].max() < TRANS_TOL


# ---- the restartable runner on a mesh -------------------------------------------


class _Flaky:
    """Random-access view that raises at frame ``crash_at``."""

    def __init__(self, seq, crash_at):
        self._seq, self._crash_at = seq, crash_at

    def __len__(self):
        return len(self._seq)

    def frame(self, i):
        if i >= self._crash_at:
            raise RuntimeError("injected decode failure")
        return self._seq.frame(i)


def test_mesh_run_resumed_equals_uninterrupted(tmp_path):
    """Three sequences of 9 frames on a (2, 2) mesh, chunk 4, a snapshot
    every 4 steps, a failure at frame 7 (after the snapshot at step 4),
    resumed on the same mesh: the poses and stats of the uninterrupted mesh
    run and of the one-device run, bit for bit."""
    intr, cfg, mesh = CameraIntrinsics(**INTR), _cfg(), _mesh(2, 2)
    seqs = [SyntheticStereoSequence(intr, num_frames=9, seed=s, speed=0.5)
            for s in range(3)]
    kw = dict(chunk=4, seed=2)
    ref = run_sequences_batched(seqs, cfg, intr, device="cpu", **kw)
    clean = run_sequences_batched(seqs, cfg, intr, mesh=mesh, **kw)
    ck = str(tmp_path / "mesh.npz")
    with pytest.raises(RuntimeError, match="injected"):
        run_sequences_batched([seqs[0], _Flaky(seqs[1], 7), seqs[2]], cfg,
                              intr, mesh=mesh, checkpoint_path=ck,
                              checkpoint_every=4, **kw)
    snap = load_batch_checkpoint(ck, batch=3, device="cpu")
    assert int(snap["frames_done"]) == 4 and snap["gen_state"].shape[0] == 3
    resumed_ck = str(tmp_path / "resume.npz")
    shutil.copy(ck, resumed_ck)
    resumed = run_sequences_batched(seqs, cfg, intr, mesh=mesh,
                                    checkpoint_path=resumed_ck,
                                    checkpoint_every=4, **kw)
    for run in (clean, resumed):
        for a, b in zip(run[0], ref[0]):
            np.testing.assert_array_equal(a, b)
        assert run[1] == ref[1]
    with pytest.raises(ValueError, match="device or a mesh"):
        run_sequences_batched(seqs, cfg, intr, device="cpu", mesh=mesh)
