"""The port's landmark-sharded bundle adjustment
(``visual_odom_tpu_torch/parallel/sharded_ba.py``) and its collectives
(``parallel/collectives.py``) on CPU device lists, against the JAX package's
``sharded_ba_solve`` on the conftest's 8-device CPU mesh.

- ``sharded_ba_solve`` on 1, 2, 3, 4 and 8 landmark shards (3 splits the
  landmarks unevenly) against JAX's on a (1, shards) mesh and against the
  port's ``ba_solve``: poses 1e-4, landmarks 1e-3, the JAX package's own
  bounds (tests/test_parallel.py:32-37); one shard is ``ba_solve`` bit for
  bit.
- ``ba_solve`` after the split of ``ba.schur`` into ``schur_parts``,
  ``solve_reduced`` and ``back_substitute`` equals the step as it was
  before the split (kept below as ``_step_before_split``) bit for bit.
- The finite guard is global: one shard's non-finite update stops every
  shard's.
- The collectives: the order of ``psum``'s sum, ``ppermute``'s zeros,
  ``broadcast`` and ``replicated``.

About 15 s alone.
"""

import numpy as np
import jax
import pytest
import torch

from visual_odom_tpu.ba import problem as jproblem
from visual_odom_tpu.parallel.mesh import make_mesh as jax_mesh
from visual_odom_tpu.parallel.sharded_ba import sharded_ba_solve as jax_sharded
from visual_odom_tpu_torch.ba import schur
from visual_odom_tpu_torch.interop import ba_problem_from_numpy
from visual_odom_tpu_torch.parallel import collectives, sharded_ba
from visual_odom_tpu_torch.parallel.mesh import (axis_devices, make_mesh,
                                                 split_ranges)

# Small tensors: one intra-op thread each keeps the parallel test workers
# from oversubscribing the cores.
torch.set_num_threads(1)

#: the JAX package's sharded-vs-single bounds (tests/test_parallel.py:32-37)
POSE_TOL = 1e-4
LM_TOL = 1e-3
ITERS = 4
#: (poses, landmarks, seed, obs_window): tests/test_parallel.py's problem,
#: and a windowed one whose 61 landmarks no shard count above 1 divides
PROBLEMS = {"dense": (4, 64, 7, None), "windowed": (6, 61, 3, 2)}
CPU = torch.device("cpu")


def _problems(name):
    W, L, seed, ow = PROBLEMS[name]
    jp, _, _ = jproblem.synthetic_ba_problem(num_poses=W, num_landmarks=L,
                                             seed=seed, obs_window=ow)
    d = {k: np.asarray(v) for k, v in jp._asdict().items()}
    return jp, ba_problem_from_numpy(d, device="cpu")


def _model_mesh(shards):
    return make_mesh({"data": 1, "model": shards}, devices=[CPU] * shards)


@pytest.mark.parametrize("name", sorted(PROBLEMS))
@pytest.mark.parametrize("shards", [1, 2, 3, 4, 8])
def test_sharded_ba_matches_jax_and_ba_solve(name, shards):
    jp, p = _problems(name)
    ref = jax_sharded(jp, jax_mesh({"data": 1, "model": shards},
                                   devices=jax.devices()[:shards]),
                      iterations=ITERS)
    single = schur.ba_solve(p, iterations=ITERS)
    got = sharded_ba.sharded_ba_solve(p, _model_mesh(shards),
                                      iterations=ITERS)
    for want in ((np.asarray(ref.poses), np.asarray(ref.landmarks)),
                 (single.poses.numpy(), single.landmarks.numpy())):
        assert np.abs(got.poses.numpy() - want[0]).max() < POSE_TOL
        assert np.abs(got.landmarks.numpy() - want[1]).max() < LM_TOL
    assert got.poses.shape == p.poses.shape
    assert got.landmarks.shape == p.landmarks.shape
    # the gauge pose stays put under its 1e9 prior
    np.testing.assert_allclose(got.poses[0].numpy(), p.poses[0].numpy(),
                               atol=1e-6)


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_one_shard_is_ba_solve_bit_for_bit(name):
    _, p = _problems(name)
    got = sharded_ba.sharded_ba_solve(p, _model_mesh(1), iterations=ITERS)
    ref = schur.ba_solve(p, iterations=ITERS)
    assert torch.equal(got.poses, ref.poses)
    assert torch.equal(got.landmarks, ref.landmarks)


def _step_before_split(problem_, damping=1e-4, anchor=None, anchor_w=None,
                       huber_delta=0.0):
    """``ba.schur.ba_gauss_newton_step`` as it stood before the split,
    verbatim."""
    poses = problem_.poses
    W = poses.shape[0]
    eye3, eye6, eyeW = (torch.eye(k, dtype=poses.dtype, device=poses.device)
                        for k in (3, 6, W))
    if anchor is None:
        anchor = poses
    if anchor_w is None:
        anchor_w = eyeW[0] * schur._GAUGE_PRIOR
    A, B, r = schur._jacobian_blocks(problem_, huber_delta=huber_delta)
    Hpp = torch.einsum("wlri,wlrj->wij", A, A)
    Hll = torch.einsum("wlri,wlrj->lij", B, B)
    Hpl = torch.einsum("wlri,wlrj->wlij", A, B)
    bp = torch.einsum("wlri,wlr->wi", A, r)
    bl = torch.einsum("wlri,wlr->li", B, r)
    Hll_inv = torch.linalg.inv_ex(Hll + damping * eye3)[0]
    HplWinv = torch.einsum("wlij,ljk->wlik", Hpl, Hll_inv)
    S_red = torch.einsum("wlik,vljk->wvij", HplWinv, Hpl)
    rhs_red = torch.einsum("wlik,lk->wi", HplWinv, bl)
    S = torch.einsum("wv,wij->wvij", eyeW, Hpp + damping * eye6) - S_red
    S = S + torch.einsum("wv,w,ij->wvij", eyeW, anchor_w, eye6)
    rhs = bp - rhs_red
    rhs = rhs + anchor_w[:, None] * (poses - anchor)
    S_dense = S.permute(0, 2, 1, 3).reshape(W * 6, W * 6)
    dp = torch.linalg.solve_ex(S_dense, rhs.reshape(W * 6))[0].reshape(W, 6)
    corr = torch.einsum("wlij,wi->lj", Hpl, dp)
    dx = torch.einsum("lij,lj->li", Hll_inv, bl - corr)
    ok = torch.isfinite(dp).all() & torch.isfinite(dx).all()
    return problem_._replace(
        poses=torch.where(ok, poses - dp, poses),
        landmarks=torch.where(ok, problem_.landmarks - dx,
                              problem_.landmarks))


@pytest.mark.parametrize("case", ["dense", "windowed", "huber", "anchored"])
def test_ba_solve_after_split_equals_before(case):
    """Six steps from the same problem: the split step gives the bits of
    the step before it (the Huber path, and anchors off pose 0, too)."""
    _, p = _problems("dense" if case == "dense" else "windowed")
    kw = {}
    if case == "huber":
        kw["huber_delta"] = 1.5
    if case == "anchored":
        W = p.poses.shape[0]
        kw["anchor"] = p.poses + 0.01
        kw["anchor_w"] = torch.linspace(1e9, 1e3, W)
    a = b = p
    for _ in range(6):
        a = _step_before_split(a, **kw)
        b = schur.ba_gauss_newton_step(b, **kw)
    assert torch.equal(a.poses, b.poses)
    assert torch.equal(a.landmarks, b.landmarks)
    if not kw:
        c = schur.ba_solve(p, iterations=6)
        assert torch.equal(c.poses, a.poses)
        assert torch.equal(c.landmarks, a.landmarks)


def test_finite_guard_is_global(monkeypatch):
    """Shard 2 of 3 back-substitutes to NaN in the first iteration only:
    no shard moves then, so three iterations equal two from the start. A
    guard per shard would have moved shards 0 and 1."""
    _, p = _problems("windowed")
    mesh = _model_mesh(3)
    a, b = split_ranges(p.landmarks.shape[0], 3)[2]
    real = sharded_ba.back_substitute
    calls = []

    def poisoned(blocks, dp):
        dx = real(blocks, dp)
        calls.append(blocks.bl.shape[0])
        if len(calls) == 3:            # shard 2, first iteration
            assert blocks.bl.shape[0] == b - a
            return torch.full_like(dx, float("nan"))
        return dx

    monkeypatch.setattr(sharded_ba, "back_substitute", poisoned)
    got = sharded_ba.sharded_ba_solve(p, mesh, iterations=3)
    monkeypatch.setattr(sharded_ba, "back_substitute", real)
    want = sharded_ba.sharded_ba_solve(p, mesh, iterations=2)
    assert len(calls) == 9
    assert torch.equal(got.poses, want.poses)
    assert torch.equal(got.landmarks, want.landmarks)
    assert not torch.equal(want.poses, p.poses)


# ---- the collectives ---------------------------------------------------------


def test_psum_adds_in_shard_order_and_shares_bits():
    """Floats whose sum depends on the order: the result is
    ((x0 + x1) + x2) + x3 on every shard, one tensor per device."""
    parts = [torch.tensor([1e8], dtype=torch.float32),
             torch.tensor([1.0]), torch.tensor([-1e8]), torch.tensor([1.0])]
    out = collectives.psum(parts)
    want = ((parts[0] + parts[1]) + parts[2]) + parts[3]
    assert len(out) == 4 and all(torch.equal(o, want) for o in out)
    assert all(o is out[0] for o in out)
    one = torch.ones(3)
    assert collectives.psum([one])[0] is one


def test_ppermute_moves_and_zero_fills():
    parts = [torch.full((2,), float(k)) for k in range(4)]
    out = collectives.ppermute(parts, [(0, 1), (1, 2), (2, 3)])
    assert [o.tolist() for o in out] == [[0, 0], [0, 0], [1, 1], [2, 2]]
    ring = collectives.ppermute(parts, [(k, (k + 1) % 4) for k in range(4)])
    assert [o[0].item() for o in ring] == [3, 0, 1, 2]
    with pytest.raises(ValueError, match="receives twice"):
        collectives.ppermute(parts, [(0, 1), (2, 1)])


def test_broadcast_and_replicated_share_per_device():
    x = torch.ones(2)
    assert collectives.broadcast(x, [CPU, CPU])[1] is x
    calls = []

    def fn(a, b):
        calls.append(1)
        return a + b

    res = collectives.replicated([CPU] * 3, fn, [x] * 3, [x] * 3)
    assert len(calls) == 1 and all(r is res[0] for r in res)


@pytest.mark.parametrize("n, parts", [(10, 3), (2, 4), (64, 8), (7, 1)])
def test_split_ranges_cut_contiguously(n, parts):
    ranges = split_ranges(n, parts)
    sizes = [b - a for a, b in ranges]
    assert len(ranges) == parts and ranges[0][0] == 0 and ranges[-1][1] == n
    assert all(r[1] == s[0] for r, s in zip(ranges, ranges[1:]))
    assert max(sizes) - min(sizes) <= 1 and sizes == sorted(sizes)[::-1]


def test_axis_devices_take_index_zero_of_other_axes():
    devs = [torch.device("cpu", k) for k in range(6)]
    mesh = make_mesh({"data": 2, "model": 3}, devices=devs)
    assert axis_devices(mesh, "model") == devs[:3]
    assert axis_devices(mesh, "data") == [devs[0], devs[3]]
