"""The port's edge-sharded pose graph (``ba.posegraph.sharded_posegraph_solve``)
and ``runner.loopclosure.close_loops(mesh=)`` on CPU device lists, against
the JAX package's on the conftest's 8-device CPU mesh and against the
port's ``posegraph_solve``.

- The drifted circle of tests/test_posegraph.py on 1, 2, 3, 4 and 8 edge
  shards (3 pads the 40 edges with two zero-weight self-edges): nodes
  within 2e-4 (tests/test_posegraph.py:106) of JAX's sharded solve and of
  the port's single-device solve; one shard is that solve bit for bit.
- Zero-weight padding edges add nothing, bit for bit.
- The gauge and the damping go on once, after the shards' sum: the system
  each sharded iteration solves equals the single-device assembly's (a
  gauge or damping added per shard would count D times).
- ``posegraph_solve`` after the split of ``_assemble`` equals the solve
  before it (kept below) bit for bit.
- ``close_loops(mesh=)`` against JAX's ``close_loops(mesh=)`` and the
  port's ``close_loops()``, both packages' loop-edge measurements replaced
  by the true relative pose (the measurement has its own tests in
  tests/test_torch_loopclosure.py).

About 15 s alone.
"""

import numpy as np
import jax
import pytest
import torch

from test_posegraph import _circle_truth, _drifted_chain
from visual_odom_tpu.ba import posegraph as jpg
from visual_odom_tpu.config import CameraIntrinsics as JIntrinsics
from visual_odom_tpu.config import VOConfig as JVOConfig
from visual_odom_tpu.parallel.mesh import make_mesh as jax_mesh
from visual_odom_tpu.runner import loopclosure as jlc
from visual_odom_tpu_torch.ba import posegraph
from visual_odom_tpu_torch.config import CameraIntrinsics, VOConfig
from visual_odom_tpu_torch.interop import pose_graph_from_numpy
from visual_odom_tpu_torch.parallel.mesh import make_mesh
from visual_odom_tpu_torch.runner import loopclosure

# Small tensors: one intra-op thread each keeps the parallel test workers
# from oversubscribing the cores.
torch.set_num_threads(1)

#: solved nodes; the JAX package's sharded-vs-single bound
#: (tests/test_posegraph.py:106)
NODE_TOL = 2e-4
#: the summed system against the single-device assembly, relative to each
#: diagonal entry (float32 sums in another order); a gauge or damping
#: counted twice moves a diagonal entry by 1e6 or by 1e-4 of itself
SYSTEM_RTOL = 1e-5
ITERS = 8
CPU = torch.device("cpu")
H, W = 120, 160
INTR = dict(fx=120.0, fy=120.0, cx=W / 2, cy=H / 2, bf=-120.0 * 0.54,
            width=W, height=H)


@pytest.fixture(scope="module")
def circle():
    truth = _circle_truth(40)
    est = _drifted_chain(truth)
    jg = jpg.build_keyframe_graph(est, np.arange(len(est)),
                                  [(0, len(est) - 1,
                                    np.linalg.inv(truth[0]) @ truth[-1],
                                    10.0)])
    g = pose_graph_from_numpy({k: np.asarray(v)
                               for k, v in jg._asdict().items()},
                              device="cpu")
    return truth, est, jg, g


def _model(n):
    return make_mesh({"model": n}, devices=[CPU] * n)


@pytest.mark.parametrize("shards", [1, 2, 3, 4, 8])
def test_sharded_posegraph_matches_jax_and_single(circle, shards):
    _, est, jg, g = circle
    got = posegraph.sharded_posegraph_solve(g, _model(shards),
                                            iterations=ITERS).nodes
    single = posegraph.posegraph_solve(g, iterations=ITERS).nodes
    ref = jpg.sharded_posegraph_solve(
        jg, jax_mesh({"model": shards}, devices=jax.devices()[:shards]),
        iterations=ITERS).nodes
    assert np.abs(got.numpy() - single.numpy()).max() < NODE_TOL
    assert np.abs(got.numpy() - np.asarray(ref)).max() < NODE_TOL
    np.testing.assert_allclose(got[0].numpy(), est[0], atol=1e-4)
    if shards == 1:
        assert torch.equal(got, single)


def test_zero_weight_padding_edges_are_exact(circle):
    _, _, _, g = circle
    pad = 3
    edges = torch.cat([g.edges, torch.zeros((pad, 2), dtype=g.edges.dtype)])
    rel = torch.cat([g.rel, torch.eye(4).expand(pad, 4, 4)])
    weight = torch.cat([g.weight, torch.zeros(pad)])
    padded = posegraph._edge_terms(g.nodes, edges, posegraph._se3_inv(rel),
                                   weight)
    plain = posegraph._edge_terms(g.nodes, g.edges, posegraph._se3_inv(g.rel),
                                  g.weight)
    for a, b in zip(padded, plain):
        assert torch.equal(a, b)
    r, (Ji, Jj) = posegraph._edge_val_and_jac(
        torch.zeros(pad, 6), torch.zeros(pad, 6), g.nodes[:pad].clone(),
        g.nodes[:pad].clone(), posegraph._se3_inv(rel[-pad:]), weight[-pad:])
    assert not r.any() and not Ji.any() and not Jj.any()


@pytest.mark.parametrize("shards", [2, 4])
def test_gauge_and_damping_counted_once(circle, monkeypatch, shards):
    """The (H, b) each sharded iteration solves is the single-device
    assembly at the same nodes: the gauge's 1e6 and the damping's
    diagonal-relative 1e-4 appear once, not once per shard."""
    _, _, _, g = circle
    seen = []
    real = posegraph._gn_update

    def spy(nodes, H, b):
        seen.append((nodes, H, b))
        return real(nodes, H, b)

    monkeypatch.setattr(posegraph, "_gn_update", spy)
    posegraph.sharded_posegraph_solve(g, _model(shards), iterations=2,
                                      damping=0.25)
    assert len(seen) == 2          # once per iteration: one CPU device
    rel_inv = posegraph._se3_inv(g.rel)
    for nodes, H, b in seen:
        H_ref, b_ref, _ = posegraph._assemble(nodes, g.edges, rel_inv,
                                              g.weight, 0.25)
        d, d_ref = torch.diagonal(H), torch.diagonal(H_ref)
        assert ((d - d_ref).abs() <= SYSTEM_RTOL * d_ref.abs()).all()
        assert ((H - H_ref).abs().max()
                <= SYSTEM_RTOL * H_ref.abs().max())
        assert ((b - b_ref).abs().max()
                <= SYSTEM_RTOL * b_ref.abs().max())
        assert not b[0].any()


def _assemble_before_split(nodes, edges, rel_inv, weight, damping):
    """``ba.posegraph._assemble`` as it stood before the split, verbatim."""
    N = nodes.shape[0]
    zero = torch.zeros((edges.shape[0], 6), dtype=nodes.dtype,
                       device=nodes.device)
    ei, ej = edges[:, 0], edges[:, 1]
    r, (Ji, Jj) = posegraph._edge_val_and_jac(zero, zero, nodes[ei],
                                              nodes[ej], rel_inv, weight)
    k = torch.arange(6, device=nodes.device)
    H = torch.zeros((6 * N, 6 * N), dtype=nodes.dtype, device=nodes.device)
    b = torch.zeros((N, 6), dtype=nodes.dtype, device=nodes.device)

    def add_blocks(n, m, X):
        H.index_put_((6 * n[:, None, None] + k[None, :, None],
                      6 * m[:, None, None] + k[None, None, :]), X,
                     accumulate=True)

    add_blocks(ei, ei, torch.einsum("eab,eac->ebc", Ji, Ji))
    add_blocks(ej, ej, torch.einsum("eab,eac->ebc", Jj, Jj))
    add_blocks(ei, ej, torch.einsum("eab,eac->ebc", Ji, Jj))
    add_blocks(ej, ei, torch.einsum("eab,eac->ebc", Jj, Ji))
    b.index_put_((ei,), -torch.einsum("eab,ea->eb", Ji, r), accumulate=True)
    b.index_put_((ej,), -torch.einsum("eab,ea->eb", Jj, r), accumulate=True)
    gauge = torch.arange(6 * N, device=nodes.device) < 6
    H = H + torch.diag(gauge.to(nodes.dtype) * 1e6)
    b = torch.cat([torch.zeros_like(b[:1]), b[1:]])
    H = H + torch.diag(damping * torch.clamp(torch.diagonal(H), min=1e-6))
    return H, b, torch.sum(r * r)


@pytest.mark.parametrize("graph", ["circle", "keyframes"])
def test_posegraph_solve_after_split_equals_before(circle, monkeypatch, graph):
    truth, est, _, g = circle
    if graph == "keyframes":
        inv = np.linalg.inv
        g = posegraph.build_keyframe_graph(
            est, np.arange(0, 40, 4),
            [(0, 36, inv(truth[0]) @ truth[36], 10.0),
             (0, 20, inv(truth[0]) @ truth[20], 10.0),
             (20, 36, inv(truth[20]) @ truth[36], 3.0)], device="cpu")
    after = posegraph.posegraph_solve(g, iterations=ITERS).nodes
    monkeypatch.setattr(posegraph, "_assemble", _assemble_before_split)
    before = posegraph.posegraph_solve(g, iterations=ITERS).nodes
    assert torch.equal(after, before)


def _true_edges(monkeypatch, truth):
    """Both packages' loop-edge measurements replaced by the true relative
    pose (frames are their indices here)."""
    def measured(fi, fj, *args, **kwargs):
        return np.linalg.inv(truth[fi]) @ truth[fj], 50, True

    monkeypatch.setattr(jlc, "measure_loop_edge_bidirectional", measured)
    monkeypatch.setattr(loopclosure, "measure_loop_edge_bidirectional",
                        measured)
    monkeypatch.setattr(loopclosure, "make_edge_measure",
                        lambda *a, **k: None)


@pytest.mark.parametrize("shards", [3, 4])
def test_close_loops_mesh_matches_jax(circle, monkeypatch, shards):
    truth, est, _, _ = circle
    _true_edges(monkeypatch, truth)
    kw = dict(keyframe_every=4, radius=3.0, min_separation=20,
              min_edge_inliers=3, gt_loop_pair=(0, 39))
    got, info = loopclosure.close_loops(
        est, lambda i: i, VOConfig.for_image(H, W),
        CameraIntrinsics(**INTR), mesh=_model(shards), device="cpu", **kw)
    single, sinfo = loopclosure.close_loops(
        est, lambda i: i, VOConfig.for_image(H, W),
        CameraIntrinsics(**INTR), device="cpu", **kw)
    ref, jinfo = jlc.close_loops(
        est, lambda i: i, JVOConfig.for_image(H, W), JIntrinsics(**INTR),
        mesh=jax_mesh({"model": shards}, devices=jax.devices()[:shards]),
        **kw)
    assert info.edges and info.edges == jinfo.edges == sinfo.edges
    assert info.candidates == jinfo.candidates
    assert info.closure_after_m < info.closure_before_m
    assert np.abs(got - ref).max() < NODE_TOL
    assert np.abs(got - single).max() < NODE_TOL
    assert abs(info.closure_after_m - jinfo.closure_after_m) < NODE_TOL
