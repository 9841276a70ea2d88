"""The port's pose graph and loop closure against the JAX package's, on the
same numpy inputs.

- ``ba.posegraph``: the solve on the drifted circle of
  tests/test_posegraph.py (carried with ``interop.pose_graph_from_numpy``),
  the assembled normal equations on a graph whose node 0 sits in several
  edges, the host-side graph glue and the stable SO(3) log.
- ``runner.loopclosure``: candidate detection, one loop-edge measurement
  against JAX's (its step fed JAX's RANSAC draws), and ``close_loops`` end
  to end on the port's own loop course at the JAX test's bars.
- The LK quad the loop-edge step runs: from the top of the pyramid
  (``start_level=None``) with zero flow and disparity, the plain version
  against JAX's Pallas quad in interpret mode.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_posegraph import _circle_truth, _drifted_chain
from test_torch_ops import PT_TOL, to_port_image
from test_torch_pipeline import (COUNT_FRAC, INTR, RANSAC, ROT_TOL, TRANS_TOL,
                                 H, W)
from visual_odom_tpu.ba import posegraph as jpg
from visual_odom_tpu.config import CameraIntrinsics as JIntrinsics
from visual_odom_tpu.config import VOConfig as JVOConfig
from visual_odom_tpu.ops.lk import LKParams as JLKParams
from visual_odom_tpu.ops.lk import prepare_lk_image as jax_prepare
from visual_odom_tpu.ops.lk_pallas import lk_circular_quad_pallas
from visual_odom_tpu.runner import loopclosure as jlc
from visual_odom_tpu_torch.ba import posegraph
from visual_odom_tpu_torch.config import CameraIntrinsics, VOConfig
from visual_odom_tpu_torch.interop import pose_graph_from_numpy
from visual_odom_tpu_torch.io.synthetic import (SyntheticStereoSequence,
                                                make_course)
from visual_odom_tpu_torch.ops import lk_cuda
from visual_odom_tpu_torch.ops.lk import LKParams
from visual_odom_tpu_torch.runner import loopclosure, pipeline

# Small tensors: one intra-op thread each keeps the parallel test workers
# from oversubscribing the cores.
torch.set_num_threads(1)

#: solved nodes; the JAX package's sharded-vs-single bound
#: (tests/test_posegraph.py:106)
NODE_TOL = 2e-4
#: host-side float64 glue: the same numpy operations
GLUE_TOL = 1e-12
#: assembled H and b, relative to their largest entry (float32 Jacobians
#: summed in another order)
ASSEMBLE_RTOL = 1e-5
#: rad; the stable log of the same float32 rotation
LOG_TOL = 1e-6


def _np(x):
    return {k: np.asarray(v) for k, v in x._asdict().items()}


@pytest.fixture(scope="module")
def drifted_circle():
    truth = _circle_truth(40)
    return truth, _drifted_chain(truth)


def _graphs(est, kf, loop_edges):
    ref = jpg.build_keyframe_graph(est, kf, loop_edges)
    return ref, pose_graph_from_numpy(_np(ref), device="cpu")


def test_posegraph_solve_matches_jax(drifted_circle):
    """One loop edge on the drifted circle: nodes within NODE_TOL of JAX's,
    the gauge node fixed, every node still a rotation, the end pulled
    back as tests/test_posegraph.py requires."""
    truth, est = drifted_circle
    true_rel = np.linalg.inv(truth[0]) @ truth[-1]
    jg, g = _graphs(est, np.arange(len(est)), [(0, len(est) - 1, true_rel, 10.0)])
    ref = np.asarray(jpg.posegraph_solve(jg, iterations=10).nodes)
    nodes = posegraph.posegraph_solve(g, iterations=10).nodes.numpy()
    assert np.abs(nodes - ref).max() < NODE_TOL
    np.testing.assert_allclose(nodes[0], est[0], atol=1e-4)
    RtR = np.einsum("nij,nik->njk", nodes[:, :3, :3], nodes[:, :3, :3])
    np.testing.assert_allclose(RtR, np.broadcast_to(np.eye(3), RtR.shape),
                               atol=1e-4)
    before = np.linalg.norm(est[-1][:3, 3] - truth[-1][:3, 3])
    after = np.linalg.norm(nodes[-1][:3, 3] - truth[-1][:3, 3])
    assert after < 0.2 * before


def test_posegraph_noop_without_loop_edge(drifted_circle):
    _, est = drifted_circle
    _, g = _graphs(est, np.arange(len(est)), [])
    solved = posegraph.posegraph_solve(g, iterations=5)
    np.testing.assert_allclose(solved.nodes.numpy(), est, atol=1e-3)


def test_assembly_accumulates_shared_nodes_as_jax(drifted_circle):
    """Node 0 sits in three edges and node 20 in three: the scatter-add
    keeps every block (a plain indexed += would keep one per node) and puts
    each where JAX's ``H.at[ei, :, ej, :].add`` does."""
    truth, est = drifted_circle
    kf = np.arange(0, 40, 4)
    inv = np.linalg.inv
    loops = [(0, 36, inv(truth[0]) @ truth[36], 10.0),
             (0, 20, inv(truth[0]) @ truth[20], 10.0),
             (20, 36, inv(truth[20]) @ truth[36], 3.0)]
    jg, g = _graphs(est, kf, loops)
    N = len(kf)
    H_ref, b_ref, c_ref = jpg._assemble(
        jg.nodes, jg.edges, jax.vmap(jpg._se3_inv)(jg.rel), jg.weight, 1e-4)
    H, b, c = posegraph._assemble(g.nodes, g.edges, posegraph._se3_inv(g.rel),
                                  g.weight, 1e-4)
    H_ref = np.asarray(H_ref).reshape(6 * N, 6 * N)
    off = ~np.kron(np.eye(N, dtype=bool), np.ones((6, 6), bool))
    assert np.abs(H_ref[off]).max() > 1.0         # loop edges couple blocks
    assert np.abs(H.numpy() - H_ref).max() <= ASSEMBLE_RTOL * np.abs(H_ref).max()
    assert (np.abs(b.numpy() - np.asarray(b_ref)).max()
            <= ASSEMBLE_RTOL * np.abs(np.asarray(b_ref)).max())
    assert abs(float(c) - float(c_ref)) <= ASSEMBLE_RTOL * float(c_ref)
    inv_ref = np.asarray(jax.vmap(jpg._se3_inv)(jg.rel))
    assert (np.abs(posegraph._se3_inv(g.rel).numpy() - inv_ref).max()
            <= ASSEMBLE_RTOL * np.abs(inv_ref).max())


def test_keyframe_graph_and_redistribution_match_jax(drifted_circle):
    truth, est = drifted_circle
    kf = np.append(np.arange(0, 40, 5), 39)
    loops = [(0, 39, np.linalg.inv(truth[0]) @ truth[-1], 10.0)]
    jg, _ = _graphs(est, kf, [])
    ref = _np(jpg.build_keyframe_graph(est, kf, loops))
    got = posegraph.build_keyframe_graph(est, kf, loops, device="cpu")
    for k in ("nodes", "rel", "weight"):
        assert np.abs(getattr(got, k).numpy() - ref[k]).max() <= GLUE_TOL
    np.testing.assert_array_equal(got.edges.numpy(), ref["edges"])
    new_kf = est[kf].copy()
    new_kf[2:, :3, 3] += 0.5
    out = posegraph.redistribute_poses(est, kf, new_kf)
    assert np.abs(out - jpg.redistribute_poses(est, kf, new_kf)).max() <= GLUE_TOL
    assert out.dtype == np.float64


@pytest.mark.parametrize("angle", [0.0, 1e-8, 1e-6, 1e-3, 0.05, 0.5])
def test_so3_log_stable_matches_jax(angle):
    from visual_odom_tpu.core.lie import rodrigues as jrod

    axis = np.array([0.3, -0.8, 0.52])
    R = np.asarray(jrod(jnp.asarray(axis / np.linalg.norm(axis) * angle,
                                    jnp.float32)))
    ref = np.asarray(jpg._so3_log_stable(jnp.asarray(R)))
    got = posegraph._so3_log_stable(torch.tensor(R)).numpy()
    assert np.abs(got - ref).max() < LOG_TOL
    assert abs(np.linalg.norm(got) - angle) < LOG_TOL + 1e-6 * angle


def test_detect_loop_candidates_match_jax(drifted_circle):
    _, est = drifted_circle
    kf = np.arange(0, 40, 2)
    for radius, sep in ((3.0, 20), (8.0, 10), (0.5, 30)):
        got = loopclosure.detect_loop_candidates(est[:, :3, 3], kf,
                                                 radius=radius,
                                                 min_separation=sep)
        assert got == jlc.detect_loop_candidates(est[:, :3, 3], kf,
                                                 radius=radius,
                                                 min_separation=sep)


# ---- the loop-edge step ----------------------------------------------------

@pytest.fixture(scope="module")
def small_course():
    seq = SyntheticStereoSequence(CameraIntrinsics(**INTR), num_frames=6,
                                  seed=0, speed=0.5)
    return [seq.frame(i) for i in range(len(seq))]


def test_measure_loop_edge_matches_jax(small_course):
    """Frames 0 -> 3 (1.5 m apart) measured by both packages: the port's
    step fed the RANSAC draws JAX's ``VisualOdometry`` makes from seed 0,
    held to the step-parity bounds of tests/test_torch_pipeline.py."""
    frames = small_course
    jcfg = JVOConfig.for_image(H, W, ransac_iterations=RANSAC)
    cfg = VOConfig.for_image(H, W, ransac_iterations=RANSAC)
    T_ref, inl_ref, acc_ref = jlc.measure_loop_edge(
        frames[0], frames[3], jcfg, JIntrinsics(**INTR))
    _, sub = jax.random.split(jax.random.PRNGKey(0))
    u = torch.tensor(np.asarray(jax.random.uniform(
        sub, (RANSAC, cfg.padded_features))))
    T, inl, acc = loopclosure.measure_loop_edge(
        frames[0], frames[3], cfg, CameraIntrinsics(**INTR), device="cpu",
        uniforms=u)
    assert acc == bool(acc_ref) and acc
    assert abs(inl - int(inl_ref)) <= COUNT_FRAC * int(inl_ref)
    d = np.abs(T - T_ref)
    assert d[:3, :3].max() < ROT_TOL and d[:3, 3].max() < TRANS_TOL
    assert T.dtype == np.float64 and np.linalg.norm(T[:3, 3]) > 1.0


def test_loop_edge_step_runs_one_full_pyramid_quad(small_course):
    """One measurement is one step of one quad from the top of the pyramid
    with zero flow and disparity; a rejected step measures the identity."""
    frames = small_course
    cfg = VOConfig.for_image(H, W, ransac_iterations=RANSAC)
    levels = []
    real = lk_cuda.lk_quad_plain

    def record(*args, **kw):
        levels.append(args[-1])
        flow, disp = args[5], args[6]
        assert not flow.any() and not disp.any()
        return real(*args, **kw)

    lk_cuda.lk_quad_plain = record
    try:
        measure = loopclosure.make_edge_measure(cfg, CameraIntrinsics(**INTR),
                                                device="cpu")
        measure(frames[0], frames[1])
        # a frame of another scene rejects
        T, _, acc = measure(frames[0], (np.zeros_like(frames[1][0]),) * 2)
    finally:
        lk_cuda.lk_quad_plain = real
    assert levels == [cfg.lk_levels, cfg.lk_levels]
    assert not acc and np.array_equal(T, np.eye(4))


@pytest.fixture(scope="module")
def quad_inputs():
    from conftest import make_textured_image, warp_translate

    img0 = make_textured_image(240, 320, seed=31)
    img1 = warp_translate(img0, 2.7, -1.9)
    p = JLKParams()
    rng = np.random.default_rng(0)
    pts = np.stack([rng.uniform(30, 290, 64), rng.uniform(30, 210, 64)],
                   axis=1).astype(np.float32)
    valid = np.ones(64, bool)
    valid[-4:] = False
    return (jax_prepare(jnp.asarray(img0), p),
            jax_prepare(jnp.asarray(img1), p), pts, valid)


def test_plain_quad_full_pyramid_matches_pallas_interpret(quad_inputs):
    """The quad as the loop-edge step runs it (``start_level=None``: from
    level ``levels``, zero flow and disparity) against JAX's Pallas quad in
    interpret mode, under the rules of tests/test_torch_ops.py: statuses
    equal, agreed tracks within PT_TOL px."""
    li, lj, pts, valid = quad_inputs
    ref = [np.asarray(r) for r in lk_circular_quad_pallas(
        li, lj, li, lj, jnp.asarray(pts), jnp.asarray(valid), JLKParams(),
        interpret=True)]
    ti, tj = to_port_image(li), to_port_image(lj)
    got = [o.numpy() for o in lk_cuda.lk_circular_quad(
        ti, tj, ti, tj, torch.from_numpy(pts), torch.from_numpy(valid),
        LKParams())]
    np.testing.assert_array_equal(got[4], ref[4])
    assert ref[4].sum() > 40
    for g, r in zip(got[:4], ref[:4]):
        assert np.abs(g - r)[ref[4]].max() < PT_TOL


# ---- end to end ------------------------------------------------------------

def test_close_loops_on_loop_course():
    """tests/test_posegraph.py::test_close_loops_on_loop_course on the
    port's own 150-frame run, with its parameters and bars."""
    intr = CameraIntrinsics(**INTR)
    cfg = VOConfig.for_image(H, W, ransac_iterations=RANSAC,
                             min_accept_inliers=0)
    n = 150
    seq = make_course("loop", intr, num_frames=n, speed=0.5)
    frames = list(seq)
    lf = seq.loop_frame
    poses, _, _, _ = pipeline.run_sequence_scan(frames, cfg, intr, chunk=16,
                                                warmup=False, device="cpu")
    poses = poses[:n]
    new_poses, info = loopclosure.close_loops(
        poses, lambda i: frames[i], cfg, intr, keyframe_every=8, radius=12.0,
        min_separation=lf - 16, min_edge_inliers=3, max_measurements=16,
        gt_loop_pair=(0, lf), device="cpu")
    assert info.candidates and info.edges
    assert info.closure_after_m < info.closure_before_m, info[:4]
    gt = seq.poses[:n]
    err_new = np.linalg.norm(new_poses[:, :3, 3] - gt[:, :3, 3], axis=1)
    err_old = np.linalg.norm(poses[:, :3, 3] - gt[:, :3, 3], axis=1)
    assert np.sqrt((err_new ** 2).mean()) <= np.sqrt((err_old ** 2).mean()) * 1.05
    assert info.graph.nodes.shape[0] == len(np.unique(np.append(
        np.arange(0, n, 8), n - 1)))


@pytest.mark.parametrize("entry", ["build_keyframe_graph",
                                   "pose_graph_from_numpy",
                                   "make_edge_measure", "close_loops"])
def test_default_device_is_cuda(monkeypatch, small_course, entry):
    """Without a card and without device="cpu" the entry points raise
    instead of carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    intr = CameraIntrinsics(**INTR)
    cfg = VOConfig.for_image(H, W, ransac_iterations=RANSAC)
    eye = np.tile(np.eye(4), (3, 1, 1))
    calls = {
        "build_keyframe_graph": lambda: posegraph.build_keyframe_graph(
            eye, np.arange(3), []),
        "pose_graph_from_numpy": lambda: pose_graph_from_numpy(dict(
            nodes=eye, edges=np.array([[0, 1]]), rel=eye[:1],
            weight=np.ones(1))),
        "make_edge_measure": lambda: loopclosure.make_edge_measure(cfg, intr),
        "close_loops": lambda: loopclosure.close_loops(
            eye, lambda i: small_course[i], cfg, intr),
    }
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()
