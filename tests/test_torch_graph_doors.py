"""The per-frame doors, the buffered and stepwise batched steps, the pipe's
stages and the solvers replayed from CUDA graphs (``utils.cudagraph``).

On the CPU, where there are no graphs:

- every entry point refuses a graph (``_graph=True``, or inside
  ``dispatch(True)``), and its default is the eager
  path, bit for bit ``dispatch(False)``, with no graph asked for:
  ``VisualOdometry``, ``run_sequence_buffered``, the stepwise batched
  runner, the pipe, ``ba_solve``, ``posegraph_solve``, the loop-edge
  measurement;
- the same doors driven through their graph paths in the CPU form
  (``GraphedStep`` / ``GraphedLoop`` with ``_replay_body=True``: the static
  buffers and loops a capture records, each replay the body itself),
  against their eager runs bit for bit: ``VisualOdometry`` (with and
  without track snapshots, and checkpointed, restored and stepped on
  against an uninterrupted run), the buffered step, the stepwise batched
  runner, the loop-edge measurement, the pipe's two static stages
  (``GraphedStep.stage``), and the solver loop (``ba_solve`` plain and
  Huber, ``posegraph_solve``), which also stays within
  ``tests/test_torch_ba.py``'s and ``tests/test_torch_loopclosure.py``'s
  bounds of the JAX package;
- a state handed out is not overwritten by a later replay, the output row
  read on the card and on the host, a stage's feeds, replays and kept
  rows, a loop's captures keyed by its static leaves and bounded.

On a card (``cuda`` marker, skipped here): each graphed path against its
eager run bit for bit (outputs, poses, the final state, the generators'
state, launch counts), its first call (capture included) under sync-debug
"error" where the path makes no fetch, and the pipe's packet reuse over 64
frames on one card.

The card has no JAX: this file imports the JAX package only inside the
CPU tests that compare with it.

Alone on the CPU this file takes ~60 s (one core).
"""

import functools

import numpy as np
import pytest
import torch

from visual_odom_tpu_torch.ba import posegraph, problem, schur
from visual_odom_tpu_torch.core.lie import rodrigues
from visual_odom_tpu_torch.config import CameraIntrinsics, VOConfig
from visual_odom_tpu_torch.interop import (ba_problem_from_numpy,
                                           pose_graph_from_numpy)
from visual_odom_tpu_torch.io.synthetic import SyntheticStereoSequence
from visual_odom_tpu_torch.parallel import batch, pipe
from visual_odom_tpu_torch.parallel.batch_eval import run_sequences_batched
from visual_odom_tpu_torch.runner import loopclosure, pipeline
from visual_odom_tpu_torch.utils import cudagraph
from visual_odom_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                    restore_vo,
                                                    save_checkpoint)

torch.set_num_threads(1)

H, W = 120, 160
INTR = dict(fx=120.0, fy=120.0, cx=80.0, cy=60.0, bf=-64.8, width=W, height=H)
#: the plain LK quad makes a CPU step ~0.4 s at this size; neither count
#: changes what the static buffers must reproduce
CFG = dict(ransac_iterations=100, lk_max_iters=10)
N_FRAMES = 4
#: the pipe's packet-reuse run on the card
PIPE_FRAMES = 65


@pytest.fixture(scope="module")
def setup():
    intr = CameraIntrinsics(**INTR)
    cfg = VOConfig.for_image(H, W, **CFG)
    seqs = [SyntheticStereoSequence(intr, num_frames=N_FRAMES, seed=s)
            for s in (0, 1)]
    frames = [[seq.frame(i) for i in range(N_FRAMES)] for seq in seqs]
    return cfg, intr, frames


def _equal(a, b) -> bool:
    a, b = (x.cpu() if isinstance(x, torch.Tensor)
            else torch.from_numpy(np.array(x)) for x in (a, b))
    return a.dtype == b.dtype and a.shape == b.shape and bool(torch.equal(a, b))


def _flat(x) -> list:
    """The arrays of nested tuples, lists and dicts of tensors, arrays and
    scalars (a None holds none)."""
    if x is None:
        return []
    if isinstance(x, (torch.Tensor, np.ndarray)):
        return [x]
    if isinstance(x, dict):
        return [a for k in sorted(x) for a in _flat(x[k])]
    if isinstance(x, (tuple, list)):
        return [a for v in x for a in _flat(v)]
    return [np.asarray(x)]


def _same(a, b) -> bool:
    fa, fb = _flat(a), _flat(b)
    return len(fa) == len(fb) and all(_equal(x, y) for x, y in zip(fa, fb))


class _Frames:
    """A frame list as the resumable doors take it."""

    def __init__(self, frames):
        self.frames = frames

    def __len__(self):
        return len(self.frames)

    def frame(self, i):
        return self.frames[i]


def _ba_problem(dev="cpu"):
    """The port's synthetic BA problem (tests/test_torch_ba.py's size)."""
    return problem.synthetic_ba_problem(num_poses=6, num_landmarks=64,
                                        device=dev)[0]


def _pose_graph(dev="cpu", n=40):
    """A drifted circle of ``n`` keyframes closed by one loop edge, as
    tests/test_posegraph.py builds it, on ``dev``."""
    rng = np.random.default_rng(3)
    truth, est = [], [np.eye(4)]
    for k in range(n):
        th = 2 * np.pi * k / n
        T = np.eye(4)
        T[:3, :3] = rodrigues(torch.tensor([0.0, th, 0.0])).numpy()
        T[:3, 3] = [10.0 * np.sin(th), 0.0, 10.0 * (1 - np.cos(th))]
        truth.append(T)
    for k in range(n - 1):
        D = np.eye(4)
        D[:3, :3] = rodrigues(torch.from_numpy(
            rng.normal(0, 0.004, 3).astype(np.float32))).numpy()
        D[:3, 3] = rng.normal(0, 0.02, 3)
        est.append(est[-1] @ np.linalg.inv(truth[k]) @ truth[k + 1] @ D)
    rel = np.linalg.inv(truth[0]) @ truth[-1]
    return posegraph.build_keyframe_graph(np.stack(est), np.arange(n),
                                          [(0, n - 1, rel, 10.0)],
                                          device=dev)


def _jax_ba_problem(obs_window):
    """JAX's synthetic problem and the port's copy of it."""
    from visual_odom_tpu.ba import problem as jproblem

    jp, _, _ = jproblem.synthetic_ba_problem(num_poses=6, num_landmarks=64,
                                             obs_window=obs_window)
    return jp, ba_problem_from_numpy(
        {k: np.asarray(v) for k, v in jp._asdict().items()}, device="cpu")


def _jax_pose_graph():
    """tests/test_posegraph.py's drifted circle: JAX's graph and the
    port's copy of it."""
    from test_posegraph import _circle_truth, _drifted_chain
    from visual_odom_tpu.ba import posegraph as jpg

    truth = _circle_truth(40)
    est = _drifted_chain(truth)
    true_rel = np.linalg.inv(truth[0]) @ truth[-1]
    jg = jpg.build_keyframe_graph(est, np.arange(len(est)),
                                  [(0, len(est) - 1, true_rel, 10.0)])
    return jg, pose_graph_from_numpy(
        {k: np.asarray(v) for k, v in jg._asdict().items()}, device="cpu")


# --- the doors, as a test calls them ----------------------------------------


def _doors(cfg, intr, frames, dev="cpu"):
    """Each door's run on the course, by name: a function of no argument
    returning what the door returns (poses, outputs, ...)."""
    frames0 = frames[0]

    def vo(with_tracks=False):
        v = pipeline.VisualOdometry(cfg, intr, seed=3, with_tracks=with_tracks,
                                    device=dev)
        v.initialize(*frames0[0])
        results, tracks = [], []
        for left, right in frames0[1:]:
            results.append(v.process_frame(left, right))
            tracks.append(v.last_tracks)
        return ([tuple(r[1:-1]) for r in results], tracks,
                pipeline.state_arrays(v.state))

    def edge():
        measure = loopclosure.make_edge_measure(cfg, intr, device=dev)
        return [measure(frames0[0], frames0[j]) for j in (1, 2)]

    return {
        "VisualOdometry": vo,
        "run_sequence_buffered": lambda: pipeline.run_sequence_buffered(
            frames0, cfg, intr, seed=3, device=dev)[:2],
        "stepwise_batched": lambda: run_sequences_batched(
            frames, cfg, intr, seed=3, chunk=0, device=dev)[:2],
        "pipe": lambda: pipe.run_sequence_pipelined(
            frames0, cfg, intr, devices=[dev, dev], seed=3)[:2],
        "ba_solve": lambda: [schur.ba_solve(_ba_problem(dev), iterations=4,
                                            huber_delta=h)
                             for h in (0.0, 1.5)],
        "posegraph_solve": lambda: posegraph.posegraph_solve(
            _pose_graph(dev), iterations=5),
        "edge_measure": edge}


DOORS = ["VisualOdometry", "run_sequence_buffered", "stepwise_batched",
         "pipe", "ba_solve", "posegraph_solve", "edge_measure"]


@pytest.fixture(scope="module")
def eager_runs(setup):
    """Every door's eager run on the CPU, by name (and VisualOdometry with
    track snapshots)."""
    cfg, intr, frames = setup
    doors = _doors(cfg, intr, frames)
    with cudagraph.dispatch(False):
        runs = {name: doors[name]() for name in DOORS}
        runs["VisualOdometry_tracks"] = doors["VisualOdometry"](True)
    return runs


@pytest.fixture
def no_graphs(monkeypatch):
    """Make building any graph fail the test."""
    def refuse(*args, **kwargs):
        raise AssertionError("a graph was asked for")

    monkeypatch.setattr(cudagraph.GraphedStep, "__init__", refuse)
    monkeypatch.setattr(cudagraph.GraphedLoop, "__init__", refuse)


@pytest.fixture
def body_form(monkeypatch):
    """Route every door to its graph path, in the CPU form: the same
    static buffers, loops and hand-overs, each replay the body itself."""
    def use(device, graphed=None):
        graphed = cudagraph._DISPATCH if graphed is None else graphed
        return graphed is not False

    @functools.lru_cache(maxsize=None)
    def graphed_step(config, intrinsics, with_tracks, device):
        return cudagraph.GraphedStep(pipeline.make_step_fn(
            config, intrinsics, with_tracks=with_tracks, device=device),
            device, _replay_body=True)

    @functools.lru_cache(maxsize=None)
    def graphed_stages(config, intrinsics, front, back):
        steps = pipe._stage_steps(config, intrinsics, (front, back))
        return tuple(cudagraph.GraphedStep(f, d, _replay_body=True)
                     for f, d in zip(steps, (front, back)))

    @functools.lru_cache(maxsize=None)
    def ba_loop(damping, huber_delta, device):
        return cudagraph.GraphedLoop(functools.partial(
            schur.ba_gauss_newton_step, damping=damping,
            huber_delta=huber_delta), device, _replay_body=True)

    @functools.lru_cache(maxsize=None)
    def pg_loop(damping, device):
        return cudagraph.GraphedLoop(functools.partial(
            posegraph._gn_iteration, damping=damping), device,
            _replay_body=True)

    for mod in (cudagraph, pipeline, loopclosure, pipe, schur, posegraph):
        monkeypatch.setattr(mod, "use_graph", use)
        if hasattr(mod, "_graphed_step"):
            monkeypatch.setattr(mod, "_graphed_step", graphed_step)
    monkeypatch.setattr(batch, "use_graph_on", use)
    monkeypatch.setattr(batch, "_graphed_step", graphed_step)
    monkeypatch.setattr(pipe, "_graphed_stages", graphed_stages)
    monkeypatch.setattr(schur, "_graphed_solve", ba_loop)
    monkeypatch.setattr(posegraph, "_graphed_solve", pg_loop)
    return graphed_step


# --- no graphs on the CPU ---------------------------------------------------


@pytest.mark.parametrize("entry", [
    "VisualOdometry", "make_buffered_step_fn", "make_batched_step_fn",
    "run_sequence_pipelined", "ba_solve", "posegraph_solve",
    "make_edge_measure", "GraphedLoop"])
def test_graph_on_cpu_raises(setup, entry):
    """``VisualOdometry(_graph=True)``, every other entry point inside
    ``dispatch(True)``, and a ``GraphedLoop`` on the CPU raise."""
    cfg, intr, frames = setup
    calls = {
        "VisualOdometry": lambda: pipeline.VisualOdometry(
            cfg, intr, device="cpu", _graph=True),
        "make_buffered_step_fn": lambda: pipeline.make_buffered_step_fn(
            cfg, intr, device="cpu"),
        "make_batched_step_fn": lambda: batch.make_batched_step_fn(
            cfg, intr, device="cpu"),
        "run_sequence_pipelined": lambda: pipe.run_sequence_pipelined(
            frames[0], cfg, intr, devices=["cpu", "cpu"]),
        "ba_solve": lambda: schur.ba_solve(_ba_problem()),
        "posegraph_solve": lambda: posegraph.posegraph_solve(_pose_graph()),
        "make_edge_measure": lambda: loopclosure.make_edge_measure(
            cfg, intr, device="cpu"),
        "GraphedLoop": lambda: cudagraph.GraphedLoop(lambda c: c, "cpu")}
    with cudagraph.dispatch(entry != "VisualOdometry"), \
            pytest.raises(ValueError, match="CUDA graph needs a card"):
        calls[entry]()


@pytest.mark.parametrize("door", DOORS)
def test_cpu_default_is_the_eager_step(setup, eager_runs, door, no_graphs):
    """On the CPU each door's default builds no graph and gives what it
    gives inside ``dispatch(False)``, bit for bit."""
    cfg, intr, frames = setup
    with cudagraph.dispatch(False):
        eager = _doors(cfg, intr, frames)[door]()
    assert _same(eager_runs[door], eager)


def test_dispatch_and_use_graph():
    """None picks by device, inside ``dispatch`` its choice, an explicit
    choice wins; a graph on the CPU raises."""
    assert not cudagraph.use_graph("cpu")
    assert cudagraph.use_graph("cuda")
    assert not cudagraph.use_graph("cuda", False)
    with cudagraph.dispatch(False):
        assert not cudagraph.use_graph("cuda")
        assert cudagraph.use_graph("cuda", True)
        with cudagraph.dispatch(True):
            assert cudagraph.use_graph("cuda")
        assert not cudagraph.use_graph("cuda")
    assert cudagraph._DISPATCH is None
    with pytest.raises(ValueError, match="CUDA graph needs a card"):
        cudagraph.use_graph("cpu", True)


# --- the graph paths in the CPU form ----------------------------------------


@pytest.mark.parametrize("door", ["VisualOdometry", "run_sequence_buffered",
                                  "stepwise_batched", "edge_measure", "pipe"])
def test_static_path_equals_eager(setup, eager_runs, door, body_form):
    """The door through its graph path (static buffers, one body run per
    replay) gives the eager run bit for bit: outputs, poses, the final
    state's arrays and its generator's state."""
    cfg, intr, frames = setup
    got = _doors(cfg, intr, frames)[door]()
    assert _same(got, eager_runs[door])
    assert body_form.cache_info().currsize == (door != "pipe")


def test_static_vo_with_tracks_equals_eager(setup, eager_runs, body_form):
    """``with_tracks``: the track snapshots come back from the same row,
    each frame's bit for bit the eager step's."""
    cfg, intr, frames = setup
    got = _doors(cfg, intr, frames)["VisualOdometry"](True)
    assert _same(got, eager_runs["VisualOdometry_tracks"])
    assert all(t is not None and t.points_l1.shape == (cfg.padded_features, 2)
               for t in got[1])


def test_stage_feeds_replays_and_keeps(setup):
    """``GraphedStep.stage``, the pipe's way in: frames fed into the input
    buffers, one replay each, give the eager step's outputs frame by
    frame; the kept rows stack to the eager outputs; the caller's
    generator ends where eager's ends."""
    cfg, intr, frames = setup
    fr = frames[0]
    step = pipeline.make_step_fn(cfg, intr, device="cpu")
    g = cudagraph.GraphedStep(step, "cpu", _replay_body=True)
    state = pipeline.init_vo_state(cfg, intr, *fr[0], seed=4, device="cpu")
    ref = pipeline.init_vo_state(cfg, intr, *fr[0], seed=4, device="cpu")
    eager = []
    with g.stage(state, *fr[1]) as stage:
        for left, right in fr[1:]:
            stage.feed([torch.from_numpy(left), torch.from_numpy(right)])
            got = stage.replay(keep=True)
            ref, out = step(ref, torch.from_numpy(left),
                            torch.from_numpy(right))
            eager.append(out)
            assert _same(got, (out,))
        kept = stage.kept()
    assert _same(kept[0], pipeline.StepOutput(
        *(torch.stack(x) for x in zip(*eager))))
    assert _equal(state.generator.get_state(), ref.generator.get_state())


def test_vo_checkpoint_restore_through_static_path(setup, body_form,
                                                   tmp_path):
    """A ``VisualOdometry`` stepping through the static path, checkpointed
    after frame 1 (its state read out of the buffers' copy), restored into
    a new one (a foreign state loaded into the buffers) and stepped on,
    equals an uninterrupted eager run."""
    cfg, intr, frames = setup
    fr = frames[0]
    with cudagraph.dispatch(False):
        ref = pipeline.VisualOdometry(cfg, intr, seed=5, device="cpu")
        ref.initialize(*fr[0])
        ref_results = [ref.process_frame(*f) for f in fr[1:]]
    vo = pipeline.VisualOdometry(cfg, intr, seed=5, device="cpu")
    assert vo._graphed is not None
    vo.initialize(*fr[0])
    first = vo.process_frame(*fr[1])
    path = str(tmp_path / "vo.npz")
    save_checkpoint(path, vo)
    vo2 = pipeline.VisualOdometry(cfg, intr, seed=99, device="cpu")
    start = restore_vo(vo2, load_checkpoint(path), *fr[1])
    assert start == 2
    rest = [vo2.process_frame(*f) for f in fr[2:]]
    got = [first] + rest
    assert _same([tuple(r[1:-1]) for r in got],
                 [tuple(r[1:-1]) for r in ref_results])
    assert _same(pipeline.state_arrays(vo2.state),
                 pipeline.state_arrays(ref.state))


def test_state_handed_out_is_not_overwritten(setup):
    """A per-frame call hands out a copy of the buffers: a later call (and
    a state handed to another sequence) leaves it as it was; the state
    returned last is not copied in again, any other state is."""
    cfg, intr, frames = setup
    fr = frames[0]
    step = pipeline.make_step_fn(cfg, intr, device="cpu")
    g = cudagraph.GraphedStep(step, "cpu", _replay_body=True)
    s0 = pipeline.init_vo_state(cfg, intr, *fr[0], seed=1, device="cpu")
    s1, out1 = g(s0, *fr[1])
    kept = [t.clone() for t in cudagraph.state_tensors(s1)]
    kept_out = [x.clone() for x in out1]
    s2, _ = g(s1, *fr[2])
    static = next(iter(g.captures.values())).static
    assert static.loads == 1
    other = pipeline.init_vo_state(cfg, intr, *fr[1], seed=2, device="cpu")
    g(other, *fr[2])
    assert static.loads == 2
    assert all(torch.equal(a, b) for a, b in zip(cudagraph.state_tensors(s1),
                                                 kept))
    assert all(torch.equal(a, b) for a, b in zip(out1, kept_out))
    views = cudagraph.state_tensors(s2)
    assert all(t.untyped_storage().data_ptr()
               == views[0].untyped_storage().data_ptr() for t in views)
    assert views[0].untyped_storage().data_ptr() != \
        static.flat.untyped_storage().data_ptr()


def test_output_row_on_card_and_host_unpack_as_the_stack(setup):
    """One packed row read as views (``unpack_row``) and on the host
    (``unpack_host``) gives what a one-row stack unpacks to, field by
    field, dtype and shape included."""
    cfg, intr, frames = setup
    step = pipeline.make_step_fn(cfg, intr, with_tracks=True, device="cpu")
    state = pipeline.init_vo_state(cfg, intr, *frames[0][0], device="cpu")
    _, *outs = step(state, *(torch.from_numpy(x) for x in frames[0][1]))
    layout = cudagraph.OutputLayout(outs)
    row = torch.zeros(layout.nbytes, dtype=torch.uint8)
    row[:layout.used] = layout.pack(outs)
    ref = layout.unpack(row[None])
    views = layout.unpack_row(row)
    host = layout.unpack_host(row.numpy())
    for r, v, h in zip(ref, views, host):
        assert type(r) is type(v) is type(h)
        for a, b, c in zip(r, v, h):
            assert _equal(a[0], b) and _equal(a[0], c)
            assert b.is_contiguous()
            assert b.untyped_storage().data_ptr() == \
                row.untyped_storage().data_ptr()


@pytest.mark.parametrize("huber", [0.0, 1.5], ids=["plain", "huber"])
@pytest.mark.parametrize("obs_window", [None, 2], ids=["dense", "window2"])
def test_ba_solver_loop_equals_eager_and_jax(obs_window, huber):
    """The solver loop (one GN step on static buffers per replay, the body
    in the replay's place) against eager ``ba_solve`` bit for bit, and
    JAX's within ``tests/test_torch_ba.py``'s bounds; the observations
    and mask come back as the caller's own tensors."""
    from test_torch_ba import SOLVE_LM_TOL, SOLVE_POSE_TOL
    from visual_odom_tpu.ba import schur as jschur

    jp, tp = _jax_ba_problem(obs_window)
    loop = cudagraph.GraphedLoop(functools.partial(
        schur.ba_gauss_newton_step, huber_delta=huber), "cpu",
        _replay_body=True)
    got = loop(tp, 8)
    eager = schur.ba_solve(tp, iterations=8, huber_delta=huber)
    assert _equal(got.poses, eager.poses)
    assert _equal(got.landmarks, eager.landmarks)
    assert got.observations is tp.observations and got.mask is tp.mask
    assert not torch.equal(got.poses, tp.poses)
    ref = jschur.ba_solve(jp, iterations=8, huber_delta=huber)
    assert np.abs(got.poses.numpy() - np.asarray(ref.poses)).max() \
        < SOLVE_POSE_TOL
    assert np.abs(got.landmarks.numpy()
                  - np.asarray(ref.landmarks)).max() < SOLVE_LM_TOL
    again = loop(tp, 8)
    assert len(loop.captures) == 1 and _equal(again.poses, got.poses)


def test_posegraph_solver_loop_equals_eager_and_jax():
    """The same loop over one pose-graph GN update: bit for bit the eager
    ``posegraph_solve``, within ``NODE_TOL`` of JAX's; only the nodes are
    copied out."""
    from test_torch_loopclosure import NODE_TOL
    from visual_odom_tpu.ba import posegraph as jpg

    jg, g = _jax_pose_graph()
    loop = cudagraph.GraphedLoop(functools.partial(posegraph._gn_iteration,
                                               damping=1e-4), "cpu",
                             _replay_body=True)
    carry = (g.nodes, g.edges, posegraph._se3_inv(g.rel), g.weight)
    got = loop(carry, 10)
    eager = posegraph.posegraph_solve(g, iterations=10)
    assert _equal(got[0], eager.nodes)
    assert got[1] is g.edges and got[3] is g.weight
    ref = np.asarray(jpg.posegraph_solve(jg, iterations=10).nodes)
    assert np.abs(got[0].numpy() - ref).max() < NODE_TOL


def test_loop_captures_keyed_by_static_leaves_and_bounded(monkeypatch):
    """Another problem shape, or the same shape under other intrinsics,
    is another capture; the ``_MAX_LOOP_CAPTURES`` used last are kept; zero
    iterations hand the carry back."""
    monkeypatch.setattr(cudagraph, "_MAX_LOOP_CAPTURES", 2)
    tp = _ba_problem()
    loop = cudagraph.GraphedLoop(schur.ba_gauss_newton_step, "cpu",
                                 _replay_body=True)
    assert loop(tp, 0) is tp
    loop(tp, 1)
    loop(tp._replace(fx=tp.fx * 1.01), 1)
    assert len(loop.captures) == 2
    p4 = problem.synthetic_ba_problem(num_poses=4, num_landmarks=32,
                                      device="cpu")[0]
    loop(p4, 1)
    assert len(loop.captures) == 2
    assert list(loop.captures)[-1][0] == cudagraph._key(p4)
    assert cudagraph.static_leaves(tp) == (tp.fx, tp.fy, tp.cx, tp.cy, tp.bf)


def test_loop_keeps_the_captures_used_last():
    """At the module's bound: one shape more than it keeps evicts the
    capture used least lately, and a call on that shape captures again."""
    loop = cudagraph.GraphedLoop(lambda c: (c[0] + 1,), "cpu",
                                 _replay_body=True)
    n = cudagraph._MAX_LOOP_CAPTURES
    for k in range(1, n + 1):
        assert torch.equal(loop((torch.zeros(k),), 2)[0],
                           torch.full((k,), 2.0))
    loop((torch.zeros(1),), 1)      # shape 1 is now the one used last
    loop((torch.zeros(n + 1),), 1)
    shapes = [key[0][0][0][0] for key in loop.captures]
    assert len(shapes) == n and (2,) not in shapes
    assert shapes[-2:] == [(1,), (n + 1,)]
    loop((torch.zeros(2),), 1)
    assert len(loop.captures) == n and (3,) not in [
        key[0][0][0][0] for key in loop.captures]


# --- on the card ------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _card_run(fn, graphed):
    """``fn()`` graphed or eager, with the LK launches it counted."""
    before = cudagraph.launch_counts()
    with cudagraph.dispatch(graphed):
        out = fn()
    torch.cuda.synchronize()
    after = cudagraph.launch_counts()
    return out, {k: after[k] - before[k] for k in after}


@pytest.mark.cuda
@pytest.mark.parametrize("door", DOORS)
def test_graphed_door_equals_eager_on_card(setup, cuda_device, door):
    """Each door graphed against eager on the card: every output, the
    poses, the final state and its generator's state, bit for bit; the
    same launches counted."""
    cfg, intr, frames = setup
    fn = _doors(cfg, intr, frames, dev=cuda_device)[door]
    (eager, ec), (got, gc) = (_card_run(fn, g) for g in (False, True))
    assert _same(got, eager)
    assert ec == gc


@pytest.mark.cuda
def test_graphed_vo_with_tracks_and_resume_on_card(setup, cuda_device,
                                                   tmp_path):
    """``run_sequence(collect_tracks=True)`` and ``run_sequence_resumable``
    (failed after its first snapshot, resumed) graphed against eager."""
    cfg, intr, frames = setup
    seq = SyntheticStereoSequence(CameraIntrinsics(**INTR), num_frames=7,
                                  seed=0)
    fr = [seq.frame(i) for i in range(7)]

    def runs():
        a = pipeline.run_sequence(fr, cfg, intr, collect_tracks=True,
                                  device=cuda_device)
        path = str(tmp_path / f"ck{cudagraph._DISPATCH}.npz")

        class Flaky(_Frames):
            def frame(self, i):
                if i >= 4:
                    raise RuntimeError("injected")
                return super().frame(i)

        with pytest.raises(RuntimeError, match="injected"):
            pipeline.run_sequence_resumable(Flaky(fr), cfg, intr, path,
                                            checkpoint_every=2,
                                            device=cuda_device)
        b = pipeline.run_sequence_resumable(_Frames(fr), cfg, intr, path,
                                            checkpoint_every=2,
                                            device=cuda_device)
        return a[0], [tuple(r[1:-1]) for r in a[1]], a[2], b[0]

    (eager, _), (got, _) = (_card_run(runs, g) for g in (False, True))
    assert _same(got, eager)
    assert np.array_equal(got[3], got[0])


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["call", "buffered", "stepwise_batched",
                                  "ba_solve", "posegraph_solve"])
def test_first_graphed_call_makes_no_host_sync(setup, cuda_device, path):
    """The first call of each path that makes no fetch (the capture
    included) runs under sync-debug "error"; the buffered step's whole
    frame loop does."""
    cfg, intr, frames = setup
    dev = cuda_device
    for cached in (pipeline._graphed_step, schur._graphed_solve,
                   posegraph._graphed_solve):
        cached.cache_clear()
    fr = [tuple(torch.from_numpy(x).to(dev) for x in f) for f in frames[0]]
    state = pipeline.init_vo_state(cfg, intr, *fr[0], device=dev)
    if path == "stepwise_batched":
        state = batch.batched_init_state(cfg, *(torch.stack(
            [torch.from_numpy(s[0][k]) for s in frames]).to(dev)
            for k in (0, 1)), device=dev)
    tp = _ba_problem(dev)
    pg = _pose_graph(dev)
    bufs = pipeline.make_output_buffers(len(fr) - 1, device=dev)
    torch.cuda.synchronize()
    # Build each path's step (its device constants are uploaded here) and
    # call it first under the check: the capture happens in that call.
    graphed = pipeline._graphed_step(cfg, intr, False, dev)
    buffered = pipeline.make_buffered_step_fn(cfg, intr, device=dev)
    batched = batch.make_batched_step_fn(cfg, intr, device=dev)
    pair = [torch.stack([x, x]) for x in fr[1]]
    calls = {
        "call": lambda: graphed(state, *fr[1]),
        "buffered": lambda: functools.reduce(
            lambda sb, f: buffered(*sb[:1], *f, sb[1]), fr[1:],
            (state, bufs)),
        "stepwise_batched": lambda: batched(state, *pair),
        "ba_solve": lambda: schur.ba_solve(tp, iterations=3),
        "posegraph_solve": lambda: posegraph.posegraph_solve(pg,
                                                             iterations=3)}
    assert not graphed.captures
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = calls[path]()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(x.float()).all())
               for x in _flat(out) if isinstance(x, torch.Tensor))
    if path == "buffered":
        assert bufs.idx.tolist() == [len(fr) - 1]


@pytest.mark.cuda
def test_graphed_pipe_reuses_its_packet_over_64_frames(cuda_device):
    """The pipe on one card, both stages graphed, over 64 frames: the
    frontend's row is overwritten every frame while the backend may still
    be reading the copy before it; every output equals the eager pipe's
    and the scan's bit for bit, and the loop makes no host sync."""
    intr = CameraIntrinsics(**INTR)
    cfg = VOConfig.for_image(H, W, **CFG)
    seq = SyntheticStereoSequence(intr, num_frames=PIPE_FRAMES, seed=4)
    fr = [seq.frame(i) for i in range(PIPE_FRAMES)]
    devs = [cuda_device, cuda_device]
    real = pipe._pipeline_loop
    strict = []

    def strict_loop(*args):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return real(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
            strict.append(True)

    pipe._pipeline_loop = strict_loop
    try:
        got = pipe.run_sequence_pipelined(fr, cfg, intr, devices=devs)
    finally:
        pipe._pipeline_loop = real
    with cudagraph.dispatch(False):
        eager = pipe.run_sequence_pipelined(fr, cfg, intr, devices=devs)
    scan = pipeline.run_sequence_scan(fr, cfg, intr, chunk=16,
                                      device=cuda_device)
    assert strict == [True]
    assert _same(got[:2], eager[:2])
    assert np.array_equal(got[0], scan[0])
    assert np.array_equal(got[1].num_inliers, scan[1].num_inliers)


@pytest.mark.cuda
def test_graphed_pipe_across_two_cards(cuda_device):
    """Frontend graph on card 0, backend graph on card 1, the packet a
    peer copy between them: equal to the eager pipe bit for bit; skips
    with fewer than two cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    intr = CameraIntrinsics(**INTR)
    cfg = VOConfig.for_image(H, W, **CFG)
    seq = SyntheticStereoSequence(intr, num_frames=17, seed=4)
    fr = [seq.frame(i) for i in range(17)]
    got = pipe.run_sequence_pipelined(fr, cfg, intr)
    with cudagraph.dispatch(False):
        eager = pipe.run_sequence_pipelined(fr, cfg, intr)
    assert _same(got[:2], eager[:2])
