"""The multi-device paths replayed from CUDA graphs (``utils.cudagraph``):
the batched step and scan on a (data, model) mesh, one process or one rank
per position, and ``sharded_ba_solve``, ``ring_ba_solve`` and
``sharded_posegraph_solve``.

On the CPU, where there are no graphs:

- each path driven through its graph path in the CPU form
  (``tests/torch_dist_worker.body_form``: the ``GraphedStep`` and
  ``GraphedLoop`` static buffers and loops a capture records, each replay
  the body itself) against its eager run (``dispatch(False)``) bit for
  bit, on meshes of the CPU named 2 and 4 times: the mesh step on (2, 1),
  (1, 2), (2, 2) and (1, 4) meshes on both LK routes, the chunked scan,
  the stepwise batched runner (its graphs captured before its loop), the
  three solvers; outputs, the final state, the generators' state and the
  launches counted, with one replay per row and step or per iteration;
- the (2, 1) mesh step through its graph path, fed the JAX package's
  RANSAC draws, against JAX's jitted sharded batched step on a (2, 1)
  CPU mesh (tests/test_torch_batch_mesh.py's course, state and bounds);
- the dispatch rule (``parallel.collectives.graph_place``): a gloo
  ``RankAxis`` steps eagerly, and a graph asked for there raises; an NCCL
  ``RankAxis`` in a world of 1, 2 or 4 ranks and a one-process row across
  cards replay graphs; every batched step carries ``capture``;
- 2 and 4 gloo ranks (``tests/torch_dist_worker.py``, scenario
  ``graph``): by default they build no graph and give the one-process
  eager results bit for bit; in the CPU form of the graph paths, the same;
  there every path's captures issue the same collectives in the same
  order on every rank of each group (a graph whose collectives differ
  between ranks hangs on NCCL), and destroying the process group first
  releases every capture that holds its collectives.

On the card (``cuda`` marker, skipped here): each path graphed against
``dispatch(False)`` bit for bit on this card named 2 and 4 times, the
first call of each under sync-debug "error"; one NCCL rank at world size
1; across 2 and 4 cards (they skip with fewer) one process (rows of one
card graphed on their own card, rows and solvers across cards graphed
card by card) and one rank per card (scenario ``card_graph``, the kernels
built before the ranks start; graphs built on every rank). The card
has no JAX: this file imports the JAX package only inside the test that
compares with it.

Alone on the CPU this file takes ~140 s (one core).
"""


import numpy as np
import pytest
import torch

import torch_dist_worker as wk
from visual_odom_tpu_torch.ba import posegraph
from visual_odom_tpu_torch.config import CameraIntrinsics, VOConfig
from visual_odom_tpu_torch.interop import state_from_numpy
from visual_odom_tpu_torch.ops import lk_cuda
from visual_odom_tpu_torch.parallel import batch, collectives
from visual_odom_tpu_torch.parallel.batch_eval import run_sequences_batched
from visual_odom_tpu_torch.parallel.mesh import make_mesh
from visual_odom_tpu_torch.runner import pipeline
from visual_odom_tpu_torch.utils import cudagraph

torch.set_num_threads(1)

CPU = torch.device("cpu")
#: meshes of one device named 2 and 4 times
MESHES = [(2, 1), (1, 2), (2, 2), (1, 4)]
ROUTES = ("pallas", "xla")
SOLVERS = ("sharded_ba", "ring_halo2", "ring_huber", "posegraph")


def _ids(shape):
    return f"{shape[0]}x{shape[1]}"


def _mesh(data, model, dev=CPU):
    return make_mesh({"data": data, "model": model},
                     devices=[dev] * (data * model))


def _equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        a, b = a.cpu(), b.cpu()
        return (a.dtype == b.dtype and a.shape == b.shape
                and bool(torch.equal(a, b)))
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b)
    return a == b


def _replays(made) -> int:
    """The replays made by the graph objects of a ``body_form`` block."""
    return sum(sum(wk.replays(graphs)) for graphs in made.values())


@pytest.fixture
def body_form():
    with wk.body_form() as made:
        yield made


# --- the mesh step and scan in the CPU form of their graph paths ------------


@pytest.fixture(scope="module")
def sequences():
    return wk.graph_sequences()


def _run(fn):
    """``fn()`` with the launches it counted."""
    return wk._counted(fn)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("shape", MESHES, ids=_ids)
def test_mesh_step_through_its_graphs_equals_eager(sequences, shape, route,
                                                   body_form):
    """Every output of every step, the final state and its generators'
    state, bit for bit, and the same launches; one replay per row and
    step."""
    cfg = wk.batch_config(route)
    with cudagraph.dispatch(False):
        eager = _run(lambda: wk.mesh_step_run(cfg, sequences, _mesh(*shape)))
    got = _run(lambda: wk.mesh_step_run(cfg, sequences, _mesh(*shape)))
    assert _equal(got, eager)
    assert _replays(body_form) == shape[0] * wk.GRAPH_STEPS


@pytest.mark.parametrize("shape", MESHES, ids=_ids)
def test_mesh_scan_through_its_graphs_equals_eager(sequences, shape,
                                                   body_form):
    cfg = wk.batch_config("pallas")
    with cudagraph.dispatch(False):
        eager = _run(lambda: wk.mesh_scan_run(cfg, sequences, _mesh(*shape)))
    got = _run(lambda: wk.mesh_scan_run(cfg, sequences, _mesh(*shape)))
    assert _equal(got, eager)
    assert _replays(body_form) == shape[0] * wk.GRAPH_STEPS


def test_stepwise_runner_captures_before_its_loop(sequences, body_form,
                                                  monkeypatch):
    """``run_sequences_batched(chunk=0)`` on a (2, 2) mesh captures every
    row's graph before its wall (``step.capture``) and gives the eager
    run's poses and stats bit for bit."""
    cfg, intr = wk.batch_config("pallas"), CameraIntrinsics(**wk.INTR)
    with cudagraph.dispatch(False):
        eager = run_sequences_batched(sequences, cfg, intr, seed=2, chunk=0,
                                      mesh=_mesh(2, 2))
    captured = []
    real = cudagraph.GraphedStep.capture

    def capture(self, *args):
        captured.append(sum(wk.replays([self])))
        return real(self, *args)

    monkeypatch.setattr(cudagraph.GraphedStep, "capture", capture)
    got = run_sequences_batched(sequences, cfg, intr, seed=2, chunk=0,
                                mesh=_mesh(2, 2))
    assert _equal(list(got[0]), list(eager[0])) and got[1] == eager[1]
    assert captured == [0, 0]        # both rows, before any replay
    assert _replays(body_form) == 2 * wk.GRAPH_STEPS


# --- the solvers --------------------------------------------------------------


@pytest.fixture(scope="module")
def solves():
    """The solvers over 2 and 4 CPU devices, by D: eager, and through their
    graph paths in the CPU form with the replays each loop made."""
    with cudagraph.dispatch(False):
        eager = {D: wk.graph_solvers([CPU] * D, D) for D in (2, 4)}
    body = {}
    for D in (2, 4):
        with wk.body_form() as made:
            body[D] = (wk.graph_solvers([CPU] * D, D),
                       {k: wk.replays(v) for k, v in made.items()})
    return eager, body


@pytest.mark.parametrize("solver", SOLVERS)
@pytest.mark.parametrize("D", [2, 4])
def test_solver_through_its_graph_equals_eager(solves, D, solver):
    """The solved poses and landmarks (nodes) bit for bit, with the same
    launches (none); one replay per iteration, per round for the ring
    (one loop for each of its two problems' halo and Huber scale)."""
    eager, body = solves
    got, replays = body[D]
    assert _equal(got[solver], eager[D][solver])
    assert replays["one_device"] == replays["split"] == []
    assert replays[solver.split("_")[0] if solver.startswith("ring")
                   else solver] == [wk.GRAPH_ITERS] * (
        2 if solver.startswith("ring") else 1)


# --- against JAX's jitted sharded step ----------------------------------------


def test_2x1_mesh_graph_path_matches_jax_2x1_mesh(body_form, monkeypatch):
    """Frames 4..6 of two sequences from JAX's batched state after frame 3
    (tests/test_torch_batch_mesh.py::test_2x1_mesh_step_matches_jax_2x1_mesh's
    course), the port's (2, 1) mesh step through its graph path, each
    replay drawing JAX's RANSAC uniforms for its sequence (the PnP draw
    reads them by the sequence's generator seed): the counts equal and
    T^-1 within tests/test_torch_batch.py's ROT_TOL and TRANS_TOL."""
    import jax
    import jax.numpy as jnp
    from test_torch_batch import ROT_TOL, TRANS_TOL, _numpy_state
    from test_torch_batch_mesh import CFG, _row_state, _seqs, _stack
    from visual_odom_tpu.config import CameraIntrinsics as JIntrinsics
    from visual_odom_tpu.config import VOConfig as JVOConfig
    from visual_odom_tpu.parallel.batch import batched_init_state as jinit
    from visual_odom_tpu.parallel.batch import make_batched_step_fn as jstep_fn
    from visual_odom_tpu.parallel.mesh import make_mesh as jax_mesh

    H, W, ransac = wk.H, wk.W, CFG["ransac_iterations"]
    frames = _seqs((10, 10))
    jcfg = JVOConfig.for_image(H, W, ransac_iterations=ransac)
    cfg = VOConfig.for_image(H, W, ransac_iterations=ransac)
    jm = jax_mesh({"data": 2, "model": 1})
    jstep = jstep_fn(jcfg, JIntrinsics(**wk.INTR), jm)
    jst = jinit(jcfg, *_stack(frames, 0), jm, seed=0)
    for i in (1, 2, 3):
        jst, _ = jstep(jst, *(jnp.asarray(x) for x in _stack(frames, i)))
    d = _numpy_state(jst)
    st = batch.MeshState(tuple(state_from_numpy(_row_state(d, b, b + 1),
                                                seed=b, device="cpu")
                               for b in range(2)))
    draws = {}
    real = pipeline.pnp_ransac

    def fed(*args, generator=None, uniforms=None, **kw):
        if uniforms is None:
            uniforms = torch.stack([draws[g.initial_seed()]
                                    for g in generator])
        return real(*args, generator=generator, uniforms=uniforms, **kw)

    monkeypatch.setattr(pipeline, "pnp_ransac", fed)
    step = batch.make_batched_step_fn(cfg, CameraIntrinsics(**wk.INTR),
                                      mesh=_mesh(2, 1))
    for i in (4, 5, 6):
        for b, k in enumerate(jst.key):
            draws[b] = torch.tensor(np.asarray(jax.random.uniform(
                jax.random.split(k)[1], (ransac, cfg.padded_features))))
        lefts, rights = _stack(frames, i)
        jst, ref = jstep(jst, jnp.asarray(lefts), jnp.asarray(rights))
        st, out = step(st, torch.from_numpy(lefts), torch.from_numpy(rights))
        for name in ("num_bucketed", "num_matched", "num_inliers", "accept"):
            np.testing.assert_array_equal(getattr(out, name).numpy(),
                                          np.asarray(getattr(ref, name)),
                                          name)
        dT = np.abs(out.T_inv.numpy() - np.asarray(ref.T_inv))
        assert dT[:, :3, :3].max() < ROT_TOL and dT[:, :3, 3].max() < TRANS_TOL
    assert _replays(body_form) == 2 * 3


# --- the dispatch rule --------------------------------------------------------


@pytest.fixture
def gloo_axis(tmp_path):
    """A ``RankAxis`` of this process's world-size-1 gloo group, its one
    position on a card."""
    dist = torch.distributed
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        yield collectives.RankAxis(ranks=(0,),
                                   devices=(torch.device("cuda", 0),),
                                   index=0, group=dist.group.WORLD)
    finally:
        dist.destroy_process_group()


def test_gloo_rank_axis_steps_eagerly_by_rule(gloo_axis):
    """A gloo rank axis is not graphed even on a card; asking for a graph
    there, explicitly or inside ``dispatch(True)``, raises."""
    assert not collectives.use_graph_on(gloo_axis)
    assert collectives.graph_place(gloo_axis)[0] == torch.device("cuda", 0)
    with pytest.raises(ValueError, match="gloo's collectives run on the host"):
        collectives.use_graph_on(gloo_axis, True)
    with cudagraph.dispatch(True), pytest.raises(ValueError, match="gloo"):
        collectives.use_graph_on(gloo_axis)
    with cudagraph.dispatch(False):
        assert not collectives.use_graph_on(gloo_axis)


def _nccl_axis(monkeypatch, n, world, index=0):
    """A ``RankAxis`` of ``n`` ranks, one per card, in a world of ``world``
    ranks, whose group reports the NCCL backend (none is made on the
    CPU)."""
    monkeypatch.setattr(torch.distributed, "get_backend", lambda g: "nccl")
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: world)
    return collectives.RankAxis(ranks=tuple(range(n)), devices=tuple(
        torch.device("cuda", i) for i in range(n)), index=index, group=None)


def _graphed_on_own_card(axis, index):
    """``axis`` (an NCCL rank axis whose rank is shard ``index``) is graphed
    on its own rank's card and records work there alone; ``dispatch(False)``
    steps it eagerly and ``dispatch(True)`` is accepted."""
    dev = torch.device("cuda", index)
    assert collectives.graph_place(axis) == (dev, None)
    assert collectives.graph_devices(axis) == (dev,)
    assert collectives.use_graph_on(axis)
    with cudagraph.dispatch(False):
        assert not collectives.use_graph_on(axis)
    with cudagraph.dispatch(True):
        assert collectives.use_graph_on(axis)
    assert collectives.use_graph_on(axis, True)


def test_nccl_rank_at_world_size_one_is_graphed(monkeypatch):
    """An NCCL rank at world size 1 replays graphs on its card by
    default."""
    _graphed_on_own_card(_nccl_axis(monkeypatch, 1, 1), 0)


@pytest.mark.parametrize("n,world", [(1, 2), (2, 2), (4, 4)],
                         ids=["row_of_2x1", "line_of_2", "line_of_4"])
def test_nccl_ranks_of_a_larger_world_step_eagerly_by_rule(monkeypatch, n,
                                                           world):
    """An NCCL rank axis in a world of more than one rank (a rank alone in
    its row's model group too) replays graphs on its own rank's card, as
    at world size 1: no rule keeps it eager."""
    _graphed_on_own_card(_nccl_axis(monkeypatch, n, world, index=n - 1),
                         n - 1)


def test_rows_of_one_card_are_graphed_rows_across_cards_are_not():
    """A one-process row or axis is graphed when its devices are one card
    (named any number of times) and across cards too, its graphs kept on
    its first card and recorded on each (``graph_devices``); a graph asked
    for across cards is accepted. On the CPU it steps eagerly."""
    one = [torch.device("cuda", 1)] * 4
    assert (collectives.use_graph_on(one)
            and collectives.use_graph_on(tuple(one)))
    assert collectives.graph_place(one) == (torch.device("cuda", 1), None)
    assert collectives.graph_devices(one) == (torch.device("cuda", 1),)
    across = [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert collectives.use_graph_on(across)
    assert collectives.graph_place(across) == (torch.device("cuda", 0), None)
    assert collectives.graph_devices(across + across) == tuple(across)
    assert collectives.use_graph_on(across, True)
    with cudagraph.dispatch(True):
        assert collectives.use_graph_on(across)
    assert not collectives.use_graph_on([CPU, CPU])
    with pytest.raises(ValueError, match="CUDA graph needs a card"):
        collectives.use_graph_on([CPU] * 2, True)
    with cudagraph.dispatch(False):
        assert not collectives.use_graph_on(one)


def test_cpu_mesh_builds_no_graph(sequences):
    """By default a CPU mesh steps eagerly: no graph object is made."""
    with wk.graphs_built() as built:
        wk.mesh_step_run(wk.batch_config("pallas"), sequences, _mesh(1, 2),
                         steps=1)
    assert built == []


@pytest.mark.parametrize("where", ["device", "2x1", "1x2"])
def test_every_batched_step_carries_capture(sequences, where):
    """The stepwise batched step carries ``capture`` on one device and on a
    mesh alike; on the CPU it builds no graph, and the step after it equals
    a step without it bit for bit."""
    cfg, intr = wk.batch_config("pallas"), CameraIntrinsics(**wk.INTR)
    place = ({"device": CPU} if where == "device" else
             {"mesh": _mesh(*map(int, where.split("x")))})
    first, frames = wk._stacked(sequences, 0), wk._stacked(sequences, 1)
    runs = []
    for capture in (True, False):
        state = batch.batched_init_state(cfg, *first, **place)
        step = batch.make_batched_step_fn(cfg, intr, **place)
        with wk.graphs_built() as built:
            if capture:
                step.capture(state, *frames)
            state, out = step(state, *map(torch.from_numpy, frames))
        assert built == []
        runs.append((wk._state_summary(state), out))
    assert _equal(runs[0], runs[1])


# --- two gloo ranks -----------------------------------------------------------


@pytest.fixture(scope="module")
def gloo_ranks(tmp_path_factory):
    """Scenario ``graph`` over 2 gloo ranks, and the one-process eager
    runs over ``[cpu] * 2`` computed meanwhile."""
    where = str(tmp_path_factory.mktemp("graph2"))

    def one_process():
        with cudagraph.dispatch(False):
            return wk.graph_paths([CPU] * 2, 2)

    return wk.run_ranks("graph", 2, where, during=one_process)


PATHS = [f"{kind}_{s[0]}x{s[1]}_pallas" for s in wk.GRAPH_MESHES[2]
         for kind in ("step", "scan")] + list(SOLVERS)


@pytest.mark.parametrize("form", ["default", "body"])
@pytest.mark.parametrize("path", PATHS)
def test_gloo_ranks_equal_one_process(gloo_ranks, path, form):
    """On both ranks each path's result, by default (eager by rule) and
    through its graph path in the CPU form, equals the one-process eager
    run bit for bit (the step's and scan's outputs of every sequence; a
    rank holds its own row's state and counts its own launches)."""
    ranks, ref = gloo_ranks
    key = "outputs" if path.startswith(("step", "scan")) else None
    for r in ranks:
        got, want = r[form][path]["out"], ref[path]["out"]
        assert _equal(got[key] if key else got, want[key] if key else want)


@pytest.mark.parametrize("path", PATHS)
def test_gloo_rank_graph_path_equals_its_eager_run(gloo_ranks, path):
    """On each rank, the CPU form of the graph path equals the rank's
    default eager run: outputs, the rank's row state and generators, its
    launches."""
    ranks, _ = gloo_ranks
    for r in ranks:
        assert _equal(r["body"][path], r["default"][path])


def test_gloo_ranks_build_no_graph_by_default(gloo_ranks):
    ranks, _ = gloo_ranks
    assert [r["graphs_built"] for r in ranks] == [[], []]


@pytest.fixture(scope="module", params=[2, 4])
def graph_ranks(request, tmp_path_factory):
    """Scenario ``graph``'s ranks over 2 gloo ranks (``gloo_ranks``) and
    over 4."""
    if request.param == 2:
        return request.getfixturevalue("gloo_ranks")[0]
    where = str(tmp_path_factory.mktemp("graph4"))
    return wk.run_ranks("graph", 4, where)[0]


def _by_group(issued, rank) -> dict:
    """A rank's collectives split by their group: {group ranks: [(kind,
    shape, dtype, pairs), ...]}, for the groups ``rank`` belongs to."""
    out = {}
    for kind, ranks, shape, dtype, pairs in issued:
        assert rank in ranks
        out.setdefault(ranks, []).append((kind, shape, dtype, pairs))
    return out


def test_ranks_capture_the_same_collectives_in_the_same_order(graph_ranks):
    """In the CPU form of the graph paths, every path's captures (the mesh
    steps and scans, the three solvers) issue collectives, and every rank
    of each group issues that group's collectives in the same order, with
    the same shapes and dtypes: NCCL waits in a graph whose collectives
    differ between ranks. Ranks of different rows issue lists of the same
    form."""
    paths = graph_ranks[0]["issued"].keys()
    assert set(paths) == set(graph_ranks[0]["body"])
    for path in paths:
        lists = [r["issued"][path] for r in graph_ranks]
        assert lists[0], path
        groups = {}
        for rank, issued in enumerate(lists):
            for ranks, got in _by_group(issued, rank).items():
                groups.setdefault(ranks, []).append((rank, got))
        for ranks, got in groups.items():
            assert [r for r, _ in got] == list(ranks), (path, ranks)
            assert all(g == got[0][1] for _, g in got), (path, ranks)
        assert all([(k, len(g), s, d) for k, g, s, d, _ in x]
                   == [(k, len(g), s, d) for k, g, s, d, _ in lists[0]]
                   for x in lists), path


def test_destroying_the_group_releases_the_captures_holding_it(graph_ranks):
    """Each rank's captures that hold collectives of its groups are
    released when the rank destroys its process group
    (``torch.distributed.destroy_process_group``, wrapped once a capture
    holds collectives): NCCL destroys a communicator only after every
    graph holding its work is gone."""
    for r in graph_ranks:
        assert r["held_before_teardown"] > 0
        assert r["held_after_teardown"] == 0
        assert r["teardown_releases"]


# --- on the card --------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _graphed_vs_eager(fn):
    with cudagraph.dispatch(False):
        eager = _run(fn)
    return eager, _run(fn)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("shape", MESHES, ids=_ids)
def test_mesh_graphed_equals_eager_on_card(sequences, cuda_device, shape,
                                           route):
    """This card named 2 and 4 times: the mesh step (frames on the card)
    and the scan graphed against eager, bit for bit with their launches;
    one capture per row shape."""
    cfg = wk.batch_config(route)
    mesh = _mesh(*shape, dev=cuda_device)
    for run in (lambda: wk.mesh_step_run(cfg, sequences, mesh,
                                         device=cuda_device),
                lambda: wk.mesh_scan_run(cfg, sequences, mesh)):
        eager, got = _graphed_vs_eager(run)
        assert _equal(got, eager)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [2, 4])
def test_solvers_graphed_equal_eager_on_card(cuda_device, D):
    eager, got = _graphed_vs_eager(
        lambda: wk.graph_solvers([cuda_device] * D, D, cuda_device))
    assert _equal(got, eager)


_CACHES = (batch._graphed_split_step, wk.sharded_ba._graphed_solve,
           wk.ring_ba._graphed_round, posegraph._graphed_sharded_solve,
           pipeline._graphed_step)


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["mesh_step", "sharded_ba", "ring",
                                  "posegraph"])
def test_first_mesh_graph_call_makes_no_host_sync(sequences, cuda_device,
                                                  path, monkeypatch):
    """The first call (its capture included) of the (2, 2) mesh step on
    frames on the card, and the first graphed loop of each solver over
    this card named 4 times, run under sync-debug "error" (a solver's set-up
    before its loop may read the host: the ring's halo check does)."""
    for cached in _CACHES:
        cached.cache_clear()
    _first_call_strict(sequences, cuda_device, path, monkeypatch)


def _first_call_strict(sequences, cuda_device, path, monkeypatch):
    dev = cuda_device
    strict = []

    def checked(fn):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
            strict.append(True)

    real = cudagraph.GraphedLoop.__call__
    monkeypatch.setattr(cudagraph.GraphedLoop, "__call__",
                        lambda self, *a: checked(lambda: real(self, *a)))
    cfg, intr = wk.batch_config("pallas"), CameraIntrinsics(**wk.INTR)
    mesh = _mesh(2, 2, dev)
    st = batch.batched_init_state(cfg, *wk._stacked(sequences, 0), mesh=mesh)
    frames = [torch.from_numpy(x).to(dev) for x in wk._stacked(sequences, 1)]
    step = batch.make_batched_step_fn(cfg, intr, mesh=mesh)
    p = wk.problem.synthetic_ba_problem(device=dev, **wk.BA)[0]
    ring = wk.ring_problems()["halo2"]
    ring = ring._replace(**{k: getattr(ring, k).to(dev) for k in (
        "poses", "landmarks", "observations", "mask")})
    g = wk.circle_graph()
    g = g._replace(**{k: getattr(g, k).to(dev) for k in g._fields})
    line = make_mesh({"x": 4}, devices=[dev] * 4)
    calls = {
        "mesh_step": lambda: checked(lambda: step(st, *frames)),
        "sharded_ba": lambda: wk.sharded_ba_solve(
            p, make_mesh({"data": 1, "model": 4}, [dev] * 4), iterations=2),
        "ring": lambda: wk.ring_ba_solve(ring, line, axis="x", halo=2,
                                         rounds=2),
        "posegraph": lambda: posegraph.sharded_posegraph_solve(
            g, line, iterations=2, axis="x")}
    out = calls[path]()
    torch.cuda.synchronize()
    assert strict == [True]
    assert all(bool(torch.isfinite(x.float()).all())
               for x in cudagraph.state_tensors(out))


def _card_graph_ranks(tmp_path, world):
    if torch.cuda.device_count() < world:
        pytest.skip(f"needs {world} CUDA devices")
    lk_cuda._library()      # built here once, so that no rank builds it
    ranks, _ = wk.run_ranks("card_graph", world, str(tmp_path),
                            timeout=wk.CARD_GRAPH_TIMEOUT)
    return ranks


@pytest.mark.cuda
def test_nccl_rank_graphed_equals_eager_on_one_card(cuda_device, tmp_path):
    """One NCCL rank at world size 1: the rank step and scan (both routes)
    and the solvers replay graphs holding the NCCL collectives, bit for
    bit their eager runs with their launches."""
    (r,) = _card_graph_ranks(tmp_path, 1)
    assert _equal(r["graphed"], r["eager"])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4])
def test_rank_graphs_across_cards_equal_eager(cuda_device, tmp_path, n):
    """One NCCL rank per card on 2 cards ((2, 1), (1, 2) meshes) and on 4
    ((2, 2), (1, 4)), both routes, and the solvers over n ranks: every rank
    builds graphs and replays them by default, each rank's graphed run
    equals its eager run bit for bit with its launches, every rank gets
    the same solver outputs, and the line of n ranks accepts a graph. Each
    rank then destroys its group, which releases the graphs holding its
    collectives first."""
    ranks = _card_graph_ranks(tmp_path, n)
    for r in ranks:
        assert r["graphs_built"]
        assert _equal(r["graphed"], r["eager"])
        assert r["line_accepts_graph"]
        assert r["held_after_teardown"] == 0
    for r in ranks[1:]:
        for path in r["graphed"]:
            if not path.startswith(("step", "scan")):
                assert _equal(r["graphed"][path]["out"],
                              ranks[0]["graphed"][path]["out"])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 1), (1, 2), (2, 2)], ids=_ids)
def test_one_process_mesh_across_cards_graphed_equals_eager(sequences,
                                                            cuda_device,
                                                            shape):
    """One process over distinct cards: each row of one card replays its
    graph on its own card ((2, 1)); a row across cards replays its graphs
    card by card ((1, 2), (2, 2): ``cudagraph._Recording``), and a graph
    asked for there is accepted. The step and the scan, both routes, equal
    their eager runs bit for bit with their launches, with graphs built."""
    n = shape[0] * shape[1]
    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA devices")
    devs = [torch.device("cuda", i) for i in range(n)]
    mesh = make_mesh({"data": shape[0], "model": shape[1]}, devs)
    for route in ROUTES:
        cfg = wk.batch_config(route)
        for run in (lambda: wk.mesh_step_run(cfg, sequences, mesh,
                                             device=devs[0]),
                    lambda: wk.mesh_scan_run(cfg, sequences, mesh)):
            for cached in _CACHES:
                cached.cache_clear()
            with wk.graphs_built() as built:
                eager, got = _graphed_vs_eager(run)
            assert _equal(got, eager)
            assert built
    with cudagraph.dispatch(True):
        batch.make_batched_step_fn(cfg, CameraIntrinsics(**wk.INTR),
                                   mesh=mesh)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4])
def test_solvers_across_cards_in_one_process_replay_graphs(cuda_device, n):
    """The three solvers over n distinct cards from one process replay
    their iterations' graphs card by card (built; a graph asked for is
    accepted) and give their eager runs' bits with their launches."""
    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA devices")
    devs = [torch.device("cuda", i) for i in range(n)]
    assert collectives.use_graph_on(devs, True)
    for cached in _CACHES:
        cached.cache_clear()
    with wk.graphs_built() as built:
        eager, got = _graphed_vs_eager(
            lambda: wk.graph_solvers(devs, n, devs[0]))
    assert _equal(got, eager)
    assert built
