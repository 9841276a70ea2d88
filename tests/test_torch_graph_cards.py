"""Graphs across cards on the CPU: the placement rule, a capture that fails,
and the plan of a capture over several positions.

- The rule (``parallel.collectives.graph_place``, the group's backend and
  world size monkeypatched as tests/test_torch_graph_mesh.py's
  ``_nccl_axis`` does): a one-process axis across cards and an NCCL rank
  axis in a world of 1, 2 or 4 ranks replay graphs, a graph asked for
  there is accepted; a gloo rank axis steps eagerly and refuses one;
  ``graph_devices`` names the cards a graph records work on.
- Graphs that hold collectives: a capture lists the collectives of
  process groups it issued (``cudagraph.note_collective``);
  ``cudagraph.release`` drops the captures holding a group's and keeps
  the others; once a capture holds one,
  ``torch.distributed.destroy_process_group`` releases them before it
  destroys the group.
- On the card (``cuda`` marker, skipped here): a capture that fails on
  one card and over two (the second card's capture open) raises, leaves
  no stream of any card capturing, and the next capture replays bit for
  bit.
- A capture that fails (``utils.cudagraph``): in the CPU forms, a body
  that raises at capture, or reads a value back to the host inside a
  capture over several positions, raises to the caller, keeps no capture,
  leaves no recording or dispatch mode behind, steps nothing eagerly in
  its place, and the next capture of the same loop replays bit for bit.
- The plan over several positions: on a card a body over several cards
  is captured as each card's graphs, cut at each group of copies between
  cards (``cudagraph.moves``), and replayed in the order captured
  (``_Recording``). Its CPU form (``_Tape``) records the same body, with
  the devices named as distinct positions (``cpu:0``, ``cpu:1``, ...),
  as operator steps cut at the same groups, and replays them in the same
  order. Held here: where the groups cut (a ``psum``, a ``ppermute``, a
  split LK launch) and, through the graph paths of the three solvers over
  2 and 4 positions and of the mesh step and scan on (1, 2) and (2, 2)
  meshes on both LK routes, the replayed results bit for bit the eager
  run's, with one replay per iteration or per row and step.

Alone on the CPU this file takes ~90 s (one core).
"""

import pytest
import torch

import torch_dist_worker as wk
from visual_odom_tpu_torch.ops import lk_cuda
from visual_odom_tpu_torch.parallel import collectives
from visual_odom_tpu_torch.parallel.mesh import make_mesh
from visual_odom_tpu_torch.utils import cudagraph

torch.set_num_threads(1)


def _cpu(k: int) -> torch.device:
    return torch.device("cpu", k)


def _positions(n: int) -> list:
    return [_cpu(k) for k in range(n)]


def _equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return (a.dtype == b.dtype and a.shape == b.shape
                and bool(torch.equal(a, b)))
    return a == b


def _tapes(graphs) -> list:
    """The ``_Tape`` of every capture of ``graphs``."""
    return [c.graph for g in graphs for c in g.captures.values()]


# --- the rule ---------------------------------------------------------------


def _rank_axis(monkeypatch, backend, n, world, index):
    monkeypatch.setattr(torch.distributed, "get_backend", lambda g: backend)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: world)
    return collectives.RankAxis(ranks=tuple(range(n)), devices=tuple(
        torch.device("cuda", i) for i in range(n)), index=index, group=None)


@pytest.mark.parametrize("n,world,index", [(1, 1, 0), (1, 2, 0), (2, 2, 1),
                                           (2, 4, 0), (4, 4, 3)])
def test_nccl_rank_axes_graphed_at_world_size_one_only(monkeypatch, n,
                                                       world, index):
    """An NCCL rank axis, in a world of any size, keeps its graph on its
    own rank's card and records work there alone; it replays graphs by
    default, ``dispatch(False)`` steps it eagerly and ``dispatch(True)`` is
    accepted."""
    axis = _rank_axis(monkeypatch, "nccl", n, world, index)
    dev = torch.device("cuda", index)
    assert collectives.graph_place(axis) == (dev, None)
    assert collectives.graph_devices(axis) == (dev,)
    assert collectives.use_graph_on(axis)
    with cudagraph.dispatch(False):
        assert not collectives.use_graph_on(axis)
    with cudagraph.dispatch(True):
        assert collectives.use_graph_on(axis)


@pytest.mark.parametrize("world", [1, 2, 4])
def test_gloo_rank_axes_stay_eager(monkeypatch, world):
    """A gloo rank axis steps eagerly at every world size (its collectives
    run on the host), and a graph asked for there raises."""
    axis = _rank_axis(monkeypatch, "gloo", 1, world, 0)
    dev, eager = collectives.graph_place(axis)
    assert dev == torch.device("cuda", 0) and "gloo" in eager
    assert not collectives.use_graph_on(axis)
    with pytest.raises(ValueError, match="gloo's collectives run on the host"):
        collectives.use_graph_on(axis, True)
    with cudagraph.dispatch(True), pytest.raises(ValueError, match="gloo"):
        collectives.use_graph_on(axis)


@pytest.mark.parametrize("cards", [[1, 0], [0, 1, 0, 1], [2, 3, 0, 1],
                                   [0, 0, 1, 1]])
def test_one_process_axis_across_cards_is_graphed(cards):
    """A one-process axis across cards keeps its graph on its first device
    and records work on each distinct card, in the axis' order; a graph
    asked for is accepted. The same axis of CPU positions steps eagerly."""
    axis = [torch.device("cuda", c) for c in cards]
    assert collectives.graph_place(axis) == (axis[0], None)
    assert collectives.graph_devices(axis) == tuple(dict.fromkeys(axis))
    assert collectives.use_graph_on(axis)
    with cudagraph.dispatch(True):
        assert collectives.use_graph_on(axis)
    cpu = [_cpu(c) for c in cards]
    assert collectives.graph_devices(cpu) == tuple(dict.fromkeys(cpu))
    assert not collectives.use_graph_on(cpu)
    with pytest.raises(ValueError, match="CUDA graph needs a card"):
        collectives.use_graph_on(cpu, True)


# --- graphs that hold collectives ------------------------------------------


class _Group:
    """A stand-in for a process group: collectives are noted by group."""


def _noting_body(group, ranks=(0, 1)):
    """A loop body that notes an all-gather over ``group`` (None: notes
    nothing) and doubles its carry."""
    def body(carry):
        (x,) = carry
        if group is not None:
            cudagraph.note_collective("all_gather", group, ranks, x)
        return (x * 2.0,)

    return body


def test_captures_list_the_collectives_they_issue():
    """A capture lists the collectives its body issued, in order, with the
    group's ranks, the shape and dtype sent and a ppermute's pairs; a body
    run outside a capture (a replay of the CPU form, an eager call) notes
    none."""
    group = _Group()

    def body(carry):
        (x,) = carry
        cudagraph.note_collective("all_gather", group, (0, 1), x)
        cudagraph.note_collective("ppermute", group, (0, 1), x[:1],
                                  [(0, 1), (1, 0)])
        return (x + 1.0,)

    loop = cudagraph.GraphedLoop(body, "cpu", _replay_body=True)
    loop((torch.zeros(3),), 4)
    (cap,) = loop.captures.values()
    assert [c[:5] for c in cap.collectives] == [
        ("all_gather", (0, 1), (3,), torch.float32, ()),
        ("ppermute", (0, 1), (1,), torch.float32, ((0, 1), (1, 0)))]
    assert all(c.group is group for c in cap.collectives)
    assert wk.REPLAYS[cap] == 4
    body((torch.zeros(3),))
    assert len(cap.collectives) == 2


def test_release_drops_only_the_captures_holding_the_group():
    """``release([group])`` drops every capture holding a collective of
    ``group`` and keeps the rest; the loop's next call captures again and
    replays bit for bit. ``release()`` drops every capture holding any."""
    a, b = _Group(), _Group()
    loops = {name: cudagraph.GraphedLoop(_noting_body(g), "cpu",
                                         _replay_body=True)
             for name, g in (("a", a), ("b", b), ("none", None))}
    x = (torch.arange(4.0),)
    for loop in loops.values():
        loop(x, 2)
    assert cudagraph.release([a]) == 1
    assert [bool(loops[k].captures) for k in ("a", "b", "none")] == [
        False, True, True]
    assert _equal(loops["a"](x, 3), (torch.arange(4.0) * 8,))
    assert cudagraph.release() >= 2
    assert [bool(loops[k].captures) for k in ("a", "b", "none")] == [
        False, False, True]
    assert cudagraph.release([a, b]) == 0


@pytest.mark.parametrize("which", ["default", "subgroup"])
def test_destroy_process_group_releases_first(monkeypatch, which):
    """Once a capture holds collectives, ``torch.distributed.
    destroy_process_group`` first releases the captures holding the
    groups it destroys (every group's for the default group, the named
    group's for a subgroup), then destroys them, as it did before."""
    c10d = torch.distributed.distributed_c10d
    calls = []
    a, b = _Group(), _Group()
    loops = [cudagraph.GraphedLoop(_noting_body(g), "cpu", _replay_body=True)
             for g in (a, b)]

    def destroy(group=None):
        calls.append((group, [bool(lp.captures) for lp in loops]))

    monkeypatch.setattr(c10d, "destroy_process_group", destroy)
    monkeypatch.setattr(torch.distributed, "destroy_process_group", destroy)
    for loop in loops:
        loop((torch.ones(2),), 1)
    assert torch.distributed.destroy_process_group.releases_graphs
    if which == "default":
        torch.distributed.destroy_process_group()
        assert calls == [(None, [False, False])]
    else:
        torch.distributed.destroy_process_group(b)
        assert calls == [(b, [True, False])]


# --- a capture that fails -----------------------------------------------------


def _psum_body(axis, fail_at=None):
    """A loop body over ``axis``: each shard plus the psum of all shards.
    ``fail_at`` (a list of call numbers, counted from 1) raises there."""
    calls = []

    def body(carry):
        calls.append(len(calls) + 1)
        total = collectives.psum(list(carry), axis)
        if fail_at and calls[-1] in fail_at:
            raise RuntimeError(f"injected failure at call {calls[-1]}")
        return tuple(c + t * 0.5 for c, t in zip(carry, total))

    return body, calls


def _carry(axis):
    g = torch.Generator().manual_seed(5)
    return tuple(torch.randn(3, 4, generator=g).to(d) for d in axis)


def _eager_loop(body, carry, iterations):
    for _ in range(iterations):
        carry = body(carry)
    return carry


@pytest.mark.parametrize("n", [1, 2])
def test_failing_capture_raises_and_the_next_one_replays(n):
    """A body that raises while it is captured (in the CPU forms: the
    warm-up on one position, the tape's recording on two) raises to the
    caller: no capture is kept, nothing is returned in its place, no
    recording or dispatch mode is left behind. The loop's next capture
    replays bit for bit the eager loop."""
    axis = _positions(n) if n > 1 else [torch.device("cpu")]
    failing, calls = _psum_body(axis, fail_at=[n])  # the warm-up or the tape
    loop = cudagraph.GraphedLoop(failing, axis[0], _replay_body=True,
                                 devices=axis)
    with pytest.raises(RuntimeError, match="injected failure"):
        loop(_carry(axis), 3)
    assert calls == list(range(1, n + 1))
    assert not loop.captures
    assert getattr(cudagraph._THREAD, "recording", None) is None
    assert torch._C._len_torch_dispatch_stack() == 0
    got = loop(_carry(axis), 3)
    want = _eager_loop(_psum_body(axis)[0], _carry(axis), 3)
    assert _equal(got, want)
    assert wk.replays([loop]) == [3]


def test_tape_refuses_a_host_read():
    """A value read back to the host inside a capture over several
    positions is refused, as a card's capture refuses it; the loop keeps
    no capture."""
    axis = _positions(2)

    def body(carry):
        total = collectives.psum(list(carry), axis)
        if float(total[0].sum()) > 1e30:
            raise AssertionError("unreachable")
        return tuple(c + t for c, t in zip(carry, total))

    loop = cudagraph.GraphedLoop(body, axis[0], _replay_body=True,
                                 devices=axis)
    with pytest.raises(RuntimeError, match="reads a value back to the host"):
        loop(_carry(axis), 2)
    assert not loop.captures
    assert getattr(cudagraph._THREAD, "recording", None) is None


# --- the plan ---------------------------------------------------------------


def _loop_tape(body, axis, carry, iterations=2):
    loop = cudagraph.GraphedLoop(body, axis[0], _replay_body=True,
                                 devices=axis)
    got = loop(carry, iterations)
    (cap,) = loop.captures.values()
    return got, cap.graph


@pytest.mark.parametrize("n", [2, 4])
def test_psum_cuts_once_to_the_first_position_and_once_back(n):
    """A psum over n positions is two groups of moves: every other shard
    to the first position, then the sum back to every other one; the
    replays give the eager loop's bits."""
    axis = _positions(n)
    body = _psum_body(axis)[0]
    got, tape = _loop_tape(body, axis, _carry(axis))
    assert tape.cuts == [[axis[0]] * (n - 1), axis[1:]]
    assert len(tape.plan) == 2 * len(tape.cuts) + 1
    assert _equal(got, _eager_loop(body, _carry(axis), 2))


def test_ppermute_is_one_group_of_the_pairs_that_cross():
    """A ppermute moves every pair whose shards lie on distinct positions
    in one group; a pair within a position (a card named twice) moves
    nothing and cuts nothing."""
    axis = [_cpu(0), _cpu(0), _cpu(1), _cpu(1)]
    perm = [(0, 1), (1, 2), (2, 3)]

    def body(carry):
        moved = collectives.ppermute(list(carry), perm, axis)
        return tuple(c + m for c, m in zip(carry, moved))

    got, tape = _loop_tape(body, axis, _carry(axis))
    assert tape.cuts == [[_cpu(1)]]
    assert _equal(got, _eager_loop(body, _carry(axis), 2))


@pytest.mark.parametrize("n", [2, 3])
def test_split_lk_launch_cuts_once_out_and_once_back(n):
    """A quad launch split over n positions moves the images and each
    slice out to the other positions in one group and the results back in
    one; replayed, it gives the unsplit quad's bits."""
    axis = _positions(n)
    imgs, pts, valid, flow, params = wk.quad_inputs()

    def quad(p, slots):
        return lk_cuda.lk_circular_quad(*imgs, p, valid, params, flow=flow,
                                        disp=-flow, start_level=2,
                                        slot_devices=slots)

    got, tape = _loop_tape(lambda c: (quad(c[0], axis)[0],), axis, (pts,),
                           iterations=1)
    assert len(tape.cuts) == 2
    assert sorted({str(d) for d in tape.cuts[0]}) == [str(d)
                                                      for d in axis[1:]]
    assert tape.cuts[1] == [axis[0]] * len(tape.cuts[1])
    assert _equal(got, (quad(pts, None)[0],))


@pytest.fixture(scope="module")
def solvers():
    """The three solvers over 2 and 4 CPU positions: eager, and through
    their graph paths in the CPU form (the tape) with their captures."""
    out = {}
    for D in (2, 4):
        with cudagraph.dispatch(False):
            eager = wk.graph_solvers(_positions(D), D)
        with wk.body_form() as made:
            body = wk.graph_solvers(_positions(D), D)
        out[D] = eager, body, made
    return out


@pytest.mark.parametrize("solver", ["sharded_ba", "ring_halo2", "ring_huber",
                                    "posegraph"])
@pytest.mark.parametrize("D", [2, 4])
def test_solver_over_positions_replays_its_plan(solvers, D, solver):
    """Each solver over D positions, through its graph path's tape, gives
    the eager run's bits with its launches, one replay per iteration; its
    plan is cut at groups of moves."""
    eager, body, made = solvers[D]
    assert _equal(body[solver], eager[solver])
    name = solver.split("_")[0] if solver.startswith("ring") else solver
    tapes = _tapes(made[name])
    assert tapes and all(t.cuts for t in tapes)
    assert all(type(t) is cudagraph._Tape for t in tapes)
    assert wk.replays(made[name]) == [wk.GRAPH_ITERS] * len(made[name])


@pytest.fixture(scope="module")
def sequences():
    return wk.graph_sequences()


@pytest.mark.parametrize("route", ["pallas", "xla"])
@pytest.mark.parametrize("shape", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
def test_mesh_across_positions_replays_its_plan(sequences, shape, route):
    """The mesh step and the scan on a (1, 2) and a (2, 2) mesh of CPU
    positions, both LK routes, through the split step's tape: every
    step's outputs, the final state and the generators' state bit for bit
    the eager run's, one replay per row and step; each row's plan cut at
    each split LK launch, once out and once back."""
    n = shape[0] * shape[1]
    mesh = make_mesh({"data": shape[0], "model": shape[1]}, _positions(n))
    cfg = wk.batch_config(route)
    for run in (lambda: wk.mesh_step_run(cfg, sequences, mesh),
                lambda: wk.mesh_scan_run(cfg, sequences, mesh)):
        with cudagraph.dispatch(False):
            eager = run()
        with wk.body_form() as made:
            got = run()
        assert _equal(got, eager)
        assert made["one_device"] == []
        assert wk.replays(made["split"]) == [wk.GRAPH_STEPS] * shape[0]
        for tape in _tapes(made["split"]):
            assert len(tape.cuts) % 2 == 0
            homes = {str(d) for cut in tape.cuts[1::2] for d in cut}
            assert len(homes) == 1


# --- on the card ------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _failing_on_card(axis, failure):
    """A psum loop body over ``axis`` that fails in its second call (the
    capture; the first is the warm-up) after the psum, by ``failure``: a
    Python error, or a value read back to the host, which CUDA refuses
    inside a capture. Also returns the streams current on each card at the
    failure (the capture's)."""
    calls, streams = [], []

    def body(carry):
        calls.append(1)
        total = collectives.psum(list(carry), axis)
        if len(calls) == 2:
            streams.extend(torch.cuda.current_stream(d)
                           for d in dict.fromkeys(axis))
            if failure == "raise":
                raise RuntimeError("injected failure")
            float(total[0].sum())
        return tuple(c + t * 0.5 for c, t in zip(carry, total))

    return body, streams


def _nothing_capturing(streams) -> bool:
    for s in streams:
        with torch.cuda.stream(s):
            if torch.cuda.is_current_stream_capturing():
                return False
    for i in range(torch.cuda.device_count()):
        with torch.cuda.device(i):
            if torch.cuda.is_current_stream_capturing():
                return False
            torch.cuda.synchronize()
    return True


@pytest.mark.cuda
@pytest.mark.parametrize("failure", ["raise", "host_read"])
@pytest.mark.parametrize("n", [1, 2])
def test_failed_capture_leaves_no_card_capturing(cuda_device, n, failure):
    """A capture that fails, on one card or over two (the second card's
    capture open, cut by the psum), raises to the caller and keeps no
    capture; no stream of any card is left capturing and every card
    synchronises; the next capture in the process replays bit for bit the
    eager loop."""
    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA devices")
    axis = [torch.device("cuda", i) for i in range(n)]
    body, streams = _failing_on_card(axis, failure)
    loop = cudagraph.GraphedLoop(body, axis[0], devices=axis)
    with pytest.raises(RuntimeError):
        loop(_carry(axis), 3)
    assert not loop.captures and len(streams) == n
    assert cudagraph._open() == []
    assert _nothing_capturing(streams)
    good = _psum_body(axis)[0]
    got = cudagraph.GraphedLoop(good, axis[0], devices=axis)(_carry(axis), 3)
    assert _equal(got, _eager_loop(good, _carry(axis), 3))
