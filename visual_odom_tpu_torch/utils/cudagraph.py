"""The step, the pipe's stages and the solvers' iterations as CUDA graphs:
captured once, replayed.

The JAX package jits its step and scans it over a chunk of frames in one
device dispatch (``make_scan_step_fn``: ``jax.jit`` of a ``lax.scan``),
jits each door's step, the pipe's two stages and the batched step, and
runs each solve as ``jit`` of a ``lax.scan`` over its iterations. The
port's eager step issues ~7,000 kernels a frame from the host, one by one.
``GraphedStep`` captures them once into a CUDA graph
(``torch.cuda.CUDAGraph``) and steps each frame with one replay;
``GraphedLoop`` captures one solver iteration and replays it once per
iteration. This module knows nothing of the step it records: the runner,
the pipe and the solvers build on it. On a card they are the default of:

- the scan family (``runner.pipeline.make_scan_step_fn``:
  ``run_sequence_scan``, the resumable scan, chunked
  ``run_sequences_batched`` on one card, the bench, the command line's
  chunked ``run`` and one-card ``run-batch``);
- the per-frame doors (``GraphedStep.__call__`` and ``fetched``):
  ``VisualOdometry`` and so ``run_sequence``, ``run_sequence_resumable``
  and the command line's unchunked ``run``; the buffered step; the
  stepwise batched runner on one card; each loop-edge measurement;
- the pipe's two stages (``parallel.pipe``, ``GraphedStep.stage``);
- ``ba.schur.ba_solve`` (so ``ba.window.smooth_trajectory_ba``) and
  ``ba.posegraph.posegraph_solve`` (so ``close_loops``), through
  ``GraphedLoop``;
- the multi-device paths (the JAX package jits its sharded batched step,
  ``sharded_ba_solve``, ``ring_ba_solve`` and the edge-sharded pose graph
  too): on a one-process mesh each data row replays its step
  (``parallel.batch``), and ``sharded_ba_solve``, ``ring_ba_solve`` (one
  GN round a replay) and ``sharded_posegraph_solve`` replay their
  iteration, on one card or, across cards, each card's graphs in turn
  (``_Recording``); an NCCL rank, in a world of any size, replays its
  own, the NCCL collectives of the step (the split LK launches'
  all-gather) or of the iteration (``psum``, ``gather``, ``ppermute``)
  captured inside the graph.

The CPU has no graphs: there every path runs eagerly. ``use_graph`` picks
by device; ``dispatch`` is the switch: inside ``dispatch(False)`` every
path runs eagerly on a card too (the reference a graph is held to),
inside ``dispatch(True)`` replays graphs, which raises on the CPU and where
the caller's place steps eagerly by rule (``parallel.collectives.
graph_place``: a gloo rank axis).
``make_scan_step_fn`` and
``VisualOdometry`` also take a private ``_graph`` that overrides both.

A graph replays fixed addresses, so the step runs on static buffers
(``_StaticStep``):

- The state's tensors (the features, both ``LKImage`` pyramids, the warm
  start) live in one byte buffer made at capture, each tensor a view of
  it; the inputs (a frame pair, or a packet) in buffers of their own. A
  replay steps the state in the buffers on the inputs, packs the outputs
  into one byte row, and writes the new state over the old one as the
  graph's last nodes (``write_back``).
- A state that is not the one this step returned last (a fresh state, a
  restored snapshot, another sequence) is copied into the buffers first.
  The one returned last is not.
- The scan copies the outputs out of the row into the chunk's stack after
  each replay (``OutputLayout``), and hands the state out at the chunk's
  end; a per-frame call copies the row (or fetches it to the host, one
  device-to-host copy) and hands the state out after each replay. The
  state handed out is one copy of the byte buffer (``snapshot``), so no
  later replay writes over it.
- The RANSAC draws come from generators that the graph owns and has
  registered (``CUDAGraph.register_generator_state``). Each call hands
  them the state of the caller's generators and hands it back after its
  last replay, so replay k draws what eager step k draws, and the
  caller's generators end where eager's end (the checkpoints store their
  state).

A solver loop (``_StaticLoop``) carries the problem in buffers of the same
kind: one iteration reads them and writes the updated problem back; the
loop loads the caller's problem, replays ``iterations`` times and hands
the result out as copies, the tensors the iteration never writes (the
observations, the edges) as the caller's own.

Capture (``_capture``): one eager run of the body on a side stream first
makes whatever the body makes at its first use (the kernels' library,
cuBLAS's handles, the cached device constants, which a pageable upload
builds and which may not be captured; an NCCL rank's communicators).
Then the body is captured on that stream in "thread_local" mode, so the
uploader threads' copies on their own streams neither break the capture
nor are broken by it; a body over several cards, on a side stream of
each, cut into graphs at its copies between cards (``_Recording``,
``moves``). Nothing synchronises with the host. A capture that fails
ends every capture this thread has open, on every card
(``end_captures``), and raises; nothing falls back to the eager path.
Every capture is logged at DEBUG on this module's logger and recorded as
a ``graph.capture`` span (``utils.profiling``); a per-frame call records
its input, replay, fetch and snapshot spans (``_StaticStep.frame``).

Collectives of a process group inside a capture (``parallel.collectives``
notes each: ``note_collective``) are listed on the capture
(``_Capture.collectives``), and the graph then holds the group's NCCL
communicator: NCCL destroys a communicator only once every graph holding
its work is gone, and waits for them until then. So the first such
capture wraps ``torch.distributed.destroy_process_group`` (and the
process' exit) to release those graphs first (``release``: each card
synchronised, the graphs destroyed, the captures dropped); a caller
destroys its groups as it always does.

Launch counts: the kernel wrappers count the kernels they launch
(``lk_circular_quad.launches`` and ``lk_track_pyramid.launches``, and
their ``batched_launches``; PnP's ``refine_hypotheses.launches`` and
``refine_polish.launches``). A capture records each count's growth as the
graph's launches per replay, and takes back what the warm-up and the
capture added, since they build the graph as a JAX trace does. Each
replay then adds its launches to the counts.
"""

from __future__ import annotations

import atexit
import collections
import contextlib
import functools
import logging
import threading
import time
import warnings
import weakref
from typing import NamedTuple

import numpy as np
import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)
from torch.utils._pytree import tree_map_only

from visual_odom_tpu_torch.backend.pnp import refine_hypotheses, refine_polish
from visual_odom_tpu_torch.ops.lk import lk_track_pyramid
from visual_odom_tpu_torch.ops.lk_cuda import lk_circular_quad
from visual_odom_tpu_torch.utils import profiling

#: the kernel wrappers' launch counts: (wrapper, attribute) by name
_COUNTERS = {"quad": (lk_circular_quad, "launches"),
             "quad_batched": (lk_circular_quad, "batched_launches"),
             "level": (lk_track_pyramid, "launches"),
             "level_batched": (lk_track_pyramid, "batched_launches"),
             "pnp_hypotheses": (refine_hypotheses, "launches"),
             "pnp_polish": (refine_polish, "launches")}

#: what ``_graph=None`` means inside ``dispatch``: None picks by device
_DISPATCH = None

#: the captures a ``GraphedLoop`` keeps, the ones used last
_MAX_LOOP_CAPTURES = 32

#: byte alignment of each state tensor in the static byte buffer, the
#: caching allocator's
_ALIGN = 512

_log = logging.getLogger(__name__)


@contextlib.contextmanager
def dispatch(graphed: bool):
    """Inside the block every path that ``use_graph`` picks for (its
    ``_graph`` left None) runs as ``graphed`` says: False runs each eagerly
    on a card too (the reference a graph is held to), True replays graphs
    (and raises on the CPU). A path reads the choice when it is built or
    when it is called: ``VisualOdometry``, the buffered, stepwise batched
    and loop-edge steps when they are built, and keep it outside the
    block; the scan doors, ``ba_solve``, ``posegraph_solve`` and the pipe
    at each call. Not thread-local: one block at a time."""
    global _DISPATCH
    prev, _DISPATCH = _DISPATCH, bool(graphed)
    try:
        yield
    finally:
        _DISPATCH = prev


def use_graph(device, graphed=None, eager=None) -> bool:
    """Whether an entry point on ``device`` replays a graph: ``graphed``
    (an entry point's private ``_graph``), else ``dispatch``'s choice, else
    whether ``device`` is a card and ``eager`` is None. ``eager`` says why
    the caller's place steps eagerly by rule (``parallel.collectives``'
    ``graph_place`` gives it for a mesh row or axis). A graph on the CPU,
    or where ``eager`` is given, raises."""
    device = torch.device(device)
    if graphed is None:
        graphed = _DISPATCH
    if graphed is None:
        return device.type == "cuda" and eager is None
    if graphed and device.type != "cuda":
        raise ValueError(f"a CUDA graph needs a card, got {device}: the "
                         f"step runs eagerly on the CPU")
    if graphed and eager is not None:
        raise ValueError(f"no CUDA graph here, the step runs eagerly: "
                         f"{eager}")
    return bool(graphed)


def launch_counts() -> dict:
    """The kernel wrappers' launch counts, by name."""
    return {k: getattr(fn, attr) for k, (fn, attr) in _COUNTERS.items()}


def set_launch_counts(counts: dict) -> None:
    for k, (fn, attr) in _COUNTERS.items():
        setattr(fn, attr, counts[k])


def add_launches(launches: dict) -> None:
    """Add ``launches`` (by name) to the wrappers' counts."""
    for k, n in launches.items():
        fn, attr = _COUNTERS[k]
        setattr(fn, attr, getattr(fn, attr) + n)


def state_tensors(tree) -> list:
    """The tensors of a tree of NamedTuples and tuples (a ``VOState``: the
    features, both pyramids, the warm start), depth first in field order.
    Generators, sizes and other leaves are not among them."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, tuple):
        return [t for x in tree for t in state_tensors(x)]
    return []


def static_leaves(tree) -> tuple:
    """The leaves of a tree that are neither tensors nor generators (a
    pyramid's sizes, a problem's intrinsics), depth first: a graph bakes
    them into its kernels' arguments."""
    if isinstance(tree, (torch.Tensor, torch.Generator)):
        return ()
    if isinstance(tree, tuple):
        return tuple(v for x in tree for v in static_leaves(x))
    return (tree,)


def with_tensors(tree, tensors):
    """``tree`` with its tensors replaced by ``tensors``, taken in
    ``state_tensors`` order; every other leaf is kept."""
    it = iter(tensors)

    def build(x):
        if isinstance(x, torch.Tensor):
            return next(it)
        if isinstance(x, tuple):
            vals = [build(v) for v in x]
            return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
        return x

    out = build(tree)
    if next(it, None) is not None:
        raise ValueError("more tensors than the state holds")
    return out


def generators(state) -> list:
    """The state's RANSAC generators: one, one per sequence, or none (a
    state without a ``generator`` field)."""
    g = getattr(state, "generator", None)
    if g is None:
        return []
    return list(g) if isinstance(g, tuple) else [g]


def hand_over(dst, src) -> None:
    """Give each generator of ``dst`` the state of its counterpart in
    ``src`` (host-side: a seed and an offset on a card)."""
    if len(dst) != len(src):
        raise ValueError(f"{len(src)} generators for {len(dst)}")
    for d, s in zip(dst, src):
        if d is not s:
            d.set_state(s.get_state())


def write_back(static, new) -> None:
    """Write the new state's tensors over the static ones. A new tensor
    that shares memory with a static tensor, other than being exactly its
    own destination, is cloned before any write, so that no write reads
    memory another has already changed."""
    got = [(tuple(t.shape), t.dtype) for t in new]
    want = [(tuple(t.shape), t.dtype) for t in static]
    if got != want:
        raise ValueError(f"the step returned a state of another structure: "
                         f"{got} for {want}")
    ptrs = {t.untyped_storage().data_ptr() for t in static}
    new = [n if n.is_set_to(d) or n.untyped_storage().data_ptr() not in ptrs
           else n.clone() for d, n in zip(static, new)]
    for d, n in zip(static, new):
        if not n.is_set_to(d):
            d.copy_(n)


class FlatLayout:
    """Tensors laid out as views of one byte buffer, each at an offset
    aligned as the allocator aligns a tensor of its own, so that a whole
    state is copied in one copy (``views`` of another such buffer)."""

    def __init__(self, tensors):
        self.fields, off = [], 0
        for t in tensors:
            n = t.numel() * t.element_size()
            self.fields.append((off, n, t.dtype, tuple(t.shape)))
            off += -(-n // _ALIGN) * _ALIGN
        self.nbytes = max(off, 1)

    def views(self, flat: torch.Tensor) -> list:
        return [flat[off:off + n].view(dtype).view(shape)
                for off, n, dtype, shape in self.fields]


class OutputLayout:
    """Where each output of a step lies in one byte buffer.

    The step's outputs (NamedTuples of tensors: a ``StepOutput`` and, with
    tracks, a ``TrackSnapshot``) are packed widest element first, so every
    field lies aligned; a stack row is padded to 8 bytes. ``pack`` writes
    one frame's outputs as ``used`` bytes; ``unpack`` reads a (k,
    ``nbytes``) stack of such rows back as the same NamedTuples with a
    leading k, each field a contiguous tensor of its own, as the eager
    scan's stacks are; ``unpack_row`` reads one row as views of it, and
    ``unpack_host`` one row fetched to the host as numpy arrays."""

    def __init__(self, outs):
        self.types = [type(o) for o in outs]
        fields = [(i, j, x.dtype, tuple(x.shape), x.numel() * x.element_size())
                  for i, o in enumerate(outs) for j, x in enumerate(o)]
        fields.sort(key=lambda f: -torch.empty(0, dtype=f[2]).element_size())
        self.fields, off = [], 0
        for i, j, dtype, shape, n in fields:
            self.fields.append((i, j, dtype, shape, off, n))
            off += n
        self.used = off
        self.nbytes = -(-off // 8) * 8

    def pack(self, outs) -> torch.Tensor:
        """One frame's outputs -> (``used``,) uint8."""
        parts = []
        for i, j, dtype, shape, _, _ in self.fields:
            x = outs[i][j]
            if x.dtype != dtype or tuple(x.shape) != shape:
                raise ValueError(f"output {self.types[i].__name__}."
                                 f"{self.types[i]._fields[j]}: {x.dtype} "
                                 f"{tuple(x.shape)}, laid out as {dtype} "
                                 f"{shape}")
            parts.append(x.reshape(-1).view(torch.uint8))
        return torch.cat(parts)

    def _build(self, vals) -> tuple:
        return tuple(t(*(vals[i, j] for j in range(len(t._fields))))
                     for i, t in enumerate(self.types))

    def unpack(self, stack: torch.Tensor) -> tuple:
        """A (k, ``nbytes``) uint8 stack -> the outputs stacked (k, ...)."""
        k = stack.shape[0]
        return self._build({(i, j): stack[:, off:off + n].view(dtype)
                            .reshape((k,) + shape).contiguous()
                            for i, j, dtype, shape, off, n in self.fields})

    def unpack_row(self, row: torch.Tensor) -> tuple:
        """One packed row -> the outputs, each a contiguous view of it."""
        return self._build({(i, j): row[off:off + n].view(dtype).view(shape)
                            for i, j, dtype, shape, off, n in self.fields})

    def unpack_host(self, row: np.ndarray) -> tuple:
        """One packed row on the host (uint8) -> the outputs as numpy
        arrays, views of it."""
        return self._build({
            (i, j): row[off:off + n].view(
                torch.empty(0, dtype=dtype).numpy().dtype).reshape(shape)
            for i, j, dtype, shape, off, n in self.fields})


class _StaticStep:
    """The step on static buffers: the body a graph records and the loops
    that replay it.

    ``step(state, *inputs) -> (state, *outputs)`` is the eager step (the
    inputs: a frame pair, or the pipe's packet); ``state`` and ``inputs``
    give the buffers their shapes and first contents. ``body()`` steps the
    static state on the static inputs, packs the outputs and writes the
    new state back; it returns the packed outputs. ``run(state, lefts,
    rights, replay)`` steps k frames, each by one ``replay()`` that returns
    the packed outputs (a graph's replay, or ``body`` itself); ``frame``
    steps one. The tensors they return are their own: no later call
    writes over them.
    """

    def __init__(self, step, state, *inputs):
        self.step = step
        tensors = state_tensors(state)
        self.flat_layout = FlatLayout(tensors)
        dev = tensors[0].device if tensors else inputs[0].device
        self.flat = torch.empty(self.flat_layout.nbytes, dtype=torch.uint8,
                                device=dev)
        self.tensors = self.flat_layout.views(self.flat)
        for d, s in zip(self.tensors, tensors):
            d.copy_(s)
        gens = generators(state)
        self.generators = [torch.Generator(device=g.device) for g in gens]
        hand_over(self.generators, gens)
        self.state = with_tensors(state, self.tensors)
        if gens:
            own = (tuple(self.generators) if isinstance(state.generator, tuple)
                   else self.generators[0])
            self.state = self.state._replace(generator=own)
        self.inputs = [x.clone() for x in inputs]
        self.layout = None
        self.last = None        # the state returned last
        self.loads = 0          # states copied into the buffers

    def body(self) -> torch.Tensor:
        new, *outs = self.step(self.state, *self.inputs)
        if self.layout is None:
            self.layout = OutputLayout(outs)
        packed = self.layout.pack(outs)     # before the state is overwritten
        write_back(self.tensors, state_tensors(new))
        return packed

    def load(self, state) -> None:
        """Copy ``state`` into the buffers, unless it is the state returned
        last (the buffers hold it), and hand its generators' state over."""
        if state is not self.last:
            for d, s in zip(self.tensors, state_tensors(state), strict=True):
                d.copy_(s)
            self.loads += 1
        hand_over(self.generators, generators(state))

    def snapshot(self, state):
        """``state``'s structure holding a copy of the buffers (one copy),
        with the caller's generators handed the buffers' draws back; it
        becomes the state returned last."""
        hand_over(generators(state), self.generators)
        self.last = with_tensors(state,
                                 self.flat_layout.views(self.flat.clone()))
        return self.last

    def run(self, state, lefts, rights, replay) -> tuple:
        """(state after the k frames, the outputs stacked (k, ...))."""
        self.load(state)
        left, right = self.inputs
        stack = torch.empty((lefts.shape[0], self.layout.nbytes),
                            dtype=torch.uint8, device=left.device)
        for i in range(lefts.shape[0]):
            left.copy_(lefts[i])
            right.copy_(rights[i])
            stack[i, :self.layout.used].copy_(replay())
        return (self.snapshot(state),) + self.layout.unpack(stack)

    def frame(self, state, inputs, replay, fetch=False) -> tuple:
        """One step: (state, packed outputs), the outputs a copy of the
        replay's row on the device, or with ``fetch`` the row on the host
        (numpy, one device-to-host copy). Spans: ``graph.input`` (the
        state's load and the inputs' copies), ``graph.replay``,
        ``graph.fetch`` (the row's copy; with ``fetch`` it waits for the
        device) and ``graph.snapshot``."""
        with profiling.span("graph.input"):
            self.load(state)
            for d, x in zip(self.inputs, inputs, strict=True):
                d.copy_(x)
        with profiling.span("graph.replay"):
            packed = replay()
        with profiling.span("graph.fetch"):
            row = packed.cpu().numpy() if fetch else packed.clone()
        with profiling.span("graph.snapshot"):
            return self.snapshot(state), row


class _StaticLoop:
    """A solver's iteration on static buffers: ``body(carry) -> carry``
    (a tree of tensors: a ``BAProblem``, the pose graph's arrays).
    ``step()`` runs the body on the static carry and writes the result
    back; ``run(carry, iterations, replay)`` loads ``carry``, calls
    ``replay()`` (a graph's replay, or ``step`` itself) ``iterations``
    times and returns the carry: copies of the buffers the body writes, the
    caller's own tensors for the ones it never writes."""

    def __init__(self, body, carry):
        self.body = body
        self.tensors = [t.clone() for t in state_tensors(carry)]
        self.carry = with_tensors(carry, self.tensors)
        self.written = None     # per tensor: whether the body writes it
        self.generators = []

    def step(self) -> None:
        new = state_tensors(self.body(self.carry))
        if self.written is None:
            self.written = [not n.is_set_to(d)
                            for d, n in zip(self.tensors, new)]
        write_back(self.tensors, new)

    def run(self, carry, iterations: int, replay):
        ins = state_tensors(carry)
        for d, s in zip(self.tensors, ins, strict=True):
            d.copy_(s)
        for _ in range(iterations):
            replay()
        return with_tensors(carry, [d.clone() if w else s for d, s, w in
                                    zip(self.tensors, ins, self.written)])


def _key(state, *inputs) -> tuple:
    return ((tuple((tuple(t.shape), t.dtype) for t in state_tensors(state)),
             len(generators(state)))
            + tuple(v for x in inputs for v in (tuple(x.shape), x.dtype)))


class _Capture:
    """One captured graph, its static step and its launches per replay.
    ``graph`` is what replays: a ``_Recording`` on a card, a ``_Tape`` in
    the CPU form of a body over several positions. ``collectives`` lists
    the collectives of process groups the capture issued, in order
    (``Collective``)."""

    def __init__(self, static, graph, packed, per_replay: dict,
                 seconds: float, label: str = "", collectives=()):
        self.static = static
        self.graph = graph
        self.packed = packed
        self.per_replay = per_replay
        self.seconds = seconds
        self.label = label
        self.collectives = list(collectives)

    def replay(self) -> torch.Tensor:
        self.graph.replay()
        add_launches(self.per_replay)
        return self.packed

    def release(self) -> None:
        """Wait for the work of the cards the graph runs on, and destroy
        its graphs (a ``_Recording``'s; the CPU forms hold none to
        destroy). The capture replays no more."""
        if isinstance(self.graph, _Recording):
            self.graph.release()
        self.graph = None


def _taken_back(static, body):
    """``body()``, with the draws of ``static``'s generators and the
    launches it counted taken back."""
    saved = [g.get_state() for g in static.generators]
    counts = launch_counts()
    try:
        return body()
    finally:
        set_launch_counts(counts)
        for g, s in zip(static.generators, saved):
            g.set_state(s)


class _BodyCapture(_Capture):
    """The CPU form of a capture: after the same warm-up, whose draws and
    launches are taken back, each replay runs the body itself (and counts
    the launches it makes). The collectives the warm-up issued are the
    capture's."""

    def __init__(self, static, body, label=""):
        with _issuing() as issued:
            _taken_back(static, body)
        super().__init__(static, None, None, {}, 0.0, label, issued)
        self.body = body

    def replay(self):
        return self.body()


# --- captures over one card or several ------------------------------------

#: this thread's state: ``open``, the captures it has begun and not ended
#: ((graph, stream, pool), oldest first); ``recording``, the capture of a
#: body over several positions in progress (``moves`` cuts it)
_THREAD = threading.local()


def _open() -> list:
    if not hasattr(_THREAD, "open"):
        _THREAD.open = []
    return _THREAD.open


def _begin(graph, stream, pool) -> None:
    with torch.cuda.stream(stream):
        graph.capture_begin(pool=pool, capture_error_mode="thread_local")
    _open().append((graph, stream, pool))


def _end(graph, stream, pool) -> None:
    with torch.cuda.stream(stream), _no_empty_warning():
        graph.capture_end()
    _open().remove((graph, stream, pool))


@contextlib.contextmanager
def _no_empty_warning():
    """Over several cards a card's graph between two groups of copies may
    hold no work, and so may a capture ended by ``end_captures``."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", "The CUDA Graph is empty")
        yield


def end_captures() -> None:
    """End every capture this thread has begun and not ended, newest
    first, on every card. A capture left open fails every later CUDA call
    on its stream ("operation not permitted when stream is capturing"), so
    a capture whose body or ``capture_end`` raises ends them all before
    the error propagates. A capture that CUDA has invalidated ends with an
    error, which is dropped here: the caller raises the first one."""
    opened = _open()
    while opened:
        graph, stream, pool = opened.pop()
        with torch.cuda.stream(stream), _no_empty_warning():
            try:
                graph.capture_end()
            except Exception:  # noqa: BLE001 - ended either way
                _release_pool(pool, stream.device)


def _release_pool(pool, device) -> None:
    """Take a capture's pool out of the allocator's routing, which an
    invalidated ``capture_end`` raises before doing."""
    try:
        torch._C._cuda_endAllocateToPool(device.index, pool)
    except Exception:  # noqa: BLE001 - it was taken out already
        pass


class Collective(NamedTuple):
    """A collective of a process group issued inside a capture: its kind
    ("all_gather", "broadcast", "ppermute"), the ranks of its group, the
    shape and dtype of the tensor this rank sends, the pairs of a
    ``ppermute`` (shard indices), and the group."""

    kind: str
    ranks: tuple
    shape: tuple
    dtype: torch.dtype
    pairs: tuple
    group: object


@contextlib.contextmanager
def _issuing():
    """Collect the collectives noted on this thread inside the block
    (``note_collective``) into the list it yields."""
    prev, _THREAD.issued = getattr(_THREAD, "issued", None), []
    try:
        yield _THREAD.issued
    finally:
        _THREAD.issued = prev


def note_collective(kind: str, group, ranks, tensor: torch.Tensor,
                    pairs=()) -> bool:
    """Note a collective over ``group`` (``parallel.collectives`` notes
    every one of a rank axis): inside a capture it is listed on the
    capture, in order, and logged. Returns whether it was."""
    issued = getattr(_THREAD, "issued", None)
    if issued is None:
        return False
    issued.append(Collective(kind, tuple(ranks), tuple(tensor.shape),
                             tensor.dtype, tuple(pairs), group))
    _log.debug("captured %s over ranks %s: %s %s", kind, tuple(ranks),
               tuple(tensor.shape), tensor.dtype)
    return True


#: every GraphedStep and GraphedLoop alive (``release`` looks at them)
_GRAPHED = weakref.WeakSet()


def release(groups=None) -> int:
    """Release every capture that holds collectives of a process group in
    ``groups`` (a list; None: of any group): wait for the cards it runs on,
    destroy its graphs and drop it, so that its next call captures again.
    Returns the number released. ``torch.distributed.destroy_process_group``
    calls it first once a graph holds a group's collectives
    (``_guard_teardown``)."""
    n = 0
    for graphed in list(_GRAPHED):
        with graphed._lock:
            for key, cap in list(graphed.captures.items()):
                if any(groups is None or any(c.group is g for g in groups)
                       for c in cap.collectives):
                    cap.release()
                    del graphed.captures[key]
                    n += 1
    if n:
        _log.debug("released %d captures holding collectives", n)
    return n


def _guard_teardown() -> None:
    """Make ``torch.distributed.destroy_process_group`` release the graphs
    that hold the collectives of the groups it destroys (every group's for
    the default one) before it destroys them, and the process' exit
    release every such graph; once. NCCL's communicator destroy waits
    until no graph holds its work, so a graph kept past it would hold the
    rank there for good."""
    c10d = torch.distributed.distributed_c10d
    destroy = c10d.destroy_process_group
    if getattr(destroy, "releases_graphs", False):
        return

    @functools.wraps(destroy)
    def destroy_process_group(group=None):
        every = group is None or group == c10d.GroupMember.WORLD
        release(None if every else [group])
        return destroy(group)

    destroy_process_group.releases_graphs = True
    c10d.destroy_process_group = destroy_process_group
    torch.distributed.destroy_process_group = destroy_process_group
    atexit.register(release)


def moves(items) -> list:
    """``x.to(device)`` for each ``(x, device)`` of ``items``: one group of
    copies between the positions of a one-process mesh, each from its
    caller's position to another (``parallel.collectives`` and the split
    LK launches move every shard through here). While a body over several
    cards is captured, the group cuts the graphs of the cards it touches
    (``_Recording.cut``); in the CPU form of such a capture it is recorded
    as a step of the tape (``_Tape.cut``)."""
    rec = getattr(_THREAD, "recording", None)
    if rec is None or not items:
        return [x.to(d) for x, d in items]
    return rec.cut([(x, torch.device(d)) for x, d in items])


class _Recording:
    """The graphs of one capture and the order they replay in.

    On one card: one graph. Over several cards (a one-process mesh row or
    solver axis across cards, ``devices`` its cards in order) every card
    captures its own work into a graph of its own, on its own stream, all
    at once; a group of copies between cards (``moves``) ends the graphs
    of the cards it touches, and each of those cards begins a new one in
    the same memory pool, where the copies' destinations are made. The
    plan lists the graphs as they end and each group of copies after them,
    so a replay runs every card's graphs in the order captured, on each
    card's current stream, with the copies between them ordered on both
    cards' streams as the eager copies are. The graphs over several cards
    are kept uninstantiated (``keep_graph``) until every capture has
    ended: CUDA refuses to instantiate a graph in this thread while
    another capture is open in it."""

    def __init__(self, devices, streams, generators):
        self.devices = list(devices)
        self.streams = streams
        self.generators = generators
        self.keep = len(self.devices) > 1
        self.pools = {}
        self.capturing = {}
        self.plan = []      # CUDAGraphs, and lists of (dst, src) copies

    def __enter__(self):
        try:
            for d in self.devices:
                self._begin(d)
        except BaseException:
            end_captures()
            raise
        if self.keep:
            _THREAD.recording = self
        return self

    def __exit__(self, kind, err, tb):
        _THREAD.recording = None
        if kind is not None:
            end_captures()
            return False
        try:
            for d in self.devices:
                self._end(d)
        except BaseException:
            end_captures()
            raise
        if self.keep:
            for g in self.plan:
                if not isinstance(g, list):
                    g.instantiate()
        return False

    def _begin(self, device) -> None:
        graph = (torch.cuda.CUDAGraph(keep_graph=True) if self.keep
                 else torch.cuda.CUDAGraph())
        with torch.cuda.stream(self.streams[device]):
            for g in self.generators:
                if not self.keep or _indexed(g.device) == device:
                    graph.register_generator_state(g)
            if device not in self.pools:
                self.pools[device] = torch.cuda.graph_pool_handle()
        _begin(graph, self.streams[device], self.pools[device])
        self.capturing[device] = graph

    def _end(self, device) -> None:
        graph = self.capturing.pop(device)
        _end(graph, self.streams[device], self.pools[device])
        self.plan.append(graph)

    def cut(self, items) -> list:
        cards = list(dict.fromkeys(
            d for x, dst in items if x.device != dst for d in (x.device, dst)))
        unknown = [str(d) for d in cards if d not in self.capturing]
        if unknown:
            raise ValueError(f"a move to or from {unknown}, outside the "
                             f"cards of this capture {self.devices}")
        for d in cards:
            self._end(d)
        for d in cards:
            self._begin(d)
        out, copies = [], []
        for x, dst in items:
            if x.device == dst:
                out.append(x)
                continue
            with torch.cuda.stream(self.streams[dst]):
                y = torch.empty_like(x, device=dst)
            copies.append((y, x))
            out.append(y)
        self.plan.append(copies)
        return out

    def replay(self) -> None:
        for step in self.plan:
            if isinstance(step, list):
                for dst, src in step:
                    dst.copy_(src)
            else:
                step.replay()

    def release(self) -> None:
        """Wait for every card of the recording, then destroy its
        graphs."""
        for d in self.devices:
            torch.cuda.synchronize(d)
        for g in self.plan:
            if not isinstance(g, list):
                g.reset()
        self.plan = []


class _Tape(TorchDispatchMode):
    """The CPU form of a capture over several positions (a one-process
    mesh row or solver axis over devices named as distinct positions,
    ``cpu:0``, ``cpu:1``, ...), which records what a card's capture
    records and replays it as the cards replay their plan.

    While active it records every operator the body runs (the LK
    kernels' plain versions each as one step, ``kernel``), with its
    operands and results, and each group of ``moves`` as a step of
    copies into destinations made for them; a replay re-runs the steps in
    order and writes each result into the tensor recorded for it, so the
    body's later steps read it where they read it at capture. Like a
    card's capture it refuses a value read back to the host."""

    def __init__(self):
        super().__init__()
        self.plan = [[]]    # lists of operator steps, and of (dst, src) copies
        self.cuts = []      # the devices each group of moves reached

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _HOST_READS:
            raise RuntimeError(f"{func} reads a value back to the host "
                               f"inside a captured body")
        out = func(*args, **kwargs)
        self._record(func, args, kwargs, out)
        return out

    def kernel(self, fn, args, kwargs):
        with _disable_current_modes():
            out = fn(*args, **kwargs)
            self._record(fn, args, kwargs, out)
        return out

    def _record(self, fn, args, kwargs, out) -> None:
        # Each tensor kept with the shape and strides it had here: an
        # in-place view op (``squeeze_``) changes a tensor's own, here or
        # at a replay.
        self.plan[-1].append((fn, *tree_map_only(torch.Tensor, _Frozen,
                                                 (args, kwargs, out))))

    def cut(self, items) -> list:
        with _disable_current_modes():
            copies = [(torch.empty_like(x), x) for x, _ in items]
        self.cuts.append([d for _, d in items])
        self.plan += [copies, []]
        return [y for y, _ in copies]

    def replay(self) -> None:
        for i, step in enumerate(self.plan):
            if i % 2:
                for dst, src in step:
                    dst.copy_(src)
                continue
            for fn, args, kwargs, out in step:
                args, kwargs, out = tree_map_only(
                    _Frozen, _Frozen.view, (args, kwargs, out))
                for rec, new in zip(_leaves(out), _leaves(fn(*args, **kwargs))):
                    if (isinstance(rec, torch.Tensor)
                            and rec.data_ptr() != new.data_ptr()):
                        rec.copy_(new)


#: the operators that read a tensor's value on the host (``item``,
#: ``bool``, ``torch.equal``), which a card's capture refuses
_HOST_READS = (torch.ops.aten._local_scalar_dense.default,
               torch.ops.aten.is_nonzero.default, torch.ops.aten.equal.default)


class _Frozen:
    """A tensor as it was when a ``_Tape`` recorded it: ``view()`` is its
    memory with that shape and those strides."""

    def __init__(self, t: torch.Tensor):
        self.t = t
        self.geometry = (t.shape, t.stride(), t.storage_offset())

    def view(self) -> torch.Tensor:
        return self.t.as_strided(*self.geometry)


def _leaves(x) -> list:
    if isinstance(x, (list, tuple)):
        return [v for y in x for v in _leaves(y)]
    return [] if x is None else [x]


def kernel(fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, a kernel's plain version on the CPU; while
    a ``_Tape`` records, one step of it (as a card's graph records one
    kernel node), whatever the plain version reads on the host."""
    rec = getattr(_THREAD, "recording", None)
    if isinstance(rec, _Tape):
        return rec.kernel(fn, args, kwargs)
    return fn(*args, **kwargs)


class _TapeCapture(_Capture):
    """The CPU form of a capture over several positions: the warm-up as a
    card's, then the body recorded on a ``_Tape``, whose draws and
    launches are taken back as a card's capture makes none; each replay
    replays the tape."""

    def __init__(self, static, body, label=""):
        _taken_back(static, body)
        tape = _Tape()

        def recorded():
            _THREAD.recording = tape
            try:
                with tape:
                    out = body()
            finally:
                _THREAD.recording = None
            return out, launch_counts()

        before = launch_counts()
        with _issuing() as issued:
            packed, after = _taken_back(static, recorded)
        super().__init__(static, tape, packed,
                         {k: n - before[k] for k, n in after.items()
                          if n != before[k]}, 0.0, label, issued)


def _capture(static, body, devices, label: str) -> _Capture:
    """Capture ``body()`` (a ``_StaticStep``'s ``body`` or a
    ``_StaticLoop``'s ``step``) over ``devices`` (its cards, the static
    buffers' first) on a side stream of each, after one warm-up run of it
    there whose draws are taken back; the generators of ``static`` are
    registered with every graph on their card (``_Recording``). Nothing
    synchronises with the host. A body or a ``capture_end`` that raises
    ends every open capture (``end_captures``) before the error reaches
    the caller; nothing steps eagerly in its place."""
    t0 = time.perf_counter()
    currents = {d: torch.cuda.current_stream(d) for d in devices}
    sides = {d: torch.cuda.Stream(d) for d in devices}
    for d in devices:
        sides[d].wait_stream(currents[d])
    counts = launch_counts()
    try:
        with contextlib.ExitStack() as on_sides:
            for d in reversed(devices):     # the first card ends current
                on_sides.enter_context(torch.cuda.stream(sides[d]))
            # Warm-up: the body's first-use work happens here, not in the
            # capture.
            _log.debug("warm-up of %s on %s", label, devices)
            _taken_back(static, body)
            before = launch_counts()
            _log.debug("capture of %s", label)
            with _issuing() as issued, _Recording(
                    devices, sides, static.generators) as rec:
                packed = body()
            _log.debug("captured %s: %d graphs", label,
                       sum(not isinstance(g, list) for g in rec.plan))
            per_replay = {k: n - before[k]
                          for k, n in launch_counts().items()
                          if n != before[k]}
    finally:
        set_launch_counts(counts)
    for d in devices:
        currents[d].wait_stream(sides[d])
    return _Capture(static, rec, packed, per_replay,
                    time.perf_counter() - t0, label, issued)


def _make_capture(static, body, devices, replay_body, label) -> _Capture:
    """The capture of ``body`` on a card or in a CPU form, as a
    ``graph.capture`` span labelled ``label`` and a count of
    ``graph.captures`` (``utils.profiling``); the teardown is guarded once
    it holds collectives."""
    with profiling.span("graph.capture", label=label):
        if not replay_body:
            cap = _capture(static, body, devices, label)
        elif len(devices) > 1:
            cap = _TapeCapture(static, body, label)
        else:
            cap = _BodyCapture(static, body, label)
    profiling.count("graph.captures")
    if cap.collectives:
        _guard_teardown()
    return cap


def _label(fn) -> str:
    """A step's or a loop body's name, for the capture log."""
    fn = getattr(fn, "func", fn)
    return getattr(fn, "__qualname__", type(fn).__name__)


def _indexed(device) -> torch.device:
    """``device`` with its index: "cuda" is the current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _cards(device, devices) -> list:
    """The cards a body runs on, in order, each with its index (the
    static buffers' ``device`` first): ``devices``, or ``device`` alone."""
    return list(dict.fromkeys(_indexed(d) for d in [device, *(devices or ())]))


class GraphedStage:
    """A ``GraphedStep``'s capture driven by a caller that orders the
    replays on its own streams (the pipe's stages; ``GraphedStep.stage``
    makes it, with the caller's state loaded). ``feed`` copies tensors into
    the input buffers on the current stream; ``replay`` steps the state in
    the buffers once and returns the outputs as views of the graph's row,
    which the next replay overwrites; with ``keep`` a copy of the row is
    kept, and ``kept`` returns the kept rows' outputs stacked (k, ...)."""

    def __init__(self, cap: _Capture):
        self._cap = cap
        self._layout = cap.static.layout
        self._kept = []

    def feed(self, tensors) -> None:
        """Copy ``tensors`` (host tensors in pinned memory, or tensors on a
        card) into the input buffers, without waiting for the host."""
        for d, x in zip(self._cap.static.inputs, tensors, strict=True):
            d.copy_(x, non_blocking=True)

    def replay(self, keep: bool = False) -> tuple:
        row = self._cap.replay()
        if keep:
            self._kept.append(row.clone())
        return self._layout.unpack_row(row)

    def kept(self) -> tuple:
        rows = torch.stack(self._kept)
        stack = torch.zeros((rows.shape[0], self._layout.nbytes),
                            dtype=torch.uint8, device=rows.device)
        stack[:, :self._layout.used] = rows
        return self._layout.unpack(stack)


class GraphedStep:
    """The eager step ``step(state, *inputs) -> (state, *outputs)``
    (``runner.pipeline.make_step_fn`` for ``device``, a card: inputs a
    frame pair, outputs ``StepOutput[, TrackSnapshot]``; or a pipe stage)
    replayed from CUDA graphs.

    ``__call__`` has the step's contract; ``fetched`` too, with the
    outputs as numpy arrays from one device-to-host copy;
    ``scan(state, lefts, rights)`` steps k frames ((k, [B,] H, W), numpy
    or tensors, uploaded in one copy unless on the card) and returns the
    outputs stacked (k, ...); ``stage`` hands a pipe the capture to drive
    itself. One graph is captured for each state shape (one sequence or
    B), input shape and dtype, at its first call (or at ``capture``);
    ``captures`` lists them. The scan and the per-frame calls share them.
    Calls are serialised: the buffers hold one state at a time.
    ``devices`` are the cards the step runs on, where it spans several (a
    mesh row split across cards; ``device``, where the buffers live, is
    the first): each replay then runs each card's graphs in turn
    (``_Recording``). ``_replay_body`` is the CPU form (the tests'): the
    same static buffers and loops, each replay the body itself, or over
    several positions the ``_Tape`` of it.
    """

    def __init__(self, step, device, _replay_body=False, devices=None):
        device = torch.device(device)
        if not _replay_body:
            use_graph(device, True)
        self.step = step
        self.device = device
        self.devices = _cards(device, devices)
        self.replay_body = _replay_body
        self.captures: dict = {}
        self._lock = threading.RLock()
        _GRAPHED.add(self)

    def __call__(self, state, *inputs):
        layout, new, row = self._frame(state, inputs, fetch=False)
        return (new,) + layout.unpack_row(row)

    def fetched(self, state, *inputs):
        """``__call__`` with the outputs fetched: NamedTuples of numpy
        arrays, in one device-to-host copy."""
        layout, new, row = self._frame(state, inputs, fetch=True)
        return (new,) + layout.unpack_host(row)

    def _on_device(self):
        return (contextlib.nullcontext() if self.replay_body
                else torch.cuda.device(self.device))

    def _frame(self, state, inputs, fetch):
        inputs = [torch.as_tensor(x) for x in inputs]
        with self._lock, self._on_device():
            cap = self._get(state, inputs)
            return (cap.static.layout,) + cap.static.frame(
                state, inputs, cap.replay, fetch)

    def scan(self, state, lefts, rights) -> tuple:
        lefts = torch.as_tensor(lefts).to(self.device)
        rights = torch.as_tensor(rights).to(self.device)
        with self._lock, self._on_device():
            cap = self._get(state, [lefts[0], rights[0]])
            return cap.static.run(state, lefts, rights, cap.replay)

    def capture(self, state, *inputs) -> None:
        """Capture the graph for ``state`` and ``inputs`` now, if there is
        none (``state`` and its generators are left as they are)."""
        with self._lock, self._on_device():
            self._get(state, [torch.as_tensor(x) for x in inputs])

    @contextlib.contextmanager
    def stage(self, state, *inputs):
        """The capture for ``state`` and ``inputs`` as a ``GraphedStage``,
        with ``state`` loaded into the buffers; the step is held for the
        block, at whose end ``state``'s generators are handed the draws the
        replays made."""
        with self._lock:
            with self._on_device():
                cap = self._get(state, [torch.as_tensor(x) for x in inputs])
            cap.static.load(state)
            yield GraphedStage(cap)
            hand_over(generators(state), cap.static.generators)

    def _get(self, state, inputs) -> _Capture:
        key = _key(state, *inputs)
        cap = self.captures.get(key)
        if cap is None:
            static = _StaticStep(self.step, state,
                                 *(x.to(self.device) for x in inputs))
            cap = self.captures[key] = _make_capture(
                static, static.body, self.devices, self.replay_body,
                _label(self.step))
        return cap


class GraphedLoop:
    """A fixed-trip solver loop, ``for _ in range(iterations): carry =
    body(carry)``, replayed from CUDA graphs: one iteration captured on
    static buffers (``_StaticLoop``) and replayed ``iterations`` times,
    the counterpart of the JAX package's ``lax.scan(body, carry, None,
    length=iterations)`` under ``jit``. ``body`` binds the loop's static
    arguments (damping, the Huber scale); one graph is captured for each
    shape and dtype of the carry's tensors and value of its other leaves
    (a problem's intrinsics), at its first call, and the
    ``_MAX_LOOP_CAPTURES`` used last are kept. Calls are serialised.
    ``devices`` and ``_replay_body`` as ``GraphedStep``'s."""

    def __init__(self, body, device, _replay_body=False, devices=None):
        device = torch.device(device)
        if not _replay_body:
            use_graph(device, True)
        self.body = body
        self.device = device
        self.devices = _cards(device, devices)
        self.replay_body = _replay_body
        self.captures: collections.OrderedDict = collections.OrderedDict()
        self._lock = threading.Lock()
        _GRAPHED.add(self)

    def __call__(self, carry, iterations: int):
        if iterations <= 0:
            return carry
        key = (_key(carry), static_leaves(carry))
        with self._lock, (contextlib.nullcontext() if self.replay_body
                          else torch.cuda.device(self.device)):
            cap = self.captures.get(key)
            if cap is None:
                static = _StaticLoop(self.body, carry)
                cap = self.captures[key] = _make_capture(
                    static, static.step, self.devices, self.replay_body,
                    _label(self.body))
                while len(self.captures) > _MAX_LOOP_CAPTURES:
                    self.captures.popitem(last=False)
            self.captures.move_to_end(key)
            return cap.static.run(carry, iterations, cap.replay)
