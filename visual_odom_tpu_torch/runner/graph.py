"""The per-frame step as one CUDA graph: captured once, replayed per frame.

The JAX package jits its step and scans it over a chunk of frames in one
device dispatch (``make_scan_step_fn``: ``jax.jit`` of a ``lax.scan``).
The port's eager step issues ~7,000 kernels a frame from the host, one by
one. ``GraphedStep`` captures them once into a CUDA graph
(``torch.cuda.CUDAGraph``) and steps each frame with one replay.
``runner.pipeline.make_scan_step_fn`` steps through it by default on a
card, so ``run_sequence_scan``, ``run_sequence_scan_resumable``, the
one-card ``run_sequences_batched``, the bench and the command line's
chunked ``run`` and one-card ``run-batch`` replay it. The CPU has no graphs: there
the step runs eagerly.

A graph replays fixed addresses, so the step runs on static buffers
(``_StaticStep``):

- The state's tensors (the features, both ``LKImage`` pyramids, the warm
  start) and the frame pair live in buffers made at capture. A replay
  steps the pair in the frame buffers, packs the outputs into one byte
  buffer, and writes the new state over the old one as the graph's last
  nodes (``write_back``).
- A state that is not the one this step returned last (the scan's warm-up
  state, a restored snapshot, another sequence) is copied into the buffers
  first. The one returned last is not.
- After each replay, the outputs are copied out of the graph's byte
  buffer into the chunk's stack, one copy a frame (``OutputLayout``), so
  they survive the next replay. At the chunk's end the state comes back
  as clones of the buffers, so a later call overwrites nothing returned.
- The RANSAC draws come from generators that the graph owns and has
  registered (``CUDAGraph.register_generator_state``). Each call hands
  them the state of the caller's generators and hands it back after its
  last replay, so replay k draws what eager step k draws, and the
  caller's generators end where eager's end (the scan checkpoint stores
  their state).

Per frame the host issues the two frame copies, the replay and the output
copy; the replay also refills two scalars per registered generator that
draws (``torch.cuda.CUDAGraph``'s seed and offset).

Capture (``GraphedStep``): one eager step on a side stream first makes
whatever the step makes at its first use (the kernels' library, cuBLAS's
handles, the cached device constants, which a pageable upload builds and
which may not be captured). Then the step is captured on that stream in
"thread_local" mode, so the uploader threads' copies on their own streams
neither break the capture nor are broken by it. Nothing synchronises with
the host. A capture that fails raises; nothing falls back to the eager
step.

Launch counts: the LK wrappers count the kernels they launch
(``lk_circular_quad.launches`` and ``lk_track_pyramid.launches``, and
their ``batched_launches``). A capture records each count's growth as the
graph's launches per replay, and takes back what the warm-up and the
capture added, since they build the graph as a JAX trace does. Each
replay then adds its launches to the counts.
"""

from __future__ import annotations

import threading
import time

import torch

from visual_odom_tpu_torch.ops.lk import lk_track_pyramid
from visual_odom_tpu_torch.ops.lk_cuda import lk_circular_quad

#: the LK wrappers' launch counts: (wrapper, attribute) by name
_COUNTERS = {"quad": (lk_circular_quad, "launches"),
             "quad_batched": (lk_circular_quad, "batched_launches"),
             "level": (lk_track_pyramid, "launches"),
             "level_batched": (lk_track_pyramid, "batched_launches")}


def launch_counts() -> dict:
    """The LK wrappers' launch counts, by name."""
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
    """The state's RANSAC generators: one, or one per sequence."""
    g = state.generator
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


class OutputLayout:
    """Where each output of a step lies in one byte buffer.

    The step's outputs (NamedTuples of tensors: a ``StepOutput`` and, with
    tracks, a ``TrackSnapshot``) are packed widest element first, so every
    field lies aligned; a stack row is padded to 8 bytes. ``pack`` writes
    one frame's outputs as ``used`` bytes; ``unpack`` reads a (k,
    ``nbytes``) stack of such rows back as the same NamedTuples with a
    leading k, each field a contiguous tensor of its own, as the eager
    scan's stacks are."""

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

    def unpack(self, stack: torch.Tensor) -> tuple:
        """A (k, ``nbytes``) uint8 stack -> the outputs stacked (k, ...)."""
        k = stack.shape[0]
        vals = {(i, j): stack[:, off:off + n].view(dtype)
                .reshape((k,) + shape).contiguous()
                for i, j, dtype, shape, off, n in self.fields}
        return tuple(t(*(vals[i, j] for j in range(len(t._fields))))
                     for i, t in enumerate(self.types))


class _StaticStep:
    """The step on static buffers: the body a graph records and the loop
    that replays it.

    ``step(state, left, right) -> (state, *outputs)`` is the eager step;
    ``state``, ``left`` and ``right`` give the buffers their shapes and
    first contents. ``body()`` steps the static state on the static frames,
    packs the outputs and writes the new state back; it returns the packed
    outputs. ``run(state, lefts, rights, replay)`` steps k frames, each by
    one ``replay()`` that returns the packed outputs (a graph's replay, or
    ``body`` itself). The tensors it returns are its own: no later call
    writes over them.
    """

    def __init__(self, step, state, left, right):
        self.step = step
        self.tensors = [t.clone() for t in state_tensors(state)]
        gens = generators(state)
        self.generators = [torch.Generator(device=g.device) for g in gens]
        hand_over(self.generators, gens)
        own = (tuple(self.generators) if isinstance(state.generator, tuple)
               else self.generators[0])
        self.state = with_tensors(state, self.tensors)._replace(generator=own)
        self.left, self.right = left.clone(), right.clone()
        self.layout = None
        self.last = None        # the state returned last
        self.loads = 0          # states copied into the buffers

    def body(self) -> torch.Tensor:
        new, *outs = self.step(self.state, self.left, self.right)
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

    def run(self, state, lefts, rights, replay) -> tuple:
        """(state after the k frames, the outputs stacked (k, ...))."""
        self.load(state)
        stack = torch.empty((lefts.shape[0], self.layout.nbytes),
                            dtype=torch.uint8, device=self.left.device)
        for i in range(lefts.shape[0]):
            self.left.copy_(lefts[i])
            self.right.copy_(rights[i])
            stack[i, :self.layout.used].copy_(replay())
        hand_over(generators(state), self.generators)
        self.last = with_tensors(state, [t.clone() for t in self.tensors])
        return (self.last,) + self.layout.unpack(stack)


def _key(state, lefts, rights) -> tuple:
    return (tuple((tuple(t.shape), t.dtype) for t in state_tensors(state)),
            len(generators(state)), tuple(lefts.shape[1:]), lefts.dtype,
            tuple(rights.shape[1:]), rights.dtype)


class _Capture:
    """One captured graph, its static step and its launches per replay."""

    def __init__(self, static: _StaticStep, graph, packed, per_replay: dict,
                 seconds: float):
        self.static = static
        self.graph = graph
        self.packed = packed
        self.per_replay = per_replay
        self.seconds = seconds
        self.replays = 0

    def replay(self) -> torch.Tensor:
        self.graph.replay()
        self.replays += 1
        add_launches(self.per_replay)
        return self.packed


class GraphedStep:
    """The eager step ``step(state, left, right) -> (state, StepOutput[,
    TrackSnapshot])`` (``runner.pipeline.make_step_fn`` for ``device``, a
    card) replayed from CUDA graphs.

    ``__call__`` has the step's contract; ``scan(state, lefts, rights)``
    steps k frames ((k, [B,] H, W), numpy or tensors, uploaded in one copy
    unless on the card) and returns the outputs stacked (k, ...). One graph
    is captured for each state shape (one sequence or B), frame shape and
    dtype, at its first call; ``captures`` lists them. Calls are
    serialised: the buffers hold one state at a time.
    """

    def __init__(self, step, device):
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a card, got {device}: the "
                             f"step runs eagerly on the CPU")
        self.step = step
        self.device = device
        self.captures: dict = {}
        self._lock = threading.Lock()

    def __call__(self, state, left, right):
        new, *outs = self.scan(state, torch.as_tensor(left)[None],
                               torch.as_tensor(right)[None])
        return (new,) + tuple(type(o)(*(x[0] for x in o)) for o in outs)

    def scan(self, state, lefts, rights) -> tuple:
        lefts = torch.as_tensor(lefts).to(self.device)
        rights = torch.as_tensor(rights).to(self.device)
        key = _key(state, lefts, rights)
        with self._lock, torch.cuda.device(self.device):
            cap = self.captures.get(key)
            if cap is None:
                cap = self.captures[key] = self._capture(state, lefts[0],
                                                         rights[0])
            return cap.static.run(state, lefts, rights, cap.replay)

    def _capture(self, state, left, right) -> _Capture:
        t0 = time.perf_counter()
        static = _StaticStep(self.step, state, left, right)
        saved = [g.get_state() for g in static.generators]
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        graph = torch.cuda.CUDAGraph()
        counts = launch_counts()
        try:
            with torch.cuda.stream(side):
                # Warm-up: the step's first-use work happens here, not in
                # the capture. Its draws are taken back.
                static.body()
                for g, s in zip(static.generators, saved):
                    g.set_state(s)
                for g in static.generators:
                    graph.register_generator_state(g)
                before = launch_counts()
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    packed = static.body()
                finally:
                    graph.capture_end()
                per_replay = {k: n - before[k]
                              for k, n in launch_counts().items()
                              if n != before[k]}
        finally:
            set_launch_counts(counts)
        current.wait_stream(side)
        return _Capture(static, graph, packed, per_replay,
                        time.perf_counter() - t0)
