"""The port's span recorder: named host spans and counters, kept in memory.

``span(name)`` is a context manager. Each span records its name (and an
optional ``label``), an id, the id of its parent (the innermost span open
on the same thread; 0 for none), a request id, its thread and its start
and end on ``time.perf_counter_ns()``. Every span of one request shares
its request id: a span opened with no span open on its thread starts a
new request, unless it is given one (``request=``), as a helper thread's
spans take the request of the call that started the thread
(``current_request()``).

Spans sit at the layer boundaries of the front doors, never per kernel or
per replay inside a chunk: the batched runner's set-up, loop, waits on its
uploader, chunk launches, fetches and pose chaining; each uploader's
stacking, copies and waits on a full queue; ``VisualOdometry``'s frames
and, inside each, the graph's input copies, replay, fetch and state
snapshot; each graph capture.

The recorder is on by default, a flight recorder: closed spans go into a
ring of ``RING`` records and are read back only when asked for
(``records``); once the ring is full the oldest are dropped and counted.
``recording(False)`` turns it off: spans then still time their block (a
span's ``seconds`` is its caller's stopwatch), and nothing is recorded or
counted. While a ``torch.profiler`` runs, each span also opens a range of
its name on its thread, recorded as an op (``_Range``), so the
profiler's trace holds the program's spans on the clock of its kernels;
with no profiler running no range is opened.

Counters (``count``) are named integer adds, read through ``records``.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import NamedTuple, Optional

from torch.autograd import profiler as _autograd_profiler

try:
    # a range recorded as an op, on the host's timeline alone: a
    # ``torch.profiler.record_function`` range is a user annotation, which
    # the profiler also mirrors onto the device's timeline as an event over
    # the kernels launched inside it, and a trace's reader would count that
    # event as device work
    from torch._C._profiler import _RecordFunctionFast as _Range
except ImportError:             # a torch without it: no ranges
    _Range = None

#: spans the ring holds: several 51 s windows of one camera at ~95
#: frames/s and ~6 spans a frame
RING = 1 << 17

_clock = time.perf_counter_ns
_get_ident = threading.get_ident
_ids = itertools.count(1)
_requests = itertools.count(1)
_lock = threading.Lock()          # the dropped count and the counters
#: the innermost span open on each thread, by thread ident
_tops: dict = {}
_on = True
_ring: collections.deque = collections.deque(maxlen=RING)
_dropped = 0
_dropped_end_ns = -1              # end of the newest record dropped
_counters: dict = {}


class SpanRecord(NamedTuple):
    name: str
    label: str
    id: int
    parent: int                   # 0: none open on its thread
    request: int
    thread: int                   # threading.get_ident()
    start_ns: int                 # time.perf_counter_ns()
    end_ns: int


class Records(NamedTuple):
    spans: list                   # SpanRecords, in the order they closed
    counters: dict
    dropped: int                  # records the ring has dropped, ever
    complete: bool                # none dropped that ended at or after
                                  # the start asked for


def _drop() -> None:
    """Count the record a full ring is about to drop (taken only on a full
    ring)."""
    global _dropped, _dropped_end_ns
    with _lock:
        if len(_ring) == _ring.maxlen:
            _dropped += 1
            _dropped_end_ns = max(_dropped_end_ns, _ring[0][-1])


class span:
    """``with span(name) as s``: record the block as a span (see the
    module's doc). ``s.seconds`` is its length once it has closed."""

    __slots__ = ("name", "label", "id", "parent", "request", "thread",
                 "start_ns", "end_ns", "_range", "_outer")

    def __init__(self, name: str, label: str = "",
                 request: Optional[int] = None):
        self.name = name
        self.label = label
        self.request = request

    def __enter__(self) -> "span":
        thread = self.thread = _get_ident()
        outer = self._outer = _tops.get(thread)
        _tops[thread] = self
        self.id = next(_ids)
        if outer is None:
            self.parent = 0
            if self.request is None:
                self.request = next(_requests)
        else:
            self.parent = outer.id
            if self.request is None:
                self.request = outer.request
        # one module flag: whether a torch.profiler runs
        if _on and _autograd_profiler._is_profiler_enabled and _Range:
            self._range = _Range(self.name)
            self._range.__enter__()
        else:
            self._range = None
        self.start_ns = _clock()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = _clock()
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        if self._outer is None:
            _tops.pop(self.thread, None)
        else:
            _tops[self.thread] = self._outer
            self._outer = None
        if _on:
            if len(_ring) == _ring.maxlen:
                _drop()
            # a tuple of atomic values, which the garbage collector stops
            # tracking: a ring of span objects slows every collection
            _ring.append((self.name, self.label, self.id, self.parent,
                          self.request, self.thread, self.start_ns,
                          self.end_ns))
        return False

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


def current_request() -> int:
    """The request of the innermost span open on this thread, or a new
    request id where none is open: hand it to a thread's spans
    (``span(..., request=)``) to make them part of the caller's
    request."""
    top = _tops.get(_get_ident())
    return top.request if top is not None else next(_requests)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (nothing while off)."""
    if _on:
        with _lock:
            _counters[name] = _counters.get(name, 0) + n


def recording(on: bool) -> bool:
    """Turn recording on or off; returns the setting it replaces."""
    global _on
    was, _on = _on, bool(on)
    return was


def records(start_ns: Optional[int] = None,
            end_ns: Optional[int] = None) -> Records:
    """The recorded spans that started at or after ``start_ns`` and ended
    at or before ``end_ns`` (``time.perf_counter_ns()``; None: no limit),
    the counters, and whether the ring dropped any record of that
    window."""
    lo = -1 if start_ns is None else start_ns
    hi = float("inf") if end_ns is None else end_ns
    spans = [SpanRecord(*r) for r in list(_ring)
             if lo <= r[-2] and r[-1] <= hi]
    return Records(spans, dict(_counters), _dropped,
                   _dropped == 0 or _dropped_end_ns < lo)


def _reset(size: int = RING) -> None:
    """Empty the ring (now of ``size`` records), the counters and the
    dropped count."""
    global _ring, _dropped, _dropped_end_ns
    with _lock:
        _ring = collections.deque(maxlen=size)
        _dropped, _dropped_end_ns = 0, -1
        _counters.clear()
