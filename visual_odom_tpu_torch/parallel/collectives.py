"""Collectives over one mesh axis, in two forms.

The JAX package runs its multi-device paths from one controller over a
``Mesh`` (after ``jax.distributed.initialize`` one that spans processes),
and XLA writes their collectives (``psum``, ``ppermute``) from sharding
constraints or ``shard_map``. Here the solvers name them. A distributed
value along a mesh axis of D shards is a list of the shards this process
issues, and each function below maps such a list to another. The axis
(``parallel.mesh.mesh_axis``) takes one of two forms:

- **One process** (a list of D devices): the list holds every shard,
  shard k's on the k-th device. Between cards a shard moves by a
  device-to-device copy, which PyTorch orders on both cards' current
  streams; each function's copies go as one group through
  ``utils.cudagraph.moves``, where a capture across cards cuts its
  graphs. One card named several times (``[cuda:0] * 4``) and CPU devices
  take the same code; a shard bound for its own device is not copied.
- **One rank per shard** (a ``RankAxis``): the list holds this rank's
  shard alone, and the values move through ``torch.distributed`` over the
  axis' process group. NCCL runs its collectives on the card's streams, so
  none waits on the host. Gloo takes CUDA tensors in ``all_gather`` and
  ``broadcast`` but not in ``send``/``recv`` (its TCP pairs write from the
  host), so a gloo ``ppermute`` of CUDA tensors goes through the host.

Every collective of the process form is noted to ``utils.cudagraph``
(``note_collective``): inside a capture it joins the capture's list, and
the graph is released before its group is destroyed. Outside a capture it
is a ``collective.<op>`` span (``gather``, ``broadcast``, ``ppermute``;
``utils.profiling``) labelled with its bytes, and adds to the counters
``collective.calls`` and ``collective.bytes``; inside one nothing is
recorded, since the graph's replays issue it. Its bytes are those it
writes on this rank: all D shards of a ``gather``, the broadcast tensor,
a ``ppermute``'s received tensor.

Both forms give the same bits: ``psum`` gathers every shard and adds them
in shard order, shard 0 + shard 1 + ... + shard D-1, where NCCL's
``all_reduce`` would add them in its own ring or tree order. Scalars stay
tensors on their devices; a solver's guards are ``torch.where``s on them.
``shards(axis)`` lists the (index, device) pairs a process issues.
"""

from __future__ import annotations

import contextlib
from typing import Callable, NamedTuple, Sequence

import torch

from visual_odom_tpu_torch.utils import cudagraph, profiling


class RankAxis(NamedTuple):
    """A mesh axis whose shards are ranks: shard k is rank ``ranks[k]`` on
    ``devices[k]``, this process is shard ``index``, and ``group`` is the
    process group of ``ranks``."""

    ranks: tuple
    devices: tuple
    index: int
    group: object


def shards(axis) -> list:
    """The (shard index, device) pairs this process issues: all of them in
    the one-process form, its own in the process form."""
    if isinstance(axis, RankAxis):
        return [(axis.index, axis.devices[axis.index])]
    return list(enumerate(axis))


def axis_size(axis) -> int:
    """The number of shards D along ``axis``."""
    return len(axis.ranks if isinstance(axis, RankAxis) else axis)


def axis_key(axis):
    """``axis`` as a cache key: a ``RankAxis`` as it is, a list of devices
    as a tuple."""
    return axis if isinstance(axis, RankAxis) else tuple(axis)


def graph_place(axis) -> tuple:
    """Where a CUDA graph of a step or an iteration over ``axis`` (a
    one-process row or axis, a list or tuple of devices; or a
    ``RankAxis``) keeps its static buffers, and whether it may be
    captured: (the device, why ``axis`` steps eagerly by rule or None).
    A rank axis' device is its own rank's, and an NCCL rank axis, in a
    world of any size, captures its collectives inside its graph; a
    one-process axis' device is its first device's, and a one-process axis
    across cards captures every card's work (``graph_devices``). Eager by
    rule: a rank axis over gloo, whose collectives run on the host.
    """
    if isinstance(axis, RankAxis):
        dev = torch.device(axis.devices[axis.index])
        backend = _dist().get_backend(axis.group)
        if backend != "nccl":
            return dev, f"{backend}'s collectives run on the host"
        return dev, None
    return graph_devices(axis)[0], None


def graph_devices(axis) -> tuple:
    """The devices a graph over ``axis`` records work on, in order: a rank
    axis' own; a one-process axis' distinct devices (one card named
    several times is one device)."""
    if isinstance(axis, RankAxis):
        return (torch.device(axis.devices[axis.index]),)
    return tuple(dict.fromkeys(torch.device(d) for d in axis))


def use_graph_on(axis, graphed=None) -> bool:
    """``utils.cudagraph.use_graph`` for a step or an iteration over
    ``axis``, at ``graph_place``'s device and by its rule."""
    device, eager = graph_place(axis)
    return cudagraph.use_graph(device, graphed, eager)


def _dist():
    return torch.distributed


@contextlib.contextmanager
def _recorded(op: str, nbytes: int, captured: bool):
    """The block issuing a process-form collective, as a
    ``collective.<op>`` span and counts (see the module's doc); nothing
    where the collective was ``captured``."""
    if captured:
        yield
        return
    with profiling.span("collective." + op, label=str(nbytes)):
        yield
    profiling.count("collective.calls")
    profiling.count("collective.bytes", nbytes)


def gather(parts: Sequence[torch.Tensor], axis, sizes=None) -> list:
    """Every shard's tensor, in shard order. One process: ``parts`` as
    they are. Process form: the D shards on this rank's device, through
    one ``all_gather``; ``sizes`` gives each shard's length along dim 0
    where they differ (the shards are padded to the longest and cut)."""
    if not isinstance(axis, RankAxis):
        return list(parts)
    (x,) = parts
    n = x.shape[0] if x.dim() else 1
    longest = max(sizes) if sizes is not None else n
    if x.dim() and longest > n:
        x = torch.cat([x, x.new_zeros((longest - n,) + x.shape[1:])])
    send = x.contiguous()
    if send.dtype == torch.bool:
        send = send.to(torch.uint8)
    out = [torch.empty_like(send) for _ in axis.ranks]
    captured = cudagraph.note_collective("all_gather", axis.group,
                                         axis.ranks, send)
    with _recorded("gather", send.nbytes * len(out), captured):
        _dist().all_gather(out, send, group=axis.group)
    group_rank = [_dist().get_group_rank(axis.group, r) for r in axis.ranks]
    got = [out[g].to(x.dtype) for g in group_rank]
    if sizes is not None:
        got = [g[:s] for g, s in zip(got, sizes)]
    return got


def psum(parts: Sequence[torch.Tensor], axis=None) -> list:
    """The sum over the axis, added in the fixed order shard 0, 1, ...,
    D - 1, so every shard holds the same bits. One process (``axis``
    None or a device list): added on shard 0's device and handed to every
    shard's device; shards on one device share one tensor, and one shard's
    sum is its own tensor. Process form: the shards gathered and added on
    each rank in the same order."""
    if isinstance(axis, RankAxis):
        got = gather(parts, axis)
        total = got[0]
        for p in got[1:]:
            total = total + p
        return [total]
    devs = _positions(parts, axis)
    there = iter(cudagraph.moves([(p, devs[0]) for p, d in
                                  zip(parts[1:], devs[1:]) if d != devs[0]]))
    total = parts[0]
    for p, d in zip(parts[1:], devs[1:]):
        total = total + (p if d == devs[0] else next(there))
    return broadcast(total, devs)


def broadcast(x: torch.Tensor, axis) -> list:
    """``x`` on each shard. One process (``axis`` a device list, ``x`` on
    shard 0's device): one copy per other distinct device. Process form:
    shard 0's ``x`` on this rank, sent from shard 0's rank."""
    if isinstance(axis, RankAxis):
        y = x.contiguous().clone()
        captured = cudagraph.note_collective("broadcast", axis.group,
                                             axis.ranks, y)
        with _recorded("broadcast", y.nbytes, captured):
            _dist().broadcast(y, src=axis.ranks[0], group=axis.group)
        return [y]
    devs = [torch.device(d) for d in axis]
    others = list(dict.fromkeys(d for d in devs if d != devs[0]))
    copies = dict(zip(others, cudagraph.moves([(x, d) for d in others])))
    copies[devs[0]] = x
    return [copies[d] for d in devs]


def ppermute(parts: Sequence[torch.Tensor], perm, axis=None) -> list:
    """Shard ``src``'s tensor moved to shard ``dst`` for every ``(src,
    dst)`` in ``perm``; a shard that receives nothing gets zeros of its own
    tensor's shape (``jax.lax.ppermute``'s rule). Process form: one
    ``batch_isend_irecv`` of this rank's sends and receives; a pair whose
    source is its destination is a send to itself on NCCL and a copy on
    gloo, whose pairs do not reach their own rank."""
    dsts = [dst for _, dst in perm]
    twice = sorted({d for d in dsts if dsts.count(d) > 1})
    if twice:
        raise ValueError(f"ppermute: shard {twice[0]} receives twice")
    if not isinstance(axis, RankAxis):
        devs = _positions(parts, axis)
        crossing = [(s, d) for s, d in perm if devs[s] != devs[d]]
        moved = dict(zip(crossing, cudagraph.moves(
            [(parts[s], devs[d]) for s, d in crossing])))
        out = [None] * len(parts)
        for src, dst in perm:
            out[dst] = moved.get((src, dst), parts[src])
        return [torch.zeros_like(p) if o is None else o
                for p, o in zip(parts, out)]
    (x,) = parts
    me = axis.index
    captured = cudagraph.note_collective("ppermute", axis.group,
                                         axis.ranks, x, perm)
    gloo = _dist().get_backend(axis.group) == "gloo"
    if gloo and (me, me) in perm:
        return [x.clone()]        # gloo's pairs do not reach their own rank
    host = gloo and x.device.type == "cuda"
    send = (x.cpu() if host else x).contiguous()
    recv = None
    ops = []
    for src, dst in perm:
        if src == me:
            ops.append(_dist().P2POp(_dist().isend, send, axis.ranks[dst],
                                     axis.group))
        if dst == me:
            recv = torch.empty_like(send)
            ops.append(_dist().P2POp(_dist().irecv, recv, axis.ranks[src],
                                     axis.group))
    if ops:
        with _recorded("ppermute", 0 if recv is None else recv.nbytes,
                       captured):
            for work in _dist().batch_isend_irecv(ops):
                work.wait()
    if recv is None:
        return [torch.zeros_like(x)]
    return [recv.to(x.device) if host else recv]


def _positions(parts, axis) -> list:
    """The device of each shard of a one-process ``axis`` (its parts' own
    devices where ``axis`` is None)."""
    return [torch.device(d) for d in
            (axis if axis is not None else [p.device for p in parts])]


def replicated(axis, fn: Callable, *args: Sequence) -> list:
    """``fn`` applied to replicated operands: ``args`` are per-shard lists
    whose shards hold the same values, such as a ``psum``'s output. One
    process (``axis`` a device list, shard k's on ``axis[k]``): ``fn``
    runs once per distinct device, on the first shard there, and the
    shards on that device share its result. Process form: once, on this
    rank's shard."""
    if isinstance(axis, RankAxis):
        return [fn(*(a[0] for a in args))]
    done = {}
    for k, d in enumerate(axis):
        if d not in done:
            done[d] = fn(*(a[k] for a in args))
    return [done[d] for d in axis]
