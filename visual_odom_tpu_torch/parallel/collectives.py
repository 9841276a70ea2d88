"""Collectives over one mesh axis, issued from one process.

The JAX package runs its multi-device paths from one controller over a
``Mesh``, and XLA writes their collectives (``psum``, ``ppermute``) from
sharding constraints or ``shard_map``. Here the solvers name them: a
distributed value along a mesh axis of D devices is a list of D tensors,
shard k's on the axis' k-th device (``parallel.mesh.axis_devices``), and
each function below maps such a list to another.

- Between cards a shard moves by a device-to-device copy, which PyTorch
  orders on both cards' current streams: no collective waits on the host
  or copies through it.
- One card named several times (``[cuda:0] * 4``, how ``chip_smoke.py``
  drives a mesh on one card) and CPU devices (the tests) take the same
  code; a copy to the device a tensor is already on is no copy.
- Scalars stay tensors on their devices; a solver's guards are
  ``torch.where``s on them.

Every function takes the whole axis' list; a process-group form, one rank
per card with one shard each, would keep these names and take the local
shard and the group instead (``ROADMAP.md`` item 18c).
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch


def psum(parts: Sequence[torch.Tensor]) -> list:
    """The sum over the axis, added in the fixed order shard 0, 1, ...,
    D - 1 on shard 0's device and handed to every shard's device, so every
    shard holds the same bits. Shards on one device share one tensor; one
    shard's sum is its own tensor."""
    total = parts[0]
    for p in parts[1:]:
        total = total + p.to(total.device)
    return broadcast(total, [p.device for p in parts])


def broadcast(x: torch.Tensor, devices: Sequence[torch.device]) -> list:
    """``x`` on each of ``devices``: one copy per distinct device."""
    copies = {}
    for d in devices:
        if d not in copies:
            copies[d] = x.to(d)
    return [copies[d] for d in devices]


def ppermute(parts: Sequence[torch.Tensor], perm) -> list:
    """Shard ``src``'s tensor moved to shard ``dst``'s device for every
    ``(src, dst)`` in ``perm``; a shard that receives nothing gets zeros of
    its own tensor's shape (``jax.lax.ppermute``'s rule)."""
    out = [None] * len(parts)
    for src, dst in perm:
        if out[dst] is not None:
            raise ValueError(f"ppermute: shard {dst} receives twice")
        out[dst] = parts[src].to(parts[dst].device)
    return [torch.zeros_like(p) if o is None else o
            for p, o in zip(parts, out)]


def replicated(devices: Sequence[torch.device], fn: Callable,
               *args: Sequence) -> list:
    """``fn`` applied to replicated operands: ``args`` are per-shard lists
    (shard k's on ``devices[k]``) whose shards hold the same values, such as
    a ``psum``'s output. ``fn`` runs once per distinct device, on the first
    shard there; the shards on that device share its result."""
    done = {}
    for k, d in enumerate(devices):
        if d not in done:
            done[d] = fn(*(a[k] for a in args))
    return [done[d] for d in devices]
