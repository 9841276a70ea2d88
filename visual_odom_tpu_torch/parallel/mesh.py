"""Device meshes and multi-process bring-up.

Port of ``visual_odom_tpu/parallel/mesh.py``. Axes follow the JAX
package's plan:

- "data": independent KITTI sequences / frame batches (DP),
- "model": feature-batch and BA-landmark sharding within a step (TP).

A mesh is a numpy array of positions with named axes (``Mesh``);
``mesh.shape[axis]`` reads as in JAX. A position takes one of two forms:

- a ``torch.device``: one process issues every position's work (the
  one-process form). One card may be named several times, and tests name
  the CPU.
- a ``Rank``: a rank of a ``torch.distributed`` process group and the
  device it drives (the process form). Each rank issues only its own
  position's work, and the collectives (``parallel.collectives``) move
  values between ranks. The form that is supported is one rank per
  position: a rank named twice raises.

Without ``devices`` a mesh takes ``visible_devices()``: inside a process
group (``initialize_distributed``) one position per rank, ordered by rank
as ``jax.devices()`` orders devices by process; outside one, every CUDA
device of this process. Either way it raises when there is no card: it
never falls back to the CPU.
``initialize_distributed`` forms the process group: NCCL on the card, gloo
when the caller names the CPU, and never the one in place of the other.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from visual_odom_tpu_torch import resolve_device
from visual_odom_tpu_torch.parallel.collectives import RankAxis


@dataclass(frozen=True)
class Rank:
    """A mesh position of the process form: a rank of the default process
    group and the device it drives."""

    rank: int
    device: torch.device


class Mesh:
    """Positions laid out on named axes (row-major over ``devices``)."""

    def __init__(self, devices: np.ndarray, axis_names: tuple):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self._axes = {}    # axis -> RankAxis of this rank (process form)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def ranks(self) -> Optional[np.ndarray]:
        """Each position's rank (the process form), else None."""
        if not isinstance(self.devices.flat[0], Rank):
            return None
        return np.vectorize(lambda p: p.rank, otypes=[int])(self.devices)


def axis_devices(mesh: Mesh, axis: str) -> list:
    """The positions along ``axis``, at index 0 of every other axis: the
    shards of a value split over ``axis`` and replicated over the rest."""
    k = mesh.axis_names.index(axis)
    index = [0] * mesh.devices.ndim
    index[k] = slice(None)
    return list(mesh.devices[tuple(index)])


def position(mesh: Mesh) -> tuple:
    """This rank's index in a mesh of ``Rank``s; raises when it holds no
    position."""
    me = torch.distributed.get_rank()
    where = np.argwhere(mesh.ranks == me)
    if not len(where):
        raise ValueError(f"rank {me} holds no position of the mesh "
                         f"{mesh.shape}")
    return tuple(int(i) for i in where[0])


def mesh_axis(mesh: Mesh, axis: str):
    """The axis a solver's collectives run over.

    One-process form: ``axis_devices(mesh, axis)``, the list of devices.
    Process form: a ``collectives.RankAxis`` for the line along ``axis``
    through this rank's position (its ranks, devices, this rank's shard and
    their process group). Creating the groups is collective: every rank of
    the default group calls ``torch.distributed.new_group`` for every line,
    in the same order, the first time any rank asks for the axis; the mesh
    keeps them."""
    if mesh.ranks is None:
        return axis_devices(mesh, axis)
    if axis not in mesh._axes:
        k = mesh.axis_names.index(axis)
        here = position(mesh)
        lines = np.moveaxis(mesh.devices, k, -1)
        world = list(range(torch.distributed.get_world_size()))
        for idx in np.ndindex(lines.shape[:-1]):
            ranks = tuple(p.rank for p in lines[idx])
            group = (torch.distributed.group.WORLD if sorted(ranks) == world
                     else torch.distributed.new_group(list(ranks)))
            if idx == here[:k] + here[k + 1:]:
                mesh._axes[axis] = RankAxis(
                    ranks=ranks, devices=tuple(p.device for p in lines[idx]),
                    index=here[k], group=group)
    return mesh._axes[axis]


def split_ranges(n: int, parts: int) -> list:
    """Contiguous (start, stop) ranges cutting ``n`` items into ``parts``,
    their sizes differing by at most one (the first ranges take the
    extra), as ``numpy.array_split`` cuts."""
    sizes = [len(a) for a in np.array_split(np.arange(n), parts)]
    stops = np.cumsum(sizes)
    return [(int(b - s), int(b)) for s, b in zip(sizes, stops)]


#: this process's device, set by ``initialize_distributed``
_LOCAL = {}


def _local_device() -> torch.device:
    """This rank's device: the one ``initialize_distributed`` bound, else
    the current card on NCCL and the CPU on gloo."""
    if "device" in _LOCAL:
        return _LOCAL["device"]
    if torch.distributed.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def local_devices() -> list:
    """Every CUDA device of this process; raises without a card."""
    resolve_device("cuda")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def visible_devices() -> list:
    """The positions a mesh takes by default. Inside a process group: one
    ``Rank`` per rank, ordered by rank, each with its rank's device (one
    all-gather: every rank calls this together); raises without a card
    unless the ranks drive the CPU. Outside one: ``local_devices()``."""
    dist = torch.distributed
    if not (dist.is_available() and dist.is_initialized()):
        return local_devices()
    dev = _local_device()
    code = torch.tensor([dev.type == "cuda",
                         -1 if dev.index is None else dev.index],
                        dtype=torch.int64,
                        device=dev if dist.get_backend() == "nccl" else "cpu")
    out = [torch.empty_like(code) for _ in range(dist.get_world_size())]
    dist.all_gather(out, code)
    ranks = [Rank(r, torch.device("cuda", i) if c else torch.device("cpu"))
             for r, (c, i) in enumerate(x.tolist() for x in out)]
    if any(p.device.type == "cuda" for p in ranks):
        resolve_device("cuda")
    return ranks


def _positions(devices: Sequence) -> list:
    """Explicit positions: ``Rank``s as given (each rank at most once), or
    devices through ``resolve_device``; the two forms do not mix."""
    devices = list(devices)
    ranks = [d for d in devices if isinstance(d, Rank)]
    if not ranks:
        return [resolve_device(d) for d in devices]
    if len(ranks) != len(devices):
        raise ValueError("a mesh takes devices or ranks, not both")
    seen = [p.rank for p in ranks]
    twice = sorted({r for r in seen if seen.count(r) > 1})
    if twice:
        raise ValueError(f"rank {twice[0]} would hold {seen.count(twice[0])} "
                         f"mesh positions: the process form runs one rank "
                         f"per position")
    return [Rank(p.rank, resolve_device(p.device)) for p in ranks]


def make_mesh(axis_sizes: dict[str, int],
              devices: Optional[Sequence] = None) -> Mesh:
    """Mesh with named axes of the given sizes (row-major over devices)."""
    devices = (_positions(devices) if devices is not None
               else visible_devices())
    total = int(np.prod(list(axis_sizes.values())))
    if total > len(devices):
        raise ValueError(
            f"mesh wants {total} devices, only {len(devices)} available"
        )
    arr = np.empty(total, dtype=object)
    for i, d in enumerate(devices[:total]):
        arr[i] = d
    return Mesh(arr.reshape(tuple(axis_sizes.values())),
                tuple(axis_sizes.keys()))


def data_model_mesh(n_devices: Optional[int] = None,
                    data: Optional[int] = None,
                    devices: Optional[Sequence] = None) -> Mesh:
    """Standard ("data", "model") mesh over ``devices`` (``visible_devices()``
    by default: every rank of a process group, else every CUDA device).
    Picks data = 2 when the device count is even, else 1, and gives the
    rest to "model". A ``data`` larger than the device count raises
    make_mesh's error (the JAX package returns an empty mesh there)."""
    devs = (_positions(devices) if devices is not None
            else visible_devices())
    n = n_devices or len(devs)
    if data is None:
        data = 2 if n % 2 == 0 and n >= 2 else 1
    model = max(1, n // data)
    return make_mesh({"data": data, "model": model}, devs[: data * model])


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device=None) -> None:
    """Multi-process bring-up: ``torch.distributed.init_process_group`` over
    NCCL for the card (the default) or gloo for ``device="cpu"``. With
    ``coordinator`` ("host:port"), ``num_processes`` and ``process_id`` the
    group meets at ``tcp://<coordinator>``; without them it reads
    ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK`` from the
    environment (``env://``).

    On the card the rank drives ``device`` (``cuda:<LOCAL_RANK>`` when it
    names no index, as ``torch.distributed.run`` sets it), and NCCL's
    communicator is bound to it at once, so a failed NCCL init raises here.
    Nothing switches to gloo on its own. The rank's device is its position
    in ``visible_devices()``."""
    import os

    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    kwargs = {}
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
        kwargs["device_id"] = dev
    if coordinator is not None:
        torch.distributed.init_process_group(
            backend, init_method=f"tcp://{coordinator}",
            world_size=num_processes, rank=process_id, **kwargs)
    else:
        torch.distributed.init_process_group(backend, init_method="env://",
                                             **kwargs)
    _LOCAL.clear()
    _LOCAL["device"] = dev
