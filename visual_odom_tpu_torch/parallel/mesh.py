"""Device meshes and multi-process bring-up.

Port of ``visual_odom_tpu/parallel/mesh.py``. Axes follow the JAX
package's plan:

- "data": independent KITTI sequences / frame batches (DP),
- "model": feature-batch and BA-landmark sharding within a step (TP).

A mesh here is a numpy array of ``torch.device``s with named axes
(``Mesh``); ``mesh.shape[axis]`` reads as in JAX. Without ``devices`` a
mesh takes every visible CUDA device and raises when there is no card: it
never falls back to the CPU. Tests pass CPU devices explicitly.
``initialize_distributed`` forms a ``torch.distributed`` process group:
NCCL on the card, gloo when the caller names the CPU.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from visual_odom_tpu_torch import resolve_device


class Mesh:
    """Devices laid out on named axes (row-major over ``devices``)."""

    def __init__(self, devices: np.ndarray, axis_names: tuple):
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)


def axis_devices(mesh: Mesh, axis: str) -> list:
    """The devices along ``axis``, at index 0 of every other axis: the
    shards of a value split over ``axis`` and replicated over the rest."""
    k = mesh.axis_names.index(axis)
    index = [0] * mesh.devices.ndim
    index[k] = slice(None)
    return list(mesh.devices[tuple(index)])


def split_ranges(n: int, parts: int) -> list:
    """Contiguous (start, stop) ranges cutting ``n`` items into ``parts``,
    their sizes differing by at most one (the first ranges take the
    extra), as ``numpy.array_split`` cuts."""
    sizes = [len(a) for a in np.array_split(np.arange(n), parts)]
    stops = np.cumsum(sizes)
    return [(int(b - s), int(b)) for s, b in zip(sizes, stops)]


def visible_devices() -> list:
    """Every visible CUDA device; raises without a card."""
    resolve_device("cuda")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(axis_sizes: dict[str, int],
              devices: Optional[Sequence] = None) -> Mesh:
    """Mesh with named axes of the given sizes (row-major over devices)."""
    devices = ([resolve_device(d) for d in devices] if devices is not None
               else visible_devices())
    total = int(np.prod(list(axis_sizes.values())))
    if total > len(devices):
        raise ValueError(
            f"mesh wants {total} devices, only {len(devices)} available"
        )
    arr = np.empty(total, dtype=object)
    arr[:] = devices[:total]
    return Mesh(arr.reshape(tuple(axis_sizes.values())),
                tuple(axis_sizes.keys()))


def data_model_mesh(n_devices: Optional[int] = None,
                    data: Optional[int] = None,
                    devices: Optional[Sequence] = None) -> Mesh:
    """Standard ("data", "model") mesh over ``devices`` (every visible CUDA
    device by default). Picks data = 2 when the device count is even, else
    1, and gives the rest to "model". A ``data`` larger than the device
    count raises make_mesh's error (the JAX package returns an empty mesh
    there)."""
    devs = ([resolve_device(d) for d in devices] if devices is not None
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
    environment (``env://``)."""
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    if coordinator is not None:
        torch.distributed.init_process_group(
            backend, init_method=f"tcp://{coordinator}",
            world_size=num_processes, rank=process_id)
    else:
        torch.distributed.init_process_group(backend, init_method="env://")
