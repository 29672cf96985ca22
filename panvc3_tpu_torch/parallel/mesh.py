"""Multi-device execution: data-parallel record batches over a device mesh.

Counterpart of ``panvc3_tpu.parallel.mesh``.  The scaling design is the
JAX package's:

- the record batch dimension is sharded over the ``dp`` axis of a mesh;
- the MSA gap index, the device event tables and the flat reference are
  replicated (read-only gather targets), one copy per device;
- each shard runs the per-record work on its own device.

PyTorch has no SPMD partitioner, so the port cuts the batch by hand: a
``Mesh`` is an ordered tuple of devices, one per shard, and a device may
repeat (several shards on one card, or ``[cpu] * 8`` in the tests, run
the shard, pad and gather code for real on one device).  A mesh may span
processes (``Mesh.across_processes``): each process then holds the
shards ``local_shards`` of the ``size`` in all.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device


@dataclass(frozen=True)
class Mesh:
    """``devices``: this process's shards' devices in shard order (a
    device may repeat); ``process_index`` of ``process_count`` processes,
    each holding as many shards, in process order."""

    devices: tuple
    axis: str = "dp"
    process_index: int = 0
    process_count: int = 1

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        # a CUDA entry gets its index (and raises without a card), so that
        # equal devices compare equal and share one replica
        devices = tuple(torch.device(d) for d in self.devices)
        object.__setattr__(self, "devices", tuple(
            resolve_device(d) if d.type == "cuda" else d for d in devices
        ))

    @classmethod
    def across_processes(cls, devices) -> "Mesh":
        """This process's ``devices`` as its part of a mesh over every
        process of ``torch.distributed``'s default group (which must be
        initialised: ``distributed.initialise``)."""
        import torch.distributed as dist

        return cls(tuple(devices), process_index=dist.get_rank(),
                   process_count=dist.get_world_size())

    @property
    def size(self) -> int:
        """Shards in the whole mesh (every process's)."""
        return len(self.devices) * self.process_count

    @property
    def local_shards(self) -> range:
        """Global indexes of this process's shards."""
        first = self.process_index * len(self.devices)
        return range(first, first + len(self.devices))

    @property
    def unique_devices(self) -> tuple:
        """``devices`` without repeats, in first-use order."""
        return tuple(dict.fromkeys(self.devices))


def make_mesh(n_devices: int | None = None, device="cuda") -> Mesh:
    """A mesh of the first ``n_devices`` devices of ``device`` (all of them
    when None): the visible cards for ``cuda``, the one CPU for ``cpu``, or
    the entries of an explicit list of devices, repeats kept.  A count
    above what is there gives all of it, as JAX's ``devices[:n]`` does.
    Raises where ``resolve_device`` would."""
    if isinstance(device, (list, tuple)):
        visible = [resolve_device(d) for d in device]
    else:
        kind = resolve_device(device).type
        if kind == "cuda":
            visible = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        else:
            visible = [torch.device("cpu")]
    if n_devices is not None:
        visible = visible[:n_devices]
    return Mesh(tuple(visible))


def _to(x, device: torch.device):
    if isinstance(x, (np.ndarray, np.generic)):
        x = torch.from_numpy(np.require(np.asarray(x), requirements=["C", "W"]))
    return x.to(device)


def shard_batch_arrays(mesh: Mesh, arrays: dict) -> dict:
    """Each array (tensor or numpy) as a list of this process's shards,
    one per mesh device: an array whose leading (batch) dimension has at
    least ``mesh.size`` rows is cut into ``mesh.size`` contiguous row
    blocks of equal size (it must divide), each on its shard's device;
    smaller arrays and scalars are replicated (JAX's rule)."""
    out = {}
    for name, arr in arrays.items():
        t = arr if isinstance(arr, torch.Tensor) else _to(arr, torch.device("cpu"))
        if t.ndim >= 1 and t.shape[0] >= mesh.size:
            if t.shape[0] % mesh.size:
                raise ValueError(
                    f"{name}: {t.shape[0]} rows do not divide over {mesh.size} shards"
                )
            rows = t.shape[0] // mesh.size
            out[name] = [
                t[g * rows:(g + 1) * rows].to(dev)
                for g, dev in zip(mesh.local_shards, mesh.devices)
            ]
        else:
            out[name] = list(replicate(mesh, t))
    return out


def replicate(mesh: Mesh, tree) -> tuple:
    """One copy of ``tree`` per shard, made once per unique device (shards
    on one device share it): a tensor, a numpy array, or an object with
    a ``to(device)`` method such as ``DeviceGapIndex`` or
    ``DeviceEventGeometry``.  A copy already on a device is not copied."""
    copies = {dev: _to(tree, dev) for dev in mesh.unique_devices}
    return tuple(copies[dev] for dev in mesh.devices)
