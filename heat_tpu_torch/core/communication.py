"""Communication over a list of torch devices (reference:
heat/core/communication.py:88-1891, heat_tpu/core/communication.py).

One Python process drives every device, as in the JAX package: a
:class:`MeshCommunication` holds a list of p torch devices, a distributed
array holds one shard per device, and the collectives are in-process torch
operations over the shard list, combined in a fixed shard order so that a
result does not depend on timing. On the GPU the default mesh is every
visible CUDA device; on the CPU it is ``HEAT_TPU_TEST_DEVICES`` copies of the
CPU device (default 8), the same mesh size the JAX package's tests use.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import devices as devices_module

__all__ = [
    "Communication",
    "MeshCommunication",
    "get_comm",
    "sanitize_comm",
    "use_comm",
]


class Communication:
    """Base class for communication contexts (reference communication.py:88-101)."""

    @staticmethod
    def is_distributed() -> bool:
        raise NotImplementedError()

    def chunk(self, shape, split, rank=None):
        raise NotImplementedError()


class MeshCommunication(Communication):
    """A communication context over a list of torch devices.

    Parameters
    ----------
    devices : sequence of torch.device
        One entry per shard, all of one device type. A device may repeat
        (p shards on the one CPU).
    """

    def __init__(self, devices: Sequence[torch.device]):
        devices = [torch.device(d) for d in devices]
        if not devices:
            raise ValueError("a mesh needs at least one device")
        if len({d.type for d in devices}) != 1:
            raise ValueError(f"a mesh holds devices of one type, got {devices}")
        self._devices = tuple(devices)
        self.rank = 0

    @property
    def size(self) -> int:
        """Parallelism degree: the number of shards along the split axis."""
        return len(self._devices)

    @property
    def devices(self) -> Tuple[torch.device, ...]:
        return self._devices

    @property
    def device_type(self) -> str:
        """``"cpu"`` or ``"gpu"``, the :class:`~.devices.Device` kind of the mesh."""
        return "gpu" if self._devices[0].type == "cuda" else "cpu"

    def is_distributed(self) -> bool:
        return self.size > 1

    # ------------------------------------------------------------------
    # block-distribution arithmetic (reference communication.py:161-209)
    # ------------------------------------------------------------------
    def counts_displs_shape(
        self, shape: Sequence[int], split: int
    ) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
        """Per-shard counts and displacements along ``split`` under the
        ceil-division block rule of the pad+mask layout."""
        n = int(shape[split])
        p = self.size
        block = -(-n // p) if n else 0
        counts = tuple(max(0, min(block, n - i * block)) for i in range(p))
        displs = tuple(min(i * block, n) for i in range(p))
        return counts, displs

    def chunk(
        self, shape: Sequence[int], split: Optional[int], rank: Optional[int] = None
    ) -> Tuple[int, Tuple[int, ...], Tuple[slice, ...]]:
        """Offset, logical local shape and slices of shard ``rank``; the full
        array for ``split=None``."""
        shape = tuple(int(s) for s in shape)
        if split is None:
            return 0, shape, tuple(slice(0, s) for s in shape)
        rank = 0 if rank is None else rank
        counts, displs = self.counts_displs_shape(shape, split)
        start, count = displs[rank], counts[rank]
        lshape = list(shape)
        lshape[split] = count
        slices = [slice(0, s) for s in shape]
        slices[split] = slice(start, start + count)
        return start, tuple(lshape), tuple(slices)

    def lshape_map(self, shape: Sequence[int], split: Optional[int]) -> np.ndarray:
        """(size, ndim) array of each shard's logical shape."""
        out = np.empty((self.size, len(shape)), dtype=np.int64)
        for r in range(self.size):
            out[r] = self.chunk(shape, split, rank=r)[1]
        return out

    # ------------------------------------------------------------------
    # collectives over the shard list
    # ------------------------------------------------------------------
    def allreduce(self, shards: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Sum one tensor per shard, in shard order, and give every shard the
        result on its own device (reference Allreduce)."""
        self._check(shards)
        total = shards[0]
        for s in shards[1:]:
            total = total + s.to(total.device)
        return [total if total.device == d else total.to(d) for d in self._devices]

    def allgather(self, shards: Sequence[torch.Tensor], dim: int = 0) -> List[torch.Tensor]:
        """Concatenate one tensor per shard along ``dim`` and give every shard
        the result on its own device (reference Allgather(v))."""
        self._check(shards)
        first = self._devices[0]
        whole = torch.cat([s.to(first) for s in shards], dim=dim)
        return [whole if whole.device == d else whole.to(d) for d in self._devices]

    def _check(self, shards: Sequence[torch.Tensor]) -> None:
        if len(shards) != self.size:
            raise ValueError(f"expected {self.size} shards, got {len(shards)}")

    def __repr__(self) -> str:
        return f"MeshCommunication({self.size} {self._devices[0].type} device(s))"


def _cpu_mesh_size() -> int:
    return int(os.environ.get("HEAT_TPU_TEST_DEVICES", "8"))


_WORLDS: Dict[str, MeshCommunication] = {}
__default_comm: Optional[MeshCommunication] = None


def _world(device_type: str) -> MeshCommunication:
    """The default mesh of a device kind: every CUDA device, or the CPU
    repeated ``HEAT_TPU_TEST_DEVICES`` times."""
    comm = _WORLDS.get(device_type)
    if comm is None:
        torch_devices = devices_module.sanitize_device(device_type).torch_devices()
        if device_type == "cpu":
            torch_devices = torch_devices * _cpu_mesh_size()
        comm = _WORLDS[device_type] = MeshCommunication(torch_devices)
    return comm


def get_comm() -> MeshCommunication:
    """The current default communication context (reference
    communication.py:1919-1925): the one set by :func:`use_comm`, else the
    default mesh of the default device."""
    if __default_comm is not None:
        return __default_comm
    return _world(devices_module.get_device().device_type)


def sanitize_comm(
    comm: Optional[Communication], device: Optional[devices_module.Device] = None
) -> MeshCommunication:
    """Validate a communication context, or pick the default one for
    ``device`` (reference communication.py:1900)."""
    if comm is None:
        if device is None:
            return get_comm()
        if __default_comm is not None and __default_comm.device_type == device.device_type:
            return __default_comm
        return _world(device.device_type)
    if isinstance(comm, MeshCommunication):
        if device is not None and comm.device_type != device.device_type:
            raise ValueError(f"device {device} does not match the mesh {comm}")
        return comm
    raise TypeError(f"Given communication object is not valid: {comm!r}")


def use_comm(comm: Optional[Communication] = None) -> None:
    """Set the default communication context (reference
    communication.py:1927-1937); ``None`` returns to the default mesh of the
    default device."""
    global __default_comm
    __default_comm = None if comm is None else sanitize_comm(comm)
