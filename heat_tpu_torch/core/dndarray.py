"""DNDarray — the distributed n-dimensional array (reference:
heat/core/dndarray.py, heat_tpu/core/dndarray.py).

A DNDarray holds one torch tensor per device of its
:class:`~heat_tpu_torch.core.communication.MeshCommunication`, in the pad+mask
layout of the JAX package (heat_tpu/core/dndarray.py:116-132): along the
``split`` axis every shard has ``ceil(n/p)`` rows, and the rows past the
global size ``n`` are padding, a suffix of the global axis. The padding's
content is unspecified; consumers that read the physical shards mask it.
A replicated array (``split=None``) holds the whole array on every device.

* ``parray`` is the physical global tensor (shards concatenated, padding
  included); with one shard it is that shard, without a copy.
* ``larray`` is the logical global tensor: ``parray`` without the padding.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import types
from .communication import MeshCommunication
from .stride_tricks import sanitize_axis

__all__ = ["DNDarray"]


class DNDarray:
    """Distributed n-dimensional array: one physical shard per mesh device.

    Parameters
    ----------
    shards : sequence of torch.Tensor
        The physical shards, one per device of ``comm``, in device order.
    gshape : tuple of int
        The logical global shape.
    dtype : heat type class
    split : int or None
        The distribution axis, or None for replicated.
    device : heat_tpu_torch.core.devices.Device
    comm : MeshCommunication
    """

    def __init__(
        self,
        shards: Sequence[torch.Tensor],
        gshape: Tuple[int, ...],
        dtype,
        split: Optional[int],
        device,
        comm: MeshCommunication,
    ):
        if len(shards) != comm.size:
            raise ValueError(f"expected {comm.size} shards, got {len(shards)}")
        self.__shards = list(shards)
        self.__gshape = tuple(int(s) for s in gshape)
        self.__dtype = dtype
        self.__split = split
        self.__device = device
        self.__comm = comm

    # ------------------------------------------------------------------
    # basic properties
    # ------------------------------------------------------------------
    @property
    def comm(self) -> MeshCommunication:
        return self.__comm

    @property
    def device(self):
        return self.__device

    @property
    def dtype(self):
        return self.__dtype

    @property
    def gshape(self) -> Tuple[int, ...]:
        return self.__gshape

    shape = gshape

    @property
    def ndim(self) -> int:
        return len(self.__gshape)

    @property
    def size(self) -> int:
        return int(np.prod(self.__gshape, dtype=np.int64)) if self.__gshape else 1

    @property
    def split(self) -> Optional[int]:
        return self.__split

    @property
    def shards(self) -> List[torch.Tensor]:
        """The physical shards, one per mesh device, padding included."""
        return list(self.__shards)

    @property
    def padded(self) -> bool:
        """True when the shards carry suffix padding along the split axis."""
        s = self.__split
        return s is not None and self.__shards[0].shape[s] * self.__comm.size != self.__gshape[s]

    @property
    def parray(self) -> torch.Tensor:
        """The physical global tensor, on the first mesh device: the shards
        concatenated along ``split``, padding included."""
        if self.__split is None or len(self.__shards) == 1:
            return self.__shards[0]
        first = self.__comm.devices[0]
        return torch.cat([s.to(first) for s in self.__shards], dim=self.__split)

    @property
    def larray(self) -> torch.Tensor:
        """The logical global tensor: :attr:`parray` without the padding."""
        arr = self.parray
        if self.padded:
            arr = arr.narrow(self.__split, 0, self.__gshape[self.__split])
        return arr

    @property
    def lshards(self) -> List[torch.Tensor]:
        """Per-device logical shards: each physical shard without its padding."""
        if self.__split is None:
            return self.shards
        counts, _ = self.counts_displs()
        return [s.narrow(self.__split, 0, c) for s, c in zip(self.__shards, counts)]

    @property
    def lshape_map(self) -> "DNDarray":
        """(n_devices, ndim) map of the logical shard shapes (reference
        dndarray.py:569-600)."""
        from . import factories

        lmap = self.__comm.lshape_map(self.__gshape, self.__split)
        return factories.array(lmap, dtype=types.int64, device=self.__device, comm=self.__comm)

    def is_distributed(self) -> bool:
        """True if data lives on more than one device (reference dndarray.py:957)."""
        return self.__split is not None and self.__comm.is_distributed()

    def counts_displs(self) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
        """Counts/displacements along the split axis (reference dndarray.py:543)."""
        if self.__split is None:
            raise ValueError("Non-distributed DNDarray has no counts and displacements")
        return self.__comm.counts_displs_shape(self.__gshape, self.__split)

    # ------------------------------------------------------------------
    # distribution and conversion
    # ------------------------------------------------------------------
    def resplit_(self, axis: Optional[int] = None) -> "DNDarray":
        """Redistribute in place to a new split axis (reference
        dndarray.py:1235-1357)."""
        axis = sanitize_axis(self.__gshape, axis)
        if axis == self.__split:
            return self
        self.__shards = _distribute(self.larray, axis, self.__comm)
        self.__split = axis
        return self

    def astype(self, dtype, copy: bool = True) -> "DNDarray":
        """Cast to a new element type (reference dndarray.py:443-468)."""
        dtype = types.canonical_heat_type(dtype)
        shards = [s.to(dtype.torch_type()) for s in self.__shards]
        if copy:
            return DNDarray(shards, self.__gshape, dtype, self.__split, self.__device, self.__comm)
        self.__shards = shards
        self.__dtype = dtype
        return self

    def numpy(self) -> np.ndarray:
        """The logical array as a host numpy array (reference
        dndarray.py:991-1003); bfloat16, which numpy lacks, comes back as
        float32."""
        arr = self.larray.detach()
        if arr.dtype == torch.bfloat16:
            arr = arr.float()
        return arr.cpu().numpy()

    def item(self):
        """The single scalar value (reference dndarray.py:965)."""
        if self.size != 1:
            raise ValueError("only one-element DNDarrays can be converted to Python scalars")
        return self.larray.item()

    def __repr__(self) -> str:
        body = np.array2string(self.numpy(), separator=", ", threshold=1000)
        return (
            f"DNDarray({body}, dtype=ht.{self.__dtype.__name__}, "
            f"device={self.__device}, split={self.__split})"
        )

    __str__ = __repr__


def _distribute(array: torch.Tensor, split: Optional[int], comm: MeshCommunication) -> List[torch.Tensor]:
    """Cut a logical global tensor into the pad+mask shards of ``comm``: along
    ``split``, ``ceil(n/p)`` rows per shard, the last ones zero-padded; the
    whole tensor on every device for ``split=None``. A single shard on the
    tensor's own device is the tensor itself, not a copy."""
    devices = comm.devices
    if split is None or array.ndim == 0:
        return [array.to(d) for d in devices]
    n = array.shape[split]
    p = comm.size
    block = -(-n // p) if n else 0
    if block * p != n:
        pad_shape = list(array.shape)
        pad_shape[split] = block * p - n
        array = torch.cat([array, array.new_zeros(pad_shape)], dim=split)
    if p == 1:
        return [array.to(devices[0])]
    return [
        array.narrow(split, i * block, block).to(d).contiguous() for i, d in enumerate(devices)
    ]


def _wrap(array: torch.Tensor, split: Optional[int], device, comm: MeshCommunication) -> DNDarray:
    """Distribute a logical global tensor and wrap it."""
    split = split if array.ndim else None
    return DNDarray(
        _distribute(array, split, comm),
        tuple(array.shape),
        types.canonical_heat_type(array.dtype),
        split,
        device,
        comm,
    )
