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

    gnumel = size

    @property
    def nbytes(self) -> int:
        """Bytes of the logical array."""
        return self.size * self.__shards[0].element_size()

    @property
    def lshape(self) -> Tuple[int, ...]:
        """Logical shape of the first shard (reference dndarray.py:404)."""
        return self.__comm.chunk(self.__gshape, self.__split, rank=0)[1]

    @property
    def T(self) -> "DNDarray":
        """The transpose, axes reversed."""
        from .linalg import basics

        return basics.transpose(self, None)

    @property
    def real(self) -> "DNDarray":
        from . import complex_math

        return complex_math.real(self)

    @property
    def imag(self) -> "DNDarray":
        from . import complex_math

        return complex_math.imag(self)

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

    def _replace(self, shards: Sequence[torch.Tensor], gshape: Tuple[int, ...], split: Optional[int]) -> "DNDarray":
        """Swap the shards and their layout (the engines' ``out=`` path);
        the dtype follows the new shards."""
        if len(shards) != self.__comm.size:
            raise ValueError(f"expected {self.__comm.size} shards, got {len(shards)}")
        self.__shards = list(shards)
        self.__gshape = tuple(int(s) for s in gshape)
        self.__split = split
        self.__dtype = types.canonical_heat_type(shards[0].dtype)
        return self

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

    def __array__(self, dtype=None, copy=None) -> np.ndarray:
        out = self.numpy()
        return out.astype(dtype) if dtype is not None else out

    def item(self):
        """The single scalar value (reference dndarray.py:965)."""
        if self.size != 1:
            raise ValueError("only one-element DNDarrays can be converted to Python scalars")
        return self.larray.item()

    def tolist(self) -> list:
        return self.numpy().tolist()

    def __bool__(self) -> bool:
        return bool(self.item())

    def __int__(self) -> int:
        return int(self.item())

    def __float__(self) -> float:
        return float(self.item())

    def __complex__(self) -> complex:
        return complex(self.item())

    def __index__(self) -> int:
        if not types.heat_type_is_exact(self.__dtype):
            raise TypeError("only integer DNDarrays can be converted to an index")
        return int(self.item())

    def __len__(self) -> int:
        if self.ndim == 0:
            raise TypeError("len() of unsized object")
        return self.__gshape[0]

    # ------------------------------------------------------------------
    # operators: the operator library bound as methods (reference
    # dndarray.py:930-1080)
    # ------------------------------------------------------------------
    def __add__(self, other):
        return arithmetics.add(self, other)

    def __radd__(self, other):
        return arithmetics.add(other, self)

    def __sub__(self, other):
        return arithmetics.sub(self, other)

    def __rsub__(self, other):
        return arithmetics.sub(other, self)

    def __mul__(self, other):
        return arithmetics.mul(self, other)

    def __rmul__(self, other):
        return arithmetics.mul(other, self)

    def __truediv__(self, other):
        return arithmetics.div(self, other)

    def __rtruediv__(self, other):
        return arithmetics.div(other, self)

    def __floordiv__(self, other):
        return arithmetics.floordiv(self, other)

    def __rfloordiv__(self, other):
        return arithmetics.floordiv(other, self)

    def __mod__(self, other):
        return arithmetics.mod(self, other)

    def __rmod__(self, other):
        return arithmetics.mod(other, self)

    def __pow__(self, other):
        return arithmetics.pow(self, other)

    def __rpow__(self, other):
        return arithmetics.pow(other, self)

    def __matmul__(self, other):
        from .linalg import basics

        return basics.matmul(self, other)

    def __rmatmul__(self, other):
        from . import factories
        from .linalg import basics

        return basics.matmul(factories.array(other, device=self.__device, comm=self.__comm), self)

    def __and__(self, other):
        return arithmetics.bitwise_and(self, other)

    def __or__(self, other):
        return arithmetics.bitwise_or(self, other)

    def __xor__(self, other):
        return arithmetics.bitwise_xor(self, other)

    def __lshift__(self, other):
        return arithmetics.left_shift(self, other)

    def __rshift__(self, other):
        return arithmetics.right_shift(self, other)

    def __invert__(self):
        return arithmetics.invert(self)

    def __neg__(self):
        return arithmetics.neg(self)

    def __pos__(self):
        return arithmetics.pos(self)

    def __abs__(self):
        return rounding.abs(self)

    def __eq__(self, other):  # type: ignore[override]
        return relational.eq(self, other)

    def __ne__(self, other):  # type: ignore[override]
        return relational.ne(self, other)

    def __lt__(self, other):
        return relational.lt(self, other)

    def __le__(self, other):
        return relational.le(self, other)

    def __gt__(self, other):
        return relational.gt(self, other)

    def __ge__(self, other):
        return relational.ge(self, other)

    __hash__ = None  # type: ignore[assignment]

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


# the operator library, bound above as methods; imported last because it
# imports this module
from . import arithmetics, relational, rounding  # noqa: E402
