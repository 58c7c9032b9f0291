"""Array creation routines (reference: heat/core/factories.py,
heat_tpu/core/factories.py).

Every factory builds the logical global tensor on the mesh's ``home`` device
(its first; this process's first over a mesh whose ranks span processes)
and cuts it into the pad+mask shards (:func:`.dndarray._distribute`), which
keeps this process's ranks' blocks only. Across processes this is the
multi-controller rule: every process passes the same host value. The device
defaults to the GPU; without CUDA that raises ``RuntimeError`` unless the
caller asks for the CPU.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from . import devices, types
from .communication import Communication, sanitize_comm
from .dndarray import DNDarray, _wrap
from .stride_tricks import sanitize_axis, sanitize_shape

__all__ = [
    "arange",
    "array",
    "asarray",
    "empty",
    "empty_like",
    "eye",
    "full",
    "from_partitioned",
    "full_like",
    "linspace",
    "logspace",
    "meshgrid",
    "ones",
    "ones_like",
    "zeros",
    "zeros_like",
]


def _resolve(device, comm: Optional[Communication]):
    """The (Device, MeshCommunication) pair of a factory call: an explicit
    ``comm`` names the device when ``device`` is not given."""
    if device is None and comm is not None:
        comm = sanitize_comm(comm)
        return devices.sanitize_device(comm.device_type), comm
    device = devices.sanitize_device(device)
    return device, sanitize_comm(comm, device)


def array(
    obj,
    dtype=None,
    copy: Optional[bool] = True,
    ndmin: int = 0,
    order: str = "C",
    split: Optional[int] = None,
    is_split: Optional[int] = None,
    device=None,
    comm: Optional[Communication] = None,
) -> DNDarray:
    """Create a DNDarray from a DNDarray, tensor, numpy array or nested
    sequence (reference factories.py:150-431). With one controller the local
    data is the global array, so ``is_split`` behaves like ``split``. The
    shards are C-contiguous tensors whatever ``order`` says; it is passed to
    ``np.asarray`` for other inputs, as the reference does."""
    if split is not None and is_split is not None:
        raise ValueError("split and is_split are mutually exclusive parameters")
    if is_split is not None:
        split = is_split
    tdtype = types.canonical_heat_type(dtype).torch_type() if dtype is not None else None
    if isinstance(obj, DNDarray):
        if dtype is None and split == obj.split and copy is not True:
            return obj
        if device is None and comm is None:
            device, comm = obj.device, obj.comm
        if split is None:
            split = obj.split
        obj = obj.larray
    device, comm = _resolve(device, comm)
    target = comm.home
    if isinstance(obj, torch.Tensor):
        t = obj.to(device=target, dtype=tdtype)
        if copy and t.data_ptr() == obj.data_ptr():
            t = t.clone()
    else:
        try:
            nparr = np.asarray(obj, order=order)
        except ValueError as e:
            raise ValueError(f"invalid data: {e}")
        if not nparr.flags.writeable:
            nparr = nparr.copy()  # torch tensors are writable
        if nparr.dtype == object:
            raise TypeError("invalid data of type object")
        if tdtype is None and nparr.dtype == np.float64 and not isinstance(obj, np.ndarray):
            # python floats default to float32 (reference factories.py:334-340)
            nparr = nparr.astype(np.float32)
        source = torch.as_tensor(nparr)
        t = source.to(device=target, dtype=tdtype)
        if copy and t.data_ptr() == source.data_ptr():
            t = t.clone()  # the numpy array's memory stays its own
    while t.ndim < ndmin:
        t = t[None]
    split = sanitize_axis(t.shape, split) if split is not None else None
    return _wrap(t, split, device, comm)


def asarray(obj, dtype=None, copy=None, order="C", is_split=None, device=None, comm=None) -> DNDarray:
    """Convert input to a DNDarray without copying where possible
    (reference factories.py:520)."""
    return array(obj, dtype=dtype, copy=copy, order=order, is_split=is_split, device=device, comm=comm)


def _factory(shape, dtype, split, fill, device, comm) -> DNDarray:
    shape = sanitize_shape(shape)
    dtype = types.canonical_heat_type(dtype)
    split = sanitize_axis(shape, split)
    device, comm = _resolve(device, comm)
    t = fill(shape, dtype=dtype.torch_type(), device=comm.home)
    return _wrap(t, split if shape else None, device, comm)


def empty(shape, dtype=types.float32, split=None, device=None, comm=None, order="C") -> DNDarray:
    """Uninitialized array (reference factories.py:558). ``order`` is
    accepted as the reference accepts it: the shards are C-contiguous."""
    return _factory(shape, dtype, split, torch.empty, device, comm)


def zeros(shape, dtype=types.float32, split=None, device=None, comm=None, order="C") -> DNDarray:
    """Array of zeros (reference factories.py:1244)."""
    return _factory(shape, dtype, split, torch.zeros, device, comm)


def ones(shape, dtype=types.float32, split=None, device=None, comm=None, order="C") -> DNDarray:
    """Array of ones (reference factories.py:1072)."""
    return _factory(shape, dtype, split, torch.ones, device, comm)


def full(shape, fill_value, dtype=None, split=None, device=None, comm=None, order="C") -> DNDarray:
    """Constant-filled array (reference factories.py:820); an integer fill
    value gives float32, as in the reference. An array fill value (a numpy
    array or a DNDarray) is broadcast to ``shape``, as numpy does."""
    if dtype is None:
        dtype = types.heat_type_of(fill_value)
        if isinstance(fill_value, (int, np.integer)):
            dtype = types.float32
    if isinstance(fill_value, DNDarray):
        fill_value = fill_value.numpy()

    def fill(shape, dtype, device):
        if isinstance(fill_value, np.ndarray):
            value = torch.as_tensor(fill_value).to(device=device, dtype=dtype)
            return value.broadcast_to(shape).clone()
        return torch.full(shape, fill_value, dtype=dtype, device=device)

    return _factory(shape, dtype, split, fill, device, comm)


def arange(*args, dtype=None, split=None, device=None, comm=None) -> DNDarray:
    """Evenly spaced values in [start, stop) (reference factories.py:40-138)."""
    if len(args) == 1:
        start, stop, step = 0, args[0], 1
    elif len(args) == 2:
        start, stop, step = args[0], args[1], 1
    elif len(args) == 3:
        start, stop, step = args
    else:
        raise TypeError(
            f"function takes minimum one and at most 3 positional arguments ({len(args)} given)"
        )
    if dtype is None:
        exact = all(isinstance(a, (int, np.integer)) for a in (start, stop, step))
        dtype = types.int32 if exact else types.float32
    dtype = types.canonical_heat_type(dtype)
    device, comm = _resolve(device, comm)
    t = torch.arange(start, stop, step, dtype=dtype.torch_type(), device=comm.home)
    split = sanitize_axis(t.shape, split) if split is not None else None
    return _wrap(t, split, device, comm)


def eye(shape, dtype=types.float32, split=None, device=None, comm=None, order="C") -> DNDarray:
    """2-D array with ones on the diagonal (reference factories.py:735): an
    int gives (n, n), a pair (n, m)."""
    if isinstance(shape, (int, np.integer)):
        n = m = int(shape)
    else:
        shape = sanitize_shape(shape)
        n, m = (shape[0], shape[0]) if len(shape) == 1 else (shape[0], shape[1])
    dtype = types.canonical_heat_type(dtype)
    device, comm = _resolve(device, comm)
    t = torch.eye(n, m, dtype=dtype.torch_type(), device=comm.home)
    split = sanitize_axis((n, m), split) if split is not None else None
    return _wrap(t, split, device, comm)


def _factory_like(a, dtype, split, factory, device, comm, **kwargs) -> DNDarray:
    """``factory`` at the shape of ``a``, taking the dtype, split, device
    and mesh of ``a`` where not given (reference factories.py:179)."""
    shape = a.shape if hasattr(a, "shape") else np.asarray(a).shape
    if dtype is None:
        dtype = a.dtype if isinstance(a, DNDarray) else types.heat_type_of(a)
    if isinstance(a, DNDarray):
        split = a.split if split is None else split
        if device is None and comm is None:
            device, comm = a.device, a.comm
    return factory(shape, dtype=dtype, split=split, device=device, comm=comm, **kwargs)


def empty_like(a, dtype=None, split=None, device=None, comm=None, order="C") -> DNDarray:
    """Uninitialized array shaped like ``a`` (reference factories.py:192)."""
    return _factory_like(a, dtype, split, empty, device, comm)


def zeros_like(a, dtype=None, split=None, device=None, comm=None, order="C") -> DNDarray:
    """Zeros shaped like ``a`` (reference factories.py:196)."""
    return _factory_like(a, dtype, split, zeros, device, comm)


def ones_like(a, dtype=None, split=None, device=None, comm=None, order="C") -> DNDarray:
    """Ones shaped like ``a`` (reference factories.py:200)."""
    return _factory_like(a, dtype, split, ones, device, comm)


def full_like(a, fill_value, dtype=types.float32, split=None, device=None, comm=None, order="C") -> DNDarray:
    """``fill_value`` shaped like ``a``; float32 unless told otherwise, as in
    the reference (factories.py:204)."""
    return _factory_like(a, dtype, split, full, device, comm, fill_value=fill_value)


def linspace(
    start, stop, num: int = 50, endpoint: bool = True, retstep: bool = False,
    dtype=None, split=None, device=None, comm=None,
):
    """``num`` evenly spaced samples over [start, stop], or [start, stop)
    without ``endpoint``; float32 by default (reference factories.py:873)."""
    num = int(num)
    if num <= 0:
        raise ValueError(f"number of samples 'num' must be non-negative integer, but was {num}")
    start = float(start.item() if isinstance(start, DNDarray) else start)
    stop = float(stop.item() if isinstance(stop, DNDarray) else stop)
    dtype = types.float32 if dtype is None else types.canonical_heat_type(dtype)
    device, comm = _resolve(device, comm)
    step = (stop - start) / max(1, num - 1 if endpoint else num)
    t = torch.linspace(start, stop if endpoint else stop - step, num, dtype=torch.float64, device=comm.home)
    t = t.to(dtype.torch_type())
    split = sanitize_axis(t.shape, split) if split is not None else None
    out = _wrap(t, split, device, comm)
    return (out, step) if retstep else out


def logspace(
    start, stop, num: int = 50, endpoint: bool = True, base: float = 10.0,
    dtype=None, split=None, device=None, comm=None,
) -> DNDarray:
    """``num`` samples on a log scale, ``base ** linspace(start, stop)``
    taken as ``exp(linspace * log(base))`` (reference factories.py:260)."""
    from . import exponential

    y = linspace(start, stop, num=num, endpoint=endpoint, split=split, device=device, comm=comm)
    out = exponential.exp(y * float(np.log(base)))
    return out if dtype is None else out.astype(dtype)


def meshgrid(*arrays, indexing: str = "xy") -> List[DNDarray]:
    """Coordinate matrices from coordinate vectors (reference
    factories.py:289); the outputs are split along 0 when an input is
    split."""
    if indexing not in ("xy", "ij"):
        raise ValueError(f"indexing must be 'xy' or 'ij', got {indexing}")
    if not arrays:
        return []
    first = next((a for a in arrays if isinstance(a, DNDarray)), None)
    device, comm = _resolve(None, None if first is None else first.comm)
    split = 0 if any(isinstance(a, DNDarray) and a.split is not None for a in arrays) else None
    target = comm.home
    tensors = [
        a.larray.to(target) if isinstance(a, DNDarray) else torch.as_tensor(np.asarray(a), device=target)
        for a in arrays
    ]
    return [_wrap(t.contiguous(), split, device, comm) for t in torch.meshgrid(*tensors, indexing=indexing)]


def from_partitioned(x, comm=None) -> DNDarray:
    """An array from any object with an array interface (reference
    factories.py:318)."""
    return array(x, comm=comm)
