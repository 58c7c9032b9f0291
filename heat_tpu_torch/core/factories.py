"""Array creation routines (reference: heat/core/factories.py,
heat_tpu/core/factories.py).

Every factory builds the logical global tensor on the mesh's first device and
cuts it into the pad+mask shards (:func:`.dndarray._distribute`). The device
defaults to the GPU; without CUDA that raises ``RuntimeError`` unless the
caller asks for the CPU.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import devices, types
from .communication import Communication, sanitize_comm
from .dndarray import DNDarray, _wrap
from .stride_tricks import sanitize_axis, sanitize_shape

__all__ = ["arange", "array", "asarray", "empty", "full", "ones", "zeros"]


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
    split: Optional[int] = None,
    is_split: Optional[int] = None,
    device=None,
    comm: Optional[Communication] = None,
) -> DNDarray:
    """Create a DNDarray from a DNDarray, tensor, numpy array or nested
    sequence (reference factories.py:150-431). With one controller the local
    data is the global array, so ``is_split`` behaves like ``split``."""
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
    target = comm.devices[0]
    if isinstance(obj, torch.Tensor):
        t = obj.to(device=target, dtype=tdtype)
        if copy and t.data_ptr() == obj.data_ptr():
            t = t.clone()
    else:
        nparr = np.asarray(obj)
        if not nparr.flags.writeable:
            nparr = nparr.copy()  # torch tensors are writable
        if nparr.dtype == object:
            raise TypeError("invalid data of type object")
        if tdtype is None and nparr.dtype == np.float64 and not isinstance(obj, np.ndarray):
            # python floats default to float32 (reference factories.py:334-340)
            nparr = nparr.astype(np.float32)
        t = torch.as_tensor(nparr).to(device=target, dtype=tdtype)
    while t.ndim < ndmin:
        t = t[None]
    split = sanitize_axis(t.shape, split) if split is not None else None
    return _wrap(t, split, device, comm)


def asarray(obj, dtype=None, copy=None, is_split=None, device=None, comm=None) -> DNDarray:
    """Convert input to a DNDarray without copying where possible
    (reference factories.py:520)."""
    return array(obj, dtype=dtype, copy=copy, is_split=is_split, device=device, comm=comm)


def _factory(shape, dtype, split, fill, device, comm) -> DNDarray:
    shape = sanitize_shape(shape)
    dtype = types.canonical_heat_type(dtype)
    split = sanitize_axis(shape, split)
    device, comm = _resolve(device, comm)
    t = fill(shape, dtype=dtype.torch_type(), device=comm.devices[0])
    return _wrap(t, split if shape else None, device, comm)


def empty(shape, dtype=types.float32, split=None, device=None, comm=None) -> DNDarray:
    """Uninitialized array (reference factories.py:558)."""
    return _factory(shape, dtype, split, torch.empty, device, comm)


def zeros(shape, dtype=types.float32, split=None, device=None, comm=None) -> DNDarray:
    """Array of zeros (reference factories.py:1244)."""
    return _factory(shape, dtype, split, torch.zeros, device, comm)


def ones(shape, dtype=types.float32, split=None, device=None, comm=None) -> DNDarray:
    """Array of ones (reference factories.py:1072)."""
    return _factory(shape, dtype, split, torch.ones, device, comm)


def full(shape, fill_value, dtype=None, split=None, device=None, comm=None) -> DNDarray:
    """Constant-filled array (reference factories.py:820); an integer fill
    value gives float32, as in the reference."""
    if dtype is None:
        dtype = types.heat_type_of(fill_value)
        if isinstance(fill_value, (int, np.integer)):
            dtype = types.float32

    def fill(shape, dtype, device):
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
    t = torch.arange(start, stop, step, dtype=dtype.torch_type(), device=comm.devices[0])
    split = sanitize_axis(t.shape, split) if split is not None else None
    return _wrap(t, split, device, comm)
