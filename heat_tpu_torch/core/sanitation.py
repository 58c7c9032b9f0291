"""Input validation (reference: heat/core/sanitation.py)."""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from . import types
from .dndarray import DNDarray

__all__ = [
    "ReplicationWarning",
    "sanitize_distribution",
    "sanitize_in",
    "sanitize_in_tensor",
    "sanitize_infinity",
    "sanitize_lshape",
    "sanitize_mesh",
    "sanitize_out",
    "sanitize_sequence",
    "scalar_to_1d",
    "warn_replicated",
]


def sanitize_in(x) -> None:
    """Raise TypeError unless ``x`` is a DNDarray (reference sanitation.py:161)."""
    if not isinstance(x, DNDarray):
        raise TypeError(f"input needs to be a DNDarray, but was {type(x)}")


def sanitize_in_tensor(x) -> None:
    """Raise TypeError unless ``x`` is a torch tensor (reference
    sanitation.py:69)."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"input needs to be a torch.Tensor, but was {type(x)}")


def sanitize_distribution(*args, target: DNDarray, diff_map=None):
    """Give each operand of ``target``'s shape ``target``'s split axis
    (reference sanitation.py:85): a resplit copy where it differs."""
    from . import manipulations

    out = []
    for x in args:
        sanitize_in(x)
        if x.split != target.split and x.shape == target.shape:
            x = manipulations.resplit(x, target.split)
        out.append(x)
    return out[0] if len(out) == 1 else tuple(out)


def _mesh_devices(comm):
    return None if comm.spans_processes else comm.devices


def same_mesh(a, b) -> bool:
    """Whether two meshes hold the same shards: the same mesh, or two
    one-process meshes of the same device list (a spanning mesh is only
    itself)."""
    return a is b or (_mesh_devices(a) is not None and _mesh_devices(a) == _mesh_devices(b))


def sanitize_mesh(*operands) -> None:
    """Raise ValueError when two DNDarray operands lie on different meshes,
    as the reference's jitted computation refuses incompatible devices.
    Meshes compare by their device lists: a mesh re-formed onto the same
    devices (the autoscaler's recovery) and a sub-mesh's own arrays
    combine; a spanning mesh compares by identity."""
    first = None
    for x in operands:
        if not isinstance(x, DNDarray):
            continue
        if first is None:
            first = x.comm
        elif not same_mesh(x.comm, first):
            raise ValueError(
                f"operands lie on different meshes ({first.size} and {x.comm.size} shards): move an "
                "array made before a reform onto the current mesh before combining them"
            )


def sanitize_lshape(array: DNDarray, tensor) -> None:
    """Raise unless ``tensor`` has the shape of ``array``'s first logical
    shard (reference sanitation.py:106)."""
    if tuple(tensor.shape) != tuple(array.lshape):
        raise ValueError(f"local shape {tuple(tensor.shape)} does not match expected {array.lshape}")


def scalar_to_1d(x: DNDarray) -> DNDarray:
    """A 0-d array as a one-element 1-d one (reference sanitation.py:138)."""
    from . import manipulations

    return manipulations.expand_dims(x, 0) if x.ndim == 0 else x


def sanitize_infinity(x) -> Union[int, float]:
    """Largest representable value of x's type (reference sanitation.py:194)."""
    dtype = x.dtype if isinstance(x, DNDarray) else types.heat_type_of(x)
    if types.heat_type_is_exact(dtype):
        return types.iinfo(dtype).max
    return float("inf")


def sanitize_out(
    out, output_shape: Sequence[int], output_split: Optional[int], output_device, output_comm=None
) -> None:
    """Validate an ``out=`` buffer (reference sanitation.py:259): a DNDarray
    of the result's shape."""
    if not isinstance(out, DNDarray):
        raise TypeError(f"expected out to be None or a DNDarray, but was {type(out)}")
    if tuple(out.shape) != tuple(output_shape):
        raise ValueError(f"Expecting output buffer of shape {tuple(output_shape)}, got {out.shape}")


def sanitize_sequence(seq) -> list:
    """A sequence argument as a list (reference sanitation.py:310)."""
    if isinstance(seq, list):
        return seq
    if isinstance(seq, tuple):
        return list(seq)
    if isinstance(seq, DNDarray):
        return seq.tolist()
    raise TypeError(f"seq must be a list, tuple or DNDarray, got {type(seq)}")


class ReplicationWarning(UserWarning):
    """A distributed operand degraded to a replicated (gathered) execution
    (heat_tpu/core/sanitation.py:44)."""


def warn_replicated(op: str, reason: str) -> None:
    """Warn that a distributed operand runs replicated: the explicit-gather
    policy of the linear algebra (heat_tpu/core/sanitation.py:48-60), never
    a silent gather. Callers filter it by :class:`ReplicationWarning`."""
    import warnings

    warnings.warn(
        f"heat_tpu_torch.{op}: executing on a REPLICATED operand — {reason}",
        ReplicationWarning,
        stacklevel=3,
    )
