"""Input validation (reference: heat/core/sanitation.py)."""

from __future__ import annotations

from typing import Optional, Sequence, Union

from . import types
from .dndarray import DNDarray

__all__ = [
    "ReplicationWarning",
    "sanitize_in",
    "sanitize_infinity",
    "sanitize_out",
    "sanitize_sequence",
    "warn_replicated",
]


def sanitize_in(x) -> None:
    """Raise TypeError unless ``x`` is a DNDarray (reference sanitation.py:161)."""
    if not isinstance(x, DNDarray):
        raise TypeError(f"input needs to be a DNDarray, but was {type(x)}")


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
