"""Printing of distributed arrays (reference: heat/core/printing.py,
heat_tpu/core/printing.py).

A large array moves only its first-axis edge slabs to the host, as the
reference's edge-item gather does.
"""

from __future__ import annotations

import numpy as np

from . import fusion, health_runtime, telemetry
from .communication import get_comm
from .dndarray import _host

__all__ = [
    "get_printoptions",
    "global_printing",
    "local_printing",
    "print0",
    "set_printoptions",
]

_T_PRINT = telemetry.force_trigger("print")

__PRINT_OPTIONS = dict(precision=4, threshold=1000, edgeitems=3, linewidth=120, sci_mode=None)
__LOCAL_PRINTING = False
# above this many elements, only the edge slabs are read from the devices
_FULL_FETCH_LIMIT = 65536


def set_printoptions(precision=None, threshold=None, edgeitems=None, linewidth=None, profile=None, sci_mode=None):
    """Set the printing options, or a profile of them: 'default', 'short'
    or 'full' (reference printing.py:31)."""
    if profile == "default":
        __PRINT_OPTIONS.update(precision=4, threshold=1000, edgeitems=3, linewidth=120)
    elif profile == "short":
        __PRINT_OPTIONS.update(precision=2, threshold=1000, edgeitems=2, linewidth=120)
    elif profile == "full":
        __PRINT_OPTIONS.update(precision=4, threshold=float("inf"), edgeitems=3, linewidth=120)
    for key, val in dict(
        precision=precision, threshold=threshold, edgeitems=edgeitems, linewidth=linewidth, sci_mode=sci_mode
    ).items():
        if val is not None:
            __PRINT_OPTIONS[key] = val


def get_printoptions() -> dict:
    """A copy of the printing options."""
    return dict(__PRINT_OPTIONS)


def local_printing() -> None:
    """Print each shard alone (reference printing.py:30-60)."""
    global __LOCAL_PRINTING
    __LOCAL_PRINTING = True


def global_printing() -> None:
    """Print the global array again (reference printing.py:61-99)."""
    global __LOCAL_PRINTING
    __LOCAL_PRINTING = False


def print0(*args, **kwargs) -> None:
    """Print once, from process 0 (reference printing.py:100-126)."""
    if get_comm().rank == 0:
        print(*args, **kwargs)


def __str__(dndarray) -> str:
    """The string of an array (reference printing.py:104-127), bound as
    ``DNDarray.__str__`` and ``__repr__``. A host read: telemetry counts it
    as a blocking sync."""
    cid = dndarray._payload.cid if fusion.is_deferred(dndarray) else None
    token = telemetry.record_blocking_sync("print", cid=cid) if telemetry._MODE else None
    with _T_PRINT:  # a print that forces a pending chain reads as "print"
        with health_runtime.watch("sync:print", cid=cid):
            body = _format_data(dndarray, __PRINT_OPTIONS)
    telemetry.end_blocking_sync(token)
    return f"DNDarray({body}, dtype=ht.{dndarray.dtype.__name__}, device={dndarray.device}, split={dndarray.split})"


def _format_data(dndarray, opts) -> str:
    """The printable part of the array: whole, or past the fetch limit its
    first and last ``edgeitems`` rows."""
    threshold, edge = opts["threshold"], opts["edgeitems"]
    np_opts = dict(
        precision=opts["precision"],
        threshold=int(threshold) if np.isfinite(threshold) else np.iinfo(np.int64).max,
        edgeitems=edge,
        linewidth=opts["linewidth"],
    )
    summarize = (
        np.isfinite(threshold)
        and dndarray.ndim >= 1
        and dndarray.size > max(threshold, _FULL_FETCH_LIMIT)
        and dndarray.shape[0] > 2 * edge + 1
    )
    with np.printoptions(**np_opts):
        if __LOCAL_PRINTING and dndarray.split is not None:
            return "\n".join(np.array2string(_host(s), separator=", ") for s in dndarray.lshards)
        if not summarize:
            return np.array2string(_host(dndarray.larray), separator=", ", prefix="DNDarray(")
        arr = dndarray.larray
        top, bot = _host(arr[:edge]), _host(arr[-edge:])
        if dndarray.ndim == 1:
            return "[" + ", ".join([np.array2string(v) for v in top] + ["..."] + [np.array2string(v) for v in bot]) + "]"
        head = np.array2string(top, separator=", ", prefix="DNDarray(")[1:-1]
        tail = np.array2string(bot, separator=", ", prefix="DNDarray(")[1:-1]
        return "[" + head + ",\n ...,\n " + tail + "]"
