"""The native CSV codec, bound with ctypes (reference: heat_tpu/_native).

``csv_reader.cpp`` is a multithreaded byte-range CSV parser and
``csv_writer.cpp`` a multithreaded writer of shortest round-trip values
(``std::to_chars``), copies of the JAX package's sources. They are built at
their first use, with the image's ``g++``, into ``heat_tpu_torch/_build/``
(``ops/_build.py::build_host``), never beside the sources, and loaded with
``ctypes``. :mod:`heat_tpu_torch.core.io` reads and writes CSV through them.

``native_available()`` is False when ``HEAT_TPU_NO_NATIVE`` is set or no
``g++`` is on the path; then io takes its Python path. With a compiler, a
failed build raises: it does not turn into the Python path. ``CALLS``
counts the calls into the library, by function.
"""

from __future__ import annotations

import ctypes
import os
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

__all__ = ["CALLS", "csv_parse", "csv_scan", "csv_write", "native_available"]

_DIR = Path(__file__).resolve().parent
SOURCES = (_DIR / "csv_reader.cpp", _DIR / "csv_writer.cpp")

#: calls into the library since import (or since the caller reset them)
CALLS: Dict[str, int] = {"csv_scan": 0, "csv_parse": 0, "csv_write": 0}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _load() -> Optional[ctypes.CDLL]:
    """The loaded library, built on first use; None when disabled or when
    there is no compiler."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if os.environ.get("HEAT_TPU_NO_NATIVE"):
            return None
        from ..ops import _build

        try:
            _build.gxx()
        except RuntimeError:
            return None  # no compiler: io takes its Python path
        lib = ctypes.CDLL(str(_build.build_host("heatcsv", SOURCES)))
        lib.csv_scan.argtypes = [
            ctypes.c_char_p, ctypes.c_char, ctypes.c_longlong,
            ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_longlong),
        ]
        lib.csv_scan.restype = ctypes.c_int
        lib.csv_parse.argtypes = [
            ctypes.c_char_p, ctypes.c_char, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.POINTER(ctypes.c_double), ctypes.c_int,
        ]
        lib.csv_parse.restype = ctypes.c_longlong
        lib.csv_write.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_double), ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_char, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        lib.csv_write.restype = ctypes.c_longlong
        _lib = lib
        return _lib


def native_available() -> bool:
    """Whether io reads and writes CSV through the native codec (building
    it on the first call)."""
    return _load() is not None


def _threads(n_threads: Optional[int]) -> int:
    return n_threads or min(os.cpu_count() or 1, 16)


def csv_scan(path: str, sep: str = ",", skip_lines: int = 0) -> Tuple[int, int]:
    """(rows, cols) of the data lines of a CSV file after ``skip_lines``."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native CSV reader unavailable")
    rows, cols = ctypes.c_longlong(0), ctypes.c_longlong(0)
    CALLS["csv_scan"] += 1
    rc = lib.csv_scan(str(path).encode(), sep.encode()[:1], skip_lines, ctypes.byref(rows), ctypes.byref(cols))
    if rc == -1:
        raise OSError(f"cannot read {path}")
    if rc == -2:
        return 0, 0
    return int(rows.value), int(cols.value)


def csv_parse(path: str, sep: str = ",", skip_lines: int = 0, n_threads: Optional[int] = None) -> np.ndarray:
    """Parse a CSV file into a (rows, cols) float64 array with C++ threads;
    ``ValueError`` when a line does not parse (the caller may then take the
    Python path, which is more lenient)."""
    rows, cols = csv_scan(path, sep, skip_lines)
    out = np.empty((rows, cols), dtype=np.float64)
    if rows == 0:
        return out
    CALLS["csv_parse"] += 1
    done = _lib.csv_parse(
        str(path).encode(), sep.encode()[:1], skip_lines, rows, cols,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), _threads(n_threads),
    )
    if done == -1:
        raise OSError(f"cannot read {path}")
    if done != rows:
        raise ValueError(f"malformed CSV {path}: parsed {done} of {rows} rows")
    return out


def csv_write(
    path: str, data: np.ndarray, sep: str = ",", decimals: int = -1, append: bool = False,
    n_threads: Optional[int] = None,
) -> int:
    """Write a 2-D array as CSV rows, formatted by C++ threads: shortest
    round-trip values of its float64 form for ``decimals < 0``, else
    ``%.<decimals>f``; ``append`` adds to the file. Returns the rows
    written."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native CSV writer unavailable")
    arr = np.ascontiguousarray(data, dtype=np.float64)
    if arr.ndim != 2:
        raise ValueError(f"need a 2-D array, got {arr.ndim}-D")
    CALLS["csv_write"] += 1
    done = lib.csv_write(
        str(path).encode(), arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        arr.shape[0], arr.shape[1], sep.encode()[:1], decimals, 1 if append else 0, _threads(n_threads),
    )
    if done != arr.shape[0]:
        raise OSError(f"native CSV write to {path} failed")
    return int(done)
