"""Tracing and timing (reference: heat_tpu/utils/profiling.py).

* :func:`trace`: a ``torch.profiler`` trace of the enclosed block, host and
  CUDA activities, exported as Chrome trace JSON into a directory (open it
  in ui.perfetto.dev or ``chrome://tracing``).
* :func:`annotate`: a named region, ``torch.profiler.record_function``, that
  shows on the device timeline of a trace; a decorator or a context manager.
* :class:`Timer` / :func:`timed`: a process-wide registry of wall-clock
  timers that synchronize every CUDA device of the default mesh before they
  stop, so a timed region measures the device work it enqueued.
* :func:`report`: ``{name: {calls, total_s, mean_s, best_s}}``.
* :func:`device_memory_stats`: the CUDA caching allocator's bytes per
  device of the default mesh; ``{}`` on a CPU mesh.
* :func:`host_memory_stats`: this process's resident and peak memory and
  the machine's physical memory.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from typing import Any, Callable, Dict, Optional

import torch

from ..core import telemetry as _telemetry

__all__ = [
    "Timer",
    "annotate",
    "device_memory_stats",
    "host_memory_stats",
    "record_timing",
    "report",
    "reset",
    "timed",
    "trace",
]


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed block with ``torch.profiler`` (host and, where
    CUDA is available, device activities) and write its Chrome trace JSON
    into ``log_dir``, which Perfetto opens; yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))


def annotate(name: str):
    """A named trace region, ``with annotate("lloyd"): ...`` or a decorator;
    regions nest and show on the device timeline."""
    return torch.profiler.record_function(name)


class Timer:
    """A wall-clock timer that waits for the device work enqueued inside it
    before it stops (``sync``), and records into the registry.

    >>> with Timer("assign"):
    ...     out = step(x)
    """

    _registry: Dict[str, Dict[str, Any]] = {}

    def __init__(self, name: str, sync: bool = True):
        self.name = name
        self.sync = sync
        self._start = None
        self.elapsed = 0.0

    def __enter__(self) -> "Timer":
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        if self.sync and exc == (None, None, None):
            _sync_all_devices()
        self.elapsed = time.perf_counter() - self._start
        record_timing(self.name, self.elapsed)


def record_timing(name: str, elapsed: float) -> None:
    """Record one completed timing (the path shared by :class:`Timer` and
    ``telemetry.span``); active telemetry spans take timers closing inside
    them, and verbose telemetry puts each on its timeline."""
    rec = Timer._registry.setdefault(name, {"calls": 0, "total_s": 0.0, "best_s": float("inf")})
    rec["calls"] += 1
    rec["total_s"] += elapsed
    rec["best_s"] = min(rec["best_s"], elapsed)
    if _telemetry._MODE:
        _telemetry.on_timer(name, elapsed)


def _sync_all_devices() -> None:
    """Wait for every CUDA device of the default mesh; nothing to wait for
    on a CPU mesh. Errors the device reports propagate."""
    from ..core.communication import get_comm

    for d in dict.fromkeys(get_comm().devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def timed(fn: Optional[Callable] = None, *, name: Optional[str] = None, sync: bool = True):
    """Decorator recording each call of ``fn`` under ``name`` (default its
    qualname) inside an :func:`annotate` region; with ``sync`` the timer
    waits for the device work the call enqueued."""

    def wrap(f):
        label = name or f.__qualname__

        @functools.wraps(f)
        def inner(*args, **kwargs):
            with annotate(label), Timer(label, sync=False):
                out = f(*args, **kwargs)
                if sync:
                    _sync_all_devices()
            return out

        return inner

    return wrap(fn) if fn is not None else wrap


def report() -> Dict[str, Dict[str, float]]:
    """The timings: ``{name: {calls, total_s, mean_s, best_s}}``."""
    return {
        name: {
            "calls": rec["calls"],
            "total_s": rec["total_s"],
            "mean_s": rec["total_s"] / rec["calls"],
            "best_s": rec["best_s"],
        }
        for name, rec in Timer._registry.items()
    }


def reset() -> None:
    """Clear the timer registry."""
    Timer._registry.clear()


Timer.report = staticmethod(report)
Timer.reset = staticmethod(reset)


def device_memory_stats() -> Dict[str, Dict[str, int]]:
    """Allocator bytes per CUDA device of the default mesh, under the
    reference's keys: ``bytes_in_use`` and ``peak_bytes_in_use`` (allocated
    tensors), ``bytes_reserved`` and ``peak_bytes_reserved`` (the caching
    allocator's segments) and ``bytes_limit`` (the device's memory).
    ``{}`` for a CPU mesh."""
    from ..core.communication import get_comm

    out: Dict[str, Dict[str, int]] = {}
    for d in dict.fromkeys(get_comm().devices):
        if d.type != "cuda":
            continue
        stats = torch.cuda.memory_stats(d)
        out[str(d)] = {
            "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
            "bytes_reserved": int(stats.get("reserved_bytes.all.current", 0)),
            "peak_bytes_reserved": int(stats.get("reserved_bytes.all.peak", 0)),
            "bytes_limit": int(torch.cuda.mem_get_info(d)[1]),
        }
    return out


def host_memory_stats() -> Dict[str, int]:
    """This process's host memory: current and peak resident bytes and the
    machine's physical total; a key is present where the platform gives
    it."""
    out: Dict[str, int] = {}
    try:
        page = int(os.sysconf("SC_PAGE_SIZE"))
        with open("/proc/self/statm") as fh:
            rss_pages = int(fh.read().split()[1])
        out["rss_bytes"] = rss_pages * page
    except (OSError, ValueError, IndexError):  # pragma: no cover - non-Linux
        pass
    try:
        import resource

        # ru_maxrss is KiB on Linux
        out["peak_rss_bytes"] = int(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024)
    except (ImportError, ValueError, OSError):  # pragma: no cover - non-POSIX
        pass
    try:
        out["total_bytes"] = int(os.sysconf("SC_PAGE_SIZE")) * int(os.sysconf("SC_PHYS_PAGES"))
    except (OSError, ValueError, AttributeError):  # pragma: no cover - non-POSIX
        pass
    return out
