"""Mesh health and live-buffer triage (reference: heat_tpu/utils/health.py).

A backend can hang rather than die, so the runtime has an explicit health
surface:

* :func:`ping_mesh`: one ``allreduce`` through the mesh's own verb over one
  value per shard, checked against its exact sum, under a wall-clock
  budget; it returns the status and the latency. The probe runs on a daemon
  thread, so that a hung backend cannot hang the caller.
* :func:`assert_mesh_healthy`: raise unless the mesh answers in time.
* :func:`memory_report`: the live buffers per device of the mesh, from the
  memory ledger's own walk and buffer key (``core/memledger.py``), so that
  the two surfaces cannot disagree on what one buffer is.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Optional

import torch

from ..core import memledger
from ..core.communication import MeshCommunication, sanitize_comm

__all__ = ["MeshUnhealthyError", "assert_mesh_healthy", "memory_report", "ping_mesh"]


class MeshUnhealthyError(RuntimeError):
    """The mesh failed to answer a collective within the budget."""


def _ping(comm: MeshCommunication) -> float:
    """One allreduce of shard r's value r over the mesh; returns the wall
    latency, the host read of the result included."""
    start = time.perf_counter()
    shards = [torch.full((1,), float(r), device=d) for r, d in enumerate(comm.devices)]
    out = comm.allreduce(shards)
    first = comm.devices[0]
    total = float(torch.cat([s.to(first) for s in out]).sum())  # the host read
    expect = float(comm.size) * sum(range(comm.size))
    if total != expect:
        raise MeshUnhealthyError(f"collective returned {total}, expected {expect}: mesh state corrupt")
    return time.perf_counter() - start


def ping_mesh(comm: Optional[MeshCommunication] = None, timeout: float = 60.0) -> dict:
    """Probe the mesh with one collective under a wall-clock budget.

    Returns ``{"ok", "latency_s", "devices", "platform", "error"}``. A hung
    backend yields ``ok=False`` with ``error="timeout"`` instead of hanging
    the caller."""
    comm = sanitize_comm(comm)
    info = {
        "ok": False,
        "latency_s": None,
        "devices": comm.size,
        "platform": comm.devices[0].type if comm.devices else "?",
        "error": None,
    }
    # a daemon thread, not an executor: an executor's shutdown (and the
    # interpreter's join of its workers at exit) would block on a hung
    # backend, the very failure this probe bounds
    result: "queue.Queue" = queue.Queue(maxsize=1)

    def run():
        try:
            result.put(("ok", _ping(comm)))
        except Exception as exc:  # noqa: BLE001 - the failure is the probe's answer
            result.put(("err", f"{type(exc).__name__}: {exc}"))

    threading.Thread(target=run, name="heat-tpu-ping", daemon=True).start()
    try:
        kind, val = result.get(timeout=timeout)
    except queue.Empty:
        info["error"] = "timeout"
        return info
    if kind == "ok":
        info["latency_s"] = round(val, 6)
        info["ok"] = True
    else:
        info["error"] = val
    return info


def assert_mesh_healthy(comm: Optional[MeshCommunication] = None, timeout: float = 60.0) -> dict:
    """Raise :class:`MeshUnhealthyError` unless :func:`ping_mesh` succeeds."""
    info = ping_mesh(comm, timeout=timeout)
    if not info["ok"]:
        raise MeshUnhealthyError(f"mesh health probe failed: {info}")
    return info


def memory_report(comm: Optional[MeshCommunication] = None, top: int = 5) -> dict:
    """The live buffers on the devices of ``comm``'s mesh: ``total_bytes``,
    ``per_device_bytes``, the deduped ``buffer_count`` and the ``top``
    largest buffers (shape, dtype, bytes and owner). It is the memory
    ledger's walk restricted to the mesh's devices, so a buffer shared by
    several shards or views counts once, and on the card a device's bytes
    are its allocator's count (``core/memledger.py``). It reads the tagged
    storages and the allocator, never the heap: ``report()`` carries it."""
    comm = sanitize_comm(comm)
    scan = memledger._scan(top=max(0, int(top)), devices={str(d) for d in comm.devices})
    return {
        "total_bytes": scan["total_bytes"],
        "per_device_bytes": dict(scan["per_device"]),
        "buffer_count": scan["buffers"],
        "top_buffers": [
            {"nbytes": r["nbytes"], "shape": r["shape"], "dtype": r["dtype"], "owner": r["owner"]} for r in scan["top"]
        ],
    }
