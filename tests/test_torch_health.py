"""heat_tpu_torch.utils.health against heat_tpu's
(tests/test_checkpoint_profiling.py::TestHealth). CPU only.

The mesh probe is one allreduce through the port's own verb, checked
against its exact value, on meshes of 1, 3 and 5 shards; the live-buffer
report is the memory ledger's walk restricted to a mesh's devices, so its
total is the report's ledger's.
"""

from __future__ import annotations

import threading
import time

import jax
import numpy as np
import pytest
import torch

import heat_tpu as ref
import heat_tpu_torch as ht
from heat_tpu.utils import health as ref_health
from heat_tpu_torch.core import memledger
from heat_tpu_torch.core import telemetry as tel
from heat_tpu_torch.core.communication import MeshCommunication
from heat_tpu_torch.utils import health
from test_torch_parity import on_cpu  # noqa: F401

MESHES = [1, 3, 5]


def _mesh(p):
    return MeshCommunication([torch.device("cpu")] * p)


@pytest.mark.parametrize("p", MESHES)
def test_ping_mesh(p):
    info = ht.utils.health.ping_mesh(_mesh(p), timeout=120.0)
    assert info["ok"], info
    assert info["devices"] == p and info["platform"] == "cpu" and info["error"] is None
    assert info["latency_s"] > 0.0
    assert set(info) == set(ref_health.ping_mesh(timeout=120.0))


def test_ping_runs_the_ports_allreduce():
    was = tel.set_mode(1)
    tel.reset()
    try:
        assert health.ping_mesh(_mesh(3))["ok"]
        assert tel.collective_counts() == {"allreduce": 1}
    finally:
        tel.set_mode(was)
        tel.reset()


def test_assert_mesh_healthy():
    info = ht.utils.health.assert_mesh_healthy(timeout=120.0)
    assert info["ok"] and info["devices"] == ht.get_comm().size


def test_unhealthy_raises(monkeypatch):
    monkeypatch.setattr(health, "_ping", lambda comm: (_ for _ in ()).throw(RuntimeError("boom")))
    with pytest.raises(health.MeshUnhealthyError, match="boom"):
        health.assert_mesh_healthy(timeout=5.0)


def test_a_wrong_sum_is_unhealthy(monkeypatch):
    comm = _mesh(3)
    monkeypatch.setattr(comm, "allreduce", lambda shards: [s * 0 for s in shards])
    info = health.ping_mesh(comm, timeout=5.0)
    assert not info["ok"] and "MeshUnhealthyError" in info["error"] and "expected 9.0" in info["error"]


def test_a_hung_backend_times_out_without_hanging_the_caller(monkeypatch):
    release = threading.Event()
    monkeypatch.setattr(health, "_ping", lambda comm: release.wait(30.0))
    t0 = time.perf_counter()
    info = health.ping_mesh(_mesh(3), timeout=0.2)
    release.set()
    assert info["error"] == "timeout" and not info["ok"]
    assert time.perf_counter() - t0 < 5.0


@pytest.mark.parametrize("p", MESHES)
def test_memory_report(p):
    comm = _mesh(p)
    keep = ht.ones((64, 4), split=0, comm=comm)  # noqa: F841 - held live for the report
    rep = ht.utils.health.memory_report(comm)
    assert set(rep) == {"total_bytes", "per_device_bytes", "buffer_count", "top_buffers"}
    assert rep["total_bytes"] >= 64 * 4 * 4 and rep["per_device_bytes"]["cpu"] == rep["total_bytes"]
    led = tel.report()["memory"]["ledger"]
    assert rep["total_bytes"] == led["total_bytes"] and rep["buffer_count"] == led["buffers"]
    assert memledger.ledger()["total_bytes"] >= rep["total_bytes"]  # and the heap's foreign tensors
    ref_keep = ref.ones((64, 4), split=0)  # noqa: F841
    assert set(rep) == set(ref_health.memory_report())


def test_memory_report_top_and_dedupe():
    comm = _mesh(3)
    xs = [ht.ones((n, 4), split=0, comm=comm) for n in (30, 60, 90)]
    views = [x.larray for x in xs] + [x.shards[1] for x in xs]  # noqa: F841 - share the shards' storages
    rep = health.memory_report(comm, top=2)
    assert len(rep["top_buffers"]) == 2
    assert [b["nbytes"] for b in rep["top_buffers"]] == sorted((b["nbytes"] for b in rep["top_buffers"]), reverse=True)
    assert rep["top_buffers"][0]["owner"] == "dndarray" and rep["top_buffers"][0]["dtype"] == "float32"
    # one storage per split-0 array on the CPU mesh, however many views
    before = health.memory_report(comm, top=0)
    more = [x.shards[0][1:] for x in xs]  # noqa: F841
    after = health.memory_report(comm, top=0)
    assert after == before


def test_memory_report_counts_only_the_mesh_devices():
    comm = _mesh(3)
    keep = ht.ones((8, 4), split=0, comm=comm)  # noqa: F841
    rep = health.memory_report(MeshCommunication([torch.device("cuda", 0)]))
    assert rep["total_bytes"] == 0 and rep["per_device_bytes"] == {} and rep["buffer_count"] == 0
