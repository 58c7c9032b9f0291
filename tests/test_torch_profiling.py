"""heat_tpu_torch.utils.profiling against heat_tpu's
(tests/test_checkpoint_profiling.py::TestProfiling), and the package's
version and exports. CPU only; times are host-clock and only checked for
their bookkeeping, never compared.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

import heat_tpu as ref
import heat_tpu_torch as ht
from heat_tpu.utils import profiling as ref_prof
from heat_tpu_torch.core import telemetry as tel
from heat_tpu_torch.utils import profiling
from test_torch_parity import on_cpu  # noqa: F401


@pytest.fixture(autouse=True)
def fresh():
    was = tel.set_mode(0)
    profiling.reset()
    tel.reset()
    yield
    tel.set_mode(was)
    profiling.reset()


def _work():
    return torch.ones((64, 64)) @ torch.ones((64, 64))


def test_timer_registry_and_report():
    with profiling.Timer("mm"):
        _work()
    with profiling.Timer("mm") as t:
        _work()
    rep = profiling.report()
    assert rep["mm"]["calls"] == 2 and t.elapsed > 0
    assert rep["mm"]["total_s"] >= rep["mm"]["best_s"] > 0
    assert rep["mm"]["mean_s"] == pytest.approx(rep["mm"]["total_s"] / 2)
    ref_prof.reset()
    with ref_prof.Timer("mm"):
        pass
    assert set(rep["mm"]) == set(ref_prof.report()["mm"])
    assert profiling.Timer.report() == rep
    profiling.Timer.reset()
    assert profiling.report() == {}


def test_a_timer_that_raises_is_still_recorded():
    with pytest.raises(ValueError):
        with profiling.Timer("bad"):
            raise ValueError
    assert profiling.report()["bad"]["calls"] == 1


def test_timed_returns_the_value_and_records():
    @profiling.timed(name="double")
    def double(x):
        return x * 2

    @profiling.timed
    def plain(x):
        return x + 1

    np.testing.assert_array_equal(double(torch.arange(4)).numpy(), [0, 2, 4, 6])
    assert plain(1) == 2
    rep = profiling.report()
    assert rep["double"]["calls"] == 1
    assert rep[plain.__qualname__]["calls"] == 1


def test_timers_inside_spans_are_attributed():
    tel.set_mode(2)
    with tel.span("fit"):
        with tel.span("iter"):
            with profiling.Timer("step"):
                _work()
    spans = tel.spans()
    assert spans["fit"]["timers"]["step"] == spans["fit/iter"]["timers"]["step"] > 0
    assert set(profiling.report()) == {"step", "span:fit", "span:fit/iter"}
    kinds = [e["kind"] for e in tel.events()]
    assert kinds == ["span_begin", "span_begin", "timer", "span_end", "span_end"]
    assert tel.report()["timers"]["step"]["calls"] == 1


def test_annotate_nests_and_trace_writes_a_chrome_file(tmp_path):
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.annotate("outer"), profiling.annotate("inner"):
            _work()
    assert prof is not None
    files = [os.path.join(r, f) for r, _, fs in os.walk(tmp_path) for f in fs]
    assert len(files) == 1
    doc = json.load(open(files[0]))
    names = {e.get("name") for e in doc["traceEvents"]}
    assert {"outer", "inner"} <= names


def test_memory_stats():
    assert profiling.device_memory_stats() == {}  # a CPU mesh
    host = profiling.host_memory_stats()
    assert set(host) == set(ref_prof.host_memory_stats())
    assert host["total_bytes"] >= host["rss_bytes"] > 0
    assert not torch.cuda.is_initialized()


def test_version_and_exports_match_heat_tpu():
    assert ht.__version__ == ref.__version__ == ht.version.__version__
    assert ht.version.__pep440__ == ref.version.__pep440__
    assert ht.errstate is ht.resilience.errstate
    assert ht.utils.profiling is profiling
    for name in ("telemetry", "resilience", "errstate", "version", "checkpoint"):
        assert hasattr(ht, name) and hasattr(ref, name), name
    assert set(ht.resilience.__all__) == set(ref.resilience.__all__)
    assert set(profiling.__all__) == set(ref_prof.__all__)


def test_ht_checkpoint_is_the_checkpoint_module_as_in_heat_tpu():
    """Fault C14: heat_tpu/__init__.py:12 exports ``ht.checkpoint``."""
    assert ht.checkpoint is ht.utils.checkpoint
    assert ref.checkpoint is ref.utils.checkpoint
    assert set(ht.checkpoint.__all__) == set(ref.checkpoint.__all__)


@pytest.fixture
def cuda_mesh(monkeypatch):
    """The default mesh as three shards of two CUDA devices, with the CUDA
    calls profiling makes recorded instead of run."""
    from heat_tpu_torch.core import communication

    mesh = communication.MeshCommunication([torch.device("cuda", 0), torch.device("cuda", 1), torch.device("cuda", 0)])
    monkeypatch.setattr(communication, "get_comm", lambda: mesh)
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda d=None: calls.append(("sync", str(d))))
    stats = {
        "allocated_bytes.all.current": 640, "allocated_bytes.all.peak": 900,
        "reserved_bytes.all.current": 1024, "reserved_bytes.all.peak": 2048, "num_alloc_retries": 0,
    }
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda d=None: calls.append(("stats", str(d))) or stats)
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda d=None: (10, 80 << 30))
    return calls


def test_a_timer_synchronizes_every_cuda_device_of_the_mesh(cuda_mesh):
    with profiling.Timer("t"):
        pass
    assert cuda_mesh == [("sync", "cuda:0"), ("sync", "cuda:1")]
    cuda_mesh.clear()
    profiling.timed(lambda: 1)()
    assert cuda_mesh == [("sync", "cuda:0"), ("sync", "cuda:1")]
    cuda_mesh.clear()
    profiling.timed(sync=False)(lambda: 1)()
    assert cuda_mesh == []


def test_a_device_error_at_the_sync_propagates(cuda_mesh, monkeypatch):
    def fail(d=None):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(torch.cuda, "synchronize", fail)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        with profiling.Timer("t"):
            pass


def test_device_memory_stats_use_the_references_keys(cuda_mesh):
    stats = profiling.device_memory_stats()
    assert list(stats) == ["cuda:0", "cuda:1"]
    assert stats["cuda:0"] == {
        "bytes_in_use": 640, "peak_bytes_in_use": 900, "bytes_reserved": 1024,
        "peak_bytes_reserved": 2048, "bytes_limit": 80 << 30,
    }
