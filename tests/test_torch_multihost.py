"""heat_tpu_torch.core.multihost (the multi-process runtime's one-process
side) against heat_tpu's, case for case: tests/test_multihost_runtime.py
(the lease daemon, the bounded barrier, the degraded topology, the guarded
bring-up, the launcher's generation protocol with stub workers, the
observability joins) and tests/test_multihost_seam.py (the pure seam
functions held against the reference's on the same fake devices, and the
consumers that route through them). Then the seams the port routes
through multihost (``atomic_write``, the checkpoint's receipts and
barriers, ``_shard_blocks``, the trace's ``pid``) and the named error of an
engine over a mesh whose ranks span processes. The real multi-process
worlds are in test_torch_multiproc.py. CPU only.
"""

from __future__ import annotations

import json
import os
import re
import sys
import tempfile
import threading
import time
import types
import unittest.mock
import warnings

import numpy as np
import pytest
import torch
import torch.distributed as dist

import heat_tpu_torch as ht
from heat_tpu.core import multihost as ref_mh
from heat_tpu_torch.core import communication, io, multihost, opsplane, resilience, telemetry
from heat_tpu_torch.utils import checkpoint
from heat_tpu_torch.utils.checkpoint import save_checkpoint
from test_torch_parity import on_cpu  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _wait_for(predicate, timeout_s=5.0, interval_s=0.01):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(interval_s)
    return predicate()


@pytest.fixture(autouse=True)
def clean_world():
    """tests/test_multihost_runtime.py:47-56: no daemon, no lost peer."""
    multihost.stop_heartbeat()
    multihost.reset_peers()
    yield
    multihost.stop_heartbeat()
    multihost.reset_peers()


def fake_devices(assignment):
    """Rank stand-ins with just the attribute the seam reads
    (tests/test_multihost_seam.py:18-20)."""
    return [types.SimpleNamespace(process_index=p, id=i) for i, p in enumerate(assignment)]


def test_the_module_surface_is_the_references():
    assert sorted(multihost.__all__) == sorted(ref_mh.__all__)
    assert multihost.REFORM_EXIT == ref_mh.REFORM_EXIT
    assert multihost.process_index() == 0 and multihost.process_count() == 1 and not dist.is_initialized()


def test_the_knobs_are_the_references_and_the_cpu_mesh_size():
    """Every HEAT_TPU_* knob of the reference module, and the one the port
    reads in place of XLA's device-count flag: HEAT_TPU_TEST_DEVICES, each
    worker's CPU mesh (spawn_local's ``devices_per_process``)."""
    mine = set(re.findall(r"HEAT_TPU_[A-Z0-9_]+", open(multihost.__file__).read()))
    theirs = set(re.findall(r"HEAT_TPU_[A-Z0-9_]+", open(ref_mh.__file__).read()))
    assert theirs <= mine and mine - theirs == {"HEAT_TPU_TEST_DEVICES"}


# ---------------------------------------------------------------------------
# the lease daemon (TestLeaseDaemon)
# ---------------------------------------------------------------------------
def test_stale_peer_declared_lost_with_marker_and_event():
    """tests/test_multihost_runtime.py:60."""
    with tempfile.TemporaryDirectory() as mesh:
        lease = multihost._lease_path(mesh, 0, 1)
        os.makedirs(os.path.dirname(lease), exist_ok=True)
        with open(lease, "w") as fh:
            fh.write("{}")
        past = time.time() - 60.0
        os.utime(lease, (past, past))
        prev = telemetry.set_mode(2)
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                assert multihost.start_heartbeat(mesh=mesh, process=0, world=2, epoch=0, interval_ms=20.0,
                                                 lost_ms=80.0)
                assert _wait_for(lambda: 1 in multihost.lost_peers())
            kinds = [e.get("kind") for e in telemetry.events()]
        finally:
            multihost.stop_heartbeat()  # before the directory goes
            telemetry.set_mode(prev)
            telemetry.reset()
        assert "peer_lost" in kinds
        with pytest.raises(multihost.PeerLostError) as ctx:
            multihost.check_peers()
        assert ctx.value.peers == (1,)
        marker = os.path.join(multihost._lost_dir(mesh, 0), "proc-00001")
        assert os.path.exists(marker)
        with open(marker) as fh:
            assert json.load(fh)["peer"] == 1


def test_beating_peer_stays_live_and_silent_peer_gets_grace():
    """tests/test_multihost_runtime.py:89."""
    with tempfile.TemporaryDirectory() as mesh:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            multihost.start_heartbeat(mesh=mesh, process=0, world=3, epoch=0, interval_ms=20.0, lost_ms=150.0)
            lease1 = multihost._lease_path(mesh, 0, 1)
            os.makedirs(os.path.dirname(lease1), exist_ok=True)
            deadline = time.monotonic() + 0.3
            while time.monotonic() < deadline:
                multihost._write_atomic(lease1, "{}")
                time.sleep(0.02)
            assert 1 not in multihost.lost_peers()
            assert _wait_for(lambda: 2 in multihost.lost_peers())
            assert 1 not in multihost.lost_peers()
            multihost.stop_heartbeat()


def test_declaration_sticky_until_reset():
    """tests/test_multihost_runtime.py:113."""
    with tempfile.TemporaryDirectory() as mesh:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            multihost.start_heartbeat(mesh=mesh, process=0, world=2, epoch=0, interval_ms=20.0, lost_ms=60.0)
            assert _wait_for(lambda: 1 in multihost.lost_peers())
            multihost._write_atomic(multihost._lease_path(mesh, 0, 1), "{}")
            time.sleep(0.1)
            assert 1 in multihost.lost_peers()
            multihost.stop_heartbeat()  # before the directory goes
        multihost.reset_peers()
        assert multihost.lost_peers() == frozenset()


def test_heartbeat_fault_site_counts_missed_beats():
    """tests/test_multihost_runtime.py:131."""
    with tempfile.TemporaryDirectory() as mesh:
        before = multihost.report_stats()["heartbeat_errors"]
        with resilience.inject("multihost.heartbeat", times=3):
            multihost.start_heartbeat(mesh=mesh, process=0, world=2, epoch=0, interval_ms=10.0, lost_ms=10_000.0)
            assert _wait_for(lambda: multihost.report_stats()["heartbeat_errors"] >= before + 3)
            lease = multihost._lease_path(mesh, 0, 0)
            assert _wait_for(lambda: os.path.exists(lease))
            multihost.stop_heartbeat()


# ---------------------------------------------------------------------------
# the barrier (TestBarrier); the real two-process barriers are in
# test_torch_multiproc.py
# ---------------------------------------------------------------------------
def test_fault_site_fires_before_single_host_early_out():
    """tests/test_multihost_runtime.py:153."""
    with resilience.inject("multihost.barrier"):
        with pytest.raises(resilience.FaultInjected):
            multihost.sync_processes("test.barrier.site")
    multihost.sync_processes("test.barrier.site")


def test_timeout_raises_stall_error_naming_tag_and_counts_abandoned(monkeypatch):
    """tests/test_multihost_runtime.py:160; the barrier itself is patched
    to hang, as the reference patches ``sync_global_devices``."""
    release = threading.Event()
    stats0 = multihost.report_stats()
    monkeypatch.setattr(multihost, "process_count", lambda: 2)
    monkeypatch.setattr(multihost, "_barrier", lambda tag, timeout_ms: release.wait(10.0))
    monkeypatch.setenv("HEAT_TPU_ABANDONED_BARRIER_CAP", "1")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            with pytest.raises(resilience.StallError) as ctx:
                multihost.sync_processes("test.hung.barrier", timeout_ms=50.0)
        assert "test.hung.barrier" in str(ctx.value)
        stats = multihost.report_stats()
        assert stats["barrier_timeouts"] == stats0["barrier_timeouts"] + 1
        assert stats["abandoned_threads"] == stats0["abandoned_threads"] + 1
        assert stats["abandoned_alive"] >= 1
        assert any(issubclass(w.category, resilience.StallWarning) for w in caught)
    finally:
        release.set()
    assert _wait_for(lambda: multihost.report_stats()["abandoned_alive"] == 0)


def test_worker_thread_failure_is_reraised_at_call_site(monkeypatch):
    """tests/test_multihost_runtime.py:199."""

    def _boom(tag, timeout_ms):
        raise ValueError(f"coordination rejected {tag}")

    monkeypatch.setattr(multihost, "process_count", lambda: 2)
    monkeypatch.setattr(multihost, "_barrier", _boom)
    with pytest.raises(ValueError) as ctx:
        multihost.sync_processes("test.error.barrier", timeout_ms=5_000.0)
    assert "test.error.barrier" in str(ctx.value)


def test_malformed_timeout_env_warns_and_reads_off(monkeypatch):
    """tests/test_multihost_runtime.py:216."""
    monkeypatch.setenv("HEAT_TPU_BARRIER_TIMEOUT_MS", "soon")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert multihost._barrier_timeout_ms() is None
    assert caught
    monkeypatch.setenv("HEAT_TPU_BARRIER_TIMEOUT_MS", "250")
    assert multihost._barrier_timeout_ms() == 250.0


def test_barrier_without_a_control_group_raises_named(monkeypatch):
    """A world the port did not bring up (no ``communication.initialize``)
    has no control group: the barrier says so rather than hanging."""
    monkeypatch.setattr(communication, "_CONTROL", None)
    with pytest.raises(RuntimeError, match="test.no.group"):
        multihost._barrier("test.no.group", None)


# ---------------------------------------------------------------------------
# the degraded topology (TestDegradedTopology)
# ---------------------------------------------------------------------------
DEVICES = fake_devices([0, 0, 1, 1])


def test_no_survivor_owns_publication():
    """tests/test_multihost_runtime.py:239."""
    assert multihost.io_owner(proc=0) and not multihost.io_owner(proc=1)
    assert (multihost.io_owner(proc=0), multihost.io_owner(proc=1)) == (ref_mh.io_owner(proc=0),
                                                                        ref_mh.io_owner(proc=1))


def test_survivor_topology_reads_stay_correct():
    """tests/test_multihost_runtime.py:246."""
    assert [r for r, _ in multihost.ranks_to_read(DEVICES, proc=1)] == [2, 3]
    assert multihost.representative_rank(DEVICES, proc=1) == 2


def test_cooperative_save_fails_fast_named():
    """tests/test_multihost_runtime.py:252."""
    with multihost._LOCK:
        multihost._LOST.add(0)
    with tempfile.TemporaryDirectory() as d:
        with pytest.raises(multihost.PeerLostError) as ctx:
            save_checkpoint(d, {"w": np.zeros(3)}, step=7)
        assert ctx.value.peers == (0,)
        assert "step 7" in str(ctx.value)
        assert os.listdir(d) == []


# ---------------------------------------------------------------------------
# the guarded bring-up (TestInitializeDistributed)
# ---------------------------------------------------------------------------
INIT_ENV = {
    "HEAT_TPU_COORDINATOR": "127.0.0.1:9999",
    "HEAT_TPU_NUM_PROCESSES": "4",
    "HEAT_TPU_PROCESS_ID": "2",
    "HEAT_TPU_MESH_DIR": "",
}


def test_env_fills_unset_arguments(monkeypatch):
    """tests/test_multihost_runtime.py:275."""
    for k, v in INIT_ENV.items():
        monkeypatch.setenv(k, v)
    sentinel = object()
    with unittest.mock.patch.object(communication, "initialize", return_value=sentinel) as init:
        out = multihost.initialize_distributed(heartbeat=False, backend="gloo")
    assert out is sentinel
    assert init.call_args.kwargs == {
        "coordinator_address": "127.0.0.1:9999", "num_processes": 4, "process_id": 2, "backend": "gloo",
    }


def test_transient_connect_fault_is_retried(monkeypatch):
    """tests/test_multihost_runtime.py:293."""
    for k, v in INIT_ENV.items():
        monkeypatch.setenv(k, v)
    sentinel = object()
    retries0 = multihost.report_stats()["init_retries"]
    with unittest.mock.patch.object(communication, "initialize",
                                    side_effect=[ConnectionResetError("handshake"), sentinel]) as init:
        out = multihost.initialize_distributed(heartbeat=False, backoff_s=0.001)
    assert out is sentinel and init.call_count == 2
    assert multihost.report_stats()["init_retries"] == retries0 + 1


def test_injected_init_fault_exercises_the_retry_path(monkeypatch):
    """tests/test_multihost_runtime.py:310."""
    for k, v in INIT_ENV.items():
        monkeypatch.setenv(k, v)
    sentinel = object()
    with unittest.mock.patch.object(communication, "initialize", return_value=sentinel), \
            resilience.inject("multihost.init", exc=ConnectionResetError) as spec:
        out = multihost.initialize_distributed(heartbeat=False, backoff_s=0.001)
    assert out is sentinel and spec.fired == 1


def test_non_transient_fault_propagates_first_attempt(monkeypatch):
    """tests/test_multihost_runtime.py:321."""
    for k, v in INIT_ENV.items():
        monkeypatch.setenv(k, v)
    with unittest.mock.patch.object(communication, "initialize", side_effect=ValueError("bad mesh shape")) as init:
        with pytest.raises(ValueError):
            multihost.initialize_distributed(heartbeat=False, backoff_s=0.001)
    assert init.call_count == 1


@pytest.mark.parametrize("exc, transient", [
    (ConnectionRefusedError(), True),
    (RuntimeError("DEADLINE_EXCEEDED: coordination service"), True),
    (RuntimeError("duplicate task id"), False),
    (ValueError("nope"), False),
    # torch's words: the TCPStore's errors, gloo's and NCCL's messages
    (dist.DistNetworkError("The client socket has failed to connect to 127.0.0.1:9999"), True),
    (dist.DistStoreError("Timed out after 61 seconds waiting for clients. 1/2 clients joined."), True),
    (RuntimeError("[gloo/transport/tcp] Connection refused"), True),
    (RuntimeError("Socket Timeout"), True),
    (RuntimeError("Connection reset by peer"), True),
    (dist.DistBackendError("NCCL error: invalid usage, Duplicate GPU detected"), False),
    (OSError(28, "No space left on device"), False),
])
def test_transient_classifier(exc, transient):
    """tests/test_multihost_runtime.py:331, with the exception types of
    ``torch.distributed``."""
    assert multihost._transient_init_fault(exc, resilience.retry_policy) is transient


def test_initialize_without_a_coordinator_needs_a_world_of_one():
    with pytest.raises(ValueError, match="coordinator"):
        communication.initialize(num_processes=2, process_id=0, device="cpu")
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# the launcher's generation protocol (TestSpawnLocalProtocol), with the
# reference's stub workers, which import neither jax nor torch
# ---------------------------------------------------------------------------
_STUB_WORKER = r"""
import json, os, sys
rank = int(os.environ["HEAT_TPU_PROCESS_ID"])
epoch = int(os.environ["HEAT_TPU_MESH_EPOCH"])
world = int(os.environ["HEAT_TPU_NUM_PROCESSES"])
mesh = os.environ["HEAT_TPU_MESH_DIR"]
out = os.environ["STUB_OUT"]
with open(os.path.join(out, f"ran-{epoch}-{rank}"), "w") as fh:
    json.dump({"world": world, "epoch": epoch, "devices": os.environ["HEAT_TPU_TEST_DEVICES"],
               "coordinator": os.environ["HEAT_TPU_COORDINATOR"]}, fh)
if epoch == 0 and world > 1:
    # the casualty holds an exclusive lock until its exit closes it; the
    # survivors mark it lost only then, so the launcher never finds a
    # marked casualty still running
    import fcntl, time
    lock, ready = os.path.join(out, "casualty.lock"), os.path.join(out, "casualty.ready")
    if rank == world - 1:
        fd = os.open(lock, os.O_CREAT | os.O_RDWR)
        fcntl.flock(fd, fcntl.LOCK_EX)
        open(ready, "w").close()
        os._exit(9)  # the casualty
    while not os.path.exists(ready):
        time.sleep(0.01)
    fd = os.open(lock, os.O_CREAT | os.O_RDWR)
    fcntl.flock(fd, fcntl.LOCK_EX)
    fcntl.flock(fd, fcntl.LOCK_UN)
    lost = os.path.join(mesh, "lost", f"epoch-{epoch:04d}")
    os.makedirs(lost, exist_ok=True)
    with open(os.path.join(lost, f"proc-{world - 1:05d}"), "w") as fh:
        json.dump({"peer": world - 1, "by": rank}, fh)
    os._exit(77)
os._exit(0)
"""


def _spawn_stubs(n, **kwargs):
    with tempfile.TemporaryDirectory() as out:
        result = multihost.spawn_local(n, [sys.executable, "-c", _STUB_WORKER], env={"STUB_OUT": out},
                                       timeout_s=60.0, **kwargs)
        runs = {}
        for name in os.listdir(out):
            if name.startswith("ran-"):
                with open(os.path.join(out, name)) as fh:
                    runs[name[4:]] = json.load(fh)
        return result, runs


def test_clean_world_is_ok_without_reform():
    """tests/test_multihost_runtime.py:383."""
    result, runs = _spawn_stubs(1, devices_per_process=3)
    assert result["ok"] and result["reforms"] == 0
    assert runs["0-0"]["world"] == 1
    assert runs["0-0"]["devices"] == "3"  # the port's per-process device knob


def test_reform_reranks_survivors_under_next_epoch():
    """tests/test_multihost_runtime.py:389."""
    result, runs = _spawn_stubs(3, max_reforms=1)
    assert result["ok"] and result["reforms"] == 1
    gen0, gen1 = result["generations"]
    assert gen0["lost"] == [2] and gen0["exits"][2] == 9
    assert [gen0["world"], gen1["world"]] == [3, 2]
    assert [gen0["epoch"], gen1["epoch"]] == [0, 1]
    assert gen1["exits"] == [0, 0]
    assert sorted(runs) == ["0-0", "0-1", "0-2", "1-0", "1-1"]
    # a fresh coordinator port per generation
    assert runs["0-0"]["coordinator"] != runs["1-0"]["coordinator"]


_BEACON_WORKER = r"""
import json, os, time
rank = int(os.environ["HEAT_TPU_PROCESS_ID"])
path = os.path.join(os.environ["HEAT_TPU_MESH_DIR"], "progress", "epoch-0000", f"proc-{rank:05d}")
os.makedirs(os.path.dirname(path), exist_ok=True)
with open(path, "w") as fh:
    json.dump({"step": 2, "time": time.time()}, fh)
if rank == 1:
    time.sleep(60)
os._exit(0)
"""


def test_the_chaos_injector_kills_at_the_beacons_step():
    """spawn_local's ``kill={"rank", "at_step"}`` (the reference's
    process-level fault injector, tests/test_multiproc.py:152): rank 1
    beacons step 2 and would sleep a minute; the launcher kills it there.
    Nobody asked for reform, so the generation ends not ok."""
    result = multihost.spawn_local(2, [sys.executable, "-c", _BEACON_WORKER], kill={"rank": 1, "at_step": 2},
                                   timeout_s=60.0)
    (gen,) = result["generations"]
    assert not result["ok"] and result["t_kill"] is not None
    assert gen["exits"] == [0, -9] and gen["lost"] == [1] and gen["duration_s"] < 30.0


def test_exhausted_reform_budget_is_a_failure():
    """tests/test_multihost_runtime.py:403."""
    result, _ = _spawn_stubs(2, max_reforms=0)
    assert not result["ok"] and result["reforms"] == 0
    assert result["generations"][0]["lost"] == [1]


# ---------------------------------------------------------------------------
# observability (TestObservability)
# ---------------------------------------------------------------------------
MULTIHOST_KEYS = {
    "world", "epoch", "barriers", "barrier_timeouts", "abandoned_threads", "heartbeats", "heartbeat_errors",
    "init_retries", "peers_lost", "heartbeat_running", "abandoned_alive",
}


def test_report_joins_multihost_block():
    """tests/test_multihost_runtime.py:411: the reference's keys."""
    block = telemetry.report()["multihost"]
    assert set(block) == MULTIHOST_KEYS == set(ref_mh.report_stats())


def test_opsplane_exports_peer_gauges():
    """tests/test_multihost_runtime.py:424."""
    samples = {name: value for name, _, value in opsplane.collect()}
    assert "heat_tpu_peers_expected" in samples
    assert samples["heat_tpu_peers_lost"] == 0.0
    assert "heat_tpu_barrier_threads_abandoned" in samples


def test_lost_peer_flips_readyz():
    """tests/test_multihost_runtime.py:430."""
    assert opsplane.ready_status()["checks"]["peers"]
    with multihost._LOCK:
        multihost._LOST.add(1)
    try:
        status = opsplane.ready_status()
        assert not status["checks"]["peers"] and status["status"] == "unready"
        samples = {name: value for name, _, value in opsplane.collect()}
        assert samples["heat_tpu_peers_lost"] == 1.0
    finally:
        multihost.reset_peers()
    assert opsplane.ready_status()["checks"]["peers"]


# ---------------------------------------------------------------------------
# the seam's pure functions (tests/test_multihost_seam.py), held against
# the reference's on the same fake devices
# ---------------------------------------------------------------------------
ASSIGNMENT = [0, 0, 0, 0, 1, 1, 1, 1]


def _ranks(pairs):
    return [r for r, _ in pairs]


def test_ranks_to_read_partitions_by_process():
    """tests/test_multihost_seam.py:29."""
    devs = fake_devices(ASSIGNMENT)
    r0, r1 = multihost.ranks_to_read(devs, proc=0), multihost.ranks_to_read(devs, proc=1)
    assert _ranks(r0) == [0, 1, 2, 3] and _ranks(r1) == [4, 5, 6, 7]
    assert sorted(_ranks(r0) + _ranks(r1)) == list(range(8))
    for proc in (0, 1):
        assert multihost.ranks_to_read(devs, proc=proc) == ref_mh.ranks_to_read(devs, proc=proc)


def test_representative_rank_is_first_addressable():
    """tests/test_multihost_seam.py:40."""
    devs = fake_devices(ASSIGNMENT)
    assert multihost.representative_rank(devs, proc=0) == 0
    assert multihost.representative_rank(devs, proc=1) == 4
    for proc in (0, 1, 2):
        assert multihost.representative_rank(devs, proc=proc) == ref_mh.representative_rank(devs, proc=proc)


def test_interleaved_assignment():
    """tests/test_multihost_seam.py:45."""
    devs = fake_devices([0, 1, 0, 1])
    assert _ranks(multihost.ranks_to_read(devs, proc=1)) == [1, 3]
    assert multihost.representative_rank(devs, proc=1) == 1
    assert multihost.ranks_to_read(devs, proc=1) == ref_mh.ranks_to_read(devs, proc=1)


def test_devices_without_process_index_are_local():
    """tests/test_multihost_seam.py:51; the in-process mesh's placements
    are torch devices, which carry no process index."""
    devs = [types.SimpleNamespace(id=0), types.SimpleNamespace(id=1)]
    assert all(multihost.is_addressable(d, proc=0) for d in devs)
    assert len(multihost.ranks_to_read(devs, proc=0)) == 2
    comm = ht.get_comm()
    assert comm.placements == comm.devices
    assert _ranks(multihost.ranks_to_read(comm.placements, proc=1)) == list(range(comm.size))


def test_process_mesh_placements_name_their_processes():
    comm = communication.ProcessMeshCommunication([torch.device("cpu")] * 2, (3, 2, 1), 1, None, None)
    assert (comm.size, comm.first_rank, comm.spans_processes) == (6, 3, True)
    assert _ranks(multihost.ranks_to_read(comm.placements, proc=1)) == [3, 4]
    assert multihost.representative_rank(comm.placements, proc=1) == 3
    assert [p.process_index for p in comm.placements] == [0, 0, 0, 1, 1, 2]
    assert [p.device for p in comm.placements] == [None] * 3 + [torch.device("cpu")] * 2 + [None]
    assert ref_mh.ranks_to_read(comm.placements, proc=2) == multihost.ranks_to_read(comm.placements, proc=2)
    assert comm.chunk((12, 2), 0, rank=4) == (8, (2, 2), (slice(8, 10), slice(0, 2)))


# ---------------------------------------------------------------------------
# the seam's consumers (TestSeamConsumers) and the port's other seams
# ---------------------------------------------------------------------------
def test_sharded_ingest_routes_through_seam(tmp_path):
    """tests/test_multihost_seam.py:57, through the .npy loader (the
    reference's case needs h5py)."""
    p = ht.get_comm().size
    data = np.arange(4 * p * 3, dtype=np.float32).reshape(4 * p, 3)
    path = str(tmp_path / "x.npy")
    np.save(path, data)
    with unittest.mock.patch.object(multihost, "ranks_to_read", wraps=multihost.ranks_to_read) as spy:
        x = ht.load_npy(path, split=0)
    assert spy.called, "sharded ingest bypassed the multihost seam"
    np.testing.assert_array_equal(x.numpy(), data)


def test_sharded_ingest_reads_only_this_processes_blocks(tmp_path, monkeypatch):
    """The ranks the seam names are the only blocks read."""
    p = ht.get_comm().size
    if p < 2:
        pytest.skip("needs a mesh of at least 2")
    data = np.arange(2 * p * 3, dtype=np.float32).reshape(2 * p, 3)
    path = str(tmp_path / "x.npy")
    np.save(path, data)
    read = []
    real = multihost.ranks_to_read

    def spy(placements, proc=None):
        out = real(placements, proc)
        read.extend(r for r, _ in out)
        return out

    monkeypatch.setattr(multihost, "ranks_to_read", spy)
    ht.load_npy(path, split=0)
    assert read == list(range(p))


def test_lshape_reports_this_processes_shard(monkeypatch):
    """tests/test_multihost_seam.py:81: on one process the representative
    rank is 0's ceil chunk; with the seam naming another rank, lshape
    follows it, not rank 0."""
    p = ht.get_comm().size
    x = ht.ones((2 * p + 1, 3), split=0)
    assert x.lshape == (-(-(2 * p + 1) // p), 3)
    devs = fake_devices([0] * p + [1] * p)
    assert multihost.representative_rank(devs, proc=1) == p
    monkeypatch.setattr(multihost, "representative_rank", lambda placements, proc=None: p - 1)
    assert x.lshape == x.comm.chunk(x.shape, 0, rank=p - 1)[1]


def test_atomic_write_publishes_only_from_the_io_owner(tmp_path, monkeypatch):
    """reference resilience.py:773-840: every process writes a private
    temporary file (pid and process index in its name), only process 0
    renames, the others discard theirs."""
    target = tmp_path / "out.bin"
    monkeypatch.setattr(multihost, "process_index", lambda: 1)
    with resilience.atomic_write(str(target)) as tmp:
        assert tmp.endswith(f"-{os.getpid()}-1")
        with open(tmp, "wb") as fh:
            fh.write(b"peer")
    assert not target.exists() and os.listdir(tmp_path) == []
    monkeypatch.setattr(multihost, "process_index", lambda: 0)
    with resilience.atomic_write(str(target)) as tmp:
        with open(tmp, "wb") as fh:
            fh.write(b"owner")
    assert target.read_bytes() == b"owner" and os.listdir(tmp_path) == ["out.bin"]


def _several(monkeypatch, proc):
    """A world of two processes as the checkpoint sees it; the barriers'
    tags are recorded."""
    tags = []
    monkeypatch.setattr(multihost, "process_count", lambda: 2)
    monkeypatch.setattr(multihost, "process_index", lambda: proc)
    monkeypatch.setattr(multihost, "sync_processes", lambda tag, timeout_ms=None: tags.append(tag))
    return tags


def test_checkpoint_publishes_receipts_and_meets_at_both_barriers(tmp_path, monkeypatch):
    """heat_tpu/utils/checkpoint.py:486-650: the owner writes the payload
    and a receipt of its checksums, then the save barrier, the manifest,
    the commit barrier."""
    tags = _several(monkeypatch, 0)
    path = save_checkpoint(str(tmp_path), {"w": np.arange(3.0), "n": 4}, step=5)
    assert tags == ["heat_tpu.checkpoint.save.5", "heat_tpu.checkpoint.commit.5"]
    with open(tmp_path / "ckpt_5" / ".receipt-0.json") as fh:
        receipt = json.load(fh)
    with open(path) as fh:
        frag = json.load(fh)["leaves"][1]["files"][0]
    assert receipt == {frag["file"]: [frag["sha256"], frag["bytes"]]}
    assert checkpoint.verify_checkpoint(str(tmp_path), 5) == []


def test_checkpoint_peer_writes_nothing_but_its_receipt(tmp_path, monkeypatch):
    """A process other than the owner drops its stale receipt of a crashed
    attempt, writes no payload and no manifest, publishes its (empty)
    receipt and meets both barriers."""
    tags = _several(monkeypatch, 1)
    os.makedirs(tmp_path / "ckpt_6")
    with open(tmp_path / "ckpt_6" / ".receipt-1.json", "w") as fh:
        json.dump({"ckpt_6/leaf_00000.arr": ["stale", 1]}, fh)
    save_checkpoint(str(tmp_path), {"w": np.arange(3.0)}, step=6)
    assert tags == ["heat_tpu.checkpoint.save.6", "heat_tpu.checkpoint.commit.6"]
    assert sorted(os.listdir(tmp_path / "ckpt_6")) == [".receipt-1.json"]
    with open(tmp_path / "ckpt_6" / ".receipt-1.json") as fh:
        assert json.load(fh) == {}
    assert checkpoint.all_steps(str(tmp_path)) == []


def test_checkpoint_failure_is_raised_after_both_barriers(tmp_path, monkeypatch):
    """A local failure still meets both barriers, so no peer waits alone."""
    tags = _several(monkeypatch, 0)
    with pytest.raises(TypeError):
        save_checkpoint(str(tmp_path), {"bad": object()}, step=2)
    assert tags == ["heat_tpu.checkpoint.save.2", "heat_tpu.checkpoint.commit.2"]


def test_streaming_save_refuses_a_mesh_this_process_cannot_address(tmp_path):
    """heat_tpu/core/io.py:296-312."""

    class HalfMine(communication.MeshCommunication):
        @property
        def placements(self):
            return tuple(fake_devices([0, 1]))

    x = ht.array(np.arange(8.0).reshape(4, 2), split=0, comm=HalfMine([torch.device("cpu")] * 2))
    with pytest.raises(NotImplementedError, match="span processes"):
        list(io._shard_blocks(x))
    with pytest.raises(NotImplementedError, match="span processes"):
        ht.save_npy(x, str(tmp_path / "x.npy"))
    assert not (tmp_path / "x.npy").exists()


def test_trace_pid_is_the_process_index(monkeypatch):
    """heat_tpu/core/telemetry.py:1653-1658: each process's trace rows
    carry its process index."""
    monkeypatch.setattr(multihost, "process_index", lambda: 3)
    assert telemetry._host_index() == 3
    prev = telemetry.set_mode(2)
    try:
        ht.get_comm().allreduce([torch.ones(2)] * ht.get_comm().size)
        events = telemetry.export_trace()["traceEvents"]
    finally:
        telemetry.set_mode(prev)
        telemetry.reset()
    assert events and {ev["pid"] for ev in events} == {3}


# ---------------------------------------------------------------------------
# a mesh whose ranks span processes: the array, its factories and the ingest
# run on each process's own ranks, and so do sub-meshes and the layers above;
# the global device list and reform raise the named error (ROADMAP A11.5b(c2b))
# ---------------------------------------------------------------------------
def _spanning(process=0):
    return communication.ProcessMeshCommunication([torch.device("cpu")] * 2, (2, 2), process, None, None)


def _spanning_entries(comm, tmp_path):
    """The entries a user meets on a mesh whose ranks span processes, over
    an 8 x 2 table."""
    q = torch.zeros(1, 8, 4, 4)
    want = np.arange(16.0).reshape(8, 2)
    np.save(tmp_path / "x.npy", want)
    return want, {
        "DNDarray": lambda: ht.DNDarray([torch.tensor(want[4:6]), torch.tensor(want[6:])], (8, 2), ht.float64, 0,
                                        ht.cpu, comm),
        "factory": lambda: ht.array(want, split=0, comm=comm),
        "ingest": lambda: ht.load_npy(str(tmp_path / "x.npy"), split=0, comm=comm),
        "devices": lambda: comm.devices,
        "sub": lambda: comm.sub([0, 1]),
        "ring": lambda: ht.nn.ring_attention(q, q, q, comm=comm),
        "ulysses": lambda: ht.nn.ulysses_attention(q, q, q, comm=comm),
        "make_mesh": lambda: ht.parallel.make_mesh([("dp", 2), ("tp", 2)]) if ht.use_comm(comm) is None else None,
        "default mesh": lambda: ht.array(want, split=0) if ht.use_comm(comm) is None else None,
        "reform": lambda: _reform_over(comm),
        "pipeline backward": lambda: ht.parallel.pipeline_apply(
            lambda prm, a: a @ prm, torch.ones(4, 2, 2, requires_grad=True), torch.ones(8, 2), comm),
    }


def _reform_over(comm):
    """``reform`` with ``comm`` the default mesh, the default restored after."""
    ht.use_comm(comm)
    try:
        return communication.reform()
    finally:
        ht.use_comm(None)


@pytest.mark.parametrize("entry", ["devices", "reform", "pipeline backward"])
def test_layers_above_the_verbs_raise_the_named_error(entry, tmp_path):
    """The global device list, the re-formation of the mesh inside one
    process and a gradient through the pipeline still raise, naming
    A11.5b(c2b) (the pipeline's forward runs, as heat_tpu's tests run it)."""
    _, calls = _spanning_entries(_spanning(1), tmp_path)
    with pytest.raises(NotImplementedError, match=r"A11\.5b\(c2b\)"):
        calls[entry]()
    assert isinstance(communication.CrossProcessMeshError("x"), NotImplementedError)


def _fake_verbs(comm, monkeypatch):
    """Verbs for a mocked spanning mesh, which has no world: each records
    its call (verb, this process's shard count, the first shard's shape)
    and answers with blocks of the right shapes."""
    calls = []

    def fake(verb):
        def run(shards, *args, **kwargs):
            calls.append((verb, len(shards), tuple(shards[0].shape)))
            p = comm.size
            if verb == "allgather":
                return [torch.cat([shards[0]] * p, dim=kwargs.get("dim", 0))] * len(shards)
            if verb == "alltoall":
                split, concat = kwargs["split_axis"], kwargs["concat_axis"]
                return [torch.cat([s.tensor_split(p, dim=split)[0]] * p, dim=concat) for s in shards]
            return [torch.zeros_like(s) for s in shards]
        return run

    for verb in ("ppermute", "alltoall", "allgather"):
        monkeypatch.setattr(comm, verb, fake(verb))
    return calls


@pytest.mark.parametrize("entry", ["ring", "ulysses", "make_mesh"])
def test_the_layers_run_on_a_spanning_mesh(entry, tmp_path, monkeypatch):
    """Ring and Ulysses attention and ``make_mesh`` run on a mocked second
    process of a 2 x 2 world (tests/test_torch_spanning.py runs them on real
    worlds): the schedules hold this process's two ranks' blocks and call
    the verbs with them, in their schedules' counts; ``make_mesh`` lays out
    the ranks, and the 'tp' line this process runs is its own two ranks."""
    comm = _spanning(1)
    calls = _fake_verbs(comm, monkeypatch)
    _, entries = _spanning_entries(comm, tmp_path)
    try:
        got = entries[entry]()
    finally:
        ht.use_comm(None)
    if entry == "make_mesh":
        assert got.shape == {"dp": 2, "tp": 2} and got.comm is comm
        lines = got.comms("tp")
        assert isinstance(lines[0], communication.ForeignSubMesh) and lines[0].ranks == (0, 1)
        assert ht.parallel._mesh.axis_comm(got, "tp") is lines[1] and lines[1].size == 2
        assert calls == []
        return
    assert got.shape == (1, 8, 4, 4)
    block = (1, 2, 4, 4)
    if entry == "ring":  # p - 1 rotations of K and V, then the output joined
        assert calls == [("ppermute", 2, block)] * 6 + [("allgather", 2, block)]
    else:  # q, k, v to heads, the output (one head per rank) back, then joined
        assert calls == [("alltoall", 2, block)] * 3 + [("alltoall", 2, (1, 8, 1, 4)), ("allgather", 2, block)]


@pytest.mark.parametrize("entry", ["DNDarray", "factory", "ingest", "default mesh", "sub"])
def test_the_arrays_entries_run_on_a_spanning_mesh(entry, tmp_path):
    """A DNDarray, a factory, the ingest and the default mesh run on a
    mocked second process of a 2 x 2 world and hold its ranks 2 and 3;
    ``sub`` of the first process's ranks runs there too, and is the mesh of
    ranks this process does not hold."""
    comm = _spanning(1)
    want, calls = _spanning_entries(comm, tmp_path)
    x = calls[entry]()
    if entry == "sub":
        assert isinstance(x, communication.ForeignSubMesh) and x.size == 2 and list(x.local_ranks) == []
        with pytest.raises(ValueError, match=r"holds none of ranks \[0, 1\]"):
            x.allreduce([])
        assert comm.sub([0, 1]) is x
        return
    assert x.comm is comm and x.gshape == (8, 2) and x.split == 0 and x.lshape == (2, 2)
    assert [r for r, _ in x.ranked_shards()] == [2, 3] and len(x.shards) == 2
    assert np.array_equal(np.concatenate([b for _, b in x.ranked_shards()]), want[4:])


def test_a_world_of_one_process_is_the_in_process_mesh():
    comm = communication.ProcessMeshCommunication([torch.device("cpu")] * 3, (3,), 0, None, None)
    assert not comm.spans_processes and comm.devices == (torch.device("cpu"),) * 3
    x = ht.ones((7, 2), split=0, comm=comm)
    assert x.lshape == (3, 2) and x.comm is comm


@pytest.fixture
def world_of_one():
    """A real gloo world of this one process on a free port, its mesh the
    CPU repeated HEAT_TPU_TEST_DEVICES times; torn down after."""
    comm = multihost.initialize_distributed(device="cpu", heartbeat=False)
    try:
        yield comm
    finally:
        ht.use_comm(None)
        dist.destroy_process_group()
        communication._CONTROL = None


def test_a_world_of_one_records_and_fires_as_the_in_process_verbs(world_of_one):
    """Each verb across processes records itself (its op, the axis
    ``split``, one participant's bytes) and fires its ``collective.<verb>``
    site before it moves anything, as the in-process verbs do; its results
    are the in-process mesh's, bit for bit."""
    comm = world_of_one
    local = communication.MeshCommunication(list(comm.local_devices))
    assert ht.get_comm() is comm and comm.size == local.size and multihost.process_count() == 1
    assert dist.get_backend() == "gloo" and dist.get_backend(communication._control_group()) == "gloo"
    shards = [torch.arange(6.0).reshape(3, 2) + r for r in range(comm.size)]
    prev = telemetry.set_mode(1)
    telemetry.reset()
    try:
        got = comm.allreduce(shards)
        counts = telemetry.collective_counts()
        record = telemetry.report()["collectives"]["allreduce"]
    finally:
        telemetry.set_mode(prev)
        telemetry.reset()
    assert all(torch.equal(g, w) for g, w in zip(got, local.allreduce(shards)))
    assert counts.get("allreduce") == 1 and record["axes"] == {"split": 1} and record["bytes"] == 6 * 4
    with resilience.inject("collective.ppermute") as spec:
        with pytest.raises(resilience.FaultInjected):
            comm.ppermute(shards)
    assert spec.fired == 1
    assert [g.tolist() for g in comm.ppermute(shards)] == [g.tolist() for g in local.ppermute(shards)]
    multihost.sync_processes("a.world.of.one")  # the early out
