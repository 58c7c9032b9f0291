"""heat_tpu_torch.core.elastic (``ht.elastic``) and its seams against
heat_tpu's (tests/test_elastic.py), case by case. CPU only.

Where the reference's call runs here it is the oracle: the knobs, the
device ledger, ``elastic.run`` and the DASO kill-a-host loop run in both
packages on the same inputs, with the reference's recorder off (its
batching stops on ``jax.core.trace_state_clean`` in this jax). Where it
does not (its admission-hold and world-refresh cases force pending chains
through that batching), the port is held to numpy and to the counts the
reference case asserts, citing it.

Two divergences are kept and tested here:

* a device can hold several ranks of the port's meshes (the CPU mesh is the
  CPU repeated; four shards of a card are ``cuda:0`` four times), so a
  degraded device drops one rank, the last that it holds, where the
  reference drops every rank of that name (each of its devices holds one);
* a mesh whose ranks span processes is never re-formed inside one process:
  ``communication.reform`` raises ``CrossProcessMeshError`` there, and a
  lost peer process raises ``PeerLostError`` after a best-effort commit.
"""

from __future__ import annotations

import math
import signal as signal_mod
import threading
import time
import warnings
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import heat_tpu as ref
import heat_tpu_torch as ht
from heat_tpu.core import communication as ref_comm
from heat_tpu.core import elastic as ref_el
from heat_tpu.core import multihost as ref_mh
from heat_tpu.core import resilience as ref_res
from heat_tpu.core import telemetry as ref_tel
from heat_tpu_torch.core import communication, elastic, fusion, health_runtime, memledger, multihost, resilience, telemetry
from heat_tpu_torch.utils import checkpoint as ckpt
from heat_tpu_torch.utils.interop import mlp_from_flax, transformer_lm_from_flax
from test_torch_parity import P, on_cpu  # noqa: F401

SEED = 20261018
#: the DASO acceptance's bound (tests/test_elastic.py:494-495): float
#: association only, the merged replicas are exact while fully synced
KILL_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def hygiene(on_cpu):  # noqa: F811 - the harness's fixture, first
    """Exact counts under an ambient HEAT_TPU_FAULTS mix; both packages'
    supervisors and device ledgers clean, and the whole mesh back after
    each test (a reform installs the shrunk mesh as the default), as the
    reference's ``_elastic_hygiene`` (tests/test_elastic.py:40-58). Both
    recorders start with no live root: a drain forces every live root of
    its process, a pending chain an earlier test left alive included."""
    suspends = [resilience.suspended(), ref_res.suspended()]
    for s in suspends:
        s.__enter__()
    fusion.clear_cache()
    ref.fusion.clear_cache()
    for el, res in ((elastic, resilience), (ref_el, ref_res)):
        el.reset()
        el._PENDING = None
        res.reset_device_faults()
    try:
        yield
    finally:
        for el, res in ((elastic, resilience), (ref_el, ref_res)):
            el._PENDING = None
            res.reset_device_faults()
            el.reset()
        if ref_comm.get_comm().size != len(jax.devices()):
            ref_comm.reform()
        ht.use_comm(None)
        communication.reform()
        for s in reversed(suspends):
            s.__exit__(None, None, None)


def _needs_two():
    if P < 2:
        pytest.skip("needs a rank to lose")


# ---------------------------------------------------------------------------
# the barrier timeout (TestBarrierTimeout): the port's barrier is
# ``multihost._barrier`` over the gloo control group, patched here where the
# reference patches ``multihost_utils.sync_global_devices``
# ---------------------------------------------------------------------------
def test_single_process_never_touches_the_barrier():
    """tests/test_elastic.py:64."""
    with mock.patch.object(multihost, "_barrier") as spy:
        multihost.sync_processes("tag", timeout_ms=10)
    spy.assert_not_called()


def test_timeout_surfaces_stall_error_naming_the_tag():
    """tests/test_elastic.py:71."""
    release = threading.Event()
    try:
        with mock.patch.object(multihost, "process_count", return_value=2), \
             mock.patch.object(multihost, "_barrier", side_effect=lambda tag, timeout_ms: release.wait(3.0)):
            with pytest.raises(resilience.StallError, match="heat_tpu.checkpoint.save.7"):
                multihost.sync_processes("heat_tpu.checkpoint.save.7", timeout_ms=50)
    finally:
        release.set()


def test_fast_barrier_passes_under_timeout():
    """tests/test_elastic.py:86."""
    with mock.patch.object(multihost, "process_count", return_value=2), \
         mock.patch.object(multihost, "_barrier") as spy:
        multihost.sync_processes("quick", timeout_ms=5000)
    spy.assert_called_once_with("quick", 5000)


def test_worker_exception_is_reraised():
    """tests/test_elastic.py:94."""
    with mock.patch.object(multihost, "process_count", return_value=2), \
         mock.patch.object(multihost, "_barrier", side_effect=RuntimeError("peer exploded")):
        with pytest.raises(RuntimeError, match="peer exploded"):
            multihost.sync_processes("boom", timeout_ms=5000)


@pytest.mark.parametrize("raw", ["250", "off", "banana", "", "-3"])
def test_env_knob_parsing(raw, monkeypatch):
    """tests/test_elastic.py:106: both packages read the same value and warn
    alike."""
    monkeypatch.setenv("HEAT_TPU_BARRIER_TIMEOUT_MS", raw)
    got = []
    for mod in (multihost, ref_mh):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            got.append((mod._barrier_timeout_ms(), any("not a number" in str(w.message) for w in caught)))
    assert got[0] == got[1]
    assert got[0] == {"250": (250.0, False), "off": (None, False), "banana": (None, True), "": (None, False),
                      "-3": (None, False)}[raw]


def test_checkpoint_save_barrier_routes_through_timeout(tmp_path, monkeypatch):
    """tests/test_elastic.py:115: a peer dead during the save's barrier is a
    StallError naming the save's tag, not a hang."""
    release = threading.Event()
    monkeypatch.setenv("HEAT_TPU_BARRIER_TIMEOUT_MS", "50")
    try:
        with mock.patch.object(multihost, "process_count", return_value=2), \
             mock.patch.object(multihost, "_barrier", side_effect=lambda tag, timeout_ms: release.wait(3.0)):
            with pytest.raises(resilience.StallError, match="heat_tpu.checkpoint.save.0"):
                ckpt.save_checkpoint(str(tmp_path), {"x": np.ones(3)}, step=0)
    finally:
        release.set()


# ---------------------------------------------------------------------------
# quarantine escalation (TestQuarantineEscalation): the per-device ledger
# ---------------------------------------------------------------------------
def test_threshold_crossing_warns_and_degrades():
    """tests/test_elastic.py:133, the same calls in both packages."""
    seen = []
    for res in (resilience, ref_res):
        out = [res.note_device_fault("devA", site="collective.sum") for _ in range(2)]
        with pytest.warns(res.MeshDegradedWarning, match="devA"):
            out.append(res.note_device_fault("devA", site="collective.sum"))
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            out.append(res.note_device_fault("devA"))
        seen.append((out, res.degraded_devices(), res.device_fault_counts()))
    assert seen[0] == seen[1] == ([False, False, True, False], {"devA"}, {"devA": 4})


def test_true_negative_faults_spread_across_devices():
    """tests/test_elastic.py:147."""
    for res in (resilience, ref_res):
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            assert [res.note_device_fault(f"dev{i % 3}") for i in range(6)] == [False] * 6
        assert res.degraded_devices() == set()
        assert res.device_fault_counts() == {"dev0": 2, "dev1": 2, "dev2": 2}


def test_degradation_emits_telemetry_event():
    """tests/test_elastic.py:157."""
    prev = telemetry.set_mode(2)
    try:
        telemetry.reset()
        for _ in range(3):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                resilience.note_device_fault("devT", site="collective.bcast")
        evs = [e for e in telemetry.report()["events"] if e["kind"] == "mesh_degraded"]
        assert len(evs) == 1
        assert evs[0]["device"] == "devT" and evs[0]["site"] == "collective.bcast"
    finally:
        telemetry.set_mode(prev)
        telemetry.reset()


def test_real_devices_pinned_at_mesh_size():
    """tests/test_elastic.py:172: the ledger's keys are ``str(device)``."""
    target = communication.get_comm().devices[-1]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for _ in range(3):
            resilience.note_device_fault(target, site="collective.sum")
    assert resilience.degraded_devices() == {str(target)} == {"cpu"}
    resilience.reset_device_faults()
    assert resilience.degraded_devices() == set() and resilience.device_fault_counts() == {}


def test_supervisor_consumes_degradation_as_mesh_shrink(tmp_path):
    """tests/test_elastic.py:188, with the kept divergence: the CPU mesh is
    the CPU repeated, so the sick device's last rank goes and the mesh
    shrinks by one, as the reference's mesh of distinct devices does."""
    _needs_two()
    sup = elastic.Supervisor(str(tmp_path), install_signals=False)
    sick = sup.comm.devices[-1]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for _ in range(3):
            resilience.note_device_fault(sick, site="collective.sum")
    pre = sup.maybe_preempt()
    assert isinstance(pre, elastic.Preempted) and pre.devices == (sick,)
    assert sup.maybe_preempt() is None  # consumed
    new_comm = sup.reform(sick=pre.devices)
    assert new_comm.devices == (torch.device("cpu"),) * (P - 1)
    assert communication.get_comm() is new_comm and communication.get_comm().size == P - 1
    assert resilience.degraded_devices() == set()
    sup.close()


@pytest.mark.parametrize("sick, survivors", [
    (["cpu:0"], ["cpu:0", "cpu:1"]),  # cpu:0 holds ranks 0 and 2: rank 2 goes
    (["cpu:1"], ["cpu:0", "cpu:0"]),  # a device of one rank goes whole, as in the reference
    (["cpu:0", "cpu:1", "cpu:0"], ["cpu:0"]),  # each sick device once
])
def test_a_device_holding_several_ranks_drops_its_last(sick, survivors, tmp_path):
    """The kept divergence on a mesh of named devices, ranks
    ``[cpu:0, cpu:1, cpu:0]``: one rank per sick device, its last."""
    mesh = communication.MeshCommunication([torch.device(n) for n in ("cpu:0", "cpu:1", "cpu:0")])
    sup = elastic.Supervisor(str(tmp_path), comm=mesh, lose=1, install_signals=False)
    new_comm = sup.reform(sick=[torch.device(n) for n in sick])
    assert [str(d) for d in new_comm.devices] == survivors
    assert elastic.stats()["reforms"] == 1
    sup.close()


# ---------------------------------------------------------------------------
# the admission hold (TestAdmissionHold): the reference's chains stop on its
# batching here; the port is held to numpy and the reference's counts
# ---------------------------------------------------------------------------
def _chain():
    a = ht.array(np.arange(4 * P * 3, dtype=np.float32).reshape(4 * P, 3), split=0)
    a.larray  # the operand concrete: only the chain is pending
    return a, a + 1.0


def test_hold_refuses_new_dispatches_then_admits():
    """tests/test_elastic.py:221 (held + 1, the refused chain pending, then
    dispatched after the release)."""
    before = memledger.gate_stats()["held"]
    a, b = _chain()
    with memledger.admission_hold("test drain window"):
        assert memledger.hold_info() == "test drain window"
        with pytest.raises(memledger.MemoryBudgetExceeded, match="test drain window"):
            b.numpy()
    assert memledger.gate_stats()["held"] == before + 1
    assert memledger.hold_info() is None and fusion.is_deferred(b)
    np.testing.assert_array_equal(b.numpy(), a.numpy() + 1.0)


def test_gate_exempt_forces_pass_the_hold():
    """tests/test_elastic.py:234."""
    a, b = _chain()
    with memledger.admission_hold("drain in progress"):
        with memledger.gate_exempt():
            np.testing.assert_array_equal(b.numpy(), a.numpy() + 1.0)


def test_supervisor_drain_runs_under_hold(tmp_path):
    """tests/test_elastic.py:240: the drain is gate-exempt."""
    a, b = _chain()
    sup = elastic.Supervisor(str(tmp_path), install_signals=False)
    with memledger.admission_hold("preempted"):
        drained = sup.drain()
    assert drained >= 1 and elastic.stats()["drained_roots"] >= 1
    assert not fusion.is_deferred(b)
    np.testing.assert_array_equal(b.numpy(), a.numpy() + 1.0)
    sup.close()


# ---------------------------------------------------------------------------
# the world refresh (TestWorldRefresh)
# ---------------------------------------------------------------------------
def _warm_fusion():
    a = ht.array(np.ones((4 * P, 3), dtype=np.float32), split=0)
    float((a + 1.0).sum())
    assert len(fusion._PROGRAMS) > 0 and fusion._infer_cached.cache_info().currsize > 0


def test_reform_clears_fusion_and_program_caches():
    """tests/test_elastic.py:263: every mesh-keyed cache, the recorder's
    shape inference (the port's ``_apply_program``) among them."""
    _warm_fusion()
    prev = memledger.set_budget(0.5)
    try:
        assert memledger._resolve_budget() is not None and memledger._RESOLVED_BUDGET is not None
        communication.reform()
        assert len(fusion._PROGRAMS) == 0 and len(fusion._PROGRAM_INFO) == 0
        assert fusion._infer_cached.cache_info().currsize == 0
        assert fusion._infer_multi_cached.cache_info().currsize == 0
        assert memledger._RESOLVED_BUDGET is None
    finally:
        memledger.set_budget(*prev)


def test_reform_installs_shrunk_world_as_default():
    """tests/test_elastic.py:274."""
    _needs_two()
    full = communication.get_comm()
    comm = communication.reform(full.devices[: P - 1])
    assert communication.get_comm() is comm and comm.size == P - 1
    restored = communication.reform()
    assert restored.size == P and communication.get_comm() is restored


def test_arrays_keep_their_mesh_across_a_reform():
    """An array made before a reform stays on the old mesh and one made
    after is on the new; an operation between the two raises, it never
    reshards one of them."""
    _needs_two()
    a = ht.array(np.arange(4.0 * P), split=0)
    small = communication.reform(communication.get_comm().devices[: P - 1])
    b = ht.array(np.arange(4.0 * P), split=0)
    assert a.comm.size == P and b.comm is small
    np.testing.assert_array_equal((a * 2.0).numpy(), np.arange(4.0 * P) * 2.0)
    with pytest.raises(ValueError, match=f"different meshes \\({P} and {P - 1} shards\\)"):
        (a + b).numpy()


#: C19's three cases (ROADMAP Queue C): an array made on one mesh meets one
#: made after a reform, split against split, split against replicated, and
#: through matmul
C19_CASES = {
    "split_split": lambda pkg, old, new: old + new,
    "split_replicated": lambda pkg, old, new: old + pkg.array(np.arange(10.0)),
    "matmul": lambda pkg, old, new: pkg.matmul(old.reshape((10, 1)), new.reshape((1, 10))),
}


def _across_reform(pkg, reform, before, after):
    reform(before)
    old = pkg.array(np.arange(10.0), split=0) * 2.0
    reform(after)
    return old, pkg.array(np.arange(10.0), split=0) * 2.0


@pytest.mark.parametrize("meshes", [(5, 3), (3, 5)], ids=["5to3", "3to5"])
@pytest.mark.parametrize("case", sorted(C19_CASES))
def test_c19_an_operand_from_another_mesh_is_refused(case, meshes):
    """C19: an operation between arrays of two meshes raises ValueError
    naming both sizes, where the parent computed silently on the dead mesh
    or raised torch's size error. heat_tpu raises too ("Received
    incompatible devices for jitted computation"); in the 3-to-5 order its
    split+split case meets the padded shapes first and raises TypeError."""
    before, after = meshes
    old, new = _across_reform(ht, lambda n: communication.reform([torch.device("cpu")] * n), before, after)
    with pytest.raises(ValueError, match=f"different meshes \\({before} and {after} shards\\)"):
        C19_CASES[case](ht, old, new)
    if len(jax.devices()) >= max(meshes):
        ref_old, ref_new = _across_reform(ref, lambda n: ref_comm.reform(jax.devices()[:n]), before, after)
        expected = TypeError if (case, meshes) == ("split_split", (3, 5)) else ValueError
        with pytest.raises(expected):
            np.asarray(C19_CASES[case](ref, ref_old, ref_new).numpy())


def test_c19_meshes_on_the_same_devices_still_combine():
    """What C19 keeps: meshes compare by their device lists, so an array
    from before a reform onto the same devices (the autoscaler's recovery)
    combines with one made after, and a sub-mesh's arrays with each
    other."""
    devices = [torch.device("cpu")] * 3
    old, new = _across_reform(ht, communication.reform, devices, devices)
    assert old.comm is not new.comm
    np.testing.assert_array_equal((old + new).numpy(), np.arange(10.0) * 4.0)
    sub = communication.get_comm().sub([0, 1])
    a = ht.array(np.arange(6.0), split=0, comm=sub)
    np.testing.assert_array_equal(ht.matmul(a.reshape((6, 1)), a.reshape((1, 6))).numpy(), np.outer(np.arange(6.0), np.arange(6.0)))


def test_initialize_reentry_refreshes_mesh_keyed_state():
    """tests/test_elastic.py:282: bringing up a process world (here a real
    gloo world of this one process) drops the programs built over the
    earlier mesh."""
    import torch.distributed as dist

    _warm_fusion()
    comm = multihost.initialize_distributed(device="cpu", heartbeat=False)
    try:
        assert comm.size == P
        assert len(fusion._PROGRAMS) == 0 and fusion._infer_cached.cache_info().currsize == 0
    finally:
        ht.use_comm(None)
        dist.destroy_process_group()
        communication._CONTROL = None


def test_reform_on_a_spanning_mesh_raises(tmp_path):
    """The kept divergence: a mesh whose ranks span processes is re-formed
    by its launcher, never inside one process; the supervisor's reform
    raises the same."""
    spanning = communication.ProcessMeshCommunication([torch.device("cpu")] * 2, (2, 2), 0, None, None)
    ht.use_comm(spanning)
    with pytest.raises(communication.CrossProcessMeshError, match="REFORM_EXIT|launcher"):
        communication.reform()
    assert communication.get_comm() is spanning
    sup = elastic.Supervisor(str(tmp_path), comm=spanning, install_signals=False)
    with pytest.raises(communication.CrossProcessMeshError):
        sup.reform()
    sup.close()


# ---------------------------------------------------------------------------
# the supervisor (TestSupervisor)
# ---------------------------------------------------------------------------
def test_fault_site_triggers_preemption(tmp_path):
    """tests/test_elastic.py:305."""
    sup = elastic.Supervisor(str(tmp_path), install_signals=False)
    with resilience.inject("elastic.preempt"):
        pre = sup.maybe_preempt()
    assert isinstance(pre, elastic.Preempted) and "injected" in pre.reason
    assert sup.maybe_preempt() is None  # times=1
    sup.close()


def test_signal_hook_requests_preemption(tmp_path):
    """tests/test_elastic.py:314."""
    if threading.current_thread() is not threading.main_thread():
        pytest.skip("signal handlers need the main thread")
    prev_handler = signal_mod.getsignal(signal_mod.SIGTERM)
    sup = elastic.Supervisor(str(tmp_path), install_signals=True)
    try:
        assert sup.maybe_preempt() is None
        signal_mod.raise_signal(signal_mod.SIGTERM)
        pre = sup.maybe_preempt()
        assert isinstance(pre, elastic.Preempted) and "SIGTERM" in pre.reason
    finally:
        sup.close()
    assert signal_mod.getsignal(signal_mod.SIGTERM) is prev_handler


def test_replay_bounded_by_checkpoint_cadence(tmp_path):
    """tests/test_elastic.py:330 (restored step 3, 2 replayed, one
    preemption and one reform)."""
    state = ht.array(np.full((2 * P,), 3.0, dtype=np.float32), split=0)
    sup = elastic.Supervisor(str(tmp_path), checkpoint_every=3, lose=1, install_signals=False)
    sup.commit({"x": state}, 3)
    restored, restored_step = sup.handle(
        elastic.Preempted("test"), step=5, template_fn=lambda comm: {"x": elastic._retarget(state, comm)}
    )
    assert restored_step == 3
    st = elastic.stats()
    assert st["steps_replayed"] == 2 <= sup.checkpoint_every
    assert st["preemptions"] == 1 and st["reforms"] == 1
    assert restored["x"].comm is sup.comm and restored["x"].comm.size == max(1, P - 1)
    np.testing.assert_array_equal(restored["x"].numpy(), np.full((2 * P,), 3.0))
    sup.close()


def test_reforms_exhausted_raises_elastic_error(tmp_path):
    """tests/test_elastic.py:350."""
    sup = elastic.Supervisor(str(tmp_path), max_reforms=0, install_signals=False)
    sup.commit({"n": 1}, 0)
    with pytest.raises(elastic.ElasticError, match="max_reforms"):
        sup.handle(elastic.Preempted("again"), step=1)
    assert elastic.stats()["failed_reforms"] == 1
    sup.close()


def test_mesh1_reforms_in_place(tmp_path):
    """tests/test_elastic.py:358."""
    solo = communication.MeshCommunication([torch.device("cpu")])
    sup = elastic.Supervisor(str(tmp_path), lose=1, min_devices=1, comm=solo, install_signals=False)
    assert sup.reform().size == 1
    assert elastic.stats()["reforms"] == 1
    sup.close()


def test_no_verified_checkpoint_is_elastic_error(tmp_path):
    """tests/test_elastic.py:368."""
    sup = elastic.Supervisor(str(tmp_path), install_signals=False)
    with pytest.raises(elastic.ElasticError, match="verifies"):
        sup.handle(elastic.Preempted("nothing saved"), step=0)
    assert elastic.stats()["failed_reforms"] == 1
    sup.close()


@pytest.mark.parametrize("commit_fails", [False, True])
def test_lost_peer_commits_then_raises_peer_lost(commit_fails, tmp_path, monkeypatch):
    """The peer-loss branch (heat_tpu/core/elastic.py:441-472): drained,
    committed where it can be, counted, then ``PeerLostError`` naming the
    peers and the launcher's exit code; the mesh is not re-formed. While the
    peer stays declared lost the checkpoint refuses to save (its barrier
    cannot meet), so the commit fails and warns: the best effort."""
    lost = mock.patch.object(multihost, "lost_peers", lambda: frozenset({1}))
    lost.start()
    sup = elastic.Supervisor(str(tmp_path), install_signals=False)
    pre = sup.maybe_preempt()
    assert pre.peers == (1,) and sup.maybe_preempt() is None  # consumed
    if not commit_fails:
        lost.stop()  # the declaration cleared: the save goes through
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            with pytest.raises(multihost.PeerLostError, match=f"exit code {multihost.REFORM_EXIT}") as err:
                sup.handle(pre, step=4, get_state=lambda: {"w": np.arange(3.0)})
    finally:
        if commit_fails:
            lost.stop()
    assert err.value.peers == (1,)
    assert ckpt.all_steps(str(tmp_path)) == ([] if commit_fails else [4])
    assert any("post-loss checkpoint" in str(w.message) for w in caught) == commit_fails
    st = elastic.stats()
    assert (st["peer_losses"], st["preemptions"], st["reforms"], st["checkpoints"]) == (1, 1, 0, 0 if commit_fails else 1)
    assert communication.get_comm().size == P
    sup.close()


@pytest.mark.parametrize("raw", [None, "", "off", "SIGTERM", "term,usr1", "SIGTERM,SIGBOGUS", "hup, ,int"])
def test_signal_knob_parses_as_heat_tpus(raw, monkeypatch):
    """``HEAT_TPU_ELASTIC_SIGNALS`` (heat_tpu/core/elastic.py:150-176): the
    same signals and the same warnings."""
    if raw is None:
        monkeypatch.delenv("HEAT_TPU_ELASTIC_SIGNALS", raising=False)
    else:
        monkeypatch.setenv("HEAT_TPU_ELASTIC_SIGNALS", raw)
    got = []
    for el in (elastic, ref_el):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            got.append((el._parse_signals(), [str(w.message) for w in caught]))
    assert got[0] == got[1]


@pytest.mark.parametrize("raw", [None, "", "250", "0", "-5", "soon", "1e3"])
def test_drain_knob_parses_as_heat_tpus(raw, monkeypatch):
    """``HEAT_TPU_ELASTIC_DRAIN_MS`` (heat_tpu/core/elastic.py:179-195): a
    malformed value warns and keeps 10 s."""
    if raw is None:
        monkeypatch.delenv("HEAT_TPU_ELASTIC_DRAIN_MS", raising=False)
    else:
        monkeypatch.setenv("HEAT_TPU_ELASTIC_DRAIN_MS", raw)
    got = []
    for el in (elastic, ref_el):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            got.append((el._parse_drain_ms(), [str(w.message) for w in caught]))
    assert got[0] == got[1]


def test_probe_attributes_a_failing_device(tmp_path, monkeypatch):
    """``probe_devices`` (heat_tpu/core/elastic.py:198-208): a device whose
    probe fails is noted in the ledger and left out."""
    real = torch.ones

    def ones(*args, device=None, **kw):
        if str(device) == "cpu:1":
            raise RuntimeError("device lost")
        return real(*args, device=device, **kw)

    monkeypatch.setattr(torch, "ones", ones)
    devices = [torch.device(n) for n in ("cpu:0", "cpu:1", "cpu:2")]
    assert elastic.probe_devices(devices) == [devices[0], devices[2]]
    assert resilience.device_fault_counts() == {"cpu:1": 1}


# ---------------------------------------------------------------------------
# the generic driver (TestElasticRun), against heat_tpu's run
# ---------------------------------------------------------------------------
def _run_both(tmp_path, steps, inject):
    """The port's run and heat_tpu's on the same state; the counters
    without the timings. The port's recorder defers the state's ``s + 1``,
    so its drain forces one root where heat_tpu's (recorder off here)
    forces none: ``drained_roots`` is compared by the callers."""
    outs = []
    for name, mod, el, res in (("mine", ht, elastic, resilience), ("theirs", ref, ref_el, ref_res)):
        state = mod.zeros((4 * P,), split=0)
        directory = str(tmp_path / name)
        with res.inject("elastic.preempt", **inject) if inject else res.suspended():
            out = el.run(lambda s, step: s + 1.0, state, steps=steps, directory=directory, checkpoint_every=2,
                         max_reforms=2, lose=1, install_signals=False)
        st = el.stats()
        st.pop("downtime_ms")
        if st["last_reform"] is not None:
            st["last_reform"].pop("downtime_ms")
        outs.append((out.numpy(), out.comm.size, st, ckpt.all_steps(directory) if name == "mine" else None))
    return outs


def test_preempted_run_completes_with_correct_state(tmp_path):
    """tests/test_elastic.py:380, and the same run of heat_tpu's."""
    (mine, size, st, _), (theirs, their_size, their_st, _) = _run_both(tmp_path, 10, dict(every=4, times=1))
    np.testing.assert_array_equal(mine, np.full((4 * P,), 10.0))
    np.testing.assert_array_equal(mine, theirs)
    assert st["preemptions"] == 1 and st["reforms"] == 1 and st["steps_replayed"] <= 2
    assert size == their_size == max(1, P - 1) == st["last_reform"]["mesh"]
    assert (st.pop("drained_roots"), their_st.pop("drained_roots")) == (1, 0)
    assert st == their_st


def test_unpreempted_run_is_a_plain_loop(tmp_path):
    """tests/test_elastic.py:398."""
    (mine, size, st, steps), (theirs, _, their_st, _) = _run_both(tmp_path, 4, None)
    np.testing.assert_array_equal(mine, np.full((4 * P,), 4.0))
    np.testing.assert_array_equal(mine, theirs)
    assert st["preemptions"] == 0 and st["reforms"] == 0 and st == their_st and st["drained_roots"] == 0
    assert steps[-1] == 4 and size == P


# ---------------------------------------------------------------------------
# the kill-a-host acceptance (TestKillAHost), and DataParallel.fit
# ---------------------------------------------------------------------------
def _batch_size():
    """tests/test_elastic.py:417: divisible by the whole mesh and by the
    survivors, so each group's mean is the batch's gradient on both."""
    lose = P // 2
    lcm = math.lcm(P, max(1, P - lose))
    return lcm * max(1, 24 // lcm)


def _training_data(n):
    rng = np.random.default_rng(7)
    X = [rng.standard_normal((n, 6)).astype(np.float32) for _ in range(10)]
    y = [rng.integers(0, 4, n).astype(np.int32) for _ in range(10)]
    return list(zip(X, y))


def _nodes(size):
    return 2 if size % 2 == 0 and size > 1 else 1


def _ref_daso(seed, sample):
    daso = ref.optim.DASO(local_optimizer=ref.optim.SGD(0.05), total_epochs=4, warmup_epochs=0, cooldown_epochs=0,
                          nodes=_nodes(ref.get_comm().size), downcast_type=jnp.float32)
    daso.add_model(ref.nn.MLP(features=(8, 4)), seed, sample)
    return daso


def _daso(seed, sample, params=None):
    """tests/test_elastic.py:430's trainer (SGD 0.05, f32 wire, MLP (8, 4)),
    holding the weights of heat_tpu's trainer from the same seed."""
    if params is None:
        params = _ref_daso(seed, sample).params
    first = jax.tree_util.tree_map(lambda a: np.asarray(a)[0], params)["params"]
    daso = ht.optim.DASO(local_optimizer=ht.optim.SGD(0.05), total_epochs=4, warmup_epochs=0, cooldown_epochs=0,
                         nodes=_nodes(ht.get_comm().size), downcast_type=torch.float32)
    daso.add_model(mlp_from_flax(first, device="cpu"), seed, sample)
    return daso


def _logits(trainer, x):
    return trainer(x).detach().numpy()


def test_daso_survives_preemption_and_matches_uninterrupted(tmp_path):
    """tests/test_elastic.py:448: one injected reform, the shrunk mesh, the
    same model and losses as the uninterrupted run within 1e-5; and the
    same counts, events, mesh and losses as heat_tpu's elastic fit (within
    1e-5 of its losses: each package's own float association)."""
    batches = _training_data(_batch_size())
    probe = batches[0][0]
    ref_trainer = _ref_daso(0, probe[:2])
    params = ref_trainer.params
    plain = _daso(0, probe[:2], params)
    plain_losses = [plain.step(x, y) for x, y in batches]
    plain_logits = _logits(plain, probe)
    communication.reform()

    results = {}
    for name, el, tel, res, trainer in (
        ("mine", elastic, telemetry, resilience, _daso(0, probe[:2], params)),
        ("theirs", ref_el, ref_tel, ref_res, ref_trainer),
    ):
        prev = tel.set_mode(2)
        try:
            tel.reset()
            el.reset()
            with res.inject("elastic.preempt", every=6, times=1):
                out = el.fit(trainer, batches, directory=str(tmp_path / name), checkpoint_every=3, max_reforms=2,
                             lose=P // 2, install_signals=False)
            doc = tel.report()
            kinds = [e["kind"] for e in doc["events"] if str(e["kind"]).startswith("elastic")]
        finally:
            tel.set_mode(prev)
            tel.reset()
        results[name] = (out, doc["elastic"], kinds, trainer)
    out, block, kinds, trainer = results["mine"]
    assert block["reforms"] == block["preemptions"] == out["elastic"]["reforms"] == 1
    assert out["elastic"]["steps_replayed"] <= 3
    assert "elastic_preempt" in kinds and "elastic_reformed" in kinds
    assert trainer.comm.size == max(1, P - P // 2) and out["steps"] == len(batches)
    np.testing.assert_allclose(_logits(trainer, probe), plain_logits, **KILL_TOL)
    np.testing.assert_allclose(out["losses"], plain_losses, **KILL_TOL)
    their_out, their_block, their_kinds, their_trainer = results["theirs"]
    strip = lambda st: {k: v for k, v in st.items() if k not in ("downtime_ms", "last_reform")}  # noqa: E731
    assert strip(out["elastic"]) == strip(their_out["elastic"]) and kinds == their_kinds
    assert {k: v for k, v in out["elastic"]["last_reform"].items() if k != "downtime_ms"} == {
        k: v for k, v in their_out["elastic"]["last_reform"].items() if k != "downtime_ms"}
    assert trainer.comm.size == their_trainer.comm.size and out["steps"] == their_out["steps"]
    np.testing.assert_allclose(out["losses"], their_out["losses"], **KILL_TOL)


def test_elastic_state_dict_round_trips_across_mesh_shapes(tmp_path):
    """tests/test_elastic.py:498: the merged state onto a shrunk mesh."""
    _needs_two()
    batches = _training_data(_batch_size())
    probe = batches[0][0]
    daso = _daso(1, probe[:2])
    for x, y in batches[:3]:
        daso.step(x, y)
    logits = _logits(daso, probe)
    ckpt.save_checkpoint(str(tmp_path), daso.elastic_state_dict(), step=3)
    small = communication.reform(communication.get_comm().devices[: P - P // 2])
    shrunk = _daso(1, probe[:2])
    assert shrunk.comm.size == small.size == P - P // 2
    sd = ckpt.load_checkpoint(str(tmp_path), shrunk.elastic_state_dict(), step=3)
    shrunk.load_elastic_state_dict(sd)
    np.testing.assert_allclose(_logits(shrunk, probe), logits, rtol=1e-6, atol=1e-6)


def test_rebind_preserves_the_live_model():
    """tests/test_elastic.py:518."""
    _needs_two()
    batches = _training_data(_batch_size())
    probe = batches[0][0]
    daso = _daso(2, probe[:2])
    for x, y in batches[:2]:
        daso.step(x, y)
    logits = _logits(daso, probe)
    new_comm = communication.reform(communication.get_comm().devices[: P - P // 2])
    daso.rebind(new_comm)
    assert daso.comm is new_comm
    np.testing.assert_allclose(_logits(daso, probe), logits, rtol=1e-6, atol=1e-6)
    daso.step(*batches[2])  # training goes on on the shrunk mesh


LM = dict(vocab=23, dim=16, depth=2, heads=2, max_len=16)
LM_STEPS = 6


def _shift_loss(logits, labels):
    return F.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]), labels[:, 1:].reshape(-1).long())


def _shift_loss_flax(logits, labels):
    return optax.softmax_cross_entropy_with_integer_labels(logits[:, :-1], labels[:, 1:]).mean()


def test_data_parallel_fit_transformer_lm_matches_uninterrupted(tmp_path):
    """``DataParallel.fit`` (heat_tpu/nn/data_parallel.py:236-241) on a
    two-layer TransformerLM with Adam, preempted at step 4 and re-formed
    onto half the mesh: its losses, its logits on a probe batch and its
    weights are the uninterrupted run's within 1e-5 (the gradient's sum over
    fewer shards is the only difference: float association), and its first
    losses equal heat_tpu's DataParallel from the same weights within 1e-4
    (two frameworks' float32).

    The attention's key biases are left out of the weights' check: a key
    bias adds the same amount to every score of a query's row, which the
    softmax ignores, so its gradient is rounding noise, and Adam scales that
    noise to its rate whatever its size. The logits check holds what they
    do (nothing)."""
    batch = 2 * math.lcm(P, max(1, P - P // 2))
    rng = np.random.default_rng(SEED)
    batches = [(t, t) for t in (rng.integers(0, LM["vocab"], (batch, 12)).astype(np.int32) for _ in range(LM_STEPS))]
    theirs = ref.nn.DataParallel(ref.nn.TransformerLM(**LM), optimizer=optax.adam(1e-2), loss_fn=_shift_loss_flax)
    theirs.init(0, batches[0][0][:2])
    params = jax.tree_util.tree_map(np.asarray, theirs.params["params"])

    def trainer():
        dp = ht.nn.DataParallel(transformer_lm_from_flax(params, device="cpu"), optimizer=ht.optim.Adam(1e-2),
                                loss_fn=_shift_loss)
        return dp.init(0, batches[0][0][:2])

    plain = trainer()
    plain_losses = [plain.train_step(x, y) for x, y in batches]
    their_losses = [float(theirs.train_step(x, y)) for x, y in batches[:2]]
    dp = trainer()
    with resilience.inject("elastic.preempt", every=5, times=1):
        out = dp.fit(batches, directory=str(tmp_path), checkpoint_every=3, lose=P // 2, install_signals=False)
    assert out["steps"] == LM_STEPS and out["elastic"]["reforms"] == 1 and out["elastic"]["steps_replayed"] <= 3
    assert dp.comm.size == communication.get_comm().size == max(1, P - P // 2) and len(dp.replicas) == dp.comm.size
    np.testing.assert_allclose(out["losses"], plain_losses, **KILL_TOL)
    np.testing.assert_allclose(plain_losses[:2], their_losses, rtol=1e-4)
    probe = torch.from_numpy(batches[0][0])
    np.testing.assert_allclose(dp(probe).detach().numpy(), plain(probe).detach().numpy(), **KILL_TOL)
    held = 0
    for (name, got), want in zip(dp.module.state_dict().items(), plain.module.state_dict().values()):
        if not name.endswith("attn.key.bias"):
            np.testing.assert_allclose(got.numpy(), want.numpy(), **KILL_TOL, err_msg=name)
            held += 1
    assert held == len(plain.module.state_dict()) - LM["depth"]


def test_the_surface_is_the_references():
    """``ht.elastic``, ``ht.autoscale``, ``ht.reform``, the health layer's
    reads and ``DataParallel.fit``, as heat_tpu exports them
    (heat_tpu/__init__.py:15, :21; heat_tpu/core/__init__.py:27)."""
    from heat_tpu.core import autoscale as ref_as
    from heat_tpu_torch.core import autoscale

    assert ht.elastic is elastic and ht.core.elastic is elastic and ht.autoscale is autoscale
    assert sorted(elastic.__all__) == sorted(ref_el.__all__) and sorted(autoscale.__all__) == sorted(ref_as.__all__)
    assert all(hasattr(elastic, n) for n in elastic.__all__) and all(hasattr(autoscale, n) for n in autoscale.__all__)
    assert ht.reform is communication.reform and hasattr(ref, "reform")
    assert "reform" in communication.__all__ and "reform" in ref_comm.__all__
    for name in ("breach_fraction", "reset_guards"):
        assert name in health_runtime.__all__ and getattr(ht.flight, name) is getattr(health_runtime, name)
    assert callable(ht.nn.DataParallel.fit) and callable(ht.nn.DataParallelMultiGPU.fit)
