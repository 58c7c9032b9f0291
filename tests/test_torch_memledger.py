"""heat_tpu_torch.core.memledger against heat_tpu's (tests/test_memory_obs.py).
CPU only.

The same arrays, made from a seed with numpy, go into both packages at
meshes 1, 3 and 5 (capped at the JAX CPU mesh's size). Bytes are integers
and are compared exactly:

* ``by_owner["dndarray"]`` grows by the same bytes in both packages for
  splits 0 and 1, ragged shapes included (the pad+mask shards);
* a replicated array (``split=None``) counts once per storage in the port:
  the CPU mesh repeats one device, so its shards are one tensor, where the
  reference holds one buffer per device (the kept divergence);
* a sharded ingest's staged shards count under ``io``, or ``checkpoint``
  inside the restore's owner scope, at the same block reads in both
  packages, and the array that wraps them claims them afterwards;
* the memory verb of both command lines prints the same text from the same
  report file.
"""

from __future__ import annotations

import gc
import importlib
import io as pyio
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import heat_tpu as ref
import heat_tpu_torch as ht
from heat_tpu.core import io as ref_io
from heat_tpu.core import memledger as ref_ml
from heat_tpu.core import telemetry as ref_tel
from heat_tpu.core.communication import MeshCommunication as RefMesh
from heat_tpu_torch.core import io as port_io
from heat_tpu_torch.core import memledger as ml
from heat_tpu_torch.core import telemetry as tel
from heat_tpu_torch.core.communication import MeshCommunication
from test_torch_parity import eager_engines, on_cpu  # noqa: F401

# every test here holds the eager engines' accounting against heat_tpu's
pytestmark = pytest.mark.usefixtures("eager_engines")

cli = importlib.import_module("heat_tpu_torch.telemetry")
ref_cli = importlib.import_module("heat_tpu.telemetry")

SEED = 20261017
MESHES = [1, 3, 5]
SHAPES = [(10, 4), (9, 7), (3, 11)]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def clean_ledgers():
    """Both packages with a zero watermark and telemetry off; the
    reference's budget disarmed for the test."""
    prev_budget = ref_ml.set_budget(None)
    was = tel.set_mode(0), ref_tel.set_mode(0)
    tel.reset()
    ref_tel.reset()
    yield
    tel.set_mode(was[0])
    ref_tel.set_mode(was[1])
    tel.reset()
    ref_tel.reset()
    ref_ml.set_budget(prev_budget[0], prev_budget[1])


def _pair(p):
    p = min(p, len(jax.devices()))
    return MeshCommunication([torch.device("cpu")] * p), RefMesh(jax.devices()[:p])


def _owned(module, owner="dndarray"):
    gc.collect()
    return module.ledger()["by_owner"].get(owner, 0)


def _grown(module, make, owner="dndarray"):
    """The bytes under ``owner`` that ``make()`` added, and its result."""
    before = _owned(module, owner)
    out = make()
    return _owned(module, owner) - before, out


# ---------------------------------------------------------------------------
# attribution (TestLedgerAttribution)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("p", MESHES)
def test_dndarray_bytes_match_the_reference(p, shape, split):
    mine_comm, ref_comm = _pair(p)
    p = mine_comm.size
    v = np.random.default_rng(SEED).standard_normal(shape).astype(np.float32)
    mine, x = _grown(ml, lambda: ht.array(v, split=split, comm=mine_comm))
    theirs, y = _grown(ref_ml, lambda: ref.array(v, split=split, comm=ref_comm))
    # the port's bytes are its shards' storages, each once
    storages = {s.untyped_storage().data_ptr(): s.untyped_storage().nbytes() for s in x.shards}
    assert mine == sum(storages.values())
    if split is None:
        # kept divergence: one tensor for the p shards of the CPU mesh, one
        # buffer per device in the reference
        assert len(storages) == 1 and mine * p == theirs
    else:
        assert mine == theirs
        block = -(-shape[split] // p)
        assert mine == block * p * (v.size // shape[split]) * 4
    del x, y


def test_foreign_tensor_is_unattributed():
    keep = torch.ones((64, 8))  # noqa: F841 - held live for the ledger
    keep_ref = jax.device_put(np.ones((64, 8), dtype=np.float32))  # noqa: F841
    for module in (ml, ref_ml):
        assert module.ledger()["by_owner"].get("unattributed", 0) >= 64 * 8 * 4


def test_owner_scope_tags_default():
    arr, ref_arr = torch.zeros(4), jax.device_put(np.zeros((4,), dtype=np.float32))
    for module, a in ((ml, arr), (ref_ml, ref_arr)):
        with module.owner_scope("checkpoint"):
            assert module.current_owner() == "checkpoint"
            with module.owner_scope("io"):
                assert module.current_owner() == "io"
            module.tag(a)
        assert module.current_owner() is None
        assert module._owner_of(a) == "checkpoint"
    assert ml._owner_of(torch.zeros(4)) == ml.UNATTRIBUTED
    ml.tag(np.zeros(3), "io")  # nothing device-side to track: a no-op


def test_registry_entries_die_with_their_tensors():
    t = torch.zeros(16)
    ml.tag(t, "io")
    key = id(t)
    assert key in ml._REGISTRY
    del t
    gc.collect()
    assert key not in ml._REGISTRY


def test_ledger_shape_and_top():
    comm, _ = _pair(3)
    xs = [ht.array(np.ones((n, 8), np.float32), split=0, comm=comm) for n in (30, 60, 90)]
    led = ml.ledger(top=3)
    assert set(led) == {"total_bytes", "by_owner", "buffers", "top", "per_device"}
    assert len(led["top"]) == 3
    tops = [rec["nbytes"] for rec in led["top"]]
    assert tops == sorted(tops, reverse=True)
    for rec in led["top"]:
        assert set(rec) == {"nbytes", "owner", "shape", "dtype", "device"}
    assert led["total_bytes"] == sum(led["by_owner"].values()) == sum(led["per_device"].values())
    assert led["by_owner"]["dndarray"] >= sum(x.nbytes for x in xs)
    assert ml.ledger(top=0)["top"] == []


def test_views_and_the_one_shard_share_a_buffer():
    comm, _ = _pair(1)
    x = ht.array(np.arange(24, dtype=np.float32).reshape(6, 4), split=0, comm=comm)
    before = ml.ledger()
    views = [x.parray, x.larray, x.shards[0].narrow(0, 1, 3), x.parray.view(-1)]
    ml.tag(views[2])  # an untagged view of a dndarray storage
    after = ml.ledger()
    assert views[0] is x.shards[0]
    assert after["by_owner"] == before["by_owner"] and after["buffers"] == before["buffers"]


def test_attributed_owners_claim_a_shared_storage_first():
    base = torch.zeros(100)
    view = base[10:]
    ml.tag(view)  # unattributed, and tagged first
    before = ml.ledger()["by_owner"]
    ml.tag(base, "io")
    after = ml.ledger()["by_owner"]
    assert after.get("io", 0) - before.get("io", 0) == 400
    assert before.get("unattributed", 0) - after.get("unattributed", 0) == 400


# ---------------------------------------------------------------------------
# the ingest and checkpoint staging
# ---------------------------------------------------------------------------
def _staged(module, ingest, v, split, comm, scope=None):
    """The ``io`` and ``checkpoint`` bytes of the ledger at each block read
    of a sharded ingest of ``v``, and the ingested array."""
    seen = []

    def read_block(sl):
        by_owner = module.ledger()["by_owner"]
        seen.append((by_owner.get("io", 0), by_owner.get("checkpoint", 0)))
        return v[sl]

    def run():
        return ingest(read_block, v.shape, ref.float32 if module is ref_ml else ht.float32, split, None, comm)

    if scope is None:
        return seen, run()
    with module.owner_scope(scope):
        return seen, run()


@pytest.mark.parametrize("scope", [None, "checkpoint"])
@pytest.mark.parametrize("split", [0, 1])
@pytest.mark.parametrize("p", MESHES)
def test_ingest_staging_is_attributed_as_the_reference(p, split, scope):
    mine_comm, ref_comm = _pair(p)
    v = np.random.default_rng(SEED).standard_normal((11, 7)).astype(np.float32)
    mine, x = _staged(ml, port_io._ingest, v, split, mine_comm, scope)
    theirs, y = _staged(ref_ml, ref_io._sharded_ingest, v, split, ref_comm, scope)
    assert mine == theirs
    owner = 1 if scope == "checkpoint" else 0
    if mine_comm.size > 1:
        assert mine[1][owner] > 0  # the first staged shard, before its array
    gc.collect()
    for module in (ml, ref_ml):  # the arrays claimed their staged shards
        assert module.ledger()["by_owner"].get("io", 0) == module.ledger()["by_owner"].get("checkpoint", 0) == 0
    assert np.array_equal(x.numpy(), y.numpy())


def test_restore_and_npy_load_ingest_under_their_owners(tmp_path, monkeypatch):
    comm, ref_comm = _pair(3)
    v = np.random.default_rng(SEED).standard_normal((10, 3)).astype(np.float32)
    owners = {"port": [], "reference": []}

    def spy(module, name, key, own):
        inner = getattr(module, name)

        def wrapped(*args, **kwargs):
            owners[key].append(own.current_owner() or "io")
            return inner(*args, **kwargs)

        monkeypatch.setattr(module, name, wrapped)

    spy(port_io, "_ingest", "port", ml)
    spy(ref_io, "_sharded_ingest", "reference", ref_ml)
    x, y = ht.array(v, split=0, comm=comm), ref.array(v, split=0, comm=ref_comm)
    ht.checkpoint.save_checkpoint(str(tmp_path / "port"), {"x": x}, step=1)
    ref.checkpoint.save_checkpoint(str(tmp_path / "ref"), {"x": y}, step=1)
    got = ht.checkpoint.load_checkpoint(str(tmp_path / "port"), {"x": x})["x"]
    ref_got = ref.checkpoint.load_checkpoint(str(tmp_path / "ref"), {"x": y})["x"]
    np.save(tmp_path / "v.npy", v)
    ht.load_npy(str(tmp_path / "v.npy"), split=0, comm=comm)
    ref.load_npy(str(tmp_path / "v.npy"), split=0, comm=ref_comm)
    assert owners["port"] == owners["reference"] == ["checkpoint", "io"]
    assert np.array_equal(got.numpy(), ref_got.numpy())


# ---------------------------------------------------------------------------
# the watermark (TestWatermark)
# ---------------------------------------------------------------------------
def test_watermark_tracks_live_bytes():
    comm, _ = _pair(3)
    with tel.enabled():
        a = ht.array(np.ones((48, 3), np.float32), split=0, comm=comm)
        float(ht.sum(a * 2.0).item())
        ml.sample("test", force=True)
    wm = ml.watermark()
    assert wm["bytes"] >= a.nbytes
    assert wm["by_owner"].get("dndarray", 0) >= a.nbytes
    assert wm["samples"] > 0 and wm["event"] is not None


def test_watermark_in_report_memory_block():
    a = ht.array(np.ones((12, 3), np.float32), split=0)  # noqa: F841 - on the default mesh
    ml.sample("test", force=True)
    mem = tel.report()["memory"]
    for key in ("device", "host", "ledger", "watermark", "live_buffers"):
        assert key in mem
    assert mem["budget"]["budget"] is None and "last_oom" not in mem  # the gate disarmed, no OOM seen
    assert mem["ledger"]["by_owner"].get("dndarray", 0) >= 12 * 3 * 4
    assert mem["watermark"]["bytes"] >= 12 * 3 * 4
    assert mem["live_buffers"]["total_bytes"] == mem["ledger"]["total_bytes"]


def test_reset_watermark():
    ml.tag(torch.ones(8), "io")
    ml.sample("test", force=True)
    ml.reset_watermark()
    wm = ml.watermark()
    assert (wm["bytes"], wm["samples"], wm["event"], wm["by_owner"]) == (0, 0, None, {})


def test_nonforced_samples_throttle():
    prev = ml.set_enabled(True)
    try:
        ml.sample("warmup", force=True)  # stamps the throttle clock
        assert ml.sample("immediately-after") is None
        ml.set_enabled(False)
        assert ml.sample("disabled") is None
        assert ml.sample("forced", force=True) is not None
    finally:
        ml.set_enabled(prev)


def test_disabled_hook_takes_no_sample(monkeypatch):
    prev = ml.set_enabled(False)
    try:
        monkeypatch.setattr(ml, "sample", lambda *a, **k: pytest.fail("sampled while disabled"))
        with tel.enabled():
            ht.sum(ht.array(np.ones(9, np.float32), split=0, comm=_pair(3)[0])).item()
    finally:
        ml.set_enabled(prev)


def test_telemetry_seams_sample_without_walking_the_heap(monkeypatch):
    monkeypatch.setattr(ml, "_SAMPLE_EVERY_S", 0.0)
    monkeypatch.setattr(ml.gc, "get_objects", lambda: pytest.fail("a sample walked the heap"))
    comm, _ = _pair(3)
    with tel.enabled():
        x = ht.array(np.ones((9, 2), np.float32), split=0, comm=comm)
        ht.sum(x, axis=0)  # a dispatch and a collective
        tel.record_checkpoint("save", 1)
        ml.sample("forced", force=True)
    wm = ml.watermark()
    assert wm["samples"] >= 3 and wm["bytes"] >= x.nbytes


def test_telemetry_reset_clears_both_modules_session_state():
    from heat_tpu_torch.core import health_runtime

    with tel.enabled():
        ml.tag(torch.ones(8), "io")
        ml.sample("test", force=True)
        tel.record_event("io", op="x")
    assert ml.watermark()["samples"] and health_runtime.flight_events()
    tel.reset()
    assert ml.watermark()["samples"] == 0 and ml.watermark()["bytes"] == 0
    assert health_runtime.flight_events() == []


# ---------------------------------------------------------------------------
# the Perfetto counter tracks (TestPerfettoCounterTracks)
# ---------------------------------------------------------------------------
def test_memory_events_export_as_counter_tracks(tmp_path):
    comm, _ = _pair(3)
    with tel.enabled(2):
        a = ht.array(np.ones((12, 3), np.float32), split=0, comm=comm)  # noqa: F841
        ml.sample("test", force=True)
        path = str(tmp_path / "trace.json")
        doc = tel.export_trace(path)
    counters = [ev for ev in doc["traceEvents"] if ev.get("ph") == "C"]
    names = {ev["name"] for ev in counters}
    assert names == {"live_bytes", "live_bytes_watermark"}
    live = next(ev for ev in counters if ev["name"] == "live_bytes")
    assert live["args"]["total"] >= 12 * 3 * 4 and live["args"]["dndarray"] >= 12 * 3 * 4
    assert tel.validate_trace(path) == [] and ref_tel.validate_trace(path) == []


# ---------------------------------------------------------------------------
# the command line (TestMemoryCLI)
# ---------------------------------------------------------------------------
def _run(module, argv):
    out = pyio.StringIO()
    assert module.main(argv, out=out) == 0
    return out.getvalue()


@pytest.mark.parametrize("source", ["port", "reference"])
def test_memory_verb_prints_the_references_text(source, tmp_path):
    comm, ref_comm = _pair(3)
    v = np.ones((12, 3), np.float32)
    x, y = ht.array(v, split=0, comm=comm), ref.array(v, split=0, comm=ref_comm)  # noqa: F841
    path = str(tmp_path / "report.json")
    if source == "port":
        ml.sample("test", force=True)
        tel.report_json(path)
    else:
        ref.get_comm()  # the reference reads its ledger once its mesh exists
        ref_ml.sample("test", force=True)
        doc = json.loads(ref_tel.report_json())
        for key in ("budget", "last_oom"):  # the admission gate's, later
            doc["memory"].pop(key, None)
        doc.pop("programs", None)
        with open(path, "w") as fh:
            json.dump(doc, fh)
    text = _run(cli, ["memory", path])
    assert text == _run(ref_cli, ["memory", path])
    assert "live:" in text and "watermark:" in text and "dndarray" in text
    assert json.loads(_run(cli, ["memory", path, "--json"]))["memory"] == json.load(open(path))["memory"]


def test_memory_verb_live():
    comm, _ = _pair(3)
    x = ht.array(np.ones((12, 3), np.float32), split=0, comm=comm)  # noqa: F841
    doc = json.loads(_run(cli, ["memory", "--json", "--top", "2"]))
    assert doc["source"] == "<live>"
    assert doc["memory"]["ledger"]["by_owner"]["dndarray"] >= 12 * 3 * 4
    assert len(doc["memory"]["ledger"]["top"]) <= 2
    assert "dndarray" in _run(cli, ["memory"])


# ---------------------------------------------------------------------------
# the contract: no surface initializes CUDA
# ---------------------------------------------------------------------------
def test_no_surface_initializes_cuda():
    code = (
        "import torch, heat_tpu_torch as ht\n"
        "from heat_tpu_torch.core import memledger, telemetry\n"
        "telemetry.set_mode(2)\n"
        "memledger.ledger(); memledger.sample('x', force=True); memledger.watermark()\n"
        "telemetry.report(); ht.flight.health_block(); ht.flight.flight_stats()\n"
        "assert not torch.cuda.is_initialized(), 'CUDA was initialized'\n"
        "print('OK')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "OK" in proc.stdout
