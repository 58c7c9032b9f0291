"""heat_tpu_torch.utils.checkpoint against heat_tpu's, and the trainers'
save and restore. CPU only.

Compatibility is held byte for byte: the same tree saved by both packages
gives the same manifest and the same payload files, and each package
restores what the other wrote, from one mesh size onto another (3 onto 5
and back; the reference's mesh is capped at the test mesh's size). Values
restore exactly. The trainers save after two steps, step once more, and a
fresh trainer restores: its state must equal the saved one and its next
step the uninterrupted third step, bit for bit (the CPU runs repeat
exactly).
"""

from __future__ import annotations

import copy
import hashlib
import json
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import heat_tpu as ref
import heat_tpu_torch as ht
from heat_tpu.core.communication import MeshCommunication as RefMesh
from heat_tpu.utils import checkpoint as ref_ckpt
from heat_tpu_torch.core.communication import MeshCommunication
from heat_tpu_torch.utils import checkpoint as ckpt
from test_torch_parity import on_cpu  # noqa: F401

SEED = 20261017


def _mesh(p):
    return MeshCommunication([torch.device("cpu")] * p)


def _ref_mesh(p):
    return RefMesh(jax.devices()[: min(p, len(jax.devices()))])


def _values(seed=SEED):
    rng = np.random.default_rng(seed)
    return {
        "rep": rng.standard_normal((4, 3)).astype(np.float32),
        "rows": rng.standard_normal((13, 4)).astype(np.float32),
        "cols": rng.integers(-9, 9, (5, 13)).astype(np.int64),
        "few": rng.standard_normal((2, 3)),  # n < p: empty shards
        "mask": rng.random((7,)) < 0.5,
        "arr": rng.standard_normal((3, 2)).astype(np.float64),
        "bf16": torch.from_numpy(rng.standard_normal((6,)).astype(np.float32)).bfloat16().float().numpy(),
    }


_SPLITS = {"rep": None, "rows": 0, "cols": 1, "few": 0, "mask": 0}


def _port_tree(v, p):
    comm = _mesh(p)
    tree = {name: ht.array(v[name], split=s, comm=comm) for name, s in _SPLITS.items()}
    tree["bf16_rows"] = ht.array(v["bf16"], dtype=ht.bfloat16, split=0, comm=comm)
    tree["leaves"] = [
        torch.from_numpy(v["arr"]),
        torch.from_numpy(v["bf16"]).bfloat16(),
        np.int32(7),
        {"n": 3, "x": 1.5, "inf": float("inf"), "name": "adam", "flag": True, "none": None},
        (2.0, -1),
    ]
    return tree


def _ref_tree(v, p):
    comm = _ref_mesh(p)
    tree = {name: ref.array(v[name], split=s, comm=comm) for name, s in _SPLITS.items()}
    tree["bf16_rows"] = ref.array(v["bf16"], dtype=ref.bfloat16, split=0, comm=comm)
    tree["leaves"] = [
        jnp.asarray(v["arr"]),
        jnp.asarray(v["bf16"]).astype(jnp.bfloat16),
        np.int32(7),
        {"n": 3, "x": 1.5, "inf": float("inf"), "name": "adam", "flag": True, "none": None},
        (2.0, -1),
    ]
    return tree


def _files(directory):
    out = {}
    for root, _, names in os.walk(directory):
        for name in names:
            full = os.path.join(root, name)
            out[os.path.relpath(full, directory)] = hashlib.sha256(open(full, "rb").read()).hexdigest()
    return out


def _port_numpy(x):
    if isinstance(x, ht.DNDarray):
        return np.asarray(x.numpy(), dtype=np.float64) if x.dtype is ht.bfloat16 else x.numpy()
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x)


def _ref_numpy(x):
    arr = np.asarray(x.numpy() if isinstance(x, ref.DNDarray) else x)
    return arr.astype(np.float64) if arr.dtype.name == "bfloat16" else arr


def _check_tree(got, want, to_got, to_want):
    flat_got = ckpt._flatten(got)
    flat_want = ckpt._flatten(want)
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (path, g), (_, w) in zip(flat_got, flat_want):
        if isinstance(w, (int, float, str, bool)) and not hasattr(w, "dtype"):
            assert g == w and type(g) is type(w), path
        else:
            a, b = to_got(g), to_want(w)
            assert a.shape == b.shape, path
            np.testing.assert_array_equal(a.astype(b.dtype) if a.dtype != b.dtype else a, b, err_msg=path)


# ---------------------------------------------------------------------------
# compatibility with heat_tpu
# ---------------------------------------------------------------------------
def test_the_same_tree_gives_the_same_bytes(tmp_path):
    v = _values()
    p = min(3, len(jax.devices()))
    ref_ckpt.save_checkpoint(str(tmp_path / "ref"), _ref_tree(v, p), step=4)
    ckpt.save_checkpoint(str(tmp_path / "port"), _port_tree(v, p), step=4)
    theirs, mine = _files(tmp_path / "ref"), _files(tmp_path / "port")
    assert sorted(mine) == sorted(theirs)
    assert mine == theirs  # every file, the manifest included, byte for byte
    doc = json.loads((tmp_path / "port" / "ckpt_4.manifest.json").read_text())
    kinds = {e["path"]: (e["kind"], e["files"][0]["format"] if e.get("files") else None) for e in doc["leaves"]}
    assert kinds["['bf16_rows']"] == ("dndarray", "raw")
    assert kinds["['leaves'][1]"] == ("array", "raw")


@pytest.mark.parametrize("save_p,load_p", [(3, 5), (5, 3)])
def test_heat_tpu_restores_the_ports_checkpoint(save_p, load_p, tmp_path):
    v = _values()
    ckpt.save_checkpoint(str(tmp_path), _port_tree(v, save_p), step=1)
    assert ref_ckpt.verify_checkpoint(str(tmp_path), 1) == []
    target = _ref_tree(_values(SEED + 1), load_p)  # other values: the restore must overwrite them
    restored = ref_ckpt.load_checkpoint(str(tmp_path), target)
    _check_tree(restored, _ref_tree(v, load_p), _ref_numpy, _ref_numpy)
    for name in _SPLITS:
        assert restored[name].split == _SPLITS[name]
        assert restored[name].comm.size == min(load_p, len(jax.devices()))


@pytest.mark.parametrize("save_p,load_p", [(3, 5), (5, 3)])
@pytest.mark.parametrize("load_split", ["saved", "other"])
def test_the_port_restores_heat_tpus_checkpoint(save_p, load_p, load_split, tmp_path):
    v = _values()
    ref_ckpt.save_checkpoint(str(tmp_path), _ref_tree(v, save_p), step=2)
    assert ckpt.verify_checkpoint(str(tmp_path), 2) == []
    target = _port_tree(_values(SEED + 1), load_p)
    if load_split == "other":  # restore onto another layout than the saved one
        target["rows"] = ht.array(v["rows"], split=1, comm=_mesh(load_p))
        target["cols"] = ht.array(v["cols"], split=None, comm=_mesh(load_p))
    restored = ckpt.load_checkpoint(str(tmp_path), target)
    _check_tree(restored, _port_tree(v, load_p), _port_numpy, _port_numpy)
    for name in _SPLITS:
        x = restored[name]
        assert x.comm.size == load_p and x.split == target[name].split and x.dtype is target[name].dtype
        check_layout(x)
    assert restored["bf16_rows"].dtype is ht.bfloat16
    assert restored["leaves"][1].dtype == torch.bfloat16
    assert isinstance(restored["leaves"][2], np.ndarray)  # a numpy template leaf stays numpy


def check_layout(x):
    from test_torch_parity import check_layout as layout

    layout(x)


@pytest.mark.parametrize("p", [1, 3, 5])
def test_port_round_trip_at_uneven_shards(p, tmp_path):
    v = _values()
    ckpt.save_checkpoint(str(tmp_path), _port_tree(v, p), step=0)
    for q in (1, 3, 5):
        restored = ckpt.load_checkpoint(str(tmp_path), _port_tree(_values(SEED + 2), q))
        _check_tree(restored, _port_tree(v, q), _port_numpy, _port_numpy)


# ---------------------------------------------------------------------------
# retention, verification, fallback, the legacy format
# ---------------------------------------------------------------------------
def _small(step):
    return {"w": torch.full((3,), float(step)), "step": step}


def test_keep_and_gc(tmp_path):
    d = str(tmp_path)
    for step in range(6):
        ckpt.save_checkpoint(d, _small(step), step=step, keep=2)
    assert ckpt.all_steps(d) == [4, 5] and ckpt.latest_step(d) == 5
    assert sorted(n for n in os.listdir(d) if os.path.isdir(os.path.join(d, n))) == ["ckpt_4", "ckpt_5"]
    ckpt.save_checkpoint(d, _small(50), step=5, keep=0)  # overwrite: staged beside the committed payload
    doc = json.loads((tmp_path / "ckpt_5.manifest.json").read_text())
    assert doc["payload"] == "ckpt_5.r1"
    assert ckpt.load_checkpoint(d, _small(0))["step"] == 50
    (tmp_path / "ckpt_9").mkdir()  # an orphaned staging directory
    (tmp_path / "ckpt_9" / "leaf_00000.arr.tmp-1-0").write_bytes(b"x")
    old = os.path.getmtime(tmp_path / "ckpt_5.manifest.json") - 10
    os.utime(tmp_path / "ckpt_9", (old, old))
    ckpt.gc_checkpoints(d, keep=0)
    assert not (tmp_path / "ckpt_9").exists()


def test_a_corrupt_newest_step_is_skipped_or_raises_under_strict(tmp_path):
    d = str(tmp_path)
    for step in (1, 2):
        ckpt.save_checkpoint(d, _small(step), step=step)
    payload = tmp_path / "ckpt_2" / "leaf_00001.arr"
    payload.write_bytes(payload.read_bytes()[:-3] + b"\0\0\0")
    problems = ckpt.verify_checkpoint(d, 2)
    assert problems and "SHA-256" in problems[0]
    with pytest.warns(ckpt.CheckpointCorruptWarning):
        got = ckpt.load_checkpoint(d, _small(0))
    assert got["step"] == 1 and torch.equal(got["w"], torch.full((3,), 1.0))
    with pytest.raises(ckpt.CheckpointCorruptError):
        ckpt.load_checkpoint(d, _small(0), strict=True)
    with pytest.raises(ckpt.CheckpointCorruptError):
        ckpt.load_checkpoint(d, _small(0), step=2)
    with pytest.raises(FileNotFoundError):
        ckpt.load_checkpoint(d, _small(0), step=7)
    (tmp_path / "ckpt_2" / "leaf_00001.arr").unlink()
    assert "missing payload file" in ckpt.verify_checkpoint(d, 2)[0]
    # heat_tpu takes the same decision on the same directory
    with pytest.warns(ref_ckpt.CheckpointCorruptWarning):
        assert ref_ckpt.load_checkpoint(d, {"w": np.zeros(3, np.float32), "step": 0})["step"] == 1


def test_structure_mismatch_and_explicit_manifest_path(tmp_path):
    d = str(tmp_path)
    path = ckpt.save_checkpoint(d, _small(3), step=3)
    assert ckpt.load_checkpoint(path, _small(0))["step"] == 3
    with pytest.raises(ValueError):
        ckpt.load_checkpoint(d, {"w": torch.zeros(3)})
    with pytest.raises(ValueError):
        ckpt.load_checkpoint(d, {"w": torch.zeros(4), "step": 0})
    with pytest.raises(TypeError):
        ckpt.save_checkpoint(d, {"bad": object()}, step=4)


def test_an_empty_template_dict_takes_the_saved_entries(tmp_path):
    d = str(tmp_path)
    tree = {"opt": {"state": {0: {"m": torch.arange(3.0), "step": torch.tensor(2.0)}, 1: {"m": torch.ones(2)}}}, "lr": 0.1}
    ckpt.save_checkpoint(d, tree, step=0)
    got = ckpt.load_checkpoint(d, {"opt": {"state": {}}, "lr": 0.0})
    assert got["lr"] == 0.1 and set(got["opt"]["state"]) == {0, 1}
    assert torch.equal(got["opt"]["state"][0]["m"], torch.arange(3.0))
    assert torch.equal(got["opt"]["state"][1]["m"], torch.ones(2))


def test_the_legacy_flax_msgpack_format_is_named(tmp_path):
    from flax import serialization

    d = str(tmp_path)
    (tmp_path / "ckpt_7.msgpack").write_bytes(serialization.msgpack_serialize({"w": np.arange(3.0)}))
    assert ckpt.all_steps(d) == [7]
    assert "flax-msgpack" in ckpt.verify_checkpoint(d, 7)[0]
    for call in (
        lambda: ckpt.load_checkpoint(d, {"w": np.zeros(3)}),
        lambda: ckpt.load_checkpoint(d, {"w": np.zeros(3)}, step=7),
        lambda: ckpt.load_checkpoint(str(tmp_path / "ckpt_7.msgpack"), {"w": np.zeros(3)}),
    ):
        with pytest.raises(NotImplementedError, match="flax-msgpack"):
            call()


# ---------------------------------------------------------------------------
# the trainers: save, step, restore, step
# ---------------------------------------------------------------------------
def _state_equal(a: dict, b: dict) -> None:
    flat_a, flat_b = ckpt._flatten(a), ckpt._flatten(b)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, x), (_, y) in zip(flat_a, flat_b):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu()), path
        else:
            assert x == y, path


def _interrupted(make, step, tmp_path):
    """Three uninterrupted steps against two, a save, and a fresh trainer
    restored for the third."""
    first = make()
    for _ in range(2):
        step(first)
    saved = copy.deepcopy(first.state_dict())
    path = first.save(str(tmp_path), step=2)
    assert ckpt.verify_checkpoint(str(tmp_path), 2) == [] and path.endswith("ckpt_2.manifest.json")
    third = step(first)
    fresh = make()
    fresh.restore(str(tmp_path))
    _state_equal(fresh.state_dict(), saved)
    assert step(fresh) == third
    _state_equal(fresh.state_dict(), first.state_dict())


@pytest.mark.parametrize("p", [1, 3])
def test_data_parallel_mlp_resumes_bit_for_bit(p, tmp_path):
    rng = np.random.default_rng(SEED)
    x, y = rng.standard_normal((12, 6)).astype(np.float32), rng.integers(0, 3, 12)

    def make():
        return ht.nn.DataParallel(ht.nn.MLP((8, 3), device="cpu"), comm=_mesh(p), optimizer=ht.optim.Adam(1e-2)).init(0, x[:2])

    _interrupted(make, lambda dp: dp.train_step(x, y), tmp_path)


def test_daso_resumes_bit_for_bit_at_mesh_4(tmp_path):
    rng = np.random.default_rng(SEED)
    x, y = rng.standard_normal((16, 6)).astype(np.float32), rng.integers(0, 3, 16)

    def make():
        daso = ht.optim.DASO(ht.optim.Adam(1e-2), total_epochs=4, comm=_mesh(4), nodes=2,
                             warmup_epochs=0, cooldown_epochs=0, local_skip_factor=1)
        dp = ht.nn.DataParallelMultiGPU(ht.nn.MLP((8, 3), device="cpu"), optimizer=daso, sample_input=x[:4])
        daso.global_skip, daso.local_skip, daso.batches_to_wait = 2, 1, 1  # solo batches and merges
        return dp

    _interrupted(make, lambda dp: dp.step(x, y), tmp_path)
    doc = json.loads((tmp_path / "ckpt_2.manifest.json").read_text())
    leaves = {e["path"]: e for e in doc["leaves"]}
    assert leaves["['schedule']['current_batch']"]["value"] == 2
    assert leaves["['params']['layers.0.weight']"]["files"][0]["shape"][0] == 4  # the replica axis


def test_transformer_lm_resumes_bit_for_bit(tmp_path):
    toks = np.random.default_rng(SEED).integers(0, 31, (4, 16)).astype(np.int64)

    def loss(logits, labels):
        return F.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]), labels[:, 1:].reshape(-1))

    def make():
        lm = ht.nn.TransformerLM(vocab=31, dim=64, depth=2, heads=4, max_len=32, device="cpu")
        return ht.nn.DataParallel(lm, comm=_mesh(2), optimizer=ht.optim.Adam(3e-3), loss_fn=loss).init(0, toks[:2])

    _interrupted(make, lambda dp: dp.train_step(toks, toks), tmp_path)


def test_data_parallel_restore_of_a_named_step_and_strict(tmp_path):
    rng = np.random.default_rng(SEED)
    x, y = rng.standard_normal((6, 4)).astype(np.float32), rng.integers(0, 2, 6)
    dp = ht.nn.DataParallel(ht.nn.MLP((4, 2), device="cpu"), comm=_mesh(3)).init(0, x[:2])
    dp.save(str(tmp_path), step=0)
    dp.train_step(x, y)
    dp.save(str(tmp_path), step=1)
    at0 = {k: v.clone() for k, v in dp.state_dict()["params"].items()}
    fresh = ht.nn.DataParallel(ht.nn.MLP((4, 2), device="cpu"), comm=_mesh(3)).init(0, x[:2])
    fresh.train_step(x, y)
    fresh.train_step(x, y)
    fresh.restore(str(tmp_path), step=0)
    with pytest.raises(FileNotFoundError):
        fresh.restore(str(tmp_path), step=5)
    before = ht.nn.DataParallel(ht.nn.MLP((4, 2), device="cpu"), comm=_mesh(3)).init(0, x[:2]).state_dict()["params"]
    for k in before:
        assert torch.equal(fresh.state_dict()["params"][k], before[k])
    assert not all(torch.equal(at0[k], before[k]) for k in before)


# ---------------------------------------------------------------------------
# fault sites, retries and lifecycle counts (test_checkpoint_resilience.py)
# ---------------------------------------------------------------------------
from heat_tpu.core import resilience as ref_res  # noqa: E402
from heat_tpu.core import telemetry as ref_tel  # noqa: E402
from heat_tpu_torch.core import resilience as res  # noqa: E402
from heat_tpu_torch.core import telemetry as tel  # noqa: E402

MESHES = [1, 3, 5]


@pytest.fixture
def observed(monkeypatch):
    """Both packages with no backoff sleep and telemetry at mode 1."""
    for module in (res, ref_res):
        monkeypatch.setattr(module, "retry_policy", module.RetryPolicy(retries=2, base_delay=0.0))
    was = tel.set_mode(1), ref_tel.set_mode(1)
    tel.reset()
    ref_tel.reset()
    yield
    tel.set_mode(was[0])
    ref_tel.set_mode(was[1])


def _truncate_a_payload(directory, step):
    payload = json.loads(open(os.path.join(directory, f"ckpt_{step}.manifest.json")).read())["payload"]
    victim = sorted(os.listdir(os.path.join(directory, payload)))[0]
    with open(os.path.join(directory, payload, victim), "r+b") as fh:
        fh.truncate(8)


@pytest.mark.parametrize("p", MESHES)
def test_a_hard_commit_fault_leaves_the_previous_step_restorable(p, tmp_path, observed):
    d = str(tmp_path)
    first = _port_tree(_values(), p)
    ckpt.save_checkpoint(d, first, step=1)
    with res.inject("checkpoint.commit") as spec:
        with pytest.raises(res.FaultInjected, match="checkpoint.commit"):
            ckpt.save_checkpoint(d, _port_tree(_values(SEED + 1), p), step=2)
    assert spec.fired == 1
    assert ckpt.all_steps(d) == [1] and ckpt.latest_step(d) == 1
    got = ckpt.load_checkpoint(d, _port_tree(_values(SEED + 2), p))
    _check_tree(got, first, _port_numpy, _port_numpy)
    assert tel.checkpoint_events() == {"save": 1, "restore": 1}
    # the staged payload of the failed save is debris the next save sweeps
    ckpt.save_checkpoint(d, first, step=3)
    assert sorted(n for n in os.listdir(d) if not n.endswith(".json")) == ["ckpt_1", "ckpt_3"]


def test_a_gc_fault_degrades_to_a_warning(tmp_path, observed):
    d = str(tmp_path)
    for step in range(3):
        ckpt.save_checkpoint(d, _port_tree(_values(), 3), step=step, keep=2)
    with res.inject("checkpoint.gc"):
        with pytest.warns(UserWarning, match="GC"):
            ckpt.save_checkpoint(d, _port_tree(_values(), 3), step=3, keep=2)
    assert ckpt.all_steps(d) == [1, 2, 3]  # nothing deleted, nothing lost
    ckpt.gc_checkpoints(d, keep=2)
    assert ckpt.all_steps(d) == [2, 3] and tel.checkpoint_events()["gc"] == 2
    # the sweep checks the site on entry too, so a fault degrades even with nothing to delete
    with res.inject("checkpoint.gc") as spec:
        with pytest.warns(UserWarning, match="GC"):
            ckpt.gc_checkpoints(d, keep=2)
    assert spec.fired == 1 and ckpt.all_steps(d) == [2, 3]


def test_a_saves_host_reads_are_attributed_to_io(tmp_path, monkeypatch):
    """The reference's ``force_trigger("io")`` scope around each leaf's host
    copy: a read there is attributed to ``io``, one outside to ``parray``."""
    seen = []

    def probe(name, real):
        def wrapped(*args):
            seen.append((name, tel.current_trigger()))
            return real(*args)
        return wrapped

    for name in ("_save_dndarray", "_host"):
        monkeypatch.setattr(ckpt, name, probe(name, getattr(ckpt, name)))
    tree = {"w": ht.array(np.ones((6, 2), np.float32), split=0, comm=_mesh(3)), "b": np.zeros(3, np.float32)}
    ckpt.save_checkpoint(str(tmp_path), tree, step=1)
    assert set(seen) == {("_host", "io"), ("_save_dndarray", "io")}
    assert tel.current_trigger() == "parray"


def _lifecycle(pkg_ckpt, tree_of, t, directory):
    t.set_mode(2)
    t.reset()
    for step in (1, 2, 3):
        pkg_ckpt.save_checkpoint(directory, tree_of(SEED + step), step=step, keep=2)
    _truncate_a_payload(directory, 3)
    with pytest.warns(pkg_ckpt.CheckpointCorruptWarning):
        pkg_ckpt.load_checkpoint(directory, tree_of(SEED))
    with pytest.raises(pkg_ckpt.CheckpointCorruptError):
        pkg_ckpt.load_checkpoint(directory, tree_of(SEED), step=3)
    with pytest.raises(pkg_ckpt.CheckpointCorruptError):
        pkg_ckpt.load_checkpoint(directory, tree_of(SEED), strict=True)
    pkg_ckpt.load_checkpoint(os.path.join(directory, "ckpt_2.manifest.json"), tree_of(SEED))
    phases = [(e["phase"], e.get("step")) for e in t.events() if e["kind"] == "checkpoint_phase"]
    return t.checkpoint_events(), phases


@pytest.mark.parametrize("p", MESHES)
def test_the_lifecycle_counts_and_phases_equal_heat_tpus(p, tmp_path, observed):
    q = min(p, len(jax.devices()))
    mine = _lifecycle(ckpt, lambda s: _port_tree(_values(s), p), tel, str(tmp_path / "port"))
    theirs = _lifecycle(ref_ckpt, lambda s: _ref_tree(_values(s), q), ref_tel, str(tmp_path / "ref"))
    assert mine == theirs
    assert mine[0] == {"save": 3, "gc": 1, "corrupt": 3, "fallback": 1, "restore": 2}


@pytest.mark.parametrize("p", MESHES)
def test_the_ci_fault_mix_leaves_checkpoints_byte_equal(p, tmp_path, observed, monkeypatch):
    """The reference's ``ci`` preset in the background: every transient
    write, commit and restore fault is retried, GC faults degrade, and the
    files equal a fault-free save's."""
    v = _values()
    ckpt.save_checkpoint(str(tmp_path / "clean"), _port_tree(v, p), step=5)
    monkeypatch.setattr(res, "_BACKGROUND", res._parse_env("ci"))
    monkeypatch.setattr(res, "_ARMED", True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for step in (3, 4, 5):
            ckpt.save_checkpoint(str(tmp_path / "faulty"), _port_tree(v if step == 5 else _values(SEED + 9), p), step=step)
        got = ckpt.load_checkpoint(str(tmp_path / "faulty"), _port_tree(_values(SEED + 2), p))
    monkeypatch.setattr(res, "_ARMED", False)
    _check_tree(got, _port_tree(v, p), _port_numpy, _port_numpy)
    clean, faulty = _files(tmp_path / "clean"), _files(tmp_path / "faulty")
    assert {k: h for k, h in faulty.items() if k.startswith("ckpt_5")} == clean
    assert set(tel.io_retries()) >= {"checkpoint.write", "checkpoint.commit", "checkpoint.restore"}
