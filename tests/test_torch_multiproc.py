"""Real multi-process worlds of heat_tpu_torch on the CPU: gloo processes
on loopback, launched by ``multihost.spawn_local`` (reference:
tests/test_multiproc.py, tests/test_multihost_runtime.py's barrier cases).

* Every verb of ``ProcessMeshCommunication`` in a world of 2 processes x 2
  local ranks against the one-process mesh of 4, and of 3 x 1 against the
  one-process mesh of 3, bit for bit, over float32, float64 and int64: a
  reduction or scan is the one-process fold in rank order. ``ppermute``
  with partners in another process and in the same one, and the verbs of
  sub-meshes over one process and over two.
* The exchange (A11.5b(d)): a reduction is one payload ``all_gather`` and
  no object gather, a ``ppermute`` sends each block to its destination's
  process only; a ``ppermute`` of two shapes raises ``ValueError``, and so
  does a verb of a sub-mesh whose ranks live elsewhere.
* Named barriers in those worlds: matching tags pass, mismatched tags
  raise naming every process's.
* The lstsq trainer clean in 2 processes against numpy's float64 gradient
  descent (rtol 1e-12) and a 1-process run (rtol 1e-5).
* The kmeans trainer over a small ragged table in 2 processes: centers,
  inertia and labels equal bit for bit to the same calls on the
  one-process two-shard mesh.

The chaos cases (a SIGKILLed and a hung peer reform and match, the fault
mix, the launcher's command line) spawn two generations each and are
marked ``slow``, as the reference marks its file. Every launch runs under
the launcher's own time bound; workers run one torch thread each.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from heat_tpu_torch.core import multihost
from heat_tpu_torch.core.communication import MeshCommunication
from heat_tpu_torch.ops import lloyd
from heat_tpu_torch.scripts import multiproc_trainer as trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {"PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
TIMEOUT_S = 120.0
STEPS, EVERY = 8, 2
LLOYD_ROWS, LLOYD_ITERS = 2_003, 4

DTYPES = {"float32": torch.float32, "float64": torch.float64, "int64": torch.int64}


def verb_cases(comm, dtype, rank_of, per):
    """The verb cases on ``comm``'s local shards, ``rank_of(i)`` the global
    rank of local shard i, ``per`` the ranks of each process of the world
    compared: name -> this process's outputs."""
    p = comm.size
    local = range(len(comm.local_devices))

    def draw(r, shape, salt):
        gen = torch.Generator().manual_seed(1_000 * r + salt)
        x = torch.randn(*shape, generator=gen) * 10
        return x.round().to(dtype) if not dtype.is_floating_point else x.to(dtype)

    a = [draw(rank_of(i), (4, 3), 1) for i in local]
    b = [draw(rank_of(i), (2,), 2) for i in local]
    ragged = [draw(rank_of(i), (rank_of(i) + 1, 3), 3) for i in local]
    tiles = [draw(rank_of(i), (2 * p, 3), 4) for i in local]
    perm = [(0, p - 1), (p - 1, 1)]
    # a partner in another process, and one in the same process
    across = [(d, (d + per) % p) for d in range(p)]
    within = [(d, d - d % per + (d + 1) % per) for d in range(p)]

    def sub(ranks, verb):
        mine = sorted((i for i in local if rank_of(i) in ranks), key=lambda i: ranks.index(rank_of(i)))
        if not mine:
            return []
        return verb(comm.sub(ranks), [a[i] for i in mine])

    one, two = list(range(per)), [per - 1, per]
    return {
        "allreduce": comm.allreduce(a),
        "allreduce_max": comm.allreduce(a, "max"),
        "allreduce_tuple": comm.allreduce([(x, y) for x, y in zip(a, b)]),
        "bcast": comm.bcast(a, root=p - 1),
        "exscan": comm.exscan(a),
        "scan": comm.scan(a),
        "scan_prod": comm.scan(b, "prod"),
        "allgather_ragged": comm.allgather(ragged, dim=0),
        "ppermute": comm.ppermute(a, shift=1),
        "ppermute_partial_perm": comm.ppermute(a, perm=perm),
        "ppermute_across_processes": comm.ppermute(a, perm=across),
        "ppermute_within_a_process": comm.ppermute(a, perm=within),
        "alltoall": comm.alltoall(tiles, split_axis=0, concat_axis=1),
        "sub_one_process_allreduce": sub(one, lambda m, s: m.allreduce(s)),
        "sub_two_processes_allreduce": sub(two, lambda m, s: m.allreduce(s)),
        "sub_two_processes_allgather": sub(two, lambda m, s: m.allgather(s)),
        "sub_two_processes_ppermute": sub(two, lambda m, s: m.ppermute(s, shift=1)),
        "sub_two_processes_bcast": sub(two, lambda m, s: m.bcast(s, root=1)),
    }


VERBS = ("allreduce", "allreduce_max", "allreduce_tuple", "bcast", "exscan", "scan", "scan_prod",
         "allgather_ragged", "ppermute", "ppermute_partial_perm", "ppermute_across_processes",
         "ppermute_within_a_process", "alltoall", "sub_one_process_allreduce", "sub_two_processes_allreduce",
         "sub_two_processes_allgather", "sub_two_processes_ppermute", "sub_two_processes_bcast")


def exchange_calls(comm) -> dict:
    """The ``torch.distributed`` calls under one ``allreduce``, ``scan`` and
    ``exscan`` each, and the sends of one shift-1 ``ppermute``, as
    (destination process, elements), on this process's shards; then a
    ``ppermute`` of shards of two shapes, an ``allreduce`` whose values
    differ in shape and type between processes (not in bytes), a verb of a
    sub-mesh of the first process's ranks, and a sub-mesh over processes of
    a sub-mesh over processes: their errors, or None."""
    import collections

    import torch.distributed as dist

    names = ("all_gather", "all_gather_object", "broadcast", "broadcast_object_list", "batch_isend_irecv")
    saved = {n: getattr(dist, n) for n in names}
    calls, sends = collections.Counter(), []

    def counting(name):
        def call(*args, **kwargs):
            calls[name] += 1
            if name == "batch_isend_irecv":
                sends.extend((op.peer, op.tensor.numel()) for op in args[0] if op.op is dist.isend)
            return saved[name](*args, **kwargs)
        return call

    shards = [torch.full((4, 3), float(comm.first_rank + i)) for i in range(len(comm.local_devices))]
    out = {}
    for n in names:
        setattr(dist, n, counting(n))
    try:
        for verb in ("allreduce", "scan", "exscan"):
            calls.clear()
            getattr(comm, verb)(shards)
            out[verb] = dict(calls)
        calls.clear()
        comm.ppermute(shards, shift=1)
        out["ppermute"], out["ppermute_sends"] = dict(calls), list(sends)
    finally:
        for n, fn in saved.items():
            setattr(dist, n, fn)
    ragged = [torch.zeros(i + 1, 3) for i in range(len(shards))]
    per = len(shards)
    # the same 48 bytes per shard in every process, of two shapes and two
    # types across processes
    shape, dtype = ((4, 3), torch.float32) if comm.process == 0 else ((3, 4), torch.int32)
    differing = [torch.zeros(shape, dtype=dtype) for _ in shards]
    for key, call in (("mismatch", lambda: comm.ppermute(ragged, shift=1)),
                      ("reduce_mismatch", lambda: comm.allreduce(differing)),
                      ("foreign", lambda: comm.sub(list(range(per))).allreduce(shards)),
                      ("nested", lambda: comm.sub([per - 1, per]).sub([0, 1]))):
        try:
            call()
            out[key] = None
        except (ValueError, NotImplementedError) as exc:
            out[key] = f"{type(exc).__name__}: {exc}"
    return out


_VERB_WORKER = r"""
import os, sys, torch
sys.path.insert(0, os.path.join(os.environ["PYTHONPATH"], "tests"))
import heat_tpu_torch as ht
from heat_tpu_torch.core import multihost
from test_torch_multiproc import DTYPES, exchange_calls, verb_cases
ht.use_device("cpu")
comm = multihost.initialize_distributed(device="cpu", heartbeat=False)
me = multihost.process_index()
per = len(comm.local_devices)
out = {name: verb_cases(comm, dt, lambda i: comm.first_rank + i, per) for name, dt in DTYPES.items()}
out["first_rank"], out["size"], out["count"] = comm.first_rank, comm.size, multihost.process_count()
out["exchange"] = exchange_calls(comm)
multihost.sync_processes("both.same", timeout_ms=30_000)
try:
    multihost.sync_processes(f"differs.{me}", timeout_ms=30_000)
    out["mismatch"] = None
except RuntimeError as exc:
    out["mismatch"] = str(exc)
out["stats"] = multihost.report_stats()
torch.save(out, os.path.join(sys.argv[1], f"verbs-{me}.pt"))
"""


def _spawn(n, cmd, **kwargs):
    kwargs.setdefault("timeout_s", TIMEOUT_S)
    kwargs.setdefault("stdout", subprocess.DEVNULL)
    env = dict(ENV, **kwargs.pop("env", {}))
    return multihost.spawn_local(n, cmd, env=env, **kwargs)


def _trainer_cmd(root, *extra, steps=STEPS):
    return [sys.executable, "-m", "heat_tpu_torch.scripts.multiproc_trainer", "--device", "cpu",
            "--steps", str(steps), "--checkpoint-every", str(EVERY),
            "--ckpt-dir", os.path.join(root, "ckpt"), "--out", os.path.join(root, "out"), *extra]


def _results(root):
    docs = {}
    out = os.path.join(root, "out")
    if os.path.isdir(out):
        for name in sorted(os.listdir(out)):
            if name.startswith("result-") and name.endswith(".json"):
                with open(os.path.join(out, name)) as fh:
                    doc = json.load(fh)
                docs[(doc["epoch"], doc["rank"])] = doc
    return docs


def _final_w(docs):
    done = [d for d in docs.values() if d["status"] == "done" and d["final_w"]]
    assert done, f"no completed result docs in {sorted(docs)}"
    return np.asarray(max(done, key=lambda d: d["epoch"])["final_w"])


@pytest.fixture(scope="module")
def scratch():
    with tempfile.TemporaryDirectory(prefix="heat-torch-multiproc-") as root:
        yield root


# ---------------------------------------------------------------------------
# the verbs across processes, bit for bit against one process
# ---------------------------------------------------------------------------
WORLDS = {"2x2": (2, 2), "3x1": (3, 1)}


@pytest.fixture(scope="module")
def verb_worlds(scratch):
    got = {}
    for label, (n, per) in WORLDS.items():
        out = os.path.join(scratch, f"verbs-{label}")
        os.makedirs(out)
        result = _spawn(n, [sys.executable, "-c", _VERB_WORKER, out], devices_per_process=per, max_reforms=0)
        assert result["ok"], result
        got[label] = [torch.load(os.path.join(out, f"verbs-{q}.pt")) for q in range(n)]
    return got


def _flat(values):
    return [t for v in values for t in (v if isinstance(v, tuple) else (v,))]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("verb", VERBS)
@pytest.mark.parametrize("world", sorted(WORLDS))
def test_verb_across_processes_equals_one_process_bit_for_bit(verb_worlds, world, verb, dtype):
    n, per = WORLDS[world]
    procs = verb_worlds[world]
    assert [d["first_rank"] for d in procs] == [q * per for q in range(n)] and procs[0]["size"] == n * per
    got = _flat([v for d in procs for v in d[dtype][verb]])
    one = MeshCommunication([torch.device("cpu")] * (n * per))
    want = _flat(verb_cases(one, DTYPES[dtype], lambda i: i, per)[verb])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w), f"{world} {verb} {dtype}"


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_reductions_gather_once_without_a_pickled_header(verb_worlds, world):
    """A11.5b(d): each ``allreduce``, ``scan`` and ``exscan`` across
    processes is one payload ``all_gather`` and no object gather; a
    ``ppermute`` posts its pairs in one ``batch_isend_irecv`` and sends each
    block to the process of its destination rank only (none within a
    process)."""
    n, per = WORLDS[world]
    p = n * per
    for q, doc in enumerate(verb_worlds[world]):
        ex = doc["exchange"]
        for verb in ("allreduce", "scan", "exscan"):
            assert ex[verb] == {"all_gather": 1}, (world, q, verb, ex[verb])
        assert ex["ppermute"] == {"batch_isend_irecv": 1}
        # shard d receives shard d + 1: of this process's ranks only the
        # first sends, to the process before (the last process for rank 0)
        dst = (q * per - 1) % p
        assert ex["ppermute_sends"] == [(dst // per, 4 * 3)], (world, q, ex["ppermute_sends"])


def test_ppermute_of_two_shapes_raises_value_error(verb_worlds):
    """Every shard of one ``ppermute`` shares a shape and a type, as in
    ``lax.ppermute``: a process whose shards differ raises ``ValueError``
    before anything moves (2 x 2: two shards per process to compare)."""
    for doc in verb_worlds["2x2"]:
        assert "share a shape and a type" in doc["exchange"]["mismatch"]


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_reduction_of_values_that_differ_between_processes_raises(verb_worlds, world):
    """The equal-shape contract of ``allreduce`` across processes: values
    of one byte count but of another shape and type in one process raise
    ``ValueError`` in every process (3 x 1: one shard per process, nothing
    to compare within a process)."""
    for q, doc in enumerate(verb_worlds[world]):
        err = doc["exchange"]["reduce_mismatch"]
        assert err is not None and err.startswith("ValueError") and "in every process" in err, (world, q, err)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_in_process_ppermute_moves_ragged_shards(dtype):
    """The in-process mesh's ``ppermute`` moves shards of different row
    counts (its halo exchange and its callers' ragged blocks); the mesh
    over processes takes one shape only, as ``lax.ppermute``
    (test_ppermute_of_two_shapes_raises_value_error)."""
    one = MeshCommunication([torch.device("cpu")] * 4)
    gen = torch.Generator().manual_seed(7)
    ragged = [(torch.randn(r + 1, 3, generator=gen) * 10).to(DTYPES[dtype]) for r in range(4)]
    got = one.ppermute(ragged, perm=[(0, 3), (3, 1)])
    assert torch.equal(got[3], ragged[0]) and torch.equal(got[1], ragged[3])
    for d in (0, 2):
        assert got[d].shape == ragged[d].shape and got[d].dtype == ragged[d].dtype and not got[d].any()


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_sub_mesh_of_ranks_held_elsewhere_refuses_its_verbs(verb_worlds, world):
    """Every process calls ``sub`` with process 0's ranks: process 0 gets
    its in-process mesh, every other a mesh whose verbs raise. A sub-mesh
    over processes makes no process group of its own (only the world's
    mesh does, every process calling): it raises the named error, and the
    mesh of ranks held elsewhere ``ValueError``."""
    for q, doc in enumerate(verb_worlds[world]):
        err = doc["exchange"]["foreign"]
        assert (err is None) if q == 0 else ("holds none of ranks" in err), (world, q, err)
        nested = doc["exchange"]["nested"]
        held = q in (0, 1)  # the sub-mesh of ranks per - 1 and per
        assert nested.startswith("CrossProcessMeshError" if held else "ValueError"), (world, q, nested)


# ---------------------------------------------------------------------------
# named barriers across two processes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("world", sorted(WORLDS))
def test_barriers_across_processes_match_tags(verb_worlds, world):
    """tests/test_multihost_runtime.py's barrier cases in a real world:
    matching tags pass; mismatched tags raise, naming every process's,
    instead of pairing unrelated barriers."""
    n, _ = WORLDS[world]
    for doc in verb_worlds[world]:
        assert doc["count"] == n
        assert all(f"differs.{q}" in doc["mismatch"] for q in range(n))
        assert doc["stats"]["barriers"] == 2 and doc["stats"]["barrier_timeouts"] == 0


# ---------------------------------------------------------------------------
# the trainers
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def lstsq_runs(scratch):
    runs = {}
    for n in (1, 2):
        root = os.path.join(scratch, f"lstsq{n}")
        runs[n] = (_spawn(n, _trainer_cmd(root)), _results(root))
    return runs


def test_two_process_world_completes_clean(lstsq_runs):
    """tests/test_multiproc.py:119."""
    result, docs = lstsq_runs[2]
    assert result["ok"], result
    assert result["reforms"] == 0 and result["generations"][0]["exits"] == [0, 0]
    assert sorted(docs) == [(0, 0), (0, 1)]
    for doc in docs.values():
        assert (doc["status"], doc["world"], doc["completed_steps"]) == ("done", 2, STEPS)
    np.testing.assert_array_equal(docs[(0, 0)]["final_w"], docs[(0, 1)]["final_w"])


def test_world_size_invariance_and_numpy(lstsq_runs):
    """tests/test_multiproc.py:137, and numpy's float64 descent."""
    assert lstsq_runs[1][0]["ok"]
    w1, w2 = _final_w(lstsq_runs[1][1]), _final_w(lstsq_runs[2][1])
    np.testing.assert_allclose(w2, w1, rtol=1e-5)
    rng = np.random.default_rng(7)
    X, y = rng.standard_normal((64, 16)), rng.standard_normal(64)
    w = np.zeros(16)
    for _ in range(STEPS):
        w = w - 0.05 * (X.T @ (X @ w - y)) / 64
    np.testing.assert_allclose(w2, w, rtol=1e-12)
    assert np.linalg.norm(w2) > 0.0


def test_lloyd_across_two_processes_equals_two_shards_bit_for_bit(scratch):
    """``--workload kmeans`` over a ragged table (1,002 and 1,001 rows, so
    the last rank masks its padding): each process's centers, inertia and
    labels are those of the same calls on the one-process two-shard mesh."""
    import heat_tpu_torch as ht
    from heat_tpu_torch.core import fusion

    root = os.path.join(scratch, "lloyd")
    os.makedirs(root)
    data = trainer.lloyd_table(LLOYD_ROWS, 16, 8, trainer.LLOYD_SEED, torch.device("cpu"))
    table = os.path.join(root, "table.npy")
    np.save(table, data.numpy())
    result = _spawn(2, [sys.executable, "-m", "heat_tpu_torch.scripts.multiproc_trainer", "--workload", "kmeans",
                        "--device", "cpu", "--table", table, "--ckpt-dir", os.path.join(root, "ckpt"),
                        "--iters", str(LLOYD_ITERS), "--out", os.path.join(root, "out")])
    assert result["ok"], result
    docs = _results(root)
    two = MeshCommunication([torch.device("cpu")] * 2)
    with fusion.disabled():
        km = trainer.kmeans_fit(ht, ht.load_npy(table, split=0, comm=two), 8, LLOYD_ITERS, trainer.LLOYD_SEED)
    labels = trainer.digests(two, {"l": km.labels_})["l"]
    for r in range(2):
        doc = docs[(0, r)]
        assert (doc["first_rank"], doc["ranks"], doc["local_shards"], doc["n_iter"]) == (r, 2, 1, LLOYD_ITERS)
        assert doc["centers_hex"] == km.cluster_centers_.numpy().tobytes().hex()
        assert doc["inertia"] == km.inertia_
        assert doc["labels_sha256"] == {str(r): labels[str(r)]}
    assert [b.shape[0] for b in km.labels_.shards] == [1_002, 1_002] and km.labels_.shape == (LLOYD_ROWS,)


def test_lloyd_masks_each_ranks_share_of_the_padding():
    """``_local_valid`` counts from this process's first global rank."""
    assert lloyd._local_valid(10, 4, 1, first_rank=2) == [2]
    assert lloyd._local_valid(10, 4, 2, first_rank=1) == [4, 2]
    assert lloyd._local_valid(10, 4, 3) == [4, 4, 2]


# ---------------------------------------------------------------------------
# chaos: two generations each (slow)
# ---------------------------------------------------------------------------
@pytest.mark.slow
def test_sigkill_mid_step_reforms_and_matches(scratch, lstsq_runs):
    """tests/test_multiproc.py:152. Rank 1 SIGKILLs itself at step 3
    (``--die-rank``): the launcher's kill, keyed off the progress beacons,
    can land after a fast CPU run has finished every step (the injector
    itself is held in test_torch_multihost.py)."""
    with tempfile.TemporaryDirectory() as root:
        result = _spawn(2, _trainer_cmd(root, "--die-rank", "1", "--die-at-step", "3"), max_reforms=1)
        assert result["ok"], result
        assert result["reforms"] == 1
        gen0, gen1 = result["generations"]
        assert gen0["lost"] == [1] and gen0["exits"][0] == multihost.REFORM_EXIT
        assert (gen1["world"], gen1["epoch"], gen1["exits"]) == (1, 1, [0])
        assert gen0["duration_s"] < 60.0
        docs = _results(root)
        final = docs[(1, 0)]
        assert final["status"] == "done" and final["completed_steps"] == STEPS
        assert final["resumed_from"] is not None
        survivor = docs.get((0, 0))
        if survivor is not None:
            assert "error" in survivor
            assert final["resumed_from"] >= survivor["completed_steps"] - EVERY
        np.testing.assert_allclose(_final_w(docs), _final_w(lstsq_runs[2][1]), rtol=1e-5)


@pytest.mark.slow
def test_hung_peer_is_detected_and_reaped():
    """tests/test_multiproc.py:195."""
    with tempfile.TemporaryDirectory() as root:
        result = _spawn(2, _trainer_cmd(root, "--hang-rank", "1", "--hang-at-step", "3"), max_reforms=1,
                        timeout_s=90.0)
        assert result["ok"], result
        assert result["reforms"] == 1
        gen0, gen1 = result["generations"]
        assert gen0["lost"] == [1] and not gen0["timed_out"] and gen0["exits"][1] != 0
        assert gen0["duration_s"] < 30.0
        assert gen1["exits"] == [0]
        assert _results(root)[(1, 0)]["completed_steps"] == STEPS


@pytest.mark.slow
def test_green_under_ci_fault_mix(lstsq_runs):
    """tests/test_multiproc.py:220."""
    with tempfile.TemporaryDirectory() as root:
        result = _spawn(2, _trainer_cmd(root), env={"HEAT_TPU_FAULTS": "ci"})
        assert result["ok"], result
        np.testing.assert_allclose(_final_w(_results(root)), _final_w(lstsq_runs[2][1]), rtol=1e-5)


@pytest.mark.slow
def test_cli_emits_result_json_and_exit_status():
    """tests/test_multiproc.py:233."""
    with tempfile.TemporaryDirectory() as root:
        proc = subprocess.run(
            [sys.executable, "-m", "heat_tpu_torch.scripts.launch_multiproc", "-n", "2", "--quiet",
             "--mesh-dir", os.path.join(root, "mesh"), "--timeout-s", "120", "--",
             *_trainer_cmd(root, steps=4)],
            capture_output=True, text=True, timeout=180, cwd=ROOT, env=dict(os.environ, **ENV),
        )
        assert proc.returncode == 0, proc.stderr[-2000:]
        result = json.loads(proc.stdout)
        assert result["ok"] and result["generations"][0]["world"] == 2
