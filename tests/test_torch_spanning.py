"""The array, the main path and the layers above it over a mesh whose
ranks span processes (ROADMAP A11.5b(a), (b), (c1) and (c2a)): a DNDarray on a
``ProcessMeshCommunication`` of real gloo worlds on loopback holds the
shards of each process's own ranks.

* One launch each of a 2 x 2 and a 3 x 1 world runs :func:`program`, a
  fixed sequence of factories, random draws, the four engines, the
  moments, ``resplit``, host reads, ``load_npy``, two ``KMeans`` fits (the
  plain Lloyd version on the CPU) and a checkpoint's save and restore. The
  test process runs the same program on the one-process mesh of the same
  p with the fusion recorder off (the spanning mesh runs the eager
  engines) and holds every result bit for bit: the host array every
  process reads, and each rank's logical block, whichever process holds
  it. Both are held against numpy.
* The workers' checkpoint is restored into this one process at the same p
  and at another, bit for bit, with every rank's fragment named in the
  receipt of the process that holds it.
* C19 across spanning meshes, and heat_tpu's mocked two-process seam
  (tests/test_multihost_seam.py:55-89) against the port.
* The main path over the spanning mesh (A11.5b(c1)): ``cdist``, ``rbf``,
  ``manhattan`` and the quadratic expansion over ragged split-0 operands
  (C25), ``matmul`` over every split pair, ``qr`` by each schedule (the
  probe's fallback included), the blocked triangular solve, ``solve``,
  ``cholesky``, ``slogdet`` and ``det``, two ``DataParallel`` steps of a
  small ResNet with BatchNorm (one with an empty rank) and two DASO steps
  with a group per process: bit for bit against the one process, against
  numpy, and the distance and linalg results against heat_tpu at the same
  p.
* The layers above the verbs (A11.5b(c2a)): the Laplacian of 7 and 10
  rows in both definitions (C27); ring and Ulysses, causal and not, with
  the gradients of q, k and v, MultiHeadAttention's ring backend and a
  TransformerLM's step through the ring; the dp x tp step of a
  ``TPMLPBlock`` with 'tp' inside a process and across the processes, the
  Megatron pair with its input's gradient, the pipeline and the experts;
  ``convolve`` in every mode over ragged rows, ``Lasso``, ``Spectral``
  and ``ping_mesh``: bit for bit against the one process, against their
  dense oracles or numpy, and ring, Ulysses and parallel/ against
  heat_tpu at the same p.

Workers run one torch thread each under the launcher's time bound.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import types as pytypes
import unittest.mock

import numpy as np
import pytest
import torch

import heat_tpu as ref
import heat_tpu_torch as ht
from heat_tpu.core import multihost as ref_mh
from heat_tpu_torch.core import communication, fusion, multihost
from heat_tpu_torch.utils.checkpoint import load_checkpoint, verify_checkpoint
from test_torch_parity import on_cpu  # noqa: F401
import torch_spanning_program
from torch_spanning_program import MESH_LAYOUTS, SP_CASES, K, mesh_layouts, program, sp_name, tables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {"PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
WORLDS = {"2x2": (2, 2), "3x1": (3, 1)}
TIMEOUT_S = 120.0
_WORKER = r"""
import os, sys, torch
sys.path.insert(0, os.path.join(os.environ["PYTHONPATH"], "tests"))
import heat_tpu_torch as ht
from heat_tpu_torch.core import multihost
from torch_spanning_program import program
ht.use_device("cpu")
comm = multihost.initialize_distributed(device="cpu", heartbeat=False)
unseeded = ht.random.rand(3, comm=comm).numpy()  # no seed set: process 0's
out = program(comm, sys.argv[1], multihost.process_count())
out["unseeded"] = unseeded
out["first_rank"], out["local"] = comm.first_rank, len(comm.local_devices)
torch.save(out, os.path.join(sys.argv[1], f"res-{multihost.process_index()}.pt"))
"""


def _inputs(workdir: str) -> None:
    np.save(os.path.join(workdir, "f7.npy"), tables()["f7"])


@pytest.fixture(scope="module")
def worlds():
    """The worlds and the kmeans workload launched two at a time (fewer
    processes competing for the cores with the suite's other workers),
    while this process runs the program on the one-process meshes."""
    from concurrent.futures import ThreadPoolExecutor

    got = {}
    with tempfile.TemporaryDirectory(prefix="heat-torch-spanning-") as root, ThreadPoolExecutor(2) as pool:
        launches = {"kmeans": pool.submit(_kmeans_workload, root)}
        for label, (n, per) in WORLDS.items():
            work = os.path.join(root, label)
            os.makedirs(work)
            _inputs(work)
            launches[label] = pool.submit(
                multihost.spawn_local, n, [sys.executable, "-c", _WORKER, work], env=dict(ENV),
                devices_per_process=per, max_reforms=0, timeout_s=TIMEOUT_S)
        ht.use_device("cpu")
        # one torch thread, as in the workers: torch splits a large CPU
        # reduction (the training cases' convolutions) over its threads
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            for label, (n, per) in WORLDS.items():
                one_dir = os.path.join(root, f"{label}-one")
                os.makedirs(one_dir)
                _inputs(one_dir)
                with fusion.disabled():
                    got[label] = {"one": program(
                        communication.MeshCommunication([torch.device("cpu")] * (n * per)), one_dir, n)}
        finally:
            torch.set_num_threads(threads)
        got["kmeans"] = _kmeans_reference(launches["kmeans"].result())
        for label, (n, per) in WORLDS.items():
            result = launches[label].result()
            assert result["ok"], result
            work = os.path.join(root, label)
            got[label]["procs"] = [torch.load(os.path.join(work, f"res-{q}.pt"), weights_only=False)
                                   for q in range(n)]
            # the checkpoint's restores into this process, made while the
            # directory lives
            got[label]["restores"] = _restores(os.path.join(work, "ckpt"), n * per)
            got[label]["receipts"] = _receipts(os.path.join(work, "ckpt"), n)
    return got


KM_ROWS, KM_F, KM_K, KM_ITERS = 1_000, 16, 8, 4


def _kmeans_workload(root: str) -> dict:
    """The trainer's ``--workload kmeans`` in two processes over a small
    config 3 table; returns the launcher's summary and the result documents
    (a thread of its own)."""
    from heat_tpu_torch.scripts import multiproc_trainer as trainer

    work = os.path.join(root, "kmeans")
    os.makedirs(work)
    data = trainer.lloyd_table(KM_ROWS, KM_F, KM_K, trainer.LLOYD_SEED, torch.device("cpu"))
    table = os.path.join(work, "table.npy")
    np.save(table, data.numpy())
    result = multihost.spawn_local(
        2, [sys.executable, "-m", "heat_tpu_torch.scripts.multiproc_trainer", "--workload", "kmeans", "--device",
            "cpu", "--table", table, "--ckpt-dir", os.path.join(work, "ckpt"), "--out", os.path.join(work, "out"),
            "--iters", str(KM_ITERS), "--clusters", str(KM_K)],
        env=dict(ENV), max_reforms=0, timeout_s=TIMEOUT_S)
    docs = []
    for q in range(2 if result["ok"] else 0):
        with open(os.path.join(work, "out", f"result-epoch0000-rank{q:05d}.json")) as fh:
            docs.append(json.load(fh))
    return {"result": result, "docs": docs, "work": work, "table": table}


def _kmeans_reference(run: dict) -> dict:
    """The workload's calls on this process's two-shard mesh, and the
    workers' checkpoint restored on three shards (the directory lives)."""
    from heat_tpu_torch.scripts import multiproc_trainer as trainer

    if not run["result"]["ok"]:
        return run
    two = communication.MeshCommunication([torch.device("cpu")] * 2)
    with fusion.disabled():
        x = ht.load_npy(run["table"], split=0, comm=two)
        run["moments"] = trainer.digests(two, trainer.kmeans_moments(ht, x))
        km = trainer.kmeans_fit(ht, x, KM_K, KM_ITERS, trainer.LLOYD_SEED)
    run["labels"] = trainer.digests(two, {"l": km.labels_})["l"]
    run["centers_hex"], run["inertia"] = km.cluster_centers_.numpy().tobytes().hex(), km.inertia_
    run["centers"], run["x"] = km.cluster_centers_.numpy(), np.load(run["table"])
    three = communication.MeshCommunication([torch.device("cpu")] * 3)
    restored = load_checkpoint(os.path.join(run["work"], "ckpt"), {
        "table": ht.zeros((KM_ROWS, KM_F), split=0, comm=three),
        "centers": ht.zeros((KM_K, KM_F), comm=communication.MeshCommunication([torch.device("cpu")]))}, step=1)
    run["restored"] = {k: v.numpy() for k, v in restored.items()}
    return run


def test_kmeans_workload_across_two_processes_equals_two_shards(worlds):
    """``multiproc_trainer --workload kmeans``: each process's moments,
    centers, inertia and labels are the two-shard mesh's bit for bit, and
    its checkpoint restores on three shards as the table and the centers."""
    run = worlds["kmeans"]
    assert run["result"]["ok"], run["result"]
    for q, doc in enumerate(run["docs"]):
        assert (doc["first_rank"], doc["ranks"], doc["local_shards"], doc["n_iter"]) == (q, 2, 1, KM_ITERS)
        assert doc["centers_hex"] == run["centers_hex"]
        assert doc["inertia"] == run["inertia"]
        assert doc["labels_sha256"] == {str(q): run["labels"][str(q)]}
        for name, want in run["moments"].items():
            got = doc["moments"][name]
            assert got == (want if isinstance(want, str) else {str(q): want[str(q)]}), name
        assert doc["ingest_bytes"] == KM_ROWS // 2 * KM_F * 4 and doc["ms_per_iter"] > 0
    assert run["restored"]["table"].tobytes() == run["x"].tobytes()
    assert run["restored"]["centers"].tobytes() == run["centers"].tobytes()


def _restores(ckpt: str, p: int) -> dict:
    out = {}
    for q in sorted({p, 1, p + 1}):
        comm = communication.MeshCommunication([torch.device("cpu")] * q)
        template = {"x": ht.zeros((7, 5), split=0, comm=comm), "xe": ht.zeros((5, 3), dtype=ht.float64, split=0,
                    comm=comm), "y": ht.zeros((7, 5), split=1, comm=comm), "centers": ht.zeros((K, 4), comm=comm),
                    "n": 0}
        back = load_checkpoint(ckpt, template, step=1)
        out[q] = {key: back[key].numpy() if isinstance(back[key], ht.DNDarray) else back[key] for key in back}
    out["problems"] = verify_checkpoint(ckpt, 1)
    return out


def _receipts(ckpt: str, n: int) -> dict:
    payload = os.path.join(ckpt, "ckpt_1")
    got = {}
    for q in range(n):
        with open(os.path.join(payload, f".receipt-{q}.json")) as fh:
            got[q] = sorted(os.path.basename(f) for f in json.load(fh))
    return got


def _layer_case_names():
    """The result names of the layers (A11.5b(c2a)) that the program builds
    with f-strings."""
    names = [f"{sp_name(*case)}_{part}" for case in SP_CASES for part in ("out", "grad_q", "grad_k", "grad_v")]
    for label in MESH_LAYOUTS:
        names += [f"mesh_{label}_shape", f"dp_tp_{label}_loss", f"dp_tp_{label}_out_after_step"]
        names += [f"dp_tp_{label}_grad_{name}" for name in ("up_kernel", "up_bias", "down_kernel", "down_bias")]
    names += [f"convolve_{rows}_{mode}" for rows in (23, 10) for mode in ("full", "same", "valid")]
    names += [f"lasso_{label}_y{split}_theta" for label in ("tall", "wide") for split in (0, None)]
    return names


LAYER_CASES = _layer_case_names()


def _case_names():
    """Every result name of :func:`program`, read from its source (the test
    ids are fixed at collection, before any world runs)."""
    import inspect
    import re

    src = inspect.getsource(torch_spanning_program)
    names = []
    for n in ("f7", "f5", "i4"):
        for split in (None, 0, 1):
            names.append(f"array_{n}_{split}")
    for label in ("x", "xe", "xi", "y"):
        for axis in (None, 0, 1):
            for fn in ("sum", "mean", "var", "std", "min", "max", "argmax"):
                names.append(f"{fn}_{label}_{axis}")
        names += [f"argmin_{label}_0", f"cumsum_{label}_0", f"cumsum_{label}_1"]
    for init in ("batchparallel", "random"):
        names += [f"kmeans_{init}_centers", f"kmeans_{init}_labels", f"kmeans_{init}_inertia"]
    names += [f"restored_{key}" for key in ("x", "xe", "y", "centers", "n")]
    names += [f"matmul_{sa}_{sb}" for sa in (None, 0, 1) for sb in (None, 0, 1)]
    names += [f"qr_{name}_{part}" for name in ("auto", "tsqr", "cholqr2", "fallback", "panel") for part in "qr"]
    names += [f"{fit}_{what}_{i}" for fit in ("dp", "dp_tokens", "daso") for what in ("loss", "params", "buffers")
              for i in (0, 1)]
    names += [f"laplacian_{definition}_{rows}" for definition in ("simple", "norm_sym") for rows in (7, 10)]
    names += LAYER_CASES
    names += re.findall(r'rec\("(\w+)"', src)
    return sorted(set(names))


CASES = _case_names()


def _merged(procs, name):
    """The processes' records of ``name``: the host values each read, and
    the blocks of every rank from the process that holds it."""
    recs = [d[name] for d in procs]
    if not isinstance(recs[0], dict):
        return recs, None
    blocks = {}
    for rec in recs:
        assert not set(rec["blocks"]) & set(blocks), "a rank held by two processes"
        blocks.update(rec["blocks"])
    return recs, blocks


def _same(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("world", sorted(WORLDS))
def test_spanning_equals_one_process_bit_for_bit(worlds, world, name):
    procs, one = worlds[world]["procs"], worlds[world]["one"][name]
    recs, blocks = _merged(procs, name)
    if name == "lshapes":
        # process 0's first rank is the one process's; the others' are held
        # in test_each_process_holds_its_own_ranks
        recs = recs[:1]
    if blocks is None:
        assert all(_same(r, one) for r in recs), (recs, one)
        return
    for rec in recs:
        assert rec["split"] == one["split"]
        assert _same(rec["np"], one["np"]), f"{world} {name}: the host array differs"
    assert sorted(blocks) == (sorted(one["blocks"]) if one["split"] is not None else [])
    for r, b in blocks.items():
        assert _same(b, one["blocks"][r]), f"{world} {name}: rank {r}'s block differs"


def _written(a):
    a = a.copy()
    a[:, 0] = 1.5
    a[2:6, 1] = np.arange(4.0)
    return a


def _pairwise(a, b, name: str):
    """numpy's value of a distance case: the metric of ``name``'s prefix
    over rows of a against rows of b, in float64."""
    a, b = a.astype(np.float64), b.astype(np.float64)
    diff = a[:, None, :] - b[None, :, :]
    if name.startswith("manhattan"):
        return np.abs(diff).sum(-1)
    d2 = (diff * diff).sum(-1)
    if name.startswith("rbf"):
        return np.exp(-d2 / (2.0 * 1.5 * 1.5)) if "quadratic" not in name else np.exp(-d2 / 2.0)
    return np.sqrt(d2)


def _linalg_expectation(name: str, t):
    """numpy's value of a linalg case (float64), or None; a QR case is
    held by its product and its orthogonality in the test."""
    if name.startswith("matmul"):
        return t["f7"].astype(np.float64) @ t["h56"].astype(np.float64)
    if name == "qr_schedules":
        return np.array(["cholqr2", "tsqr", "cholqr2", "tsqr", "panel"])
    return {
        "solve_triangular_lower": lambda: np.linalg.solve(t["tri"], t["rhs"]),
        "solve_triangular_upper_vector": lambda: np.linalg.solve(t["tri"].T, t["rhs"][:, 0]),
        "solve": lambda: np.linalg.solve(t["spd"], t["rhs"]),
        "cholesky": lambda: np.linalg.cholesky(t["spd"]),
        "cholesky_split1": lambda: np.linalg.cholesky(t["spd"]),
        "slogdet_sign": lambda: np.linalg.slogdet(t["spd"])[0],
        "slogdet_logabs": lambda: np.linalg.slogdet(t["spd"])[1],
        "det_tri": lambda: np.linalg.det(t["tri"]),
    }.get(name, lambda: None)()


def _laplacian(a, definition: str):
    """numpy's fully connected rbf Laplacian (sigma 1.5) of the rows of a,
    in float64."""
    a = a.astype(np.float64)
    diff = a[:, None, :] - a[None, :, :]
    adj = np.exp(-(diff * diff).sum(-1) / (2.0 * 1.5 * 1.5))
    np.fill_diagonal(adj, 0.0)
    deg = adj.sum(1)
    if definition == "simple":
        return np.diag(deg) - adj
    scale = 1.0 / np.sqrt(deg)
    return np.eye(len(a)) - scale[:, None] * adj * scale[None, :]


def _numpy_expectation(name: str):
    """numpy's value of a result of :func:`program`, or None."""
    t = tables()
    if name.startswith("laplacian_"):
        definition, rows = name[len("laplacian_"):].rsplit("_", 1)
        return _laplacian(t["f7"] if rows == "7" else t["g10"], definition)
    linalg = _linalg_expectation(name, t)
    if linalg is not None:
        return linalg
    if name.startswith(("cdist", "rbf", "manhattan")):
        rows = {"7": t["f7"], "10": t["g10"]}
        parts = name.split("_")
        x = rows[parts[-2]]
        y = x if parts[-1] == "self" else t["g10"] if parts[-1] == "replicated" else rows[parts[-1]]
        return _pairwise(x, y, name)
    arrays = {"x": t["f7"], "xe": t["f5"], "xi": t["i4"], "y": t["f7"]}
    parts = name.split("_")
    if parts[0] == "array":
        return t[parts[1]]
    if parts[0] in ("sum", "mean", "var", "std", "min", "max", "argmax", "argmin") and parts[1] in arrays:
        a = arrays[parts[1]]
        axis = None if parts[2] == "None" else int(parts[2])
        if parts[0] in ("mean", "var", "std") and a.dtype.kind == "i":
            a = a.astype(np.float64)
        return getattr(np, {"min": "amin", "max": "amax"}.get(parts[0], parts[0]))(a, axis=axis)
    if parts[0] == "cumsum" and parts[1] in arrays:
        return np.cumsum(arrays[parts[1]], axis=int(parts[2]))
    simple = {
        "add_replicated": t["f7"] + t["f7"][0], "mul_scalar": t["f7"] * 2, "add_other_split": t["f7"] + t["f7"],
        "sub_ints": t["i4"] - 3, "exp": np.exp(t["f7"]), "sqrt_abs": np.sqrt(np.abs(t["f5"])),
        "cumprod_xi_0": np.cumprod(t["i4"], 0), "arange": np.arange(7), "zeros": np.zeros((5, 3)),
        "full": np.full((4, 3), 2.5), "linspace": np.linspace(0.0, 1.0, 7), "eye": np.eye(5),
        "load_npy_0": t["f7"], "load_npy_1": t["f7"], "item_sum": t["f7"].sum(), "item_one_row": 3.5,
        "sort_xe_values": np.sort(t["f5"], axis=0), "sort_xe_indices": np.argsort(t["f5"], axis=0, kind="stable"),
        "unique_xi": np.unique(t["i4"]), "restored_x": t["f7"], "getitem_columns": t["f7"][:, 1:3],
        "getitem_rows": t["f7"][1:6:2], "setitem": _written(t["f7"]), "fill_diagonal": np.eye(5) * 2.0, "restored_xe": t["f5"], "restored_y": t["f7"], "restored_n": 3,
    }
    if name.startswith("resplit"):
        return t["f7"] if "none_0" not in name else t["f7"][0]
    return simple.get(name)


@pytest.mark.parametrize("name", CASES)
def test_one_process_program_against_numpy(worlds, name):
    """The program's results against numpy: exact for integers, indices
    and moves, to float32's or float64's rounding for arithmetic."""
    want = _numpy_expectation(name)
    for world in sorted(WORLDS):
        one = worlds[world]["one"][name]
        got = one["np"] if isinstance(one, dict) else one
        if name.startswith("kmeans_random"):
            # a random init may seed two centers in one blob: the fit is
            # held bit for bit against the one-process fit only
            assert np.isfinite(np.asarray(got, dtype=np.float64)).all()
            continue
        if name.startswith("kmeans_") and name.endswith("_labels"):
            # every blob's rows share one label, three labels in all
            labels = np.asarray(got).reshape(-1, K)
            assert len(set(labels[0].tolist())) == K and (labels == labels[0]).all()
            continue
        if name.startswith("qr_") and name != "qr_schedules":
            # Q R = A and QᵀQ = I (float64 1e-10; the cond-1e5 float32
            # operand 1e-4 on the product, 1e-3 on Q's orthogonality)
            base = name[3:-2]
            other = worlds[world]["one"][name[:-1] + ("r" if name.endswith("q") else "q")]["np"]
            q, r = (got, other) if name.endswith("q") else (other, got)
            a = {"auto": "tall", "tsqr": "tall", "cholqr2": "tall", "fallback": "ill", "panel": "wide"}[base]
            tol = 1e-10 if q.dtype == np.float64 else 1e-4
            np.testing.assert_allclose(q @ r, tables()[a], rtol=tol, atol=tol)
            np.testing.assert_allclose(q.T @ q, np.eye(q.shape[1]), atol=10 * tol)
            continue
        if name.startswith(("dp_", "daso_")):
            # the training steps are held bit for bit against the one
            # process; here: finite, and the losses of a 3-class problem
            assert np.isfinite(np.asarray(got, dtype=np.float64)).all()
            continue
        if name.startswith("kmeans_") and name.endswith("_centers"):
            means = np.stack([tables()["blobs"][i::K].mean(0) for i in range(K)])
            order = np.argsort(np.asarray(got)[:, 0])
            np.testing.assert_allclose(np.asarray(got)[order], means[np.argsort(means[:, 0])], rtol=1e-4, atol=1e-4)
            continue
        if want is None:
            assert got is not None
            continue
        got = np.asarray(got)
        want = np.asarray(want)
        if "quadratic" in name:
            # |x|² + |y|² − 2x·y in float32 cancels to ~1e-6 of |x|² near the
            # diagonal, whose square root is ~1e-3 (reference distance.py:40-60)
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-3)
            continue
        if name.startswith(("matmul", "solve", "cholesky", "slogdet", "det")):
            tol = 1e-10 if got.dtype == np.float64 else 2e-5
            np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
            continue
        if want.dtype.kind in "iubU" or name.startswith(("arg", "array", "resplit", "load", "restored", "eye", "sort", "get", "set", "fill")):
            np.testing.assert_array_equal(got, want.astype(got.dtype) if want.dtype.kind == "f" else want)
        else:
            rtol = 1e-12 if got.dtype == want.dtype == np.float64 else 2e-5
            np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol)


def _heat_tpu_case(name: str, comm):
    """heat_tpu's value of a distance or linalg case on ``comm`` (a mesh of
    the JAX package), as a numpy array."""
    t = tables()

    def arr(key, split, a=None):
        return ref.array(t[key] if a is None else a, split=split, comm=comm)

    cases = {
        "cdist_7_10": lambda: ref.spatial.cdist(arr("f7", 0), arr("g10", 0)),
        "cdist_10_self": lambda: ref.spatial.cdist(arr("g10", 0)),
        "rbf_7_10": lambda: ref.spatial.rbf(arr("f7", 0), arr("g10", 0), sigma=1.5),
        "manhattan_10_7": lambda: ref.spatial.manhattan(arr("g10", 0), arr("f7", 0)),
        "cdist_quadratic_7_10": lambda: ref.spatial.cdist(arr("f7", 0), arr("g10", 0), quadratic_expansion=True),
        "matmul_0_None": lambda: ref.matmul(arr("f7", 0), arr("h56", None)),
        "matmul_1_0": lambda: ref.matmul(arr("f7", 1), arr("h56", 0)),
        "matmul_None_1": lambda: ref.matmul(arr("f7", None), arr("h56", 1)),
        "matmul_1_1": lambda: ref.matmul(arr("f7", 1), arr("h56", 1)),
        "qr_tsqr_r": lambda: ref.linalg.qr(arr("tall", 0), method="tsqr")[1],
        "qr_panel_r": lambda: ref.linalg.qr(arr("wide", 1))[1],
        "solve_triangular_lower": lambda: ref.linalg.solve_triangular(arr("tri", 0), arr("rhs", 0), lower=True),
        "cholesky": lambda: ref.linalg.cholesky(arr("spd", 0)),
        "slogdet_logabs": lambda: ref.linalg.slogdet(arr("spd", 0))[1],
    }
    return np.asarray(cases[name]().numpy())


@pytest.mark.parametrize("name", [
    "cdist_7_10", "cdist_10_self", "rbf_7_10", "manhattan_10_7", "cdist_quadratic_7_10", "matmul_0_None",
    "matmul_1_0", "matmul_None_1", "matmul_1_1", "qr_tsqr_r", "qr_panel_r", "solve_triangular_lower", "cholesky",
    "slogdet_logabs"])
@pytest.mark.parametrize("world", sorted(WORLDS))
def test_distances_and_linalg_against_heat_tpu(worlds, world, name):
    """The spanning worlds' distance and linalg results (equal to the one
    process's bit for bit) against heat_tpu on a mesh of the same p:
    float32 to 2e-5 relative (the quadratic expansion 2e-3 absolute, its
    cancellation), float64 to 1e-10; R up to the signs of its rows."""
    import jax
    from heat_tpu.core.communication import MeshCommunication as RefMesh

    n, per = WORLDS[world]
    comm = RefMesh(jax.devices()[: min(n * per, len(jax.devices()))])
    got = worlds[world]["one"][name]["np"]
    want = _heat_tpu_case(name, comm)
    if name.startswith("qr_"):
        got = got * np.sign(np.diagonal(got))[:, None]
        want = want * np.sign(np.diagonal(want))[:, None]
    tol = 1e-10 if got.dtype == np.float64 else 2e-5
    atol = 2e-3 if "quadratic" in name else tol
    np.testing.assert_allclose(got, want, rtol=tol, atol=atol)


# ---------------------------------------------------------------------------
# the layers over the spanning mesh (A11.5b(c2a)): their oracles and heat_tpu
# ---------------------------------------------------------------------------
SP_TOL, SP_GRAD_TOL = 1e-5, 1e-4  # tests/test_torch_attention.py's
TP_LOSS_RTOL, TP_TOL, MOE_TOL = 1e-6, 1e-5, 1e-4  # tests/test_torch_parallel.py's
EST_TOL = 2e-5  # float32 against float64


def _dense_attention(t, causal):
    """The dense oracle's output and q, k, v gradients under the program's
    weighting."""
    leaves = [torch.from_numpy(t[key]).requires_grad_() for key in ("q", "k", "v")]
    out = ht.nn.dot_product_attention(*leaves, causal=causal)
    (out * torch.from_numpy(t["w_sp"])).sum().backward()
    return {"out": out.detach(), **{f"grad_{k}": leaf.grad for k, leaf in zip("qkv", leaves)}}


def _dense_tp(t, tp):
    """The dense TPMLPBlock of the program's seed: loss, gradients, and the
    output after one SGD step."""
    from torch_spanning_program import SEED

    from heat_tpu_torch import parallel

    x, y = torch.from_numpy(t["x_tp"]), torch.from_numpy(t["y_tp"])
    block = parallel.TPMLPBlock(4 * tp + 1, 6, 6, device="cpu", generator=torch.Generator().manual_seed(SEED))
    loss = ((block(x) - y) ** 2).mean()
    loss.backward()
    out = {"loss": loss.item(), "grad_up_kernel": block.up.kernel[0].grad, "grad_up_bias": block.up.bias[0].grad,
           "grad_down_kernel": block.down.kernel[0].grad, "grad_down_bias": block.down.bias.grad}
    with torch.no_grad():
        for param in block.parameters():
            param -= 0.1 * param.grad
        out["out_after_step"] = block(x)
    return out


def _layer_oracle(name: str, p: int):
    """The oracle of a layer case: (value, rtol, atol), or None."""
    from torch_spanning_program import SEED

    from heat_tpu_torch import parallel

    t = tables()
    for case in SP_CASES:
        for part in ("out", "grad_q", "grad_k", "grad_v"):
            if name == f"{sp_name(*case)}_{part}":
                tol = SP_TOL if part == "out" else SP_GRAD_TOL
                return _dense_attention(t, case[1])[part], tol, tol
    if name.startswith("mha_ring_"):
        mha = ht.nn.MultiHeadAttention(4, 16, backend="dense", causal=True, device="cpu",
                                       generator=torch.Generator().manual_seed(SEED))
        x = torch.from_numpy(t["x_mha"]).requires_grad_()
        out = mha(x)
        (out * out).sum().backward()
        want = {"out": out.detach(), "grad_x": x.grad,
                "grad_params": torch.cat([q.grad.reshape(-1) for q in mha.parameters()])}[name[len("mha_ring_"):]]
        tol = SP_TOL if name.endswith("out") else SP_GRAD_TOL
        return want, tol, tol
    for label, axes in mesh_layouts(p).items():
        if name == f"mesh_{label}_shape":
            return np.array([s for _, s in axes]), 0, 0
        prefix = f"dp_tp_{label}_"
        if name.startswith(prefix):
            part = name[len(prefix):]
            return _dense_tp(t, dict(axes)["tp"])[part], TP_LOSS_RTOL if part == "loss" else TP_TOL, \
                0 if part == "loss" else TP_TOL
    if name.startswith("lm_ring_"):
        lm = ht.nn.TransformerLM(vocab=31, dim=24, depth=2, heads=4, max_len=12, device="cpu",
                                 generator=torch.Generator().manual_seed(SEED))
        tokens = torch.from_numpy(t["lm_tokens"])
        logits = lm(tokens)
        loss = torch.nn.functional.cross_entropy(logits[:, :-1].reshape(-1, 31), tokens[:, 1:].reshape(-1))
        loss.backward()
        if name == "lm_ring_loss":
            return np.float32(loss.item()), SP_TOL, 0
        return torch.cat([q.grad.reshape(-1) for q in lm.parameters()]), SP_GRAD_TOL, SP_GRAD_TOL
    if name.startswith("megatron_pair_"):
        col = parallel.ColumnParallelDense(6, 2 * p + 1, device="cpu", generator=torch.Generator().manual_seed(SEED + 1))
        row = parallel.RowParallelDense(2 * p + 1, 6, device="cpu", generator=torch.Generator().manual_seed(SEED + 2))
        x = torch.from_numpy(t["x_tp"]).requires_grad_()
        out = row(torch.tanh(col(x)))
        (out * out).sum().backward()
        return {"out": out.detach(), "grad_x": x.grad, "grad_col_kernel": col.kernel[0].grad,
                "grad_row_kernel": row.kernel[0].grad}[name[len("megatron_pair_"):]], TP_TOL, TP_TOL
    if name.startswith("pipeline_"):
        stages = 2 if name == "pipeline_named_axis" and p % 2 == 0 else p
        a = t["pp_x"].astype(np.float64)
        for s in range(stages):
            a = np.tanh(a @ t["pp_w"][s] + t["pp_b"][s])
        return a, TP_TOL, TP_TOL
    if name.startswith("convolve_"):
        _, rows, mode = name.split("_")
        return np.convolve(t["conv_x"][: int(rows)].astype(np.float64), t["conv_taps"], mode=mode), EST_TOL, EST_TOL
    if name == "ping_mesh":
        return np.array(["True", str(p), "cpu", "None"]), 0, 0
    return None


@pytest.mark.parametrize("name", [n for n in CASES if n in LAYER_CASES or n.startswith(
    ("mha_", "lm_ring_", "megatron_", "pipeline_", "moe_", "lasso_", "spectral_", "ping_"))])
@pytest.mark.parametrize("world", sorted(WORLDS))
def test_layers_against_their_oracles(worlds, world, name):
    """Each layer's result (equal to the spanning world's bit for bit)
    against its oracle: ring, Ulysses and MultiHeadAttention against dense
    attention and its autograd; the dp x tp step and the Megatron pair
    against the dense block; the pipeline against its stages in sequence;
    the experts against the dense oracle; convolve against numpy; Lasso
    against the fit on one unsplit shard; Spectral's labels one per blob;
    ping_mesh's answer."""
    n, per = WORLDS[world]
    p = n * per
    one = worlds[world]["one"]
    got = one[name]["np"] if isinstance(one[name], dict) else one[name]
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    if name.startswith("moe_grad_"):
        from torch_spanning_program import SEED

        moe = ht.parallel.MoELayer(p, 8, 5, device="cpu", generator=torch.Generator().manual_seed(SEED + 3))
        xg = torch.from_numpy(tables()["moe_x"]).requires_grad_()
        out = moe(xg)
        (out * out).sum().backward()
        want = xg.grad if name == "moe_grad_x" else torch.cat([q.grad.reshape(-1) for q in moe.parameters()])
        np.testing.assert_allclose(got, want.numpy(), rtol=MOE_TOL, atol=MOE_TOL)
        return
    if name.startswith("moe_"):
        np.testing.assert_allclose(got, one["moe_dense"].numpy(), rtol=MOE_TOL, atol=MOE_TOL)
        return
    if name.startswith("lasso_"):
        t = tables()
        label, ysplit = name.split("_")[1:3]
        xk, yk = ("lasso_x", "lasso_y") if label == "tall" else ("lasso_xw", "lasso_yw")
        single = communication.MeshCommunication([torch.device("cpu")])
        est = ht.regression.Lasso(lam=0.1, max_iter=20, tol=None).fit(
            ht.array(t[xk], comm=single), ht.array(t[yk], comm=single))
        np.testing.assert_allclose(got, est.theta.numpy(), rtol=EST_TOL, atol=EST_TOL)
        return
    if name == "spectral_labels":
        labels = got.reshape(-1, K)
        assert len(set(labels[0].tolist())) == K and (labels == labels[0]).all()
        return
    want, rtol, atol = _layer_oracle(name, p)
    want = want.numpy() if isinstance(want, torch.Tensor) else np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if want.dtype.kind in "iuU":  # the layouts and ping_mesh's answer: exact
        np.testing.assert_array_equal(got, want)
        return
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _heat_tpu_layer(name: str, p: int):
    """heat_tpu's value of a ring, Ulysses, pipeline, experts or dp x tp
    case at the same p, as a numpy array (the dp x tp loss and gradients by
    ``jax.value_and_grad`` of its TPMLPBlock from the port's weights)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh as JaxMesh
    from jax.sharding import NamedSharding, PartitionSpec
    from torch_spanning_program import SEED

    from heat_tpu.core.communication import MeshCommunication as RefMesh
    from heat_tpu.nn import attention as ref_attention
    from heat_tpu.parallel import expert as ref_expert
    from heat_tpu.parallel import pipeline as ref_pipeline
    from heat_tpu.parallel import tensor as ref_tensor
    from heat_tpu_torch import parallel

    t = tables()
    devices = jax.devices()[:p]
    for fn, causal, block in SP_CASES:
        if name == f"{sp_name(fn, causal, block)}_out":
            comm = RefMesh(devices)
            sharded = [jax.device_put(jnp.asarray(t[key]), comm.sharding(4, 1)) for key in ("q", "k", "v")]
            kwargs = {"block_size": block} if fn == "ulysses" else {}
            return np.asarray(getattr(ref_attention, f"{fn}_attention")(*sharded, comm=comm, causal=causal, **kwargs))
    if name.startswith("pipeline_"):
        microbatches = 12 if name == "pipeline_microbatches" else None
        stacked = {"w": jnp.asarray(t["pp_w"][:p]), "b": jnp.asarray(t["pp_b"][:p])}
        return np.asarray(ref_pipeline.pipeline_apply(
            lambda sp, a: jnp.tanh(a @ sp["w"] + sp["b"]), stacked, jnp.asarray(t["pp_x"]),
            JaxMesh(np.array(devices), ("pp",)), axis="pp", n_microbatches=microbatches))
    if name == "moe_mesh":
        moe = parallel.MoELayer(p, 8, 5, device="cpu", generator=torch.Generator().manual_seed(SEED + 3))
        mesh = JaxMesh(np.array(devices), ("ep",))
        xs = jax.device_put(jnp.asarray(t["moe_x"]), NamedSharding(mesh, PartitionSpec("ep", None)))
        weights = [jnp.asarray(w.detach().numpy()) for w in (moe.wi, moe.wo, moe.router)]
        return np.asarray(ref_expert.moe_apply(ref_expert.MoELayer.expert_fn, tuple(weights[:2]), weights[2], xs,
                                               mesh, "ep"))
    label = next(lab for lab in MESH_LAYOUTS if name.startswith(f"dp_tp_{lab}_"))
    part = name[len(f"dp_tp_{label}_"):]
    tp = dict(mesh_layouts(p)[label])["tp"]
    block = parallel.TPMLPBlock(4 * tp + 1, 6, 6, device="cpu", generator=torch.Generator().manual_seed(SEED))
    params = {"up": {"kernel": block.up.kernel[0], "bias": block.up.bias[0]},
              "down": {"kernel": block.down.kernel[0], "bias": block.down.bias}}
    params = jax.tree.map(lambda w: jnp.asarray(w.detach().numpy()), params)
    model = ref_tensor.TPMLPBlock(hidden=4 * tp + 1, features=6)

    def loss_fn(prm):
        return jnp.mean((model.apply({"params": prm}, jnp.asarray(t["x_tp"])) - jnp.asarray(t["y_tp"])) ** 2)

    loss, grads = jax.value_and_grad(loss_fn)(params)
    if part == "loss":
        return np.asarray(loss)
    layer, leaf = part[len("grad_"):].split("_")
    return np.asarray(grads[layer][leaf])


@pytest.mark.parametrize("name", [f"{sp_name(*case)}_out" for case in SP_CASES] + [
    "pipeline_all_ranks", "pipeline_microbatches", "moe_mesh"] + [
    f"dp_tp_{label}_{part}" for label in MESH_LAYOUTS for part in (
        "loss", "grad_up_kernel", "grad_up_bias", "grad_down_kernel", "grad_down_bias")])
@pytest.mark.parametrize("world", sorted(WORLDS))
def test_layers_against_heat_tpu(worlds, world, name):
    """The spanning worlds' layers (equal to the one process's bit for bit)
    against heat_tpu at the same p, within tests/test_torch_attention.py's
    and tests/test_torch_parallel.py's tolerances."""
    n, per = WORLDS[world]
    one = worlds[world]["one"][name]
    got = np.asarray(one.numpy() if isinstance(one, torch.Tensor) else one)
    want = _heat_tpu_layer(name, n * per)
    if name.endswith("_loss"):
        np.testing.assert_allclose(got, want, rtol=TP_LOSS_RTOL)
        return
    tol = SP_TOL if name.startswith(("ring", "ulysses")) else MOE_TOL if name.startswith("moe") else TP_TOL
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_each_process_holds_its_own_ranks(worlds, world):
    """Process q holds ranks ``first_rank`` on, its ``lshape`` the chunk
    of its first rank (heat_tpu/core/dndarray.py:401-413)."""
    n, per = WORLDS[world]
    procs = worlds[world]["procs"]
    assert [(d["first_rank"], d["local"]) for d in procs] == [(q * per, per) for q in range(n)]
    one = communication.MeshCommunication([torch.device("cpu")] * (n * per))
    shapes = [(7, 5), (7, 5), (5, 3), (4, 3)]
    for q, d in enumerate(procs):
        want = [one.chunk(s, split, rank=q * per)[1] for s, split in zip(shapes, (0, 1, 0, 0))]
        assert [tuple(s) for s in d["lshapes"]] == want


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_an_unseeded_stream_is_process_zeros_everywhere(worlds, world):
    got = [d["unseeded"] for d in worlds[world]["procs"]]
    assert all(np.array_equal(g, got[0]) for g in got) and got[0].shape == (3,)


@pytest.mark.parametrize("at", ["same", "one", "more"])
@pytest.mark.parametrize("world", sorted(WORLDS))
def test_checkpoint_restores_into_one_process(worlds, world, at):
    """The world's checkpoint restored into this process on one shard, on
    the world's p and on p + 1, bit for bit, after it verifies clean."""
    n, per = WORLDS[world]
    p = {"same": n * per, "one": 1, "more": n * per + 1}[at]
    restores = worlds[world]["restores"]
    assert restores["problems"] == []
    t = tables()
    got = restores[p]
    for key, want in (("x", t["f7"]), ("xe", t["f5"]), ("y", t["f7"])):
        assert got[key].dtype == want.dtype and got[key].tobytes() == want.tobytes(), key
    assert got["n"] == 3
    assert got["centers"].tobytes() == worlds[world]["one"]["kmeans_batchparallel_centers"]["np"].tobytes()


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_each_process_receipt_names_its_own_ranks_fragments(worlds, world):
    """Each process wrote, and its receipt lists, the fragments of its own
    ranks with logical rows; the owner also the replicated leaves."""
    n, per = WORLDS[world]
    p = n * per
    one = communication.MeshCommunication([torch.device("cpu")] * p)
    receipts = worlds[world]["receipts"]
    for q in range(n):
        want = set()
        # the leaves in sorted key order: centers, n, x, xe, y
        for leaf, (shape, split) in zip((2, 3, 4), (((7, 5), 0), ((5, 3), 0), ((7, 5), 1))):
            counts, _ = one.counts_displs_shape(shape, split)
            want |= {f"leaf_{leaf:05d}.shard_{r:05d}" for r in range(q * per, (q + 1) * per) if counts[r]}
        shards = {f for f in receipts[q] if ".shard_0" in f}
        assert shards == want, (q, receipts[q])
        assert any(f.endswith(".shard_full") for f in receipts[q]) == (q == 0)


# ---------------------------------------------------------------------------
# C19 across spanning meshes; the mocked seam against heat_tpu's
# ---------------------------------------------------------------------------
def _mock(counts, process=0):
    per = counts[process]
    return communication.ProcessMeshCommunication([torch.device("cpu")] * per, counts, process, None, None)


@pytest.mark.parametrize("other", [(2, 1), (2, 2)])
def test_two_spanning_meshes_do_not_combine(other):
    """Spanning meshes compare by identity (C19): another mesh, of another
    rank count or of the same, is refused before any verb runs."""
    a = ht.ones((8, 2), split=0, comm=_mock((2, 2)))
    b = ht.ones((8, 2), split=0, comm=_mock(other))
    with pytest.raises(ValueError, match="different meshes"):
        a + b
    assert (a * 2).comm is a.comm


def _fake_devices(assignment):
    return [pytypes.SimpleNamespace(process_index=p, id=i) for i, p in enumerate(assignment)]


def test_sharded_ingest_routes_through_seam(tmp_path):
    """tests/test_multihost_seam.py:55-77: the sharded ingest asks the seam
    which ranks to read, in heat_tpu and in the port; on a mocked second
    process of a 2 x 2 world the port reads its two ranks' rows only."""
    data = np.arange(4 * 4 * 3, dtype=np.float32).reshape(16, 3)
    path = str(tmp_path / "x.npy")
    np.save(path, data)
    with unittest.mock.patch.object(ref_mh, "ranks_to_read", wraps=ref_mh.ranks_to_read) as ref_spy:
        want = ref.load_npy(path, split=0)
    with unittest.mock.patch.object(multihost, "ranks_to_read", wraps=multihost.ranks_to_read) as spy:
        mine = ht.load_npy(path, split=0, comm=_mock((2, 2), 1))
    assert ref_spy.called and spy.called
    assert spy.call_args.args[1] == 1  # the mesh's process, not the live world's
    np.testing.assert_array_equal(np.concatenate([b for _, b in mine.ranked_shards()]), want.numpy()[8:])
    assert [r for r, _ in mine.ranked_shards()] == [2, 3]


def test_lshape_reports_this_processes_shard():
    """tests/test_multihost_seam.py:79-89: ``lshape`` is the chunk of this
    process's first rank, in heat_tpu's seam and in the port's."""
    p = 4
    want = ref.ones((2 * p + 1, 3), split=0)
    assert ht.ones((2 * p + 1, 3), split=0, comm=communication.MeshCommunication([torch.device("cpu")] * p)).lshape \
        == (-(-(2 * p + 1) // p), 3)
    assert want.lshape[1] == 3
    devs = _fake_devices([0] * 2 + [1] * 2)
    assert multihost.representative_rank(devs, proc=1) == ref_mh.representative_rank(devs, proc=1) == 2
    second = ht.ones((2 * p + 1, 3), split=0, comm=_mock((2, 2), 1))
    assert second.lshape == communication.MeshCommunication([torch.device("cpu")] * p).chunk((9, 3), 0, rank=2)[1]
    # 9 rows on 4 ranks: 3, 3, 3, 0; rank 3 holds no row to yield
    assert second.lshape == (3, 3) and [r for r, _ in second.ranked_shards()] == [2]


def test_the_recorder_stays_eager_on_a_spanning_mesh():
    """A chain that one process forces and another does not would call the
    verbs in another order in each: over a spanning mesh every engine runs
    eagerly, with the reason ``spans_processes``; the same ops over a
    one-process mesh of the same device defer as before."""
    from heat_tpu_torch.core import telemetry

    prev, was = telemetry.set_mode(1), fusion.set_enabled(True)
    telemetry.reset()
    try:
        x = ht.ones((8, 2), split=0, comm=_mock((2, 2), 1))
        y = ht.exp(x + 1)
        spanning = telemetry.unfused_reasons()
        telemetry.reset()
        ht.exp(ht.ones((8, 2), split=0, comm=communication.MeshCommunication([torch.device("cpu")] * 2)) + 1)
        in_process = telemetry.unfused_reasons()
    finally:
        fusion.set_enabled(was)
        telemetry.set_mode(prev)
        telemetry.reset()
    assert spanning["binary"] == {"spans_processes": 1} and spanning["local"] == {"spans_processes": 1}
    assert not isinstance(y._payload, fusion.LazyArray) and len(y.shards) == 2
    assert "spans_processes" not in in_process.get("binary", {})
