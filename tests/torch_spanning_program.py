"""The fixed program of tests/test_torch_spanning.py, which every process
of a gloo world runs on its process-spanning mesh and the test process on
the one-process mesh of the same p. It imports the port only: the workers
start without JAX."""

from __future__ import annotations

import os

import numpy as np

import heat_tpu_torch as ht
from heat_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

SEED, K = 11, 3


def tables():
    """The program's inputs, the same in every process: 7 rows (ragged on
    2 x 2 and 3 x 1), 5 float64 rows (an empty rank on 2 x 2), 4 int64 rows
    (an empty rank on 3 x 1), and 48 rows of blobs around three means."""
    rng = np.random.default_rng(SEED)
    means = rng.standard_normal((K, 4)) * 6.0
    blobs = (rng.standard_normal((48, 4)) + means[np.arange(48) % K]).astype(np.float32)
    return {
        "f7": rng.standard_normal((7, 5)).astype(np.float32),
        "f5": rng.standard_normal((5, 3)),
        "i4": rng.integers(-9, 9, (4, 3)).astype(np.int64),
        "blobs": blobs,
    }


def _record(comm, x):
    """A result as the test compares it: the host array every process
    reads, and this process's logical blocks by global rank."""
    if not isinstance(x, ht.DNDarray):
        return x
    blocks = {} if x.split is None else {r: b.clone() for r, b in zip(comm.local_ranks, x.lshards)}
    return {"np": x.numpy(), "split": x.split, "lshape": x.lshape, "blocks": blocks}


def program(comm, workdir: str) -> dict:
    """The fixed program, on ``comm``: every process of a world calls it
    with the world's mesh; the test process with a one-process mesh."""
    t = tables()
    out = {}

    def rec(name, x):
        out[name] = _record(comm, x)

    # factories, ragged rows and empty ranks
    for name in ("f7", "f5", "i4"):
        for split in (None, 0, 1):
            rec(f"array_{name}_{split}", ht.array(t[name], split=split, comm=comm))
    rec("arange", ht.arange(7, split=0, comm=comm))
    rec("zeros", ht.zeros((5, 3), split=1, comm=comm))
    rec("full", ht.full((4, 3), 2.5, split=0, comm=comm))
    rec("linspace", ht.linspace(0.0, 1.0, 7, split=0, comm=comm))
    rec("eye", ht.eye(5, split=1, comm=comm))
    # the global stream, drawn whole in every process
    ht.random.seed(3)
    rec("randn", ht.random.randn(7, 5, split=0, comm=comm))
    rec("randint", ht.random.randint(0, 10, (5, 3), split=1, comm=comm))
    rec("rand_replicated", ht.random.rand(4, comm=comm))
    # the engines
    x = ht.array(t["f7"], split=0, comm=comm)
    y = ht.array(t["f7"], split=1, comm=comm)
    r = ht.array(t["f7"][0], comm=comm)
    xe = ht.array(t["f5"], split=0, comm=comm)
    xi = ht.array(t["i4"], split=0, comm=comm)
    rec("add_replicated", x + r)
    rec("mul_scalar", x * 2)
    rec("add_other_split", x + y)
    rec("sub_ints", xi - 3)
    rec("exp", ht.exp(x))
    rec("sqrt_abs", ht.sqrt(ht.abs(xe)))
    for label, a in (("x", x), ("xe", xe), ("xi", xi), ("y", y)):
        for axis in (None, 0, 1):
            for fn in ("sum", "mean", "var", "std", "min", "max", "argmax"):
                rec(f"{fn}_{label}_{axis}", getattr(ht, fn)(a, axis=axis))
        rec(f"argmin_{label}_0", ht.argmin(a, axis=0))
        rec(f"cumsum_{label}_0", ht.cumsum(a, 0))
        rec(f"cumsum_{label}_1", ht.cumsum(a, 1))
    rec("cumprod_xi_0", ht.cumprod(xi, 0))
    # resplit between None, 0 and 1
    rec("resplit_0_1", ht.resplit(x, 1))
    rec("resplit_0_none", ht.resplit(x, None))
    rec("resplit_1_0", ht.resplit(y, 0))
    rec("resplit_none_0", ht.resplit(r, 0))
    rec("resplit_none_1", ht.resplit(ht.array(t["f7"], comm=comm), 1))
    # the merge-exchange sort, unique and the halo exchange address global ranks
    values, indices = ht.sort(xe, axis=0)
    rec("sort_xe_values", values)
    rec("sort_xe_indices", indices)
    rec("unique_xi", ht.unique(xi))
    halo = ht.array(t["f7"], split=0, comm=comm)
    halo.get_halo(1)
    rec("halos", halo.array_with_halos)
    # indexing: a shard-wise key, a key that cuts the split, writes
    rec("getitem_columns", x[:, 1:3])
    rec("getitem_rows", x[1:6:2])
    z = ht.array(t["f7"], split=0, comm=comm)
    z[:, 0] = 1.5
    z[2:6, 1] = ht.array(np.arange(4.0, dtype=np.float32), comm=comm)
    rec("setitem", z)
    d = ht.zeros((5, 5), split=0, comm=comm)
    rec("fill_diagonal", d.fill_diagonal(2.0))
    # host reads
    rec("item_sum", ht.sum(x).item())
    rec("item_one_row", ht.array([3.5], split=0, comm=comm).item())
    rec("lshapes", [a.lshape for a in (x, y, xe, xi)])
    # the ingest
    path = os.path.join(workdir, "f7.npy")
    rec("load_npy_0", ht.load_npy(path, split=0, comm=comm))
    rec("load_npy_1", ht.load_npy(path, split=1, comm=comm))
    # the fits
    blobs = ht.array(t["blobs"], split=0, comm=comm)
    fits = {}
    for init in ("batchparallel", "random"):
        km = ht.cluster.KMeans(n_clusters=K, init=init, max_iter=6, random_state=5).fit(blobs)
        fits[init] = km
        rec(f"kmeans_{init}_centers", km.cluster_centers_)
        rec(f"kmeans_{init}_labels", km.labels_)
        rec(f"kmeans_{init}_inertia", km.inertia_)
    # the checkpoint, saved and restored in the same world
    ckpt = os.path.join(workdir, "ckpt")
    tree = {"x": x, "xe": xe, "y": y, "centers": fits["batchparallel"].cluster_centers_, "n": 3}
    save_checkpoint(ckpt, tree, step=1)
    template = {"x": ht.zeros((7, 5), split=0, comm=comm), "xe": ht.zeros((5, 3), dtype=ht.float64, split=1,
                comm=comm), "y": ht.zeros((7, 5), split=0, comm=comm), "centers": ht.zeros((K, 4), comm=comm),
                "n": 0}
    back = load_checkpoint(ckpt, template, step=1)
    for key in ("x", "xe", "y", "centers"):
        rec(f"restored_{key}", back[key])
    rec("restored_n", back["n"])
    return out
