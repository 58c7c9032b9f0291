"""The fixed program of tests/test_torch_spanning.py, which every process
of a gloo world runs on its process-spanning mesh and the test process on
the one-process mesh of the same p. It imports the port only: the workers
start without JAX."""

from __future__ import annotations

import os

import numpy as np

import heat_tpu_torch as ht
from heat_tpu_torch.nn._init import BatchNorm
from heat_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

SEED, K = 11, 3


def tables():
    """The program's inputs, the same in every process: 7 rows (ragged on
    2 x 2 and 3 x 1), 5 float64 rows (an empty rank on 2 x 2), 4 int64 rows
    (an empty rank on 3 x 1), 48 rows of blobs around three means, and 10
    float32 rows of the f7 table's 5 features."""
    rng = np.random.default_rng(SEED)
    means = rng.standard_normal((K, 4)) * 6.0
    blobs = (rng.standard_normal((48, 4)) + means[np.arange(48) % K]).astype(np.float32)
    out = {
        "f7": rng.standard_normal((7, 5)).astype(np.float32),
        "f5": rng.standard_normal((5, 3)),
        "i4": rng.integers(-9, 9, (4, 3)).astype(np.int64),
        "blobs": blobs,
    }
    out["g10"] = rng.standard_normal((10, 5)).astype(np.float32)
    # linalg: a (5, 6) factor, tall operands (one of cond 1e5), a wide one
    # for the panel QR, an SPD matrix, a lower triangle and right-hand sides
    out["h56"] = rng.standard_normal((5, 6)).astype(np.float32)
    out["tall"] = rng.standard_normal((20, 3))
    u = np.linalg.qr(rng.standard_normal((20, 3)))[0]
    v = np.linalg.qr(rng.standard_normal((3, 3)))[0]
    out["ill"] = ((u * np.logspace(0, -5, 3)) @ v.T).astype(np.float32)
    out["wide"] = rng.standard_normal((12, 10))
    m = rng.standard_normal((9, 9))
    out["spd"] = m @ m.T + 9 * np.eye(9)
    out["tri"] = np.tril(rng.standard_normal((9, 9))) + 4 * np.eye(9)
    out["rhs"] = rng.standard_normal((9, 2))
    # training: 12 NHWC images of 8 x 8 x 3 and three classes
    out["images"] = rng.standard_normal((12, 8, 8, 3)).astype(np.float32)
    out["labels"] = rng.integers(0, K, 12).astype(np.int64)
    return out


def linalg(comm, t, rec) -> None:
    """matmul over every split pair of ragged operands; qr by CholQR2, TSQR,
    the probe's fallback on cond 1e5 and the split-1 panel QR (the
    schedules each call ran recorded); the blocked triangular solve, solve,
    cholesky, slogdet and det."""
    import importlib

    methods = importlib.import_module("heat_tpu_torch.core.linalg.qr")._METHODS
    for sa in (None, 0, 1):
        for sb in (None, 0, 1):
            a = ht.array(t["f7"], split=sa, comm=comm)
            rec(f"matmul_{sa}_{sb}", ht.matmul(a, ht.array(t["h56"], split=sb, comm=comm)))
    schedules = []

    def qr(name, a, **kwargs):
        before = dict(methods)
        q, r = ht.linalg.qr(a, **kwargs)
        schedules.extend(k for k in methods if methods[k] != before.get(k, 0))
        rec(f"qr_{name}_q", q)
        rec(f"qr_{name}_r", r)

    tall = ht.array(t["tall"], split=0, comm=comm)
    qr("auto", tall)
    qr("tsqr", tall, method="tsqr")
    qr("cholqr2", tall, method="cholqr2")
    qr("fallback", ht.array(t["ill"], split=0, comm=comm))
    qr("panel", ht.array(t["wide"], split=1, comm=comm))
    rec("qr_schedules", np.array(schedules))
    tri = ht.array(t["tri"], split=0, comm=comm)
    rhs = ht.array(t["rhs"], split=0, comm=comm)
    rec("solve_triangular_lower", ht.linalg.solve_triangular(tri, rhs, lower=True))
    rec("solve_triangular_upper_vector", ht.linalg.solve_triangular(
        ht.array(t["tri"].T.copy(), split=1, comm=comm), ht.array(t["rhs"][:, 0].copy(), comm=comm)))
    spd = ht.array(t["spd"], split=0, comm=comm)
    rec("solve", ht.linalg.solve(spd, rhs))
    rec("cholesky", ht.linalg.cholesky(spd))
    rec("cholesky_split1", ht.linalg.cholesky(ht.array(t["spd"], split=1, comm=comm)))
    sign, logabs = ht.linalg.slogdet(spd)
    rec("slogdet_sign", sign)
    rec("slogdet_logabs", logabs)
    rec("det_tri", ht.linalg.det(tri))


def training(comm, t, rec, nodes) -> None:
    """Two DataParallel steps of a small ResNet with BatchNorm (7 rows, then
    5: an empty rank on 4), the parameters and running averages after each,
    and the same of a network whose BatchNorm sees 64 rows per image; two
    DASO steps of the ResNet with ``nodes`` groups."""
    import torch

    def net():
        return ht.nn.ResNet((1, 1), num_classes=K, num_filters=4, generator=torch.Generator().manual_seed(SEED))

    def flat(tensors):
        return torch.cat([v.detach().reshape(-1) for v in tensors])

    class Tokens(torch.nn.Module):
        """A BatchNorm over tokens: each image's pixels flattened into rows
        of its channels before the norm, so the norm's rows are not the
        batch's."""

        def __init__(self):
            super().__init__()
            gen = torch.Generator().manual_seed(SEED)
            self.proj = torch.nn.Parameter(torch.randn(3, 4, generator=gen))
            self.norm = BatchNorm(4, device=comm.home)
            self.head = torch.nn.Parameter(torch.randn(4, K, generator=gen))

        def forward(self, x, train=False):
            tokens = self.norm(x.reshape(-1, 3) @ self.proj, train=train)
            return tokens.reshape(x.shape[:3] + (4,)).mean((1, 2)) @ self.head

    images, labels = t["images"], t["labels"]
    for label, model in (("dp", net), ("dp_tokens", Tokens)):
        dp = ht.nn.DataParallel(model(), comm=comm, optimizer=ht.optim.SGD(0.1)).init(SEED, images[:2])
        for i, (lo, hi) in enumerate(((0, 7), (7, 12))):
            rec(f"{label}_loss_{i}", dp.train_step(images[lo:hi], labels[lo:hi]))
            rec(f"{label}_params_{i}", flat(dp.module.parameters()))
            rec(f"{label}_buffers_{i}", flat(dp.module.buffers()))
    daso = ht.optim.DASO(ht.optim.SGD(0.1), total_epochs=8, comm=comm, nodes=nodes)
    daso.add_model(net(), SEED, images[:2])
    for i in range(2):
        rec(f"daso_loss_{i}", daso.step(images, labels))
        rec(f"daso_params_{i}", flat(daso.module.parameters()))
        # the running averages are each group's: one block per rank
        out = {"np": np.zeros(0), "split": 0, "lshape": (), "blocks": {
            r: flat(replica.buffers()) for r, replica in zip(comm.local_ranks, daso.replicas)}}
        rec(f"daso_buffers_{i}", out)


def distances(comm, t, rec) -> None:
    """The distance rings over split-0 operands of 7 and 10 rows (C25), the
    quadratic expansion in their tiles, and the one-block path of a
    replicated operand."""
    a = ht.array(t["f7"], split=0, comm=comm)
    b = ht.array(t["g10"], split=0, comm=comm)
    rec("cdist_7_10", ht.spatial.cdist(a, b))
    rec("cdist_10_7", ht.spatial.cdist(b, a))
    rec("cdist_7_self", ht.spatial.cdist(a, a))
    rec("cdist_10_self", ht.spatial.cdist(b))
    rec("rbf_7_10", ht.spatial.rbf(a, b, sigma=1.5))
    rec("rbf_10_self", ht.spatial.rbf(b, sigma=1.5))
    rec("manhattan_10_7", ht.spatial.manhattan(b, a))
    rec("cdist_quadratic_7_10", ht.spatial.cdist(a, b, quadratic_expansion=True))
    rec("cdist_quadratic_10_self", ht.spatial.cdist(b, quadratic_expansion=True))
    rec("rbf_quadratic_7_self", ht.spatial.rbf(a, quadratic_expansion=True))
    rec("cdist_7_replicated", ht.spatial.cdist(a, ht.array(t["g10"], comm=comm)))


def _record(comm, x):
    """A result as the test compares it: the host array every process
    reads, and this process's logical blocks by global rank (a record of
    that form passes as it is)."""
    if not isinstance(x, ht.DNDarray):
        return x
    blocks = {} if x.split is None else {r: b.clone() for r, b in zip(comm.local_ranks, x.lshards)}
    return {"np": x.numpy(), "split": x.split, "lshape": x.lshape, "blocks": blocks}


def program(comm, workdir: str, nodes: int) -> dict:
    """The fixed program, on ``comm``: every process of a world calls it
    with the world's mesh; the test process with a one-process mesh.
    ``nodes`` is the world's process count, DASO's group count."""
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
    distances(comm, t, rec)
    linalg(comm, t, rec)
    training(comm, t, rec, nodes)
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
