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
    # the layers: q, k, v and a weighting of the output; a MultiHeadAttention input
    for key in ("q", "k", "v", "w_sp"):
        out[key] = rng.standard_normal(SP_SHAPE).astype(np.float32)
    out["x_mha"] = rng.standard_normal((2, 12, 16)).astype(np.float32)
    out["lm_tokens"] = rng.integers(0, 31, (2, 12)).astype(np.int64)
    # parallel/: a dp x tp batch, a pipeline's stages and input, the experts' tokens
    out["x_tp"] = rng.standard_normal((8, 6)).astype(np.float32)
    out["y_tp"] = rng.standard_normal((8, 6)).astype(np.float32)
    out["pp_w"] = (rng.standard_normal((4, 5, 5)) * 0.5).astype(np.float32)
    out["pp_b"] = rng.standard_normal((4, 5)).astype(np.float32)
    out["pp_x"] = rng.standard_normal((12, 3, 5)).astype(np.float32)
    out["moe_x"] = rng.standard_normal((12, 5)).astype(np.float32)
    # estimators: a signal and its taps; Lasso's tall and wide tables with
    # unit mean-square columns
    out["conv_x"] = rng.standard_normal(23).astype(np.float32)
    out["conv_taps"] = rng.standard_normal(5).astype(np.float32)
    for key, shape in (("lasso_x", (40, 5)), ("lasso_xw", (6, 9))):
        a = rng.standard_normal(shape)
        out[key] = (a / np.sqrt((a * a).mean(0))).astype(np.float32)
        out[key.replace("x", "y")] = (a @ rng.standard_normal(shape[1]) + 0.1 * rng.standard_normal(shape[0])).astype(
            np.float32)
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


def laplacians(comm, t, rec) -> None:
    """The fully connected rbf Laplacian of split-0 tables of 7 and 10 rows
    (C27), in both definitions."""
    for rows, key in ((7, "f7"), (10, "g10")):
        x = ht.array(t[key], split=0, comm=comm)
        for definition in ("simple", "norm_sym"):
            lap = ht.graph.Laplacian(lambda z: ht.spatial.rbf(z, sigma=1.5), definition=definition,
                                     mode="fully_connected")
            rec(f"laplacian_{definition}_{rows}", lap.construct(x))


#: ring and Ulysses over every world: S and H divisible by 4 and by 3
SP_SHAPE = (2, 12, 12, 4)
SP_CASES = [(fn, causal, block) for fn in ("ring", "ulysses") for causal in (False, True)
            for block in ((0, 5) if fn == "ulysses" else (0,))]


def sp_name(fn, causal, block) -> str:
    return f"{fn}_{'causal' if causal else 'full'}" + (f"_block{block}" if block else "")


def attention(comm, t, rec) -> None:
    """Ring and Ulysses (dense and blockwise local attention), causal and
    not: the output and the gradients of q, k and v under a fixed weighting;
    MultiHeadAttention's ring backend: its output and the gradients of its
    input and of its parameters."""
    import torch

    for fn, causal, block in SP_CASES:
        leaves = [torch.from_numpy(t[key]).requires_grad_() for key in ("q", "k", "v")]
        kwargs = {"block_size": block} if fn == "ulysses" else {}
        out = getattr(ht.nn, f"{fn}_attention")(*leaves, causal=causal, comm=comm, **kwargs)
        (out * torch.from_numpy(t["w_sp"])).sum().backward()
        name = sp_name(fn, causal, block)
        rec(f"{name}_out", out.detach())
        for key, leaf in zip("qkv", leaves):
            rec(f"{name}_grad_{key}", leaf.grad)
    mha = ht.nn.MultiHeadAttention(4, 16, backend="ring", causal=True, device="cpu",
                                   generator=torch.Generator().manual_seed(SEED))
    x = torch.from_numpy(t["x_mha"]).requires_grad_()
    out = mha(x, comm)
    (out * out).sum().backward()
    rec("mha_ring_out", out.detach())
    rec("mha_ring_grad_x", x.grad)
    rec("mha_ring_grad_params", torch.cat([p.grad.reshape(-1) for p in mha.parameters()]))
    # a two-layer TransformerLM through the ring: the next-token loss and
    # every parameter's gradient (the key bias's sums the joined gradient)
    lm = ht.nn.TransformerLM(vocab=31, dim=24, depth=2, heads=4, max_len=12, device="cpu",
                             generator=torch.Generator().manual_seed(SEED),
                             attention_fn=lambda q, k, v, causal: ht.nn.ring_attention(q, k, v, causal=causal, comm=comm))
    tokens = torch.from_numpy(t["lm_tokens"])
    logits = lm(tokens)
    loss = torch.nn.functional.cross_entropy(logits[:, :-1].reshape(-1, 31), tokens[:, 1:].reshape(-1))
    loss.backward()
    rec("lm_ring_loss", loss.item())
    rec("lm_ring_grads", torch.cat([p.grad.reshape(-1) for p in lm.parameters()]))


def mesh_layouts(p: int):
    """The dp x tp layouts of a world of p ranks: on 2 x 2 'tp' inside a
    process and 'tp' across the processes; on 3 x 1 'tp' of one rank and
    'tp' across every process."""
    if p == 4:
        return {"tp_inside": [("dp", 2), ("tp", 2)], "tp_across": [("tp", 2), ("dp", 2)]}
    return {"tp_inside": [("dp", p), ("tp", 1)], "tp_across": [("dp", 1), ("tp", p)]}


MESH_LAYOUTS = ("tp_inside", "tp_across")


def parallel_layers(comm, t, rec) -> None:
    """parallel/: the dp x tp step of a TPMLPBlock on each layout (loss,
    output, every parameter's gradient joined over its 'tp' line, and the
    output after one SGD update); the Megatron pair on the mesh's own line;
    the pipeline over the mesh and over a named axis; the experts."""
    import torch

    from heat_tpu_torch import parallel

    p = comm.size
    x, y = torch.from_numpy(t["x_tp"]), torch.from_numpy(t["y_tp"])
    for label, axes in mesh_layouts(p).items():
        mesh = parallel.make_mesh(axes, comm=comm)
        rec(f"mesh_{label}_shape", np.array([mesh.shape[name] for name, _ in axes]))
        tp = dict(axes)["tp"]
        block = parallel.TPMLPBlock(4 * tp + 1, 6, 6, comm=mesh, device="cpu",
                                    generator=torch.Generator().manual_seed(SEED))
        loss = ((block(x) - y) ** 2).mean()
        loss.backward()
        rec(f"dp_tp_{label}_loss", loss.item())
        line = parallel._mesh.axis_comm(mesh, "tp")
        for name, layer, dim in (("up_kernel", block.up.kernel, 1), ("up_bias", block.up.bias, 0),
                                 ("down_kernel", block.down.kernel, 0)):
            rec(f"dp_tp_{label}_grad_{name}", line.allgather([b.grad for b in layer], dim=dim)[0])
        rec(f"dp_tp_{label}_grad_down_bias", block.down.bias.grad)
        with torch.no_grad():
            for param in block.parameters():
                param -= 0.1 * param.grad
            rec(f"dp_tp_{label}_out_after_step", block(x))
    # the pair on the mesh itself, a line of every rank, with an input that
    # takes a gradient (summed over the ranks across processes)
    col = parallel.ColumnParallelDense(6, 2 * p + 1, comm=comm, device="cpu",
                                       generator=torch.Generator().manual_seed(SEED + 1))
    row = parallel.RowParallelDense(2 * p + 1, 6, comm=comm, device="cpu",
                                    generator=torch.Generator().manual_seed(SEED + 2))
    xg = x.clone().requires_grad_()
    out = row([torch.tanh(h) for h in col(xg)])
    (out * out).sum().backward()
    rec("megatron_pair_out", out.detach())
    rec("megatron_pair_grad_x", xg.grad)
    rec("megatron_pair_grad_col_kernel", comm.allgather([k.grad for k in col.kernel], dim=1)[0])
    rec("megatron_pair_grad_row_kernel", comm.allgather([k.grad for k in row.kernel], dim=0)[0])
    # the pipeline: every rank a stage, then two stages on a named axis
    stage = lambda prm, a: torch.tanh(a @ prm["w"] + prm["b"])  # noqa: E731
    stacked = {"w": torch.from_numpy(t["pp_w"][:p]), "b": torch.from_numpy(t["pp_b"][:p])}
    acts = torch.from_numpy(t["pp_x"])
    rec("pipeline_all_ranks", parallel.pipeline_apply(stage, stacked, acts, comm))
    rec("pipeline_microbatches", parallel.pipeline_apply(stage, stacked, acts, comm, n_microbatches=12))
    pp = 2 if p % 2 == 0 else p
    mesh = parallel.make_mesh([("dp", p // pp), ("pp", pp)], comm=comm)
    rec("pipeline_named_axis", parallel.pipeline_apply(stage, {k: v[:pp] for k, v in stacked.items()}, acts, mesh))
    # the experts: one per rank, on the mesh and on a named axis
    moe = parallel.MoELayer(p, 8, 5, device="cpu", generator=torch.Generator().manual_seed(SEED + 3))
    tokens = torch.from_numpy(t["moe_x"])
    rec("moe_mesh", moe(tokens, comm))
    rec("moe_named_axis", moe(tokens, parallel.make_mesh([("ep", p)], comm=comm)))
    rec("moe_dense", moe(tokens))
    # the experts' gradients: of the tokens and of the router and experts
    xg = tokens.clone().requires_grad_()
    out = moe(xg, comm)
    (out * out).sum().backward()
    rec("moe_grad_x", xg.grad)
    rec("moe_grad_params", torch.cat([q.grad.reshape(-1) for q in moe.parameters()]))


def estimators(comm, t, rec) -> None:
    """convolve in every mode over a ragged split signal (halos narrower
    than a shard, and one wider: the whole-signal path); Lasso by both
    sweeps over split rows, with y split and replicated; Spectral's labels
    and embedding's eigenvalues; ping_mesh's answer."""
    from heat_tpu_torch.utils import health

    taps = ht.array(t["conv_taps"], comm=comm)
    for rows in (23, 10):
        signal = ht.array(t["conv_x"][:rows], split=0, comm=comm)
        for mode in ("full", "same", "valid"):
            rec(f"convolve_{rows}_{mode}", ht.convolve(signal, taps, mode=mode))
    for label, (xk, yk) in (("tall", ("lasso_x", "lasso_y")), ("wide", ("lasso_xw", "lasso_yw"))):
        x = ht.array(t[xk], split=0, comm=comm)
        for ysplit in (0, None):
            est = ht.regression.Lasso(lam=0.1, max_iter=20, tol=None).fit(x, ht.array(t[yk], split=ysplit, comm=comm))
            rec(f"lasso_{label}_y{ysplit}_theta", est.theta)
    spectral = ht.cluster.Spectral(n_clusters=K, gamma=0.1, n_lanczos=24, random_state=5, max_iter=10)
    spectral.fit(ht.array(t["blobs"], split=0, comm=comm))
    rec("spectral_labels", spectral.labels_)
    info = health.ping_mesh(comm, timeout=60.0)
    rec("ping_mesh", np.array([str(info[key]) for key in ("ok", "devices", "platform", "error")]))


def _record(comm, x):
    """A result as the test compares it: the host array every process
    reads, and this process's logical blocks by global rank (a record of
    that form passes as it is)."""
    if not isinstance(x, ht.DNDarray):
        return x.detach() if hasattr(x, "detach") else x
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
    laplacians(comm, t, rec)
    attention(comm, t, rec)
    parallel_layers(comm, t, rec)
    estimators(comm, t, rec)
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
