"""Deterministic multi-process trainer, the acceptance workload of the
process-spanning runtime (reference: scripts/multiproc_trainer.py).

Launched by ``multihost.spawn_local`` / ``heat_tpu_torch.scripts.launch_multiproc``:
the world's configuration arrives in the launcher's environment
(``HEAT_TPU_COORDINATOR`` / ``HEAT_TPU_PROCESS_ID`` / ``HEAT_TPU_NUM_PROCESSES``
/ ``HEAT_TPU_MESH_DIR`` / ``HEAT_TPU_MESH_EPOCH``). Two workloads:

``--workload lstsq`` (the reference's): least squares by full-batch
gradient descent over a fixed seeded global table (seed 7, float64), its
rows split over the world's ranks::

    w  <-  w - lr * X^T (X w - y) / rows

Each rank computes ``X_r^T r_r`` and ``comm.allreduce`` sums them across
processes, so the trajectory does not depend on the world's size: a run
that loses a process, restores from the newest verified checkpoint onto
the smaller world and replays lands on the same ``w`` as an uninterrupted
run. Each step polls ``multihost.check_peers()``, publishes a progress
beacon (``multihost.note_progress``) and, every ``--checkpoint-every``
steps, saves through the cooperative checkpoint. On a peer loss, a stall
or a collective torn by a dying peer the worker writes its partial result
and leaves through ``multihost.reform_exit``. Chaos: ``--die-rank R
--die-at-step S`` kills rank R from inside at step S; ``--hang-rank R
--hang-at-step S`` stops its lease and sleeps, with its sockets open.

``--workload kmeans``: BASELINE config 3's k-means fit (a table such as
:func:`lloyd_table` draws: 10,000,000 x 16 float32 blobs, k = 8, seed
20261016) through the array's own entry points on the process-spanning
mesh. Each process reads its ranks' rows of the ``.npy`` table ``--table``
(``ht.load_npy(split=0)``), takes config 1's moments over it
(:func:`kmeans_moments`), fits ``ht.cluster.KMeans(init="batchparallel",
use_fused=True)`` for ``--iters`` iterations (:func:`timed_fit`: one Lloyd
kernel launch per local shard per iteration, the accumulators summed across
processes by one ``comm.allreduce`` per iteration) and saves the table and
the centers with ``save_checkpoint`` to ``--ckpt-dir`` (step 1), each
process writing its own ranks' shard files. The result holds the centers'
bytes, the inertia, the digests of the moments and of this process's labels
(:func:`digests`), the Lloyd kernel's launches in the fit, the fit's seconds
by part with its milliseconds per iteration and those of its cross-process
allreduce, and the seconds and bytes of the ingest and of the save.

``--workload cdist``, ``qr`` and ``dp`` (BASELINE configs 2, 4 and 5, the
main path over the process-spanning mesh; ``--workload kmeans,cdist,qr,dp``
runs several in turn in one launch): config 2's table drawn from ``--seed``
through ``ht.random`` (``--cdist-rows`` x ``--cdist-features`` float32,
split 0) and its ``cdist`` and ``rbf`` by the symmetric ring
(:func:`cdist_workload`); config 4's ``ht.linalg.qr`` of a seeded
``--qr-rows`` x ``--qr-cols`` float32 table at condition 1 and, sheared,
at condition ~1e5, where CholeskyQR2's probe falls back
(:func:`qr_workload`); config 5's ResNet-50 at ``--dp-batch`` images
through ``DataParallel`` steps, then DASO steps with one group per process
(:func:`dp_workload`); and the exchange itself, an ``allreduce`` of 548
bytes and a ``ppermute`` of one 50,000 x 64 float32 block
(:func:`.exchange_timing.time_exchange`). Each part is timed with its verbs counted
(:class:`VerbClock`), and large results are compared by digest
(:func:`block_digest`), with no gather.

``--workload lm``, ``parallel`` and ``estimators`` (the layers above the
verbs over the process-spanning mesh): the README's TransformerLM from
``--seed`` through ring and Ulysses attention, forward at ``--lm-seq``
tokens and one Adam step through the ring at ``--lm-step-seq``, the
gradients crossing the processes (:func:`lm_workload`); the Megatron pair
on a 'tp' line across the processes, forward and one step, a pipeline and
the experts (:func:`parallel_workload`); ``convolve``, ``Lasso``,
``Spectral`` and ``ping_mesh`` (:func:`estimators_workload`). Their shapes
are :data:`LAYER_SIZES`, each an option.

Results land as JSON at ``--out/result-epoch{E:04d}-rank{R:05d}.json``.
"""

import argparse
import hashlib
import json
import os
import signal
import sys
import time
from contextlib import contextmanager

import numpy as np
import torch

LLOYD_SEED = 20261016
LLOYD_SPREAD = 8.0


def _result_path(out_dir: str, epoch: int, rank: int, kind: str = "result", ext: str = "json") -> str:
    return os.path.join(out_dir, f"{kind}-epoch{epoch:04d}-rank{rank:05d}.{ext}")


def _write_result(out_dir: str, doc: dict) -> None:
    os.makedirs(out_dir, exist_ok=True)
    path = _result_path(out_dir, doc["epoch"], doc["rank"])
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "w") as fh:
        json.dump(doc, fh, indent=2, sort_keys=True)
    os.replace(tmp, path)


def _comm_failure(exc: BaseException) -> bool:
    msg = f"{type(exc).__name__}: {exc}".lower()
    return any(
        key in msg
        for key in ("gloo", "socket", "connection", "peer", "deadline", "barrier", "distributed", "nccl",
                    "closed", "timed out", "unavailable", "cancelled")
    )


def row_blocks(rows: int, p: int):
    """(start, stop) of each of the ``p`` ranks' rows under the
    ``ceil(rows/p)`` block rule."""
    block = -(-rows // p) if rows else 0
    return [(min(r * block, rows), min((r + 1) * block, rows)) for r in range(p)]


def lloyd_table(rows: int, features: int, k: int, seed: int, device):
    """The fit's table, ``rows`` x ``features`` float32 blobs around ``k``
    means, drawn on ``device`` from ``seed``: the same on every call."""
    gen = torch.Generator(device=device).manual_seed(seed)
    means = torch.randn(k, features, generator=gen, device=device) * LLOYD_SPREAD
    ids = torch.randint(0, k, (rows,), generator=gen, device=device)
    data = torch.randn(rows, features, generator=gen, device=device)
    data += means[ids]
    return data


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def kmeans_moments(ht, x) -> dict:
    """Config 1's moments of ``x``: mean, var, std, min, max and argmax over
    the whole table, across the split (axis 0) and along it (axis 1)."""
    return {f"{fn}_{axis}": getattr(ht, fn)(x, axis=axis)
            for axis in (None, 0, 1) for fn in ("mean", "var", "std", "min", "max", "argmax")}


def digests(comm, arrays: dict) -> dict:
    """A comparable digest of each array without a gather: a replicated
    array's bytes in hex, a split one's :func:`block_digest` per logical
    block of this process's ranks (the global rank as a string key),
    computed where the block lies."""
    out = {}
    for name, a in arrays.items():
        if a.split is None:
            out[name] = a.numpy().tobytes().hex()
            continue
        out[name] = {str(r): block_digest(b) for r, b in zip(comm.local_ranks, a.lshards)}
    return out


def kmeans_fit(ht, x, k: int, iters: int, seed: int):
    """The spanning fit's estimator, fitted: batch-parallel init from
    ``seed``, the fused Lloyd kernel, every one of ``iters`` iterations run
    (a negative tolerance never stops early)."""
    return kmeans_estimator(ht, k, iters, seed).fit(x)


def kmeans_estimator(ht, k: int, iters: int, seed: int):
    return ht.cluster.KMeans(n_clusters=k, init="batchparallel", max_iter=iters, tol=-1.0, random_state=seed,
                             use_fused=True)


FIT_PARTS = ("init", "xsq", "iterations", "labels")


def timed_fit(ht, x, k: int, iters: int, seed: int):
    """:func:`kmeans_fit` with its own parts timed, on whatever mesh ``x``
    lives; the result is the fit's. Timed call by call, each closed by a
    device synchronization: the init and, inside it, each kmeans++
    (``cluster._kcluster._kmeanspp_fixed``), Σ|x|², each chunk of iterations
    (``ops.lloyd.run_steps``), the labels (``ops.lloyd.sharded_labels``), and
    each ``x.comm.allreduce`` and ``allgather``, keyed by the part they run
    in (``"allreduce in iterations"``). Returns the estimator and the
    seconds of the fit, of each part and of the rest (the chunks'
    convergence tests, the result's wrapping), each call's seconds, the
    milliseconds per iteration and those of the allreduce per iteration, and
    the Lloyd kernel's launches in the fit."""
    from ..cluster import _kcluster
    from ..ops import lloyd

    km = kmeans_estimator(ht, k, iters, seed)
    comm, device = x.comm, x.lshards[0].device
    calls, inside = {}, []

    def timed(part, fn):
        def call(*args, **kwargs):
            key = f"{part} in {(inside or ['fit'])[-1]}" if part in ("allreduce", "allgather") else part
            _sync(device)
            t0 = time.perf_counter()
            inside.append(part)
            try:
                out = fn(*args, **kwargs)
                _sync(device)
            finally:
                inside.pop()
            calls.setdefault(key, []).append(time.perf_counter() - t0)
            return out
        return call

    modules = [(lloyd, "logical_xsq_sum", "xsq"), (lloyd, "run_steps", "iterations"),
               (lloyd, "sharded_labels", "labels"), (_kcluster, "_kmeanspp_fixed", "kmeanspp")]
    saved = [(module, name, getattr(module, name)) for module, name, _ in modules]
    for (module, name, part), (_, _, fn) in zip(modules, saved):
        setattr(module, name, timed(part, fn))
    instances = [(km, "_initialize_cluster_centers", "init"), (comm, "allreduce", "allreduce"),
                 (comm, "allgather", "allgather")]
    for obj, name, part in instances:
        setattr(obj, name, timed(part, getattr(obj, name)))
    lloyd.LAUNCHES = 0
    try:
        _sync(device)
        t0 = time.perf_counter()
        km.fit(x)
        _sync(device)
        fit_s = time.perf_counter() - t0
    finally:
        for obj, name, _ in instances:
            delattr(obj, name)
        for module, name, fn in saved:
            setattr(module, name, fn)
    parts = {part: sum(calls.get(part, ())) for part in FIT_PARTS}
    n_iter = km.n_iter_
    return km, {
        "fit_s": fit_s,
        "parts_s": dict(parts, rest=fit_s - sum(parts.values())),
        "calls_s": calls,
        "ms_per_iter": parts["iterations"] * 1e3 / n_iter,
        "allreduce_ms_per_iter": sum(calls.get("allreduce in iterations", ())) * 1e3 / n_iter,
        "launches": lloyd.LAUNCHES,
    }


def run_kmeans(args, comm, doc) -> int:
    import heat_tpu_torch as ht

    from ..core import multihost
    from ..utils.checkpoint import save_checkpoint

    device = comm.local_devices[0]
    _sync(device)
    t0 = time.perf_counter()
    x = ht.load_npy(args.table, split=0, comm=comm)
    _sync(device)
    ingest_s = time.perf_counter() - t0
    held = sum(b.numel() * b.element_size() for b in x.lshards)
    moments = digests(comm, kmeans_moments(ht, x))
    km, timing = timed_fit(ht, x, args.clusters, args.iters, args.seed)
    centers = km.cluster_centers_.larray
    written = held + (centers.numel() * centers.element_size() if multihost.io_owner() else 0)
    _sync(device)
    t0 = time.perf_counter()
    save_checkpoint(args.ckpt_dir, {"table": x, "centers": km.cluster_centers_}, step=1, keep=0)
    save_s = time.perf_counter() - t0
    labels = digests(comm, {"labels": km.labels_})["labels"]
    c = centers.float().cpu()
    doc.update(timing, status="done", completed_steps=args.iters, centers=c.tolist(),
               centers_hex=c.numpy().tobytes().hex(), inertia=float(km.inertia_), n_iter=km.n_iter_,
               labels_sha256=labels, moments=moments, ingest_s=ingest_s, ingest_bytes=held, save_s=save_s,
               save_bytes=written, device=str(device), local_shards=len(comm.local_devices),
               first_rank=comm.first_rank, ranks=comm.size)
    _write_result(args.out, doc)
    return 0


# ---------------------------------------------------------------------------
# the main path over the spanning mesh: configs 2, 4 and 5, and the exchange
# ---------------------------------------------------------------------------
CDIST_ROWS, CDIST_FEATURES, CDIST_SIGMA = 100_000, 64, 8.0
QR_ROWS, QR_COLS, QR_COND = 2_500_000, 512, 1e5
DP_BATCH, DP_STEPS, DASO_STEPS, DP_IMAGE, DP_CLASSES, DP_LR = 256, 3, 2, (32, 32, 3), 10, 0.05
DP_FILTERS = 64  # ResNet-50's stem
EXCHANGE_REPS = 20
MAIN_WORKLOADS = ("cdist", "qr", "dp", "exchange")
#: the main path's shapes, by the name of their command-line option
MAIN_SIZES = {"cdist_rows": CDIST_ROWS, "cdist_features": CDIST_FEATURES, "qr_rows": QR_ROWS, "qr_cols": QR_COLS,
              "dp_batch": DP_BATCH, "dp_image": DP_IMAGE[0], "dp_filters": DP_FILTERS}


def block_digest(t) -> str:
    """A digest of a tensor's bits, computed where it lies: its 32-bit
    words (bytes, for an odd byte count), each times an odd weight of its
    position, summed in ``int64`` (exact, wrapping, in any order), with its
    shape and type. Two tensors of one shape and type with equal bits give
    equal digests on any device; a flipped bit changes it."""
    t = t.detach().contiguous().reshape(-1)
    words = t.view(torch.uint8)
    if words.numel() % 4 == 0:
        words = words.view(torch.int32)
    total = torch.zeros((), dtype=torch.int64, device=t.device)
    chunk = 1 << 24
    for at in range(0, words.numel(), chunk):
        part = words[at:at + chunk].to(torch.int64)
        weights = torch.arange(at, at + part.numel(), dtype=torch.int64, device=t.device) * 2 + 1
        total += (part * weights).sum()
    text = f"{tuple(t.shape)} {t.dtype} {int(total.item())}"
    return hashlib.sha256(text.encode()).hexdigest()


class VerbClock:
    """The seconds of named parts on ``comm``'s device, each closed by a
    synchronization, with the calls and milliseconds of every verb of the
    mesh inside them (the verbs wrapped on the instance while a part runs,
    the host clock around each call)."""

    VERBS = ("allreduce", "allgather", "bcast", "ppermute", "alltoall", "scan", "exscan")

    def __init__(self, comm):
        self.comm = comm
        self.device = comm.home
        self.parts = {}

    @contextmanager
    def part(self, name: str):
        verbs = {}
        for verb in self.VERBS:
            fn = getattr(self.comm, verb)

            def timed(*args, _fn=fn, _verb=verb, **kwargs):
                t0 = time.perf_counter()
                try:
                    return _fn(*args, **kwargs)
                finally:
                    entry = verbs.setdefault(_verb, {"calls": 0, "ms": 0.0})
                    entry["calls"] += 1
                    entry["ms"] += (time.perf_counter() - t0) * 1e3
            setattr(self.comm, verb, timed)
        _sync(self.device)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _sync(self.device)
            self.parts[name] = {"ms": (time.perf_counter() - t0) * 1e3, "verbs": verbs}
            for verb in self.VERBS:
                delattr(self.comm, verb)


def cdist_workload(ht, comm, clock: VerbClock, rows: int = CDIST_ROWS, features: int = CDIST_FEATURES,
                   sigma: float = CDIST_SIGMA, seed: int = LLOYD_SEED) -> dict:
    """Config 2 on ``comm``: ``cdist`` and ``rbf`` of a seeded ``rows`` x
    ``features`` float32 table split 0 (the symmetric ring, kernel B2 on
    CUDA): each result's digests per rank and B2's launches per call, each
    result freed before the next."""
    from ..ops import pairwise

    ht.random.seed(seed)
    x = ht.random.randn(rows, features, split=0, comm=comm)
    out = {"launches": {}, "digests": {}}
    for name, fn in (("cdist", lambda: ht.spatial.cdist(x)), ("rbf", lambda: ht.spatial.rbf(x, sigma=sigma))):
        before = pairwise.LAUNCHES
        with clock.part(name):
            d = fn()
        out["launches"][name] = pairwise.LAUNCHES - before
        out["digests"][name] = digests(comm, {name: d})[name]
        del d
    return out


def qr_workload(ht, comm, clock: VerbClock, rows: int = QR_ROWS, cols: int = QR_COLS,
                seed: int = LLOYD_SEED, keep=None) -> dict:
    """Config 4 on ``comm``: ``ht.linalg.qr`` of a seeded ``rows`` x
    ``cols`` float32 table split 0 at condition 1 and ~1e5, the schedule each
    ran (CholeskyQR2, and TSQR where its probe falls back), R's digest and
    Q's per rank. ``keep(name, a, q, r)``, when given, sees each
    factorization before it is freed."""
    import importlib

    methods = importlib.import_module("heat_tpu_torch.core.linalg.qr")._METHODS
    ht.random.seed(seed + 4)
    base = ht.random.randn(rows, cols, split=0, comm=comm)
    # the first column times QR_COND / cols added to every column: a shear
    # of condition ~QR_COND, past CholeskyQR2's float32 limit (a column
    # scaling would not do: CholeskyQR is blind to it)
    operands = {"cond1": lambda: base, "cond1e5": lambda: base + (QR_COND / cols) * base[:, :1]}
    out = {}
    for name, operand in operands.items():
        a = operand()
        before = dict(methods)
        with clock.part(f"qr {name}"):
            q, r = ht.linalg.qr(a)
        out[name] = {"schedule": [k for k in methods if methods[k] != before.get(k, 0)],
                     "r": block_digest(r.larray), "q": digests(comm, {"q": q})["q"]}
        if keep is not None:
            keep(name, a, q, r)
        del a, q, r
    return out


def dp_workload(ht, comm, clock: VerbClock, nodes: int, batch: int = DP_BATCH, steps: int = DP_STEPS,
                daso_steps: int = DASO_STEPS, seed: int = LLOYD_SEED, image=DP_IMAGE, filters: int = DP_FILTERS) -> dict:
    """Config 5 on ``comm``: a seeded ResNet-50 (``filters`` in its stem)
    takes ``steps`` DataParallel steps of SGD on one seeded ``batch`` of
    NHWC ``image``s, then a fresh one ``daso_steps`` DASO steps with
    ``nodes`` groups: each step's loss and the parameters' digest after
    each trainer."""
    def net():
        return ht.nn.ResNet50(num_classes=DP_CLASSES, num_filters=filters, device=comm.home,
                              generator=torch.Generator(device=comm.home).manual_seed(seed))

    def params(module):
        return block_digest(torch.cat([p.detach().reshape(-1) for p in module.parameters()]))

    gen = torch.Generator(device=comm.home).manual_seed(seed + 5)
    x = torch.randn((batch,) + tuple(image), generator=gen, device=comm.home)
    y = torch.randint(0, DP_CLASSES, (batch,), generator=gen, device=comm.home)
    out = {"dp_losses": [], "daso_losses": []}
    dp = ht.nn.DataParallel(net(), comm=comm, optimizer=ht.optim.SGD(DP_LR)).init(seed, x[:2])
    for i in range(steps):
        with clock.part(f"dp step {i}"):
            out["dp_losses"].append(dp.train_step(x, y))
    out["dp_params"] = params(dp.module)
    del dp
    daso = ht.optim.DASO(ht.optim.SGD(DP_LR), total_epochs=8, comm=comm, nodes=nodes)
    daso.add_model(net(), seed, x[:2])
    for i in range(daso_steps):
        with clock.part(f"daso step {i}"):
            out["daso_losses"].append(daso.step(x, y))
    out["daso_params"] = params(daso.module)
    return out


# ---------------------------------------------------------------------------
# the layers over the spanning mesh: sequence parallelism, parallel/ and the
# estimators (A11.5b(c2a))
# ---------------------------------------------------------------------------
LM_VOCAB, LM_DIM, LM_DEPTH, LM_HEADS, LM_MAX_LEN = 50_257, 768, 12, 12, 32_768  # the README's TransformerLM
LM_SEQ, LM_STEP_SEQ, LM_LR, SP_BLOCK = 16_384, 4_096, 3e-4, 512
TP_ROWS, TP_DIM, TP_HIDDEN, TP_LR = 4_096, 768, 3_072, 0.05  # GPT-2 small's MLP
PP_SEQ, PP_BATCH = 512, 8
CONV_N, CONV_TAPS = 100_000_000, 9
LASSO_N, LASSO_F, LASSO_LAM, LASSO_SWEEPS = 100_000, 64, 0.1, 20  # benchmarks/lasso.py's protocol
SPECTRAL_N, SPECTRAL_F, SPECTRAL_K, SPECTRAL_LANCZOS = 10_000, 16, 8, 300
SPECTRAL_GAMMA = 1.0 / 32.0
LAYER_WORKLOADS = ("lm", "parallel", "estimators")
#: the layers' shapes, by the name of their command-line option
LAYER_SIZES = {"lm_vocab": LM_VOCAB, "lm_dim": LM_DIM, "lm_depth": LM_DEPTH, "lm_heads": LM_HEADS,
               "lm_seq": LM_SEQ, "lm_step_seq": LM_STEP_SEQ, "sp_block": SP_BLOCK, "tp_rows": TP_ROWS,
               "tp_dim": TP_DIM, "tp_hidden": TP_HIDDEN, "pp_seq": PP_SEQ, "pp_batch": PP_BATCH, "conv_n": CONV_N,
               "lasso_n": LASSO_N, "lasso_f": LASSO_F, "spectral_n": SPECTRAL_N, "spectral_lanczos": SPECTRAL_LANCZOS}


@contextmanager
def deterministic():
    """torch's deterministic algorithms (warning where an op has none): the
    embedding's backward sums its rows in a fixed order, so two processes'
    steps can be held bit for bit."""
    was, warn = torch.are_deterministic_algorithms_enabled(), torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn)


def lm_workload(ht, comm, clock: VerbClock, sizes: dict, seed: int = LLOYD_SEED) -> dict:
    """The README's TransformerLM on ``comm``, from ``seed`` in every
    process: a forward of batch 1 at ``lm_seq`` tokens through
    ``ring_attention``, another through ``ulysses_attention`` (blockwise
    local attention of ``sp_block``), each logits' digest; then one Adam
    step at ``lm_step_seq`` tokens through the ring, the next-token loss
    and the parameters' digest after it. Each part's verbs are counted."""
    import functools

    import torch.nn.functional as Fn

    s = sizes
    home = comm.home
    model = ht.nn.TransformerLM(vocab=s["lm_vocab"], dim=s["lm_dim"], depth=s["lm_depth"], heads=s["lm_heads"],
                                max_len=LM_MAX_LEN, device=home,
                                generator=torch.Generator(device=home).manual_seed(seed))
    gen = torch.Generator(device=home).manual_seed(seed + 24)
    tokens = torch.randint(0, s["lm_vocab"], (1, s["lm_seq"]), generator=gen, device=home)
    schedules = {"ring": functools.partial(ht.nn.ring_attention, comm=comm),
                 "ulysses": functools.partial(ht.nn.ulysses_attention, comm=comm, block_size=s["sp_block"])}
    out = {"digests": {}}
    for name, fn in schedules.items():
        for block in model.blocks:
            block.attn.attention_fn = fn
        with torch.no_grad(), clock.part(f"lm {name} forward"):
            logits = model(tokens)
        out["digests"][f"{name}_logits"] = block_digest(logits)
        del logits
        if home.type == "cuda":
            torch.cuda.empty_cache()
    for block in model.blocks:
        block.attn.attention_fn = schedules["ring"]
    step = tokens[:, : s["lm_step_seq"]]
    optimizer = torch.optim.Adam(model.parameters(), lr=LM_LR)
    with deterministic(), clock.part("lm ring step"):
        logits = model(step)
        loss = Fn.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]), step[:, 1:].reshape(-1))
        loss.backward()
        optimizer.step()
    out["loss"] = loss.item()
    out["digests"]["params_after_step"] = block_digest(torch.cat([p.detach().reshape(-1) for p in model.parameters()]))
    return out


def _rank_digests(comm, tensors) -> dict:
    """A digest per rank of this process: each rank's tensors joined."""
    return {str(r): block_digest(torch.cat([t.detach().reshape(-1).to(comm.home) for t in ts]))
            for r, ts in zip(comm.local_ranks, tensors)}


def parallel_workload(ht, comm, clock: VerbClock, sizes: dict, seed: int = LLOYD_SEED) -> dict:
    """parallel/ on ``comm``, a 'tp' line of every rank: the Megatron pair
    (``TPMLPBlock``, ``tp_dim`` x ``tp_hidden``) on ``tp_rows`` tokens,
    forward, then one SGD step of the mean-square loss (the loss, each
    rank's blocks' digest and the forward after it); a pipeline of one
    TransformerBlock per rank on ``pp_batch`` x ``pp_seq`` activations; one
    expert per rank (``MoELayer``) on the tokens. Outputs by digest."""
    from torch.func import functional_call

    from .. import parallel

    s = sizes
    home = comm.home
    dim, hidden = s["tp_dim"], s["tp_hidden"]
    gen = torch.Generator(device=home).manual_seed(seed + 16)
    x = torch.randn(s["tp_rows"], dim, generator=gen, device=home)
    target = torch.randn(s["tp_rows"], dim, generator=gen, device=home)
    block = parallel.TPMLPBlock(hidden, dim, dim, comm=comm, device=home,
                                generator=torch.Generator(device=home).manual_seed(seed))
    out = {"digests": {}}
    with torch.no_grad(), clock.part("tp forward"):
        out["digests"]["tp_forward"] = block_digest(block(x))
    with clock.part("tp step"):
        loss = ((block(x) - target) ** 2).mean()
        loss.backward()
        with torch.no_grad():
            for param in block.parameters():
                param -= TP_LR * param.grad
    out["tp_loss"] = loss.item()
    out["tp_params"] = _rank_digests(comm, [(block.up.kernel[i], block.up.bias[i], block.down.kernel[i])
                                            for i in range(len(comm.local_ranks))])
    out["digests"]["tp_down_bias"] = block_digest(block.down.bias)
    with torch.no_grad():
        out["digests"]["tp_forward_after_step"] = block_digest(block(x))
        stages = [ht.nn.TransformerBlock(dim, heads=LM_HEADS, device=home,
                                         generator=torch.Generator(device=home).manual_seed(seed + r))
                  for r in range(comm.size)]
        acts = torch.randn(s["pp_batch"], s["pp_seq"], dim, generator=gen, device=home)
        stacked = parallel.pipeline_stage_params([dict(b.named_parameters()) for b in stages])
        with clock.part("pipeline"):
            got = parallel.pipeline_apply(lambda prm, a: functional_call(stages[0], prm, (a,)), stacked, acts, comm)
        out["digests"]["pipeline"] = block_digest(got)
        moe = parallel.MoELayer(comm.size, hidden, dim, device=home,
                                generator=torch.Generator(device=home).manual_seed(seed))
        with clock.part("experts"):
            got = moe(x, mesh=comm)
        out["digests"]["experts"] = block_digest(got)
    return out


def estimators_workload(ht, comm, clock: VerbClock, sizes: dict, seed: int = LLOYD_SEED) -> dict:
    """The estimators on ``comm``: ``convolve`` of a seeded ``conv_n``
    float32 signal, split 0, with ``CONV_TAPS`` taps in "same" and "full"
    (each rank's block by digest); ``Lasso`` at benchmarks/lasso.py's
    protocol (``lasso_n`` x ``lasso_f``, λ 0.1, 20 sweeps; θ's digest);
    ``Spectral.fit`` of a ``spectral_n`` x 16 table of 8 blobs (rbf
    similarity, ``spectral_lanczos`` Lanczos steps, KMeans through the
    Lloyd kernel: its labels per rank and the launches of B1 and B2 in the
    fit); ``ping_mesh``'s answer."""
    from ..ops import lloyd, pairwise
    from ..utils import health

    s = sizes
    out = {"digests": {}, "launches": {}}
    ht.random.seed(seed + 20)
    signal = ht.random.randn(s["conv_n"], split=0, comm=comm)
    taps = ht.random.randn(CONV_TAPS, comm=comm)
    for mode in ("same", "full"):
        with clock.part(f"convolve {mode}"):
            got = ht.convolve(signal, taps, mode=mode)
        out["digests"][f"convolve_{mode}"] = digests(comm, {"c": got})["c"]
        del got
    del signal
    ht.random.seed(seed + 21)
    x = ht.random.randn(s["lasso_n"], s["lasso_f"], split=0, comm=comm)
    y = ht.random.randn(s["lasso_n"], split=0, comm=comm)
    with clock.part("lasso"):
        est = ht.regression.Lasso(lam=LASSO_LAM, max_iter=LASSO_SWEEPS, tol=None).fit(x, y)
    out["digests"]["lasso_theta"] = block_digest(est.theta.larray)
    del x, y
    table = lloyd_table(s["spectral_n"], SPECTRAL_F, SPECTRAL_K, seed + 37, comm.home)
    x = ht.array(table, split=0, comm=comm)
    del table
    spectral = ht.cluster.Spectral(n_clusters=SPECTRAL_K, gamma=SPECTRAL_GAMMA, n_lanczos=s["spectral_lanczos"],
                                   init="kmeans++", random_state=seed)
    lloyd_before, pairwise_before = lloyd.LAUNCHES, pairwise.LAUNCHES
    with clock.part("spectral"):
        spectral.fit(x)
    out["launches"]["spectral"] = {"lloyd": lloyd.LAUNCHES - lloyd_before,
                                   "pairwise": pairwise.LAUNCHES - pairwise_before}
    out["spectral_iterations"] = spectral._cluster.n_iter_
    out["digests"]["spectral_labels"] = digests(comm, {"l": spectral.labels_})["l"]
    info = health.ping_mesh(comm, timeout=120.0)
    out["ping"] = {key: info[key] for key in ("ok", "devices", "platform", "error", "latency_s")}
    return out


def run_mainpath(args, comm, doc, workloads) -> int:
    """The main-path workloads in the order given, on the spanning mesh."""
    import heat_tpu_torch as ht

    from ..core import multihost
    from . import exchange_timing

    clock = VerbClock(comm)
    out = {}
    for name in workloads:
        if name == "cdist":
            out[name] = cdist_workload(ht, comm, clock, args.cdist_rows, args.cdist_features, seed=args.seed)
        elif name == "qr":
            out[name] = qr_workload(ht, comm, clock, args.qr_rows, args.qr_cols, seed=args.seed)
        elif name == "dp":
            out[name] = dp_workload(ht, comm, clock, multihost.process_count(), args.dp_batch, seed=args.seed,
                                    image=(args.dp_image, args.dp_image, 3), filters=args.dp_filters)
        elif name == "exchange":
            out[name] = exchange_timing.time_exchange(comm, EXCHANGE_REPS)
        elif name in LAYER_WORKLOADS:
            sizes = {key: getattr(args, key) for key in LAYER_SIZES}
            fn = {"lm": lm_workload, "parallel": parallel_workload, "estimators": estimators_workload}[name]
            t0 = time.perf_counter()
            out[name] = fn(ht, comm, clock, sizes, seed=args.seed)
            out[name]["seconds"] = time.perf_counter() - t0
        if comm.home.type == "cuda":
            torch.cuda.empty_cache()
    doc.update(status="done", mainpath=out, parts=clock.parts, first_rank=comm.first_rank, ranks=comm.size,
               local_shards=len(comm.local_devices), device=str(comm.home))
    _write_result(args.out, doc)
    return 0


def _device(kind: str) -> str:
    return "gpu" if kind == "cuda" else "cpu"


def run_lstsq(args, comm, doc) -> int:
    from ..core import elastic, multihost, resilience
    from ..utils.checkpoint import load_checkpoint, save_checkpoint

    rank = doc["rank"]
    lost_window_s = float(os.environ.get("HEAT_TPU_PEER_LOST_MS", "1000") or 1000) / 1e3
    rows, dim, lr = args.rows, args.dim, args.lr
    rng = np.random.default_rng(7)  # the same table in every process
    X_full = rng.standard_normal((rows, dim))
    y_full = rng.standard_normal((rows,))
    blocks = row_blocks(rows, comm.size)
    first = comm.first_rank
    Xs, ys = [], []
    for i, dev in enumerate(comm.local_devices):
        start, stop = blocks[first + i]
        Xs.append(torch.from_numpy(X_full[start:stop]).to(dev))
        ys.append(torch.from_numpy(y_full[start:stop]).to(dev))
    home = comm.local_devices[0]

    def train_step(w):
        parts = [X.T @ (X @ w.to(X.device) - y) for X, y in zip(Xs, ys)]
        g = comm.allreduce(parts)[0] / rows  # the cross-process sum
        return w - lr * g

    start = 0
    newest = elastic.newest_verified_step(args.ckpt_dir)
    if newest is not None:
        restored = load_checkpoint(args.ckpt_dir, {"w": np.zeros(dim)}, step=newest)
        w = torch.as_tensor(np.asarray(restored["w"], dtype=np.float64)).to(home)
        start = doc["resumed_from"] = doc["completed_steps"] = int(newest)
    else:
        w = torch.zeros(dim, dtype=torch.float64, device=home)

    def exit_for_reform(exc: BaseException) -> int:
        doc["error"] = f"{type(exc).__name__}: {exc}"
        _write_result(args.out, doc)
        # not sys.exit: the teardown of a process group with a dead or hung
        # peer can block
        multihost.reform_exit()
        return multihost.REFORM_EXIT

    t_after_first = None
    step = start
    try:
        while step < args.steps:
            multihost.check_peers()
            if rank == args.die_rank and step == args.die_at_step:
                os.kill(os.getpid(), signal.SIGKILL)
            if rank == args.hang_rank and step == args.hang_at_step:
                multihost.stop_heartbeat()  # go silent: the peers must detect it
                time.sleep(3600)
            w = train_step(w)
            _sync(home)
            step += 1
            doc["completed_steps"] = step
            multihost.note_progress(step)
            if doc["t_first_step"] is None:
                doc["t_first_step"] = t_after_first = time.time()
            if step % args.checkpoint_every == 0 and step < args.steps:
                try:
                    save_checkpoint(args.ckpt_dir, {"w": w.cpu().numpy()}, step=step, keep=5)
                except (multihost.PeerLostError, resilience.StallError):
                    raise
                except Exception as exc:  # noqa: BLE001 - the ci fault mix is survivable
                    print(f"[rank {rank}] checkpoint at step {step} skipped: {exc!r}", file=sys.stderr)
    except (multihost.PeerLostError, resilience.StallError) as exc:
        return exit_for_reform(exc)
    except Exception as exc:  # noqa: BLE001 - a collective torn by a dying peer?
        deadline = time.time() + 2.0 * lost_window_s
        while time.time() < deadline and not multihost.lost_peers():
            time.sleep(0.05)
        if multihost.lost_peers() or _comm_failure(exc):
            return exit_for_reform(exc)
        raise

    doc["status"] = "done"
    if t_after_first is not None and step - start > 1:
        doc["rate_steps_per_s"] = round((step - start - 1) / max(time.time() - t_after_first, 1e-9), 3)
    doc["final_w"] = w.cpu().tolist()
    _write_result(args.out, doc)
    multihost.stop_heartbeat()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", default="lstsq",
                    help="lstsq, or a comma list of kmeans, cdist, qr, dp, exchange, lm, parallel and estimators, run "
                         "in turn")
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default=None,
                    help="the payload's backend (default: gloo on the CPU, nccl on CUDA)")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--checkpoint-every", type=int, default=2)
    ap.add_argument("--rows", type=int, default=64)
    ap.add_argument("--dim", type=int, default=16)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--clusters", type=int, default=8)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--seed", type=int, default=LLOYD_SEED)
    ap.add_argument("--ckpt-dir", default=None, help="checkpoint directory (lstsq, kmeans)")
    ap.add_argument("--table", default=None, help="the .npy table the kmeans workload reads")
    for key, value in {**MAIN_SIZES, **LAYER_SIZES}.items():
        ap.add_argument(f"--{key.replace('_', '-')}", type=int, default=value)
    ap.add_argument("--out", required=True, help="result directory")
    ap.add_argument("--die-rank", type=int, default=-1)
    ap.add_argument("--die-at-step", type=int, default=-1)
    ap.add_argument("--hang-rank", type=int, default=-1)
    ap.add_argument("--hang-at-step", type=int, default=-1)
    args = ap.parse_args(argv)
    workloads = args.workload.split(",")
    known = ("kmeans", *MAIN_WORKLOADS, *LAYER_WORKLOADS)
    unknown = set(workloads) - set(known) if workloads != ["lstsq"] else set()
    if unknown:
        ap.error(f"unknown workload(s) {sorted(unknown)}: lstsq alone, or {', '.join(known)}")
    if ("lstsq" in workloads or "kmeans" in workloads) and not args.ckpt_dir:
        ap.error(f"--workload {args.workload} needs --ckpt-dir")
    if "kmeans" in workloads and not args.table:
        ap.error("--workload kmeans needs --table")

    from ..core import multihost

    if args.device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        # config 5's steps are held bit for bit against another process's
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    kwargs = {"device": _device(args.device)}
    if args.backend is not None:
        kwargs["backend"] = args.backend
    comm = multihost.initialize_distributed(**kwargs)
    doc = {
        "rank": multihost.process_index(), "world": multihost.process_count(), "epoch": multihost.mesh_epoch(),
        "workload": args.workload, "status": "reform", "resumed_from": None, "completed_steps": 0,
        "t_first_step": None, "rate_steps_per_s": None, "final_w": None,
    }
    if workloads == ["lstsq"]:
        return run_lstsq(args, comm, doc)
    if "kmeans" in workloads:
        run_kmeans(args, comm, doc)
    rest = [w for w in workloads if w != "kmeans"]
    return run_mainpath(args, comm, doc, rest) if rest else 0


if __name__ == "__main__":
    sys.exit(main())
