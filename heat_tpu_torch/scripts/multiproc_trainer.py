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

Results land as JSON at ``--out/result-epoch{E:04d}-rank{R:05d}.json``.
"""

import argparse
import json
import os
import signal
import sys
import time

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
    array's bytes in hex, a split one's SHA-256 per logical block of this
    process's ranks (the global rank as a string key)."""
    import hashlib

    out = {}
    for name, a in arrays.items():
        if a.split is None:
            out[name] = a.numpy().tobytes().hex()
            continue
        out[name] = {str(r): hashlib.sha256(b.detach().cpu().contiguous().numpy().tobytes()).hexdigest()
                     for r, b in zip(comm.local_ranks, a.lshards)}
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
    ap.add_argument("--workload", choices=("lstsq", "kmeans"), default="lstsq")
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
    ap.add_argument("--out", required=True, help="result directory")
    ap.add_argument("--die-rank", type=int, default=-1)
    ap.add_argument("--die-at-step", type=int, default=-1)
    ap.add_argument("--hang-rank", type=int, default=-1)
    ap.add_argument("--hang-at-step", type=int, default=-1)
    args = ap.parse_args(argv)
    if args.workload in ("lstsq", "kmeans") and not args.ckpt_dir:
        ap.error(f"--workload {args.workload} needs --ckpt-dir")
    if args.workload == "kmeans" and not args.table:
        ap.error("--workload kmeans needs --table")

    from ..core import multihost

    if args.device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    kwargs = {"device": _device(args.device)}
    if args.backend is not None:
        kwargs["backend"] = args.backend
    comm = multihost.initialize_distributed(**kwargs)
    doc = {
        "rank": multihost.process_index(), "world": multihost.process_count(), "epoch": multihost.mesh_epoch(),
        "workload": args.workload, "status": "reform", "resumed_from": None, "completed_steps": 0,
        "t_first_step": None, "rate_steps_per_s": None, "final_w": None,
    }
    if args.workload == "kmeans":
        return run_kmeans(args, comm, doc)
    return run_lstsq(args, comm, doc)


if __name__ == "__main__":
    sys.exit(main())
