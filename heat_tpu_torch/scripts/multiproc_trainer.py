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

``--workload lloyd``: BASELINE config 3's k-means fit (10,000,000 x 16
float32 blobs, k = 8, seed 20261016; ``--lloyd-rows`` cuts it), its rows
split over the world's ranks, through ``ops.lloyd.fused_lloyd_run_sharded``
on the process-spanning mesh: one Lloyd kernel launch per local shard per
iteration, the accumulators summed across processes by one
``comm.allreduce`` per iteration. The result holds the centers' bytes, the
inertia, this process's kernel launches, the milliseconds per iteration and
those of the cross-process allreduce; the labels of this process's rows go
to ``labels-epoch{E:04d}-rank{R:05d}.npy``.

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
    means, and the ``k`` rows that start it, drawn on ``device`` from
    ``seed``: every process, and the one-process fit it is held against,
    draws the same."""
    gen = torch.Generator(device=device).manual_seed(seed)
    means = torch.randn(k, features, generator=gen, device=device) * LLOYD_SPREAD
    ids = torch.randint(0, k, (rows,), generator=gen, device=device)
    data = torch.randn(rows, features, generator=gen, device=device)
    data += means[ids]
    del ids
    init = data[torch.randint(0, rows, (k,), generator=gen, device=device)].clone()
    return data, init


def lloyd_shards(data: torch.Tensor, p: int, ranks) -> list:
    """The ``ceil(n/p)``-row shards of global ``ranks``, the short ones
    padded with zeros (the padding is never read)."""
    rows = data.shape[0]
    block = -(-rows // p)
    out = []
    for r in ranks:
        start, stop = row_blocks(rows, p)[r]
        shard = data[start:stop].clone()
        if stop - start < block:
            shard = torch.cat([shard, shard.new_zeros(block - (stop - start), data.shape[1])])
        out.append(shard)
    return out


class TimedComm:
    """A mesh whose ``allreduce`` is timed: the device is synchronized
    before and after each call, and ``ms`` holds each call's milliseconds."""

    def __init__(self, comm):
        self.comm = comm
        self.size, self.first_rank = comm.size, comm.first_rank
        self.spans_processes = comm.spans_processes
        self.ms = []

    def allreduce(self, parts, op="sum"):
        _sync(parts[0].device)
        t0 = time.perf_counter()
        out = self.comm.allreduce(parts, op)
        _sync(out[0].device)
        self.ms.append((time.perf_counter() - t0) * 1e3)
        return out


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def lloyd_fit(comm, shards, init, k: int, rows: int, iters: int) -> dict:
    """The fit over ``shards`` (ranks ``comm.first_rank`` on): a warm-up
    iteration, the timed fit with its kernel launches counted, then the same
    fit with the allreduce timed. Returns the numbers and the first fit's
    ``(centers, labels, inertia)``."""
    from ..ops import lloyd

    xs = [lloyd.stream_operand(s) for s in shards]
    first = comm.first_rank
    lloyd.run_steps(xs, init, k, comm, rows, 1, lloyd.logical_xsq_sum(xs, rows, comm, first), first)
    _sync(xs[0].device)
    lloyd.LAUNCHES = 0
    t0 = time.perf_counter()
    xsq = lloyd.logical_xsq_sum(xs, rows, comm, first)
    t1 = time.perf_counter()
    centers, used, inertia, _ = lloyd.run_steps(xs, init, k, comm, rows, iters, xsq, first)
    _sync(xs[0].device)
    t2 = time.perf_counter()
    launches = lloyd.LAUNCHES
    labels = lloyd.sharded_labels(xs, used, rows, first)
    timed = TimedComm(comm)
    lloyd.run_steps(xs, init, k, timed, rows, iters, xsq, first)
    return {
        "launches": launches,
        "xsq_ms": (t1 - t0) * 1e3,
        "ms_per_iter": (t2 - t1) * 1e3 / iters,
        "allreduce_ms_per_iter": sum(timed.ms) / len(timed.ms) if timed.ms else 0.0,
        "centers": centers,
        "labels": labels,
        "inertia": inertia,
    }


def _device(kind: str) -> str:
    return "gpu" if kind == "cuda" else "cpu"


def run_lloyd(args, comm, doc) -> int:
    device = comm.local_devices[0]
    data, init = lloyd_table(args.lloyd_rows, args.lloyd_features, args.clusters, args.seed, device)
    shards = lloyd_shards(data, comm.size, range(comm.first_rank, comm.first_rank + len(comm.local_devices)))
    shards = [s.to(d) for s, d in zip(shards, comm.local_devices)]
    del data
    fit = lloyd_fit(comm, shards, init, args.clusters, args.lloyd_rows, args.iters)
    labels = fit.pop("labels").to(torch.int32).cpu().numpy()
    os.makedirs(args.out, exist_ok=True)
    np.save(_result_path(args.out, doc["epoch"], doc["rank"], "labels", "npy"), labels)
    centers = fit.pop("centers").float().cpu()
    doc.update(fit, status="done", completed_steps=args.iters, centers=centers.tolist(),
               centers_hex=centers.numpy().tobytes().hex(), inertia=float(fit["inertia"]),
               device=str(device), local_shards=len(shards), first_rank=comm.first_rank, ranks=comm.size)
    _write_result(args.out, doc)
    return 0


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
    ap.add_argument("--workload", choices=("lstsq", "lloyd"), default="lstsq")
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default=None,
                    help="the payload's backend (default: gloo on the CPU, nccl on CUDA)")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--checkpoint-every", type=int, default=2)
    ap.add_argument("--rows", type=int, default=64)
    ap.add_argument("--dim", type=int, default=16)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--lloyd-rows", type=int, default=10_000_000)
    ap.add_argument("--lloyd-features", type=int, default=16)
    ap.add_argument("--clusters", type=int, default=8)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--seed", type=int, default=LLOYD_SEED)
    ap.add_argument("--ckpt-dir", default=None, help="checkpoint directory (lstsq)")
    ap.add_argument("--out", required=True, help="result directory")
    ap.add_argument("--die-rank", type=int, default=-1)
    ap.add_argument("--die-at-step", type=int, default=-1)
    ap.add_argument("--hang-rank", type=int, default=-1)
    ap.add_argument("--hang-at-step", type=int, default=-1)
    args = ap.parse_args(argv)
    if args.workload == "lstsq" and not args.ckpt_dir:
        ap.error("--workload lstsq needs --ckpt-dir")

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
    if args.workload == "lloyd":
        return run_lloyd(args, comm, doc)
    return run_lstsq(args, comm, doc)


if __name__ == "__main__":
    sys.exit(main())
