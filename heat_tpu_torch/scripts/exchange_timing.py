"""Times the cross-process exchange of one ``heat_tpu_torch`` tree: two
processes over gloo, one shard of the card (or of the CPU) each, time an
``allreduce`` of 548 bytes, a shift-1 ``ppermute`` of one 50,000 x 64
float32 block per rank, and config 3's ``KMeans`` fit by part
(``multiproc_trainer.timed_fit``: its ms per Lloyd iteration and those of
its 548-byte allreduce).

It imports the package from ``--root`` (default: the tree it lies in), so
one command can time two trees in turns on one card::

    python heat_tpu_torch/scripts/exchange_timing.py --root OLD --out DIR/old
    python heat_tpu_torch/scripts/exchange_timing.py --root . --out DIR/new

Each worker writes ``DIR/.../exchange-<process>.json``; the launcher prints
one JSON line with both processes' medians. :func:`time_exchange` is also
the ``exchange`` workload of ``multiproc_trainer``, which the chip script's
phase 22 runs.
"""

import argparse
import json
import os
import statistics
import sys
import time

REDUCE_ELEMENTS = 137  # 548 bytes of float32: a Lloyd step's sums, counts and inertia at k 8, f 16
BLOCK = (50_000, 64)  # one rank's rows of config 2 on two ranks
ROWS, FEATURES, CLUSTERS, ITERS, SEED = 10_000_000, 16, 8, 30, 20261016


def time_exchange(comm, reps: int) -> dict:
    """The exchange on ``comm``: ``reps`` timed calls (after three warm
    ones) of an ``allreduce`` of :data:`REDUCE_ELEMENTS` float32 and of a
    shift-1 ``ppermute`` of one :data:`BLOCK` float32 block per rank, each
    call closed by a synchronization of this process's first device; the
    milliseconds of each call."""
    import torch

    home = comm.local_devices[0]

    def sync():
        if home.type == "cuda":
            torch.cuda.synchronize(home)

    small = [torch.ones(REDUCE_ELEMENTS, device=d) for d in comm.local_devices]
    block = [torch.ones(BLOCK, device=d) for d in comm.local_devices]
    out = {}
    for name, fn in (("allreduce_548B", lambda: comm.allreduce(small)),
                     ("ppermute_block", lambda: comm.ppermute(block, shift=1))):
        times = []
        for i in range(reps + 3):
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            if i >= 3:
                times.append((time.perf_counter() - t0) * 1e3)
        out[name] = times
    return out


def worker(args) -> None:
    import heat_tpu_torch as ht
    from heat_tpu_torch.core import multihost
    from heat_tpu_torch.scripts import multiproc_trainer as trainer

    kind = "gpu" if args.device == "cuda" else "cpu"
    comm = multihost.initialize_distributed(device=kind, backend="gloo", heartbeat=False)
    doc = {"process": multihost.process_index(), "package": os.path.dirname(os.path.abspath(ht.__file__))}
    doc.update(time_exchange(comm, args.reps))
    data = trainer.lloyd_table(args.rows, FEATURES, CLUSTERS, SEED, comm.local_devices[0])
    x = ht.array(data, split=0, comm=comm)
    del data
    _, timing = trainer.timed_fit(ht, x, CLUSTERS, ITERS, SEED)
    doc.update({k: timing[k] for k in ("ms_per_iter", "allreduce_ms_per_iter", "fit_s")})
    with open(os.path.join(args.out, f"exchange-{doc['process']}.json"), "w") as fh:
        json.dump(doc, fh)
    multihost.sync_processes("exchange.done")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                    help="the directory holding the heat_tpu_torch package to time")
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--rows", type=int, default=ROWS, help="config 3's rows for the KMeans fit")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    if args.worker:
        worker(args)
        return 0
    from heat_tpu_torch.core import multihost

    os.makedirs(args.out, exist_ok=True)
    cmd = [sys.executable, os.path.abspath(__file__), "--worker", "--root", root, "--out", args.out, "--device",
           args.device, "--reps", str(args.reps), "--rows", str(args.rows)]
    env = {"PYTHONPATH": root, "OMP_NUM_THREADS": "1"}
    result = multihost.spawn_local(2, cmd, env=env, max_reforms=0, timeout_s=300.0,
                                   mesh=os.path.join(args.out, "mesh"))
    if not result["ok"]:
        print(json.dumps({"ok": False, "generations": str(result["generations"])[:2000]}))
        return 1
    docs = []
    for q in range(2):
        with open(os.path.join(args.out, f"exchange-{q}.json")) as fh:
            docs.append(json.load(fh))
    print(json.dumps({"ok": True, "package": docs[0]["package"], "per_process": [{
        "allreduce_548B_ms_median": statistics.median(d["allreduce_548B"]),
        "ppermute_block_ms_median": statistics.median(d["ppermute_block"]),
        "fit_ms_per_iter": d["ms_per_iter"], "fit_allreduce_ms_per_iter": d["allreduce_ms_per_iter"],
        "fit_s": d["fit_s"]} for d in docs]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
