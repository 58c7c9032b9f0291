"""Local multi-process launcher and supervisor (reference:
scripts/launch_multiproc.py), a thin command line over
:func:`heat_tpu_torch.core.multihost.spawn_local`.

Spawns ``-n`` workers on this machine, each joined into one
``torch.distributed`` world whose mesh spans the processes, supervises
their lease files and, when a worker dies or hangs, reforms: the survivors
drain and exit ``REFORM_EXIT``, the launcher re-ranks them into a smaller
world under a bumped ``HEAT_TPU_MESH_EPOCH`` and a fresh coordinator port,
and the respawned generation restores from the newest verified checkpoint.

Everything after ``--`` is the worker command, run once per process with the
launcher's environment. Without one, the acceptance trainer runs on the
CPU::

    python -m heat_tpu_torch.scripts.launch_multiproc -n 2 -- \\
        python -m heat_tpu_torch.scripts.multiproc_trainer --device cpu \\
            --steps 8 --ckpt-dir /tmp/ckpt --out /tmp/out

Chaos: ``--kill-rank R --kill-at-step S`` kills rank R from outside once its
progress beacon reaches step S; ``--kill-after-s T`` kills it after T
seconds instead. The launcher prints the run's summary as JSON and exits 0
only if the last generation completed cleanly.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    worker_cmd = None
    if "--" in argv:
        split = argv.index("--")
        argv, worker_cmd = argv[:split], argv[split + 1 :]

    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("-n", "--num-processes", type=int, default=2)
    ap.add_argument("--mesh-dir", default=None, help="shared coordination directory (default: a fresh temporary one)")
    ap.add_argument("--max-reforms", type=int, default=1)
    ap.add_argument("--devices-per-process", type=int, default=1, help="each worker's CPU mesh size")
    ap.add_argument("--barrier-timeout-ms", type=float, default=30_000.0)
    ap.add_argument("--heartbeat-ms", type=float, default=200.0)
    ap.add_argument("--peer-lost-ms", type=float, default=None)
    ap.add_argument("--timeout-s", type=float, default=600.0)
    ap.add_argument("--kill-rank", type=int, default=None)
    ap.add_argument("--kill-at-step", type=int, default=None)
    ap.add_argument("--kill-after-s", type=float, default=None)
    ap.add_argument("--quiet", action="store_true", help="drop the workers' standard output and error")
    args = ap.parse_args(argv)

    from ..core import multihost

    if not worker_cmd:
        scratch = args.mesh_dir or tempfile.mkdtemp(prefix="heat_tpu_mp_")
        worker_cmd = [
            sys.executable, "-m", "heat_tpu_torch.scripts.multiproc_trainer", "--device", "cpu",
            "--ckpt-dir", os.path.join(scratch, "ckpt"), "--out", os.path.join(scratch, "out"),
        ]

    kill = None
    if args.kill_rank is not None:
        kill = {"rank": args.kill_rank}
        if args.kill_at_step is not None:
            kill["at_step"] = args.kill_at_step
        elif args.kill_after_s is not None:
            kill["after_s"] = args.kill_after_s
        else:
            ap.error("--kill-rank needs --kill-at-step or --kill-after-s")

    result = multihost.spawn_local(
        args.num_processes,
        worker_cmd,
        mesh=args.mesh_dir,
        max_reforms=args.max_reforms,
        devices_per_process=args.devices_per_process,
        barrier_timeout_ms=args.barrier_timeout_ms,
        heartbeat_ms=args.heartbeat_ms,
        peer_lost_ms=args.peer_lost_ms,
        timeout_s=args.timeout_s,
        kill=kill,
        stdout=subprocess.DEVNULL if args.quiet else None,
    )
    json.dump(result, sys.stdout, indent=2, sort_keys=True, default=str)
    print()
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
