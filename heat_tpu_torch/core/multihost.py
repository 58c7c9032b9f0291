"""The multi-process runtime: every per-process decision in one place
(reference: heat_tpu/core/multihost.py).

The reference framework gets its process world from MPI ranks (reference
communication.py:1886-1891); here it comes from ``torch.distributed``. The
call sites that must care (sharded ingest, ``lshape``, streaming saves,
the atomic publication, the cooperative checkpoint) route through these
helpers, so the contract is testable against a mocked process topology.

The seam
--------
* ``process_index()`` / ``process_count()``: this process's rank and the
  world's size once ``torch.distributed`` is initialized, 0 and 1 before.
* ``is_addressable(placement)``: whether this process holds a rank. A mesh
  rank is read through whatever stands for it (``MeshCommunication.placements``:
  a ``RankPlacement`` on a process-spanning mesh, a torch device on the
  in-process mesh); an entry without ``process_index`` is this process's.
* ``ranks_to_read(placements)``: the (rank, placement) pairs this process
  populates when it ingests a split array, in rank order.
* ``representative_rank(placements)``: the rank whose chunk this process
  reports as "the local shard" (``lshape``): its first.
* ``io_owner()``: whether this process publishes a cooperative file write
  (``resilience.atomic_write``'s rename): process 0.
* ``sync_processes(tag)``: a named barrier over the world's gloo control
  group. ``HEAT_TPU_BARRIER_TIMEOUT_MS`` (off by default; the launcher turns
  it on) bounds the wait: a peer dead mid-barrier surfaces as a
  ``resilience.StallError`` naming the tag instead of a deadlock.

The process world's lifecycle
-----------------------------
* :func:`initialize_distributed` is the guarded bring-up: coordinator,
  world size and id from arguments or ``HEAT_TPU_COORDINATOR`` /
  ``HEAT_TPU_NUM_PROCESSES`` / ``HEAT_TPU_PROCESS_ID`` (what
  :func:`spawn_local` exports), ``communication.initialize`` retried on
  transient connect faults under ``resilience.retry_policy``, and the
  ``multihost.init`` fault site before every connect.
* The **lease heartbeat daemon** (:func:`start_heartbeat`) beats a lease
  file under ``$HEAT_TPU_MESH_DIR/lease/`` every ``HEAT_TPU_HEARTBEAT_MS``;
  a peer whose lease is older than ``HEAT_TPU_PEER_LOST_MS`` becomes a
  named :class:`PeerLostError` and a ``peer_lost`` event instead of a hang.
  A gloo collective with a SIGKILLed peer usually raises, but one with a
  hung peer (sockets open) blocks until the group's timeout: the lease
  daemon and its drain watchdog act well before that.
* :func:`spawn_local` launches N workers on this machine and supervises
  them across **generations**: when a worker dies, the survivors detect
  it, drain and exit with :data:`REFORM_EXIT`; the launcher re-ranks them
  contiguously, bumps the mesh epoch, takes a fresh coordinator port and
  respawns them into a smaller world that restores from the newest
  verified checkpoint.

Observability: ``telemetry.report()["multihost"]`` (the hook this module
installs) carries the heartbeat, barrier and abandoned-thread counters, and
the ops plane exports them as ``heat_tpu_peers_*`` / ``heat_tpu_barrier_*``
gauges with a ``/readyz`` check that flips unready while a peer is lost.
"""

from __future__ import annotations

import datetime
import json
import os
import socket
import subprocess
import sys
import threading
import time
import warnings
from typing import Any, Callable, Dict, FrozenSet, List, Optional, Sequence, Tuple

__all__ = [
    "PeerLostError",
    "REFORM_EXIT",
    "check_peers",
    "heartbeat_stats",
    "initialize_distributed",
    "io_owner",
    "is_addressable",
    "lost_peers",
    "reform_exit",
    "mesh_dir",
    "mesh_epoch",
    "note_progress",
    "process_count",
    "process_index",
    "ranks_to_read",
    "report_stats",
    "representative_rank",
    "reset_peers",
    "spawn_local",
    "start_heartbeat",
    "stop_heartbeat",
    "sync_processes",
]

#: values that read as "knob off"
_OFF_VALUES = ("", "0", "false", "off", "no")

#: worker exit code meaning "peer lost: I drained; respawn me into a smaller
#: world", the launcher's reform signal (sysexits leaves 64-78 to users)
REFORM_EXIT = 77


class PeerLostError(RuntimeError):
    """A peer process stopped beating its lease: barriers, collectives and
    cooperative checkpoints would hang or fail. ``peers`` names the lost
    process ids. A launcher-managed worker drains and exits with
    :data:`REFORM_EXIT` on this."""

    def __init__(self, message: str, peers: Sequence[int] = ()):
        super().__init__(message)
        self.peers = tuple(int(p) for p in peers)


# ----------------------------------------------------------------------
# observability: report()["multihost"]
# ----------------------------------------------------------------------
_LOCK = threading.Lock()
_STATS: Dict[str, Any] = {
    "world": 1,              # processes in the current world
    "epoch": 0,              # mesh generation (the launcher bumps it per reform)
    "barriers": 0,           # sync_processes waits entered (multi-process)
    "barrier_timeouts": 0,   # barriers abandoned on StallError
    "abandoned_threads": 0,  # barrier threads abandoned, in all
    "heartbeats": 0,         # lease beats written
    "heartbeat_errors": 0,   # beats that failed to write (missed beats)
    "init_retries": 0,       # transient connect faults retried
}
#: peers declared lost by the lease daemon (process ids)
_LOST: set = set()
#: abandoned barrier threads, pruned of finished ones on read
_ABANDONED: List[threading.Thread] = []


def _abandoned_alive() -> int:
    with _LOCK:
        _ABANDONED[:] = [t for t in _ABANDONED if t.is_alive()]
        return len(_ABANDONED)


def _abandoned_cap() -> int:
    """``HEAT_TPU_ABANDONED_BARRIER_CAP``: warn once this many barrier
    threads were abandoned (default 8)."""
    raw = os.environ.get("HEAT_TPU_ABANDONED_BARRIER_CAP", "").strip()
    try:
        return max(1, int(raw)) if raw else 8
    except ValueError:
        return 8


def report_stats() -> Dict[str, Any]:
    """The runtime's counters, ``telemetry.report()``'s ``multihost`` block."""
    with _LOCK:
        doc = dict(_STATS)
        doc["peers_lost"] = sorted(_LOST)
    hb = _HEARTBEAT
    doc["heartbeat_running"] = hb is not None and hb.is_alive()
    if hb is not None:
        doc["world"] = hb.world
        doc["epoch"] = hb.epoch
    doc["abandoned_alive"] = _abandoned_alive()
    return doc


def reset_peers() -> None:
    """Forget every lost-peer declaration (a fresh epoch starts clean)."""
    with _LOCK:
        _LOST.clear()


# ----------------------------------------------------------------------
# env knobs
# ----------------------------------------------------------------------
def _barrier_timeout_ms() -> Optional[float]:
    """``HEAT_TPU_BARRIER_TIMEOUT_MS``: off by default (a slow peer is not a
    dead one), a positive bound in milliseconds otherwise; a malformed value
    warns and reads as off."""
    raw = os.environ.get("HEAT_TPU_BARRIER_TIMEOUT_MS", "").strip().lower()
    if raw in _OFF_VALUES:
        return None
    try:
        value = float(raw)
    except ValueError:
        warnings.warn(f"HEAT_TPU_BARRIER_TIMEOUT_MS={raw!r} is not a number; barrier timeout stays off", stacklevel=2)
        return None
    return value if value > 0 else None


def _env_ms(name: str, default: float) -> float:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        value = float(raw)
    except ValueError:
        warnings.warn(f"{name}={raw!r} is not a number; using {default:g}", stacklevel=2)
        return default
    return value if value > 0 else default


def mesh_dir() -> Optional[str]:
    """``HEAT_TPU_MESH_DIR``: the shared directory of lease files, lost-peer
    markers and progress beacons; None when unset (no lease daemon)."""
    raw = os.environ.get("HEAT_TPU_MESH_DIR", "").strip()
    return raw or None


def mesh_epoch() -> int:
    """``HEAT_TPU_MESH_EPOCH``: the generation of the process world (0 at
    first launch; each reform bumps it, so a stale lease of an earlier
    generation never reads as a live peer)."""
    raw = os.environ.get("HEAT_TPU_MESH_EPOCH", "").strip()
    try:
        return int(raw) if raw else 0
    except ValueError:
        return 0


def _lease_path(mesh: str, epoch: int, proc: int) -> str:
    return os.path.join(mesh, "lease", f"epoch-{epoch:04d}", f"proc-{proc:05d}")


def _lost_dir(mesh: str, epoch: int) -> str:
    return os.path.join(mesh, "lost", f"epoch-{epoch:04d}")


def _progress_path(mesh: str, epoch: int, proc: int) -> str:
    return os.path.join(mesh, "progress", f"epoch-{epoch:04d}", f"proc-{proc:05d}")


def _write_atomic(path: str, payload: str) -> None:
    """A small file published by rename: a reader never sees a torn write."""
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "w") as fh:
        fh.write(payload)
    os.replace(tmp, path)


# ----------------------------------------------------------------------
# the per-process facts
# ----------------------------------------------------------------------
def _distributed_client_live() -> bool:
    """Whether this process is in a ``torch.distributed`` world."""
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    """This process's rank in the ``torch.distributed`` world; 0 before
    the world is initialized."""
    if not _distributed_client_live():
        return 0
    import torch.distributed as dist

    return int(dist.get_rank())


def process_count() -> int:
    """The number of processes of the world; 1 before it is initialized."""
    if not _distributed_client_live():
        return 1
    import torch.distributed as dist

    return int(dist.get_world_size())


def _barrier(tag: str, timeout_ms: Optional[float]) -> None:
    """One named barrier over the control group: ``monitored_barrier``,
    which names the ranks that did not arrive when ``timeout_ms`` is set,
    then the tags of every process, which must match."""
    import torch.distributed as dist

    from . import communication

    group = communication._control_group()
    if group is None:
        raise RuntimeError(f"barrier {tag!r}: the process world has no control group (communication.initialize)")
    if timeout_ms is not None:
        dist.monitored_barrier(group=group, timeout=datetime.timedelta(milliseconds=timeout_ms), wait_all_ranks=True)
    tags: List[Optional[str]] = [None] * process_count()
    dist.all_gather_object(tags, tag, group=group)
    if any(t != tag for t in tags):
        raise RuntimeError(f"barrier {tag!r} met other barriers across processes: tags by process {tags}")


def sync_processes(tag: str, timeout_ms: Optional[float] = None) -> None:
    """Named barrier across processes (a no-op in a world of one).

    The cooperative checkpoint needs every process's files on the shared
    filesystem before the owner publishes the manifest that names them.
    ``tag`` names the barrier, and the tags of every process are compared,
    so mismatched call sites raise with both names instead of pairing.

    ``timeout_ms`` (or ``HEAT_TPU_BARRIER_TIMEOUT_MS``) bounds the wait: the
    barrier runs on a daemon thread, and when the bound expires a
    ``resilience.StallError`` naming the tag surfaces here. Abandoned
    threads are counted and warn past ``HEAT_TPU_ABANDONED_BARRIER_CAP``.
    The ``multihost.barrier`` fault site fires at entry, before the
    one-process early out."""
    from . import resilience

    if resilience._ARMED:
        resilience.check("multihost.barrier")
    if process_count() <= 1:
        return
    with _LOCK:
        _STATS["barriers"] += 1
    if timeout_ms is None:
        timeout_ms = _barrier_timeout_ms()
    if timeout_ms is None:
        _barrier(tag, None)
        return
    failure: List[BaseException] = []
    done = threading.Event()

    def _run() -> None:
        try:
            _barrier(tag, timeout_ms)
        except BaseException as exc:  # noqa: BLE001 - relayed to the caller
            failure.append(exc)
        finally:
            done.set()

    worker = threading.Thread(target=_run, name=f"heat-tpu-barrier:{tag}", daemon=True)
    worker.start()
    if not done.wait(float(timeout_ms) / 1e3):
        with _LOCK:
            _STATS["barrier_timeouts"] += 1
            _STATS["abandoned_threads"] += 1
            abandoned_total = _STATS["abandoned_threads"]
            _ABANDONED.append(worker)
        cap = _abandoned_cap()
        if abandoned_total >= cap:
            warnings.warn(
                f"{abandoned_total} barrier daemon thread(s) abandoned on timeout (cap {cap}, "
                "HEAT_TPU_ABANDONED_BARRIER_CAP): a flapping peer is leaking threads; reform the world "
                "or raise the barrier timeout",
                resilience.StallWarning,
                stacklevel=2,
            )
        raise resilience.StallError(
            f"barrier {tag!r} still waiting after {timeout_ms:g}ms (HEAT_TPU_BARRIER_TIMEOUT_MS): a peer "
            "process likely died mid-barrier; the hung barrier is abandoned on its daemon thread"
        )
    if failure:
        raise failure[0]


def io_owner(proc: Optional[int] = None) -> bool:
    """Whether this process publishes a cooperative file write (the
    temp-to-target rename of ``resilience.atomic_write``): process 0. When
    process 0 is the dead peer, no survivor publishes: cooperative saves
    fail fast with :class:`PeerLostError`, and the launcher's re-rank gives
    the next generation a process 0 again."""
    return (process_index() if proc is None else proc) == 0


def is_addressable(placement, proc: Optional[int] = None) -> bool:
    """Whether this process holds the rank ``placement`` stands for; an
    entry without ``process_index`` (a torch device of the in-process
    mesh) is this process's."""
    if proc is None:
        proc = process_index()
    return getattr(placement, "process_index", proc) == proc


def ranks_to_read(placements: Sequence, proc: Optional[int] = None) -> List[Tuple[int, object]]:
    """The (rank, placement) pairs this process populates when it ingests
    a split array: the ranks it holds, in rank order."""
    if proc is None:
        proc = process_index()
    return [(r, d) for r, d in enumerate(placements) if is_addressable(d, proc)]


def representative_rank(placements: Sequence, proc: Optional[int] = None) -> int:
    """The rank whose chunk this process reports as "the local shard"
    (``DNDarray.lshape``): the first it holds, 0 when it holds none."""
    if proc is None:
        proc = process_index()
    for r, d in enumerate(placements):
        if is_addressable(d, proc):
            return r
    return 0


# ----------------------------------------------------------------------
# the lease heartbeat daemon: peer loss as a named event, not a hang
# ----------------------------------------------------------------------
class _HeartbeatDaemon(threading.Thread):
    """Beats this process's lease file and watches the peers'.

    One file per process per epoch under ``{mesh_dir}/lease/``; a lease's
    age is its mtime against this process's clock (one machine's clock for
    the launcher, the file server's on shared storage). A peer is lost when
    its lease is older than ``lost_after_s``; a missing file gets the same
    grace from the daemon's start. Declarations stick until
    :func:`reset_peers`: a peer that comes back belongs to an earlier world
    and rejoins through a new epoch."""

    def __init__(self, mesh: str, process: int, world: int, epoch: int, interval_s: float, lost_after_s: float,
                 on_peer_lost: Optional[Callable[[int], None]] = None):
        super().__init__(name="heat-tpu-heartbeat", daemon=True)
        self.mesh = mesh
        self.process = int(process)
        self.world = int(world)
        self.epoch = int(epoch)
        self.interval_s = float(interval_s)
        self.lost_after_s = float(lost_after_s)
        self.on_peer_lost = on_peer_lost
        self._watchdog_armed = False
        self._halt = threading.Event()
        self._started_at = time.time()
        self._lease = _lease_path(mesh, self.epoch, self.process)
        os.makedirs(os.path.dirname(self._lease), exist_ok=True)

    def stop(self) -> None:
        self._halt.set()

    def run(self) -> None:
        beat = 0
        while not self._halt.is_set():
            beat += 1
            self._beat(beat)
            self._scan()
            self._halt.wait(self.interval_s)

    def _beat(self, beat: int) -> None:
        from . import resilience

        try:
            if resilience._ARMED:
                resilience.check("multihost.heartbeat")
            _write_atomic(self._lease, json.dumps(
                {"process": self.process, "epoch": self.epoch, "beat": beat, "pid": os.getpid(), "time": time.time()}))
            with _LOCK:
                _STATS["heartbeats"] += 1
        # a failed beat is a missed beat, counted, never a daemon crash
        except Exception:  # noqa: BLE001
            with _LOCK:
                _STATS["heartbeat_errors"] += 1

    def _scan(self) -> None:
        now = time.time()
        for peer in range(self.world):
            if peer == self.process:
                continue
            with _LOCK:
                if peer in _LOST:
                    continue
            try:
                age = now - os.stat(_lease_path(self.mesh, self.epoch, peer)).st_mtime
            except OSError:
                age = now - self._started_at  # never beaten: grace from our start
            if age > self.lost_after_s:
                self._declare_lost(peer, age)

    def _declare_lost(self, peer: int, age_s: float) -> None:
        with _LOCK:
            if peer in _LOST:
                return
            _LOST.add(peer)
        # the marker is the launcher's evidence of who died
        try:
            lost_dir = _lost_dir(self.mesh, self.epoch)
            os.makedirs(lost_dir, exist_ok=True)
            _write_atomic(os.path.join(lost_dir, f"proc-{peer:05d}"), json.dumps(
                {"peer": peer, "by": self.process, "age_s": round(age_s, 3), "time": time.time()}))
        except OSError:
            pass
        from . import telemetry

        if telemetry._MODE:
            telemetry.record_event("peer_lost", peer=peer, epoch=self.epoch, age_ms=round(age_s * 1e3, 1),
                                   world=self.world)
        warnings.warn(
            f"peer process {peer} lost (lease silent {age_s * 1e3:.0f}ms > {self.lost_after_s * 1e3:.0f}ms, "
            f"epoch {self.epoch}): the process world is degraded",
            stacklevel=2,
        )
        if self.on_peer_lost is not None:
            try:
                self.on_peer_lost(peer)
            except Exception:  # noqa: BLE001 - a callback must not kill the daemon
                pass
        self._maybe_arm_drain_watchdog()

    def _maybe_arm_drain_watchdog(self) -> None:
        """The backstop for a peer that hangs instead of dying: a worker
        blocked inside a gloo collective with a hung peer (whose sockets
        stay open) waits until the group's timeout. Once a loss is
        declared, a one-shot timer forces :func:`reform_exit` if the worker
        still runs after ``HEAT_TPU_DRAIN_GRACE_MS``. Opt-in: :func:`spawn_local`
        exports the knob for its workers, and a bare process is never
        ended by a timer it did not ask for."""
        raw = os.environ.get("HEAT_TPU_DRAIN_GRACE_MS", "").strip().lower()
        if raw in _OFF_VALUES:
            return
        try:
            grace_ms = float(raw)
        except ValueError:
            return
        if grace_ms <= 0 or self._watchdog_armed:
            return
        self._watchdog_armed = True

        def _watch() -> None:
            time.sleep(grace_ms / 1e3)
            with _LOCK:
                lost = sorted(_LOST)
            warnings.warn(
                f"peer(s) {lost} lost and this worker is still running after the {grace_ms:g}ms drain grace "
                "(HEAT_TPU_DRAIN_GRACE_MS): likely blocked in a collective with a dead peer; forcing reform exit",
                stacklevel=2,
            )
            from . import telemetry

            if telemetry._MODE:
                telemetry.record_event("drain_watchdog_fired", peers=lost, epoch=self.epoch)
            reform_exit()

        threading.Thread(target=_watch, name="heat-tpu-drain-watchdog", daemon=True).start()


_HEARTBEAT: Optional[_HeartbeatDaemon] = None


def start_heartbeat(
    *,
    mesh: Optional[str] = None,
    process: Optional[int] = None,
    world: Optional[int] = None,
    epoch: Optional[int] = None,
    interval_ms: Optional[float] = None,
    lost_ms: Optional[float] = None,
    on_peer_lost: Optional[Callable[[int], None]] = None,
) -> bool:
    """Start (or restart) the lease daemon. Defaults come from
    ``HEAT_TPU_MESH_DIR`` / ``HEAT_TPU_HEARTBEAT_MS`` (500) /
    ``HEAT_TPU_PEER_LOST_MS`` (5 beats) / ``HEAT_TPU_MESH_EPOCH`` and the
    live world. Returns False, starting nothing, without a mesh dir or in a
    world of one; True once the daemon beats."""
    global _HEARTBEAT
    mesh = mesh if mesh is not None else mesh_dir()
    if not mesh:
        return False
    world = int(world) if world is not None else process_count()
    if world <= 1:
        return False
    process = int(process) if process is not None else process_index()
    epoch = int(epoch) if epoch is not None else mesh_epoch()
    interval_ms = float(interval_ms) if interval_ms is not None else _env_ms("HEAT_TPU_HEARTBEAT_MS", 500.0)
    lost_ms = float(lost_ms) if lost_ms is not None else _env_ms("HEAT_TPU_PEER_LOST_MS", 5.0 * interval_ms)
    stop_heartbeat()
    daemon = _HeartbeatDaemon(mesh, process, world, epoch, interval_s=interval_ms / 1e3,
                              lost_after_s=lost_ms / 1e3, on_peer_lost=on_peer_lost)
    with _LOCK:
        _STATS["world"] = world
        _STATS["epoch"] = epoch
    daemon.start()
    _HEARTBEAT = daemon
    return True


def stop_heartbeat() -> None:
    """Stop the lease daemon (idempotent). Lost-peer declarations persist:
    they describe the world; :func:`reset_peers` clears them."""
    global _HEARTBEAT
    daemon, _HEARTBEAT = _HEARTBEAT, None
    if daemon is not None:
        daemon.stop()
        daemon.join(timeout=2.0)


def lost_peers() -> FrozenSet[int]:
    """The peer process ids declared lost (empty while the world is whole)."""
    with _LOCK:
        return frozenset(_LOST)


def check_peers() -> None:
    """Raise :class:`PeerLostError` if a peer is declared lost: the poll of a
    launcher-managed worker between steps, before the next cross-process
    collective can block on a dead peer."""
    with _LOCK:
        lost = sorted(_LOST)
    if lost:
        raise PeerLostError(
            f"peer process(es) {lost} lost (missed lease beats in epoch {_STATS['epoch']}): drain and exit for reform",
            peers=lost,
        )


def heartbeat_stats() -> Dict[str, Any]:
    """:func:`report_stats` under the name that goes with :func:`start_heartbeat`."""
    return report_stats()


def reform_exit() -> None:
    """Leave this worker with :data:`REFORM_EXIT`, past ``atexit``.

    A survivor of a lost peer must not take the interpreter's normal exit:
    ``destroy_process_group`` and gloo's teardown at exit can block on a
    dead or hung peer (a hung peer keeps its sockets open, so they wait out
    the group's timeout), turning a clean drain into a hang. ``os._exit``
    skips all of that; callers flush their results to disk first (the
    lease daemon is stopped here)."""
    stop_heartbeat()
    try:
        sys.stdout.flush()
        sys.stderr.flush()
    except Exception:  # noqa: BLE001 - a broken pipe must not block the exit
        pass
    os._exit(REFORM_EXIT)


def note_progress(step: int) -> None:
    """Publish this process's training step under ``{mesh_dir}/progress/``:
    the launcher's chaos injector keys its kills off these beacons, and the
    recovery timing reads a respawned generation's first. No mesh dir, no
    beacon."""
    mesh = mesh_dir()
    if not mesh:
        return
    path = _progress_path(mesh, mesh_epoch(), process_index())
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        _write_atomic(path, json.dumps({"step": int(step), "time": time.time()}))
    except OSError:
        pass


# ----------------------------------------------------------------------
# guarded bring-up: torch.distributed with retry, fault site, heartbeat
# ----------------------------------------------------------------------
#: the words of a connect failure worth a retry: the TCPStore's
#: ``DistNetworkError`` and ``DistStoreError`` carry them, as do gloo's and
#: NCCL's ``RuntimeError``s
_TRANSIENT_WORDS = (
    "connection refused", "timed out", "timeout", "connection reset", "failed to connect", "unavailable",
    "deadline", "broken pipe", "temporarily",
)


def _transient_init_fault(exc: BaseException, policy) -> bool:
    """Whether a connect failure is worth a retry: ``ConnectionError``
    always; ``torch.distributed``'s ``DistNetworkError`` and
    ``DistStoreError`` (the TCPStore's: the coordinator's port not up yet, a
    handshake cut) always; other ``OSError``s by the policy's errnos; other
    ``RuntimeError``s when their message says refused, reset, timed out or
    unavailable."""
    if isinstance(exc, ConnectionError):
        return True
    try:
        import torch.distributed as dist

        store_errors = (dist.DistNetworkError, dist.DistStoreError)
    except (ImportError, AttributeError):
        store_errors = ()
    if store_errors and isinstance(exc, store_errors):
        return True
    if isinstance(exc, OSError):
        return policy.is_transient(exc)
    if isinstance(exc, RuntimeError):
        msg = str(exc).lower()
        return any(word in msg for word in _TRANSIENT_WORDS)
    return False


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    heartbeat: bool = True,
    retries: Optional[int] = None,
    backoff_s: Optional[float] = None,
    **kwargs,
):
    """Bring up the process world, guarded.

    Wraps ``communication.initialize`` (``torch.distributed.init_process_group``,
    a gloo control group and the process-spanning mesh) with:

    * the launcher's environment: ``HEAT_TPU_COORDINATOR`` /
      ``HEAT_TPU_NUM_PROCESSES`` / ``HEAT_TPU_PROCESS_ID`` fill any argument
      left None, so a :func:`spawn_local` worker passes none;
    * retries with backoff of transient connect faults
      (``resilience.retry_policy``; ``retries``/``backoff_s`` override); any
      other fault propagates at the first attempt;
    * the ``multihost.init`` fault site before every connect;
    * the lease daemon, started in a world of several processes when a mesh
      dir is set.

    ``kwargs`` go to ``communication.initialize`` (``backend``, ``device``,
    ``timeout_s``). Idempotent: with a live world it builds the mesh again.
    Returns the installed :class:`~.communication.ProcessMeshCommunication`."""
    from . import communication, resilience, telemetry

    env = os.environ
    if coordinator_address is None:
        coordinator_address = env.get("HEAT_TPU_COORDINATOR", "").strip() or None
    if num_processes is None:
        raw = env.get("HEAT_TPU_NUM_PROCESSES", "").strip()
        num_processes = int(raw) if raw else None
    if process_id is None:
        raw = env.get("HEAT_TPU_PROCESS_ID", "").strip()
        process_id = int(raw) if raw else None
    policy = resilience.retry_policy
    attempts_left = policy.retries if retries is None else int(retries)
    delay = policy.base_delay if backoff_s is None else float(backoff_s)
    while True:
        try:
            if resilience._ARMED:
                resilience.check("multihost.init")
            comm = communication.initialize(
                coordinator_address=coordinator_address,
                num_processes=num_processes,
                process_id=process_id,
                **kwargs,
            )
            break
        except Exception as exc:  # noqa: BLE001 - classified below
            if attempts_left <= 0 or not _transient_init_fault(exc, policy):
                raise
            attempts_left -= 1
            with _LOCK:
                _STATS["init_retries"] += 1
            if telemetry._MODE:
                telemetry.record_event("distributed_init_retry", error=repr(exc), delay_s=delay)
            time.sleep(min(delay, policy.max_delay))
            delay *= 2.0
    world = process_count()
    with _LOCK:
        _STATS["world"] = world
        _STATS["epoch"] = mesh_epoch()
    if telemetry._MODE:
        telemetry.record_event("distributed_init", world=world, process=process_index(), epoch=mesh_epoch())
    if heartbeat and world > 1:
        start_heartbeat(world=world)
    return comm


# ----------------------------------------------------------------------
# the local launcher: N coordinated processes, supervised across generations
# ----------------------------------------------------------------------
def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return int(s.getsockname()[1])


def _read_progress_step(mesh: str, epoch: int, proc: int) -> Optional[int]:
    try:
        with open(_progress_path(mesh, epoch, proc)) as fh:
            return int(json.load(fh).get("step"))
    except (OSError, ValueError, TypeError):
        return None


def _first_progress_time(mesh: str, epoch: int, world: int) -> Optional[float]:
    times = []
    for proc in range(world):
        try:
            times.append(os.stat(_progress_path(mesh, epoch, proc)).st_mtime)
        except OSError:
            pass
    return min(times) if times else None


def _read_lost_markers(mesh: str, epoch: int) -> FrozenSet[int]:
    lost = set()
    try:
        for name in os.listdir(_lost_dir(mesh, epoch)):
            if name.startswith("proc-"):
                try:
                    lost.add(int(name.split("-", 1)[1]))
                except ValueError:
                    pass
    except OSError:
        pass
    return frozenset(lost)


def spawn_local(
    n: int,
    command: Sequence[str],
    *,
    mesh: Optional[str] = None,
    max_reforms: int = 1,
    devices_per_process: int = 1,
    barrier_timeout_ms: float = 30_000.0,
    heartbeat_ms: float = 200.0,
    peer_lost_ms: Optional[float] = None,
    drain_grace_ms: Optional[float] = None,
    env: Optional[Dict[str, str]] = None,
    timeout_s: float = 600.0,
    kill: Optional[Dict[str, Any]] = None,
    stdout=None,
) -> Dict[str, Any]:
    """Launch ``command`` as ``n`` coordinated workers on this machine and
    supervise them across reform generations.

    Every worker gets the launcher's contract in its environment:
    ``HEAT_TPU_COORDINATOR`` (a fresh localhost port each generation, where
    process 0's TCPStore listens), ``HEAT_TPU_PROCESS_ID`` /
    ``HEAT_TPU_NUM_PROCESSES`` (contiguous, re-ranked each generation),
    ``HEAT_TPU_MESH_DIR`` / ``HEAT_TPU_MESH_EPOCH``, barrier timeouts on
    (``HEAT_TPU_BARRIER_TIMEOUT_MS``), a fast lease cadence
    (``HEAT_TPU_HEARTBEAT_MS`` / ``HEAT_TPU_PEER_LOST_MS``) and the drain
    grace (``HEAT_TPU_DRAIN_GRACE_MS``). ``devices_per_process`` is each
    worker's CPU mesh size, ``HEAT_TPU_TEST_DEVICES``: the port's
    counterpart of the reference's ``--xla_force_host_platform_device_count``
    flag (a CUDA worker's mesh is every device it sees, which
    ``CUDA_VISIBLE_DEVICES`` in ``env`` sets).

    A generation ends when every child has exited. All zero: done.
    Otherwise the lost set comes from the lease daemons' markers
    (``{mesh}/lost/epoch-*/``), falling back to the non-zero exits other
    than :data:`REFORM_EXIT`. If a worker asked for reform and reforms
    remain, the survivors respawn as a smaller world under the next epoch
    and restore from the newest verified checkpoint themselves. Children
    still alive once every member not marked lost has exited (a hung peer)
    are killed, so a generation cannot hang.

    Chaos: ``kill={"rank": r, "at_step": s}`` kills rank ``r`` once its
    progress beacon (:func:`note_progress`) reaches step ``s``, or
    ``{"rank": r, "after_s": t}`` after ``t`` seconds, in epoch 0.

    Returns ``{"ok", "reforms", "generations", "t_kill", "mesh"}``; each
    generation has its epoch, world, exits, lost set, ``t_spawn``,
    ``t_first_progress``, ``timed_out`` and ``duration_s``."""
    import tempfile

    if mesh is None:
        mesh = tempfile.mkdtemp(prefix="heat-tpu-mesh-")
    os.makedirs(mesh, exist_ok=True)
    command = [str(c) for c in command]
    generations: List[Dict[str, Any]] = []
    result: Dict[str, Any] = {"ok": False, "reforms": 0, "generations": generations, "t_kill": None, "mesh": mesh}
    world = int(n)
    epoch = 0
    kill_pending = dict(kill) if kill else None
    while True:
        port = _free_port()
        base_env = dict(os.environ)
        if env:
            base_env.update(env)
        overrides = env or {}
        if "HEAT_TPU_TEST_DEVICES" not in overrides:
            base_env["HEAT_TPU_TEST_DEVICES"] = str(int(devices_per_process))
        if "HEAT_TPU_BARRIER_TIMEOUT_MS" not in overrides:
            base_env["HEAT_TPU_BARRIER_TIMEOUT_MS"] = f"{barrier_timeout_ms:g}"
        if "HEAT_TPU_HEARTBEAT_MS" not in overrides:
            base_env["HEAT_TPU_HEARTBEAT_MS"] = f"{heartbeat_ms:g}"
        if "HEAT_TPU_PEER_LOST_MS" not in overrides:
            base_env["HEAT_TPU_PEER_LOST_MS"] = f"{peer_lost_ms if peer_lost_ms is not None else 5.0 * heartbeat_ms:g}"
        if "HEAT_TPU_DRAIN_GRACE_MS" not in overrides:
            # the backstop of a survivor stuck in a collective with a hung peer
            grace = drain_grace_ms if drain_grace_ms is not None else max(2_000.0, 10.0 * heartbeat_ms)
            base_env["HEAT_TPU_DRAIN_GRACE_MS"] = f"{grace:g}"
        base_env["HEAT_TPU_MESH_DIR"] = mesh
        base_env["HEAT_TPU_MESH_EPOCH"] = str(epoch)
        base_env["HEAT_TPU_COORDINATOR"] = f"127.0.0.1:{port}"
        base_env["HEAT_TPU_NUM_PROCESSES"] = str(world)
        procs: List[subprocess.Popen] = []
        t_spawn = time.time()
        for rank in range(world):
            penv = dict(base_env)
            penv["HEAT_TPU_PROCESS_ID"] = str(rank)
            procs.append(subprocess.Popen(command, env=penv, stdout=stdout, stderr=stdout))
        gen: Dict[str, Any] = {
            "epoch": epoch, "world": world, "exits": [None] * world, "lost": [], "t_spawn": t_spawn,
            "t_first_progress": None, "timed_out": False,
        }
        generations.append(gen)
        deadline = time.monotonic() + float(timeout_s)
        kill_fired_at = None
        while any(p.poll() is None for p in procs):
            if gen["t_first_progress"] is None:
                gen["t_first_progress"] = _first_progress_time(mesh, epoch, world)
            if kill_pending is not None and epoch == 0:
                rank = int(kill_pending.get("rank", world - 1))
                due = False
                if "at_step" in kill_pending:
                    step = _read_progress_step(mesh, epoch, rank)
                    due = step is not None and step >= int(kill_pending["at_step"])
                if "after_s" in kill_pending:
                    due = due or (time.time() - t_spawn) >= float(kill_pending["after_s"])
                if due and rank < world and procs[rank].poll() is None:
                    procs[rank].kill()
                    result["t_kill"] = kill_fired_at = time.time()
                    kill_pending = None
            # a lost child still running (hung) must not hold the generation
            # open once every other member has exited
            marked = _read_lost_markers(mesh, epoch)
            if marked and all(procs[r].poll() is not None for r in range(world) if r not in marked):
                for r in sorted(marked):
                    if r < world and procs[r].poll() is None:
                        procs[r].kill()
            if time.monotonic() > deadline:
                gen["timed_out"] = True
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                break
            time.sleep(0.05)
        for p in procs:
            p.wait()
        gen["exits"] = [p.returncode for p in procs]
        if gen["t_first_progress"] is None:
            gen["t_first_progress"] = _first_progress_time(mesh, epoch, world)
        gen["duration_s"] = round(time.time() - t_spawn, 3)
        if gen["timed_out"]:
            return result
        if all(rc == 0 for rc in gen["exits"]):
            result["ok"] = True
            return result
        lost = set(_read_lost_markers(mesh, epoch))
        if kill_fired_at is not None and kill is not None:
            lost.add(int(kill.get("rank", world - 1)))
        # the daemons' evidence first, the exit codes only as a fallback
        lost = {r for r in lost if r < world and gen["exits"][r] != 0} or {
            r for r, rc in enumerate(gen["exits"]) if rc not in (0, REFORM_EXIT)
        }
        gen["lost"] = sorted(lost)
        asked_reform = any(rc == REFORM_EXIT for rc in gen["exits"])
        survivors = world - len(lost)
        if not asked_reform or survivors < 1 or result["reforms"] >= int(max_reforms):
            return result
        world = survivors
        epoch += 1
        result["reforms"] += 1


# report()["multihost"] and the ops plane's peer gauges read this hook
from . import telemetry as _telemetry  # noqa: E402

_telemetry._MULTIHOST_HOOK = report_stats
