"""Live elasticity: the preemption-tolerant supervisor (``ht.elastic``;
reference heat_tpu/core/elastic.py).

A job survives the loss of part of its mesh by closing the loop detect →
drain → commit → re-form → restore → resume while it runs:

1. **Detect.** One poll between steps (:meth:`Supervisor.maybe_preempt`)
   reads five triggers: a signal (``HEAT_TPU_ELASTIC_SIGNALS``, default
   ``SIGTERM``), the ``elastic.preempt`` fault site, the health probes of
   :func:`probe_devices`, the per-device fault ledger of
   :mod:`.resilience` (a device past its threshold shrinks the mesh, not
   the job) and the lease daemon of :mod:`.multihost` declaring a peer
   process lost. A lost peer drains, commits what it can and raises
   :class:`~.multihost.PeerLostError`: the worker exits
   ``multihost.REFORM_EXIT`` and its launcher respawns a smaller world; a
   mesh whose ranks span processes is never re-formed from inside one.
2. **Drain and commit.** New fused dispatches are refused
   (``memledger.admission_hold``), the live roots of the fusion recorder
   are forced under a watchdog deadline (``HEAT_TPU_ELASTIC_DRAIN_MS``),
   and a checkpoint is committed through ``utils/checkpoint.py``'s
   manifest rename.
3. **Re-form.** :func:`.communication.reform` installs the surviving mesh
   and drops every mesh-keyed cache; the watchdog's guards and the device
   ledger are cleared; the newest checkpoint that verifies is restored
   onto the new mesh.
4. **Drive.** :func:`run` steps a function over state whose DNDarrays are
   re-targeted onto each new mesh; :func:`fit` steps a DASO or
   DataParallel trainer, rebound with ``rebind`` and restored from its
   mesh-size-independent state. ``report()["elastic"]`` counts what
   happened; ``elastic_*`` events land on the flight ring.

A device may hold several ranks of a mesh (the CPU mesh is the CPU
repeated, four shards of one card are ``cuda:0`` four times). The ledger
names a device by ``str(device)``, as the reference's; a degraded device
drops one rank, the last that it holds, so the mesh shrinks by one as the
reference's mesh of distinct devices does.
"""

from __future__ import annotations

import os
import signal as _signal_mod
import time
import warnings
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from . import communication, fusion, health_runtime, memledger, multihost, resilience, telemetry

__all__ = [
    "ElasticError",
    "Preempted",
    "Supervisor",
    "fit",
    "newest_verified_step",
    "probe_devices",
    "request_preempt",
    "reset",
    "run",
    "stats",
]

_OFF_VALUES = ("", "0", "false", "off", "no")


class Preempted(RuntimeError):
    """A preemption notice: why the mesh must shrink, and the devices known
    to be sick, if any. :meth:`Supervisor.maybe_preempt` returns it; the
    supervisor turns it into a reform, not a crash."""

    def __init__(self, reason: str, devices: Tuple = ()):
        super().__init__(reason)
        self.reason = reason
        self.devices = tuple(devices)


class ElasticError(RuntimeError):
    """The job cannot go on: reforms exhausted, fewer than ``min_devices``
    would survive, or no checkpoint verifies."""


# ----------------------------------------------------------------------
# report()["elastic"]
# ----------------------------------------------------------------------
_STATS: Dict[str, Any] = {
    "preemptions": 0,  # notices the supervisor consumed
    "reforms": 0,  # meshes re-formed
    "failed_reforms": 0,  # ElasticError exits
    "steps_replayed": 0,  # steps run again after restores
    "downtime_ms": 0.0,  # drain to restore, summed
    "drained_roots": 0,  # live fusion roots forced by drains
    "checkpoints": 0,  # commits through the supervisor
    "peer_losses": 0,  # lost peer processes handed to the launcher
    "last_reform": None,  # {"step", "mesh", "downtime_ms", "reason"} of the newest
}


def stats() -> Dict[str, Any]:
    """A copy of the supervisor's counters: ``report()["elastic"]``."""
    doc = dict(_STATS)
    if doc["last_reform"] is not None:
        doc["last_reform"] = dict(doc["last_reform"])
    return doc


def reset() -> None:
    """Zero the counters (part of ``telemetry.reset()``)."""
    _STATS.update(
        preemptions=0, reforms=0, failed_reforms=0, steps_replayed=0, downtime_ms=0.0, drained_roots=0,
        checkpoints=0, peer_losses=0, last_reform=None,
    )


# ----------------------------------------------------------------------
# detection
# ----------------------------------------------------------------------
#: the out-of-band notice a signal handler files; the next poll takes it
_PENDING: Optional[Preempted] = None


def request_preempt(reason: str, devices: Sequence = ()) -> None:
    """File a preemption notice for the next poll. Safe from a signal
    handler or another thread: one attribute store."""
    global _PENDING
    _PENDING = Preempted(reason, tuple(devices))


def _parse_signals() -> List[int]:
    """``HEAT_TPU_ELASTIC_SIGNALS``: comma-separated signal names, default
    ``SIGTERM``; ``off`` or empty hooks none, an unknown name warns and is
    skipped."""
    raw = os.environ.get("HEAT_TPU_ELASTIC_SIGNALS", "SIGTERM").strip()
    if raw.lower() in _OFF_VALUES:
        return []
    out: List[int] = []
    for name in raw.split(","):
        name = name.strip().upper()
        if not name:
            continue
        if not name.startswith("SIG"):
            name = "SIG" + name
        num = getattr(_signal_mod, name, None)
        if num is None:
            warnings.warn(f"HEAT_TPU_ELASTIC_SIGNALS: unknown signal {name!r}; skipped", stacklevel=2)
            continue
        out.append(int(num))
    return out


def _parse_drain_ms() -> float:
    """``HEAT_TPU_ELASTIC_DRAIN_MS``: the drain's watchdog deadline, default
    10 s; a malformed or non-positive value keeps the default (a malformed
    one warns)."""
    raw = os.environ.get("HEAT_TPU_ELASTIC_DRAIN_MS", "").strip()
    if not raw:
        return 10_000.0
    try:
        value = float(raw)
    except ValueError:
        warnings.warn(f"HEAT_TPU_ELASTIC_DRAIN_MS={raw!r} is not a number; using 10000", stacklevel=2)
        return 10_000.0
    return value if value > 0 else 10_000.0


def probe_devices(devices: Sequence) -> List:
    """The entries of ``devices`` that answer a one-element allocation and a
    sync of their device. A device that fails has a fault noted against it
    in :mod:`.resilience`'s ledger (three degrade it) and is left out: the
    reform probes its survivors so that a sick device does not enter the
    new mesh."""
    healthy = []
    for d in devices:
        try:
            t = torch.ones(1, device=d)
            if t.device.type == "cuda":
                torch.cuda.synchronize(t.device)
            healthy.append(d)
        # any failure means sick: it is attributed to the device's ledger,
        # not swallowed
        except Exception:  # noqa: BLE001
            resilience.note_device_fault(d, site="elastic.probe")
    return healthy


def newest_verified_step(directory: str) -> Optional[int]:
    """The newest checkpoint step in ``directory`` that verifies, or None: a
    preemption may have raced the last save, so the restore takes the
    newest step whose manifest and payload hashes check out."""
    from ..utils import checkpoint as ckpt

    for s in sorted(ckpt.all_steps(directory), reverse=True):
        if not ckpt.verify_checkpoint(directory, s):
            return int(s)
    return None


def _retarget(tree, comm) -> Any:
    """The restore template of ``tree`` on ``comm``: each DNDarray becomes
    zeros of its shape, dtype and split on ``comm`` (the restore fills the
    values), everything else stays for the checkpoint's shape checks. The
    walk is the checkpoint's own (``utils/checkpoint.py::_children``)."""
    from ..utils.checkpoint import _children
    from . import factories
    from .dndarray import DNDarray

    def remap(node):
        if isinstance(node, DNDarray):
            return factories.zeros(tuple(node.shape), dtype=node.dtype, split=node.split, comm=comm)
        if _children(node) is None:
            return node
        if isinstance(node, dict):
            out = OrderedDict() if isinstance(node, OrderedDict) else {}
            for key in node:
                out[key] = remap(node[key])
            return out
        return type(node)(remap(child) for child in node)

    return remap(tree)


def _drop_last_rank(devices: List, sick: Sequence) -> List:
    """``devices`` without the last rank held by each sick device (by
    ``str``): one rank per device, however many it holds."""
    survivors = list(devices)
    for key in dict.fromkeys(str(d) for d in sick):
        ranks = [r for r, d in enumerate(survivors) if str(d) == key]
        if ranks:
            del survivors[ranks[-1]]
    return survivors


# ----------------------------------------------------------------------
# the supervisor
# ----------------------------------------------------------------------
class Supervisor:
    """One job's preemption tolerance: it polls the triggers, drains and
    commits on a notice, re-forms the mesh on the survivors and restores.
    :func:`run` and :func:`fit` drive it; the class is the building block
    of other loops.

    Parameters
    ----------
    directory : str
        The checkpoint directory.
    checkpoint_every : int
        Commit cadence in steps, which bounds the steps replayed after a
        reform.
    max_reforms : int
        Reforms before the job is given up (:class:`ElasticError`).
    keep : int
        Checkpoints kept.
    drain_ms : float, optional
        The drain's watchdog deadline (default ``HEAT_TPU_ELASTIC_DRAIN_MS``,
        10 s).
    lose : int
        Ranks dropped from the tail per reform when no device is named
        sick; never below ``min_devices`` (a one-rank mesh re-forms in
        place).
    min_devices : int
        The floor under the surviving mesh.
    comm : MeshCommunication, optional
        The starting mesh (default the default mesh).
    install_signals : bool
        Hook ``HEAT_TPU_ELASTIC_SIGNALS`` until :meth:`close` (nothing off
        the main thread, where Python refuses signal handlers).
    """

    def __init__(
        self,
        directory: str,
        *,
        checkpoint_every: int = 5,
        max_reforms: int = 2,
        keep: int = 3,
        drain_ms: Optional[float] = None,
        lose: int = 1,
        min_devices: int = 1,
        comm=None,
        install_signals: bool = True,
    ):
        self.directory = str(directory)
        self.checkpoint_every = max(1, int(checkpoint_every))
        self.max_reforms = int(max_reforms)
        self.keep = int(keep)
        self.drain_ms = _parse_drain_ms() if drain_ms is None else float(drain_ms)
        self.lose = max(0, int(lose))
        self.min_devices = max(1, int(min_devices))
        self.comm = communication.sanitize_comm(comm)
        self.reforms = 0
        self._seen_degraded: set = set()
        self._seen_lost: set = set()
        self._prev_handlers: List[Tuple[int, Any]] = []
        if install_signals:
            self._install_signals()

    # -- detection ------------------------------------------------------
    def _install_signals(self) -> None:
        for num in _parse_signals():
            try:
                prev = _signal_mod.signal(
                    num, lambda signum, frame: request_preempt(f"signal {_signal_mod.Signals(signum).name}")
                )
            except ValueError:  # not the main thread: the signals are not ours
                return
            self._prev_handlers.append((num, prev))

    def close(self) -> None:
        """Restore the hooked signals' previous handlers (idempotent)."""
        while self._prev_handlers:
            num, prev = self._prev_handlers.pop()
            try:
                _signal_mod.signal(num, prev)
            except (ValueError, TypeError):  # pragma: no cover - teardown race
                pass

    def maybe_preempt(self) -> Optional[Preempted]:
        """One poll between steps: the ``elastic.preempt`` fault site, lost
        peer processes, devices newly degraded in the ledger, then a filed
        notice. Returns the notice to act on, or None; never raises."""
        global _PENDING
        if resilience._ARMED:
            try:
                resilience.check("elastic.preempt")
            except Exception as exc:  # noqa: BLE001 - the fault is the notice
                return Preempted(f"injected: {exc}")
        lost = multihost.lost_peers() - self._seen_lost
        if lost:
            self._seen_lost |= lost
            pre = Preempted(f"peer process(es) {sorted(lost)} lost mid-run")
            pre.peers = tuple(sorted(lost))
            return pre
        degraded = resilience.degraded_devices() - self._seen_degraded
        if degraded:
            self._seen_degraded |= degraded
            current = {str(d): d for d in self.comm.devices}
            sick = [current[k] for k in sorted(degraded) if k in current]
            if sick:
                return Preempted(f"{len(sick)} device(s) crossed the fault threshold", devices=sick)
        if _PENDING is not None:
            pre, _PENDING = _PENDING, None
            return pre
        return None

    # -- drain and commit -----------------------------------------------
    def drain(self) -> int:
        """Force every live fusion root onto the device under the drain's
        deadline, so nothing is in flight when the mesh goes. Gate-exempt:
        the drain's forces pass the admission hold, they are the draining."""
        with memledger.gate_exempt():
            with health_runtime.watch("elastic:drain", deadline_ms=self.drain_ms):
                drained = fusion._drain_pending_roots(())
        _STATS["drained_roots"] += drained
        return drained

    def commit(self, tree, step: int) -> None:
        """Checkpoint ``tree`` as step ``step`` through the manifest commit."""
        from ..utils.checkpoint import save_checkpoint

        with memledger.gate_exempt():
            save_checkpoint(self.directory, tree, step=int(step), keep=self.keep)
        _STATS["checkpoints"] += 1

    # -- re-form --------------------------------------------------------
    def reform(self, sick: Sequence = ()) -> "communication.MeshCommunication":
        """Install the mesh of the survivors as the default: the current
        ranks without the last rank of each sick device, or without
        ``lose`` tail ranks when none is named, probed. Clears the
        watchdog's guards and the device ledger: the new mesh starts
        healthy."""
        if self.reforms >= self.max_reforms:
            raise ElasticError(
                f"preempted again after {self.reforms} reform(s) (max_reforms={self.max_reforms}): "
                "giving the job up"
            )
        devices = list(self.comm.devices)
        survivors = _drop_last_rank(devices, sick)
        if len(survivors) == len(devices):
            # none named: drop the tail, never below min_devices
            lose_n = max(0, min(self.lose, len(devices) - self.min_devices))
            if lose_n:
                survivors = devices[: len(devices) - lose_n]
        survivors = probe_devices(survivors)
        if len(survivors) < self.min_devices:
            raise ElasticError(
                f"only {len(survivors)} healthy device(s) would survive the reform "
                f"(min_devices={self.min_devices}): giving the job up"
            )
        new_comm = communication.reform(survivors)
        health_runtime.reset_guards()
        resilience.reset_device_faults()
        self._seen_degraded.clear()
        self.comm = new_comm
        self.reforms += 1
        _STATS["reforms"] += 1
        return new_comm

    # -- the loop -------------------------------------------------------
    def handle(
        self,
        pre: Preempted,
        *,
        step: int,
        get_state: Optional[Callable[[], Any]] = None,
        template_fn: Optional[Callable[[Any], Any]] = None,
    ) -> Tuple[Any, int]:
        """One preemption: drain, commit if ``get_state`` is given (a failed
        commit warns; the restore takes the newest step that verifies),
        re-form, restore. Returns ``(state, step)`` to resume from;
        ``template_fn(new_comm)`` builds the restore's template on the new
        mesh (a trainer rebinds there), and without it the state is None.

        A notice of lost peer processes drains, commits if it can and
        raises :class:`~.multihost.PeerLostError`: the launcher re-forms a
        world of processes."""
        t0 = time.perf_counter()
        _STATS["preemptions"] += 1
        if telemetry._MODE:
            telemetry.record_event("elastic_preempt", reason=pre.reason, step=step, mesh=self.comm.size)
        health_runtime.auto_dump("elastic_preempt")
        peers = tuple(getattr(pre, "peers", ()))
        if peers:
            _STATS["peer_losses"] += 1
            with memledger.admission_hold(f"peer lost at step {step}: {pre.reason}"):
                self.drain()
                if get_state is not None:
                    try:
                        self.commit(get_state(), step)
                    except Exception as exc:  # noqa: BLE001 - best effort only
                        warnings.warn(
                            f"post-loss checkpoint at step {step} failed ({exc!r}); the reformed world "
                            "restores from the newest verified step",
                            stacklevel=2,
                        )
            if telemetry._MODE:
                telemetry.record_event("elastic_peer_lost", peers=list(peers), step=step, mesh=self.comm.size)
            health_runtime.auto_dump("elastic_peer_lost")
            raise multihost.PeerLostError(
                f"peer process(es) {sorted(peers)} lost at step {step}: drained; exit for the launcher's "
                f"reform (exit code {multihost.REFORM_EXIT})",
                peers=peers,
            )
        try:
            with memledger.admission_hold(f"preempted at step {step}: {pre.reason}"):
                self.drain()
                if get_state is not None:
                    try:
                        self.commit(get_state(), step)
                    except Exception as exc:  # noqa: BLE001 - a racing save is safe
                        warnings.warn(
                            f"pre-reform checkpoint at step {step} failed ({exc!r}); restoring from the "
                            "newest verified step",
                            stacklevel=2,
                        )
                new_comm = self.reform(sick=pre.devices)
                restored_step = newest_verified_step(self.directory)
                if restored_step is None:
                    raise ElasticError(f"no checkpoint in {self.directory!r} verifies: nothing to resume from")
                restored = None
                if template_fn is not None:
                    from ..utils.checkpoint import load_checkpoint

                    template = template_fn(new_comm)
                    with memledger.gate_exempt():
                        restored = load_checkpoint(self.directory, template, step=restored_step)
        except ElasticError:
            _STATS["failed_reforms"] += 1
            if telemetry._MODE:
                telemetry.record_event("elastic_reform_failed", reason=pre.reason, step=step)
            health_runtime.auto_dump("elastic_reform_failed")
            raise
        downtime_ms = (time.perf_counter() - t0) * 1e3
        replayed = max(0, int(step) - int(restored_step))
        _STATS["steps_replayed"] += replayed
        _STATS["downtime_ms"] += downtime_ms
        _STATS["last_reform"] = {
            "step": int(restored_step), "mesh": self.comm.size, "downtime_ms": downtime_ms, "reason": pre.reason,
        }
        if telemetry._MODE:
            telemetry.record_event(
                "elastic_reformed", step=int(restored_step), mesh=self.comm.size, downtime_ms=downtime_ms,
                replayed=replayed,
            )
        health_runtime.auto_dump("elastic_reformed")
        return restored, int(restored_step)


# ----------------------------------------------------------------------
# drivers
# ----------------------------------------------------------------------
def run(
    step_fn: Callable[[Any, int], Any],
    state: Any,
    *,
    steps: int,
    directory: str,
    checkpoint_every: int = 5,
    max_reforms: int = 2,
    keep: int = 3,
    drain_ms: Optional[float] = None,
    lose: int = 1,
    min_devices: int = 1,
    template_fn: Optional[Callable[[Any], Any]] = None,
    on_reform: Optional[Callable[[Any, Any], Any]] = None,
    comm=None,
    install_signals: bool = True,
) -> Any:
    """``state = step_fn(state, step)`` for ``steps`` steps, committed every
    ``checkpoint_every`` steps; on a notice the full drain → commit →
    reform → restore → resume loop (at most ``checkpoint_every`` steps
    replayed). The DNDarrays of ``state`` are re-targeted onto each new
    mesh unless ``template_fn(new_comm)`` gives the template;
    ``on_reform(new_comm, state)`` may return a replacement state. Returns
    the final state."""
    sup = Supervisor(
        directory, checkpoint_every=checkpoint_every, max_reforms=max_reforms, keep=keep, drain_ms=drain_ms,
        lose=lose, min_devices=min_devices, comm=comm, install_signals=install_signals,
    )
    step = 0
    try:
        sup.commit(state, 0)
        while step < steps:
            pre = sup.maybe_preempt()
            if pre is None:
                state = step_fn(state, step)
                step += 1
                if step % sup.checkpoint_every == 0 and step < steps:
                    sup.commit(state, step)
                continue
            tf = template_fn if template_fn is not None else (lambda new_comm: _retarget(state, new_comm))
            state, step = sup.handle(pre, step=step, get_state=lambda: state, template_fn=tf)
            if on_reform is not None:
                replacement = on_reform(sup.comm, state)
                if replacement is not None:
                    state = replacement
        sup.commit(state, step)
        return state
    finally:
        sup.close()


def fit(
    trainer,
    batches: Sequence,
    *,
    directory: str,
    steps: Optional[int] = None,
    checkpoint_every: int = 5,
    max_reforms: int = 2,
    keep: int = 3,
    drain_ms: Optional[float] = None,
    lose: int = 1,
    min_devices: int = 1,
    install_signals: bool = True,
) -> Dict[str, Any]:
    """Preemption-tolerant training: one ``trainer.step(x, y)`` (DASO,
    ``DataParallelMultiGPU``) or ``trainer.train_step(x, y)``
    (``DataParallel``) per ``(x, y)`` batch, committed every
    ``checkpoint_every`` steps. On a notice the trainer is rebound onto the
    new mesh (``rebind``) and restored from its mesh-size-independent state
    (``elastic_state_dict`` where it has one), at most ``checkpoint_every``
    batches replayed. Returns ``{"losses", "steps", "elastic"}``, the losses
    cut back to the restore point before each replay, so that they are an
    uninterrupted run's, one per step."""
    core = getattr(trainer, "daso", None) or trainer
    get_state = getattr(core, "elastic_state_dict", None) or core.state_dict
    load_state = getattr(core, "load_elastic_state_dict", None) or core.load_state_dict
    step_call = getattr(trainer, "step", None) or trainer.train_step
    batches = list(batches)
    total = len(batches) if steps is None else min(int(steps), len(batches))
    sup = Supervisor(
        directory, checkpoint_every=checkpoint_every, max_reforms=max_reforms, keep=keep, drain_ms=drain_ms,
        lose=lose, min_devices=min_devices, comm=getattr(core, "comm", None), install_signals=install_signals,
    )
    losses: List[float] = []
    step = 0
    try:
        sup.commit(get_state(), 0)
        while step < total:
            pre = sup.maybe_preempt()
            if pre is None:
                x, y = batches[step]
                losses.append(float(step_call(x, y)))
                step += 1
                if step % sup.checkpoint_every == 0 and step < total:
                    sup.commit(get_state(), step)
                continue

            def template_fn(new_comm):
                # rebind first, then the trainer's own state on the new mesh
                # shapes the template
                trainer.rebind(new_comm)
                return get_state()

            restored, step = sup.handle(pre, step=step, get_state=get_state, template_fn=template_fn)
            load_state(restored)
            del losses[step:]
        sup.commit(get_state(), step)
        return {"losses": losses, "steps": step, "elastic": stats()}
    finally:
        sup.close()


# report()["elastic"]: telemetry's slot, filled at import
telemetry._ELASTIC_HOOK = stats
