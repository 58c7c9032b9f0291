"""SLO-driven autoscaling: the control loop over serving, elastic and the
ops plane (``ht.autoscale``; reference heat_tpu/core/autoscale.py).

Serving's admission buckets, the ops plane's burn-rate alerts and the
health layer's SLO windows measure overload; this controller acts on them.
A daemon poll, woken early by :func:`.opsplane.on_burn`, observes those
gauges and drives three actuators:

1. **Tiered shedding.** Under overload the dispatches of ``batch`` sessions
   are refused with :class:`~.serving.ShedError` while interactive ones
   keep their tokens. A refused chain stays pending, is never degraded or
   dispatched twice, and dispatches once shedding lifts.
2. **Deadline order.** Serving's ``fusion._ROOT_PRIORITY`` orders the batch
   window by tier and deadline, so an interactive root is not queued
   behind a batch tenant's.
3. **Shrink and recover.** A burn that persists shrinks the mesh through
   the elastic seams (drain under an admission hold, probe,
   :func:`.communication.reform`, guards and device ledger cleared); once
   it has stayed clear through a cooldown the mesh is re-formed to the
   mesh the controller first shrank, its baseline. On the CPU that
   baseline is the default mesh, as the reference's "every live device";
   on a card it is the mesh the tenants ran on (four shards of
   ``cuda:0``, say), which "every live device", one ``cuda:0``, is not.

Hysteresis (a burn must persist before the mesh moves, and stay clear
through the cooldown before it recovers), a ``max_actions`` budget and a
``min_devices`` floor keep the mesh from flapping. A failing actuator
(:class:`~.elastic.ElasticError`) is counted, dumped and warned; the loop
goes on and the mesh stays. Every decision is a telemetry event and feeds
the ``heat_tpu_autoscale_*`` families through ``telemetry._AUTOSCALE_HOOK``;
``/readyz`` reads unready while shedding.

::

    ht.autoscale.arm()                       # defaults, daemon poll
    ht.autoscale.arm(cooldown_s=5.0, max_actions=2)
    ht.autoscale.disarm()                    # stop, lift shedding, recover

``HEAT_TPU_AUTOSCALE=1`` arms at import with the ``HEAT_TPU_AUTOSCALE_*``
knobs below; a malformed value warns and keeps its default.
"""

from __future__ import annotations

import os
import threading
import time
import warnings
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from . import communication, health_runtime, memledger, resilience, telemetry
from .communication import CrossProcessMeshError
from .elastic import ElasticError, probe_devices

__all__ = [
    "Controller",
    "arm",
    "disarm",
    "poll",
    "armed",
    "stats",
    "status",
    "reset",
]


# ----------------------------------------------------------------------
# knobs: a malformed value warns and keeps the default
# ----------------------------------------------------------------------
def _env_float(name: str, default: float, minimum: float = 0.0) -> float:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        value = float(raw)
    except ValueError:
        warnings.warn(f"{name}={raw!r} is not a number; using {default}", stacklevel=2)
        return default
    if value < minimum:
        warnings.warn(f"{name}={raw!r} is below the floor {minimum}; using {default}", stacklevel=2)
        return default
    return value


def _env_int(name: str, default: int, minimum: int = 0) -> int:
    return int(_env_float(name, float(default), float(minimum)))


def _env_tiers(name: str, default: Tuple[str, ...]) -> Tuple[str, ...]:
    from . import serving

    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    tiers = []
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        resolved = serving._TIER_ALIASES.get(part, part)
        if resolved not in serving._TIERS:
            warnings.warn(f"{name}={raw!r}: unknown tier {part!r}; using {default}", stacklevel=2)
            return default
        tiers.append(resolved)
    return tuple(tiers) or default


def _defaults() -> Dict[str, Any]:
    return {
        "interval_s": _env_float("HEAT_TPU_AUTOSCALE_INTERVAL_S", 1.0, 0.01),
        "cooldown_s": _env_float("HEAT_TPU_AUTOSCALE_COOLDOWN_S", 30.0),
        "shrink_after_s": _env_float("HEAT_TPU_AUTOSCALE_SHRINK_AFTER_S", 10.0),
        "max_actions": _env_int("HEAT_TPU_AUTOSCALE_MAX_ACTIONS", 4),
        "min_devices": _env_int("HEAT_TPU_AUTOSCALE_MIN_DEVICES", 1, 1),
        "shrink_n": _env_int("HEAT_TPU_AUTOSCALE_SHRINK", 1),
        "shed_tiers": _env_tiers("HEAT_TPU_AUTOSCALE_SHED_TIERS", ("batch",)),
    }


def _mesh_size() -> int:
    """Ranks of the default mesh if it exists; 0 before (never builds one)."""
    comm = communication._built_comm()
    return 0 if comm is None else comm.size


# ----------------------------------------------------------------------
# the controller
# ----------------------------------------------------------------------
class Controller:
    """One process's overload supervisor: observe, decide, act.

    States: ``ok`` → (a burn's rising edge) → ``shedding`` → (the burn
    persists ``shrink_after_s``) → ``shrunk`` → (clear for ``cooldown_s``)
    → ``ok``, shedding lifted and the mesh re-formed to its baseline. A
    burn that comes back during the cooldown restarts it.

    Parameters
    ----------
    interval_s : float
        The daemon's poll cadence; burn edges wake it early.
    cooldown_s : float
        How long the burn must stay clear before shedding lifts and the
        mesh recovers.
    shrink_after_s : float
        How long shedding alone must fail to clear the burn before the
        mesh shrinks.
    max_actions : int
        Budget of mesh moves (shrinks and recoveries). Spent, the
        controller keeps shedding and the mesh holds; one ``bound``
        decision is recorded per saturation.
    min_devices : int
        Floor under the shrunk mesh; a shrink that would cross it is
        refused.
    shrink_n : int
        Tail ranks dropped per shrink.
    shed_tiers : sequence of str
        Tiers shed under overload (default ``("batch",)``).
    """

    def __init__(
        self,
        interval_s: float = 1.0,
        cooldown_s: float = 30.0,
        shrink_after_s: float = 10.0,
        max_actions: int = 4,
        min_devices: int = 1,
        shrink_n: int = 1,
        shed_tiers: Sequence[str] = ("batch",),
    ) -> None:
        from . import elastic, serving

        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        if min_devices < 1:
            raise ValueError(f"min_devices must be >= 1, got {min_devices}")
        self.interval_s = float(interval_s)
        self.cooldown_s = max(0.0, float(cooldown_s))
        self.shrink_after_s = max(0.0, float(shrink_after_s))
        self.max_actions = max(0, int(max_actions))
        self.min_devices = int(min_devices)
        self.shrink_n = max(0, int(shrink_n))
        self.drain_ms = elastic._parse_drain_ms()
        resolved = []
        for t in shed_tiers:
            t = serving._TIER_ALIASES.get(t, t)
            if t not in serving._TIERS:
                raise ValueError(
                    f"unknown tier {t!r}: tiers are {serving._TIERS} (alias {tuple(serving._TIER_ALIASES)})"
                )
            resolved.append(t)
        self.shed_tiers: Tuple[str, ...] = tuple(resolved)

        self._lock = threading.RLock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._unsubscribe: Optional[Callable[[], None]] = None

        self.state = "ok"
        self._burn_since: Optional[float] = None  # monotonic, rising edge
        self._clear_since: Optional[float] = None  # monotonic, falling edge
        #: the devices of the mesh before the first shrink, one per rank:
        #: what a recovery re-forms
        self._baseline: Optional[List] = None
        self._shrunk = False
        self._bound_noted = False
        self.mesh_actions = 0
        self.ticks = 0
        self.burn_edges = 0
        self.decisions: Dict[str, int] = {
            "shed_on": 0, "shed_off": 0, "shrink": 0, "recover": 0, "bound": 0, "errors": 0,
        }
        self.last_decision: Optional[Dict[str, Any]] = None

    @property
    def baseline(self) -> Optional[int]:
        """Ranks of the mesh before the first shrink, or None."""
        return None if self._baseline is None else len(self._baseline)

    # -- lifecycle ------------------------------------------------------
    def start(self) -> None:
        """Arm: subscribe to burn edges and start the daemon poll."""
        from . import opsplane

        with self._lock:
            if self._thread is not None:
                return
            self._stop.clear()
            self._unsubscribe = opsplane.on_burn(self._on_burn)
            self._thread = threading.Thread(target=self._run, name="heat-tpu-autoscale", daemon=True)
            self._thread.start()

    def stop(self, restore: bool = True) -> None:
        """Disarm: stop the poll, unsubscribe, lift shedding and, with
        ``restore``, re-form a shrunk mesh to its baseline. A failing
        recovery is counted and warned, never raised."""
        with self._lock:
            thread, self._thread = self._thread, None
            unsub, self._unsubscribe = self._unsubscribe, None
        self._stop.set()
        self._wake.set()
        if unsub is not None:
            unsub()
        if thread is not None and thread is not threading.current_thread():
            thread.join(timeout=max(5.0, 2 * self.interval_s))
        with self._lock:
            obs = {"reason": "disarm"}
            if self.state != "ok":
                self._act_shed_off(obs)
            if restore and self._shrunk:
                try:
                    self._act_recover(obs)
                except ElasticError as exc:
                    self._note_error("recover", exc, obs)
            self.state = "ok"
            self._burn_since = None
            self._clear_since = None

    def _run(self) -> None:
        while not self._stop.is_set():
            self._wake.wait(self.interval_s)
            self._wake.clear()
            if self._stop.is_set():
                return
            try:
                self.tick()
            # the loop is the protection: it survives whatever an actuator
            # or an observer throws
            except Exception as exc:  # noqa: BLE001
                self.decisions["errors"] += 1
                warnings.warn(f"autoscale tick failed: {exc!r}", stacklevel=2)

    def _on_burn(self, metric: str, tenant: str, rising: bool, snapshot) -> None:
        """:func:`.opsplane.on_burn`'s subscriber: wakes the loop, so that a
        decision (which may drain and re-form) runs on the loop's thread."""
        self.burn_edges += 1
        self._wake.set()

    # -- observe --------------------------------------------------------
    def _observe(self) -> Dict[str, Any]:
        """The gauges the controller reads: active burn alerts, SLO breach
        fractions and the global admission bucket's tokens; each read fails
        on its own."""
        from . import opsplane, serving

        obs: Dict[str, Any] = {"burn": [], "breach": {}, "tokens": None}
        try:
            alerts = opsplane.burn_report()["alerts"]
            obs["burn"] = sorted(key for key, row in alerts.items() if row.get("active"))
        except Exception:  # noqa: BLE001 - a broken gauge never stops the loop
            pass
        for metric in ("dispatch", "sync", "compile"):
            try:
                frac = health_runtime.breach_fraction(metric)
            except Exception:  # noqa: BLE001
                frac = None
            if frac is not None:
                obs["breach"][metric] = round(frac, 4)
        try:
            with serving._LOCK:
                bucket = serving._GLOBAL_BUCKET
            if bucket is not None:
                from .opsplane import _bucket_tokens

                obs["tokens"] = round(_bucket_tokens(bucket), 3)
        except Exception:  # noqa: BLE001
            pass
        return obs

    # -- decide ---------------------------------------------------------
    def tick(self, now: Optional[float] = None) -> Optional[str]:
        """One observe → decide → act pass; returns the action taken or
        None. Thread-safe; :func:`poll` runs it on the caller's thread."""
        now = time.monotonic() if now is None else now
        with self._lock:
            self.ticks += 1
            obs = self._observe()
            if obs["burn"]:
                self._clear_since = None
                if self._burn_since is None:
                    self._burn_since = now
                if self.state == "ok":
                    self._act_shed_on(obs)
                    self.state = "shedding"
                    return "shed_on"
                if self.state == "shedding" and now - self._burn_since >= self.shrink_after_s:
                    return self._try_shrink(obs)
                return None
            # clear: the hysteresis on the way down
            self._burn_since = None
            if self.state == "ok":
                return None
            if self._clear_since is None:
                self._clear_since = now
            if now - self._clear_since < self.cooldown_s:
                return None
            action = None
            if self._shrunk:
                try:
                    self._act_recover(obs)
                    action = "recover"
                except ElasticError as exc:
                    self._note_error("recover", exc, obs)
                    return None  # keep shedding; try again after the next cooldown tick
            self._act_shed_off(obs)
            self.state = "ok"
            self._clear_since = None
            return action or "shed_off"

    def _try_shrink(self, obs: Dict[str, Any]) -> Optional[str]:
        comm = communication._built_comm()
        if comm is None:
            # the controller never builds a mesh itself
            return None
        lose = max(0, min(self.shrink_n, comm.size - self.min_devices))
        if lose == 0:
            return None  # at the floor already
        if self.mesh_actions >= self.max_actions:
            if not self._bound_noted:
                self._bound_noted = True
                self._decide("bound", obs, mesh_actions=self.mesh_actions, max_actions=self.max_actions)
            return None
        try:
            self._act_shrink(obs, list(comm.devices), lose)
        except (ElasticError, CrossProcessMeshError) as exc:
            self._note_error("shrink", exc, obs)
            return None
        self.state = "shrunk"
        return "shrink"

    # -- act ------------------------------------------------------------
    def _act_shed_on(self, obs: Dict[str, Any]) -> None:
        from . import serving

        serving.shed(self.shed_tiers)
        self._decide("shed_on", obs, tiers=list(self.shed_tiers))

    def _act_shed_off(self, obs: Dict[str, Any]) -> None:
        from . import serving

        serving.shed(())
        self._decide("shed_off", obs)

    def _reform(self, devices: Optional[List], reason: str, probe: bool) -> None:
        """The elastic ritual under an admission hold: drain every pending
        root (gate-exempt, under the watchdog), probe the survivors when
        ``probe``, re-form on ``devices`` (None: the default mesh), clear
        the guards and the device ledger."""
        from . import fusion

        with memledger.admission_hold(reason):
            with memledger.gate_exempt():
                with health_runtime.watch("autoscale:drain", deadline_ms=self.drain_ms):
                    fusion._drain_pending_roots(())
            if probe:
                devices = probe_devices(devices)
                if len(devices) < self.min_devices:
                    raise ElasticError(
                        f"only {len(devices)} healthy device(s) would survive the shrink "
                        f"(min_devices={self.min_devices})"
                    )
            communication.reform(devices)
            health_runtime.reset_guards()
            resilience.reset_device_faults()

    def _act_shrink(self, obs: Dict[str, Any], devices: List, lose: int) -> None:
        if self._baseline is None:
            self._baseline = list(devices)
        self._reform(
            devices[: len(devices) - lose], f"autoscale shrink: sustained SLO burn ({obs['burn']})", probe=True
        )
        self._shrunk = True
        self.mesh_actions += 1
        self._decide("shrink", obs, lose=lose, devices=len(devices) - lose, baseline=self.baseline)
        health_runtime.auto_dump("autoscale_shrink")

    def _act_recover(self, obs: Dict[str, Any]) -> None:
        # the baseline's devices: the reference's "every live device" where
        # the baseline is the default mesh, the mesh first shrunk elsewhere
        self._reform(self._baseline, "autoscale recover: burn clear through cooldown", probe=False)
        self._shrunk = False
        self._bound_noted = False
        self.mesh_actions += 1
        self._decide("recover", obs, devices=_mesh_size(), baseline=self.baseline)
        health_runtime.auto_dump("autoscale_recover")

    # -- bookkeeping ----------------------------------------------------
    def _decide(self, action: str, obs: Dict[str, Any], **fields) -> None:
        self.decisions[action] = self.decisions.get(action, 0) + 1
        rec = {"action": action, "ts": time.time(), "obs": dict(obs)}
        rec.update(fields)
        self.last_decision = rec
        telemetry.record_event("autoscale_" + action, **{k: v for k, v in rec.items() if k != "ts"})

    def _note_error(self, action: str, exc: Exception, obs: Dict[str, Any]) -> None:
        """A failing actuator: counted, an event, a dump and a warning,
        never raised out of the loop."""
        self.decisions["errors"] += 1
        telemetry.record_event("autoscale_error", action=action, error=str(exc), obs=dict(obs))
        health_runtime.auto_dump("autoscale_" + action + "_failed")
        warnings.warn(f"autoscale {action} failed: {exc}", stacklevel=3)

    def snapshot(self) -> Dict[str, Any]:
        from . import serving

        with self._lock:
            return {
                "armed": self._thread is not None,
                "state": self.state,
                "shedding": self.state != "ok",
                "shed_tiers": sorted(serving._SHED_TIERS),
                "decisions": dict(self.decisions),
                "mesh_actions": self.mesh_actions,
                "max_actions": self.max_actions,
                "min_devices": self.min_devices,
                "mesh": {"devices": _mesh_size(), "baseline": self.baseline},
                "shed_refusals": serving._SHED_STATS["refusals"],
                "ticks": self.ticks,
                "burn_edges": self.burn_edges,
                "last_decision": self.last_decision,
            }


# ----------------------------------------------------------------------
# the module's controller
# ----------------------------------------------------------------------
_CONTROLLER: Optional[Controller] = None
_LOCK = threading.Lock()


def arm(**overrides) -> Controller:
    """Arm the process's controller (arming again stops and replaces the
    previous one). A :class:`Controller` keyword overrides its
    ``HEAT_TPU_AUTOSCALE_*`` default. Returns the armed controller."""
    global _CONTROLLER
    cfg = _defaults()
    cfg.update(overrides)
    ctl = Controller(**cfg)
    with _LOCK:
        prev, _CONTROLLER = _CONTROLLER, ctl
    if prev is not None:
        prev.stop()
    ctl.start()
    return ctl


def disarm(restore: bool = True) -> None:
    """Stop the controller: lift shedding, re-form a shrunk mesh to its
    baseline (unless ``restore=False``), unsubscribe."""
    global _CONTROLLER
    with _LOCK:
        ctl, _CONTROLLER = _CONTROLLER, None
    if ctl is not None:
        ctl.stop(restore=restore)


def armed() -> bool:
    """True while a controller is armed."""
    ctl = _CONTROLLER
    return ctl is not None and ctl._thread is not None


def poll() -> Optional[str]:
    """One controller tick on the calling thread; the action taken, or None
    (also when nothing is armed)."""
    ctl = _CONTROLLER
    return None if ctl is None else ctl.tick()


def stats() -> Dict[str, Any]:
    """The controller's snapshot, behind ``telemetry._AUTOSCALE_HOOK``:
    ``report()["autoscale"]`` and the ``heat_tpu_autoscale_*`` families
    read it. Never builds a mesh."""
    ctl = _CONTROLLER
    if ctl is not None:
        return ctl.snapshot()
    from . import serving

    return {
        "armed": False,
        "state": "disarmed",
        "shedding": bool(serving._SHED_TIERS),
        "shed_tiers": sorted(serving._SHED_TIERS),
        "decisions": {},
        "mesh_actions": 0,
        "max_actions": 0,
        "min_devices": 1,
        "mesh": {"devices": _mesh_size(), "baseline": None},
        "shed_refusals": serving._SHED_STATS["refusals"],
        "ticks": 0,
        "burn_edges": 0,
        "last_decision": None,
    }


def status() -> Dict[str, Any]:
    """:func:`stats` and the armed controller's configuration."""
    doc = stats()
    ctl = _CONTROLLER
    if ctl is not None:
        doc["config"] = {
            "interval_s": ctl.interval_s,
            "cooldown_s": ctl.cooldown_s,
            "shrink_after_s": ctl.shrink_after_s,
            "max_actions": ctl.max_actions,
            "min_devices": ctl.min_devices,
            "shrink_n": ctl.shrink_n,
            "shed_tiers": list(ctl.shed_tiers),
        }
    return doc


def reset() -> None:
    """Disarm and forget the controller (part of ``telemetry.reset()``).
    The mesh is not re-formed: :func:`disarm` recovers a shrunk one."""
    global _CONTROLLER
    with _LOCK:
        ctl, _CONTROLLER = _CONTROLLER, None
    if ctl is not None:
        ctl.stop(restore=False)


# report()["autoscale"] and the ops plane's collector: telemetry's slot
telemetry._AUTOSCALE_HOOK = stats


# HEAT_TPU_AUTOSCALE: arm with the process; a failure warns and leaves the
# controller disarmed
_raw = os.environ.get("HEAT_TPU_AUTOSCALE", "").strip().lower()
if _raw not in ("", "0", "false", "off", "no"):
    try:
        arm()
    except Exception as _exc:  # noqa: BLE001 - arming from the environment is best effort
        warnings.warn(f"HEAT_TPU_AUTOSCALE={_raw!r}: arming failed ({_exc}); the autoscaler stays disarmed",
                      stacklevel=2)
del _raw
