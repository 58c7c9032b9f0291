"""The multi-tenant serving layer: sessions, the persistent program cache
and admission control (reference: heat_tpu/core/serving.py).

Many short client computations share one warm card. The pieces a service
needs exist in the other layers (scoped telemetry, the memory gate and its
hold, the recorder's per-program ledger); this module composes them.

**Sessions** (:class:`Session`): one per client, entered as a context
manager on the client's thread. A session gets its own telemetry scope
(counters, spans, latency histograms through ``health_runtime``'s tenant
seam), its own numeric error policy (``resilience``'s per-thread errstate),
its own sampling frame of the numerics lens, and its own quarantine view
(degraded programs and quarantine hits are billed to the tripping tenant,
never a neighbour). Nothing bleeds between concurrent client threads.

**The persistent program cache.** ``HEAT_TPU_PROGRAM_CACHE_DIR`` (or
:func:`arm_cache`) points Inductor's on-disk caches at ``<dir>/inductor``
(its FX graph cache) and ``<dir>/triton`` (the Triton kernels), where the
reference points jax's compilation cache, and keeps an append-only index of
the recorder's program keys in ``<dir>/programs.jsonl``. A fresh process
that forces a signature the index knows records a ``disk_hit`` instead of a
``compile``: on a card Inductor then loads the compiled code from its FX
graph cache, after Dynamo's trace, which a warm start still pays.
:func:`warmup` builds representative chains ahead of traffic. Inductor
reads its directory at each cache lookup, but its compile workers keep the
one they started with: arm the cache before the first build of the process
(the environment knob does, at import). A directory that cannot be written
warns and disarms; corrupt index lines are skipped with one warning.

**Admission control**: token buckets on fused dispatches
(``HEAT_TPU_ADMISSION_RATE`` tokens/s, ``HEAT_TPU_ADMISSION_BURST`` deep),
one global and optionally one per session, checked in ``fusion.force()``
before the force lock (a tenant waiting for tokens blocks only itself) and
before the memory gate. A refused chain stays pending, never degraded,
never dispatched twice: under ``wait`` (the default) the force sleeps until
the bucket refills, under ``raise`` (``HEAT_TPU_ADMISSION_POLICY=raise``)
an :class:`AdmissionError` names the session and the bucket.

**Cross-session batching** is the recorder's own: its live-root registry is
global, so small pending roots of several sessions ride one program. Each
root carries its session's name, the ``dispatch`` event lists the
``sessions``, and each tenant is billed its own roots. While two or more
sessions are active, a top-level force sleeps a short batch window first.
On a card only a chain whose operands hold 192 MiB or more records at all
(``fusion._EAGER_BELOW_BYTES``), and only roots of at most
``fusion._BATCH_BYTES`` batch.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
import warnings
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional

from . import fusion, health_runtime, numlens, resilience, telemetry

__all__ = [
    "AdmissionError",
    "ShedError",
    "Session",
    "arm_cache",
    "cache_stats",
    "disarm_cache",
    "sessions_block",
    "session_reports",
    "set_admission",
    "shed",
    "shed_state",
    "warmup",
    "reset",
]


class AdmissionError(RuntimeError):
    """A fused dispatch exceeded the admission token bucket under the
    ``raise`` policy. The message names the session and the bucket
    (``global`` or ``session:<name>``) that refused; the chain it refused
    is untouched — still pending, dispatchable once tokens refill."""


class ShedError(AdmissionError):
    """A fused dispatch from a shed tier was refused by overload
    protection (:func:`shed`, an overload controller's switch). Same
    containment contract as every admission refusal: the chain is still
    pending, never degraded, never double-dispatched — it dispatches
    cleanly (or rides a neighbour's batch) once shedding lifts."""


# ----------------------------------------------------------------------
# token buckets
# ----------------------------------------------------------------------
class _TokenBucket:
    """Classic token bucket: ``rate`` tokens/second refill up to ``burst``
    capacity; one fused dispatch costs one token. ``take`` never sleeps —
    it returns the seconds until a token WILL be available so the caller
    owns the wait/raise decision (and the bookkeeping)."""

    __slots__ = ("name", "rate", "burst", "tokens", "ts",
                 "admitted", "refused", "waited_s", "_lock")

    def __init__(self, rate: float, burst: float, name: str):
        self.name = name
        self.rate = float(rate)
        self.burst = max(1.0, float(burst))
        self.tokens = self.burst  # starts full: the first burst is free
        self.ts = time.monotonic()
        self.admitted = 0
        self.refused = 0
        self.waited_s = 0.0
        self._lock = threading.Lock()

    def take(self) -> float:
        """Take one token if available (returns 0.0), else the seconds
        until the bucket refills enough."""
        with self._lock:
            now = time.monotonic()
            self.tokens = min(self.burst, self.tokens + (now - self.ts) * self.rate)
            self.ts = now
            if self.tokens >= 1.0:
                self.tokens -= 1.0
                self.admitted += 1
                return 0.0
            return (1.0 - self.tokens) / self.rate if self.rate > 0 else 60.0

    def give_back(self) -> None:
        """Refund a taken token (a later bucket in the chain refused, or the
        admitted dispatch never ran)."""
        with self._lock:
            self.tokens = min(self.burst, self.tokens + 1.0)
            self.admitted -= 1

    def reconfigure(self, rate: float, burst: float) -> None:
        """Hot-update ``rate``/``burst`` mid-traffic without losing state:
        the ``admitted``/``refused``/``waited_s`` counters survive, and the
        accumulated tokens are first refilled at the OLD rate up to now,
        then clamped to the new burst — a shrink mid-burst takes effect
        immediately instead of granting the old depth one more time."""
        with self._lock:
            now = time.monotonic()
            self.tokens = min(self.burst, self.tokens + (now - self.ts) * self.rate)
            self.ts = now
            self.rate = float(rate)
            self.burst = max(1.0, float(burst))
            self.tokens = min(self.burst, self.tokens)

    def refuse(self) -> None:
        with self._lock:
            self.refused += 1

    def note_wait(self, seconds: float) -> None:
        with self._lock:
            self.waited_s += seconds

    def stats(self) -> Dict[str, Any]:
        return {
            "rate": self.rate,
            "burst": self.burst,
            "admitted": self.admitted,
            "refused": self.refused,
            "waited_s": round(self.waited_s, 6),
        }


# ----------------------------------------------------------------------
# env knobs (warn-and-disarm, the HEAT_TPU_MEMORY_BUDGET convention)
# ----------------------------------------------------------------------
_POLICIES = ("wait", "raise")


def _parse_env_rate(name: str) -> Optional[float]:
    raw = os.environ.get(name)
    if raw is None or not raw.strip():
        return None
    try:
        rate = float(raw)
        if rate <= 0:
            raise ValueError("rate must be > 0")
        return rate
    except (ValueError, TypeError):
        warnings.warn(
            f"{name}={raw!r} is not a positive tokens/second number; the "
            "admission gate stays disarmed",
            stacklevel=1,
        )
        return None


def _parse_env_burst(name: str, default: float) -> float:
    raw = os.environ.get(name)
    if raw is None or not raw.strip():
        return default
    try:
        burst = float(raw)
        if burst < 1:
            raise ValueError("burst must be >= 1")
        return burst
    except (ValueError, TypeError):
        warnings.warn(
            f"{name}={raw!r} is not a bucket depth >= 1; using {default}",
            stacklevel=1,
        )
        return default


def _parse_env_policy() -> str:
    raw = os.environ.get("HEAT_TPU_ADMISSION_POLICY", "wait").strip().lower() or "wait"
    if raw not in _POLICIES:  # a typo'd env knob must not take the process down
        warnings.warn(
            f"HEAT_TPU_ADMISSION_POLICY={raw!r} is not one of {_POLICIES}; "
            "using 'wait'",
            stacklevel=1,
        )
        return "wait"
    return raw


def _parse_env_cache_dir() -> Optional[str]:
    """``HEAT_TPU_PROGRAM_CACHE_DIR``, probed writable. An unwritable path
    or a file-where-a-dir-should-be warns and disarms instead of making
    ``import heat_tpu`` raise."""
    raw = os.environ.get("HEAT_TPU_PROGRAM_CACHE_DIR")
    if raw is None or not raw.strip():
        return None
    path = raw.strip()
    try:
        os.makedirs(path, exist_ok=True)
        probe = os.path.join(path, ".ht_probe")
        with open(probe, "w"):
            pass
        os.remove(probe)
    except OSError as exc:
        warnings.warn(
            f"HEAT_TPU_PROGRAM_CACHE_DIR={raw!r} is not a writable directory "
            f"({exc}); the persistent program cache stays disarmed",
            stacklevel=1,
        )
        return None
    return path


# ----------------------------------------------------------------------
# the persistent program-key index
# ----------------------------------------------------------------------
class _DiskIndex:
    """``programs.jsonl`` under the cache dir: one ``{"key", "family"}``
    line appended per first-built program. The index is what lets a fresh
    process tell "first build ever" from "seen before, the compiled code is
    in Inductor's FX graph cache": fusion counts the latter as
    ``disk_hits``, so the compile counter stays an honest retrace count
    across process restarts. Corrupt lines (partial writes, stray bytes)
    are skipped with ONE warning, never a crash."""

    def __init__(self, path: str):
        self.path = path
        self.keys: Dict[str, str] = {}  # key -> family
        self.loaded = 0
        self.skipped = 0
        self._warned = False
        self._lock = threading.Lock()

    def load(self) -> None:
        try:
            with open(self.path, "r") as fh:
                lines = fh.readlines()
        except FileNotFoundError:
            return
        except OSError as exc:
            self._warn_once(f"unreadable ({exc})")
            return
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
                key = rec["key"]
                if not isinstance(key, str) or not key:
                    raise ValueError("bad key")
            except (ValueError, KeyError, TypeError):
                self.skipped += 1
                self._warn_once(f"corrupt entry {line[:60]!r}")
                continue
            if key not in self.keys:
                self.keys[key] = str(rec.get("family", "?"))
                self.loaded += 1

    def _warn_once(self, what: str) -> None:
        if not self._warned:
            self._warned = True
            warnings.warn(
                f"persistent program index {self.path}: {what} — skipping "
                "(the cache keeps working; bad entries just recompile)",
                stacklevel=2,
            )

    def has(self, key: str) -> bool:
        return key in self.keys

    def note(self, key: str, family: str) -> None:
        """Record a program key (idempotent; append-only on disk)."""
        with self._lock:
            if key in self.keys:
                return
            self.keys[key] = family
            try:
                with open(self.path, "a") as fh:
                    fh.write(json.dumps({"key": key, "family": family}) + "\n")
            except OSError as exc:
                self._warn_once(f"append failed ({exc})")


# ----------------------------------------------------------------------
# module state
# ----------------------------------------------------------------------
# RLock: Session.__enter__/__exit__ install/uninstall the fusion hooks while
# holding it (so a last-exit teardown cannot race a concurrent first-enter
# and disarm a live session's gates), and the helpers they call take it too
_LOCK = threading.RLock()
_TLS = threading.local()  # per-thread stack of active Sessions
_SESSION_SEQ = itertools.count(1)
#: every session ever entered this telemetry session, active or exited,
#: keyed by name (the archive the CLI `sessions` verb renders)
_SESSIONS: "OrderedDict[str, Session]" = OrderedDict()
_ACTIVE = 0  # entered-and-not-exited count, across all threads

_CACHE_DIR: Optional[str] = None
_INDEX: Optional[_DiskIndex] = None
#: the variables Inductor and Triton read their cache directories from
_CACHE_ENV = ("TORCHINDUCTOR_CACHE_DIR", "TRITON_CACHE_DIR")
#: their values, and Inductor's FX-graph-cache switch, before the first
#: arm_cache (disarm_cache restores them); None while not wired
_PREV_ENV: Optional[Dict[str, Optional[str]]] = None
_PREV_FX_CACHE = None

_GLOBAL_BUCKET: Optional[_TokenBucket] = None
_POLICY = _parse_env_policy()

#: session tiers: ``interactive`` keeps its tokens under overload;
#: ``batch`` (alias ``preemptible``) is sheddable — an overload controller flips
#: the shed set and batch-tier dispatches raise :class:`ShedError`
_TIERS = ("interactive", "batch")
_TIER_ALIASES = {"preemptible": "batch"}
#: tiers currently shedding (overload protection active); flipped by
#: :func:`shed`
_SHED_TIERS: frozenset = frozenset()
#: total ShedErrors raised since reset
_SHED_STATS = {"refusals": 0}
_ENV_RATE = _parse_env_rate("HEAT_TPU_ADMISSION_RATE")
_ENV_BURST = _parse_env_burst(
    "HEAT_TPU_ADMISSION_BURST", _ENV_RATE if _ENV_RATE is not None else 1.0
)


def _session_stack() -> List["Session"]:
    stack = getattr(_TLS, "stack", None)
    if stack is None:
        stack = _TLS.stack = []
    return stack


def _current_session() -> Optional["Session"]:
    stack = getattr(_TLS, "stack", None)
    return stack[-1] if stack else None


def _current_session_name() -> Optional[str]:
    stack = getattr(_TLS, "stack", None)
    return stack[-1].name if stack else None


# ----------------------------------------------------------------------
# the fusion seams (set-attribute hooks, installed while sessions exist)
# ----------------------------------------------------------------------
def _bill(names, field: str, per_root: bool = False) -> None:
    """Charge ``field`` once per distinct session in ``names`` (or per root
    when ``per_root``), resolving names through the registry."""
    if not names:
        return
    seen: Dict[str, int] = {}
    for n in names:
        if n is not None:
            seen[n] = seen.get(n, 0) + 1
    with _LOCK:  # reset() deletes exited entries concurrently
        resolved = [(_SESSIONS.get(n), count) for n, count in seen.items()]
    for sess, count in resolved:
        if sess is not None:
            sess.stats[field] += count if per_root else 1


def _on_note(kind: str, **data) -> None:
    """fusion's ``_SERVING_NOTE`` seam: per-session billing + incident
    containment. Called under fusion's force lock; must never raise."""
    try:
        if kind == "dispatch":
            sessions = data.get("sessions")
            _bill(sessions, "dispatches")
            _bill(sessions, "roots", per_root=True)
            trigger = data.get("trigger")
            if data.get("compiled") and trigger is not None:
                with _LOCK:
                    sess = _SESSIONS.get(trigger)
                if sess is not None:
                    sess.stats["compiles"] += 1
            return
        if kind == "degraded":
            sess = _current_session()
            if sess is not None:
                sess.stats["degraded"] += 1
                sess._incident(kind, data)
            return
        if kind == "quarantine_hit":
            names = [n for n in (data.get("sessions") or ()) if n is not None]
            if not names and _current_session() is not None:
                names = [_current_session().name]
            for n in dict.fromkeys(names):
                with _LOCK:
                    sess = _SESSIONS.get(n)
                if sess is not None:
                    sess.stats["quarantine_hits"] += 1
                    sess._incident(kind, data)
            return
        if kind == "mem_refused":
            sess = _current_session()
            if sess is not None:
                sess.stats["mem_refused"] += 1
                sess._incident(kind, data)
    except Exception:  # pragma: no cover - billing never breaks a dispatch
        pass


def _admit(cid) -> Optional[Any]:
    """fusion's ``_ADMIT_HOOK`` seam: the token-bucket gate, composed
    before memledger's headroom gate. fusion calls it in ``force()``
    BEFORE acquiring ``_FORCE_LOCK`` — the ``wait`` policy sleeps until
    refill, and sleeping under the force lock would let one rate-limited
    tenant convoy every other session's dispatches for the full refill
    wait (containment demands the opposite: a tenant tripping its gate
    blocks only itself). The session's own bucket is consulted first
    (cheap containment), then the global one; a raise-refusal refunds the
    session token so the retry is not double-charged. Under ``wait`` the
    force blocks until refill — the chain stays pending the whole time,
    mirroring ``admission_hold``. Returns a refund closure fusion invokes
    when the admitted dispatch never runs (a neighbour's batch landed the
    value during the wait), or ``None`` when no bucket gated.

    Tier shedding composes BEFORE the buckets: a dispatch from a session
    whose tier is in the shed set raises :class:`ShedError` without
    consuming anyone's tokens — interactive traffic keeps the whole
    budget while the overload lasts."""
    sess = _current_session()
    if (sess is not None and _SHED_TIERS and sess.tier in _SHED_TIERS):
        sess.stats["shed"] += 1
        sess._incident("shed", {"tier": sess.tier, "cid": cid})
        _SHED_STATS["refusals"] += 1
        if telemetry._MODE >= 2:
            telemetry.record_event(
                "admission_shed", tier=sess.tier, session=sess.name, cid=cid
            )
        raise ShedError(
            f"dispatch of chain cid={cid} shed: session {sess.name!r} is "
            f"{sess.tier}-tier and the overload controller is shedding "
            f"{sorted(_SHED_TIERS)} — the chain is still pending and "
            "dispatches cleanly once shedding lifts"
        )
    buckets: List[_TokenBucket] = []
    if sess is not None and sess.bucket is not None:
        buckets.append(sess.bucket)
    if _GLOBAL_BUCKET is not None:
        buckets.append(_GLOBAL_BUCKET)
    if not buckets:
        return None
    policy = sess.policy if sess is not None and sess.policy else _POLICY
    taken: List[_TokenBucket] = []
    for bucket in buckets:
        while True:
            wait = bucket.take()
            if wait <= 0.0:
                taken.append(bucket)
                break
            if policy == "raise":
                bucket.refuse()
                for t in taken:  # refund earlier buckets in the chain
                    t.give_back()
                if sess is not None:
                    sess.stats["admission_refused"] += 1
                    sess._incident("admission_refused",
                                   {"bucket": bucket.name, "cid": cid})
                raise AdmissionError(
                    f"dispatch of chain cid={cid} refused by the "
                    f"{bucket.name} admission bucket for session "
                    f"{sess.name if sess is not None else '<none>'} "
                    f"(rate {bucket.rate}/s, burst {int(bucket.burst)}; "
                    f"retry in {wait:.3f}s or use the 'wait' policy) — the "
                    "chain is still pending and dispatches once tokens refill"
                )
            # wait policy: the refused chain stays pending and dispatches
            # when tokens refill (nothing degraded, nothing re-walked).
            # The sleep happens on the CALLING tenant's thread only, with
            # no fusion lock held: neighbours keep dispatching throughout.
            bucket.note_wait(wait)
            if sess is not None:
                sess.stats["admission_waits"] += 1
                sess.stats["admission_waited_s"] += wait
            if telemetry._MODE >= 2:
                telemetry.record_event(
                    "admission_wait", bucket=bucket.name, cid=cid,
                    seconds=round(wait, 6),
                )
            time.sleep(wait)

    def _refund() -> None:
        for t in taken:
            t.give_back()

    return _refund


def _root_priority(session_name: Optional[str]):
    """fusion's ``_ROOT_PRIORITY`` seam: map a root's recording session to
    a deterministic sort key ``(tier_rank, deadline_ms)`` — interactive
    roots (rank 0) batch ahead of unattributed roots (rank 1) ahead of
    batch-tier roots (rank 2), earliest deadline first within a tier. The
    cross-session batch window orders candidates by this key so a
    latency-sensitive root is never convoyed behind (or truncated out of a
    full batch by) a batch tenant's chain. While a tier is being shed, its
    roots return ``fusion._BATCH_EXCLUDED`` instead — a shed chain must
    not free-ride a neighbour's batch while the overload lasts (it stays
    pending and dispatches, or batches, once shedding lifts). Must never
    raise — fusion calls it inside ``_gather_batch`` under the force
    lock."""
    sess = None
    if session_name is not None:
        with _LOCK:
            sess = _SESSIONS.get(session_name)
    if sess is None:
        return (1, float("inf"))
    if _SHED_TIERS and sess.tier in _SHED_TIERS:
        return fusion._BATCH_EXCLUDED
    deadline = sess.deadline_ms if sess.deadline_ms is not None else float("inf")
    return (0 if sess.tier == "interactive" else 2, deadline)


def _install_hooks() -> None:
    fusion._SERVING_NOTE = _on_note
    fusion._SESSION_OF = _current_session_name
    fusion._ROOT_PRIORITY = _root_priority
    _refresh_admit_hook()


def _uninstall_hooks() -> None:
    fusion._SERVING_NOTE = None
    fusion._SESSION_OF = None
    fusion._ROOT_PRIORITY = None
    _refresh_admit_hook()


def _refresh_admit_hook() -> None:
    """The admit hook is live whenever any bucket could gate a dispatch —
    a global env/set_admission bucket, or an active session with its own —
    or a shed set is armed (tier shedding refuses before any bucket)."""
    armed = _GLOBAL_BUCKET is not None or bool(_SHED_TIERS)
    if not armed:
        with _LOCK:
            armed = any(
                s.bucket is not None and s._entered > 0 for s in _SESSIONS.values()
            )
    fusion._ADMIT_HOOK = _admit if armed else None


def shed(tiers) -> frozenset:
    """Flip overload shedding for ``tiers`` (an iterable of tier names;
    empty/``None``/``()`` lifts shedding entirely). While a tier sheds,
    every fused dispatch from a session of that tier raises
    :class:`ShedError` BEFORE any token is taken — interactive traffic
    keeps the whole admission budget. Returns the previous shed set, so
    callers can restore it. Safe to
    call directly (idempotent, takes effect on the next dispatch)."""
    global _SHED_TIERS
    prev = _SHED_TIERS
    resolved = set()
    for t in tiers or ():
        t = _TIER_ALIASES.get(t, t)
        if t not in _TIERS:
            raise ValueError(
                f"unknown tier {t!r}: tiers are {_TIERS} "
                f"(alias {tuple(_TIER_ALIASES)})"
            )
        resolved.add(t)
    _SHED_TIERS = frozenset(resolved)
    _refresh_admit_hook()
    return prev


def shed_state() -> Dict[str, Any]:
    """The live shed set + refusal counter (pure module state)."""
    return {
        "tiers": sorted(_SHED_TIERS),
        "refusals": _SHED_STATS["refusals"],
    }


#: cross-session micro batch window (seconds). Armed on ``fusion`` whenever
#: >= 2 sessions are concurrently active: each top-level force sleeps this
#: long with the GIL released before dispatching, so the other tenants'
#: threads get to register their pending roots and ride the SAME multi-output
#: program — the thing that keeps N-client steady-state p99 flat instead of
#: convoying N serialized dispatches behind the force lock.
_BATCH_WINDOW = 5e-4


def _refresh_batch_window() -> None:
    fusion._BATCH_WINDOW_S = _BATCH_WINDOW if _ACTIVE >= 2 else 0.0


# ----------------------------------------------------------------------
# Session
# ----------------------------------------------------------------------
class Session:
    """One tenant on the warm mesh, used as a context manager on the
    client's thread::

        with ht.serving.Session("tenant-a", errstate="raise") as sess:
            ...  # every chain recorded here is billed to tenant-a

    Inside the ``with`` block, the calling thread gets: a telemetry scope
    ``session:<name>`` (isolated counters/spans + scoped latency
    histograms), the session's numeric error policy (``errstate`` of
    ``"ignore"``/``"warn"``/``"raise"``; ``None`` inherits the global
    ``ht.errstate``), an isolated numerics-lens sampling frame (``numlens``
    of ``"off"``/``"sample"``/``"full"``; ``None`` inherits the global
    mode but still samples on its own cadence and counters), and — when an
    admission rate is configured — the session's own token bucket composed
    with the global one. Incidents (degraded programs, quarantine hits,
    memory-gate and admission refusals) are recorded on THIS session only:
    a tenant tripping a gate is contained and reported per-session, never
    poisoning neighbors. Thread-safe: distinct threads can run distinct
    sessions concurrently (state is thread-local), and one Session object
    may be entered from several threads at once (each gets its own scope
    entry; the stats roll up)."""

    def __init__(self, name: Optional[str] = None, *,
                 errstate: Optional[str] = None,
                 numlens: Optional[str] = None,
                 admission_rate: Optional[float] = None,
                 admission_burst: Optional[float] = None,
                 policy: Optional[str] = None,
                 tier: Optional[str] = None,
                 deadline_ms: Optional[float] = None):
        self.name = name if name else f"session{next(_SESSION_SEQ)}"
        if errstate is not None and errstate not in ("ignore", "warn", "raise"):
            raise ValueError(
                f"errstate must be one of ('ignore', 'warn', 'raise'), got {errstate!r}"
            )
        if policy is not None and policy not in _POLICIES:
            raise ValueError(f"policy must be one of {_POLICIES}, got {policy!r}")
        tier = _TIER_ALIASES.get(tier, tier)
        if tier is not None and tier not in _TIERS:
            raise ValueError(
                f"tier must be one of {_TIERS} (alias {tuple(_TIER_ALIASES)}), "
                f"got {tier!r}"
            )
        self.tier = tier or "interactive"
        if deadline_ms is not None and not float(deadline_ms) > 0:
            raise ValueError(f"deadline_ms must be > 0, got {deadline_ms!r}")
        self.deadline_ms = None if deadline_ms is None else float(deadline_ms)
        self._errstate = errstate
        self._numlens = numlens
        self.policy = policy
        rate = admission_rate if admission_rate is not None else _ENV_RATE
        if rate is not None:
            burst = admission_burst if admission_burst is not None else \
                max(_ENV_BURST, 1.0)
            self.bucket: Optional[_TokenBucket] = _TokenBucket(
                rate, burst, f"session:{self.name}"
            )
        else:
            self.bucket = None
        self.stats: Dict[str, Any] = {
            "dispatches": 0,
            "roots": 0,
            "compiles": 0,
            "degraded": 0,
            "quarantine_hits": 0,
            "mem_refused": 0,
            "admission_refused": 0,
            "admission_waits": 0,
            "admission_waited_s": 0.0,
            "shed": 0,
        }
        self.incidents: deque = deque(maxlen=64)
        self._entered = 0  # concurrent __enter__ count, across threads
        self._sess_tls = threading.local()  # per-thread enter bookkeeping

    # -- lifecycle ------------------------------------------------------
    def __enter__(self) -> "Session":
        global _ACTIVE
        with _LOCK:
            registered = _SESSIONS.get(self.name)
            if (registered is not None and registered is not self
                    and registered._entered > 0):
                raise ValueError(
                    f"a Session named {self.name!r} is already ACTIVE (names "
                    "are the billing key — two live tenants must not share "
                    "one); an exited session's name is reusable"
                )
            _SESSIONS[self.name] = self  # reusing a name rolls the archive over
            self._entered += 1
            _ACTIVE += 1
            # install while still holding _LOCK: a concurrent last-exit in
            # another thread must not observe _ACTIVE drop to 0, release,
            # and then tear the hooks down AFTER we installed them
            if fusion._SERVING_NOTE is None:
                _install_hooks()
            elif self.bucket is not None:
                _refresh_admit_hook()
            _refresh_batch_window()
        frames = getattr(self._sess_tls, "frames", None)
        if frames is None:
            frames = self._sess_tls.frames = []
        scope_cm = telemetry.scope(f"session:{self.name}")
        scope_cm.__enter__()
        if self._errstate is not None:
            resilience._push_errstate(
                None if self._errstate == "ignore" else self._errstate
            )
        numlens._push_session(self._numlens)
        _session_stack().append(self)
        frames.append(scope_cm)
        return self

    def __exit__(self, *exc) -> None:
        global _ACTIVE
        stack = _session_stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] is self:
                del stack[i]
                break
        numlens._pop_session()
        if self._errstate is not None:
            resilience._pop_errstate()
        frames = getattr(self._sess_tls, "frames", None)
        if frames:
            frames.pop().__exit__(*exc)
        with _LOCK:
            self._entered -= 1
            _ACTIVE -= 1
            # teardown under the SAME lock as the check: deciding last=True,
            # releasing, and uninstalling later would race a concurrent
            # __enter__ (0→1 + install in the window) and silently disarm
            # the new session's admission/billing/containment hooks
            if _ACTIVE == 0:
                _uninstall_hooks()
            elif self.bucket is not None:
                _refresh_admit_hook()
            _refresh_batch_window()

    # -- reporting ------------------------------------------------------
    def _incident(self, kind: str, data: Dict[str, Any]) -> None:
        rec = {"kind": kind}
        rec.update({k: v for k, v in data.items() if k != "sessions"})
        self.incidents.append(rec)

    def quarantined_programs(self) -> List[str]:
        """Program keys THIS session saw degrade or hit quarantine — the
        per-session quarantine view (the global ledger is in
        ``fusion.cache_stats()``)."""
        keys = []
        for rec in self.incidents:
            if rec["kind"] in ("degraded", "quarantine_hit"):
                key = rec.get("program")
                if key and key not in keys:
                    keys.append(key)
        return keys

    def report(self) -> Dict[str, Any]:
        """This session's block: billing counters, incidents, quarantine
        view and bucket stats. Pure module state — never forces, never
        initializes a backend."""
        doc: Dict[str, Any] = {
            "name": self.name,
            "active": self._entered > 0,
            "tier": self.tier,
            "deadline_ms": self.deadline_ms,
            "errstate": self._errstate or "inherit",
            "numlens": self._numlens or "inherit",
            "stats": dict(self.stats),
            "incidents": list(self.incidents),
            "quarantine": self.quarantined_programs(),
        }
        if self.bucket is not None:
            doc["bucket"] = self.bucket.stats()
        return doc


# ----------------------------------------------------------------------
# the persistent cache: arming + warmup
# ----------------------------------------------------------------------
def arm_cache(path: str) -> Dict[str, Any]:
    """Arm the persistent program cache at ``path`` (the programmatic form
    of ``HEAT_TPU_PROGRAM_CACHE_DIR``): point Inductor's caches at
    ``<path>/inductor`` and ``<path>/triton`` with its FX graph cache on,
    and load the program-key index ``<path>/programs.jsonl``. Inductor's
    compile workers keep the directory they started with, so arm before the
    process's first build. Returns ``{"dir", "index_keys", "skipped"}``."""
    global _CACHE_DIR, _INDEX, _PREV_ENV, _PREV_FX_CACHE
    os.makedirs(path, exist_ok=True)
    if _PREV_ENV is None:
        _PREV_ENV = {k: os.environ.get(k) for k in _CACHE_ENV}
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(os.path.abspath(path), "inductor")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(os.path.abspath(path), "triton")
    try:
        import torch._inductor.config as inductor_config

        if _PREV_FX_CACHE is None:
            _PREV_FX_CACHE = inductor_config.fx_graph_cache
        inductor_config.fx_graph_cache = True
    except Exception as exc:  # noqa: BLE001 - a build without Inductor keeps the index
        warnings.warn(
            f"could not turn Inductor's FX graph cache on ({exc!r}); the program-key index still arms "
            "(disk hits are counted, the programs are just built again)",
            stacklevel=2,
        )
    _CACHE_DIR = path
    _INDEX = _DiskIndex(os.path.join(path, "programs.jsonl"))
    _INDEX.load()
    fusion._DISK_INDEX = _INDEX
    return {"dir": path, "index_keys": len(_INDEX.keys), "skipped": _INDEX.skipped}


def disarm_cache() -> None:
    """Detach the persistent index and give Inductor and Triton back the
    cache directories (and the FX-graph-cache switch) they had before the
    first :func:`arm_cache`: left pointing at a caller's, possibly deleted,
    directory, every later build would write there."""
    global _CACHE_DIR, _INDEX, _PREV_ENV, _PREV_FX_CACHE
    _CACHE_DIR = None
    _INDEX = None
    fusion._DISK_INDEX = None
    if _PREV_ENV is not None:
        for key, value in _PREV_ENV.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
        _PREV_ENV = None
    if _PREV_FX_CACHE is not None:
        import torch._inductor.config as inductor_config

        inductor_config.fx_graph_cache = _PREV_FX_CACHE
        _PREV_FX_CACHE = None


def warmup(signatures) -> Dict[str, int]:
    """Pre-bake the program cache ahead of traffic. Each item is either a
    zero-arg callable recording one representative chain (its result is
    forced — compiling, or disk-loading when the signature was seen by an
    earlier process) or a bare program-key string to seed the persistent
    index directly. Returns how the warming went::

        {"warmed": n, "compiles": Δ, "disk_hits": Δ, "seeded": k}
    """
    before = fusion.cache_stats()
    warmed = seeded = 0
    for item in signatures:
        if isinstance(item, str):
            if _INDEX is not None:
                _INDEX.note(item, "?")
                seeded += 1
            continue
        result = item()
        for out in result if isinstance(result, (tuple, list)) else (result,):
            payload = getattr(out, "_payload", out)
            if hasattr(out, "_forced"):
                out._forced()
            else:
                fusion.force(payload)
        warmed += 1
    after = fusion.cache_stats()
    return {
        "warmed": warmed,
        "seeded": seeded,
        "compiles": after["compiles"] - before["compiles"],
        "disk_hits": after["disk_hits"] - before["disk_hits"],
    }


def cache_stats() -> Dict[str, Any]:
    """``fusion.cache_stats()`` plus the persistent layer: where the cache
    dir is (or None disarmed), how many keys the index holds, and how many
    corrupt lines were skipped loading it."""
    st = fusion.cache_stats()
    st["persistent_dir"] = _CACHE_DIR
    st["index_keys"] = 0 if _INDEX is None else len(_INDEX.keys)
    st["index_skipped"] = 0 if _INDEX is None else _INDEX.skipped
    return st


# ----------------------------------------------------------------------
# admission configuration
# ----------------------------------------------------------------------
def set_admission(rate: Optional[float], burst: Optional[float] = None,
                  policy: Optional[str] = None) -> None:
    """Arm (or, with ``rate=None``, disarm) the GLOBAL admission bucket —
    the programmatic form of ``HEAT_TPU_ADMISSION_RATE``/``_BURST``/
    ``_POLICY``. Per-session buckets are per-:class:`Session` kwargs.

    Changing rate/burst on an already-armed bucket reconfigures it IN
    PLACE: the ``refused``/``waited_s``/``admitted`` counters and the
    accumulated tokens survive (tokens clamp to the new burst), so a
    mid-traffic retune never zeroes
    the ops plane's admission counters."""
    global _GLOBAL_BUCKET, _POLICY
    if policy is not None:
        if policy not in _POLICIES:
            raise ValueError(f"policy must be one of {_POLICIES}, got {policy!r}")
        _POLICY = policy
    if rate is None:
        _GLOBAL_BUCKET = None
    else:
        if rate <= 0:
            raise ValueError(f"rate must be > 0 tokens/second, got {rate}")
        resolved_burst = burst if burst is not None else max(rate, 1.0)
        if _GLOBAL_BUCKET is not None:
            _GLOBAL_BUCKET.reconfigure(rate, resolved_burst)
        else:
            _GLOBAL_BUCKET = _TokenBucket(rate, resolved_burst, "global")
    _refresh_admit_hook()


# ----------------------------------------------------------------------
# report surfaces
# ----------------------------------------------------------------------
def session_reports() -> List[Dict[str, Any]]:
    """Every session's report block (active and exited), entry order."""
    with _LOCK:
        sessions = list(_SESSIONS.values())
    return [s.report() for s in sessions]


def sessions_block() -> Dict[str, Any]:
    """The ``report()["serving"]`` payload: per-session blocks, the global
    admission bucket, and the persistent-cache summary. Pure module state —
    never forces, never initializes a backend."""
    with _LOCK:
        sessions = list(_SESSIONS.values())
    return {
        "sessions": [s.report() for s in sessions],
        "active": sum(1 for s in sessions if s._entered > 0),
        "admission": {
            "policy": _POLICY,
            "global": None if _GLOBAL_BUCKET is None else _GLOBAL_BUCKET.stats(),
            "shed_tiers": sorted(_SHED_TIERS),
            "shed_refusals": _SHED_STATS["refusals"],
        },
        "cache": {
            "persistent_dir": _CACHE_DIR,
            "index_keys": 0 if _INDEX is None else len(_INDEX.keys),
            "disk_hits": fusion._STATS["disk_hits"],
        },
    }


def reset() -> None:
    """Forget exited sessions and zero the global bucket's counters (active
    sessions and the arming itself — cache dir, rates — are configuration
    and survive, mirroring ``memledger.reset``). Called from
    ``telemetry.reset()`` so the joined report surfaces clear together."""
    with _LOCK:
        for name in [n for n, s in _SESSIONS.items() if s._entered == 0]:
            del _SESSIONS[name]
        _refresh_batch_window()
    if _GLOBAL_BUCKET is not None:
        with _GLOBAL_BUCKET._lock:
            _GLOBAL_BUCKET.admitted = 0
            _GLOBAL_BUCKET.refused = 0
            _GLOBAL_BUCKET.waited_s = 0.0
    _SHED_STATS["refusals"] = 0


# ----------------------------------------------------------------------
# import-time arming from the env knobs
# ----------------------------------------------------------------------
_env_cache_dir = _parse_env_cache_dir()
if _env_cache_dir is not None:
    arm_cache(_env_cache_dir)
if _ENV_RATE is not None:
    _GLOBAL_BUCKET = _TokenBucket(_ENV_RATE, _ENV_BURST, "global")
    _refresh_admit_hook()

# per-session label export (set-attribute, like the fusion seams): SLO
# latency samples carry the recording thread's session name, so the ops
# plane's burn-rate windows can group per tenant without health_runtime
# importing the serving layer
health_runtime._TENANT_HOOK = _current_session_name
