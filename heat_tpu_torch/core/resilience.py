"""Fault injection, recovery policy, the numeric error policy and atomic,
retrying I/O (reference: heat_tpu/core/resilience.py).

Fault injection
---------------
Named **injection sites** in the port's seams:

=======================  ==================================================
site                     where it fires
=======================  ==================================================
``collective.<verb>``    each ``MeshCommunication`` verb, before it moves
                         anything (``collective.allreduce``, ...), and each
                         declared linear-algebra schedule once
``collective.matmul``    a 2-D ``matmul`` of unpadded operands
``collective.reshard``   a resplit (``resplit``, ``DNDarray.resplit_``),
                         before any metadata changes
``collective.halo``      a halo exchange (``DNDarray.get_halo``)
``io.read``              each block read of a load
``io.write``             each whole-file write attempt of a ``save_*``
``io.rename``            the temp-then-rename publication
``checkpoint.write``     each payload-file write of a checkpoint
``checkpoint.commit``    the manifest publication, a checkpoint's commit
``checkpoint.restore``   manifest and payload reads of verify and restore
``checkpoint.gc``        each retention or debris deletion
``watchdog.stall``       an armed watchdog guard (``core/health_runtime``),
                         which turns the fault into a real stall past its
                         deadline; ``watchdog.stall:<site>`` targets one
                         site (``watchdog.stall:sync:numpy``)
``numeric.sdc.<index>``  the numerics lens's canary on the mesh device of
                         that index (``core/numlens.run_canary``): the
                         device is reported as returning wrong bits
=======================  ==================================================

:func:`inject` arms a site for a block::

    with ht.resilience.inject("collective.allreduce", times=1):
        ht.sum(x, axis=0)       # raises FaultInjected before any shard moves

``HEAT_TPU_FAULTS`` arms sites for a whole process: the ``ci`` preset (the
reference's background mix of recoverable faults) or an explicit list,
``HEAT_TPU_FAULTS="io.write:exc=OSError:every=5,collective.*:every=11"``.
Specs are deterministic: ``every=N`` counts matching checks, ``p=<float>``
draws from a ``seed``-ed private ``random.Random``, so a spec string fires
at the same calls in both packages. While an :func:`inject` block is active
the environment's specs are suspended.

Recovery policy
---------------
:func:`record_recoverable` and :func:`force_recoverable` are the one place
that decides which failures fall back (the fusion recorder's seams).
:class:`errstate` is the numeric error policy,
``ht.errstate(nonfinite="warn"|"raise"|"ignore")``: the eager engines check
each result for inf/NaN with one ``isfinite`` reduction and one scalar read,
and warn or raise :class:`NonFiniteError`. Off by default, when the check
costs two module-attribute reads per op. A serving ``Session`` pushes a
policy of its own for its thread (:func:`_push_errstate`), which shadows
the global one there.

Atomic and retrying I/O
-----------------------
:func:`atomic_write` publishes by temp-then-rename, so a crash never leaves
a partial file under the target name. :func:`call_with_retries` retries
transient ``OSError``s with capped exponential backoff (:data:`retry_policy`,
seeded by ``HEAT_TPU_IO_RETRIES`` and ``HEAT_TPU_IO_RETRY_DELAY``);
non-transient errnos never retry.

One process drives every device here, so :func:`atomic_write`'s publishing
process is always this one; ``force_recoverable`` does not yet know the
memory ledger's budget refusal, which comes with the ledger.
"""

from __future__ import annotations

import errno as errno_module
import fnmatch
import os
import random
import re
import shutil
import threading
import time
import warnings
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional

from . import telemetry

__all__ = [
    "DegradedDispatchWarning",
    "FaultInjected",
    "MeshDegradedWarning",
    "NonFiniteError",
    "NonFiniteWarning",
    "RetryPolicy",
    "atomic_write",
    "call_with_retries",
    "check",
    "check_nonfinite",
    "degraded_devices",
    "device_fault_counts",
    "errstate",
    "fault_counts",
    "force_recoverable",
    "inject",
    "note_device_fault",
    "record_recoverable",
    "reset",
    "reset_device_faults",
    "retry_policy",
    "suspended",
    "StallError",
    "StallWarning",
]


class FaultInjected(RuntimeError):
    """The default exception raised at an armed injection site."""


class DegradedDispatchWarning(UserWarning):
    """A fused program failed and its chain was re-run op by op."""


class NonFiniteError(FloatingPointError):
    """Non-finite values found under ``ht.errstate(nonfinite="raise")``."""


class NonFiniteWarning(RuntimeWarning):
    """Non-finite values found under ``ht.errstate(nonfinite="warn")``."""


class StallWarning(UserWarning):
    """A watchdog found a blocking wait past its deadline."""


class StallError(TimeoutError):
    """A watchdog's stall under the ``raise`` policy: a policy signal that
    propagates, never a failure to degrade."""


class MeshDegradedWarning(UserWarning):
    """Faults attributed to one device crossed
    ``HEAT_TPU_DEVICE_FAULT_THRESHOLD``: the device is marked degraded."""


# ----------------------------------------------------------------------
# the fault-injection harness
# ----------------------------------------------------------------------
_EXC_BY_NAME = {
    "FaultInjected": FaultInjected,
    "OSError": OSError,
    "IOError": OSError,
    "TimeoutError": TimeoutError,
    "RuntimeError": RuntimeError,
    "MemoryError": MemoryError,
    "ValueError": ValueError,
}


class FaultSpec:
    """One armed fault: a site pattern and a deterministic firing rule.

    ``times`` caps how often it fires (``times=0`` arms the sites but never
    fires); ``every=N`` fires on every Nth matching check; ``p`` draws from
    a private ``seed``-ed RNG."""

    __slots__ = ("pattern", "exc", "times", "every", "p", "rng", "seen", "fired", "_regex")

    def __init__(self, pattern, exc=FaultInjected, times=None, every=None, p=1.0, seed=0):
        self.pattern = pattern
        self.exc = exc
        self.times = times
        self.every = every
        self.p = float(p)
        self.rng = random.Random(seed)
        self.seen = 0
        self.fired = 0
        self._regex = re.compile(fnmatch.translate(pattern))

    def matches(self, site: str) -> bool:
        return self._regex.match(site) is not None

    def should_fire(self) -> bool:
        self.seen += 1
        if self.times is not None and self.fired >= self.times:
            return False
        if self.every is not None and self.seen % self.every != 0:
            return False
        if self.p < 1.0 and self.rng.random() >= self.p:
            return False
        return True

    def make(self, site: str) -> BaseException:
        if isinstance(self.exc, BaseException):
            return self.exc
        if issubclass(self.exc, OSError):
            # a transient I/O fault by construction: ETIMEDOUT and EIO are in
            # the retry policy's transient set
            err = errno_module.ETIMEDOUT if issubclass(self.exc, TimeoutError) else errno_module.EIO
            return self.exc(err, f"injected fault at {site}")
        return self.exc(f"injected fault at {site}")

    def __repr__(self) -> str:
        return (
            f"FaultSpec({self.pattern!r}, exc={getattr(self.exc, '__name__', self.exc)},"
            f" times={self.times}, every={self.every}, p={self.p}, fired={self.fired})"
        )


def _parse_specs(text: str) -> List[FaultSpec]:
    """``site:key=val:key=val, site2:...`` as FaultSpecs; a malformed entry
    warns and is skipped."""
    specs: List[FaultSpec] = []
    for entry in text.split(","):
        entry = entry.strip()
        if not entry:
            continue
        parts = entry.split(":")
        kwargs: dict = {}
        try:
            for part in parts[1:]:
                key, _, val = part.partition("=")
                key = key.strip()
                if key == "exc":
                    kwargs["exc"] = _EXC_BY_NAME[val.strip()]
                elif key in ("times", "every", "seed"):
                    kwargs[key] = int(val)
                elif key == "p":
                    kwargs["p"] = float(val)
                else:
                    raise KeyError(key)
            specs.append(FaultSpec(parts[0].strip(), **kwargs))
        except Exception as exc:  # noqa: BLE001 - a typo in a knob must not stop the process
            warnings.warn(f"HEAT_TPU_FAULTS: ignoring malformed entry {entry!r} ({exc!r})", stacklevel=2)
    return specs


#: the background mix of recoverable seams (the reference's preset, sites
#: the port lacks yet included: they never fire here)
_PRESETS = {
    "ci": (
        "fusion.compile:every=13,"
        "fusion.execute:every=11,"
        "fusion.record:every=17,"
        "io.write:exc=OSError:every=5,"
        "io.read:exc=OSError:every=7,"
        "checkpoint.write:exc=OSError:every=3,"
        "checkpoint.commit:exc=OSError:every=3,"
        "checkpoint.restore:exc=OSError:every=5,"
        "checkpoint.gc:exc=OSError:every=2"
    ),
}


def _parse_env(value: str) -> List[FaultSpec]:
    value = (value or "").strip()
    if not value or value.lower() in ("0", "off", "false", "no"):
        return []
    return _parse_specs(_PRESETS.get(value.lower(), value))


#: the environment's specs, suspended while an inject() block is active
_BACKGROUND: List[FaultSpec] = _parse_env(os.environ.get("HEAT_TPU_FAULTS", ""))
#: the specs of nested inject() blocks (all of them fire)
_OVERLAY: List[FaultSpec] = []
#: fired faults per site (survives the blocks)
_FIRED: Dict[str, int] = {}

#: True while any spec is armed, firing or not: a site gates on
#: ``resilience._ARMED`` with one attribute read
_ARMED = bool(_BACKGROUND)


def check(site: str) -> None:
    """Raise the armed fault for ``site``, if any."""
    if not _ARMED:
        return
    for spec in _OVERLAY if _OVERLAY else _BACKGROUND:
        if spec.matches(site) and spec.should_fire():
            spec.fired += 1
            _FIRED[site] = _FIRED.get(site, 0) + 1
            if telemetry._MODE:
                telemetry.record_fault(site, spec.pattern)
            raise spec.make(site)


@contextmanager
def inject(site: str, exc=FaultInjected, times: Optional[int] = 1, every: Optional[int] = None, p: float = 1.0, seed: int = 0):
    """Arm a fault at ``site`` (an fnmatch pattern) for the block; yields the
    :class:`FaultSpec` (its ``fired`` count stays readable). The
    environment's specs are suspended meanwhile; nested blocks all fire."""
    global _ARMED
    spec = FaultSpec(site, exc=exc, times=times, every=every, p=p, seed=seed)
    _OVERLAY.append(spec)
    _ARMED = True
    try:
        yield spec
    finally:
        _OVERLAY.remove(spec)
        _ARMED = bool(_BACKGROUND) or bool(_OVERLAY)


@contextmanager
def suspended():
    """Run with the environment's specs suspended (an armed spec that never
    fires), so exact fault counts stay exact under ``HEAT_TPU_FAULTS``."""
    with inject("__suspend__", times=0):
        yield


def fault_counts() -> Dict[str, int]:
    """Fired faults per site."""
    return dict(_FIRED)


def reset() -> None:
    """Zero the per-site fired counts (armed specs keep their own state)."""
    _FIRED.clear()


# ----------------------------------------------------------------------
# the per-device fault ledger
# ----------------------------------------------------------------------
def _parse_device_fault_threshold() -> int:
    raw = os.environ.get("HEAT_TPU_DEVICE_FAULT_THRESHOLD", "").strip()
    if not raw:
        return 3
    try:
        return max(1, int(raw))
    except ValueError:
        warnings.warn(f"HEAT_TPU_DEVICE_FAULT_THRESHOLD={raw!r} is not an int; using 3", stacklevel=1)
        return 3


#: faults per device before the device is marked degraded
_DEVICE_FAULT_THRESHOLD = _parse_device_fault_threshold()
_DEVICE_FAULTS: Dict[str, int] = {}
_DEGRADED_DEVICES: set = set()


def note_device_fault(device, site: str = "collective") -> bool:
    """Attribute one fault to ``device``; the call that crosses
    ``HEAT_TPU_DEVICE_FAULT_THRESHOLD`` (default 3) marks it degraded, emits
    a ``mesh_degraded`` event, warns :class:`MeshDegradedWarning` and
    returns True."""
    key = str(device)
    count = _DEVICE_FAULTS.get(key, 0) + 1
    _DEVICE_FAULTS[key] = count
    if key in _DEGRADED_DEVICES or count < _DEVICE_FAULT_THRESHOLD:
        return False
    _DEGRADED_DEVICES.add(key)
    if telemetry._MODE:
        telemetry.record_event("mesh_degraded", device=key, faults=count, site=site)
    warnings.warn(
        MeshDegradedWarning(
            f"device {key} accumulated {count} attributed fault(s) at {site} "
            f"(threshold {_DEVICE_FAULT_THRESHOLD}): marked degraded"
        ),
        stacklevel=2,
    )
    return True


def device_fault_counts() -> Dict[str, int]:
    """Attributed faults per device."""
    return dict(_DEVICE_FAULTS)


def degraded_devices() -> set:
    """``str(device)`` of the devices past the threshold."""
    return set(_DEGRADED_DEVICES)


def reset_device_faults() -> None:
    """Clear the per-device ledger and the degraded set."""
    _DEVICE_FAULTS.clear()
    _DEGRADED_DEVICES.clear()


# ----------------------------------------------------------------------
# recovery policies
# ----------------------------------------------------------------------
#: record-time failures that mean "this op cannot be recorded": the eager
#: engine handles the operands or raises the same error at the op
_RECORD_FALLBACK_TYPES = (TypeError, ValueError, NotImplementedError, IndexError, ArithmeticError)


def record_recoverable(exc: BaseException) -> bool:
    """Whether a failure while recording an op into a fused program falls
    back to the eager engine (injected faults and the shape, type and
    arithmetic rejections do; ``MemoryError`` and the rest propagate)."""
    return isinstance(exc, (FaultInjected,) + _RECORD_FALLBACK_TYPES)


def force_recoverable(exc: BaseException) -> bool:
    """Whether a fused program's build or run failure degrades the chain to
    op-by-op dispatch: everything does (a memory exhaustion too) except the
    policy signals raised by the forcing point itself
    (:class:`NonFiniteError`, :class:`StallError` and the memory gate's
    :class:`~.memledger.MemoryBudgetExceeded`, raised before the dispatch so
    that the chain stays pending)."""
    if isinstance(exc, (NonFiniteError, StallError)):
        return False
    from .memledger import MemoryBudgetExceeded

    return not isinstance(exc, MemoryBudgetExceeded)


# ----------------------------------------------------------------------
# the numeric error policy: ht.errstate(nonfinite=...)
# ----------------------------------------------------------------------
_NONFINITE_MODES = ("ignore", "warn", "raise")

#: None = ignore (the default); "warn" or "raise". HEAT_TPU_NONFINITE seeds it
_ERRSTATE: Optional[str] = None
_env_nonfinite = os.environ.get("HEAT_TPU_NONFINITE", "ignore").strip().lower()
if _env_nonfinite in ("warn", "raise"):
    _ERRSTATE = _env_nonfinite

# The per-thread overrides of the serving layer's sessions, over the global
# policy. ``_TLS_ARMED`` counts the pushed overrides of every thread, so the
# engines' gates stay two module-attribute reads while no session has one.
_ERR_TLS = threading.local()
_TLS_ARMED = 0
_TLS_LOCK = threading.Lock()


def _push_errstate(mode: Optional[str]) -> None:
    """Push a policy for the calling thread only (``None`` = ignore, "warn"
    or "raise"), shadowing the global one until :func:`_pop_errstate`."""
    global _TLS_ARMED
    stack = getattr(_ERR_TLS, "stack", None)
    if stack is None:
        stack = _ERR_TLS.stack = []
    stack.append(mode)
    with _TLS_LOCK:
        _TLS_ARMED += 1


def _pop_errstate() -> None:
    global _TLS_ARMED
    stack = getattr(_ERR_TLS, "stack", None)
    if stack:
        stack.pop()
        with _TLS_LOCK:
            _TLS_ARMED -= 1


def _effective_errstate() -> Optional[str]:
    """The policy of the calling thread: its innermost override, else the
    global ``ht.errstate`` policy."""
    stack = getattr(_ERR_TLS, "stack", None)
    if stack:
        return stack[-1]
    return _ERRSTATE


class errstate:
    """Numeric error policy scope: ``ht.errstate(nonfinite="warn")``.

    ``nonfinite`` in {"ignore", "warn", "raise"}: what an eager op does when
    its result holds inf or NaN. ``numpy.errstate`` semantics: the policy
    applies on entry and the previous one returns on exit, so scopes nest
    and an instance can be reused. ``HEAT_TPU_NONFINITE`` sets the
    process-wide policy."""

    def __init__(self, nonfinite: str = "ignore"):
        if nonfinite not in _NONFINITE_MODES:
            raise ValueError(f"nonfinite must be one of {_NONFINITE_MODES}, got {nonfinite!r}")
        self._mode = None if nonfinite == "ignore" else nonfinite
        # a stack, so one instance may be entered reentrantly
        self._prev_stack: List[Optional[str]] = []

    def __enter__(self) -> "errstate":
        global _ERRSTATE
        self._prev_stack.append(_ERRSTATE)
        _ERRSTATE = self._mode
        return self

    def __exit__(self, *exc) -> None:
        global _ERRSTATE
        _ERRSTATE = self._prev_stack.pop()


def check_nonfinite(value, where: str = "force", *, program=None, cid=None) -> None:
    """Apply the active ``errstate`` policy to ``value``, a tensor or a
    sequence of tensors (a result's logical shards). Inexact dtypes only,
    bfloat16 included. Each tensor reduces to one ``isfinite(x).all()`` on
    its own device, the flags combine on the first one, and one scalar read
    is the only sync added. ``program``/``cid`` name a producing fused
    program in the message, and, with the numerics lens on, in its
    ``numlens.nonfinite`` finding."""
    mode = _effective_errstate()
    if mode is None:
        return
    parts = list(value) if isinstance(value, (list, tuple)) else [value]
    if not parts:
        return
    dtype = getattr(parts[0], "dtype", None)
    if dtype is None or not (dtype.is_floating_point or dtype.is_complex):
        return
    import torch

    first = parts[0].device
    flags = [torch.isfinite(t).all() for t in parts]
    ok = flags[0] if len(flags) == 1 else torch.stack([f.to(first) for f in flags]).all()
    if bool(ok):
        return
    if telemetry._MODE:
        telemetry.record_nonfinite(where)
    origin = ""
    if program is not None or cid is not None:
        origin = f" produced by fused program {program or '<eager>'} (chain cid {cid if cid is not None else '?'})"
    shape = tuple(parts[0].shape) if len(parts) == 1 else f"{len(parts)} shards of {tuple(parts[0].shape)}"
    msg = (
        f"non-finite values (inf/NaN) detected at {where} point "
        f"(shape {shape}, dtype {str(dtype).replace('torch.', '')}){origin} under ht.errstate"
    )
    from . import numlens

    if numlens.active():
        numlens._add_finding("numlens.nonfinite", "error", msg, where=where, program=program, cid=cid)
    if mode == "raise":
        raise NonFiniteError(msg)
    warnings.warn(NonFiniteWarning(msg), stacklevel=3)


# ----------------------------------------------------------------------
# retrying I/O
# ----------------------------------------------------------------------
#: errnos worth retrying: interrupted calls and the device and network
#: errors a flaky mount gives; ENOENT, EACCES, ENOSPC never retry
_TRANSIENT_ERRNOS = frozenset(
    getattr(errno_module, name)
    for name in (
        "EAGAIN", "EWOULDBLOCK", "EINTR", "EBUSY", "EIO", "ETIMEDOUT",
        "ESTALE", "ECONNRESET", "ENETDOWN", "ENETUNREACH", "ENOBUFS",
    )
    if hasattr(errno_module, name)
)


class RetryPolicy:
    """Capped exponential backoff over transient ``OSError``s: ``retries``
    extra attempts, ``base_delay`` seconds before the first, doubling up to
    ``max_delay``; :meth:`is_transient` classifies."""

    __slots__ = ("retries", "base_delay", "max_delay", "transient_errnos")

    def __init__(self, retries: int = 2, base_delay: float = 0.05, max_delay: float = 1.0, transient_errnos: frozenset = _TRANSIENT_ERRNOS):
        self.retries = int(retries)
        self.base_delay = float(base_delay)
        self.max_delay = float(max_delay)
        self.transient_errnos = transient_errnos

    def is_transient(self, exc: BaseException) -> bool:
        return isinstance(exc, OSError) and exc.errno in self.transient_errnos

    def __repr__(self) -> str:
        return f"RetryPolicy(retries={self.retries}, base_delay={self.base_delay}, max_delay={self.max_delay})"


#: the policy every retrying I/O path consults
retry_policy = RetryPolicy(
    retries=int(os.environ.get("HEAT_TPU_IO_RETRIES", "2")),
    base_delay=float(os.environ.get("HEAT_TPU_IO_RETRY_DELAY", "0.05")),
)


def call_with_retries(site: str, fn: Callable, *args, policy: Optional[RetryPolicy] = None, **kwargs):
    """Run ``fn(*args, **kwargs)``, retrying transient ``OSError``s with the
    policy's backoff; ``site`` is checked before every attempt, so an
    injected ``OSError`` takes exactly the retry path."""
    pol = policy if policy is not None else retry_policy
    delay = pol.base_delay
    attempt = 0
    while True:
        try:
            if _ARMED:
                check(site)
            return fn(*args, **kwargs)
        except OSError as exc:
            if attempt >= pol.retries or not pol.is_transient(exc):
                raise
            attempt += 1
            if telemetry._MODE:
                telemetry.record_io_retry(site)
            time.sleep(min(delay, pol.max_delay))
            delay *= 2.0


# ----------------------------------------------------------------------
# atomic writes
# ----------------------------------------------------------------------
def _unlink_quiet(path: str) -> None:
    try:
        os.unlink(path)
    except OSError:
        pass


@contextmanager
def atomic_write(path: str, preserve: bool = False):
    """Yield a private temporary path beside ``path``; publish it with
    ``os.replace`` when the block succeeds, and remove it when the block
    fails, so ``path`` only ever holds a complete file, the old one or the
    new one. ``preserve`` seeds the temporary file with a copy of the
    target (the append modes). A block that writes nothing publishes
    nothing. The ``io.rename`` site fires before the rename."""
    directory = os.path.dirname(os.path.abspath(path)) or "."
    tmp = os.path.join(directory, f".{os.path.basename(path)}.tmp-{os.getpid()}-0")
    if preserve and os.path.exists(path):
        try:
            shutil.copy2(path, tmp)
        except BaseException:
            _unlink_quiet(tmp)
            raise
    try:
        yield tmp
    except BaseException:
        _unlink_quiet(tmp)
        raise
    if not os.path.exists(tmp):
        return
    try:
        if _ARMED:
            check("io.rename")
        os.replace(tmp, path)
    except BaseException:
        _unlink_quiet(tmp)
        raise
