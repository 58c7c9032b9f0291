"""Post-hoc trace analytics: the critical path, cross-host straggler
attribution and the diagnosis of a slow window (``ht.tracelens``;
reference: heat_tpu/core/tracelens.py).

:func:`analyze` reads a timeline (the live ``telemetry`` state, an exported
or merged Chrome trace document, a file path, or a flight-recorder ring)
and answers "why is this window slow" in four parts:

1. **Time attribution.** Every wall-clock microsecond of the window goes to
   one bucket, overall and per program key, with an explicit
   ``unattributed`` remainder, so the accounting can be checked:

   * ``compile``        the cid-joined compile-to-dispatch interval: the
     first call of a fresh program, which builds it (Inductor on the card)
   * ``dispatch_queue`` host time from a blocking read's start to the
     program call returning (the record walk, batching, the enqueue)
   * ``device_execute`` the rest of that read, joined by cid to an
     in-flight dispatch: the host waits on the card running the program
   * ``collective``     blocking syncs whose trigger is a collective
   * ``sync_wait``      blocking syncs joined to no dispatch (drains,
     degraded replays, reads of eager results)
   * ``host_async``     uncovered time with a dispatch in flight (host and
     card overlap)
   * ``host_gap``       uncovered time with nothing in flight: the card is
     provably idle while the host computes

2. **The critical path**: the longest serialized chain of blocking
   segments, an ordered list of (bucket, dur, program key, cid).

3. **Cross-host stragglers.** On merged traces each host's clock offset is
   estimated from its earliest matched collective events (matched by
   occurrence, robust to cid drift between hosts); the arrival skew per
   collective then names the straggling host. The ``trace.hostdelay``
   fault site makes one host slow, and must give the
   ``tracelens.straggler`` finding.

4. **Detectors**: sync storm, retrace storm, reshard ping-pong, device-idle
   gaps and the numerics lens's events, each a :class:`Finding` with a
   severity and a fix hint.

The analyzer reads the timeline only: it never forces a pending chain,
never initializes CUDA and never adds events. What it can see is what the
timeline records. A kernel launched outside the fusion recorder (``KMeans``'
Lloyd launches, an eager op under ``fusion._EAGER_BELOW_BYTES``) records no
``dispatch``, so a read of its result is ``sync_wait``, not
``device_execute``. A program's call returns after the launch, so
``device_execute`` is the host's wait, the card's time less the host work
between the launch and the read. The command line is ``python -m
heat_tpu_torch.telemetry analyze``.
"""

from __future__ import annotations

import bisect
import json
import math
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "Finding",
    "TraceIncompleteError",
    "analyze",
    "diagnose",
    "diff",
    "load_analysis",
    "render",
]

#: findings schema version (diff refuses to compare across major bumps)
SCHEMA = 1

#: attribution buckets, in sweep priority order (highest wins a segment)
_BUCKET_PRIORITY = {
    "compile": 6,
    "device_execute": 5,
    "collective": 5,
    "sync_wait": 5,
    "dispatch_queue": 4,
    "host_async": 2,
    "host_gap": 1,
}

#: buckets on which the host is blocked — the critical-path candidate set
_BLOCKING_BUCKETS = ("compile", "dispatch_queue", "device_execute", "collective", "sync_wait")

# detector defaults (overridable per analyze() call)
_SYNC_STORM_K = int(os.environ.get("HEAT_TPU_TRACELENS_SYNC_STORM_K", "24"))
_SYNC_STORM_WINDOW_S = 1.0
_RETRACE_STORM_K = int(os.environ.get("HEAT_TPU_TRACELENS_RETRACE_K", "4"))
_IDLE_GAP_MS = float(os.environ.get("HEAT_TPU_TRACELENS_IDLE_GAP_MS", "250"))
_IDLE_GAP_PCT = 50.0  # host_gap share of window that escalates to a warning
_STRAGGLER_MS = float(os.environ.get("HEAT_TPU_TRACELENS_STRAGGLER_MS", "5"))
_MIN_MATCHED_COLLECTIVES = 3
_MAX_PATH_STEPS = 64


class TraceIncompleteError(ValueError):
    """The analyzed window dropped events past the timeline cap — attribution
    over a truncated window would silently lie. Re-run with a larger
    ``HEAT_TPU_TELEMETRY_EVENTS`` cap, or pass ``allow_partial=True``
    (CLI ``--allow-partial``) to analyze anyway with a loud caveat."""


@dataclass
class Finding:
    """One diagnosis: rule id, severity, message, fix hint — the trace-level
    twin of the static analyzer's ``engine.Finding``."""

    rule: str
    severity: str  # "error" | "warning" | "info"
    message: str
    hint: str = ""
    host: Optional[int] = None
    data: Dict[str, Any] = field(default_factory=dict)

    def as_dict(self) -> Dict[str, Any]:
        doc: Dict[str, Any] = {
            "rule": self.rule,
            "severity": self.severity,
            "message": self.message,
            "hint": self.hint,
        }
        if self.host is not None:
            doc["host"] = self.host
        if self.data:
            doc["data"] = dict(self.data)
        return doc


# ----------------------------------------------------------------------
# normalization: every input shape -> per-host raw event lists (seconds)
# ----------------------------------------------------------------------
def _finite(v) -> Optional[float]:
    try:
        f = float(v)
    except (TypeError, ValueError):
        return None
    return f if math.isfinite(f) else None


def _from_perfetto(doc: dict) -> Tuple[Dict[int, List[dict]], int]:
    """Invert the exporter: a Chrome trace document (one host or merged)
    back to per-pid raw event lists with seconds timestamps. Malformed
    events are skipped — their time lands in ``unattributed``."""
    hosts: Dict[int, List[dict]] = {}
    # B/E pairing stacks for span/timer reconstruction, per (pid, cat, name)
    open_frames: Dict[tuple, List[float]] = {}
    for ev in doc.get("traceEvents", []):
        if not isinstance(ev, dict):
            continue
        ph = ev.get("ph")
        if ph in ("M", "C", "b", "e", None):
            continue  # meta/counter rows; async pairs are re-derived from cids
        pid = ev.get("pid", 0)
        pid = pid if isinstance(pid, int) else 0
        ts = _finite(ev.get("ts"))
        if ts is None:
            continue
        ts /= 1e6  # exporter stamps microseconds
        cat = ev.get("cat")
        name = str(ev.get("name", ""))
        args = ev.get("args") if isinstance(ev.get("args"), dict) else {}
        out = hosts.setdefault(pid, [])
        if ph == "B":
            open_frames.setdefault((pid, cat, name), []).append(ts)
            if cat == "span":
                out.append({"kind": "span_begin", "ts": ts, "name": name})
        elif ph == "E":
            stack = open_frames.get((pid, cat, name))
            start = stack.pop() if stack else None
            if cat == "span":
                dur = (ts - start) if start is not None else None
                out.append({"kind": "span_end", "ts": ts, "name": name, "dur": dur})
            elif cat == "timer" and start is not None:
                out.append({"kind": "timer", "ts": ts, "name": name, "dur": ts - start})
        elif ph == "X" and cat == "sync":
            dur = _finite(ev.get("dur"))
            rec = {
                "kind": "blocking_sync",
                "ts": ts,
                "where": args.get("where"),
                "cid": args.get("cid"),
            }
            if dur is not None:
                rec["dur"] = dur / 1e6
            out.append(rec)
        elif ph == "i":
            if cat == "sync":
                out.append({"kind": "blocking_sync", "ts": ts,
                            "where": args.get("where"), "cid": args.get("cid")})
            elif cat == "dispatch":
                out.append({"kind": "dispatch", "ts": ts,
                            "roots": args.get("roots"), "cid": args.get("cid"),
                            "cids": args.get("cids") or [],
                            "program": args.get("program")})
            elif cat == "collective":
                kind = "fused_collective" if name.startswith("fused:") else "collective"
                op = name[6:] if kind == "fused_collective" else name
                out.append({"kind": kind, "ts": ts, "op": args.get("op", op),
                            "cid": args.get("cid"), "detail": args.get("detail"),
                            "bytes": args.get("bytes"), "count": args.get("count", 1)})
            elif cat == "compile":
                out.append({"kind": "compile", "ts": ts,
                            "program": args.get("program"), "family": args.get("family"),
                            "label": args.get("label"), "cid": args.get("cid")})
            elif cat == "fault":
                out.append({"kind": "fault", "ts": ts, "site": args.get("site")})
            else:
                out.append({"kind": str(cat or "event"), "ts": ts, "name": name})
    dropped = 0
    other = doc.get("otherData")
    if isinstance(other, dict):
        d = _finite(other.get("events_dropped"))
        dropped = int(d) if d else 0
    return hosts, dropped


def _normalize(source) -> Tuple[Dict[int, List[dict]], int, str]:
    """``(hosts, events_dropped, source_kind)`` from any accepted input:
    None (live telemetry state), a raw event list, a Chrome trace document,
    or a path to an exported/merged trace file."""
    if source is None:
        from . import telemetry

        evs = telemetry.events()
        dropped = telemetry._cur().events_dropped
        return ({0: evs} if evs else {}), dropped, "live"
    if isinstance(source, str):
        try:
            with open(source) as fh:
                doc = json.load(fh)
        except OSError as exc:
            raise ValueError(f"cannot read trace {source!r}: {exc}") from exc
        except json.JSONDecodeError as exc:
            raise ValueError(f"{source!r} is not valid JSON: {exc}") from exc
        hosts, dropped = _coerce_doc(doc, source)
        return hosts, dropped, source
    hosts, dropped = _coerce_doc(source, "<doc>")
    return hosts, dropped, "doc"


def _coerce_doc(doc, label: str) -> Tuple[Dict[int, List[dict]], int]:
    if isinstance(doc, list):  # a raw timeline (telemetry.events() shape)
        return ({0: [e for e in doc if isinstance(e, dict)]} if doc else {}), 0
    if isinstance(doc, dict) and isinstance(doc.get("traceEvents"), list):
        return _from_perfetto(doc)
    raise ValueError(
        f"{label}: not a trace — expected a raw event list or a Chrome "
        "trace document with 'traceEvents'"
    )


# ----------------------------------------------------------------------
# per-host attribution: priority interval sweep + explicit remainder
# ----------------------------------------------------------------------
def _join_events(evs: List[dict]):
    """The cid joins the attribution sits on: ``(dispatches, syncs,
    compile_iv, pairs)`` where ``pairs[id(sync)]`` is the dispatch whose
    root set contains the sync's cid, and ``compile_iv`` maps ``id(dispatch)``
    to its cid-joined compile start."""
    dispatches = [e for e in evs if e.get("kind") == "dispatch" and _finite(e.get("ts")) is not None]
    syncs = [e for e in evs if e.get("kind") == "blocking_sync" and _finite(e.get("ts")) is not None]
    by_cid: Dict[Any, dict] = {}
    for d in dispatches:
        cids = d.get("cids") or ([d["cid"]] if d.get("cid") is not None else [])
        for cid in cids:
            by_cid[cid] = d  # last dispatch wins, matching telemetry.async_pairs
    pairs: Dict[int, dict] = {}
    for s in syncs:
        d = by_cid.get(s.get("cid"))
        if d is not None:
            pairs[id(s)] = d
    compile_iv: Dict[int, float] = {}
    for c in evs:
        if c.get("kind") != "compile" or c.get("cid") is None:
            continue
        cts = _finite(c.get("ts"))
        if cts is None:
            continue
        best = None
        for d in dispatches:
            cids = d.get("cids") or ([d["cid"]] if d.get("cid") is not None else [])
            if c["cid"] in cids and d["ts"] >= cts and (best is None or d["ts"] < best["ts"]):
                best = d
        if best is not None:
            prev = compile_iv.get(id(best))
            compile_iv[id(best)] = cts if prev is None else min(prev, cts)
    return dispatches, syncs, compile_iv, pairs


def _attribute_host(evs: List[dict]) -> Dict[str, Any]:
    """One host's attribution: bucket seconds, labeled segments, per-program
    totals, per-chain dispatch/sync counts, and the window bounds."""
    stamps = [
        t for e in evs for t in (_finite(e.get("ts")),) if t is not None
    ]
    if not stamps:
        return {"window": (0.0, 0.0), "buckets": {}, "segments": [],
                "per_program": {}, "chains": [], "unattributed_s": 0.0}
    dispatches, syncs, compile_iv, pairs = _join_events(evs)
    w0 = min(stamps)
    w1 = max(stamps)
    for s in syncs:
        dur = _finite(s.get("dur"))
        if dur is not None and dur >= 0:
            w1 = max(w1, s["ts"] + dur)

    # labeled candidate intervals: (start, end, bucket, program, cid)
    intervals: List[Tuple[float, float, str, Optional[str], Any]] = []

    def add(a, b, bucket, program=None, cid=None):
        a, b = max(a, w0), min(b, w1)
        if b > a:
            intervals.append((a, b, bucket, program, cid))

    # dispatch in-flight spans: dispatch -> last joined sync end; a dispatch
    # with no joined sync keeps the device "not provably idle" to window end
    inflight: Dict[int, float] = {}
    for s in syncs:
        d = pairs.get(id(s))
        if d is None:
            continue
        dur = _finite(s.get("dur")) or 0.0
        end = s["ts"] + max(dur, 0.0)
        inflight[id(d)] = max(inflight.get(id(d), d["ts"]), end)
    for d in dispatches:
        end = inflight.get(id(d), w1)
        add(d["ts"], end, "host_async", d.get("program"), d.get("cid"))

    # compile: cid-joined [compile.ts -> dispatch.ts]
    for d in dispatches:
        cts = compile_iv.get(id(d))
        if cts is not None:
            add(cts, d["ts"], "compile", d.get("program"), d.get("cid"))

    # blocking syncs: split at the joined dispatch stamp
    for s in syncs:
        dur = _finite(s.get("dur"))
        if dur is None or dur < 0:
            continue  # unstamped sync: zero-width, nothing to attribute
        s0, s1 = s["ts"], s["ts"] + dur
        d = pairs.get(id(s))
        where = s.get("where")
        if where == "collective":
            add(s0, s1, "collective", None if d is None else d.get("program"), s.get("cid"))
        elif d is None:
            add(s0, s1, "sync_wait", None, s.get("cid"))
        else:
            split = min(max(d["ts"], s0), s1)
            add(s0, split, "dispatch_queue", d.get("program"), s.get("cid"))
            add(split, s1, "device_execute", d.get("program"), s.get("cid"))

    # priority sweep: every elementary segment takes its highest-priority
    # active label; uncovered segments are host_gap (device provably idle)
    bounds = sorted({w0, w1, *(p for iv in intervals for p in iv[:2])})
    segments: List[dict] = []
    buckets: Dict[str, float] = {}
    for a, b in zip(bounds, bounds[1:]):
        if b <= a:
            continue
        mid = (a + b) / 2.0
        best = ("host_gap", None, None)
        best_p = _BUCKET_PRIORITY["host_gap"]
        for s0, s1, bucket, program, cid in intervals:
            if s0 <= mid < s1 and _BUCKET_PRIORITY[bucket] > best_p:
                best = (bucket, program, cid)
                best_p = _BUCKET_PRIORITY[bucket]
        bucket, program, cid = best
        buckets[bucket] = buckets.get(bucket, 0.0) + (b - a)
        if segments and segments[-1]["bucket"] == bucket \
                and segments[-1]["program"] == program and segments[-1]["cid"] == cid \
                and abs(segments[-1]["end"] - a) < 1e-12:
            segments[-1]["end"] = b
        else:
            segments.append({"start": a, "end": b, "bucket": bucket,
                             "program": program, "cid": cid})

    window_s = w1 - w0
    unattributed = max(0.0, window_s - sum(buckets.values()))

    per_program: Dict[str, Dict[str, Any]] = {}
    for seg in segments:
        if seg["program"] is None or seg["bucket"] not in _BLOCKING_BUCKETS:
            continue
        rec = per_program.setdefault(
            str(seg["program"]),
            {b: 0.0 for b in _BLOCKING_BUCKETS} | {"dispatches": 0, "syncs": 0},
        )
        rec[seg["bucket"]] += seg["end"] - seg["start"]
    for d in dispatches:
        if d.get("program") is not None:
            rec = per_program.setdefault(
                str(d["program"]),
                {b: 0.0 for b in _BLOCKING_BUCKETS} | {"dispatches": 0, "syncs": 0},
            )
            rec["dispatches"] += 1
    for s in syncs:
        d = pairs.get(id(s))
        if d is not None and d.get("program") is not None:
            per_program[str(d["program"])]["syncs"] += 1

    chains = []
    for d in dispatches:
        joined = [s for s in syncs if pairs.get(id(s)) is d]
        chains.append({
            "cid": d.get("cid"),
            "program": d.get("program"),
            "roots": d.get("roots"),
            "dispatches": 1,
            "syncs": len(joined),
            "compiled": id(d) in compile_iv,
        })

    return {"window": (w0, w1), "buckets": buckets, "segments": segments,
            "per_program": per_program, "chains": chains,
            "unattributed_s": unattributed}


# ----------------------------------------------------------------------
# critical path: longest serialized chain of blocking segments
# ----------------------------------------------------------------------
def _critical_path(segments: List[dict]) -> Dict[str, Any]:
    """Longest-duration chain of non-overlapping blocking segments, by
    dynamic programming over end-sorted segments. On a single-threaded host
    the blocking segments are already serial, so this degenerates to "all of
    them" — the DP guards the merged/adversarial cases where reconstructed
    intervals overlap."""
    blocking = [s for s in segments if s["bucket"] in _BLOCKING_BUCKETS]
    blocking.sort(key=lambda s: (s["end"], s["start"]))
    n = len(blocking)
    if not n:
        return {"total_s": 0.0, "sync_pct": 0.0, "steps": [], "truncated": 0}
    ends = [s["end"] for s in blocking]
    best = [0.0] * n
    prev = [-1] * n
    # prefix maxima over best[0..i]: segments that fit before seg i form a
    # PREFIX of the end-sorted order, so the best predecessor is one lookup
    pref_best = [0.0] * n
    pref_arg = [0] * n
    for i, seg in enumerate(blocking):
        dur = seg["end"] - seg["start"]
        best[i] = dur
        j = bisect.bisect_right(ends, seg["start"] + 1e-9, hi=i) - 1
        if j >= 0 and pref_best[j] > 0.0:
            best[i] = pref_best[j] + dur
            prev[i] = pref_arg[j]
        if i == 0 or best[i] > pref_best[i - 1]:
            pref_best[i] = best[i]
            pref_arg[i] = i
        else:
            pref_best[i] = pref_best[i - 1]
            pref_arg[i] = pref_arg[i - 1]
    i = max(range(n), key=lambda k: best[k])
    path = []
    while i >= 0:
        path.append(blocking[i])
        i = prev[i]
    path.reverse()
    total = sum(s["end"] - s["start"] for s in path)
    synced = sum(
        s["end"] - s["start"] for s in path
        if s["bucket"] in ("device_execute", "collective", "sync_wait")
    )
    steps = [
        {
            "bucket": s["bucket"],
            "dur_s": round(s["end"] - s["start"], 6),
            "program": s["program"],
            "cid": s["cid"],
        }
        for s in path
    ]
    truncated = max(0, len(steps) - _MAX_PATH_STEPS)
    if truncated:
        steps = sorted(steps, key=lambda s: -s["dur_s"])[:_MAX_PATH_STEPS]
    return {
        "total_s": round(total, 6),
        "sync_pct": round(100.0 * synced / total, 2) if total > 0 else 0.0,
        "steps": steps,
        "truncated": truncated,
    }


# ----------------------------------------------------------------------
# cross-host straggler / clock-skew attribution
# ----------------------------------------------------------------------
def _median(xs: List[float]) -> float:
    xs = sorted(xs)
    n = len(xs)
    return xs[n // 2] if n % 2 else (xs[n // 2 - 1] + xs[n // 2]) / 2.0


def _stragglers(hosts: Dict[int, List[dict]], straggler_s: float) -> Dict[str, Any]:
    """Per-host clock offset + arrival skew from matched collective events.

    Matching is per (event kind, op, occurrence index) — the k-th allreduce
    on host A pairs with the k-th on host B. Occurrence matching (rather
    than the parity checker's per-cid keys) survives cid drift between
    independently-recorded hosts; under SPMD every host records the same
    collective sequence, so occurrence IS identity. The clock offset is the
    median arrival delta over the EARLIEST quarter of matched keys (a
    straggler's lag accumulates, so late keys would contaminate the offset);
    the residual per-key lag after offset correction names the straggler."""
    arrivals: Dict[int, Dict[tuple, float]] = {}
    for pid, evs in hosts.items():
        seen: Dict[tuple, int] = {}
        table: Dict[tuple, float] = {}
        for ev in evs:
            if ev.get("kind") not in ("collective", "fused_collective"):
                continue
            ts = _finite(ev.get("ts"))
            if ts is None:
                continue
            base = (ev["kind"], str(ev.get("op")))
            k = seen.get(base, 0)
            seen[base] = k + 1
            table[base + (k,)] = ts
        arrivals[pid] = table
    pids = sorted(arrivals)
    doc: Dict[str, Any] = {
        "hosts": len(pids), "matched_collectives": 0,
        "offsets_ms": {}, "lag_ms": {}, "straggler": None, "max_skew_ms": 0.0,
    }
    if len(pids) < 2:
        return doc
    shared = set(arrivals[pids[0]])
    for pid in pids[1:]:
        shared &= set(arrivals[pid])
    if len(shared) < _MIN_MATCHED_COLLECTIVES:
        return doc
    ref = pids[0]
    keys = sorted(shared, key=lambda k: arrivals[ref][k])
    early = keys[: max(_MIN_MATCHED_COLLECTIVES, len(keys) // 4)]
    offsets = {
        pid: _median([arrivals[pid][k] - arrivals[ref][k] for k in early])
        for pid in pids
    }
    lag: Dict[int, float] = {pid: 0.0 for pid in pids}
    max_skew = 0.0
    for k in keys:
        corrected = {pid: arrivals[pid][k] - offsets[pid] for pid in pids}
        first = min(corrected.values())
        last = max(corrected.values())
        max_skew = max(max_skew, last - first)
        for pid in pids:
            lag[pid] = max(lag[pid], corrected[pid] - first)
    worst = max(pids, key=lambda p: lag[p])
    doc.update(
        matched_collectives=len(keys),
        offsets_ms={str(p): round(offsets[p] * 1e3, 3) for p in pids},
        lag_ms={str(p): round(lag[p] * 1e3, 3) for p in pids},
        max_skew_ms=round(max_skew * 1e3, 3),
    )
    if lag[worst] >= straggler_s:
        doc["straggler"] = worst
    return doc


# ----------------------------------------------------------------------
# anti-pattern detectors
# ----------------------------------------------------------------------
def _detect(hosts, per_host, straggle, params) -> List[Finding]:
    findings: List[Finding] = []
    for pid in sorted(hosts):
        evs = hosts[pid]
        ana = per_host[pid]
        findings.extend(_detect_sync_storm(pid, evs, params))
        findings.extend(_detect_retrace_storm(pid, evs, params))
        findings.extend(_detect_reshard_pingpong(pid, evs))
        findings.extend(_detect_idle_gaps(pid, ana, params))
        findings.extend(_detect_numeric(pid, evs))
    if straggle.get("straggler") is not None:
        pid = straggle["straggler"]
        findings.append(Finding(
            rule="tracelens.straggler",
            severity="warning",
            message=(
                f"host {pid} trails its peers by up to "
                f"{straggle['lag_ms'][str(pid)]:g}ms at matched collectives "
                f"({straggle['matched_collectives']} matched, clock offsets "
                "removed) — every collective waits for the slowest arrival"
            ),
            hint="profile host {} alone: look for input-pipeline stalls, cpu "
                 "contention, or thermal throttling on that worker".format(pid),
            host=pid,
            data={"lag_ms": straggle["lag_ms"], "offsets_ms": straggle["offsets_ms"]},
        ))
    return findings


def _detect_sync_storm(pid, evs, params) -> List[Finding]:
    """>K blocking syncs inside one span instance (or any rolling window
    when no spans bound the loop): a host read per iteration of a loop."""
    k = params["sync_storm_k"]
    syncs = sorted(
        (e["ts"] for e in evs
         if e.get("kind") == "blocking_sync" and _finite(e.get("ts")) is not None),
    )
    findings = []
    # span instances: begin/end pairs per name, a stack per name
    stacks: Dict[str, List[float]] = {}
    spans: List[Tuple[str, float, float]] = []
    for e in sorted(evs, key=lambda e: _finite(e.get("ts")) or 0.0):
        if e.get("kind") == "span_begin":
            stacks.setdefault(str(e.get("name")), []).append(e["ts"])
        elif e.get("kind") == "span_end":
            stack = stacks.get(str(e.get("name")))
            if stack:
                spans.append((str(e.get("name")), stack.pop(), e["ts"]))
    flagged = False
    for name, a, b in spans:
        inside = sum(1 for t in syncs if a <= t <= b)
        if inside > k:
            flagged = True
            findings.append(Finding(
                rule="tracelens.sync_storm", severity="warning",
                message=f"{inside} blocking syncs inside one '{name}' span "
                        f"(threshold {k}) on host {pid} — the host serializes "
                        "on the device once per iteration",
                hint="batch the reads: keep values deferred across the loop "
                     "and read once after it, or use ht.tracelens to confirm "
                     "which boundary forces",
                host=pid, data={"span": name, "syncs": inside},
            ))
    if not flagged and len(syncs) > k:
        # no span bounds the loop: a rolling time window catches the storm
        w = params["sync_storm_window_s"]
        lo = 0
        for hi in range(len(syncs)):
            while syncs[hi] - syncs[lo] > w:
                lo += 1
            if hi - lo + 1 > k:
                findings.append(Finding(
                    rule="tracelens.sync_storm", severity="warning",
                    message=f"{hi - lo + 1} blocking syncs within {w:g}s on "
                            f"host {pid} (threshold {k}) — per-element reads "
                            "are forcing chain after chain",
                    hint="hoist reads out of the loop or read whole arrays "
                         "(.numpy()) instead of items",
                    host=pid, data={"syncs": hi - lo + 1, "window_s": w},
                ))
                break
    return findings


def _detect_retrace_storm(pid, evs, params) -> List[Finding]:
    """One op family paying compile after compile inside the window —
    shape churn defeating the program cache, seen from the trace side."""
    counts: Dict[str, int] = {}
    for e in evs:
        if e.get("kind") != "compile":
            continue
        fam = str(e.get("family") or e.get("label") or e.get("program") or "?")
        counts[fam] = counts.get(fam, 0) + 1
    return [
        Finding(
            rule="tracelens.retrace_storm", severity="warning",
            message=f"op family {fam} compiled {n} times inside the analyzed "
                    f"window on host {pid} — shape churn is defeating the "
                    "program cache",
            hint="pad or bucket the varying dimension (see RetraceWarning); "
                 "every miss pays a fresh program build",
            host=pid, data={"family": fam, "compiles": n},
        )
        for fam, n in sorted(counts.items())
        if n > params["retrace_k"]
    ]


def _detect_reshard_pingpong(pid, evs) -> List[Finding]:
    """Alternating A→B→A reshards in one cid lineage: bytes moved twice to
    end where they started. The fusion layer stamps the target split as the
    reshard node's ``detail``."""
    findings = []
    trail: List[Tuple[Any, Any]] = []  # (cid, target-detail), in ts order
    for e in sorted(
        (e for e in evs if e.get("kind") == "fused_collective"
         and str(e.get("op", "")).startswith("reshard")),
        key=lambda e: _finite(e.get("ts")) or 0.0,
    ):
        trail.append((e.get("cid"), e.get("detail")))
    for i in range(len(trail) - 2):
        (c0, d0), (c1, d1), (c2, d2) = trail[i], trail[i + 1], trail[i + 2]
        if d0 is None or d1 is None:
            continue
        if d0 == d2 and d0 != d1:
            findings.append(Finding(
                rule="tracelens.reshard_pingpong", severity="warning",
                message=f"reshard ping-pong on host {pid}: split {d0} -> {d1} "
                        f"-> {d0} across cids {c0}/{c1}/{c2} — the second hop "
                        "undoes the first",
                hint="keep the intermediate computation on the first layout, "
                     "or record the op between the reshards into one program "
                     "so that one collective moves the data",
                host=pid, data={"targets": [d0, d1, d2], "cids": [c0, c1, c2]},
            ))
            break  # one finding per host; the trail names the first instance
    return findings


#: drift above this many ULPs in a ``numeric`` drift event becomes a
#: finding, as core/numlens.py's default HEAT_TPU_NUMLENS_MAX_ULP
_NUMERIC_DRIFT_ULP = 16


def _detect_numeric(pid, evs) -> List[Finding]:
    """Numerics-lens events on the timeline (``core/numlens.py``,
    HEAT_TPU_NUMLENS): an ``sdc`` canary mismatch is always an error — the
    named device returned wrong bits; a shadow-replay ``drift`` event past
    the ULP threshold is a warning. Plain ``stats`` samples never produce
    findings (a clean instrumented workload stays finding-free)."""
    findings: List[Finding] = []
    sick: Dict[str, int] = {}
    worst_drift = None
    for e in evs:
        if e.get("kind") != "numeric":
            continue
        what = e.get("event")
        if what == "sdc":
            dev = str(e.get("device"))
            sick[dev] = sick.get(dev, 0) + 1
        elif what == "drift":
            ulp = e.get("max_ulp") or 0
            if ulp > _NUMERIC_DRIFT_ULP and (
                worst_drift is None or ulp > worst_drift.get("max_ulp", 0)
            ):
                worst_drift = dict(e)
    for dev, n in sorted(sick.items()):
        findings.append(Finding(
            rule="tracelens.sdc",
            severity="error",
            message=f"SDC sentinel flagged device {dev} on host {pid} "
                    f"{n} time(s): the determinism canary returned wrong "
                    "bits — silent data corruption, not a software bug",
            hint="quarantine the device (resilience.note_device_fault has "
                 "already been fed; three strikes shrink the mesh) and "
                 "re-run the canary after a swap",
            host=pid,
            data={"device": dev, "hits": n},
        ))
    if worst_drift is not None:
        findings.append(Finding(
            rule="tracelens.numeric_drift",
            severity="warning",
            message=f"fused program {worst_drift.get('program')} drifted "
                    f"{worst_drift.get('max_ulp')} ULP from its bitwise "
                    f"eager replay on host {pid} — the fused reorder left "
                    "float tolerance",
            hint="inspect the op family ({}); consider HEAT_TPU_FUSION=0 "
                 "for this chain or widen the accumulation dtype".format(
                     worst_drift.get("family")),
            host=pid,
            data={"program": worst_drift.get("program"),
                  "max_ulp": worst_drift.get("max_ulp")},
        ))
    return findings


def _detect_idle_gaps(pid, ana, params) -> List[Finding]:
    """host_gap segments: the device is provably idle (nothing in flight)
    while the host computes — dead time a pipeline would fill."""
    gap_s = params["idle_gap_ms"] / 1e3
    w0, w1 = ana["window"]
    window = max(w1 - w0, 1e-12)
    gaps = [s for s in ana["segments"]
            if s["bucket"] == "host_gap" and s["end"] - s["start"] >= gap_s]
    if not gaps:
        return []
    total = ana["buckets"].get("host_gap", 0.0)
    pct = 100.0 * total / window
    worst = max(gaps, key=lambda s: s["end"] - s["start"])
    return [Finding(
        rule="tracelens.device_idle",
        severity="warning" if pct >= params["idle_gap_pct"] else "info",
        message=f"device idle {pct:.1f}% of the window on host {pid} "
                f"({len(gaps)} gap(s) >= {params['idle_gap_ms']:g}ms, worst "
                f"{(worst['end'] - worst['start']) * 1e3:.1f}ms) — no dispatch "
                "in flight while the host runs",
        hint="overlap host work with device work: dispatch before the python "
             "section, or pipeline input preparation",
        host=pid,
        data={"gaps": len(gaps), "host_gap_pct": round(pct, 2),
              "worst_ms": round((worst["end"] - worst["start"]) * 1e3, 3)},
    )]


# ----------------------------------------------------------------------
# the public entry points
# ----------------------------------------------------------------------
def analyze(
    source=None,
    *,
    allow_partial: bool = False,
    sync_storm_k: Optional[int] = None,
    retrace_k: Optional[int] = None,
    idle_gap_ms: Optional[float] = None,
    idle_gap_pct: Optional[float] = None,
    straggler_ms: Optional[float] = None,
    sync_storm_window_s: Optional[float] = None,
) -> Dict[str, Any]:
    """Analyze a trace window into the four-part diagnosis.

    ``source``: None (live ``telemetry`` state — requires
    ``HEAT_TPU_TELEMETRY=verbose`` to have been recording), a raw event list
    (``telemetry.events()`` / the flight ring), a Chrome trace document, or
    a path to an ``export_trace``/``merge_traces`` file.

    Refuses a window with dropped events (:class:`TraceIncompleteError`)
    unless ``allow_partial=True`` — attribution over a truncated window
    would silently lie; partial analyses carry ``partial: true`` and a
    ``tracelens.partial`` finding. Pure post-hoc: never forces a chain,
    never initializes CUDA."""
    params = {
        "sync_storm_k": _SYNC_STORM_K if sync_storm_k is None else int(sync_storm_k),
        "retrace_k": _RETRACE_STORM_K if retrace_k is None else int(retrace_k),
        "idle_gap_ms": _IDLE_GAP_MS if idle_gap_ms is None else float(idle_gap_ms),
        "idle_gap_pct": _IDLE_GAP_PCT if idle_gap_pct is None else float(idle_gap_pct),
        "sync_storm_window_s": (
            _SYNC_STORM_WINDOW_S if sync_storm_window_s is None else float(sync_storm_window_s)
        ),
    }
    straggler_s = (_STRAGGLER_MS if straggler_ms is None else float(straggler_ms)) / 1e3
    hosts, dropped, src = _normalize(source)
    if not hosts:
        raise ValueError(
            "no events to analyze — record with HEAT_TPU_TELEMETRY=verbose "
            "and export_trace(), or pass a trace file"
        )
    if dropped > 0 and not allow_partial:
        raise TraceIncompleteError(
            f"{dropped} event(s) were dropped past the timeline cap; the "
            "window is incomplete and attribution over it would lie — raise "
            "HEAT_TPU_TELEMETRY_EVENTS or pass allow_partial=True/"
            "--allow-partial to analyze the surviving suffix anyway"
        )

    per_host = {pid: _attribute_host(evs) for pid, evs in hosts.items()}
    window_total = sum(
        max(ana["window"][1] - ana["window"][0], 0.0) for ana in per_host.values()
    )
    overall: Dict[str, float] = {}
    unattributed = 0.0
    for ana in per_host.values():
        unattributed += ana["unattributed_s"]
        for bucket, secs in ana["buckets"].items():
            overall[bucket] = overall.get(bucket, 0.0) + secs

    def _pct(s: float) -> float:
        return round(100.0 * s / window_total, 3) if window_total > 0 else 0.0

    per_program: Dict[str, Dict[str, Any]] = {}
    for ana in per_host.values():
        for key, rec in ana["per_program"].items():
            dst = per_program.setdefault(
                key, {b: 0.0 for b in _BLOCKING_BUCKETS} | {"dispatches": 0, "syncs": 0}
            )
            for b in _BLOCKING_BUCKETS:
                dst[b] = round(dst[b] + rec[b], 6)
            dst["dispatches"] += rec["dispatches"]
            dst["syncs"] += rec["syncs"]

    # critical path: the longest chain among hosts (each host is serial; the
    # slowest host's serialized chain bounds the job)
    paths = {pid: _critical_path(ana["segments"]) for pid, ana in per_host.items()}
    crit_pid = max(paths, key=lambda p: paths[p]["total_s"]) if paths else 0
    critical = dict(paths[crit_pid], host=crit_pid)

    straggle = _stragglers(hosts, straggler_s)
    findings = _detect(hosts, per_host, straggle, params)
    if dropped > 0:
        findings.insert(0, Finding(
            rule="tracelens.partial", severity="info",
            message=f"analysis over a TRUNCATED window: {dropped} event(s) "
                    "dropped past the timeline cap — buckets undercount "
                    "anything that happened before the surviving suffix",
            hint="raise HEAT_TPU_TELEMETRY_EVENTS (or the flight ring cap) "
                 "and re-record",
        ))
    sev_rank = {"error": 0, "warning": 1, "info": 2}
    findings.sort(key=lambda f: (sev_rank.get(f.severity, 3), f.rule))

    chains = [c for ana in per_host.values() for c in ana["chains"]]
    return {
        "schema": SCHEMA,
        "source": src,
        "partial": dropped > 0,
        "events_dropped": dropped,
        "hosts": len(hosts),
        "events": sum(len(evs) for evs in hosts.values()),
        "window_s": round(window_total, 6),
        "attribution": {
            "overall": {
                b: {"s": round(s, 6), "pct": _pct(s)} for b, s in sorted(overall.items())
            },
            "per_host": {
                str(pid): {
                    "window_s": round(ana["window"][1] - ana["window"][0], 6),
                    "buckets": {b: round(s, 6) for b, s in sorted(ana["buckets"].items())},
                    "unattributed_s": round(ana["unattributed_s"], 6),
                }
                for pid, ana in sorted(per_host.items())
            },
            "per_program": per_program,
            "unattributed_s": round(unattributed, 6),
            "unattributed_pct": _pct(unattributed),
        },
        "critical_path": critical,
        "chains": chains,
        "stragglers": straggle,
        "findings": [f.as_dict() for f in findings],
    }


def load_analysis(path: str) -> Dict[str, Any]:
    """An analysis document from disk: a saved :func:`analyze` output is
    returned as-is, a trace file is analyzed first (``allow_partial`` — the
    baseline side of a diff tolerates truncation)."""
    with open(path) as fh:
        doc = json.load(fh)
    if isinstance(doc, dict) and "attribution" in doc and "findings" in doc:
        return doc
    return analyze(doc if not isinstance(doc, dict) or "traceEvents" in doc else doc,
                   allow_partial=True)


# ----------------------------------------------------------------------
# diff: bucket shifts, new findings, critical-path growth
# ----------------------------------------------------------------------
#: regression thresholds for ``analyze --against``
_DIFF_UNATTRIBUTED_PTS = 2.0   # unattributed share may grow this much (pts)
_DIFF_PATH_GROWTH_PCT = 50.0   # critical-path growth that counts as regression


def diff(old: Dict[str, Any], new: Dict[str, Any]) -> Dict[str, Any]:
    """Compare two analyses: per-bucket percentage-point shifts, findings
    that appeared, and critical-path growth. ``regressions`` is the
    CLI-gating list — new warning/error findings, an unattributed share that
    grew past {u} points, or a critical path that grew past {p}%.""".format(
        u=_DIFF_UNATTRIBUTED_PTS, p=_DIFF_PATH_GROWTH_PCT
    )
    shifts: Dict[str, float] = {}
    oa = (old.get("attribution") or {}).get("overall") or {}
    na = (new.get("attribution") or {}).get("overall") or {}
    for bucket in sorted(set(oa) | set(na)):
        d = (na.get(bucket, {}).get("pct", 0.0) or 0.0) - (oa.get(bucket, {}).get("pct", 0.0) or 0.0)
        if abs(d) >= 0.01:
            shifts[bucket] = round(d, 3)
    old_keys = {(f.get("rule"), f.get("host")) for f in old.get("findings", [])}
    new_findings = [
        f for f in new.get("findings", [])
        if (f.get("rule"), f.get("host")) not in old_keys
    ]
    regressions: List[str] = []
    for f in new_findings:
        if f.get("severity") in ("error", "warning"):
            regressions.append(f"new {f['severity']} finding: {f['rule']} — {f['message']}")
    ou = (old.get("attribution") or {}).get("unattributed_pct", 0.0) or 0.0
    nu = (new.get("attribution") or {}).get("unattributed_pct", 0.0) or 0.0
    if nu - ou > _DIFF_UNATTRIBUTED_PTS:
        regressions.append(
            f"unattributed time grew {ou:g}% -> {nu:g}% "
            f"(> {_DIFF_UNATTRIBUTED_PTS:g} points): the accounting lost coverage"
        )
    op = (old.get("critical_path") or {}).get("total_s", 0.0) or 0.0
    np_ = (new.get("critical_path") or {}).get("total_s", 0.0) or 0.0
    growth = (100.0 * (np_ - op) / op) if op > 0 else 0.0
    if op > 0 and growth > _DIFF_PATH_GROWTH_PCT:
        regressions.append(
            f"critical path grew {op:g}s -> {np_:g}s (+{growth:.0f}%, "
            f"> {_DIFF_PATH_GROWTH_PCT:g}%)"
        )
    return {
        "bucket_shifts_pts": shifts,
        "new_findings": new_findings,
        "critical_path_growth_pct": round(growth, 2),
        "regressions": regressions,
        "ok": not regressions,
    }


# ----------------------------------------------------------------------
# rendering: the one-page diagnosis
# ----------------------------------------------------------------------
def render(analysis: Dict[str, Any]) -> str:
    """The one-page human diagnosis of an :func:`analyze` result — the text
    the CLI prints and flight-recorder bundles embed."""
    lines: List[str] = []
    att = analysis.get("attribution") or {}
    window = analysis.get("window_s", 0.0)
    head = (
        f"trace window: {window * 1e3:.1f}ms over {analysis.get('hosts', 0)} host(s), "
        f"{analysis.get('events', 0)} events"
    )
    if analysis.get("partial"):
        head += f"  [PARTIAL: {analysis.get('events_dropped')} events dropped]"
    lines.append(head)
    lines.append("time attribution:")
    overall = att.get("overall") or {}
    for bucket, rec in sorted(overall.items(), key=lambda kv: -kv[1].get("s", 0.0)):
        lines.append(f"  {bucket:<16} {rec.get('s', 0.0) * 1e3:9.2f}ms  {rec.get('pct', 0.0):6.2f}%")
    lines.append(
        f"  {'unattributed':<16} {att.get('unattributed_s', 0.0) * 1e3:9.2f}ms  "
        f"{att.get('unattributed_pct', 0.0):6.2f}%"
    )
    crit = analysis.get("critical_path") or {}
    lines.append(
        f"critical path (host {crit.get('host', 0)}): {crit.get('total_s', 0.0) * 1e3:.2f}ms, "
        f"{crit.get('sync_pct', 0.0):g}% waiting on the device, "
        f"{len(crit.get('steps') or [])} step(s)"
    )
    for step in (crit.get("steps") or [])[:8]:
        prog = f"  [{step['program']}]" if step.get("program") else ""
        lines.append(
            f"  {step['bucket']:<16} {step['dur_s'] * 1e3:9.2f}ms  cid={step.get('cid')}{prog}"
        )
    per_prog = att.get("per_program") or {}
    if per_prog:
        lines.append("per-program (blocking seconds):")
        ranked = sorted(
            per_prog.items(),
            key=lambda kv: -sum(kv[1].get(b, 0.0) for b in _BLOCKING_BUCKETS),
        )
        for key, rec in ranked[:5]:
            busy = sum(rec.get(b, 0.0) for b in _BLOCKING_BUCKETS)
            lines.append(
                f"  {key:<18} {busy * 1e3:9.2f}ms  x{rec.get('dispatches', 0)} dispatches "
                f"/ {rec.get('syncs', 0)} syncs  (compile {rec.get('compile', 0.0) * 1e3:.1f}ms)"
            )
    strag = analysis.get("stragglers") or {}
    if strag.get("hosts", 0) >= 2:
        who = strag.get("straggler")
        verdict = f"host {who} STRAGGLES" if who is not None else "no straggler"
        lines.append(
            f"cross-host: {verdict} (lag {strag.get('lag_ms')}, offsets "
            f"{strag.get('offsets_ms')}, {strag.get('matched_collectives', 0)} "
            "matched collectives)"
        )
    findings = analysis.get("findings") or []
    if findings:
        lines.append(f"findings ({len(findings)}):")
        for f in findings:
            lines.append(f"  [{f.get('severity', '?'):<7}] {f.get('rule')}: {f.get('message')}")
            if f.get("hint"):
                lines.append(f"            fix: {f['hint']}")
    else:
        lines.append("findings: none — nothing structural bounds this window")
    return "\n".join(lines)


def diagnose(events: List[dict], **kwargs) -> Dict[str, Any]:
    """The flight-recorder one-pager: analyze a raw event ring (always
    ``allow_partial`` — a ring is a window by construction) and return a
    compact ``{"text", "attribution", "critical_path", "findings", ...}``
    block sized for embedding in a forensics bundle. Never raises — a bundle
    must ship even when the ring holds nothing analyzable."""
    try:
        kwargs.setdefault("allow_partial", True)
        analysis = analyze(list(events), **kwargs)
    except Exception as exc:  # noqa: BLE001 - forensics must never fail the dump
        return {"error": repr(exc)}
    crit = dict(analysis["critical_path"])
    crit["steps"] = crit.get("steps", [])[:10]
    return {
        "text": render(analysis),
        "window_s": analysis["window_s"],
        "attribution": analysis["attribution"]["overall"],
        "unattributed_pct": analysis["attribution"]["unattributed_pct"],
        "critical_path": crit,
        "stragglers": analysis["stragglers"],
        "findings": analysis["findings"],
    }
