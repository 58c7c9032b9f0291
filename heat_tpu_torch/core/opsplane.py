"""The live ops plane (``ht.opsplane``; reference:
heat_tpu/core/opsplane.py): a streaming metrics registry, an HTTP ops
endpoint from the standard library, and SLO burn-rate alerting over two
windows.

The runtime already measures its latency histograms and SLO windows
(``core/health_runtime.py``), the serving layer's admission and billing
(``core/serving.py``), the memory watermark (``core/memledger.py``), the
numerics lens (``core/numlens.py``) and the program cache
(``core/fusion.py``). This module is a live tap on those same gauges:

**The registry and the sampler.** :func:`collect` projects the gauges into
a flat list of samples ``(name, labels, value)``: counters, gauges and one
log-bucketed latency histogram. A daemon sampler at a fixed cadence
(``HEAT_TPU_OPS_INTERVAL_S``, 2 s) folds every sample into a bounded
time-series registry (:func:`series`, ``HEAT_TPU_OPS_RETAIN`` points per
series). Collection reads module state only: it never forces a pending
chain, never takes ``fusion._FORCE_LOCK`` and never initializes CUDA; the
health tables are copied under ``health_runtime._H_LOCK`` and read after.

**The ops server.** ``HEAT_TPU_OPS_PORT`` (off by default; ``0`` an
ephemeral port) or :func:`serve` arms a ``ThreadingHTTPServer`` on
``HEAT_TPU_OPS_HOST`` (127.0.0.1) with seven routes:

- ``/metrics``, the Prometheus text exposition (``# HELP``/``# TYPE``,
  ``tenant`` and program-``key`` labels),
- ``/healthz``, liveness: the watchdog never tripped, no burn alert firing,
- ``/readyz``, readiness: healthy, the mesh built, admission not saturated,
- ``/debug/report``, the whole ``telemetry.report()`` as JSON,
- ``/debug/trace``, the live timeline's export (``?analyze=1`` runs
  ``tracelens.analyze`` over it),
- ``/debug/flight``, a flight-recorder dump on demand,
- ``/debug/numerics``, the numerics lens's block,

so a serving process can be inspected mid-traffic without touching its
client threads (``/debug/burn`` answers the burn report too). Scrapes run
on the server's daemon threads.

**Burn-rate alerting.** Over the SLO windows ``health_runtime`` keeps,
each sample tagged with its serving session: per metric
(sync/dispatch/compile), per tenant and overall (``tenant="*"``), burn =
(breach fraction in the window) / error budget, the budget being ``1 -
HEAT_TPU_SLO_TARGET``. An alert fires when both the fast window
(``HEAT_TPU_SLO_FAST_S``) and the slow one (``HEAT_TPU_SLO_SLOW_S``) burn
at ``HEAT_TPU_SLO_BURN`` times the sustainable rate or faster, with at
least ``HEAT_TPU_SLO_BURN_MIN`` samples in the fast window. A rising edge
emits an ``slo_burn`` event and a finding (:func:`burn_findings`), a
falling edge ``slo_burn_clear``; :func:`on_burn` subscribers hear both.
``heat_tpu_slo_burn_alert`` exports the state, and a firing alert degrades
``/healthz``.

The metric names keep the reference's ``heat_tpu_`` prefix and its schema
(:data:`SCHEMA`, equal to ``doc/metrics_schema.json``), so a dashboard
built on the reference reads the port. The elastic, autoscale and
multi-process families read ``telemetry``'s hook slots, which
``core/elastic.py``, ``core/autoscale.py`` and ``core/multihost.py`` fill
at import. Malformed knobs warn and disarm, never
fail an import. ``telemetry.reset()`` clears the series, alerts, findings
and scrape counts; the configuration and an armed server stay.
"""

from __future__ import annotations

import json
import math
import os
import re
import threading
import time
import warnings
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional, Tuple

from . import health_runtime, telemetry

__all__ = [
    "collect",
    "render",
    "validate_exposition",
    "schema",
    "sample",
    "series",
    "set_burn",
    "on_burn",
    "burn_report",
    "burn_findings",
    "health_status",
    "ready_status",
    "serve",
    "shutdown",
    "status",
    "reset",
]


# ----------------------------------------------------------------------
# env knobs (warn-and-disarm, the HEAT_TPU_MEMORY_BUDGET convention)
# ----------------------------------------------------------------------
def _env_float(name: str, default: float, lo: float, hi: float) -> float:
    raw = os.environ.get(name)
    if raw is None or not raw.strip():
        return default
    try:
        v = float(raw)
        if not (lo <= v <= hi) or math.isnan(v):
            raise ValueError(f"out of range [{lo}, {hi}]")
        return v
    except ValueError as exc:
        warnings.warn(
            f"{name}={raw!r} is not a valid value ({exc}); "
            f"using the default {default}",
            stacklevel=2,
        )
        return default


def _env_port() -> Optional[int]:
    """``HEAT_TPU_OPS_PORT``: unset/empty = ops server off (the default);
    ``0`` = arm on an ephemeral port; malformed warns and disarms."""
    raw = os.environ.get("HEAT_TPU_OPS_PORT")
    if raw is None or not raw.strip():
        return None
    try:
        port = int(raw)
        if not (0 <= port <= 65535):
            raise ValueError("out of range [0, 65535]")
        return port
    except ValueError as exc:
        warnings.warn(
            f"HEAT_TPU_OPS_PORT={raw!r} is not a valid port ({exc}); "
            "the ops server stays disarmed",
            stacklevel=2,
        )
        return None


_INTERVAL_S = _env_float("HEAT_TPU_OPS_INTERVAL_S", 2.0, 0.05, 3600.0)
_RETAIN = int(_env_float("HEAT_TPU_OPS_RETAIN", 512, 8, 65536))
#: distinct (name, labels) series kept; past the cap new series are dropped
#: and counted — the registry must stay O(1) however hot the label churn
_SERIES_CAP = 4096

# ----------------------------------------------------------------------
# metric-name schema: the exporter contract dashboards pin against.
# doc/metrics_schema.json is the committed copy; tests diff the two so a
# rename/removal fails CI instead of silently breaking a dashboard.
# ----------------------------------------------------------------------
_C, _G, _H = "counter", "gauge", "histogram"
SCHEMA: "OrderedDict[str, Dict[str, Any]]" = OrderedDict(
    [
        # -- ops-plane self metrics ------------------------------------
        ("heat_tpu_up", (_G, "Always 1 while the process is scrapable.", [])),
        ("heat_tpu_mesh_up", (_G, "1 once the device mesh is initialized.", [])),
        ("heat_tpu_ops_samples_total", (_C, "Registry sampler ticks.", [])),
        ("heat_tpu_ops_scrapes_total", (_C, "HTTP scrapes served, by endpoint.", ["endpoint"])),
        ("heat_tpu_ops_scrape_errors_total", (_C, "HTTP scrapes that failed.", [])),
        ("heat_tpu_ops_series", (_G, "Live time-series in the registry.", [])),
        ("heat_tpu_ops_series_dropped_total", (_C, "Series dropped past the registry cap.", [])),
        ("heat_tpu_ops_sample_ms", (_G, "Wall time of the last registry sample tick.", [])),
        # -- telemetry counters ----------------------------------------
        ("heat_tpu_collectives_total", (_C, "Collective operations recorded, by op.", ["op"])),
        ("heat_tpu_timeline_events", (_G, "Telemetry timeline events currently buffered.", [])),
        ("heat_tpu_timeline_events_dropped_total", (_C, "Timeline events dropped past the cap.", [])),
        ("heat_tpu_nonfinite_total", (_C, "Non-finite detections, by kind.", ["kind"])),
        # -- fusion program cache --------------------------------------
        ("heat_tpu_fusion_compiles_total", (_C, "Fused-program compiles (retraces).", [])),
        ("heat_tpu_fusion_hits_total", (_C, "In-memory program-cache hits.", [])),
        ("heat_tpu_fusion_disk_hits_total", (_C, "Persistent-cache warm starts.", [])),
        ("heat_tpu_fusion_forces_total", (_C, "Chain forces.", [])),
        ("heat_tpu_fusion_evictions_total", (_C, "LRU program evictions.", [])),
        ("heat_tpu_fusion_degraded_total", (_C, "Programs degraded to per-op replay.", [])),
        ("heat_tpu_fusion_quarantine_hits_total", (_C, "Forces that skipped a quarantined compile.", [])),
        ("heat_tpu_fusion_cache_size", (_G, "Compiled programs currently cached.", [])),
        ("heat_tpu_fusion_quarantined", (_G, "Program keys currently quarantined.", [])),
        # -- latency (health_runtime histograms; key = program key or
        # sync trigger, LRU-capped at health_runtime._PROGRAM_CAP) ------
        ("heat_tpu_latency_seconds", (_H, "Operation latency, by metric (sync/dispatch/compile).", ["metric"])),
        ("heat_tpu_latency_count_total", (_C, "Latency observations, by metric and key.", ["metric", "key"])),
        ("heat_tpu_latency_p50_ms", (_G, "Rolling p50 latency, by metric and key.", ["metric", "key"])),
        ("heat_tpu_latency_p99_ms", (_G, "Rolling p99 latency, by metric and key.", ["metric", "key"])),
        # -- SLO gauges + burn-rate alerting ---------------------------
        ("heat_tpu_slo_limit_ms", (_G, "Configured SLO limit (absent metric = no SLO).", ["metric"])),
        ("heat_tpu_slo_window_p99_ms", (_G, "p99 over the rolling SLO window.", ["metric"])),
        ("heat_tpu_slo_ok_ratio", (_G, "In-SLO fraction over the rolling window.", ["metric"])),
        ("heat_tpu_slo_breaches_total", (_C, "SLO breaches since reset.", ["metric"])),
        ("heat_tpu_slo_burn_rate", (_G, "Error-budget burn rate, by window (fast/slow).", ["metric", "tenant", "window"])),
        ("heat_tpu_slo_burn_alert", (_G, "1 while the two-window burn alert is firing.", ["metric", "tenant"])),
        ("heat_tpu_slo_burn_alerts_total", (_C, "Burn-alert rising edges.", ["metric", "tenant"])),
        # -- watchdog + flight recorder --------------------------------
        ("heat_tpu_watchdog_trips_total", (_C, "Watchdog deadline trips.", [])),
        ("heat_tpu_watchdog_armed", (_G, "Collectives currently under watchdog guard.", [])),
        ("heat_tpu_flight_events", (_G, "Flight-recorder ring occupancy.", [])),
        ("heat_tpu_flight_dropped_total", (_C, "Flight events dropped past the ring cap.", [])),
        ("heat_tpu_flight_dumps_total", (_C, "Flight bundles written.", [])),
        # -- memory ledger ---------------------------------------------
        ("heat_tpu_mem_watermark_bytes", (_G, "High watermark of sampled live bytes.", [])),
        ("heat_tpu_mem_budget_bytes", (_G, "Resolved memory budget (absent = disarmed).", [])),
        ("heat_tpu_mem_gate_total", (_C, "Admission-gate outcomes, by outcome.", ["outcome"])),
        # -- numerics lens ---------------------------------------------
        ("heat_tpu_numerics_dispatches_sampled_total", (_C, "Dispatches the numerics lens sampled.", [])),
        ("heat_tpu_numerics_findings", (_G, "Open numerics findings.", [])),
        # -- multi-process runtime (lease heartbeats + named barriers) -
        ("heat_tpu_peers_expected", (_G, "Controller processes in the current world.", [])),
        ("heat_tpu_peers_lost", (_G, "Peer processes currently declared lost.", [])),
        ("heat_tpu_peer_heartbeats_total", (_C, "Lease heartbeats written.", [])),
        ("heat_tpu_peer_heartbeat_errors_total", (_C, "Lease beats that failed to write (missed beats).", [])),
        ("heat_tpu_barriers_total", (_C, "Named cross-process barrier waits entered.", [])),
        ("heat_tpu_barrier_timeouts_total", (_C, "Barriers abandoned on timeout (StallError).", [])),
        ("heat_tpu_barrier_threads_abandoned", (_G, "Abandoned barrier daemon threads still alive.", [])),
        # -- elastic supervisor ----------------------------------------
        ("heat_tpu_elastic_total", (_C, "Elastic supervisor events, by event.", ["event"])),
        ("heat_tpu_elastic_downtime_ms_total", (_C, "Cumulative drain-to-restore wall time.", [])),
        # -- serving sessions (tenant = session name) ------------------
        ("heat_tpu_sessions_active", (_G, "Serving sessions currently entered.", [])),
        ("heat_tpu_session_dispatches_total", (_C, "Fused dispatches billed, by tenant.", ["tenant"])),
        ("heat_tpu_session_roots_total", (_C, "Chain roots billed, by tenant.", ["tenant"])),
        ("heat_tpu_session_compiles_total", (_C, "Compiles billed, by tenant.", ["tenant"])),
        ("heat_tpu_session_incidents_total", (_C, "Contained incidents, by tenant and kind.", ["tenant", "kind"])),
        ("heat_tpu_session_admission_waits_total", (_C, "Dispatches that waited for admission, by tenant.", ["tenant"])),
        ("heat_tpu_session_admission_waited_seconds_total", (_C, "Seconds spent waiting for admission, by tenant.", ["tenant"])),
        # -- admission token buckets -----------------------------------
        ("heat_tpu_admission_tokens", (_G, "Projected tokens available, by bucket.", ["bucket"])),
        ("heat_tpu_admission_admitted_total", (_C, "Dispatches admitted, by bucket.", ["bucket"])),
        ("heat_tpu_admission_refused_total", (_C, "Dispatches refused, by bucket.", ["bucket"])),
        # -- autoscale controller ----------------------------------------
        ("heat_tpu_autoscale_armed", (_G, "1 while the autoscale controller is armed.", [])),
        ("heat_tpu_autoscale_shedding", (_G, "1 while tiered load shedding is active.", [])),
        ("heat_tpu_autoscale_mesh_devices", (_G, "Devices in the current (possibly shrunk) mesh.", [])),
        ("heat_tpu_autoscale_mesh_baseline", (_G, "Devices in the full pre-shrink mesh.", [])),
        ("heat_tpu_autoscale_decisions_total", (_C, "Controller decisions, by action.", ["action"])),
        ("heat_tpu_autoscale_shed_refusals_total", (_C, "Dispatches shed from shed-tier sessions.", [])),
    ]
)


def schema() -> Dict[str, Dict[str, Any]]:
    """The exporter contract: ``{name: {"type", "help", "labels"}}`` — the
    committed ``doc/metrics_schema.json`` must equal this exactly."""
    return {
        name: {"type": mtype, "help": help_, "labels": list(labels)}
        for name, (mtype, help_, labels) in SCHEMA.items()
    }


#: serving sessions exported per scrape (newest first) — the tenant-label
#: cardinality cap, mirroring fusion._PROGRAM_INFO's LRU for program keys
_TENANT_CAP = 64

_INCIDENT_KINDS = (
    ("degraded", "degraded"),
    ("quarantine_hits", "quarantine_hit"),
    ("mem_refused", "mem_refused"),
    ("admission_refused", "admission_refused"),
    ("shed", "shed"),
)


# ----------------------------------------------------------------------
# collection: the existing gauges, projected flat. Pure module-state
# reads — never forces a chain, never initializes CUDA; every
# subsystem is wrapped so one broken block never drops the whole scrape.
# ----------------------------------------------------------------------
Sample = Tuple[str, Dict[str, str], float]


def _mesh_up() -> bool:
    """Whether the default mesh exists: a read that builds none."""
    from . import communication

    return communication._built_comm() is not None


def _collect_telemetry(out: List[Sample]) -> None:
    st = telemetry._GLOBAL
    for op, rec in list(st.collectives.items()):
        out.append(("heat_tpu_collectives_total", {"op": str(op)}, float(rec["count"])))
    out.append(("heat_tpu_timeline_events", {}, float(len(st.events))))
    out.append(("heat_tpu_timeline_events_dropped_total", {}, float(st.events_dropped)))
    for kind, n in list(st.nonfinite.items()):
        out.append(("heat_tpu_nonfinite_total", {"kind": str(kind)}, float(n)))


def _collect_fusion(out: List[Sample]) -> None:
    from . import fusion

    stats = fusion.cache_stats()
    for field in (
        "compiles", "hits", "disk_hits", "forces", "evictions", "degraded",
        "quarantine_hits",
    ):
        out.append((f"heat_tpu_fusion_{field}_total", {}, float(stats[field])))
    out.append(("heat_tpu_fusion_cache_size", {}, float(stats["size"])))
    out.append(("heat_tpu_fusion_quarantined", {}, float(stats["quarantined"])))


def _hist_copy(h):
    """A detached copy of one ``health_runtime._Hist`` (under ``_H_LOCK``)."""
    c = health_runtime._Hist()
    c.count, c.total, c.vmin, c.vmax, c.buckets = h.count, h.total, h.vmin, h.vmax, dict(h.buckets)
    return c


def _latency_tables() -> Dict[str, Dict[str, Any]]:
    """The global latency tables, ``{metric: {"*": overall, key: hist}}``,
    copied under ``health_runtime._H_LOCK``: the recording threads fold
    into them under that lock, and a scrape holds it only to copy."""
    st = health_runtime._H_GLOBAL
    with health_runtime._H_LOCK:
        out = {}
        for metric in health_runtime._METRICS:
            tables = {"*": _hist_copy(st.overall[metric])}
            tables.update((key, _hist_copy(h)) for key, h in getattr(st, metric).items())
            out[metric] = tables
    return out


def _collect_health(out: List[Sample]) -> None:
    wd = health_runtime.watchdog_stats()
    out.append(("heat_tpu_watchdog_trips_total", {}, float(wd["trips"])))
    out.append(("heat_tpu_watchdog_armed", {}, float(wd["armed"])))
    fl = health_runtime.flight_stats()
    out.append(("heat_tpu_flight_events", {}, float(fl.get("events", 0))))
    out.append(("heat_tpu_flight_dropped_total", {}, float(fl.get("dropped", 0))))
    out.append(("heat_tpu_flight_dumps_total", {}, float(fl.get("dumps", 0))))
    for metric, tables in _latency_tables().items():
        for key, hist in tables.items():
            if not hist.count:
                continue
            labels = {"metric": metric, "key": str(key)}
            out.append(("heat_tpu_latency_count_total", labels, float(hist.count)))
            out.append(
                ("heat_tpu_latency_p50_ms", labels, round(hist.percentile(50.0) * 1e3, 6))
            )
            out.append(
                ("heat_tpu_latency_p99_ms", labels, round(hist.percentile(99.0) * 1e3, 6))
            )
    slo = health_runtime._slo_block()
    for metric in health_runtime._METRICS:
        entry = slo.get(metric) or {}
        if entry.get("limit_ms") is not None:
            out.append(("heat_tpu_slo_limit_ms", {"metric": metric}, float(entry["limit_ms"])))
        if entry.get("window_p99_ms") is not None:
            out.append(
                ("heat_tpu_slo_window_p99_ms", {"metric": metric}, float(entry["window_p99_ms"]))
            )
        if entry.get("ok_ratio") is not None:
            out.append(("heat_tpu_slo_ok_ratio", {"metric": metric}, float(entry["ok_ratio"])))
        out.append(
            ("heat_tpu_slo_breaches_total", {"metric": metric}, float(entry.get("breaches_total", 0)))
        )


def _collect_memory(out: List[Sample]) -> None:
    from . import memledger

    wm = memledger.watermark()
    out.append(("heat_tpu_mem_watermark_bytes", {}, float(wm["bytes"])))
    info = memledger.budget_info(resolve=False)  # resolve=True probes devices
    if isinstance(info.get("budget_bytes"), int):
        out.append(("heat_tpu_mem_budget_bytes", {}, float(info["budget_bytes"])))
    for outcome in ("checks", "allowed", "exceeded", "warned", "raised", "drains"):
        if outcome in info:
            out.append(("heat_tpu_mem_gate_total", {"outcome": outcome}, float(info[outcome])))


def _collect_numerics(out: List[Sample]) -> None:
    from . import numlens

    out.append(
        ("heat_tpu_numerics_dispatches_sampled_total", {}, float(numlens._SAMPLED))
    )
    out.append(("heat_tpu_numerics_findings", {}, float(len(numlens.findings()))))


def _collect_elastic(out: List[Sample]) -> None:
    # the elastic supervisor's slot on telemetry (core/elastic.py installs it)
    hook = telemetry._ELASTIC_HOOK
    if hook is None:
        return
    stats = hook()
    for event in (
        "preemptions", "reforms", "failed_reforms", "steps_replayed",
        "checkpoints", "drained_roots", "peer_losses",
    ):
        if event in stats:
            out.append(("heat_tpu_elastic_total", {"event": event}, float(stats[event])))
    out.append(("heat_tpu_elastic_downtime_ms_total", {}, float(stats["downtime_ms"])))


def _collect_multihost(out: List[Sample]) -> None:
    # the multi-process runtime's slot on telemetry (core/multihost.py installs it)
    hook = telemetry._MULTIHOST_HOOK
    if hook is None:
        return
    st = hook()
    out.append(("heat_tpu_peers_expected", {}, float(st.get("world", 1))))
    out.append(("heat_tpu_peers_lost", {}, float(len(st.get("peers_lost") or ()))))
    out.append(("heat_tpu_peer_heartbeats_total", {}, float(st.get("heartbeats", 0))))
    out.append(
        ("heat_tpu_peer_heartbeat_errors_total", {}, float(st.get("heartbeat_errors", 0)))
    )
    out.append(("heat_tpu_barriers_total", {}, float(st.get("barriers", 0))))
    out.append(
        ("heat_tpu_barrier_timeouts_total", {}, float(st.get("barrier_timeouts", 0)))
    )
    out.append(
        ("heat_tpu_barrier_threads_abandoned", {}, float(st.get("abandoned_alive", 0)))
    )


def _bucket_tokens(bucket) -> float:
    """A bucket's projected token count WITHOUT taking one: the refill math
    from ``_TokenBucket.take``, read under its lock."""
    with bucket._lock:
        now = time.monotonic()
        return min(bucket.burst, bucket.tokens + (now - bucket.ts) * bucket.rate)


def _bucket_samples(out: List[Sample], name: str, bucket) -> None:
    labels = {"bucket": name}
    out.append(("heat_tpu_admission_tokens", labels, round(_bucket_tokens(bucket), 3)))
    out.append(("heat_tpu_admission_admitted_total", labels, float(bucket.admitted)))
    out.append(("heat_tpu_admission_refused_total", labels, float(bucket.refused)))


def _collect_serving(out: List[Sample]) -> None:
    from . import serving

    with serving._LOCK:
        sessions = list(serving._SESSIONS.values())
        active = serving._ACTIVE
        global_bucket = serving._GLOBAL_BUCKET
    out.append(("heat_tpu_sessions_active", {}, float(active)))
    if global_bucket is not None:
        _bucket_samples(out, "global", global_bucket)
    # newest sessions win the label budget (the tenant-cardinality cap)
    for sess in sessions[-_TENANT_CAP:]:
        tenant = {"tenant": sess.name}
        stats = dict(sess.stats)
        out.append(("heat_tpu_session_dispatches_total", tenant, float(stats["dispatches"])))
        out.append(("heat_tpu_session_roots_total", tenant, float(stats["roots"])))
        out.append(("heat_tpu_session_compiles_total", tenant, float(stats["compiles"])))
        for field, kind in _INCIDENT_KINDS:
            out.append(
                (
                    "heat_tpu_session_incidents_total",
                    {"tenant": sess.name, "kind": kind},
                    float(stats[field]),
                )
            )
        out.append(
            ("heat_tpu_session_admission_waits_total", tenant, float(stats["admission_waits"]))
        )
        out.append(
            (
                "heat_tpu_session_admission_waited_seconds_total",
                tenant,
                round(float(stats["admission_waited_s"]), 6),
            )
        )
        if sess.bucket is not None:
            _bucket_samples(out, f"session:{sess.name}", sess.bucket)


def _collect_autoscale(out: List[Sample]) -> None:
    # the autoscale controller's slot on telemetry (core/autoscale.py installs it)
    hook = telemetry._AUTOSCALE_HOOK
    if hook is None:
        return
    st = hook()
    out.append(("heat_tpu_autoscale_armed", {}, 1.0 if st.get("armed") else 0.0))
    out.append(
        ("heat_tpu_autoscale_shedding", {}, 1.0 if st.get("shedding") else 0.0)
    )
    mesh = st.get("mesh") or {}
    if mesh.get("devices"):
        out.append(("heat_tpu_autoscale_mesh_devices", {}, float(mesh["devices"])))
    if mesh.get("baseline"):
        out.append(("heat_tpu_autoscale_mesh_baseline", {}, float(mesh["baseline"])))
    for action, n in sorted((st.get("decisions") or {}).items()):
        out.append(
            ("heat_tpu_autoscale_decisions_total", {"action": str(action)}, float(n))
        )
    out.append(
        ("heat_tpu_autoscale_shed_refusals_total", {}, float(st.get("shed_refusals", 0)))
    )


def _collect_burn(out: List[Sample]) -> None:
    with _BURN_LOCK:
        for (metric, tenant), row in _ALERTS.items():
            labels = {"metric": metric, "tenant": tenant}
            for window in ("fast", "slow"):
                out.append(
                    (
                        "heat_tpu_slo_burn_rate",
                        dict(labels, window=window),
                        round(row[f"{window}_burn"], 4),
                    )
                )
            out.append(("heat_tpu_slo_burn_alert", labels, 1.0 if row["active"] else 0.0))
            out.append(("heat_tpu_slo_burn_alerts_total", labels, float(row["fired"])))


def _collect_self(out: List[Sample]) -> None:
    out.append(("heat_tpu_up", {}, 1.0))
    out.append(("heat_tpu_mesh_up", {}, 1.0 if _mesh_up() else 0.0))
    out.append(("heat_tpu_ops_samples_total", {}, float(_OPS_STATS["samples"])))
    for endpoint, n in list(_SCRAPES.items()):
        out.append(("heat_tpu_ops_scrapes_total", {"endpoint": endpoint}, float(n)))
    out.append(("heat_tpu_ops_scrape_errors_total", {}, float(_OPS_STATS["scrape_errors"])))
    with _SERIES_LOCK:
        live = len(_SERIES)
    out.append(("heat_tpu_ops_series", {}, float(live)))
    out.append(("heat_tpu_ops_series_dropped_total", {}, float(_OPS_STATS["series_dropped"])))
    out.append(("heat_tpu_ops_sample_ms", {}, float(_OPS_STATS["sample_ms"])))


_COLLECTORS = (
    _collect_self,
    _collect_telemetry,
    _collect_fusion,
    _collect_health,
    _collect_burn,
    _collect_memory,
    _collect_numerics,
    _collect_elastic,
    _collect_serving,
    _collect_autoscale,
    _collect_multihost,
)


def collect() -> List[Sample]:
    """One flat snapshot of every exported gauge: ``(name, labels, value)``
    triples, schema-checked names only. Pure module state: safe from any
    thread, with chains pending, before CUDA is initialized."""
    out: List[Sample] = []
    for collector in _COLLECTORS:
        try:
            collector(out)
        # one broken subsystem must never drop the whole scrape
        except Exception:  # noqa: BLE001
            _OPS_STATS["collect_errors"] += 1
    return out


# ----------------------------------------------------------------------
# the time-series registry + the fixed-cadence sampler
# ----------------------------------------------------------------------
_SERIES: "OrderedDict[Tuple[str, Tuple[Tuple[str, str], ...]], deque]" = OrderedDict()
_SERIES_LOCK = threading.Lock()
_OPS_STATS = {
    "samples": 0,
    "scrape_errors": 0,
    "collect_errors": 0,
    "series_dropped": 0,
    "sample_ms": 0.0,
    "callback_errors": 0,
}
_SCRAPES: Dict[str, int] = {}


def _series_key(name: str, labels: Dict[str, str]) -> Tuple[str, Tuple[Tuple[str, str], ...]]:
    return (name, tuple(sorted(labels.items())))


def sample(now: Optional[float] = None) -> int:
    """One sampler tick: update the burn tracker, collect every gauge and
    fold the values into the bounded time-series registry. Returns the
    number of samples folded. Called at cadence by the daemon sampler and
    by every ``/metrics`` scrape (so alert state is never staler than one
    scrape)."""
    t0 = time.perf_counter()
    _burn_tick(now)
    samples = collect()
    ts = time.time()
    with _SERIES_LOCK:
        for name, labels, value in samples:
            key = _series_key(name, labels)
            dq = _SERIES.get(key)
            if dq is None:
                if len(_SERIES) >= _SERIES_CAP:
                    _OPS_STATS["series_dropped"] += 1
                    continue
                dq = _SERIES[key] = deque(maxlen=_RETAIN)
            dq.append((ts, value))
    _OPS_STATS["samples"] += 1
    _OPS_STATS["sample_ms"] = round((time.perf_counter() - t0) * 1e3, 3)
    return len(samples)


def series(name: str, labels: Optional[Dict[str, str]] = None) -> List[Tuple[float, float]]:
    """The retained ``(unix_ts, value)`` points of one series, the pull
    surface an autoscaler reads. ``labels=None`` with a single matching
    series returns it; ambiguity raises."""
    with _SERIES_LOCK:
        if labels is not None:
            dq = _SERIES.get(_series_key(name, labels))
            return list(dq) if dq is not None else []
        matches = [k for k in _SERIES if k[0] == name]
        if not matches:
            return []
        if len(matches) > 1:
            raise ValueError(
                f"{name} has {len(matches)} label sets — pass labels= to pick one"
            )
        return list(_SERIES[matches[0]])


class _Sampler:
    """The fixed-cadence registry pump (daemon thread, like telemetry's
    ``_MetricsSink``): one :func:`sample` every ``interval`` seconds."""

    def __init__(self, interval: float):
        self.interval = max(0.05, float(interval))
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="heat-tpu-ops-sampler", daemon=True
        )

    def start(self) -> None:
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                sample()
            # the sampler must outlive any one broken subsystem
            except Exception:  # noqa: BLE001
                _OPS_STATS["collect_errors"] += 1

    def stop(self) -> None:
        self._stop.set()


_SAMPLER: Optional[_Sampler] = None


# ----------------------------------------------------------------------
# multi-window SLO burn-rate alerting
# ----------------------------------------------------------------------
_BURN = {
    "target": _env_float("HEAT_TPU_SLO_TARGET", 0.99, 0.0, 0.999999),
    "fast_s": _env_float("HEAT_TPU_SLO_FAST_S", 60.0, 0.1, 86400.0),
    "slow_s": _env_float("HEAT_TPU_SLO_SLOW_S", 300.0, 0.1, 86400.0),
    "threshold": _env_float("HEAT_TPU_SLO_BURN", 2.0, 0.0, 1e6),
    "min_samples": int(_env_float("HEAT_TPU_SLO_BURN_MIN", 8, 1, 1e6)),
}
_BURN_LOCK = threading.Lock()
#: (metric, tenant) -> {"active", "since", "fired", "fast_burn",
#: "slow_burn", "fast_n", "slow_n"} — tenant "*" is the global row
_ALERTS: "OrderedDict[Tuple[str, str], Dict[str, Any]]" = OrderedDict()
_FINDINGS: deque = deque(maxlen=256)
#: alert rows kept (newest-touched win) — bounded like the tenant labels
_ALERT_CAP = 256
#: burn-edge subscribers (:func:`on_burn`): called as
#: ``callback(metric, tenant, rising, snapshot)`` AFTER ``_BURN_LOCK`` is
#: released — a subscriber may safely read ``burn_report()`` or flip
#: actuators without deadlocking the tick that notified it
_BURN_CALLBACKS: List = []


def on_burn(callback) -> Any:
    """Subscribe ``callback(metric, tenant, rising, snapshot)`` to burn
    alert edges: ``rising=True`` on every ``slo_burn`` firing edge,
    ``False`` on the matching clear. ``snapshot`` is a copy of the alert
    row at the edge. Callbacks run on the ticking thread (the sampler, a
    scrape, or a direct :func:`sample` call) after the burn lock is
    released; one raising subscriber never breaks the tick or the others
    (errors are counted, not propagated). The flight recorder logs every
    dispatch as a ``burn_callback`` event. Returns an unsubscribe
    callable — the autoscaler holds it for its disarm path. Subscriptions
    are configuration: they survive :func:`reset`."""
    if not callable(callback):
        raise TypeError(f"on_burn needs a callable, got {type(callback).__name__}")
    with _BURN_LOCK:
        _BURN_CALLBACKS.append(callback)

    def _unsubscribe() -> None:
        with _BURN_LOCK:
            try:
                _BURN_CALLBACKS.remove(callback)
            except ValueError:  # already unsubscribed: idempotent
                pass

    return _unsubscribe


def _dispatch_burn_edges(edges: List[Tuple[str, str, bool, Dict[str, Any]]]) -> None:
    """Fan each accumulated edge out to the subscribers — called by
    ``_burn_tick`` AFTER ``_BURN_LOCK`` is released, so a callback reading
    ``burn_report()`` (or running a whole autoscale decision) cannot
    deadlock against the tick that produced the edge."""
    if not edges:
        return
    with _BURN_LOCK:
        callbacks = list(_BURN_CALLBACKS)
    if not callbacks:
        return
    for metric, tenant, rising, snapshot in edges:
        for cb in callbacks:
            try:
                cb(metric, tenant, rising, dict(snapshot))
                # the flight ring logs every dispatch (record_event lands
                # on the ring at any active telemetry mode)
                telemetry.record_event(
                    "burn_callback",
                    metric=metric,
                    tenant=tenant,
                    rising=rising,
                    callback=getattr(cb, "__name__", type(cb).__name__),
                )
            except Exception:  # noqa: BLE001 - one subscriber never breaks a tick
                _OPS_STATS["callback_errors"] += 1


def set_burn(
    target: Optional[float] = None,
    fast_s: Optional[float] = None,
    slow_s: Optional[float] = None,
    threshold: Optional[float] = None,
    min_samples: Optional[int] = None,
) -> Dict[str, Any]:
    """Set burn-rate parameters in-process; returns the previous config.
    ``target`` is the SLO objective (0.99 = 1% error budget); an alert
    fires when both windows burn at ``threshold``× the sustainable rate."""
    with _BURN_LOCK:
        prev = dict(_BURN)
        if target is not None:
            if not (0.0 <= float(target) < 1.0):
                raise ValueError(f"target must be in [0, 1), got {target!r}")
            _BURN["target"] = float(target)
        if fast_s is not None:
            _BURN["fast_s"] = max(0.1, float(fast_s))
        if slow_s is not None:
            _BURN["slow_s"] = max(0.1, float(slow_s))
        if threshold is not None:
            _BURN["threshold"] = max(0.0, float(threshold))
        if min_samples is not None:
            _BURN["min_samples"] = max(1, int(min_samples))
    return prev


def _burn_tick(now: Optional[float] = None) -> None:
    """Fold the tenant-tagged SLO sample windows into burn rates and run
    the two-window alert state machine. Rising edges emit ``slo_burn``
    events + findings; falling edges emit ``slo_burn_clear``. Edges are
    accumulated under ``_BURN_LOCK`` and fanned out to :func:`on_burn`
    subscribers only after it is released."""
    now = time.perf_counter() if now is None else now
    edges: List[Tuple[str, str, bool, Dict[str, Any]]] = []
    with _BURN_LOCK:
        fast_s, slow_s = _BURN["fast_s"], _BURN["slow_s"]
        budget = max(1e-9, 1.0 - _BURN["target"])
        threshold, min_n = _BURN["threshold"], _BURN["min_samples"]
        horizon = max(fast_s, slow_s)
        touched = set()
        for metric, dq in health_runtime._SLO_SAMPLES.items():
            limit = health_runtime._SLO_LIMITS.get(metric)
            if limit is None:
                continue
            # one pass over the window: (n, breaches) per tenant per window
            rows: Dict[str, List[int]] = {}
            for item in list(dq):
                ts, v = item[0], item[1]
                tenant = item[2] if len(item) > 2 else None
                age = now - ts
                if age > horizon:
                    continue
                bad = 1 if v > limit else 0
                for t in ("*",) if tenant is None else ("*", str(tenant)):
                    row = rows.setdefault(t, [0, 0, 0, 0])  # fn, fbad, sn, sbad
                    if age <= fast_s:
                        row[0] += 1
                        row[1] += bad
                    if age <= slow_s:
                        row[2] += 1
                        row[3] += bad
            for tenant, (fn, fbad, sn, sbad) in rows.items():
                fast_burn = (fbad / fn / budget) if fn else 0.0
                slow_burn = (sbad / sn / budget) if sn else 0.0
                firing = (
                    fn >= min_n
                    and fast_burn >= threshold
                    and slow_burn >= threshold
                )
                self_key = (metric, tenant)
                touched.add(self_key)
                state = _ALERTS.get(self_key)
                if state is None:
                    if len(_ALERTS) >= _ALERT_CAP:
                        _ALERTS.popitem(last=False)
                    state = _ALERTS[self_key] = {
                        "active": False, "since": None, "fired": 0,
                        "fast_burn": 0.0, "slow_burn": 0.0, "fast_n": 0, "slow_n": 0,
                    }
                else:
                    _ALERTS.move_to_end(self_key)
                state.update(
                    fast_burn=fast_burn, slow_burn=slow_burn, fast_n=fn, slow_n=sn
                )
                _edge(state, metric, tenant, firing, edges)
        # rows that emptied out (no samples left in the slow window) clear
        for key, state in _ALERTS.items():
            if key in touched:
                continue
            state.update(fast_burn=0.0, slow_burn=0.0, fast_n=0, slow_n=0)
            _edge(state, key[0], key[1], False, edges)
    _dispatch_burn_edges(edges)


def _edge(
    state: Dict[str, Any],
    metric: str,
    tenant: str,
    firing: bool,
    edges: List[Tuple[str, str, bool, Dict[str, Any]]],
) -> None:
    """One alert edge under ``_BURN_LOCK``: event + finding on rise, event
    on clear; no-op while the level holds. Each edge is also appended to
    ``edges`` for post-lock subscriber dispatch."""
    if firing and not state["active"]:
        state["active"] = True
        state["since"] = time.time()
        state["fired"] += 1
        finding = {
            "kind": "slo_burn",
            "metric": metric,
            "tenant": tenant,
            "fast_burn": round(state["fast_burn"], 4),
            "slow_burn": round(state["slow_burn"], 4),
            "fast_n": state["fast_n"],
            "threshold": _BURN["threshold"],
            "target": _BURN["target"],
            "ts": state["since"],
        }
        _FINDINGS.append(finding)
        telemetry.record_event(
            "slo_burn", **{k: v for k, v in finding.items() if k not in ("kind", "ts")}
        )
        edges.append((metric, tenant, True, dict(state)))
    elif state["active"] and not firing:
        state["active"] = False
        telemetry.record_event(
            "slo_burn_clear",
            metric=metric,
            tenant=tenant,
            fast_burn=round(state["fast_burn"], 4),
            slow_burn=round(state["slow_burn"], 4),
        )
        edges.append((metric, tenant, False, dict(state)))


def burn_report() -> Dict[str, Any]:
    """Burn-tracker state: config, per-(metric, tenant) alert rows and the
    bounded findings ledger — the JSON the autoscaler and ``/healthz``
    read."""
    with _BURN_LOCK:
        return {
            "config": dict(_BURN),
            "alerts": {
                f"{metric}/{tenant}": dict(state)
                for (metric, tenant), state in _ALERTS.items()
            },
            "findings": list(_FINDINGS),
        }


def burn_findings() -> List[Dict[str, Any]]:
    """Every ``slo_burn`` rising edge this session (bounded, newest last)."""
    with _BURN_LOCK:
        return list(_FINDINGS)


def _burn_alert_active() -> bool:
    with _BURN_LOCK:
        return any(state["active"] for state in _ALERTS.values())


# ----------------------------------------------------------------------
# Prometheus text exposition: render + strict validation
# ----------------------------------------------------------------------
def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _escape_help(v: str) -> str:
    return v.replace("\\", "\\\\").replace("\n", "\\n")


def _fmt_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _fmt_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{_escape_label(str(v))}"' for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


def _render_latency_histogram(lines: List[str]) -> None:
    """The one native-histogram family: cumulative ``le`` buckets straight
    from health_runtime's log-spaced ``_Hist`` rows (the ``*`` overall row
    per metric, global view)."""
    base = health_runtime._HIST_BASE
    for metric, tables in _latency_tables().items():
        hist = tables["*"]
        if not hist.count:
            continue
        labels = {"metric": metric}
        cum = 0
        for idx in sorted(hist.buckets):
            cum += hist.buckets[idx]
            le = dict(labels, le=_fmt_value(round(base ** (idx + 1), 9)))
            lines.append(f"heat_tpu_latency_seconds_bucket{_fmt_labels(le)} {cum}")
        inf = dict(labels, le="+Inf")
        lines.append(f"heat_tpu_latency_seconds_bucket{_fmt_labels(inf)} {hist.count}")
        lines.append(
            f"heat_tpu_latency_seconds_sum{_fmt_labels(labels)} {_fmt_value(round(hist.total, 9))}"
        )
        lines.append(f"heat_tpu_latency_seconds_count{_fmt_labels(labels)} {hist.count}")


def render(samples: Optional[List[Sample]] = None) -> str:
    """Prometheus text exposition (format 0.0.4) of ``samples`` (default: a
    fresh :func:`collect`): one ``# HELP`` + ``# TYPE`` block per schema'd
    family in schema order, samples sorted by label set, duplicates
    dropped. Unschema'd names are skipped — the registry cannot emit what
    the committed contract does not name."""
    if samples is None:
        samples = collect()
    by_name: Dict[str, Dict[str, float]] = {}
    for name, labels, value in samples:
        if name not in SCHEMA:
            continue
        rendered = _fmt_labels(labels)
        fam = by_name.setdefault(name, {})
        if rendered not in fam:  # first writer wins: no duplicate samples
            fam[rendered] = value
    lines: List[str] = []
    for name, (mtype, help_, _labels) in SCHEMA.items():
        if name == "heat_tpu_latency_seconds":
            head = len(lines)
            lines.append(f"# HELP {name} {_escape_help(help_)}")
            lines.append(f"# TYPE {name} {mtype}")
            body = len(lines)
            _render_latency_histogram(lines)
            if len(lines) == body:  # nothing observed yet: drop the header
                del lines[head:]
            continue
        fam = by_name.get(name)
        if not fam:
            continue
        lines.append(f"# HELP {name} {_escape_help(help_)}")
        lines.append(f"# TYPE {name} {mtype}")
        for rendered in sorted(fam):
            lines.append(f"{name}{rendered} {_fmt_value(fam[rendered])}")
    return "\n".join(lines) + "\n"


def validate_exposition(text: str) -> List[str]:
    """Strict exposition-format check, returning problems (empty = valid):
    every sample belongs to a ``# TYPE``-declared family with a preceding
    ``# HELP``, histogram samples use only the histogram suffixes, values
    parse as floats, label syntax is well-formed, and no (name, labels)
    sample repeats. The test matrix and the ``ops check`` CLI verb run
    this against a live scrape."""
    problems: List[str] = []
    helped: Dict[str, str] = {}
    typed: Dict[str, str] = {}
    seen: set = set()

    def _family(sample_name: str) -> Optional[str]:
        if sample_name in typed:
            return sample_name
        for fam, mtype in typed.items():
            if mtype in (_H, "summary") and sample_name in (
                fam + "_bucket", fam + "_sum", fam + "_count"
            ):
                return fam
        return None

    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# HELP "):
            parts = line.split(None, 3)
            if len(parts) < 4:
                problems.append(f"line {lineno}: HELP without text")
                continue
            name = parts[2]
            if name in helped:
                problems.append(f"line {lineno}: duplicate HELP for {name}")
            helped[name] = parts[3]
            continue
        if line.startswith("# TYPE "):
            parts = line.split()
            if len(parts) != 4 or parts[3] not in (_C, _G, _H, "summary", "untyped"):
                problems.append(f"line {lineno}: malformed TYPE line {line!r}")
                continue
            name = parts[2]
            if name in typed:
                problems.append(f"line {lineno}: duplicate TYPE for {name}")
            if name not in helped:
                problems.append(f"line {lineno}: TYPE {name} has no preceding HELP")
            if any(s in seen and s[0] == name for s in seen):  # pragma: no cover
                problems.append(f"line {lineno}: TYPE {name} after its samples")
            typed[name] = parts[3]
            continue
        if line.startswith("#"):
            continue
        # sample line: name{labels} value [timestamp]
        brace = line.find("{")
        if brace >= 0:
            close = line.rfind("}")
            if close < brace:
                problems.append(f"line {lineno}: unbalanced label braces")
                continue
            sample_name = line[:brace]
            label_body = line[brace + 1 : close]
            rest = line[close + 1 :].strip()
            if label_body and not _LABELS_RE.match(label_body):
                problems.append(f"line {lineno}: malformed labels {label_body!r}")
        else:
            fields = line.split()
            sample_name, rest = fields[0], " ".join(fields[1:])
            label_body = ""
        if not _NAME_RE.match(sample_name):
            problems.append(f"line {lineno}: invalid metric name {sample_name!r}")
            continue
        value_field = rest.split()[0] if rest.split() else ""
        try:
            float(value_field.replace("+Inf", "inf").replace("-Inf", "-inf").replace("NaN", "nan"))
        except ValueError:
            problems.append(f"line {lineno}: unparseable value {value_field!r}")
        fam = _family(sample_name)
        if fam is None:
            problems.append(f"line {lineno}: sample {sample_name!r} has no TYPE declaration")
        elif typed[fam] == _H and sample_name == fam:
            problems.append(
                f"line {lineno}: histogram {fam} sample without _bucket/_sum/_count suffix"
            )
        key = (sample_name, label_body)
        if key in seen:
            problems.append(f"line {lineno}: duplicate sample {sample_name}{{{label_body}}}")
        seen.add(key)
    return problems


_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABELS_RE = re.compile(
    r'^[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*"'
    r'(?:,[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*")*,?$'
)


# ----------------------------------------------------------------------
# health + readiness checks
# ----------------------------------------------------------------------
def health_status() -> Dict[str, Any]:
    """Liveness: the process is healthy unless the watchdog has tripped
    (a hung collective — restart advised until a ``reset()``) or a burn
    alert is firing. ``{"status": "ok"|"degraded", "checks": {...}}``."""
    wd = health_runtime.watchdog_stats()
    checks = {
        "watchdog": wd["trips"] == 0,
        "slo_burn": not _burn_alert_active(),
    }
    return {
        "status": "ok" if all(checks.values()) else "degraded",
        "checks": checks,
        "watchdog_trips": wd["trips"],
        "last_stall": health_runtime.last_stall(),
    }


def ready_status() -> Dict[str, Any]:
    """Readiness: healthy AND the mesh is up AND global admission is not
    saturated (the global bucket, when armed, projects at least one
    token) AND no peer process is declared lost.
    ``{"status": "ok"|"unready", "checks": {...}}``."""
    doc = health_status()
    checks = dict(doc["checks"])
    checks["mesh"] = _mesh_up()
    admission_ok = True
    try:
        from . import serving

        with serving._LOCK:
            bucket = serving._GLOBAL_BUCKET
        if bucket is not None:
            admission_ok = _bucket_tokens(bucket) >= 1.0
    except Exception:  # pragma: no cover - import-order safety only
        pass
    checks["admission"] = admission_ok
    shedding_ok = True
    try:
        from . import serving

        shedding_ok = not serving._SHED_TIERS
    except Exception:  # pragma: no cover - import-order safety only
        pass
    checks["shedding"] = shedding_ok
    peers_ok = True
    try:
        hook = telemetry._MULTIHOST_HOOK
        if hook is not None:
            # a lost peer means cross-process collectives/barriers cannot
            # complete: unready until the launcher reforms the world
            peers_ok = not (hook().get("peers_lost") or ())
    except Exception:  # pragma: no cover - import-order safety only
        pass
    checks["peers"] = peers_ok
    return {
        "status": "ok" if all(checks.values()) else "unready",
        "checks": checks,
    }


# ----------------------------------------------------------------------
# the ops HTTP server (stdlib ThreadingHTTPServer, daemon threads)
# ----------------------------------------------------------------------
def _debug_report() -> Dict[str, Any]:
    doc = telemetry.report(_state=telemetry._GLOBAL)
    doc.pop("events", None)  # /debug/trace is the timeline's exporter
    doc["burn"] = burn_report()
    return doc


def _debug_trace(analyze: bool) -> Tuple[int, Dict[str, Any]]:
    doc = telemetry.export_trace(path=None)
    if not analyze:
        return 200, doc
    from . import tracelens

    try:
        return 200, tracelens.analyze(doc, allow_partial=True)
    except (tracelens.TraceIncompleteError, ValueError) as exc:
        return 409, {"error": str(exc)}


def _debug_numerics() -> Dict[str, Any]:
    from . import numlens

    return numlens.numerics_block()


def _debug_flight() -> Dict[str, Any]:
    return health_runtime.dump_flight(reason="ops")


#: lazily built handler class — ``http.server`` costs ~50ms of import and
#: a scrape-only client process (the common case) never needs it
_HANDLER_CLS = None


def _handler_cls():
    global _HANDLER_CLS
    if _HANDLER_CLS is not None:
        return _HANDLER_CLS
    from http.server import BaseHTTPRequestHandler
    from urllib.parse import parse_qs, urlparse

    class _OpsHandler(BaseHTTPRequestHandler):
        server_version = "heat-tpu-ops"
        protocol_version = "HTTP/1.1"

        # access logs would interleave with the host process's stdout
        def log_message(self, fmt, *args):  # noqa: D102
            pass

        def _send(self, code: int, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, code: int, doc: Any) -> None:
            body = json.dumps(
                telemetry._jsonable(doc), indent=2, sort_keys=True, default=str
            ).encode()
            self._send(code, body, "application/json")

        def do_GET(self) -> None:  # noqa: N802 - BaseHTTPRequestHandler API
            url = urlparse(self.path)
            route = url.path.rstrip("/") or "/"
            query = parse_qs(url.query)
            try:
                if route == "/metrics":
                    sample()  # alert state never staler than one scrape
                    self._send(
                        200, render().encode(), "text/plain; version=0.0.4"
                    )
                elif route == "/healthz":
                    doc = health_status()
                    self._send_json(200 if doc["status"] == "ok" else 503, doc)
                elif route == "/readyz":
                    doc = ready_status()
                    self._send_json(200 if doc["status"] == "ok" else 503, doc)
                elif route == "/debug/report":
                    self._send_json(200, _debug_report())
                elif route == "/debug/trace":
                    analyze = query.get("analyze", ["0"])[0] not in (
                        "0", "", "false",
                    )
                    code, doc = _debug_trace(analyze)
                    self._send_json(code, doc)
                elif route == "/debug/flight":
                    self._send_json(200, _debug_flight())
                elif route == "/debug/numerics":
                    self._send_json(200, _debug_numerics())
                elif route == "/debug/burn":
                    self._send_json(200, burn_report())
                else:
                    self._send_json(404, {"error": f"no route {route!r}"})
                    return
                _SCRAPES[route] = _SCRAPES.get(route, 0) + 1
            # a broken debug surface answers 500; never kills the server
            except Exception as exc:  # noqa: BLE001
                _OPS_STATS["scrape_errors"] += 1
                try:
                    self._send_json(
                        500, {"error": f"{type(exc).__name__}: {exc}"}
                    )
                except Exception:  # pragma: no cover - client went away
                    pass

    _HANDLER_CLS = _OpsHandler
    return _OpsHandler


class _OpsServer:
    def __init__(self, host: str, port: int):
        from http.server import ThreadingHTTPServer

        self.httpd = ThreadingHTTPServer((host, port), _handler_cls())
        self.httpd.daemon_threads = True
        self.host, self.port = self.httpd.server_address[:2]
        self._thread = threading.Thread(
            target=self.httpd.serve_forever,
            name="heat-tpu-ops-server",
            daemon=True,
            kwargs={"poll_interval": 0.2},
        )

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()


_SERVER: Optional[_OpsServer] = None
_SERVE_LOCK = threading.Lock()


def serve(port: Optional[int] = None, host: Optional[str] = None) -> int:
    """Arm the ops plane: bind the HTTP server (``port=0`` = ephemeral;
    default ``HEAT_TPU_OPS_PORT``) and start the cadence sampler. Returns
    the bound port. Idempotent: re-arming replaces the previous server."""
    global _SERVER, _SAMPLER
    with _SERVE_LOCK:
        if port is None:
            port = _env_port()
            if port is None:
                raise ValueError(
                    "no port: pass serve(port=...) or set HEAT_TPU_OPS_PORT"
                )
        if host is None:
            host = os.environ.get("HEAT_TPU_OPS_HOST", "127.0.0.1")
        if _SERVER is not None:
            _SERVER.stop()
            _SERVER = None
        if _SAMPLER is None:
            _SAMPLER = _Sampler(_INTERVAL_S)
            _SAMPLER.start()
        _SERVER = _OpsServer(host, int(port))
        _SERVER.start()
        telemetry.record_event("ops_serve", host=_SERVER.host, port=_SERVER.port)
        return _SERVER.port


def shutdown() -> None:
    """Disarm the ops plane: stop the HTTP server and the sampler (the
    registry and alert state survive — they are session data)."""
    global _SERVER, _SAMPLER
    with _SERVE_LOCK:
        if _SERVER is not None:
            _SERVER.stop()
            _SERVER = None
        if _SAMPLER is not None:
            _SAMPLER.stop()
            _SAMPLER = None


def status() -> Dict[str, Any]:
    """Ops-plane state: armed/port/host, sampler cadence, registry + scrape
    counters, burn config and any active alerts."""
    with _SERVE_LOCK:
        armed = _SERVER is not None
        host = _SERVER.host if armed else None
        port = _SERVER.port if armed else None
        sampling = _SAMPLER is not None
    with _SERIES_LOCK:
        live = len(_SERIES)
    with _BURN_LOCK:
        active = [
            {"metric": m, "tenant": t, **{k: v for k, v in s.items()}}
            for (m, t), s in _ALERTS.items()
            if s["active"]
        ]
    return {
        "armed": armed,
        "host": host,
        "port": port,
        "sampling": sampling,
        "interval_s": _INTERVAL_S,
        "series": live,
        "scrapes": dict(_SCRAPES),
        "stats": dict(_OPS_STATS),
        "burn": {"config": dict(_BURN), "active_alerts": active},
    }


def reset() -> None:
    """Clear the session state — series registry, burn alerts + findings,
    scrape/sample counters. Configuration (burn parameters, cadence) and
    an armed server/sampler survive — the ``memledger.reset`` split."""
    with _SERIES_LOCK:
        _SERIES.clear()
    with _BURN_LOCK:
        _ALERTS.clear()
        _FINDINGS.clear()
    _OPS_STATS.update(
        samples=0,
        scrape_errors=0,
        collect_errors=0,
        series_dropped=0,
        sample_ms=0.0,
        callback_errors=0,
    )
    _SCRAPES.clear()


# env arming: HEAT_TPU_OPS_PORT set -> the server comes up with the
# process (warn-and-disarm on a port that will not bind; an import must
# never die because a sidecar already owns the port)
_ENV_PORT = _env_port()
if _ENV_PORT is not None:  # pragma: no cover - exercised via subprocess
    try:
        serve(_ENV_PORT)
    except OSError as exc:
        warnings.warn(
            f"HEAT_TPU_OPS_PORT={_ENV_PORT}: bind failed ({exc}); "
            "the ops server stays disarmed",
            stacklevel=2,
        )
