"""``python -m heat_tpu_torch.telemetry``: the observability command line
(reference: heat_tpu/telemetry.py).

Pretty-prints and diffs ``ht.telemetry.report_json`` files and validates
exported Chrome/Perfetto trace files:

.. code-block:: console

    $ python -m heat_tpu_torch.telemetry show telemetry.json
    $ python -m heat_tpu_torch.telemetry diff before.json after.json
    $ python -m heat_tpu_torch.telemetry validate-trace trace.json
    $ python -m heat_tpu_torch.telemetry memory                 # this process's ledger
    $ python -m heat_tpu_torch.telemetry memory report.json --json
    $ python -m heat_tpu_torch.telemetry health                 # flight, watchdog, SLO
    $ python -m heat_tpu_torch.telemetry health flight_dump.json
    $ python -m heat_tpu_torch.telemetry numerics               # the numerics lens
    $ python -m heat_tpu_torch.telemetry sessions report.json   # the serving layer
    $ python -m heat_tpu_torch.telemetry analyze trace.json --against base.json
    $ python -m heat_tpu_torch.telemetry ops check --port 9100  # a live ops plane

``analyze`` exits 0 on a clean window, 1 on a warning or error finding or a
regression against ``--against``, 2 on input it cannot read or a truncated
window (unless ``--allow-partial``); ``ops check`` exits 1 unless
``/metrics`` validates and ``/healthz`` answers 200.

The state lives in :mod:`heat_tpu_torch.core.telemetry`; this module proxies
its names (``heat_tpu_torch.telemetry.report`` and the rest) so that the
command line has a stable ``-m`` entry point.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional

from heat_tpu_torch.core import telemetry as _core


def __getattr__(name):
    # live proxy: heat_tpu_torch.telemetry.<name> is heat_tpu_torch.core.telemetry.<name>
    return getattr(_core, name)


def __dir__():
    return sorted(set(globals()) | set(dir(_core)))


# ----------------------------------------------------------------------
# show
# ----------------------------------------------------------------------
def _load(path: str) -> Dict[str, Any]:
    with open(path) as fh:
        return json.load(fh)


def _fmt_bytes(n) -> str:
    try:
        n = float(n)
    except (TypeError, ValueError):
        return str(n)
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024.0 or unit == "TiB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{int(n)} B"
        n /= 1024.0
    return f"{n:.1f} TiB"  # pragma: no cover - loop always returns


def _show(doc: Dict[str, Any], out) -> None:
    print(f"mode: {doc.get('mode', '?')}  enabled: {doc.get('enabled')}", file=out)
    colls = doc.get("collectives") or {}
    if colls:
        print("collectives:", file=out)
        for op, rec in sorted(colls.items(), key=lambda kv: -kv[1].get("count", 0)):
            print(
                f"  {op:<20} x{rec.get('count', 0):<8} {_fmt_bytes(rec.get('bytes', 0))}",
                file=out,
            )
    fused = doc.get("fused_collectives") or {}
    if fused:
        print("fused collective nodes:", file=out)
        for op, n in sorted(fused.items(), key=lambda kv: -kv[1]):
            print(f"  {op:<28} x{n}", file=out)
    asyncf = doc.get("async_forcing") or {}
    if asyncf:
        print(
            f"async forcing: {asyncf.get('dispatches', 0)} dispatches "
            f"({asyncf.get('roots_dispatched', 0)} roots, "
            f"{asyncf.get('multi_root_batches', 0)} batched) / "
            f"{asyncf.get('blocking_total', 0)} blocking syncs "
            f"{asyncf.get('blocking_syncs', {})}",
            file=out,
        )
    forces = doc.get("forcing_points") or {}
    if forces:
        print("forcing points:", file=out)
        for trig, rec in sorted(forces.items(), key=lambda kv: -kv[1].get("count", 0)):
            print(
                f"  {trig:<12} x{rec.get('count', 0):<7} mean depth "
                f"{rec.get('mean_depth', 0)} (max {rec.get('max_depth', 0)}, "
                f"{rec.get('compiles', 0)} compiles)",
                file=out,
            )
    progs = (doc.get("programs") or {}).get("top") or []
    if progs:
        print(f"top programs (of {doc.get('programs', {}).get('cached', 0)} cached):", file=out)
        for rec in progs:
            line = (
                f"  {rec.get('key', '?'):<18} x{rec.get('dispatches', 0):<6} "
                f"{rec.get('family', '')[:60]}"
            )
            cost = rec.get("cost") or {}
            if cost.get("flops") is not None:
                line += f"  [{cost['flops']:.0f} flops, {_fmt_bytes(cost.get('bytes_accessed'))}]"
            print(line, file=out)
    spans = doc.get("spans") or {}
    if spans:
        print("spans:", file=out)
        for path, rec in sorted(spans.items(), key=lambda kv: -kv[1].get("total_s", 0.0)):
            print(
                f"  {path:<28} x{rec.get('calls', 0):<5} {rec.get('total_s', 0.0):.4f}s",
                file=out,
            )
    scopes = doc.get("scopes") or {}
    if scopes:
        print("scopes:", file=out)
        for path, rec in sorted(scopes.items()):
            blk = rec.get("async_forcing") or {}
            print(
                f"  {path:<24} x{rec.get('calls', 0):<4} {rec.get('wall_s', 0.0):.4f}s  "
                f"{blk.get('dispatches', 0)} dispatches / "
                f"{blk.get('blocking_total', 0)} syncs  "
                f"collectives {rec.get('collective_counts', {})}",
                file=out,
            )
    tl = doc.get("timeline") or {}
    if tl:
        dropped = tl.get("events_dropped", 0)
        note = f" ({dropped} DROPPED past cap {tl.get('cap')})" if dropped else ""
        print(f"timeline: {tl.get('events', 0)} events{note}", file=out)
    for key in ("degraded", "faults", "io_retries", "checkpoint", "nonfinite", "retraces"):
        block = doc.get(key) or {}
        if block:
            print(f"{key}: {json.dumps(block, sort_keys=True)}", file=out)


# ----------------------------------------------------------------------
# memory: the live ledger and the watermark
# ----------------------------------------------------------------------
def _memory_doc(report_path: Optional[str], top: int) -> Dict[str, Any]:
    """The memory picture to show: a saved report's ``memory`` and
    ``programs`` blocks when a path is given, else this process's live
    ledger, gate and the fusion recorder's programs with their static
    peaks."""
    if report_path is not None:
        doc = _load(report_path)
        return {"source": report_path, "memory": doc.get("memory") or {}, "programs": doc.get("programs") or {}}
    from heat_tpu_torch.core import fusion, memledger

    return {
        "source": "<live>",
        "memory": {
            "ledger": memledger.ledger(top=top),
            "watermark": memledger.watermark(),
            "budget": memledger.budget_info(resolve=True),
            "last_oom": memledger.last_oom(),
        },
        "programs": {
            "cached": len(fusion.cache_stats()["program_keys"]),
            "cost_errors": fusion.cost_error_count(),
            "top": [dict(rec, key=key) for key, rec in fusion.program_costs(top=top).items()],
        },
    }


def _show_memory(doc: Dict[str, Any], out) -> None:
    mem = doc.get("memory") or {}
    led = mem.get("ledger") or {}
    print(f"memory ({doc.get('source', '?')}):", file=out)
    if led:
        print(
            f"  live: {_fmt_bytes(led.get('total_bytes', 0))} over "
            f"{led.get('buffers', led.get('buffer_count', 0))} buffer(s)",
            file=out,
        )
        for owner, nbytes in sorted((led.get("by_owner") or {}).items(), key=lambda kv: -kv[1]):
            print(f"    {owner:<14} {_fmt_bytes(nbytes)}", file=out)
        for rec in led.get("top") or []:
            print(
                f"    top: {_fmt_bytes(rec.get('nbytes', 0)):<10} "
                f"{rec.get('owner', '?'):<14} {rec.get('dtype', '?')}"
                f"{rec.get('shape', [])}",
                file=out,
            )
    wm = mem.get("watermark") or {}
    if wm:
        print(
            f"  watermark: {_fmt_bytes(wm.get('bytes', 0))} "
            f"(event {wm.get('event')}, {wm.get('samples', 0)} samples) "
            f"{wm.get('by_owner', {})}",
            file=out,
        )
    budget = mem.get("budget") or {}
    if budget.get("budget") is not None:
        print(
            f"  budget: {_fmt_bytes(budget.get('budget_bytes'))} "
            f"policy={budget.get('policy')} checks={budget.get('checks', 0)} "
            f"exceeded={budget.get('exceeded', 0)} drains={budget.get('drains', 0)}",
            file=out,
        )
    oom = mem.get("last_oom")
    if oom:
        print(
            f"  LAST OOM: program {oom.get('program')} ({oom.get('family')}) "
            f"static peak {_fmt_bytes(oom.get('static_peak_bytes'))}, live "
            f"{_fmt_bytes(oom.get('live_total_bytes', 0))} by owner "
            f"{oom.get('by_owner', {})}",
            file=out,
        )
    dev = mem.get("device") or {}
    for name, stats in sorted(dev.items()):
        line = ", ".join(f"{k}={_fmt_bytes(v)}" for k, v in sorted(stats.items()))
        print(f"  {name}: {line}", file=out)
    progs = doc.get("programs") or {}
    top_progs = progs.get("top") or []
    if top_progs:
        print(
            f"per-program static peaks (of {progs.get('cached', 0)} cached, "
            f"{progs.get('cost_errors', 0)} cost error(s)):",
            file=out,
        )
        for rec in top_progs:
            memrec = (rec.get("cost") or rec).get("memory") or {}
            peak = memrec.get("peak_bytes")
            line = f"  {rec.get('key', '?'):<18} x{rec.get('dispatches', 0):<6} {str(rec.get('family', ''))[:48]:<48} "
            if peak is not None:
                line += (
                    f"peak {_fmt_bytes(peak)} (args {_fmt_bytes(memrec.get('argument_bytes', 0))}"
                    f" + out {_fmt_bytes(memrec.get('output_bytes', 0))}"
                    f" + temp {_fmt_bytes(memrec.get('temp_bytes', 0))})"
                )
            else:
                line += "peak n/a"
            print(line, file=out)


# ----------------------------------------------------------------------
# health: the flight recorder, the watchdog and the latency picture
# ----------------------------------------------------------------------
def _health_doc(report_path: Optional[str]) -> Dict[str, Any]:
    """The health picture to show: a saved report's (or a flight dump's)
    ``health`` block when a path is given, else this process's live block
    (module state: asking for health initializes nothing)."""
    if report_path is not None:
        doc = _load(report_path)
        blk = doc.get("health") or {}
        if not blk and "watchdog" in doc:  # a bare bundle without the block
            blk = {"watchdog": doc.get("watchdog") or {}}
        return {"source": report_path, "health": blk, "stalls": doc.get("stalls") or []}
    from heat_tpu_torch.core import health_runtime

    return {"source": "<live>", "health": health_runtime.health_block(global_view=True), "stalls": health_runtime.stalls()}


def _ms(v) -> str:
    try:
        return f"{float(v) * 1e3:.2f}ms"
    except (TypeError, ValueError):
        return "?"


def _show_health(doc: Dict[str, Any], out) -> None:
    blk = doc.get("health") or {}
    print(f"health ({doc.get('source', '?')}):", file=out)
    fl = blk.get("flight") or {}
    if fl:
        state = "armed" if fl.get("enabled") else "DISARMED"
        dropped = f", {fl['dropped']} dropped" if fl.get("dropped") else ""
        last = f"  last dump: {fl['last_dump']}" if fl.get("last_dump") else ""
        print(
            f"  flight: {state}, {fl.get('events', 0)}/{fl.get('cap', 0)} "
            f"events{dropped}, {fl.get('dumps', 0)} dump(s){last}",
            file=out,
        )
    wd = blk.get("watchdog") or {}
    if wd:
        state = "armed" if wd.get("enabled") else "DISARMED"
        print(
            f"  watchdog: {state}, deadline {wd.get('deadline_ms', 0)}ms "
            f"policy={wd.get('policy')} arms={wd.get('arms', 0)} "
            f"trips={wd.get('trips', 0)}",
            file=out,
        )
    for st in (doc.get("stalls") or [])[-3:]:
        print(
            f"  STALL: {st.get('site')} waited {st.get('waited_s')}s "
            f"(deadline {st.get('deadline_s')}s) program={st.get('program')} "
            f"pending={[r.get('cid') for r in st.get('pending_roots') or []]}",
            file=out,
        )
    for metric, title in (("sync", "blocking-sync host wait"), ("dispatch", "dispatch→done"), ("compile", "compile time")):
        table = blk.get(metric) or {}
        rows = [(k, r) for k, r in table.items() if r.get("count")]
        if not rows:
            continue
        print(f"  {title}:", file=out)
        rows.sort(key=lambda kv: (kv[0] != "*", -kv[1].get("count", 0)))
        for key, rec in rows[:12]:
            print(
                f"    {key:<20} x{rec.get('count', 0):<6} "
                f"p50 {_ms(rec.get('p50_s'))}  p90 {_ms(rec.get('p90_s'))}  "
                f"p99 {_ms(rec.get('p99_s'))}  max {_ms(rec.get('max_s'))}",
                file=out,
            )
    slo = blk.get("slo") or {}
    for metric in ("sync", "dispatch", "compile"):
        rec = slo.get(metric) or {}
        if rec.get("limit_ms") is None:
            continue
        ratio = rec.get("ok_ratio")
        print(
            f"  SLO {metric}: limit {rec['limit_ms']}ms, {rec.get('recent', 0)} in "
            f"window, {rec.get('window_breaches', 0)} breach(es)"
            + (f", ok_ratio {ratio}" if ratio is not None else "")
            + f", {rec.get('breaches_total', 0)} total",
            file=out,
        )


# ----------------------------------------------------------------------
# numerics and sessions (the numerics lens and the serving layer)
# ----------------------------------------------------------------------
def _numerics_doc(report_path: Optional[str]) -> Dict[str, Any]:
    """The numerics picture to render: a saved report's (or flight-dump
    bundle's) ``numerics`` block when a path is given, else THIS process's
    live block — pure module state, no mesh bring-up (the same
    never-initialize contract as ``health``)."""
    if report_path is not None:
        doc = _load(report_path)
        return {"source": report_path, "numerics": doc.get("numerics") or {}}
    from heat_tpu_torch.core import numlens

    return {"source": "<live>", "numerics": numlens.numerics_block()}


def _show_numerics(doc: Dict[str, Any], out) -> None:
    blk = doc.get("numerics") or {}
    print(f"numerics ({doc.get('source', '?')}):", file=out)
    print(
        f"  lens: {blk.get('mode', 'off')}, sampled "
        f"{blk.get('dispatches_sampled', 0)}/{blk.get('dispatches_seen', 0)} "
        f"dispatches (every {blk.get('sample_every', '?')})",
        file=out,
    )
    stats = blk.get("tensor_stats") or {}
    if stats:
        print("  tensor stats:", file=out)
        rows = sorted(stats.items(), key=lambda kv: -kv[1].get("samples", 0))
        for key, rec in rows[:8]:
            for i, rr in sorted((rec.get("roots") or {}).items()):
                flags = []
                if rr.get("nonfinite"):
                    flags.append(f"NONFINITE x{rr['nonfinite']}")
                if rr.get("subnormal"):
                    flags.append(f"subnormal {rr.get('subnormal_pct', 0)}%")
                if rr.get("edge_high"):
                    flags.append(f"edge_high {rr['edge_high']}")
                print(
                    f"    {key}[{i}] {rr.get('dtype')}  rms {rr.get('rms', 0):.4g}  "
                    f"absmax {rr.get('absmax', 0):.4g}  x{rr.get('samples', 0)}"
                    + ("  " + " ".join(flags) if flags else ""),
                    file=out,
                )
    drift = blk.get("drift") or {}
    progs = drift.get("programs") or {}
    if progs:
        print(
            f"  drift ledger (max {drift.get('max_ulp', 0)} ULP, worst family "
            f"{drift.get('worst_family')}):",
            file=out,
        )
        for key, rec in sorted(progs.items(), key=lambda kv: -kv[1].get("max_ulp", 0))[:8]:
            print(
                f"    {key}  p50 {rec.get('p50_ulp', 0)} ULP  max "
                f"{rec.get('max_ulp', 0)} ULP  x{rec.get('samples', 0)}",
                file=out,
            )
    canary = blk.get("canary") or {}
    if canary.get("runs"):
        sick = canary.get("last_sick") or []
        print(
            f"  sdc canary: {canary['runs']} run(s) over "
            f"{canary.get('devices', '?')} device(s), "
            f"{canary.get('mismatches', 0)} mismatch(es), last "
            f"{canary.get('last_ms', '?')}ms"
            + (f"  SICK: {', '.join(sick)}" if sick else ""),
            file=out,
        )
    for tag, rec in (blk.get("training") or {}).items():
        extras = []
        if rec.get("overflows"):
            extras.append(f"OVERFLOWS x{rec['overflows']}")
        if rec.get("plateau"):
            extras.append("PLATEAU")
        ratio = rec.get("last_update_ratio")
        print(
            f"  train[{tag}]: {rec.get('steps', 0)} step(s), loss "
            f"{rec.get('last_loss')}"
            + (f", update_ratio {ratio:.3g}" if ratio is not None else "")
            + ("  " + " ".join(extras) if extras else ""),
            file=out,
        )
    for f in (blk.get("findings") or [])[-5:]:
        print(f"  {f.get('severity', '?').upper()}: {f.get('message')}", file=out)


def _sessions_doc(report_path: Optional[str]) -> Dict[str, Any]:
    """The serving picture to render: a saved report's ``serving`` block
    when a path is given, else THIS process's live block — pure module
    state, no mesh bring-up (the same never-initialize contract as
    ``health``/``numerics``)."""
    if report_path is not None:
        doc = _load(report_path)
        return {"source": report_path, "serving": doc.get("serving") or {}}
    from heat_tpu_torch.core import serving

    return {"source": "<live>", "serving": serving.sessions_block()}


def _show_sessions(doc: Dict[str, Any], out) -> None:
    blk = doc.get("serving") or {}
    print(f"serving ({doc.get('source', '?')}):", file=out)
    sessions = blk.get("sessions") or []
    if not sessions:
        print("  no sessions recorded", file=out)
    adm = blk.get("admission") or {}
    gbl = adm.get("global")
    if gbl:
        print(
            f"  admission: policy {adm.get('policy', 'wait')}, global bucket "
            f"{gbl.get('rate')}/s burst {gbl.get('burst')} — "
            f"{gbl.get('admitted', 0)} admitted, {gbl.get('refused', 0)} "
            f"refused, {gbl.get('waited_s', 0)}s waited",
            file=out,
        )
    cache = blk.get("cache") or {}
    if cache.get("persistent_dir"):
        print(
            f"  persistent cache: {cache['persistent_dir']} "
            f"({cache.get('index_keys', 0)} indexed keys, "
            f"{cache.get('disk_hits', 0)} disk hits)",
            file=out,
        )
    for sess in sessions:
        st = sess.get("stats") or {}
        state = "active" if sess.get("active") else "exited"
        print(
            f"  {sess.get('name', '?')} ({state}): "
            f"{st.get('dispatches', 0)} dispatches "
            f"({st.get('roots', 0)} roots, {st.get('compiles', 0)} compiles), "
            f"errstate {sess.get('errstate', 'inherit')}, "
            f"numlens {sess.get('numlens', 'inherit')}",
            file=out,
        )
        trouble = {
            k: st.get(k, 0)
            for k in ("degraded", "quarantine_hits", "mem_refused",
                      "admission_refused", "admission_waits")
            if st.get(k)
        }
        if trouble:
            print(f"    incidents: {trouble}", file=out)
        if sess.get("quarantine"):
            print(f"    quarantine view: {sess['quarantine']}", file=out)
        bucket = sess.get("bucket")
        if bucket:
            print(
                f"    bucket: {bucket.get('rate')}/s burst {bucket.get('burst')} "
                f"— {bucket.get('admitted', 0)} admitted, "
                f"{bucket.get('refused', 0)} refused",
                file=out,
            )


# ----------------------------------------------------------------------
# ops: scrape, check or serve a live ops plane
# ----------------------------------------------------------------------
def _ops_base(args) -> str:
    if args.url:
        return args.url.rstrip("/")
    if args.port is None:
        raise SystemExit("ops: pass --url or --port to reach a live endpoint")
    return f"http://{args.host}:{int(args.port)}"


def _ops_get(url: str, timeout: float):
    """One GET: ``(status, body)``; an HTTP error status is a result to
    report, not an exception."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.status, resp.read().decode("utf-8", "replace")
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read().decode("utf-8", "replace")


def _ops_scrape(args, out) -> int:
    url = _ops_base(args) + args.path
    try:
        code, body = _ops_get(url, args.timeout)
    except OSError as exc:
        print(f"ERROR: {url}: {exc}", file=out)
        return 1
    print(body, end="" if body.endswith("\n") else "\n", file=out)
    return 0 if code == 200 else 1


def _ops_check(args, out) -> int:
    """The strict check of a live endpoint: ``/metrics`` validates as an
    exposition (types, HELP lines, no duplicate sample, only the schema's
    names) and ``/healthz`` answers 200."""
    from heat_tpu_torch.core import opsplane

    base = _ops_base(args)
    rc = 0
    try:
        code, text = _ops_get(base + "/metrics", args.timeout)
    except OSError as exc:
        print(f"ERROR: {base}/metrics: {exc}", file=out)
        return 1
    if code != 200:
        print(f"FAIL: /metrics answered {code}", file=out)
        return 1
    problems = opsplane.validate_exposition(text)
    names = {line.split("{")[0].split()[0] for line in text.splitlines() if line and not line.startswith("#")}
    known = set(opsplane.SCHEMA)
    for name, spec in opsplane.SCHEMA.items():
        if spec[0] == "histogram":
            known.update(name + s for s in ("_bucket", "_sum", "_count"))
    for name in sorted(names - known):
        problems.append(f"unschema'd metric name {name!r} (doc/metrics_schema.json)")
    if problems:
        for p in problems[:20]:
            print(f"INVALID: {p}", file=out)
        rc = 1
    else:
        samples = sum(1 for ln in text.splitlines() if ln and not ln.startswith("#"))
        print(f"OK: /metrics parses as Prometheus exposition ({len(names)} families, {samples} samples)", file=out)
    try:
        code, body = _ops_get(base + "/healthz", args.timeout)
    except OSError as exc:
        print(f"ERROR: {base}/healthz: {exc}", file=out)
        return 1
    if code == 200:
        print("OK: /healthz answers 200", file=out)
    else:
        print(f"FAIL: /healthz answered {code}: {body.strip()[:200]}", file=out)
        rc = 1
    return rc


def _ops_serve(args, out) -> int:
    """Arm this process's ops plane and block until interrupted: a scrape
    target for checking the wiring (an idle process exports mostly zeros)."""
    import time

    from heat_tpu_torch.core import opsplane

    try:
        port = opsplane.serve(port=args.port, host=args.host)
    except ValueError as exc:
        print(f"ERROR: {exc}", file=out)
        return 2
    print(f"ops plane listening on http://{args.host}:{port}", file=out, flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        opsplane.shutdown()
    return 0


# ----------------------------------------------------------------------
# analyze
# ----------------------------------------------------------------------
def _analyze(args, out) -> int:
    from heat_tpu_torch.core import tracelens

    try:
        analysis = tracelens.analyze(args.trace, allow_partial=args.allow_partial)
    except tracelens.TraceIncompleteError as exc:
        print(f"REFUSED: {exc}", file=out)
        return 2
    except (ValueError, OSError) as exc:
        print(f"ERROR: {exc}", file=out)
        return 2
    delta = None
    if args.against is not None:
        try:
            baseline = tracelens.load_analysis(args.against)
        except (ValueError, OSError) as exc:
            print(f"ERROR: cannot load baseline: {exc}", file=out)
            return 2
        delta = tracelens.diff(baseline, analysis)
    if args.json:
        doc = dict(analysis)
        if delta is not None:
            doc["against"] = delta
        print(json.dumps(_core._jsonable(doc), indent=2, sort_keys=True), file=out)
    else:
        print(tracelens.render(analysis), file=out)
        if delta is not None:
            shifts = delta["bucket_shifts_pts"]
            if shifts:
                print("vs baseline (bucket shifts, pts):", file=out)
                for bucket, pts in sorted(shifts.items(), key=lambda kv: -abs(kv[1])):
                    print(f"  {bucket:<16} {pts:+.2f}", file=out)
            for f in delta["new_findings"]:
                print(f"NEW [{f.get('severity', '?')}] {f.get('rule')}: {f.get('message')}", file=out)
            for r in delta["regressions"]:
                print(f"REGRESSION: {r}", file=out)
    gate = any(f.get("severity") in ("error", "warning") for f in analysis["findings"])
    return 1 if gate or (delta is not None and not delta["ok"]) else 0


# ----------------------------------------------------------------------
# diff
# ----------------------------------------------------------------------
def _flatten_numeric(doc, prefix="") -> Dict[str, float]:
    out: Dict[str, float] = {}
    if isinstance(doc, dict):
        for k, v in doc.items():
            out.update(_flatten_numeric(v, f"{prefix}{k}/" if prefix else f"{k}/"))
    elif isinstance(doc, bool) or doc is None or isinstance(doc, str):
        pass
    elif isinstance(doc, (int, float)):
        out[prefix.rstrip("/")] = float(doc)
    return out


def _diff(a: Dict[str, Any], b: Dict[str, Any], out, top: int = 40) -> int:
    """Print per-counter deltas b - a, largest absolute change first.
    Returns the number of changed counters."""
    fa, fb = _flatten_numeric(a), _flatten_numeric(b)
    deltas = []
    for key in sorted(set(fa) | set(fb)):
        if key.startswith("events/") or key.endswith("/ts"):
            continue  # raw timeline entries are not counters
        va, vb = fa.get(key, 0.0), fb.get(key, 0.0)
        if va != vb:
            deltas.append((abs(vb - va), key, va, vb))
    deltas.sort(reverse=True)
    for _, key, va, vb in deltas[:top]:
        sign = "+" if vb >= va else ""
        print(f"  {key:<64} {va:g} -> {vb:g} ({sign}{vb - va:g})", file=out)
    if len(deltas) > top:
        print(f"  ... and {len(deltas) - top} more changed counters", file=out)
    if not deltas:
        print("  no counter differences", file=out)
    return len(deltas)


# ----------------------------------------------------------------------
# entry point
# ----------------------------------------------------------------------
def main(argv: Optional[List[str]] = None, out=None) -> int:
    out = out if out is not None else sys.stdout
    parser = argparse.ArgumentParser(
        prog="python -m heat_tpu_torch.telemetry",
        description="Pretty-print/diff heat_tpu_torch telemetry reports, analyze and validate trace files, and "
        "check a live ops plane.",
    )
    sub = parser.add_subparsers(dest="cmd", required=True)
    p_show = sub.add_parser("show", help="pretty-print a report_json artifact")
    p_show.add_argument("report", help="path to a telemetry report_json file")
    p_show.add_argument("--raw", action="store_true", help="re-emit the parsed JSON instead")
    p_diff = sub.add_parser("diff", help="diff two report_json artifacts (b - a)")
    p_diff.add_argument("a")
    p_diff.add_argument("b")
    p_mem = sub.add_parser(
        "memory",
        help="the live-buffer ledger and the watermark (from a report_json artifact, or live from this process)",
    )
    p_mem.add_argument("report", nargs="?", default=None, help="a report_json artifact; omitted = this process, live")
    p_mem.add_argument("--json", action="store_true", help="emit JSON instead of text")
    p_mem.add_argument("--top", type=int, default=5, help="top-K buffers shown")
    p_health = sub.add_parser(
        "health",
        help="runtime health: flight recorder, watchdog and stalls, latency p50/p90/p99 and SLO gauges "
        "(from a report_json artifact or a flight-dump bundle, or live from this process)",
    )
    p_health.add_argument(
        "report", nargs="?", default=None,
        help="a report_json artifact or flight-dump bundle; omitted = this process's live health block",
    )
    p_health.add_argument("--json", action="store_true", help="emit JSON instead of text")
    p_num = sub.add_parser(
        "numerics",
        help="numerics lens: tensor statistics, the drift ledger, the SDC canary and the training streams "
        "(from a report_json artifact or a flight-dump bundle, or live from this process)",
    )
    p_num.add_argument(
        "report", nargs="?", default=None,
        help="a report_json artifact or flight-dump bundle; omitted = this process's live numerics block",
    )
    p_num.add_argument("--json", action="store_true", help="emit JSON instead of text")
    p_sess = sub.add_parser(
        "sessions",
        help="serving layer: per-session billing and incidents, the admission buckets and the persistent "
        "program cache (from a report_json artifact, or live from this process)",
    )
    p_sess.add_argument(
        "report", nargs="?", default=None, help="a report_json artifact; omitted = this process's live serving block",
    )
    p_sess.add_argument("--json", action="store_true", help="emit JSON instead of text")
    p_ana = sub.add_parser(
        "analyze",
        help="tracelens's diagnosis of a trace: time per bucket, the critical path, cross-host stragglers and "
        "findings; exit 1 on a warning or error finding or a regression against --against",
    )
    p_ana.add_argument(
        "trace", nargs="?", default=None,
        help="an export_trace/merge_traces file; omitted = this process's live verbose timeline",
    )
    p_ana.add_argument(
        "--against", default=None,
        help="the baseline: a saved `analyze --json` output or another trace file (bucket shifts, new findings, "
        "critical-path growth; a regression exits 1)",
    )
    p_ana.add_argument("--json", action="store_true", help="emit JSON instead of text")
    p_ana.add_argument(
        "--allow-partial", action="store_true",
        help="analyze a window with dropped events anyway (refused with exit 2 otherwise)",
    )
    p_ops = sub.add_parser(
        "ops",
        help="the live ops plane: scrape a route, check /metrics and /healthz strictly, or serve this process's plane",
    )
    p_ops.add_argument("action", choices=("scrape", "check", "serve"))
    p_ops.add_argument("--url", default=None, help="the endpoint's base URL (overrides --host/--port)")
    p_ops.add_argument("--host", default="127.0.0.1")
    p_ops.add_argument("--port", type=int, default=None)
    p_ops.add_argument("--path", default="/metrics", help="the route of 'scrape' (default /metrics)")
    p_ops.add_argument("--timeout", type=float, default=10.0)
    p_val = sub.add_parser("validate-trace", help="check a Chrome/Perfetto trace-event JSON file")
    p_val.add_argument("trace", help="path to an export_trace/merge_traces output")
    p_val.add_argument(
        "--cross-host",
        action="store_true",
        help="also require cross-host collective parity (per-cid collective event "
        "counts equal on every process row)",
    )
    args = parser.parse_args(argv)

    if args.cmd == "show":
        doc = _load(args.report)
        if args.raw:
            print(json.dumps(doc, indent=2, sort_keys=True), file=out)
        else:
            _show(doc, out)
        return 0
    if args.cmd == "diff":
        _diff(_load(args.a), _load(args.b), out)
        return 0
    if args.cmd in ("memory", "health", "numerics", "sessions"):
        if args.cmd == "memory":
            doc, show = _memory_doc(args.report, top=args.top), _show_memory
        else:
            doc_of, show = {
                "health": (_health_doc, _show_health),
                "numerics": (_numerics_doc, _show_numerics),
                "sessions": (_sessions_doc, _show_sessions),
            }[args.cmd]
            doc = doc_of(args.report)
        if args.json:
            print(json.dumps(_core._jsonable(doc), indent=2, sort_keys=True), file=out)
        else:
            show(doc, out)
        return 0
    if args.cmd == "ops":
        return {"scrape": _ops_scrape, "check": _ops_check, "serve": _ops_serve}[args.action](args, out)
    if args.cmd == "analyze":
        return _analyze(args, out)
    problems = _core.validate_trace(args.trace, cross_host=args.cross_host)
    if problems:
        for p in problems[:20]:
            print(f"INVALID: {p}", file=out)
        return 1
    with open(args.trace) as fh:
        n = len(json.load(fh).get("traceEvents", []))
    parity = " + cross-host collective parity" if args.cross_host else ""
    print(f"OK: {args.trace} parses as trace-event JSON ({n} events){parity}", file=out)
    return 0


if __name__ == "__main__":  # pragma: no cover - run through subprocess in the tests
    sys.exit(main())
