"""The numerics lens: what the values do, beside when things run, what they
allocate and whether the runtime is healthy (reference:
heat_tpu/core/numlens.py).

Four pillars, all off by default (``HEAT_TPU_NUMLENS={0,sample,full}``),
and one attribute read at the fused-dispatch seam while off
(``telemetry._NUMLENS_HOOK``):

1. **Tensor statistics.** Every Nth fused dispatch
   (``HEAT_TPU_NUMLENS_SAMPLE_EVERY``; ``full`` samples every one) reads
   each root's rms, absmax, nonfinite and subnormal counts and a fixed
   16-bucket histogram of its exponents over the dtype's exponent range,
   aggregated per program key and root into ``report()["numerics"]``,
   emitted as ``numeric`` timeline events and exported as Perfetto counter
   tracks. A root is a tuple of shard tensors whose rows are padded to
   ``ceil(n/p)``: only the logical elements count (the extent stamped on
   the root by ``fusion.register_root``). The counts and the histogram come
   from the bit pattern (the exponent and mantissa fields), so they are
   exact whatever the float unit flushes; torch has no unsigned shifts at
   16, 32 and 64 bits, so the bits are read as signed integers (16-bit
   ones widened to 32) and masked after each shift. The statistics run as
   plain torch on the shards, never through ``ht`` ops, which would record
   into the recorder from inside its own hook. Reading them is one host
   sync per sampled dispatch.

2. **The drift audit.** Every ``HEAT_TPU_NUMLENS_SHADOW_EVERY`` sampled
   dispatch is run again through the program's plain module
   (``fusion._build(sig)``, op by op: what a degraded force runs) and each
   root is compared ULP by ULP with the program's output. On a card the
   program is Inductor's code, so the ledger (per program: p50 and max ULP,
   the op family) checks that the fused reorder stays within float
   tolerance; on the CPU the program is its plain module and the drift is 0
   by construction. The distances are computed on the device; only their
   median and maximum are read.

3. **The SDC canary** (:func:`run_canary`). A fixed program on replicated
   input, twice on every device of the mesh: each device must repeat itself
   bit for bit and agree with the majority. A device that does not yields a
   ``numlens.sdc`` finding naming it and its index, and feeds
   ``resilience.note_device_fault``. The ``numeric.sdc.<index>`` fault site
   injects a corruption per device index.

4. **Training streams.** ``nn.DataParallel.train_step`` and DASO's merge
   call :func:`note_training`: loss, gradient norm, parameter and update
   norms and the update ratio ``|Δp|/|p|``, with overflow (a nonfinite loss
   or update) and plateau (a flat loss over a window) detectors.

A serving ``Session`` pushes a sampling frame of its own for its thread
(:func:`_push_session`): its mode shadows the global one there, and it
samples on its own cadence and counters.

The lens never forces a pending chain, never builds a mesh from a read
(:func:`numerics_block` is module state; :func:`run_canary` returns None
while no mesh exists) and never raises out of its hook: a failure there is
swallowed, and :func:`sampling_stats` shows what was sampled.
"""

from __future__ import annotations

import math
import os
import threading
import time
from collections import Counter, OrderedDict, deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from . import resilience, telemetry

__all__ = [
    "set_mode",
    "mode",
    "active",
    "reset",
    "numerics_block",
    "tensor_stats",
    "drift_ledger",
    "run_canary",
    "note_training",
    "training_stats",
    "findings",
    "sampling_stats",
    "ulp_diff",
]

# ----------------------------------------------------------------------
# knobs
# ----------------------------------------------------------------------
_MODE_NAMES = {0: "off", 1: "sample", 2: "full"}


def _parse_mode(raw) -> int:
    if isinstance(raw, int):
        return max(0, min(2, raw))
    s = str(raw or "").strip().lower()
    if s in ("", "0", "off", "false", "no"):
        return 0
    if s in ("2", "full"):
        return 2
    return 1  # "sample", "1", "on", anything truthy


def _int_env(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


_MODE = 0
#: sample every Nth fused dispatch in ``sample`` mode (``full`` samples all)
_SAMPLE_EVERY = _int_env("HEAT_TPU_NUMLENS_SAMPLE_EVERY", 16)
#: audit every Nth sampled dispatch against its plain module (0: never)
_SHADOW_EVERY = _int_env("HEAT_TPU_NUMLENS_SHADOW_EVERY", 4)
#: run the canary every Nth sampled dispatch (0: only by hand)
_CANARY_EVERY = _int_env("HEAT_TPU_NUMLENS_CANARY_EVERY", 0)
#: a drift above this many ULP is a ``numlens.drift`` finding
_MAX_ULP = _int_env("HEAT_TPU_NUMLENS_MAX_ULP", 16)

#: the exponent histogram's fixed width
N_BUCKETS = 16

_FINDING_CAP = 64
_PROGRAM_CAP = 64
_TRAIN_WINDOW = 128
_PLATEAU_WINDOW = 12

# ----------------------------------------------------------------------
# session state (cleared by reset(); the mode survives)
# ----------------------------------------------------------------------
_LOCK = threading.Lock()
_SEEN = 0  # fused dispatches observed while armed
_SAMPLED = 0  # dispatches that paid for statistics
_STATS: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
_DRIFT: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
_CANARY: Dict[str, Any] = {}
_TRAINING: Dict[str, Dict[str, Any]] = {}
_FINDINGS: deque = deque(maxlen=_FINDING_CAP)
_IN_HOOK = False

# The serving sessions' sampling frames: per thread, each with its own mode
# override and seen/sampled counters. ``_SESSION_ARMED`` counts the frames
# with a mode of their own, so the hook stays installed while one exists.
_NL_TLS = threading.local()
_SESSION_ARMED = 0


def _push_session(mode_override=None) -> Dict[str, Any]:
    """Push a sampling frame for the calling thread. A ``mode_override`` of
    None inherits the global mode with counters of its own; another mode
    shadows the global one for this thread's dispatches."""
    global _SESSION_ARMED
    stack = getattr(_NL_TLS, "frames", None)
    if stack is None:
        stack = _NL_TLS.frames = []
    frame: Dict[str, Any] = {
        "mode": None if mode_override is None else _parse_mode(mode_override),
        "seen": 0,
        "sampled": 0,
    }
    stack.append(frame)
    if frame["mode"]:
        with _LOCK:
            _SESSION_ARMED += 1
            if telemetry._NUMLENS_HOOK is None:
                telemetry._NUMLENS_HOOK = _on_dispatch
    return frame


def _pop_session() -> Optional[Dict[str, Any]]:
    global _SESSION_ARMED
    stack = getattr(_NL_TLS, "frames", None)
    if not stack:
        return None
    frame = stack.pop()
    if frame["mode"]:
        with _LOCK:
            _SESSION_ARMED -= 1
            if not _SESSION_ARMED and not _MODE:
                telemetry._NUMLENS_HOOK = None
    return frame


def mode() -> str:
    """The mode's name: ``off``, ``sample`` or ``full``."""
    return _MODE_NAMES[_MODE]


def active() -> bool:
    """Whether the lens is on."""
    return _MODE > 0


def set_mode(new_mode) -> int:
    """Turn the lens on or off: ``0``/``"off"``, ``1``/``"sample"``,
    ``2``/``"full"`` (or an earlier return value). Installs the dispatch
    hook on telemetry while the lens or a session frame needs it. Returns
    the previous mode as an int."""
    global _MODE
    prev = _MODE
    _MODE = _parse_mode(new_mode)
    telemetry._NUMLENS_HOOK = _on_dispatch if (_MODE or _SESSION_ARMED) else None
    return prev


def reset() -> None:
    """Clear the session state (counters, statistics, drift ledger, canary,
    training streams, findings); the mode and the knobs stay. Called from
    ``telemetry.reset()``."""
    global _SEEN, _SAMPLED
    with _LOCK:
        _SEEN = 0
        _SAMPLED = 0
        _STATS.clear()
        _DRIFT.clear()
        _CANARY.clear()
        _TRAINING.clear()
        _FINDINGS.clear()


def _add_finding(rule: str, severity: str, message: str, **data) -> Dict[str, Any]:
    f = {"rule": rule, "severity": severity, "message": message}
    f.update(data)
    _FINDINGS.append(f)
    return f


def findings() -> List[Dict[str, Any]]:
    """The capped list of numeric findings (drift breaches, SDC hits,
    training overflow and plateau, nonfinite provenance), oldest first."""
    return list(_FINDINGS)


# ----------------------------------------------------------------------
# pillar 1: tensor statistics
# ----------------------------------------------------------------------
#: exponent-field widths: the counts and the histogram read bit patterns
_EXP_BITS = {torch.bfloat16: 8, torch.float16: 5, torch.float32: 8, torch.float64: 11}
_INT_OF_SIZE = {2: torch.int16, 4: torch.int32, 8: torch.int64}


def _logical_parts(value, extent) -> List[torch.Tensor]:
    """The shards of a root cut to their logical extent (``(gshape,
    split)`` of the array that holds it; None: every element counts),
    flattened; empty shards dropped."""
    parts = list(value)
    if extent is not None and len(parts) > 1:
        gshape, split = extent
        if split is not None and split < parts[0].dim():
            n, block = int(gshape[split]), parts[0].shape[split]
            parts = [t.narrow(split, 0, max(0, min(block, n - i * block))) for i, t in enumerate(parts)]
    return [t.reshape(-1) for t in parts if t.numel()]


def _bit_fields(x: torch.Tensor):
    """(exponent field, mantissa field, exponent bits) of a flat float
    tensor, as signed integers masked after each shift."""
    size = x.element_size()
    ebits = _EXP_BITS[x.dtype]
    mbits = 8 * size - 1 - ebits
    bits = x.view(_INT_OF_SIZE[size])
    if size == 2:
        bits = bits.to(torch.int32) & 0xFFFF
    expf = (bits >> mbits) & ((1 << ebits) - 1)
    mant = bits & ((1 << mbits) - 1)
    return expf, mant, ebits


def _root_stats(parts: List[torch.Tensor]) -> Dict[str, Any]:
    """rms, absmax, nonfinite and subnormal counts and the exponent
    histogram of the logical elements ``parts`` (one float dtype). The sum
    of squares is scaled by absmax so that large maxima do not overflow the
    accumulator; one host read at the end."""
    dtype = parts[0].dtype
    acc = torch.float64 if dtype == torch.float64 else torch.float32
    n = sum(t.numel() for t in parts)
    counts, hists, maxima, clean = [], [], [], []
    for x in parts:
        expf, mant, ebits = _bit_fields(x)
        efield_max = (1 << ebits) - 1
        bias = (1 << (ebits - 1)) - 1
        span = max(1, efield_max - 1)  # the normal exponent codes
        nonfinite = expf == efield_max  # inf and nan
        zero = (expf == 0) & (mant == 0)
        subnormal = (expf == 0) & (mant != 0)
        # bucket by floor(log2|x|) over the dtype's own exponent range;
        # subnormals fall below the smallest normal and clip into bucket 0
        b = torch.clamp(((expf - bias - (1 - bias)) * N_BUCKETS) // span, 0, N_BUCKETS - 1)
        b = torch.where(nonfinite | zero, N_BUCKETS, b)  # uncounted: the extra bucket
        # one comparison per bucket: a bincount over few bins serializes on
        # its atomics when most elements share one
        hists.append(torch.stack([(b == i).sum() for i in range(N_BUCKETS)]))
        counts.append(torch.stack([nonfinite.sum(), subnormal.sum()]))
        xf = torch.where(nonfinite, torch.zeros((), dtype=x.dtype, device=x.device), x).to(acc)
        clean.append(xf)
        maxima.append(xf.abs().max())
    first = parts[0].device
    absmax = torch.stack([m.to(first) for m in maxima]).max()
    scale = torch.clamp(absmax, min=1e-30)
    sumsq = torch.stack([(xf / scale.to(xf.device)).square().sum().to(first) for xf in clean]).sum()
    rms = scale * torch.sqrt(sumsq / n)
    floats = torch.stack([rms, absmax]).double().cpu().tolist()
    ints = torch.stack([c.to(first) for c in counts]).sum(0).tolist()
    hist = torch.stack([h.to(first) for h in hists]).sum(0).tolist()
    return {"n": n, "rms": floats[0], "absmax": floats[1], "nonfinite": int(ints[0]), "subnormal": int(ints[1]),
            "hist": [int(v) for v in hist]}


def _record_stats(key: str, family: str, roots, values) -> None:
    rec = _STATS.get(key)
    if rec is None:
        while len(_STATS) >= _PROGRAM_CAP:
            _STATS.popitem(last=False)
        rec = _STATS[key] = {"family": family, "samples": 0, "roots": {}}
    rec["samples"] += 1
    for i, (root, value) in enumerate(zip(roots, values)):
        if not value or value[0].dtype not in _EXP_BITS:
            continue
        parts = _logical_parts(value, root.extent)
        if not parts:
            continue
        st = _root_stats(parts)
        hist = st["hist"]
        rr = rec["roots"].get(i)
        if rr is None:
            rr = rec["roots"][i] = {
                "shape": tuple(root.extent[0]) if root.extent is not None else tuple(value[0].shape),
                "dtype": str(value[0].dtype).replace("torch.", ""),
                "samples": 0,
                "elems": 0,
                "rms": 0.0,
                "absmax": 0.0,
                "nonfinite": 0,
                "subnormal": 0,
                "subnormal_pct": 0.0,
                "hist": [0] * N_BUCKETS,
                "edge_low": 0,
                "edge_high": 0,
            }
        rr["samples"] += 1
        rr["elems"] += st["n"]
        rr["rms"] = st["rms"]
        rr["absmax"] = max(rr["absmax"], st["absmax"])
        rr["nonfinite"] += st["nonfinite"]
        rr["subnormal"] += st["subnormal"]
        rr["subnormal_pct"] = round(100.0 * rr["subnormal"] / max(1, rr["elems"]), 4)
        rr["hist"] = [a + b for a, b in zip(rr["hist"], hist)]
        rr["edge_low"] = rr["hist"][0]
        rr["edge_high"] = rr["hist"][-1]
        telemetry.record_event(
            "numeric", event="stats", program=key, root=i, dtype=rr["dtype"], rms=st["rms"], absmax=st["absmax"],
            nonfinite=st["nonfinite"], subnormal_pct=rr["subnormal_pct"], edge_low=hist[0], edge_high=hist[-1],
        )


def tensor_stats() -> Dict[str, Dict[str, Any]]:
    """Per program key, the statistics of each root: rms, absmax, nonfinite
    and subnormal counts, the exponent histogram and its edge buckets."""
    with _LOCK:
        return {k: _copy_stats(v) for k, v in _STATS.items()}


def _copy_stats(rec: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(rec)
    out["roots"] = {i: dict(rr) for i, rr in rec["roots"].items()}
    return out


# ----------------------------------------------------------------------
# pillar 2: the ULP-aware drift audit
# ----------------------------------------------------------------------
_INT_FOR_SIZE = {2: np.int16, 4: np.int32, 8: np.int64}
_ULP_SENTINEL = 2**62  # stands in for "finiteness disagrees"


def ulp_diff(a, b) -> np.ndarray:
    """Elementwise ULP distance between two float arrays of one dtype
    (bf16, f16, f32, f64), as int64. Bit patterns go through the monotone
    signed-magnitude map (``i if i >= 0 else INT_MIN - i``, so -0.0 and
    +0.0 coincide) and are differenced in float64. Where both sides are
    nonfinite the distance is 0; where finiteness disagrees it saturates
    at ``2**62``. The drift audit runs the same arithmetic on the device
    (:func:`_ulp_tensor`)."""
    a = np.atleast_1d(np.asarray(a))
    b = np.atleast_1d(np.asarray(b))
    if a.dtype != b.dtype:
        raise TypeError(f"ulp_diff needs matching dtypes, got {a.dtype} vs {b.dtype}")
    itype = _INT_FOR_SIZE.get(a.dtype.itemsize)
    if itype is None or a.dtype.kind in "iub?":
        raise TypeError(f"ulp_diff: unsupported dtype {a.dtype}")
    ia = a.view(itype).astype(np.int64)
    ib = b.view(itype).astype(np.int64)
    mn = -(2 ** (8 * a.dtype.itemsize - 1))
    oa = np.where(ia >= 0, ia, mn - ia).astype(np.float64)
    ob = np.where(ib >= 0, ib, mn - ib).astype(np.float64)
    d = np.minimum(np.abs(oa - ob), float(_ULP_SENTINEL)).astype(np.int64)
    fa = np.isfinite(a.astype(np.float64))
    fb = np.isfinite(b.astype(np.float64))
    d = np.where(fa & fb, d, np.where(fa == fb, 0, _ULP_SENTINEL))
    return d


def _ulp_tensor(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """:func:`ulp_diff`'s arithmetic on two flat tensors of one float dtype,
    on their device; an int64 tensor."""
    size = a.element_size()
    itype = _INT_OF_SIZE[size]
    ia = a.contiguous().view(itype).to(torch.int64)
    ib = b.contiguous().view(itype).to(torch.int64)
    mn = -(2 ** (8 * size - 1))
    oa = torch.where(ia >= 0, ia, mn - ia).to(torch.float64)
    ob = torch.where(ib >= 0, ib, mn - ib).to(torch.float64)
    d = torch.clamp((oa - ob).abs(), max=float(_ULP_SENTINEL)).to(torch.int64)
    fa, fb = torch.isfinite(a), torch.isfinite(b)
    sentinel = torch.full((), _ULP_SENTINEL, dtype=torch.int64, device=a.device)
    zero = torch.zeros((), dtype=torch.int64, device=a.device)
    return torch.where(fa & fb, d, torch.where(fa == fb, zero, sentinel))


def _shadow_audit(sig, leaves, roots, values, info) -> None:
    """Run the program again through its plain module (``fusion._build``,
    op by op, what a degraded force runs) and compare each root's logical
    elements with the program's output ULP by ULP. Costs one op-by-op run
    of the chain per ``sample_every * shadow_every`` dispatches."""
    from . import fusion

    replay = fusion._build(sig)(*fusion._flat(leaves))
    key, family = info["key"], info.get("family", "?")
    diffs: List[torch.Tensor] = []
    pos = 0
    for root, value in zip(roots, values):
        mine = replay[pos:pos + len(value)]
        pos += len(value)
        if not value or value[0].dtype not in _EXP_BITS:
            continue
        got, ref = _logical_parts(value, root.extent), _logical_parts(mine, root.extent)
        first = value[0].device
        diffs.extend(_ulp_tensor(g, r).to(first) for g, r in zip(got, ref))
    if not diffs:
        return
    flat = torch.cat(diffs)
    lo, hi = _middle_values(flat)
    p50 = int((lo + hi) / 2)  # numpy's median: the mean of the middle two, truncated
    worst, mismatched = (int(v) for v in torch.stack([flat.max(), (flat >= _ULP_SENTINEL).sum()]).tolist())
    rec = _DRIFT.get(key)
    if rec is None:
        while len(_DRIFT) >= _PROGRAM_CAP:
            _DRIFT.popitem(last=False)
        rec = _DRIFT[key] = {"family": family, "samples": 0, "p50_ulp": 0, "max_ulp": 0, "nonfinite_mismatch": 0}
    rec["samples"] += 1
    rec["p50_ulp"] = max(rec["p50_ulp"], p50)
    rec["max_ulp"] = max(rec["max_ulp"], worst)
    rec["nonfinite_mismatch"] += mismatched
    telemetry.record_event("numeric", event="drift", program=key, family=family, p50_ulp=p50, max_ulp=worst)
    if worst > _MAX_ULP:
        _add_finding(
            "numlens.drift",
            "warning",
            f"shadow replay of program {key} (family {family}) drifted {worst} ULP from the fused output "
            f"(p50 {p50}, threshold {_MAX_ULP}) — the fused reorder left float tolerance",
            program=key,
            family=family,
            max_ulp=worst,
        )


#: the distances a median is counted over before it is found by selection
_MEDIAN_COUNTED = 16


def _middle_values(d: torch.Tensor):
    """The two middle values of the flat int64 distances ``d`` (equal for an
    odd count): counted below :data:`_MEDIAN_COUNTED` (drift is mostly a few
    ULP, and a selection over 10^8 elements costs far more than the count),
    else selected."""
    n = d.numel()
    ranks = ((n + 1) // 2, n // 2 + 1)
    below = torch.stack([(d <= t).sum() for t in range(_MEDIAN_COUNTED)]).tolist()
    out = []
    for k in ranks:
        t = next((t for t, c in enumerate(below) if c >= k), None)
        out.append(t if t is not None else int(d.kthvalue(k).values))
    return out


def drift_ledger() -> Dict[str, Any]:
    """Per program: samples, p50 and max ULP, op family; and the worst
    program overall."""
    with _LOCK:
        programs = {k: dict(v) for k, v in _DRIFT.items()}
    worst_key, worst = None, -1
    for k, v in programs.items():
        if v["max_ulp"] > worst:
            worst_key, worst = k, v["max_ulp"]
    return {
        "programs": programs,
        "max_ulp": max(worst, 0),
        "worst_program": worst_key,
        "worst_family": programs[worst_key]["family"] if worst_key else None,
    }


# ----------------------------------------------------------------------
# pillar 3: the determinism canary
# ----------------------------------------------------------------------
#: the canary's input: reorder-sensitive enough to catch a sick unit, tiny
#: enough to take microseconds per device
_CANARY_INPUT = (np.arange(96, dtype=np.float32) * 0.37) - 11.5


def _canary_program(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.exp(torch.sin(x) * 1.5) * x + torch.sqrt(torch.abs(x)))


def run_canary(repeats: int = 2, comm=None) -> Optional[Dict[str, Any]]:
    """Run the canary on every device of ``comm`` (default: the default
    mesh, if it exists already; else None, and nothing is built): the same
    input, ``repeats`` runs per device. A device must repeat itself bit for
    bit and agree with the majority; one that does not gets a
    ``numlens.sdc`` finding naming it and its index, and one fault in
    ``resilience.note_device_fault`` (three quarantine it). Returns
    ``{"devices", "mismatches", "ms"}``."""
    if comm is None:
        from . import communication

        comm = communication._built_comm()
        if comm is None:
            return None
    t0 = time.perf_counter()
    outs: Dict[int, Optional[bytes]] = {}
    sick: Dict[int, str] = {}
    devs = list(comm.devices)
    for idx, dev in enumerate(devs):
        try:
            resilience.check(f"numeric.sdc.{idx}")
            x = torch.from_numpy(_CANARY_INPUT).to(dev)
            got = [_canary_program(x).cpu().numpy().tobytes() for _ in range(max(2, int(repeats)))]
            if any(g != got[0] for g in got[1:]):
                sick[idx] = "self-inconsistent across repeats"
                outs[idx] = None
            else:
                outs[idx] = got[0]
        except resilience.FaultInjected:
            sick[idx] = "injected numeric.sdc corruption"
            outs[idx] = None
    votes = Counter(v for v in outs.values() if v is not None)
    if votes:
        majority = votes.most_common(1)[0][0]
        for idx, v in outs.items():
            if v is not None and v != majority and idx not in sick:
                sick[idx] = "bitwise mismatch vs device majority"
    ms = (time.perf_counter() - t0) * 1e3
    mismatches = []
    for idx in sorted(sick):
        dev, why = devs[idx], sick[idx]
        mismatches.append(str(dev))
        _add_finding(
            "numlens.sdc",
            "error",
            f"SDC canary: device {dev} (index {idx}) returned wrong bits ({why}) — replicated input must agree "
            "bitwise; reporting to the resilience quarantine ledger",
            device=str(dev),
            index=idx,
            why=why,
        )
        telemetry.record_event("numeric", event="sdc", device=str(dev), index=idx, why=why)
        try:
            resilience.note_device_fault(dev, site="numlens.sdc")
        except Exception:  # noqa: BLE001 - the ledger never stops the canary
            pass
    with _LOCK:
        _CANARY["runs"] = _CANARY.get("runs", 0) + 1
        _CANARY["devices"] = len(devs)
        _CANARY["mismatches"] = _CANARY.get("mismatches", 0) + len(mismatches)
        _CANARY["last_ms"] = round(ms, 3)
        _CANARY["last_sick"] = mismatches
    return {"devices": len(devs), "mismatches": mismatches, "ms": ms}


# ----------------------------------------------------------------------
# pillar 4: training streams (the DataParallel and DASO seam)
# ----------------------------------------------------------------------
def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _leaves(v)]
    if isinstance(tree, torch.Tensor) or hasattr(tree, "dtype"):
        return [tree]
    return []


def _f32(leaf) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to(torch.float32)
    return torch.as_tensor(np.asarray(leaf, dtype=np.float32))


def _tree_norm(tree) -> float:
    """The float32 norm of every leaf of ``tree`` together (tensors, arrays,
    or dicts and sequences of them)."""
    leaves = _leaves(tree)
    if not leaves:
        return 0.0
    first = _f32(leaves[0]).device
    total = sum(torch.sum(torch.square(_f32(leaf))).to(first) for leaf in leaves)
    return float(torch.sqrt(total))


def note_training(tag: str, *, loss=None, params=None, prev_params=None, grads=None) -> Optional[Dict[str, Any]]:
    """Record one step or merge of the stream ``tag``: the loss, the
    gradient norm (given ``grads``), the parameter norm, the update norm
    ``|params - prev_params|`` and the update ratio ``|Δp| / |p|``. Flags
    ``numlens.overflow`` (a nonfinite loss or update) and ``numlens.plateau``
    (the loss flat over the window). None, and nothing recorded, while the
    lens is off. ``prev_params`` must be a copy: an optimizer that updates
    in place changes the tensors ``params`` holds."""
    if not _MODE:
        return None
    try:
        rec = _TRAINING.get(tag)
        if rec is None:
            rec = _TRAINING[tag] = {
                "steps": 0,
                "losses": deque(maxlen=_TRAIN_WINDOW),
                "grad_norms": deque(maxlen=_TRAIN_WINDOW),
                "update_ratios": deque(maxlen=_TRAIN_WINDOW),
                "overflows": 0,
                "plateau": False,
            }
        rec["steps"] += 1
        out: Dict[str, Any] = {"tag": tag, "step": rec["steps"]}
        loss_f = None
        if loss is not None:
            try:
                loss_f = float(loss.item() if isinstance(loss, torch.Tensor) else loss)
            except Exception:  # noqa: BLE001 - an unreadable loss is left out
                loss_f = None
        if loss_f is not None:
            rec["losses"].append(loss_f)
            out["loss"] = loss_f
        if grads is not None:
            gn = _tree_norm(grads)
            rec["grad_norms"].append(gn)
            out["grad_norm"] = gn
        if params is not None and prev_params is not None:
            now, before = _leaves(params), _leaves(prev_params)
            un = _tree_norm([_f32(a) - _f32(b).to(_f32(a).device) for a, b in zip(now, before)])
            pn = _tree_norm(now)
            ratio = un / (pn + 1e-12)
            rec["update_ratios"].append(ratio)
            out["update_norm"] = un
            out["param_norm"] = pn
            out["update_ratio"] = ratio
        bad_loss = loss_f is not None and not math.isfinite(loss_f)
        bad_update = "update_norm" in out and not math.isfinite(out["update_norm"])
        if bad_loss or bad_update:
            rec["overflows"] += 1
            what = "loss" if bad_loss else "parameter update"
            _add_finding(
                "numlens.overflow",
                "error",
                f"training stream '{tag}' step {rec['steps']}: nonfinite {what} — gradients have overflowed",
                tag=tag,
                step=rec["steps"],
            )
        # plateau: the loss flat (relative) over the window; flagged once,
        # rearmed when the loss moves again
        losses = list(rec["losses"])
        if len(losses) >= _PLATEAU_WINDOW:
            win = losses[-_PLATEAU_WINDOW:]
            if all(math.isfinite(v) for v in win):
                spread = max(win) - min(win)
                scale = max(1e-12, abs(sum(win) / len(win)))
                flat = spread <= 1e-9 + 1e-6 * scale
                if flat and not rec["plateau"]:
                    rec["plateau"] = True
                    _add_finding(
                        "numlens.plateau",
                        "info",
                        f"training stream '{tag}' loss has been flat for {_PLATEAU_WINDOW} merges "
                        f"(spread {spread:.3e}) — plateau or dead gradients",
                        tag=tag,
                        step=rec["steps"],
                    )
                elif not flat:
                    rec["plateau"] = False
        telemetry.record_event(
            "numeric", event="train", tag=tag, step=rec["steps"],
            **{k: out[k] for k in ("loss", "grad_norm", "update_ratio") if k in out},
        )
        return out
    except Exception:  # noqa: BLE001 - observability never breaks training
        return None


def training_stats() -> Dict[str, Dict[str, Any]]:
    """Per stream: steps, last and least loss, last gradient norm and
    update ratio, overflow count, plateau flag."""
    out = {}
    with _LOCK:
        items = list(_TRAINING.items())
    for tag, rec in items:
        losses = list(rec["losses"])
        ratios = list(rec["update_ratios"])
        gnorms = list(rec["grad_norms"])
        out[tag] = {
            "steps": rec["steps"],
            "last_loss": losses[-1] if losses else None,
            "min_loss": min(losses) if losses else None,
            "last_grad_norm": gnorms[-1] if gnorms else None,
            "last_update_ratio": ratios[-1] if ratios else None,
            "overflows": rec["overflows"],
            "plateau": rec["plateau"],
        }
    return out


# ----------------------------------------------------------------------
# the fused-dispatch hook (telemetry._NUMLENS_HOOK)
# ----------------------------------------------------------------------
def _on_dispatch(sig, leaves, roots, values, info) -> None:
    """Called by ``fusion.force`` after a program's values land (``values``:
    each root's shard tensors). One counter per dispatch; statistics and the
    audit on sampled ones only. Never raises, never forces, skips while
    torch traces, and guards against reentry."""
    global _SEEN, _SAMPLED, _IN_HOOK
    frames = getattr(_NL_TLS, "frames", None)
    frame = frames[-1] if frames else None
    # the innermost frame's mode shadows the global one on this thread
    eff_mode = _MODE
    if frame is not None and frame["mode"] is not None:
        eff_mode = frame["mode"]
    if not eff_mode or _IN_HOOK or info is None:
        return
    _SEEN += 1
    if frame is not None:
        frame["seen"] += 1
    every = 1 if eff_mode >= 2 else max(1, _SAMPLE_EVERY)
    # a frame with a mode of its own samples on its own cadence
    seen = frame["seen"] if (frame is not None and frame["mode"] is not None) else _SEEN
    if (seen - 1) % every:
        return
    _IN_HOOK = True
    try:
        if torch.compiler.is_compiling():
            return
        _SAMPLED += 1
        if frame is not None:
            frame["sampled"] += 1
        _record_stats(info["key"], info.get("family", "?"), roots, values)
        if _SHADOW_EVERY > 0 and _SAMPLED % _SHADOW_EVERY == 0:
            _shadow_audit(sig, leaves, roots, values, info)
        if _CANARY_EVERY > 0 and _SAMPLED % _CANARY_EVERY == 0:
            run_canary()
    except Exception:  # noqa: BLE001 - the lens never breaks a dispatch
        pass
    finally:
        _IN_HOOK = False


# ----------------------------------------------------------------------
# the report block (module state only)
# ----------------------------------------------------------------------
def sampling_stats() -> Dict[str, int]:
    """Dispatches seen and sampled since the last reset."""
    return {"dispatches_seen": _SEEN, "dispatches_sampled": _SAMPLED}


def numerics_block() -> Dict[str, Any]:
    """``report()["numerics"]``: mode and knobs, the sampling counters, the
    statistics, the drift ledger, the canary, the training streams and the
    findings. Module state only: safe before any mesh exists."""
    return {
        "mode": mode(),
        "sample_every": _SAMPLE_EVERY,
        "shadow_every": _SHADOW_EVERY,
        "dispatches_seen": _SEEN,
        "dispatches_sampled": _SAMPLED,
        "tensor_stats": tensor_stats(),
        "drift": drift_ledger(),
        "canary": dict(_CANARY),
        "training": training_stats(),
        "findings": findings(),
    }


# armed from the environment at import (an unarmed import leaves the
# dispatch seam untouched)
set_mode(os.environ.get("HEAT_TPU_NUMLENS", "0"))
