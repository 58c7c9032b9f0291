"""Verified, sharded, crash-consistent checkpoints (reference:
heat_tpu/utils/checkpoint.py), in the JAX package's manifest format.

A checkpoint at ``step`` is a JSON manifest ``ckpt_<step>.manifest.json``
and a payload directory ``ckpt_<step>`` (``ckpt_<step>.r1`` when a save
overwrites a committed step) of per-leaf files, with the same keys, file
names and bytes as heat_tpu writes, so either package restores what the
other saved:

* a DNDarray leaf is one file per shard with logical rows
  (``leaf_<i>.shard_<rank>``, its ``start``/``stop`` along the split in the
  manifest), or one ``.shard_full`` file when replicated; each shard is
  copied to the host on its own, the array is never gathered;
* a tensor or numpy leaf is one ``leaf_<i>.arr`` file;
* plain Python leaves (bool, int, float with inf and nan, str) are written
  into the manifest.

Files are ``.npy`` except bfloat16, which numpy lacks: its bytes are
written ``"raw"`` with the dtype name recorded, through an int16 view.
Every file's SHA-256 comes from its write stream. The leaves are found as
``jax.tree_util`` finds them, and keyed by the same path strings: dicts in
sorted key order (``OrderedDict`` in its own), lists and tuples by index,
``None`` holding no leaf.

The manifest's rename is the commit point: a crash leaves the previous
checkpoint or the new one. :func:`load_checkpoint` verifies every checksum
before it restores, falls back past an unverifiable newest step with a
:class:`CheckpointCorruptWarning` (or raises under ``strict``), and
restores a DNDarray onto the current mesh whatever its size at save time,
reading each shard's rows from the saved files' ``start``/``stop``. Keep-N
retention never deletes the last step that verifies and sweeps staging
debris older than the newest manifest.

Left out: the legacy single-blob flax-msgpack format
(``ckpt_<step>.msgpack``) needs flax; the port lists such steps and raises
``NotImplementedError`` naming the format when asked to restore one.

Fault sites and retries (``core/resilience.py``, heat_tpu/utils/checkpoint.py
:101-132, 913-1079): each payload-file write retries transient ``OSError``s
at ``checkpoint.write``, the manifest's publication at ``checkpoint.commit``
(a hard fault there leaves the previous checkpoint committed), every
verify and restore read at ``checkpoint.restore``, and each GC deletion
fires ``checkpoint.gc`` (a failure degrades to a warning). Telemetry counts
the lifecycle in ``telemetry.checkpoint_events()`` (``save``, ``restore``,
``corrupt``, ``fallback``, ``gc``); verbose telemetry adds a
``checkpoint_phase`` event at each phase boundary.
"""

from __future__ import annotations

import ast
import hashlib
import json
import os
import re
import shutil
import warnings
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import io, memledger, resilience, telemetry

__all__ = [
    "CheckpointCorruptError",
    "CheckpointCorruptWarning",
    "MANIFEST_VERSION",
    "all_steps",
    "gc_checkpoints",
    "latest_step",
    "load_checkpoint",
    "save_checkpoint",
    "verify_checkpoint",
]

MANIFEST_VERSION = 1
_FORMAT_NAME = "heat-tpu-checkpoint"

_MANIFEST_RE = re.compile(r"^ckpt_(\d+)\.manifest\.json$")
_LEGACY_RE = re.compile(r"^ckpt_(\d+)\.msgpack$")
_LEGACY_TMP_RE = re.compile(r"^ckpt_(\d+)\.msgpack\.tmp$")
_PAYLOAD_RE = re.compile(r"^ckpt_(\d+)(\.r\d+)?$")

# the forcing attribution of the host copies a save makes
_T_IO = telemetry.force_trigger("io")


def _phase(phase: str, step=None, **fields) -> None:
    """One ``checkpoint_phase`` timeline event (verbose mode only), apart
    from the lifecycle counts of ``telemetry.checkpoint_events()``."""
    if telemetry._MODE >= 2:
        telemetry.record_event("checkpoint_phase", phase=phase, step=step, **fields)


class CheckpointCorruptError(RuntimeError):
    """A checkpoint failed verification (a torn payload, a checksum
    mismatch) and the policy forbids, or could not find, a fallback."""


class CheckpointCorruptWarning(UserWarning):
    """Restore skipped unverifiable checkpoints and fell back to the newest
    one that verifies."""


def _legacy_error(path: str) -> NotImplementedError:
    return NotImplementedError(
        f"{path!r} is a legacy flax-msgpack checkpoint: heat_tpu_torch cannot read that format "
        "(it needs flax); restore it with heat_tpu and save it again in the manifest format"
    )


# ----------------------------------------------------------------------
# leaves: host copies, dtypes, the tree's paths
# ----------------------------------------------------------------------
def _dtype_name(t: torch.dtype) -> str:
    if t == torch.bfloat16:
        return "bfloat16"
    return torch.empty(0, dtype=t).numpy().dtype.name


def _np_dtype(name: str) -> np.dtype:
    """The numpy type a recorded dtype name is read as: bfloat16's raw
    bytes as int16."""
    if name == "bfloat16":
        return np.dtype(np.int16)
    try:
        return np.dtype(name)
    except TypeError as exc:
        raise TypeError(f"checkpoint dtype {name!r} has no counterpart in heat_tpu_torch") from exc


def _is_native_npy_dtype(dtype: np.dtype) -> bool:
    return dtype.kind in "biufc" and dtype.names is None


def _host(x) -> Tuple[np.ndarray, str]:
    """A tensor or array leaf as a host numpy array and its dtype name;
    bfloat16 as the int16 view of its bytes."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        return t.numpy(), _dtype_name(t.dtype)
    arr = np.asarray(x)
    if not _is_native_npy_dtype(arr.dtype):
        raise TypeError(
            f"checkpoint leaf of dtype {arr.dtype!r} cannot be round-tripped "
            "(supported: bool/int/uint/float/complex and bfloat16 tensors)"
        )
    return arr, arr.dtype.name


def _from_file(block: np.ndarray, name: str) -> torch.Tensor:
    """A block read from a payload file as a tensor that owns its memory."""
    block = np.array(block, order="C") if not block.flags.writeable or not block.flags.c_contiguous else block
    t = torch.from_numpy(block)
    return t.view(torch.bfloat16) if name == "bfloat16" else t


def _encode_py(v):
    """JSON form of a plain Python leaf (inf and nan included)."""
    if isinstance(v, float):
        return v if np.isfinite(v) else {"__nonfinite__": repr(v)}
    if v is None or isinstance(v, (bool, int, str)):
        return v
    raise TypeError(
        f"checkpoint leaf of type {type(v).__name__} is not serializable "
        "(arrays, DNDarrays, and plain Python scalars/strings are)"
    )


def _decode_py(v):
    if isinstance(v, dict) and "__nonfinite__" in v:
        return float(v["__nonfinite__"])
    return v


def _is_arraylike(x) -> bool:
    return isinstance(x, torch.Tensor) or hasattr(x, "dtype") or hasattr(x, "__array__")


def _children(node) -> Optional[List[Tuple[Any, Any]]]:
    """``(key, child)`` pairs of a container node in jax's order, or None
    for a leaf."""
    if isinstance(node, OrderedDict):
        return list(node.items())
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if type(node) in (list, tuple):
        return list(enumerate(node))
    return None


def _flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """``(path, leaf)`` pairs of ``tree``, in jax's order and with its
    ``keystr`` paths; a DNDarray is a leaf, ``None`` has no leaves."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for key, child in kids:
        out.extend(_flatten(child, f"{prefix}[{key!r}]"))
    return out


def _unflatten(tree, values: Dict[str, Any], prefix: str = ""):
    """``tree`` with each leaf replaced by ``values[path]``; an empty dict
    of the template takes the checkpoint's entries below its path."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return values[prefix]
    if isinstance(tree, dict) and not tree:
        return _open_dict(values, prefix)
    rebuilt = [(key, _unflatten(child, values, f"{prefix}[{key!r}]")) for key, child in kids]
    if isinstance(tree, dict):
        by_key = dict(rebuilt)
        out = OrderedDict() if isinstance(tree, OrderedDict) else {}
        for key in tree:  # the template's own key order
            out[key] = by_key[key]
        return out
    return type(tree)(value for _, value in rebuilt)


def _parse_path(path: str) -> List[Any]:
    """The keys of a ``keystr`` path: ``"['a'][0]"`` -> ``['a', 0]``."""
    keys, i = [], 0
    while i < len(path):
        j = path.index("]", i)
        while True:
            try:
                keys.append(ast.literal_eval(path[i + 1 : j]))
                break
            except (ValueError, SyntaxError):
                j = path.index("]", j + 1)
        i = j + 1
    return keys


def _open_dict(values: Dict[str, Any], prefix: str) -> dict:
    """The checkpoint's leaves below ``prefix`` as nested dicts."""
    out: dict = {}
    for path, value in values.items():
        if path.startswith(prefix) and path != prefix:
            keys = _parse_path(path[len(prefix):])
            node = out
            for key in keys[:-1]:
                node = node.setdefault(key, {})
            node[keys[-1]] = value
    return out


def _open_prefixes(tree, prefix: str = "") -> List[str]:
    """Paths of the template's empty dicts."""
    if isinstance(tree, dict) and not tree:
        return [prefix]
    kids = _children(tree) if tree is not None else None
    if not kids:
        return []
    out = []
    for key, child in kids:
        out.extend(_open_prefixes(child, f"{prefix}[{key!r}]"))
    return out


# ----------------------------------------------------------------------
# directory enumeration
# ----------------------------------------------------------------------
def _committed(directory: str) -> Dict[int, str]:
    """step -> committed artifact name (a manifest wins over a legacy blob
    of the same step)."""
    out: Dict[int, str] = {}
    try:
        names = os.listdir(directory)
    except FileNotFoundError:
        return out
    for name in names:
        m = _LEGACY_RE.match(name)
        if m:
            out.setdefault(int(m.group(1)), name)
    for name in names:
        m = _MANIFEST_RE.match(name)
        if m:
            out[int(m.group(1))] = name
    return out


def all_steps(directory: str) -> List[int]:
    """Every committed step in ``directory``, ascending (commitment, not
    validity: a step may still fail :func:`verify_checkpoint`)."""
    return sorted(_committed(directory))


def latest_step(directory: str) -> Optional[int]:
    """The newest committed step in ``directory``, or None."""
    steps = all_steps(directory)
    return steps[-1] if steps else None


def _manifest_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"ckpt_{int(step)}.manifest.json")


def _legacy_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"ckpt_{int(step)}.msgpack")


def _read_manifest(directory: str, step: int) -> dict:
    path = _manifest_path(directory, step)

    def _read():
        with open(path, "r") as fh:
            return json.load(fh)

    return resilience.call_with_retries("checkpoint.restore", _read)


# ----------------------------------------------------------------------
# payload writers
# ----------------------------------------------------------------------
class _HashingWriter:
    """A file pass-through that hashes every byte written through it, so a
    file's checksum comes from its write stream, never a read back."""

    __slots__ = ("fh", "h", "n")

    def __init__(self, fh):
        self.fh = fh
        self.h = hashlib.sha256()
        self.n = 0

    def write(self, b) -> int:
        self.h.update(b)
        self.n += len(b)
        return self.fh.write(b)


def _write_payload_file(path: str, arr: np.ndarray, raw: bool) -> Tuple[str, int]:
    """Write one payload file under a temporary name and rename it; return
    its ``(sha256, bytes)``. A transient ``OSError`` re-runs the attempt
    (``checkpoint.write``)."""

    def _attempt() -> Tuple[str, int]:
        tmp = f"{path}.tmp-{os.getpid()}-0"
        try:
            with open(tmp, "wb") as fh:
                w = _HashingWriter(fh)
                if raw:
                    w.write(np.ascontiguousarray(arr).tobytes())
                else:
                    np.save(w, arr)
            os.replace(tmp, path)
            return w.h.hexdigest(), w.n
        except BaseException:
            resilience._unlink_quiet(tmp)
            raise

    return resilience.call_with_retries("checkpoint.write", _attempt)


def _file_entry(payload_rel: str, fname: str, name: str, shape) -> dict:
    return {
        "file": f"{payload_rel}/{fname}",
        "format": "raw" if name == "bfloat16" else "npy",
        "dtype": name,
        "shape": [int(s) for s in shape],
        "sha256": None,
        "bytes": None,
    }


def _write_frag(frag: dict, payload_dir: str, fname: str, arr: np.ndarray) -> None:
    frag["sha256"], frag["bytes"] = _write_payload_file(
        os.path.join(payload_dir, fname), arr, frag["format"] == "raw"
    )


def _save_dndarray(payload_dir: str, payload_rel: str, base: str, leaf) -> dict:
    """Write a DNDarray leaf, shard by shard; return its manifest entry."""
    split = leaf.split
    name = _dtype_name(leaf.dtype.torch_type())
    entry: dict = {
        "kind": "dndarray",
        "gshape": [int(s) for s in leaf.shape],
        "dtype": name,
        "split": None if split is None else int(split),
        "mesh_size": int(leaf.comm.size),
        "files": [],
    }
    if split is None or leaf.ndim == 0:
        fname = f"{base}.shard_full"
        frag = _file_entry(payload_rel, fname, name, leaf.shape)
        frag["rank"] = None
        _write_frag(frag, payload_dir, fname, _host(leaf.shards[0])[0])
        entry["files"].append(frag)
        return entry
    counts, displs = leaf.comm.counts_displs_shape(leaf.shape, split)
    for r, (shard, count, displ) in enumerate(zip(leaf.shards, counts, displs)):
        if not count:
            continue
        bshape = list(leaf.shape)
        bshape[split] = count
        fname = f"{base}.shard_{r:05d}"
        frag = _file_entry(payload_rel, fname, name, bshape)
        frag["rank"] = r
        frag["start"] = int(displ)
        frag["stop"] = int(displ + count)
        _write_frag(frag, payload_dir, fname, _host(shard.narrow(split, 0, count))[0])
        entry["files"].append(frag)
    return entry


def _payload_rel_for_save(directory: str, step: int) -> str:
    """The staging directory of a save of ``step``: ``ckpt_<step>``, or
    ``ckpt_<step>.r1`` when a committed manifest of the same step uses the
    former, so a committed payload is never written into."""
    base = f"ckpt_{int(step)}"
    if os.path.exists(_manifest_path(directory, step)):
        try:
            current = _read_manifest(directory, step).get("payload")
        except Exception:  # noqa: BLE001 - an unreadable manifest: stage under a new name
            cand, k = base, 0
            while os.path.exists(os.path.join(directory, cand)):
                k += 1
                cand = f"{base}.r{k}"
            return cand
        if current == base:
            return base + ".r1"
    return base


# ----------------------------------------------------------------------
# save
# ----------------------------------------------------------------------
def save_checkpoint(directory: str, tree: Any, step: int = 0, keep: int = 3) -> str:
    """Write ``tree`` as a checkpoint of ``step`` in ``directory``: the
    payload files, then ``ckpt_<step>.manifest.json`` with every file's
    SHA-256, renamed into place as the commit point; then keep-N retention
    and the debris sweep (``keep <= 0`` keeps every step). Returns the
    manifest's path."""
    from ..core.dndarray import DNDarray

    step = int(step)
    os.makedirs(directory, exist_ok=True)
    payload_rel = _payload_rel_for_save(directory, step)
    payload_dir = os.path.join(directory, payload_rel)
    os.makedirs(payload_dir, exist_ok=True)
    leaves = _flatten(tree)
    _phase("save_begin", step, leaves=len(leaves))
    _phase("save_materialized", step)
    entries: List[dict] = []
    for i, (path, leaf) in enumerate(leaves):
        base = f"leaf_{i:05d}"
        if isinstance(leaf, DNDarray):
            with _T_IO:
                entry = _save_dndarray(payload_dir, payload_rel, base, leaf)
        elif _is_arraylike(leaf):
            with _T_IO:
                arr, name = _host(leaf)
            fname = f"{base}.arr"
            frag = _file_entry(payload_rel, fname, name, arr.shape)
            _write_frag(frag, payload_dir, fname, arr)
            entry = {"kind": "array", "files": [frag]}
        else:
            entry = {"kind": "py", "value": _encode_py(leaf)}
        entry["path"] = path
        entries.append(entry)
    doc = {
        "format": _FORMAT_NAME,
        "version": MANIFEST_VERSION,
        "step": step,
        "payload": payload_rel,
        "leaves": entries,
    }
    _phase("save_staged", step, leaves=len(entries))
    manifest_path = _manifest_path(directory, step)

    def _commit():
        with resilience.atomic_write(manifest_path) as tmp:
            with open(tmp, "w") as fh:
                json.dump(doc, fh, indent=1)
                fh.write("\n")

    resilience.call_with_retries("checkpoint.commit", _commit)
    telemetry.record_checkpoint("save", step)
    _phase("save_committed", step)
    gc_checkpoints(directory, keep=keep, protect_step=step)
    return manifest_path


# ----------------------------------------------------------------------
# verification
# ----------------------------------------------------------------------
def _sha256_file(path: str) -> str:
    """The streamed SHA-256 of ``path``, its read retried."""

    def _hash() -> str:
        h = hashlib.sha256()
        with open(path, "rb") as fh:
            while True:
                chunk = fh.read(1 << 20)
                if not chunk:
                    break
                h.update(chunk)
        return h.hexdigest()

    return resilience.call_with_retries("checkpoint.restore", _hash)


def verify_checkpoint(directory: str, step: int) -> List[str]:
    """The problems of the committed checkpoint of ``step`` (empty when it
    verifies): the manifest must parse, and every payload file must exist
    with the recorded size and SHA-256. A legacy flax-msgpack step cannot
    be checked here and is reported as a problem."""
    step = int(step)
    if os.path.exists(_manifest_path(directory, step)):
        return _verify_manifest_artifact(directory, step)
    if os.path.exists(_legacy_path(directory, step)):
        return [str(_legacy_error(_legacy_path(directory, step)))]
    return [f"no committed checkpoint for step {step}"]


def _verify_manifest_artifact(directory: str, step: int) -> List[str]:
    try:
        doc = _read_manifest(directory, step)
    except Exception as exc:  # noqa: BLE001 - any parse failure is a torn manifest
        return [f"manifest unreadable: {exc!r}"]
    if doc.get("format") != _FORMAT_NAME:
        return [f"manifest format {doc.get('format')!r} is not {_FORMAT_NAME!r}"]
    if int(doc.get("version", -1)) > MANIFEST_VERSION:
        return [f"manifest version {doc.get('version')} is newer than supported {MANIFEST_VERSION}"]
    problems = []
    for entry in doc.get("leaves", ()):
        for frag in entry.get("files", ()):
            full = os.path.join(directory, frag["file"])
            try:
                size = resilience.call_with_retries("checkpoint.restore", os.path.getsize, full)
            except FileNotFoundError:
                problems.append(f"missing payload file {frag['file']}")
                continue
            except OSError as exc:
                problems.append(f"payload file {frag['file']} unreadable: {exc!r}")
                continue
            if frag.get("bytes") is not None and size != frag["bytes"]:
                problems.append(f"payload file {frag['file']} is {size} bytes, manifest says {frag['bytes']}")
                continue
            try:
                if frag.get("sha256") and _sha256_file(full) != frag["sha256"]:
                    problems.append(f"payload file {frag['file']} fails its SHA-256 check")
            except OSError as exc:
                problems.append(f"payload file {frag['file']} unreadable: {exc!r}")
    return problems


# ----------------------------------------------------------------------
# restore
# ----------------------------------------------------------------------
def _read_array_file(directory: str, frag: dict) -> np.ndarray:
    full = os.path.join(directory, frag["file"])
    shape = tuple(frag["shape"])

    def _read():
        if frag["format"] == "npy":
            return np.load(full, allow_pickle=False)
        return np.fromfile(full, dtype=_np_dtype(frag["dtype"])).reshape(shape)

    arr = resilience.call_with_retries("checkpoint.restore", _read)
    if tuple(arr.shape) != shape:
        raise CheckpointCorruptError(f"payload file {frag['file']} holds shape {tuple(arr.shape)}, manifest says {shape}")
    return arr


def _open_array_lazy(directory: str, frag: dict):
    """A memory-mapped view of a payload file: block reads page in only
    their rows."""
    full = os.path.join(directory, frag["file"])
    if frag["format"] == "npy":
        return np.load(full, mmap_mode="r", allow_pickle=False)
    return np.memmap(full, dtype=_np_dtype(frag["dtype"]), mode="r", shape=tuple(frag["shape"]))


def _restore_array(directory: str, entry: dict, template, path: str):
    """An array leaf: a tensor on the template tensor's device, a numpy
    array for a numpy template, a CPU tensor where the template has none
    (bfloat16, which numpy lacks, always as a tensor)."""
    frag = entry["files"][0]
    arr = _read_array_file(directory, frag)
    tshape = getattr(template, "shape", None)
    if tshape is not None and tuple(tshape) != tuple(arr.shape):
        raise ValueError(
            f"checkpoint leaf {path!r} has shape {tuple(arr.shape)}, target template has {tuple(tshape)}"
        )
    if isinstance(template, (np.ndarray, np.generic)) and frag["dtype"] != "bfloat16":
        return arr
    t = _from_file(arr, frag["dtype"])
    return t.to(template.device) if isinstance(template, torch.Tensor) else t


def _restore_dndarray(directory: str, entry: dict, template) -> Any:
    """A DNDarray leaf onto the current mesh: the template's mesh, device
    and split (or the default ones and the saved split), each shard's block
    read from the saved files it overlaps, whatever the mesh size at save
    time."""
    from ..core import factories, types
    from ..core.dndarray import DNDarray, _wrap

    gshape = tuple(int(s) for s in entry["gshape"])
    name = entry["dtype"]
    dtype = types.bfloat16 if name == "bfloat16" else types.canonical_heat_type(np.dtype(name))
    saved_split = entry["split"]
    out_split = saved_split
    if isinstance(template, DNDarray):
        comm, device = template.comm, template.device
        out_split = template.split
        if tuple(template.shape) != gshape:
            raise ValueError(
                f"checkpoint leaf {entry['path']!r} has global shape {gshape}, target template has {tuple(template.shape)}"
            )
    else:
        device, comm = factories._resolve(None, None)

    def convert(block, tdt=None):
        return _from_file(np.asarray(block), name)

    if saved_split is None or not gshape:
        t = convert(_read_array_file(directory, entry["files"][0]))
        return _wrap(t.to(comm.devices[0]), None if out_split is None or not gshape else int(out_split) % len(gshape), device, comm)
    saved_split = int(saved_split) % len(gshape)
    shards = [
        (frag["start"], frag["stop"], _open_array_lazy(directory, frag))
        for frag in sorted((f for f in entry["files"] if f.get("rank") is not None), key=lambda f: f["start"])
    ]

    def read_block(sl):
        sl = tuple(slice(s.start or 0, gshape[d] if s.stop is None else s.stop) for d, s in enumerate(sl))
        lo, hi = sl[saved_split].start, sl[saved_split].stop
        pieces = []
        for start, stop, mm in shards:
            s, e = max(lo, start), min(hi, stop)
            if s < e:
                idx = list(sl)
                idx[saved_split] = slice(s - start, e - start)
                pieces.append(np.asarray(mm[tuple(idx)]))
        if not pieces:
            shape = [sl[d].stop - sl[d].start for d in range(len(gshape))]
            shape[saved_split] = 0
            return np.empty(tuple(shape), dtype=_np_dtype(name))
        return pieces[0] if len(pieces) == 1 else np.concatenate(pieces, axis=saved_split)

    if out_split is None:
        full = convert(resilience.call_with_retries("checkpoint.restore", read_block, tuple(slice(0, s) for s in gshape)))
        return _wrap(full.to(comm.devices[0]), None, device, comm)
    with memledger.owner_scope("checkpoint"):
        # the staged shards count under "checkpoint" in the memory ledger
        # until the restored array claims them
        return io._ingest(read_block, gshape, dtype, int(out_split) % len(gshape), device, comm, convert=convert)


def _restore_manifest(directory: str, step: int, target: Any) -> Any:
    from ..core.dndarray import DNDarray

    doc = _read_manifest(directory, step)
    flat = _flatten(target)
    by_path = {e["path"]: e for e in doc.get("leaves", ())}
    paths = [p for p, _ in flat]
    opens = _open_prefixes(target)
    under_open = {p for p in by_path if any(p.startswith(o) and p != o for o in opens)}
    missing = sorted(set(paths) - set(by_path))
    extra = sorted(set(by_path) - set(paths) - under_open)
    if missing or extra:
        raise ValueError(
            f"checkpoint step {step} does not match the target structure: "
            f"missing from checkpoint {missing[:5]}, not in target {extra[:5]}"
        )
    templates = dict(flat)
    values: Dict[str, Any] = {}
    for path in paths + sorted(under_open):
        entry = by_path[path]
        tleaf = templates.get(path)
        kind = entry["kind"]
        if kind == "py":
            values[path] = _decode_py(entry["value"])
        elif kind == "array":
            values[path] = _restore_array(directory, entry, tleaf, path)
        elif kind == "dndarray":
            values[path] = _restore_dndarray(directory, entry, tleaf if isinstance(tleaf, DNDarray) else None)
        else:
            raise CheckpointCorruptError(f"checkpoint step {step} in {directory!r}: unknown leaf kind {kind!r}")
    telemetry.record_checkpoint("restore", step)
    _phase("restore_done", step, leaves=len(values))
    return _unflatten(target, values)


def _restore_step(directory: str, step: int, target: Any) -> Any:
    _phase("restore_begin", step)
    return _restore_manifest(directory, step, target)


def load_checkpoint(directory: str, target: Any, step: Optional[int] = None, strict: bool = False) -> Any:
    """Restore a checkpoint into the structure of ``target``, a template
    tree whose leaves' shapes validate the restore and whose DNDarrays name
    the mesh, device and split to restore onto; an empty dict in it takes
    whatever the checkpoint holds below it. ``step=None`` loads the newest
    step that verifies: unverifiable newer steps are skipped with a
    :class:`CheckpointCorruptWarning`, or raise
    :class:`CheckpointCorruptError` under ``strict``. An explicit ``step``
    that is missing raises ``FileNotFoundError`` naming the steps there, one
    that fails verification :class:`CheckpointCorruptError`. A manifest's
    own path is accepted as ``directory``."""
    if os.path.isfile(directory):
        name = os.path.basename(directory)
        parent = os.path.dirname(directory) or "."
        m = _MANIFEST_RE.match(name)
        if m is None:
            raise _legacy_error(directory)
        file_step = int(m.group(1))
        problems = _verify_manifest_artifact(parent, file_step)
        if problems:
            telemetry.record_checkpoint("corrupt", file_step)
            raise CheckpointCorruptError(
                f"checkpoint {directory!r} (step {file_step}) failed verification: "
                f"{'; '.join(problems[:3])} — no fallback (explicit file path given)"
            )
        return _restore_manifest(parent, file_step, target)

    steps = all_steps(directory)
    if not steps:
        raise FileNotFoundError(f"no checkpoints in {directory!r}")
    committed = _committed(directory)
    if step is not None:
        step = int(step)
        if step not in steps:
            raise FileNotFoundError(f"no checkpoint for step {step} in {directory!r}; available steps: {steps}")
        if _LEGACY_RE.match(committed[step]):
            raise _legacy_error(_legacy_path(directory, step))
        problems = _verify_manifest_artifact(directory, step)
        if problems:
            telemetry.record_checkpoint("corrupt", step)
            raise CheckpointCorruptError(
                f"checkpoint step {step} in {directory!r} failed verification: "
                f"{'; '.join(problems[:3])} — no fallback (explicit step= requested)"
            )
        return _restore_step(directory, step, target)

    skipped: List[Tuple[int, List[str]]] = []
    for s in reversed(steps):
        if _LEGACY_RE.match(committed[s]):
            raise _legacy_error(_legacy_path(directory, s))
        problems = _verify_manifest_artifact(directory, s)
        if not problems:
            if skipped:
                telemetry.record_checkpoint("fallback", s)
                warnings.warn(
                    CheckpointCorruptWarning(
                        f"checkpoint step(s) {[t for t, _ in skipped]} in {directory!r} "
                        f"failed verification ({skipped[0][1][0]}); falling back to the "
                        f"newest checkpoint that verifies: step {s}"
                    ),
                    stacklevel=2,
                )
            return _restore_step(directory, s, target)
        telemetry.record_checkpoint("corrupt", s)
        if strict:
            raise CheckpointCorruptError(
                f"checkpoint step {s} in {directory!r} failed verification: "
                f"{'; '.join(problems[:3])} — strict=True forbids falling back "
                f"to an older checkpoint (available steps: {steps})"
            )
        skipped.append((s, problems))
    raise CheckpointCorruptError(
        f"no checkpoint in {directory!r} verifies — tried steps "
        f"{[t for t, _ in skipped]}; newest failure: {skipped[0][1][:3]}"
    )


# ----------------------------------------------------------------------
# retention + debris GC
# ----------------------------------------------------------------------
def gc_checkpoints(directory: str, keep: int = 3, protect_step: Optional[int] = None) -> None:
    """Keep-N retention that never deletes the last step that verifies,
    and a sweep of staging debris (``*.tmp-*`` files, payload directories
    no manifest references) older than the newest manifest. A failure
    degrades to a warning and leaves the rest for the next sweep (the
    ``checkpoint.gc`` site fires at the sweep's start and before each
    deletion)."""
    try:
        swept = _gc_inner(directory, keep, protect_step)
        if swept:
            telemetry.record_checkpoint("gc", protect_step, detail=f"removed {swept}")
    except Exception as exc:  # noqa: BLE001 - GC must never fail the save
        warnings.warn(f"checkpoint GC in {directory!r} failed ({exc!r}); debris left for the next sweep", stacklevel=2)


def _gc_remove(path: str, tree: bool = False) -> bool:
    try:
        if resilience._ARMED:
            resilience.check("checkpoint.gc")
        if tree:
            shutil.rmtree(path)
        else:
            os.remove(path)
        return True
    except OSError:
        return False


def _gc_inner(directory: str, keep: int, protect_step: Optional[int]) -> int:
    if resilience._ARMED:
        resilience.check("checkpoint.gc")
    committed = _committed(directory)
    steps = sorted(committed)
    swept = 0
    protect_valid: Optional[int] = None
    if keep > 0 and len(steps) > keep:
        kept, doomed = steps[-keep:], steps[:-keep]
        kept_has_valid = protect_step in kept or any(not verify_checkpoint(directory, s) for s in reversed(kept))
        if not kept_has_valid:
            for s in reversed(doomed):
                if not verify_checkpoint(directory, s):
                    protect_valid = s
                    break
        for s in doomed:
            if s not in (protect_step, protect_valid):
                swept += _delete_step(directory, s)

    manifest_mtimes = []
    referenced = set()
    unreadable_steps = set()
    for s, name in _committed(directory).items():
        if _MANIFEST_RE.match(name):
            try:
                manifest_mtimes.append(os.path.getmtime(os.path.join(directory, name)))
                referenced.add(_read_manifest(directory, s).get("payload"))
            except Exception:  # noqa: BLE001 - protect every payload of an unreadable step
                unreadable_steps.add(s)
    if not manifest_mtimes:
        return swept
    newest = max(manifest_mtimes)

    def _older(path: str) -> bool:
        try:
            return os.path.getmtime(path) < newest
        except OSError:
            return False

    for name in sorted(os.listdir(directory)):
        full = os.path.join(directory, name)
        if os.path.isdir(full):
            m = _PAYLOAD_RE.match(name)
            if m and name not in referenced and int(m.group(1)) not in unreadable_steps and _older(full):
                swept += _gc_remove(full, tree=True)
            elif name in referenced:
                for sub in os.listdir(full):
                    subfull = os.path.join(full, sub)
                    if ".tmp-" in sub and _older(subfull):
                        swept += _gc_remove(subfull)
        elif (_LEGACY_TMP_RE.match(name) or ".tmp-" in name) and _older(full):
            swept += _gc_remove(full)
    return swept


def _delete_step(directory: str, step: int) -> int:
    """Delete one committed step: a legacy blob first, then the manifest
    (the commit point), and only then its payload directory."""
    removed = 0
    lpath = _legacy_path(directory, step)
    if os.path.exists(lpath):
        if not _gc_remove(lpath):
            return removed
        removed += 1
    mpath = _manifest_path(directory, step)
    if os.path.exists(mpath):
        try:
            payload = _read_manifest(directory, step).get("payload")
        except Exception:  # noqa: BLE001 - a torn manifest is still deleted
            payload = None
        if not _gc_remove(mpath):
            return removed
        removed += 1
        if payload:
            full = os.path.join(directory, payload)
            if os.path.isdir(full):
                removed += _gc_remove(full, tree=True)
    return removed
