"""The distribution-flow value lattice.

The dataflow verifier (:mod:`heat_tpu_torch.analysis.dataflow`) tracks every value
a program manipulates through a small abstract domain. For DNDarrays the
element is the tuple the ISSUE names::

    (rank, split ∈ {None, 0..k, ⊤}, device-set, pending|forced)

plus the statically-known parts of the shape and dtype, because the static
cost model prices collectives in bytes and bytes need dims × itemsize.
``split`` is the load-bearing coordinate: heat's single-integer split makes
distribution semantics statically decidable (HeAT, arxiv 2007.13552) — two
concrete-but-different splits meeting at a binary op IS the implicit-reshard
hazard (S101), a concrete split collapsing to ``None`` IS the downgrade
hazard (S103). ``⊤`` (:data:`TOP`) means "some split, statically unknown";
rules only fire on *concrete* disagreement, so ⊤ is how the interpreter
stays conservative instead of wrong.

Non-array values keep just enough structure for the rules: literal constants
(:class:`Const`) so shapes/splits/axes written in source propagate into the
cost model, scalars with a host-divergence taint (:class:`Scalar` — the S104
"two abstract hosts" bit, with provenance recording whether the divergence
crossed a function boundary), tuples (:class:`VTuple`) so ``q, r = qr(a)``
unpacks, class instances (:class:`Instance`) so estimator ``self`` state
flows through methods, and :data:`UNKNOWN` as the top of the whole domain.

Pure standard library; importing this module never touches a device.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, Optional, Tuple, Union

__all__ = [
    "TOP",
    "UNKNOWN",
    "AbstractArray",
    "Const",
    "Instance",
    "Scalar",
    "VTuple",
    "as_array",
    "bcast_shape",
    "is_divergent",
    "itemsize",
    "join",
    "logical_bytes",
]


class _Top:
    """⊤ of the split sub-lattice: distributed along SOME axis, unknown
    which. Distinct from ``None`` (known replicated) and from an int (known
    axis). A singleton so identity checks work."""

    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self):
        return "⊤"

    def __reduce__(self):  # keep the singleton through copy/pickle
        return (_Top, ())


TOP = _Top()

#: split domain: None (replicated) | int (axis) | TOP (unknown)
Split = Union[None, int, _Top]


class _Unknown:
    """⊤ of the full value domain: could be anything, including a DNDarray
    of any layout. Rules never fire on it."""

    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self):
        return "?"

    def __reduce__(self):
        return (_Unknown, ())


UNKNOWN = _Unknown()


@dataclass(frozen=True)
class Const:
    """A statically-known python literal (int/float/str/bool/None/tuples of
    those). Shapes, split axes and method kwargs travel as Consts."""

    value: object

    def __repr__(self):
        return f"Const({self.value!r})"


@dataclass(frozen=True)
class Scalar:
    """A non-array runtime value the analysis does not model further, except
    for the host-divergence taint: ``divergent=True`` means the value differs
    across controller processes of one SPMD job (process identity, wall
    clock, unseeded RNG). ``via_call`` records whether that divergence came
    out of a *callee's return value* — the provenance bit S104 uses to report
    only hazards H001's intraprocedural view cannot see."""

    divergent: bool = False
    via_call: bool = False


@dataclass(frozen=True)
class AbstractArray:
    """One DNDarray as the verifier sees it.

    ``rank``/``shape`` are ``None`` when unknown; known shapes may carry
    ``None`` for individual unknown dims. ``split`` is the three-valued
    distribution coordinate. ``pending`` distinguishes a recorded-but-not-
    forced fusion chain from a materialized value (host reads of pending
    values are the blocking syncs S102 prices). ``device`` is the device-set
    tag: ``"mesh"`` for arrays living on the SPMD mesh, ``"host"`` for
    host-materialized copies, ``None`` when unknown."""

    rank: Optional[int] = None
    split: Split = TOP
    shape: Optional[Tuple[Optional[int], ...]] = None
    dtype: Optional[str] = None
    pending: bool = True
    device: Optional[str] = "mesh"

    def with_(self, **kw) -> "AbstractArray":
        return replace(self, **kw)


@dataclass
class Instance:
    """An object of an analyzed class: ``attrs`` is the flow-insensitive
    abstract heap for ``self.<name>`` (joined at every write, never killed),
    so estimator state like fitted centroids keeps its layout across
    methods. Deliberately mutable + compared by content."""

    cls: str
    attrs: Dict[str, object] = field(default_factory=dict)

    def __eq__(self, other):
        return (
            isinstance(other, Instance)
            and self.cls == other.cls
            and self.attrs == other.attrs
        )

    def __repr__(self):
        return f"Instance({self.cls}, {sorted(self.attrs)})"


@dataclass(frozen=True)
class VTuple:
    """A fixed-arity tuple of abstract values (function multi-returns,
    ``shape`` literals, unpacking targets)."""

    items: Tuple[object, ...]


# ----------------------------------------------------------------------
# byte helpers for the cost model
# ----------------------------------------------------------------------
_ITEMSIZE = {
    "bool": 1,
    "int8": 1, "uint8": 1,
    "int16": 2, "uint16": 2, "float16": 2, "bfloat16": 2,
    "int32": 4, "uint32": 4, "float32": 4,
    "int64": 8, "uint64": 8, "float64": 8, "complex64": 8,
    "complex128": 16,
}


def itemsize(dtype: Optional[str], default: int = 4) -> int:
    """Bytes per element; unknown dtypes price at the f32 default — the cost
    model is a lower bound, not an oracle."""
    if dtype is None:
        return default
    return _ITEMSIZE.get(dtype, default)


def logical_bytes(arr: "AbstractArray") -> Optional[int]:
    """Global logical payload bytes (the convention telemetry's collective
    accounting uses), or None when any dim is unknown."""
    if not isinstance(arr, AbstractArray) or arr.shape is None:
        return None
    total = 1
    for d in arr.shape:
        if d is None:
            return None
        total *= int(d)
    return total * itemsize(arr.dtype)


def as_array(v) -> Optional[AbstractArray]:
    return v if isinstance(v, AbstractArray) else None


def is_divergent(v) -> bool:
    if isinstance(v, Scalar):
        return v.divergent
    if isinstance(v, VTuple):
        return any(is_divergent(i) for i in v.items)
    return False


def bcast_shape(
    a: Optional[Tuple[Optional[int], ...]], b: Optional[Tuple[Optional[int], ...]]
) -> Optional[Tuple[Optional[int], ...]]:
    """Numpy broadcast of two partially-known shapes; None when either side
    is wholly unknown, per-dim None where the dims are."""
    if a is None or b is None:
        return None
    if len(a) < len(b):
        a = (1,) * (len(b) - len(a)) + tuple(a)
    elif len(b) < len(a):
        b = (1,) * (len(a) - len(b)) + tuple(b)
    out = []
    for x, y in zip(a, b):
        if x is None or y is None:
            out.append(None)
        elif x == 1:
            out.append(y)
        elif y == 1 or x == y:
            out.append(x)
        else:
            return None  # statically incompatible: let the runtime error
    return tuple(out)


# ----------------------------------------------------------------------
# join / widen
# ----------------------------------------------------------------------
def _join_split(a: Split, b: Split) -> Split:
    return a if a == b else TOP


def _join_opt(a, b):
    return a if a == b else None


def _join_shape(a, b):
    if a is None or b is None or len(a) != len(b):
        return None
    return tuple(x if x == y else None for x, y in zip(a, b))


def join(a, b):
    """Least upper bound of two abstract values: control-flow merge. Equal
    values join to themselves; structurally-compatible arrays merge
    coordinate-wise (split disagreement → ⊤); everything else tops out at
    :data:`UNKNOWN`. Every sub-lattice here is FLAT (a value, or its top),
    so join doubles as the loop-widening operator: a coordinate that
    changes across iterations reaches its top after one join, which is
    what bounds the interpreter's fixpoint."""
    if a is b or a == b:
        return a
    if isinstance(a, AbstractArray) and isinstance(b, AbstractArray):
        return AbstractArray(
            rank=_join_opt(a.rank, b.rank),
            split=_join_split(a.split, b.split),
            shape=_join_shape(a.shape, b.shape),
            dtype=_join_opt(a.dtype, b.dtype),
            pending=a.pending or b.pending,
            device=_join_opt(a.device, b.device),
        )
    if isinstance(a, Scalar) and isinstance(b, Scalar):
        return Scalar(
            divergent=a.divergent or b.divergent,
            via_call=a.via_call or b.via_call,
        )
    if isinstance(a, Const) and isinstance(b, Scalar):
        return b
    if isinstance(a, Scalar) and isinstance(b, Const):
        return a
    if isinstance(a, VTuple) and isinstance(b, VTuple) and len(a.items) == len(b.items):
        return VTuple(tuple(join(x, y) for x, y in zip(a.items, b.items)))
    if isinstance(a, Instance) and isinstance(b, Instance) and a.cls == b.cls:
        attrs = dict(a.attrs)
        for k, v in b.attrs.items():
            attrs[k] = join(attrs[k], v) if k in attrs else v
        return Instance(a.cls, attrs)
    return UNKNOWN


def join_env(a: Dict[str, object], b: Dict[str, object]) -> Dict[str, object]:
    """Pointwise join of two environments; names bound on only one path
    join with "unbound" and become UNKNOWN (they may not exist at runtime)."""
    out: Dict[str, object] = {}
    for name in set(a) | set(b):
        if name in a and name in b:
            out[name] = join(a[name], b[name])
        else:
            out[name] = UNKNOWN
    return out
