"""NumPy-like dtype classes backed by ``torch.dtype`` (reference:
heat/core/types.py:64-415 hierarchy, :495 canonical_heat_type, :836
promote_types).

Each concrete dtype is a class; ``.torch_type()`` returns the ``torch.dtype``
it stands for. Only the types the k-means path needs exist so far: bool,
int32, int64, bfloat16, float32 and float64.
"""

from __future__ import annotations

import builtins
import functools

import numpy as np
import torch

__all__ = [
    "datatype",
    "generic",
    "number",
    "integer",
    "signedinteger",
    "floating",
    "bool",
    "bool_",
    "int32",
    "int",
    "int64",
    "long",
    "bfloat16",
    "float32",
    "float",
    "float_",
    "float64",
    "double",
    "canonical_heat_type",
    "heat_type_of",
    "heat_type_is_exact",
    "promote_types",
    "index_dtype",
]


class _DatatypeMeta(type):
    """Metaclass so that calling a dtype class casts, and repr is clean."""

    def __repr__(cls) -> str:
        return f"heat_tpu_torch.{cls.__name__}"

    def __call__(cls, *args, **kwargs):
        if getattr(cls, "_torch_dtype", None) is None:
            raise TypeError(f"cannot create instances of abstract type {cls.__name__}")
        from . import factories

        return factories.array(*args, dtype=cls, **kwargs)


class datatype(metaclass=_DatatypeMeta):
    """Abstract base for all types (reference heat/core/types.py:64)."""

    _torch_dtype = None

    @classmethod
    def torch_type(cls) -> torch.dtype:
        """The corresponding ``torch.dtype`` (reference ``torch_type()``)."""
        if cls._torch_dtype is None:
            raise TypeError(f"abstract type {cls.__name__} has no torch equivalent")
        return cls._torch_dtype

    @classmethod
    def char(cls) -> str:
        return cls.__name__


class generic(datatype):
    pass


class bool(generic):  # noqa: A001 - parity with reference name
    _torch_dtype = torch.bool


bool_ = bool


class number(generic):
    pass


class integer(number):
    pass


class signedinteger(integer):
    pass


class floating(number):
    pass


class int32(signedinteger):
    _torch_dtype = torch.int32


int = int32  # noqa: A001


class int64(signedinteger):
    _torch_dtype = torch.int64


long = int64


class bfloat16(floating):
    _torch_dtype = torch.bfloat16


class float32(floating):
    _torch_dtype = torch.float32


float = float32  # noqa: A001
float_ = float32


class float64(floating):
    _torch_dtype = torch.float64


double = float64

_CONCRETE = (bool, int32, int64, bfloat16, float32, float64)
_TORCH_TO_TYPE = {c._torch_dtype: c for c in _CONCRETE}
_NAME_TO_TYPE = {c.__name__: c for c in _CONCRETE}
_PY_TO_TYPE = {
    builtins.bool: bool,
    builtins.int: int64,
    builtins.float: float32,
}


def canonical_heat_type(a_type) -> type:
    """Map a dtype-like (heat type, ``torch.dtype``, numpy dtype, str, python
    type) to its heat type class (reference heat/core/types.py:495)."""
    if isinstance(a_type, type) and issubclass(a_type, datatype):
        if a_type._torch_dtype is None:
            raise TypeError(f"data type {a_type} is abstract")
        return a_type
    if isinstance(a_type, torch.dtype):
        if a_type in _TORCH_TO_TYPE:
            return _TORCH_TO_TYPE[a_type]
        raise TypeError(f"data type {a_type!r} is not supported")
    if a_type in _PY_TO_TYPE:
        return _PY_TO_TYPE[a_type]
    try:
        name = np.dtype(a_type).name
    except TypeError:
        name = getattr(a_type, "name", None) or str(a_type)
    if name in _NAME_TO_TYPE:
        return _NAME_TO_TYPE[name]
    raise TypeError(f"data type {a_type!r} is not understood")


def heat_type_of(obj) -> type:
    """The heat type of an array-like or scalar (reference types.py:556)."""
    dt = getattr(obj, "dtype", None)
    if dt is not None:
        return canonical_heat_type(dt)
    if isinstance(obj, (list, tuple)):
        return canonical_heat_type(np.asarray(obj).dtype)
    return canonical_heat_type(builtins.type(obj))


def heat_type_is_exact(ht_dtype) -> builtins.bool:
    """True for integer and bool types (reference types.py:595)."""
    return issubclass(canonical_heat_type(ht_dtype), (integer, bool))


# the reference's "intuitive" rule: numpy's "safe" casting plus int32 ->
# float32 (reference types.py:604-666, 855)
_PROMOTE_ORDER = (bool, int32, int64, float32, float64)


def _intuitive_can_cast(src: np.dtype, dst: np.dtype) -> builtins.bool:
    if src == np.dtype(np.int32) and dst == np.dtype(np.float32):
        return True
    return np.can_cast(src, dst, casting="safe")


def promote_types(type1, type2) -> type:
    """Smallest type both inputs cast to (reference types.py:755-761, 836);
    bfloat16 follows torch's promotion."""
    return _promote(canonical_heat_type(type1), canonical_heat_type(type2))


@functools.lru_cache(maxsize=None)
def _promote(h1, h2) -> type:
    if bfloat16 in (h1, h2):
        return canonical_heat_type(torch.promote_types(h1.torch_type(), h2.torch_type()))
    t1, t2 = np.dtype(h1.char()), np.dtype(h2.char())
    for target in _PROMOTE_ORDER:
        td = np.dtype(target.char())
        if _intuitive_can_cast(t1, td) and _intuitive_can_cast(t2, td):
            return target
    raise TypeError(f"no promotion for {h1}, {h2}")


def index_dtype() -> torch.dtype:
    """The dtype of labels and indices: torch indexes with int64."""
    return torch.int64
