"""NumPy-like dtype classes backed by ``torch.dtype`` (reference:
heat/core/types.py:64-415 hierarchy, :495 canonical_heat_type, :836
promote_types; heat_tpu/core/types.py:380-598).

Each concrete dtype is a class; ``.torch_type()`` returns the ``torch.dtype``
it stands for. Promotion is the reference's table, not torch's: the engines
cast operands to :func:`result_type` before an operation.
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
    "unsignedinteger",
    "inexact",
    "floating",
    "complexfloating",
    "flexible",
    "bool",
    "bool_",
    "int8",
    "byte",
    "int16",
    "short",
    "int32",
    "int",
    "int64",
    "long",
    "uint8",
    "ubyte",
    "float16",
    "half",
    "bfloat16",
    "float32",
    "float",
    "float_",
    "float64",
    "double",
    "complex",
    "complex64",
    "csingle",
    "cfloat",
    "complex128",
    "cdouble",
    "canonical_heat_type",
    "heat_type_of",
    "heat_type_is_exact",
    "heat_type_is_inexact",
    "heat_type_is_complexfloating",
    "issubdtype",
    "iscomplex",
    "isreal",
    "promote_types",
    "result_type",
    "can_cast",
    "finfo",
    "iinfo",
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


class unsignedinteger(integer):
    pass


class inexact(number):
    pass


class floating(inexact):
    pass


class complexfloating(inexact):
    pass


class flexible(generic):
    pass


class int8(signedinteger):
    _torch_dtype = torch.int8


byte = int8


class int16(signedinteger):
    _torch_dtype = torch.int16


short = int16


class int32(signedinteger):
    _torch_dtype = torch.int32


int = int32  # noqa: A001


class int64(signedinteger):
    _torch_dtype = torch.int64


long = int64


class uint8(unsignedinteger):
    _torch_dtype = torch.uint8


ubyte = uint8


class float16(floating):
    _torch_dtype = torch.float16


half = float16


class bfloat16(floating):
    _torch_dtype = torch.bfloat16


class float32(floating):
    _torch_dtype = torch.float32


float = float32  # noqa: A001
float_ = float32


class float64(floating):
    _torch_dtype = torch.float64


double = float64


class complex64(complexfloating):
    _torch_dtype = torch.complex64


cfloat = complex64
csingle = complex64


class complex128(complexfloating):
    _torch_dtype = torch.complex128


cdouble = complex128
# reference types.py:367 names the abstract complex parent `complex`
complex = complexfloating  # noqa: A001

_CONCRETE = (
    bool,
    int8,
    int16,
    int32,
    int64,
    uint8,
    float16,
    bfloat16,
    float32,
    float64,
    complex64,
    complex128,
)
_TORCH_TO_TYPE = {c._torch_dtype: c for c in _CONCRETE}
_NAME_TO_TYPE = {c.__name__: c for c in _CONCRETE}
_PY_TO_TYPE = {
    builtins.bool: bool,
    builtins.int: int64,
    builtins.float: float32,
    builtins.complex: complex64,
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


def issubdtype(arg1, arg2) -> builtins.bool:
    """NumPy-style abstract dtype subclass check."""
    if not (isinstance(arg1, type) and issubclass(arg1, datatype)):
        arg1 = canonical_heat_type(arg1)
    if isinstance(arg2, type) and issubclass(arg2, datatype):
        return issubclass(arg1, arg2)
    return issubclass(arg1, canonical_heat_type(arg2))


def heat_type_is_exact(ht_dtype) -> builtins.bool:
    """True for integer and bool types (reference types.py:595)."""
    return issubdtype(ht_dtype, integer) or issubdtype(ht_dtype, bool)


def heat_type_is_inexact(ht_dtype) -> builtins.bool:
    """True for floating and complex types."""
    return issubdtype(ht_dtype, inexact)


def heat_type_is_complexfloating(ht_dtype) -> builtins.bool:
    """True for complex types."""
    return issubdtype(ht_dtype, complexfloating)


def iscomplex(x):
    """Elementwise test for nonzero imaginary part (reference types.py:640)."""
    from . import complex_math, factories

    if heat_type_is_complexfloating(x.dtype):
        return complex_math.imag(x) != 0
    return factories.zeros(x.shape, dtype=bool, split=x.split, device=x.device, comm=x.comm)


def isreal(x):
    """Elementwise test for zero imaginary part (reference types.py:675)."""
    from . import complex_math, factories

    if heat_type_is_complexfloating(x.dtype):
        return complex_math.imag(x) == 0
    return factories.ones(x.shape, dtype=bool, split=x.split, device=x.device, comm=x.comm)


# The reference's promotion scan order and cast rule (reference
# types.py:604-666): numpy's "safe" casting plus the torch-style exceptions
# int32->float32 and int32->complex64, which make promote_types(int32,
# float32) float32 where numpy says float64, and promote_types(int64,
# float32) float64 where torch says float32.
_PROMOTE_ORDER = (bool, uint8, int8, int16, int32, int64, float32, float64, complex64, complex128)


def _np_dtype(h) -> np.dtype:
    return np.dtype(h.char())


def _intuitive_can_cast(src: np.dtype, dst: np.dtype) -> builtins.bool:
    if src == np.dtype(np.int32) and dst in (np.dtype(np.float32), np.dtype(np.complex64)):
        return True
    return np.can_cast(src, dst, casting="safe")


def _scalar_fits(value, target: np.dtype) -> builtins.bool:
    """Value-based castability (reference types.py:380): rounding allowed,
    overflow and truncation not."""
    if np.issubdtype(target, np.bool_):
        return isinstance(value, builtins.bool) or value in (0, 1)
    if isinstance(value, builtins.complex) and not np.issubdtype(target, np.complexfloating):
        if value.imag != 0:
            return False
        value = value.real
    if np.issubdtype(target, np.integer):
        if isinstance(value, builtins.float) and not builtins.float(value).is_integer():
            return False
        info = np.iinfo(target)
        try:
            return info.min <= value <= info.max
        except (OverflowError, ValueError):
            return False
    v = builtins.abs(value)
    if np.isnan(v) or np.isinf(v):
        return True
    comp = target if np.issubdtype(target, np.floating) else np.dtype(
        np.float32 if target == np.dtype(np.complex64) else np.float64
    )
    return v <= builtins.float(np.finfo(comp).max)


def promote_types(type1, type2) -> type:
    """Smallest type in the reference's scan order that both inputs cast to
    under the "intuitive" rule (reference types.py:755-761, 836). float16 and
    bfloat16, absent from that table, follow torch's promotion, which agrees
    with the JAX package's for them."""
    return _promote(canonical_heat_type(type1), canonical_heat_type(type2))


@functools.lru_cache(maxsize=None)
def _promote(h1, h2) -> type:
    if float16 in (h1, h2) or bfloat16 in (h1, h2):
        return canonical_heat_type(torch.promote_types(h1.torch_type(), h2.torch_type()))
    t1, t2 = _np_dtype(h1), _np_dtype(h2)
    for target in _PROMOTE_ORDER:
        td = _np_dtype(target)
        if _intuitive_can_cast(t1, td) and _intuitive_can_cast(t2, td):
            return target
    raise TypeError(f"no promotion for {h1}, {h2}")


def _scalar_kind(op):
    if isinstance(op, (builtins.bool, np.bool_)):
        return "bool"
    if isinstance(op, (builtins.int, np.integer)):
        return "int"
    if isinstance(op, (builtins.float, np.floating)):
        return "float"
    if isinstance(op, (builtins.complex, np.complexfloating)):
        return "complex"
    return None


# the type a weak Python scalar joins a promotion with (reference
# types.py:456-518): a float never widens a float array, an int never
# widens an integer array, a bool is neutral
_KIND_TYPE = {"bool": torch.bool, "int": torch.int64, "float": torch.float32, "complex": torch.complex64}


def result_type(*operands) -> type:
    """Result type over arrays, dtypes and scalars (reference types.py:456-518).

    Arrays and dtypes promote by :func:`promote_types`. Python scalars are
    weak: a float joined with integer or bool arrays gives float32, with
    float arrays their type; a complex gives at least complex64; an int
    turns a bool array into int64 and leaves integer arrays alone."""
    dtypes, kinds = [], []
    for op in operands:
        if isinstance(op, type) and issubclass(op, datatype):
            dtypes.append(canonical_heat_type(op))
        elif hasattr(op, "dtype") and not isinstance(op, (np.generic,)):
            dtypes.append(canonical_heat_type(op.dtype))
        elif _scalar_kind(op) is not None:
            kinds.append(_scalar_kind(op))
        else:
            dtypes.append(canonical_heat_type(np.asarray(op).dtype))
    if not dtypes:
        res = torch.bool
        for kind in kinds:
            res = torch.promote_types(res, _KIND_TYPE[kind])
        return canonical_heat_type(res)
    acc = dtypes[0]
    for d in dtypes[1:]:
        acc = promote_types(acc, d)
    for kind in kinds:
        if kind == "complex" or (kind == "float" and heat_type_is_exact(acc)):
            acc = canonical_heat_type(torch.promote_types(acc.torch_type(), _KIND_TYPE[kind]))
        elif kind == "int" and acc is bool:
            acc = int64
    return acc


def _can_cast_types(src, dst, casting: str) -> builtins.bool:
    """numpy's ``casting`` rule between two heat types, or the reference's
    "intuitive" one; bfloat16, which numpy lacks, casts like float16 except
    to and from float16."""
    if src is dst:
        return True
    if {src, dst} == {bfloat16, float16} and casting != "same_kind":
        return False
    src, dst = (_np_dtype(float16 if h is bfloat16 else h) for h in (src, dst))
    if casting == "intuitive":
        return _intuitive_can_cast(src, dst)
    return builtins.bool(np.can_cast(src, dst, casting=casting))


def can_cast(from_, to, casting: str = "intuitive") -> builtins.bool:
    """Whether ``from_`` casts to ``to`` (reference types.py:520): types and
    arrays by type, under the reference's "intuitive" rule (numpy's "safe"
    plus int32 to float32 and complex64) or one of numpy's; Python scalars
    by value, where rounding is allowed and overflow and truncation are
    not."""
    if casting == "unsafe":
        return True
    to = canonical_heat_type(to)
    if isinstance(from_, (builtins.bool, builtins.int, builtins.float, builtins.complex)):
        if casting == "no":
            return to is not bfloat16 and np.result_type(from_) == _np_dtype(to)
        # bfloat16, which numpy lacks, has float32's range
        return _scalar_fits(from_, np.dtype(np.float32) if to is bfloat16 else _np_dtype(to))
    if not (isinstance(from_, type) and issubclass(from_, datatype)):
        from_ = heat_type_of(from_)
    return _can_cast_types(canonical_heat_type(from_), to, casting)


class finfo:
    """Machine limits of a floating type (reference types.py:950)."""

    def __new__(cls, dtype):
        h = canonical_heat_type(dtype)
        if not heat_type_is_inexact(h):
            raise TypeError(f"data type {h} not inexact")
        info = torch.finfo(h.torch_type())
        self = super().__new__(cls)
        self.bits = info.bits
        self.eps = builtins.float(info.eps)
        self.max = builtins.float(info.max)
        self.min = builtins.float(info.min)
        self.tiny = builtins.float(info.tiny)
        self.dtype = h
        return self


class iinfo:
    """Machine limits of an integer type (reference types.py:1005)."""

    def __new__(cls, dtype):
        h = canonical_heat_type(dtype)
        if not issubdtype(h, integer):
            raise TypeError(f"data type {h} not an integer type")
        info = torch.iinfo(h.torch_type())
        self = super().__new__(cls)
        self.bits = info.bits
        self.max = builtins.int(info.max)
        self.min = builtins.int(info.min)
        self.dtype = h
        return self


def index_dtype() -> torch.dtype:
    """The dtype of labels and indices: torch indexes with int64."""
    return torch.int64
