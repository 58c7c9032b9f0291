"""heat_tpu_torch's elementwise library against heat_tpu and numpy on the CPU
mesh: arithmetics, exponential, trigonometrics, rounding, relational,
logical and complex_math, over bool/int32/int64/float32/float64 (bfloat16
where heat_tpu takes it) and the split layouts of both operands. Where the
reference raises for a type, the port must raise too. Cases from
test_elementwise.py, test_func_matrix.py and test_numeric_conventions.py.
Tolerances: see test_torch_parity."""

import numpy as np
import pytest
import torch

import heat_tpu as ref
import heat_tpu_torch as ht
from test_torch_parity import EXACT, SHAPES, both, check, data, on_cpu, tol  # noqa: F401

TYPES = ["bool", "int32", "int64", "float32", "float64"]
LAYOUTS = [("ragged", None), ("ragged", 0), ("ragged", 1), ("even", 0)]

# unary functions: name, numpy function, input range
UNARY = [
    ("exp", np.exp, (-3, 3)), ("exp2", np.exp2, (-3, 3)), ("expm1", np.expm1, (-3, 3)),
    ("log", np.log, (1, 4)), ("log2", np.log2, (1, 4)), ("log10", np.log10, (1, 4)),
    ("log1p", np.log1p, (0, 4)), ("sqrt", np.sqrt, (0, 4)), ("square", np.square, (-3, 3)),
    ("sin", np.sin, (-3, 3)), ("cos", np.cos, (-3, 3)), ("tan", np.tan, (-1, 1)),
    ("sinh", np.sinh, (-3, 3)), ("cosh", np.cosh, (-3, 3)), ("tanh", np.tanh, (-3, 3)),
    ("arcsin", np.arcsin, (-1, 1)), ("arccos", np.arccos, (-1, 1)), ("arctan", np.arctan, (-3, 3)),
    ("arcsinh", np.arcsinh, (-3, 3)), ("arccosh", np.arccosh, (1, 4)), ("arctanh", np.arctanh, (0, 1)),
    ("deg2rad", np.deg2rad, (-3, 3)), ("rad2deg", np.rad2deg, (-3, 3)),
    ("ceil", np.ceil, (-3, 3)), ("floor", np.floor, (-3, 3)), ("trunc", np.trunc, (-3, 3)),
    ("round", np.round, (-3, 3)), ("fabs", np.fabs, (-3, 3)), ("abs", np.abs, (-3, 3)),
    ("neg", np.negative, (-3, 3)), ("pos", np.positive, (-3, 3)), ("sign", np.sign, (-3, 3)),
    ("isfinite", np.isfinite, (-3, 3)), ("isinf", np.isinf, (-3, 3)), ("isnan", np.isnan, (-3, 3)),
    ("isneginf", np.isneginf, (-3, 3)), ("isposinf", np.isposinf, (-3, 3)), ("signbit", np.signbit, (-3, 3)),
    ("logical_not", np.logical_not, (-3, 3)), ("invert", np.invert, (-3, 3)),
    ("nan_to_num", np.nan_to_num, (-3, 3)), ("conj", np.conj, (-3, 3)), ("real", np.real, (-3, 3)),
    ("imag", np.imag, (-3, 3)), ("angle", np.angle, (-3, 3)),
]
BF16_UNARY = ["exp", "log", "sqrt", "sin", "tanh", "abs", "neg", "floor", "isnan"]

# binary functions: name, numpy function, first and second operand ranges
BINARY = [
    ("add", np.add, (-3, 3), (-3, 3)), ("sub", np.subtract, (-3, 3), (-3, 3)),
    ("mul", np.multiply, (-3, 3), (-3, 3)), ("div", np.true_divide, (-3, 3), (1, 4)),
    ("floordiv", np.floor_divide, (-9, 9), (1, 4)), ("mod", np.mod, (-9, 9), (1, 4)),
    ("fmod", np.fmod, (-9, 9), (1, 4)), ("pow", np.power, (-3, 3), (0, 3)),
    ("copysign", np.copysign, (-3, 3), (-3, 3)), ("hypot", np.hypot, (-3, 3), (-3, 3)),
    ("logaddexp", np.logaddexp, (-3, 3), (-3, 3)), ("logaddexp2", np.logaddexp2, (-3, 3), (-3, 3)),
    ("arctan2", np.arctan2, (-3, 3), (-3, 3)),
    ("bitwise_and", np.bitwise_and, (-9, 9), (-9, 9)), ("bitwise_or", np.bitwise_or, (-9, 9), (-9, 9)),
    ("bitwise_xor", np.bitwise_xor, (-9, 9), (-9, 9)), ("left_shift", np.left_shift, (-9, 9), (0, 4)),
    ("right_shift", np.right_shift, (-9, 9), (0, 4)), ("gcd", np.gcd, (-9, 9), (-9, 9)),
    ("lcm", np.lcm, (-9, 9), (-9, 9)),
    ("eq", np.equal, (-2, 2), (-2, 2)), ("ne", np.not_equal, (-2, 2), (-2, 2)),
    ("lt", np.less, (-2, 2), (-2, 2)), ("le", np.less_equal, (-2, 2), (-2, 2)),
    ("gt", np.greater, (-2, 2), (-2, 2)), ("ge", np.greater_equal, (-2, 2), (-2, 2)),
    ("logical_and", np.logical_and, (-2, 2), (-2, 2)), ("logical_or", np.logical_or, (-2, 2), (-2, 2)),
    ("logical_xor", np.logical_xor, (-2, 2), (-2, 2)),
    ("minimum", np.minimum, (-3, 3), (-3, 3)), ("maximum", np.maximum, (-3, 3), (-3, 3)),
]
BINARY_LAYOUTS = [(None, None), (0, 0), (1, 1), (0, 1), (None, 0), (1, None)]


def _inputs(shape, dtype, bounds, seed=0):
    return data(shape, dtype, *bounds, seed=2026 + seed)


def _run_both(fn, theirs_args, mine_args, kwargs=None):
    """The reference's result, or None where it raises; then the port's,
    which must raise where the reference does."""
    kwargs = kwargs or {}
    try:
        theirs = getattr(ref, fn)(*theirs_args, **kwargs)
    except Exception:  # noqa: BLE001 - the reference rejects the type
        with pytest.raises(Exception):
            getattr(ht, fn)(*mine_args, **kwargs)
        return None, None
    return theirs, getattr(ht, fn)(*mine_args, **kwargs)


def _expected(npfn, *args):
    """numpy's values, from float64 where numpy would compute a float of
    bool in float16; None where numpy has no loop for the type (positive
    of bool)."""
    with np.errstate(all="ignore"):
        try:
            out = npfn(*args)
        except TypeError:
            return None
        if np.asarray(out).dtype == np.float16:
            out = npfn(*(a.astype(np.float64) if isinstance(a, np.ndarray) else a for a in args))
        return out


@pytest.mark.parametrize("shape,split", LAYOUTS, ids=str)
@pytest.mark.parametrize("dtype", TYPES)
@pytest.mark.parametrize("name,npfn,bounds", UNARY, ids=[u[0] for u in UNARY])
def test_unary(name, npfn, bounds, dtype, shape, split):
    values = _inputs(SHAPES[shape], dtype, bounds)
    theirs, mine = both(values, split)
    if name == "angle" and dtype in ("bool", "int32"):
        # the reference takes JAX's default float, float64 in the tests'
        # x64 mode (float32 on the TPU); the port heat's float for int32
        got = ht.angle(mine)
        assert got.dtype is ht.float32 and got.split == split
        np.testing.assert_allclose(got.numpy(), np.angle(values), rtol=1e-6)
        return
    theirs, mine = _run_both(name, (theirs,), (mine,))
    if mine is None:
        return
    check(mine, theirs, _expected(npfn, values), **tol(mine.dtype.__name__))


@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("name", BF16_UNARY)
def test_unary_bfloat16(name, split):
    npfn, bounds = {u[0]: u[1:] for u in UNARY}[name]
    values = _inputs(SHAPES["ragged"], "bfloat16", bounds)
    theirs, mine = both(values, split, "bfloat16")
    check(getattr(ht, name)(mine), getattr(ref, name)(theirs), _expected(npfn, values), **tol("bfloat16"))


@pytest.mark.parametrize("splits", BINARY_LAYOUTS, ids=str)
@pytest.mark.parametrize("dtype", TYPES)
@pytest.mark.parametrize("name,npfn,b1,b2", BINARY, ids=[b[0] for b in BINARY])
def test_binary(name, npfn, b1, b2, dtype, splits):
    a = _inputs(SHAPES["ragged"], dtype, b1)
    b = _inputs(SHAPES["ragged"], dtype, b2, seed=1)
    if name in ("floordiv", "mod", "fmod"):
        # divisors of both signs, never 0 (test_division_by_zero_follows_numpy)
        b = np.ones_like(b) if dtype == "bool" else np.where(data(b.shape, "bool", seed=3), -b, b).astype(b.dtype)
    (ra, ma), (rb, mb) = both(a, splits[0]), both(b, splits[1])
    theirs, mine = _run_both(name, (ra, rb), (ma, mb))
    if mine is None:
        return
    check(mine, theirs, _expected(npfn, a, b), **tol(mine.dtype.__name__))


# broadcasting: the second operand's shape and split against a (13, 7) one
BROADCASTS = [
    ((7,), None), ((1, 7), None), ((1, 7), 0), ((13, 1), 0), ((13, 1), None), ((13, 1), 1), ((), None),
]


@pytest.mark.parametrize("other", BROADCASTS, ids=str)
@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("name", ["add", "div", "pow", "floordiv", "gt", "maximum"])
def test_binary_broadcast(name, split, other):
    npfn = {b[0]: b[1] for b in BINARY}[name]
    a = _inputs(SHAPES["ragged"], "float32", (-3, 3))
    b = _inputs(other[0], "float32", (0.5, 3), seed=1)
    (ra, ma), (rb, mb) = both(a, split), both(b, other[1])
    check(getattr(ht, name)(ma, mb), getattr(ref, name)(ra, rb), _expected(npfn, a, b), **tol("float32"))
    check(getattr(ht, name)(mb, ma), getattr(ref, name)(rb, ra), _expected(npfn, b, a), **tol("float32"))


SCALARS = [2, -3, 1.5, True, 2.0]


@pytest.mark.parametrize("scalar", SCALARS, ids=repr)
@pytest.mark.parametrize("dtype", TYPES)
@pytest.mark.parametrize("name", ["add", "sub", "mul", "div", "floordiv", "mod", "pow", "lt", "eq"])
def test_binary_with_a_python_scalar(name, dtype, scalar):
    """Weak scalars: a Python float turns an integer array into float32, an
    int leaves it alone and turns a bool array into int64."""
    npfn = {b[0]: b[1] for b in BINARY}[name]
    a = np.ones(SHAPES["ragged"], bool) if dtype == "bool" else _inputs(SHAPES["ragged"], dtype, (1, 4))
    theirs, mine = both(a, 0)
    for args in ((theirs, scalar), (scalar, theirs)):
        margs = tuple(mine if x is theirs else x for x in args)
        nargs = tuple(a if x is theirs else x for x in args)
        r, m = _run_both(name, args, margs)
        if m is None:
            continue
        expected = _expected(npfn, *nargs)
        check(m, r, None, **tol(m.dtype.__name__))
        np.testing.assert_allclose(m.numpy().astype(np.float64), np.asarray(expected, np.float64), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("name", ["add", "mul", "div", "eq"])
def test_binary_bfloat16(name, split):
    npfn = {b[0]: b[1] for b in BINARY}[name]
    a = _inputs(SHAPES["ragged"], "bfloat16", (-3, 3))
    b = _inputs(SHAPES["ragged"], "bfloat16", (1, 3), seed=1)
    (ra, ma), (rb, mb) = both(a, split, "bfloat16"), both(b, split, "bfloat16")
    check(getattr(ht, name)(ma, mb), getattr(ref, name)(ra, rb), None, **tol("bfloat16"))
    check(getattr(ht, name)(ma, 2.5), getattr(ref, name)(ra, 2.5), None, **tol("bfloat16"))


@pytest.mark.parametrize("split", [None, 0, 1])
def test_operators(split):
    """The operators bound as methods, and their reflected forms."""
    a = _inputs(SHAPES["ragged"], "int32", (-9, 9))
    b = _inputs(SHAPES["ragged"], "int32", (1, 5), seed=1)
    (ra, ma), (rb, mb) = both(a, split), both(b, split)
    cases = [
        lambda x, y: x + y, lambda x, y: x - y, lambda x, y: x * y, lambda x, y: x / y,
        lambda x, y: x // y, lambda x, y: x % y, lambda x, y: x ** (y % 3), lambda x, y: x & y,
        lambda x, y: x | y, lambda x, y: x ^ y, lambda x, y: x << (y % 3), lambda x, y: x >> (y % 3),
        lambda x, y: -x, lambda x, y: +x, lambda x, y: abs(x), lambda x, y: ~x,
        lambda x, y: x == y, lambda x, y: x != y, lambda x, y: x < y, lambda x, y: x <= y,
        lambda x, y: x > y, lambda x, y: x >= y, lambda x, y: 2 + x, lambda x, y: 7 - x,
        lambda x, y: 3 * x, lambda x, y: 9 / y, lambda x, y: 9 // y, lambda x, y: 9 % y, lambda x, y: 2 ** (y % 3),
        lambda x, y: x * 2 + 1.5,
    ]
    for case in cases:
        check(case(ma, mb), case(ra, rb), case(a, b), **tol("float64"))
    check(ma @ mb.T, ra @ rb.T, a @ b.T, **EXACT)
    with pytest.raises(ValueError):
        ma @ mb  # (13, 7) @ (13, 7) is not aligned


@pytest.mark.parametrize("split", [None, 0, 1])
def test_out_and_where(split):
    a = _inputs(SHAPES["ragged"], "float32", (-3, 3))
    b = _inputs(SHAPES["ragged"], "float32", (-3, 3), seed=1)
    mask = data(SHAPES["ragged"], "bool", seed=4)
    (ra, ma), (rb, mb), (rw, mw) = both(a, split), both(b, 0), both(mask, split)
    mo, ro = ht.zeros(a.shape, dtype=ht.float64, split=1), ref.zeros(a.shape, dtype=ref.float64, split=1)
    check(ht.add(ma, mb, out=mo), ref.add(ra, rb, out=ro), a.astype(np.float64) + b, **tol("float32"))
    assert mo.dtype is ht.float64
    check(ht.mul(ma, mb, where=mw), ref.mul(ra, rb, where=rw), np.where(mask, a * b, 0), **tol("float32"))
    mo, ro = ht.ones(a.shape, split=0), ref.ones(a.shape, split=0)
    check(ht.sub(ma, mb, out=mo, where=mw), ref.sub(ra, rb, out=ro, where=rw), np.where(mask, a - b, 1), **tol("float32"))
    mo, ro = ht.zeros(a.shape), ref.zeros(a.shape)
    check(ht.exp(ma, out=mo), ref.exp(ra, out=ro), np.exp(a), **tol("float32"))
    with pytest.raises(ValueError):
        ht.add(ma, mb, out=ht.zeros((3, 3)))


def test_division_by_zero_follows_numpy():
    """numpy's x // 0 = x % 0 = fmod(x, 0) = 0 for integers, on every shard
    and in the padding, and x // 0.0 = ±inf for floats. (heat_tpu's
    floordiv gives XLA's -1 and -2 for integers and NaN for floats here,
    reference faults, ROADMAP queue C.)"""
    a = np.array([5, -5, 0, 7, -7, 3, 1], dtype=np.int64)
    b = np.array([0, 0, 0, 2, -2, 0, 1], dtype=np.int64)
    x, y = ht.array(a, split=0), ht.array(b, split=0)
    with np.errstate(all="ignore"):
        np.testing.assert_array_equal((x // y).numpy(), a // b)
        np.testing.assert_array_equal((x % y).numpy(), a % b)
        np.testing.assert_array_equal(ht.fmod(x, y).numpy(), np.fmod(a, b))
    r = ref.array(a, split=0), ref.array(b, split=0)
    np.testing.assert_array_equal(ref.mod(*r).numpy(), a % b)
    f, g = a.astype(np.float64), b.astype(np.float64)
    with np.errstate(all="ignore"):
        np.testing.assert_array_equal((ht.array(f, split=0) // ht.array(g, split=0)).numpy(), f // g)
        np.testing.assert_array_equal((ht.array(f, split=0) % ht.array(g, split=0)).numpy(), f % g)


@pytest.mark.parametrize("split", [None, 0, 1])
def test_python_sign_rules(split):
    """floordiv and mod take the divisor's sign (Python's rule); fmod the
    dividend's (C's); on floats as on integers."""
    for dtype in ("int32", "float64"):
        a = np.array([[7, -7, 7, -7]] * 3, dtype=dtype)
        b = np.array([[2, 2, -2, -2]] * 3, dtype=dtype)
        (ra, ma), (rb, mb) = both(a, split), both(b, split)
        check(ma // mb, ra // rb, a // b, **EXACT)
        check(ma % mb, ra % rb, a % b, **EXACT)
        check(ht.fmod(ma, mb), ref.fmod(ra, rb), np.fmod(a, b), **EXACT)


@pytest.mark.parametrize("split", [None, 0, 1])
def test_clip_modf_nan_to_num(split):
    a = _inputs(SHAPES["ragged"], "float64", (-3, 3))
    a[0, 0], a[5, 5], a[12, 6] = np.nan, np.inf, -np.inf
    theirs, mine = both(a, split)
    check(ht.clip(mine, -1, 2), ref.clip(theirs, -1, 2), np.clip(a, -1, 2), **EXACT)
    check(ht.clip(mine, max=0.5), ref.clip(theirs, max=0.5), np.clip(a, None, 0.5), **EXACT)
    frac, whole = ht.modf(mine)
    ref_frac, ref_whole = ref.modf(theirs)
    check(whole, ref_whole, np.modf(a)[1], **EXACT)
    # the fraction of ±inf is ±0 in numpy and the port, NaN in the
    # reference (ROADMAP queue C): held to numpy, and to the reference
    # where x is finite
    np.testing.assert_array_equal(frac.numpy(), np.modf(a)[0])
    finite = np.isfinite(a)
    np.testing.assert_array_equal(frac.numpy()[finite], np.asarray(ref_frac.numpy())[finite])
    check(ht.nan_to_num(mine, nan=-1.0, posinf=9.0), ref.nan_to_num(theirs, nan=-1.0, posinf=9.0), np.nan_to_num(a, nan=-1.0, posinf=9.0), **EXACT)
    check(ht.round(mine, 2), ref.round(theirs, 2), np.round(a, 2), **tol("float64"))
    lo = _inputs((13, 1), "float64", (-2, 0))
    rlo, mlo = both(lo, split if split != 1 else None)
    np.testing.assert_array_equal(ht.clip(mine, mlo, 2.5).numpy(), np.clip(a, lo, 2.5))


@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("axis", [0, 1, -1])
@pytest.mark.parametrize("n", [1, 2])
def test_diff(n, axis, split):
    a = _inputs(SHAPES["ragged"], "float64", (-3, 3))
    theirs, mine = both(a, split)
    check(ht.diff(mine, n, axis), ref.diff(theirs, n, axis), np.diff(a, n, axis), **tol("float64"))
    check(ht.diff(mine, n, axis, prepend=0.5), ref.diff(theirs, n, axis, prepend=0.5), np.diff(a, n, axis, prepend=0.5), **tol("float64"))


@pytest.mark.parametrize("split", [None, 0, 1])
def test_isclose_allclose_equal(split):
    a = _inputs(SHAPES["ragged"], "float64", (-3, 3))
    b = a + 1e-9
    b[3, 3] += 1.0
    (ra, ma), (rb, mb) = both(a, split), both(b, split)
    check(ht.isclose(ma, mb), ref.isclose(ra, rb), np.isclose(a, b), **EXACT)
    assert ht.allclose(ma, mb) is ref.allclose(ra, rb) is False
    assert ht.allclose(ma, ma + 1e-9) is True
    assert ht.equal(ma, ma) is ref.equal(ra, ra) is True
    assert ht.equal(ma, mb) is ref.equal(ra, rb) is False
    assert ht.equal(ma, ht.zeros((2, 2))) is False


@pytest.mark.parametrize("split", [None, 0, 1])
def test_complex(split):
    rng = np.random.default_rng(11)
    a = (rng.standard_normal((13, 7)) + 1j * rng.standard_normal((13, 7))).astype(np.complex128)
    theirs, mine = both(a, split)
    for name in ("real", "imag", "conj", "abs", "sign", "sgn", "exp", "sqrt"):
        check(getattr(ht, name)(mine), getattr(ref, name)(theirs), None, **tol("float64"))
    check(ht.angle(mine, deg=True), ref.angle(theirs, deg=True), np.angle(a, deg=True), **tol("float64"))
    check(ht.iscomplex(mine), ref.iscomplex(theirs), np.iscomplex(a), **EXACT)
    check(ht.isreal(mine), ref.isreal(theirs), np.isreal(a), **EXACT)
    check(mine * 2j, theirs * 2j, a * 2j, **tol("float64"))
    b = a.astype(np.complex64)
    rb, mb = both(b, split)
    check(mb + mb, rb + rb, b + b, **tol("float32"))


# ---------------------------------------------------------------------------
# faults C4-C6 of ROADMAP queue C: the port on explicit meshes of 3 and 5
# shards, the reference on its own, both against numpy
# ---------------------------------------------------------------------------
def _mesh(p):
    from heat_tpu_torch.core.communication import MeshCommunication

    return MeshCommunication([torch.device("cpu")] * p)


@pytest.mark.parametrize("p", [3, 5])
@pytest.mark.parametrize(
    "a_dtype,b,expected_dtype",
    [("bool", 2, "float32"), ("int32", "float16", "float32"), ("int64", 2.0, "float64")],
)
def test_arctan2_casts_each_operand_first(a_dtype, b, expected_dtype, p):
    values = np.array([[1, 0, 1], [0, 1, 1]], dtype=a_dtype)
    other = np.array([[1.5, -2.0, 0.5], [2.0, 1.0, -1.0]], np.float16) if b == "float16" else b
    mine = ht.arctan2(
        ht.array(values, split=0, comm=_mesh(p)),
        ht.array(other, split=0, comm=_mesh(p)) if b == "float16" else other,
    )
    theirs = ref.arctan2(ref.array(values, split=0), ref.array(other, split=0) if b == "float16" else other)
    assert mine.dtype.__name__ == theirs.dtype.__name__ == expected_dtype
    expected = np.arctan2(values.astype(np.float64), np.asarray(other, np.float64))
    np.testing.assert_allclose(mine.numpy(), theirs.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(mine.numpy(), expected, rtol=1e-6, atol=1e-6)


_C1 = np.array([1 + 2j, 3 - 1j, 2 + 0j, 3 + 5j, 1 + 1j, -1 + 4j, 2 - 2j], np.complex64)
_C2 = np.array([1 + 3j, 3 - 2j, 2 + 0j, 2 + 5j, 1 + 1j, -1 + 4j, 2 - 3j], np.complex64)


@pytest.mark.parametrize("p", [3, 5])
@pytest.mark.parametrize(
    "name,npfn",
    [("lt", np.less), ("le", np.less_equal), ("gt", np.greater), ("ge", np.greater_equal),
     ("maximum", np.maximum), ("minimum", np.minimum)],
)
def test_complex_comparisons_are_lexicographic(name, npfn, p):
    mine = getattr(ht, name)(ht.array(_C1, split=0, comm=_mesh(p)), ht.array(_C2, split=0, comm=_mesh(p)))
    theirs = getattr(ref, name)(ref.array(_C1, split=0), ref.array(_C2, split=0))
    assert mine.dtype.__name__ == theirs.dtype.__name__
    np.testing.assert_array_equal(mine.numpy(), theirs.numpy())
    np.testing.assert_array_equal(mine.numpy(), npfn(_C1, _C2))


@pytest.mark.parametrize("p", [3, 5])
@pytest.mark.parametrize("name", ["max", "min"])
@pytest.mark.parametrize("split,axis", [(0, None), (1, 1), (0, 0)])
def test_complex_max_min_are_lexicographic(name, split, axis, p):
    values = np.stack([_C1, _C2[::-1], _C1 * 1j]).T.copy()  # (7, 3)
    mine = getattr(ht, name)(ht.array(values, split=split, comm=_mesh(p)), axis)
    theirs = getattr(ref, name)(ref.array(values, split=split), axis)
    np.testing.assert_array_equal(mine.numpy(), theirs.numpy())
    np.testing.assert_array_equal(mine.numpy(), getattr(np, name)(values, axis=axis))


@pytest.mark.parametrize("p", [3, 5])
def test_complex_round_and_nansum(p):
    values = np.array([1.26 + 2.51j, -0.5 + 1.5j, 2.45 - 0.35j, 0.04 + 7.77j], np.complex64)
    mine = ht.round(ht.array(values, split=0, comm=_mesh(p)), 1)
    np.testing.assert_allclose(mine.numpy(), ref.round(ref.array(values, split=0), 1).numpy(), rtol=1e-6)
    np.testing.assert_allclose(mine.numpy(), np.round(values, 1), rtol=1e-6)
    nans = np.array([1 + 2j, complex(np.nan, 1), 3 + 0j, 3 + 4j, complex(0, np.nan)], np.complex64)
    got = ht.nansum(ht.array(nans, split=0, comm=_mesh(p)))
    assert got.numpy() == ref.nansum(ref.array(nans, split=0)).numpy() == np.nansum(nans) == 7 + 6j


@pytest.mark.parametrize("p", [3, 5])
def test_sgn_of_bool_raises(p):
    values = np.array([True, False, True])
    with pytest.raises(TypeError):
        ref.sgn(ref.array(values, split=0))
    with pytest.raises(TypeError):
        ht.sgn(ht.array(values, split=0, comm=_mesh(p)))
    with pytest.raises(TypeError):
        np.sign(values)
