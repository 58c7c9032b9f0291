"""heat_tpu_torch's reductions and statistics against heat_tpu and numpy on
the CPU mesh: sum, prod, nansum, nanprod, mean, var, std, min, max, all, any
over every axis, split and type; argmin/argmax and their combiners; NaN
across shards; cumsum/cumprod along and across the split; minimum/maximum,
average, skew, kurtosis and cov. Cases from test_statistics.py,
test_statistics_depth2.py, test_numeric_conventions.py and test_ragged.py.
Tolerances: see test_torch_parity."""

import numpy as np
import pytest
import torch

import heat_tpu as ref
import heat_tpu_torch as ht
from heat_tpu_torch.core.communication import MeshCommunication
from test_torch_parity import EXACT, REDUCTION, SHAPES, both, check, data, on_cpu, tol  # noqa: F401

AXES = [None, 0, 1, (0, 1)]
SPLITS = [None, 0, 1]
# reductions: name, the numpy function, the types it runs on
REDUCTIONS = [
    ("sum", np.sum, ["bool", "int32", "int64", "float32", "float64", "bfloat16"]),
    ("prod", np.prod, ["bool", "int32", "int64", "float32", "float64"]),
    ("nansum", np.nansum, ["int32", "int64", "float32", "float64"]),
    ("nanprod", np.nanprod, ["int32", "int64", "float32", "float64"]),
    ("mean", np.mean, ["bool", "int32", "int64", "float32", "float64", "bfloat16"]),
    ("var", np.var, ["bool", "int32", "int64", "float32", "float64"]),
    ("std", np.std, ["int32", "int64", "float32", "float64"]),
    ("min", np.min, ["bool", "int32", "int64", "float32", "float64", "bfloat16"]),
    ("max", np.max, ["bool", "int32", "int64", "float32", "float64", "bfloat16"]),
    ("all", np.all, ["bool", "int32", "float32"]),
    ("any", np.any, ["bool", "int32", "float32"]),
]
EXACT_RESULTS = ("min", "max", "all", "any")


def _inputs(shape, dtype):
    """Positive floats (no sum cancels, so a relative bound means something),
    integers in [-3, 3), half-true bools."""
    return data(shape, dtype, 0.5, 1.5) if dtype in ("float32", "float64", "bfloat16") else data(shape, dtype)


def _case_tol(name, dtype):
    return EXACT if name in EXACT_RESULTS else tol(_result_type(name, dtype), REDUCTION)


def _result_type(name, dtype):
    if name in ("mean", "var", "std") and dtype in ("bool", "int32"):
        return "float32"
    if name in ("mean", "var", "std") and dtype == "int64":
        return "float64"
    return dtype


@pytest.mark.parametrize("shape", list(SHAPES.values()), ids=list(SHAPES))
@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("axis", AXES, ids=str)
@pytest.mark.parametrize(
    "name,dtype", [(n, d) for n, _, ds in REDUCTIONS for d in ds], ids=lambda v: str(v)
)
def test_reduction(name, dtype, axis, split, shape):
    values = _inputs(shape, dtype)
    theirs, mine = both(values, split, dtype)
    npfn = dict((n, f) for n, f, _ in REDUCTIONS)[name]
    expected = npfn(values.astype(np.float64) if dtype == "bfloat16" else values, axis=axis)
    check(getattr(ht, name)(mine, axis=axis), getattr(ref, name)(theirs, axis=axis), expected, **_case_tol(name, dtype))


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("axis", AXES, ids=str)
@pytest.mark.parametrize("name", ["sum", "prod", "mean", "max", "min", "any"])
def test_reduction_keepdims(name, axis, split):
    values = _inputs(SHAPES["ragged"], "float32")
    theirs, mine = both(values, split)
    expected = getattr(np, name)(values, axis=axis, keepdims=True)
    check(
        getattr(ht, name)(mine, axis=axis, keepdims=True),
        getattr(ref, name)(theirs, axis=axis, keepdims=True),
        expected,
        **_case_tol(name, "float32"),
    )


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("axis", [None, 0, 1])
@pytest.mark.parametrize("ddof", [0, 1])
def test_var_std_ddof_and_bessel(ddof, axis, split):
    values = _inputs(SHAPES["ragged"], "float64")
    theirs, mine = both(values, split)
    for fn, npfn in ((ht.var, np.var), (ht.std, np.std)):
        reffn = getattr(ref, fn.__name__)
        check(fn(mine, axis, ddof=ddof), reffn(theirs, axis, ddof=ddof), npfn(values, axis=axis, ddof=ddof), **REDUCTION["float64"])
        check(fn(mine, axis, bessel=bool(ddof)), reffn(theirs, axis, bessel=bool(ddof)), npfn(values, axis=axis, ddof=ddof), **REDUCTION["float64"])
    with pytest.raises(ValueError):
        ht.var(mine, ddof=2)
    with pytest.raises(TypeError):
        ht.var(mine, ddof=0.5)


@pytest.mark.parametrize("split", [None, 0])
@pytest.mark.parametrize("axis", [None, 0])
def test_var_takes_the_mean_first(axis, split):
    """Data offset far from zero: E[x²] - E[x]² would cancel to noise in
    float32; the mean-first order keeps the variance to float32 rounding."""
    rng = np.random.default_rng(3)
    values = (rng.standard_normal((4001, 3)) + 1e4).astype(np.float32)
    theirs, mine = both(values, split)
    expected = np.var(values.astype(np.float64), axis=axis)
    got = ht.var(mine, axis).numpy()
    np.testing.assert_allclose(got, expected, rtol=1e-3)
    np.testing.assert_allclose(got, np.asarray(ref.var(theirs, axis).numpy()), rtol=1e-3)


@pytest.mark.parametrize("shape", list(SHAPES.values()), ids=list(SHAPES))
@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("axis", [None, 0, 1])
@pytest.mark.parametrize("dtype", ["bool", "int32", "int64", "float32", "float64"])
@pytest.mark.parametrize("name", ["argmax", "argmin"])
def test_arg_reduction(name, dtype, axis, split, shape):
    """Integers in [-3, 3) and bools tie often: the first index wins."""
    values = data(shape, dtype)
    theirs, mine = both(values, split)
    expected = getattr(np, name)(values, axis=axis)
    check(getattr(ht, name)(mine, axis), getattr(ref, name)(theirs, axis), expected, **EXACT)


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("axis", [None, 0, 1])
@pytest.mark.parametrize("where", ["first", "middle", "last", "two"])
def test_nan_propagates_across_shards(where, axis, split):
    values = data(SHAPES["ragged"], "float64")
    spots = {"first": [(0, 0)], "middle": [(6, 3)], "last": [(12, 6)], "two": [(11, 2), (3, 5)]}[where]
    for r, c in spots:
        values[r, c] = np.nan
    theirs, mine = both(values, split)
    for name in ("max", "min", "argmax", "argmin", "sum", "mean"):
        check(getattr(ht, name)(mine, axis), getattr(ref, name)(theirs, axis), getattr(np, name)(values, axis=axis), **REDUCTION["float64"])
    check(ht.nansum(mine, axis), ref.nansum(theirs, axis), np.nansum(values, axis=axis), **REDUCTION["float64"])


@pytest.mark.parametrize("p", [1, 2, 3, 5, 7, 13, 16])
def test_reductions_at_every_mesh_size(p):
    """13 rows over p shards: empty shards (p = 16), one row each (13), a
    short last shard; every result equals numpy's."""
    values = data(SHAPES["ragged"], "float64", 0.5, 1.5)
    values[5, 2] = values.max() + 1  # a unique max, and a tie for argmin
    values[9, 4] = values[1, 1] = values.min() - 1
    x = ht.array(values, split=0, comm=MeshCommunication([torch.device("cpu")] * p))
    for axis in (None, 0, 1):
        for name in ("sum", "mean", "var", "max", "argmax", "argmin", "prod"):
            np.testing.assert_allclose(
                getattr(ht, name)(x, axis).numpy(), getattr(np, name)(values, axis=axis), rtol=1e-12
            )
        np.testing.assert_allclose(ht.cumsum(x, 0).numpy(), np.cumsum(values, 0), rtol=1e-12)


@pytest.mark.parametrize("shape", list(SHAPES.values()), ids=list(SHAPES))
@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("dtype", ["bool", "int32", "int64", "float32", "float64"])
@pytest.mark.parametrize("name", ["cumsum", "cumprod"])
def test_cumulative(name, dtype, axis, split, shape):
    values = _inputs(shape, dtype)
    theirs, mine = both(values, split)
    expected = getattr(np, name)(values, axis=axis)
    check(getattr(ht, name)(mine, axis), getattr(ref, name)(theirs, axis), expected, **tol(dtype, REDUCTION))


@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("case", [((70001, 3), 0), ((3, 70001), 1), ((65537, 2), 0), ((131075,), 0)], ids=str)
@pytest.mark.parametrize("dtype", ["int32", "float64"])
@pytest.mark.parametrize("name", ["cumsum", "cumprod"])
def test_cumulative_along_a_long_axis(name, dtype, case, split):
    """More than 2^16 elements along the axis: the engine scans in blocks of
    about √n (ragged: the last block padded with the neutral element)."""
    shape, axis = case
    if split is not None and split >= len(shape):
        split = 0
    values = data(shape, "float64", 0.999, 1.001) if dtype == "float64" else data(shape, "int32", -2, 3)
    theirs, mine = both(values, split)
    check(getattr(ht, name)(mine, axis), getattr(ref, name)(theirs, axis), getattr(np, name)(values, axis), rtol=1e-10, atol=0)


@pytest.mark.parametrize("split", SPLITS)
def test_cumulative_dtype_and_out(split):
    values = _inputs(SHAPES["ragged"], "int32")
    theirs, mine = both(values, split)
    check(ht.cumsum(mine, 0, dtype=ht.float64), ref.cumsum(theirs, 0, dtype=ref.float64), np.cumsum(values, 0), **EXACT)
    mine_out, theirs_out = ht.zeros(values.shape, dtype=ht.int64), ref.zeros(values.shape, dtype=ref.int64)
    check(ht.cumsum(mine, 1, out=mine_out), ref.cumsum(theirs, 1, out=theirs_out), np.cumsum(values, 1), **EXACT)


@pytest.mark.parametrize("splits", [(None, None), (0, 0), (0, None), (None, 1), (1, 0)])
@pytest.mark.parametrize("name", ["minimum", "maximum"])
def test_minimum_maximum(name, splits):
    a, b = data(SHAPES["ragged"], "float32"), data(SHAPES["ragged"], "float32", seed=7)
    a[2, 3] = np.nan
    (ra, ma), (rb, mb) = both(a, splits[0]), both(b, splits[1])
    check(getattr(ht, name)(ma, mb), getattr(ref, name)(ra, rb), getattr(np, name)(a, b), **EXACT)


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("axis", [None, 0, 1])
def test_average(axis, split):
    values = _inputs(SHAPES["ragged"], "float64")
    weights = data(SHAPES["ragged"], "float64", 0.5, 2.0, seed=5)
    theirs, mine = both(values, split)
    rw, mw = both(weights, split)
    check(ht.average(mine, axis), ref.average(theirs, axis), np.average(values, axis=axis), **REDUCTION["float64"])
    check(
        ht.average(mine, axis, weights=mw), ref.average(theirs, axis, weights=rw),
        np.average(values, axis=axis, weights=weights), **REDUCTION["float64"],
    )
    got, wsum = ht.average(mine, axis, returned=True)
    np.testing.assert_allclose(wsum.numpy(), np.average(values, axis=axis, returned=True)[1])
    if axis is not None:
        w1 = weights[0] if axis == 1 else weights[:, 0]
        rw1, mw1 = both(w1, None)
        check(
            ht.average(mine, axis, weights=mw1), ref.average(theirs, axis, weights=rw1),
            np.average(values, axis=axis, weights=w1), **REDUCTION["float64"],
        )


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("axis", [None, 0, 1])
@pytest.mark.parametrize("unbiased", [True, False])
def test_skew_kurtosis(unbiased, axis, split):
    values = data(SHAPES["ragged"], "float64") ** 3
    theirs, mine = both(values, split)
    check(ht.skew(mine, axis, unbiased), ref.skew(theirs, axis, unbiased), **REDUCTION["float64"])
    for fischer in (True, False):
        check(
            ht.kurtosis(mine, axis, unbiased, fischer), ref.kurtosis(theirs, axis, unbiased, fischer),
            **REDUCTION["float64"],
        )


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("kwargs", [{}, {"rowvar": False}, {"bias": True}, {"ddof": 0}, {"y": True}])
def test_cov(kwargs, split):
    values = data((5, 13), "float64")
    theirs, mine = both(values, split)
    kwargs = dict(kwargs)
    mine_kw, ref_kw, np_kw = dict(kwargs), dict(kwargs), dict(kwargs)
    if kwargs.pop("y", None):
        other = data((2, 13), "float64", seed=9)
        ref_kw["y"], mine_kw["y"] = both(other, split)
        np_kw["y"] = other
    check(ht.cov(mine, **mine_kw), ref.cov(theirs, **ref_kw), np.cov(values, **np_kw), **REDUCTION["float64"])


@pytest.mark.parametrize("name", ["mpi_argmax", "mpi_argmin"])
def test_arg_combiners_match_the_reference_where_a_holds_the_lower_index(name):
    """a holds the lower global indices (shard order): the reference's
    combiner keeps a on a tie, which is the lower index."""
    a = (np.array([1.0, 5.0, np.nan, 2.0, np.nan]), np.array([0, 1, 2, 3, 4]))
    b = (np.array([1.0, 3.0, 7.0, np.nan, np.nan]), np.array([10, 11, 12, 13, 14]))
    mine = getattr(ht, name)(tuple(map(torch.tensor, a)), tuple(map(torch.tensor, b)))
    theirs = getattr(ref.statistics, name)(a, b)
    np.testing.assert_array_equal(mine[0].numpy(), np.asarray(theirs[0]))
    np.testing.assert_array_equal(mine[1].numpy(), np.asarray(theirs[1]))


def test_arg_combiners_take_the_lower_global_index_on_a_tie():
    """A tie where b holds the lower index (a split=1 array's flat index):
    numpy's first occurrence wins, for values and for NaN."""
    a = (torch.tensor([2.0, float("nan")]), torch.tensor([9, 9]))
    b = (torch.tensor([2.0, float("nan")]), torch.tensor([4, 4]))
    for fn in (ht.mpi_argmax, ht.mpi_argmin):
        assert fn(a, b)[1].tolist() == [4, 4]
        assert fn(b, a)[1].tolist() == [4, 4]


def test_flat_argmax_of_a_column_split_array_is_numpys_first_occurrence():
    values = np.zeros((4, 16))
    values[3, 0] = values[0, 15] = 5.0  # a tie: (0, 15) comes first in C order
    values[2, 1] = values[1, 14] = -5.0
    theirs, mine = both(values, 1)
    assert ht.argmax(mine).item() == np.argmax(values) == ref.argmax(theirs).item() == 15
    assert ht.argmin(mine).item() == np.argmin(values) == ref.argmin(theirs).item()


def test_reductions_out_and_dtype():
    values = _inputs(SHAPES["ragged"], "int32")
    theirs, mine = both(values, 0)
    mine_out, theirs_out = ht.zeros((7,), dtype=ht.float64), ref.zeros((7,), dtype=ref.float64)
    check(ht.sum(mine, 0, out=mine_out), ref.sum(theirs, 0, out=theirs_out), values.sum(0), **EXACT)
    assert mine_out.dtype is ht.float64
    with pytest.raises(ValueError):
        ht.sum(mine, 0, out=ht.zeros((3,)))
    assert ht.sum(mine, keepdim=True).gshape == (1, 1)


# ---------------------------------------------------------------------------
# faults C1-C3 of ROADMAP queue C: the port on explicit meshes of 3 and 5
# shards, the reference on its own, both against numpy
# ---------------------------------------------------------------------------
def _mesh(p):
    return MeshCommunication([torch.device("cpu")] * p)


@pytest.mark.parametrize("p", [3, 5])
@pytest.mark.parametrize("name", ["var", "std"])
def test_complex_moments_across_the_split_are_real(name, p):
    values = np.array([1 + 2j, 3 - 1j, 0j, 3 + 5j], np.complex64)
    mine = getattr(ht, name)(ht.array(values, split=0, comm=_mesh(p)))
    theirs = getattr(ref, name)(ref.array(values, split=0))
    expected = getattr(np, name)(values)  # var 6.9375
    assert mine.dtype.__name__ == theirs.dtype.__name__ == "float32"
    np.testing.assert_allclose(mine.numpy(), theirs.numpy(), rtol=1e-6)
    np.testing.assert_allclose(mine.numpy(), expected, rtol=1e-6)


@pytest.mark.parametrize("p", [3, 5])
@pytest.mark.parametrize("split,axis", [(0, None), (0, 0), (1, None)])
@pytest.mark.parametrize("name", ["mean", "var", "std"])
def test_half_moments_accumulate_in_float32(name, split, axis, p):
    # N(30, 1) for the mean, N(3, 40) for var/std: a float16 sum of 3000
    # such values overflows (max 65504)
    rng = np.random.default_rng(SEED_C)
    values = (rng.normal(30, 1, (3000, 4)) if name == "mean" else rng.normal(3, 40, (3000, 4))).astype(np.float16)
    mine = getattr(ht, name)(ht.array(values, split=split, comm=_mesh(p)), axis)
    theirs = getattr(ref, name)(ref.array(values, split=split), axis)
    expected = getattr(np, name)(values.astype(np.float64), axis=axis)
    assert mine.dtype.__name__ == theirs.dtype.__name__ == "float16"
    # the float64 result rounded once to float16: half an ulp, 2^-11 relative
    np.testing.assert_allclose(mine.numpy().astype(np.float64), expected, rtol=2**-10)
    np.testing.assert_allclose(mine.numpy(), theirs.numpy(), rtol=2**-10)


SEED_C = 20261017


@pytest.mark.parametrize("p", [3, 5])
@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
@pytest.mark.parametrize("name", ["skew", "kurtosis"])
def test_half_skew_kurtosis_compute_in_float32(name, dtype, p):
    import scipy.stats

    rng = np.random.default_rng(SEED_C)
    values = rng.normal(0, 20, (600, 4)).astype(np.float32)
    values = torch.from_numpy(values).to(getattr(torch, dtype)).float().numpy()  # exact in the half type
    mine = getattr(ht, name)(ht.array(values, dtype=getattr(ht, dtype), split=0, comm=_mesh(p)), 0)
    theirs = getattr(ref, name)(ref.array(values, dtype=getattr(ref, dtype), split=0), 0)
    fn = scipy.stats.skew if name == "skew" else scipy.stats.kurtosis
    expected = fn(values.astype(np.float64), axis=0, bias=False)
    assert mine.dtype.__name__ == theirs.dtype.__name__ == "float32"
    # float32 moments of 600 values: 1e-4 relative to the moments' scale
    np.testing.assert_allclose(mine.numpy(), theirs.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(mine.numpy(), expected, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("p", [3, 5])
@pytest.mark.parametrize("name", ["sum", "prod", "nansum"])
def test_uint8_sums_give_numpys_value(name, p):
    # ROADMAP queue C, a reference fault: under x64 heat_tpu raises on these,
    # numpy gives uint64 and the port heat's int64 with numpy's value
    values = np.array([200, 100, 7], np.uint8)
    mine = getattr(ht, name)(ht.array(values, split=0, comm=_mesh(p)))
    expected = getattr(np, name)(values)
    assert mine.dtype.__name__ == "int64"
    assert mine.item() == int(expected)  # 307 for the sums: no wrap at 256
    with pytest.raises(TypeError):
        getattr(ref, name)(ref.array(values, split=0))


# ---------------------------------------------------------------------------
# order statistics and counting (the sort slice): percentile, median,
# bincount, bucketize, digitize, histc, histogram. Order statistics and
# counts are exact; interpolated float32 percentiles within 1e-6 relative,
# float64 within 1e-12. The reference's dense percentile computes in float64
# under the tests' x64 mode, the port in the data's float type (heat's), so
# there the values are compared and the type is the data's.
# ---------------------------------------------------------------------------
INTERPOLATIONS = ["linear", "lower", "higher", "midpoint", "nearest"]
INTERPOLATED = {"float32": dict(rtol=1e-6, atol=1e-6), "float64": dict(rtol=1e-12, atol=1e-12)}


def _order_inputs(n, dtype, seed=0):
    """Values with ties, so that ranks land on repeated values too."""
    rng = np.random.default_rng(seed)
    return np.round(rng.normal(3.0, 2.0, n), 1).astype(dtype)


@pytest.mark.parametrize("interpolation", INTERPOLATIONS)
@pytest.mark.parametrize("dtype", ["float32", "float64", "int32"])
@pytest.mark.parametrize("q", [50.0, [1.0, 50.0, 99.0], [[0.0, 25.0], [75.0, 100.0]], 37.5], ids=str)
def test_percentile_by_bisection_equals_the_reference(q, dtype, interpolation):
    """The flat percentile of a split, unpadded array: its order statistics
    by bisection equal the reference's and the sorted ranks exactly."""
    n = 24 * ht.communication._cpu_mesh_size()
    values = _order_inputs(n, dtype)
    theirs, mine = both(values, 0)
    assert not mine.padded
    got = ht.percentile(mine, q, interpolation=interpolation)
    want = ref.percentile(theirs, q, interpolation=interpolation)
    assert got.dtype.__name__ == want.dtype.__name__ and got.gshape == tuple(want.shape) and got.split is None
    expected = np.percentile(values.astype(np.float64), q, method=interpolation)
    np.testing.assert_allclose(got.numpy(), expected, **INTERPOLATED["float32" if dtype != "float64" else "float64"])
    if interpolation in ("lower", "higher"):  # the ranks themselves, exactly
        np.testing.assert_array_equal(got.numpy(), np.percentile(values, q, method=interpolation).astype(got.numpy().dtype))
    # the reference's bisection stalls above the minimum when the minimum
    # is the statistic (the case below); elsewhere the two are equal
    agree = np.broadcast_to(np.asarray(q, np.float64) / 100 * (n - 1) >= 1, np.shape(got.numpy()))
    tolerance = EXACT if interpolation in ("lower", "higher", "nearest") or dtype == "float64" else INTERPOLATED["float32"]
    np.testing.assert_allclose(got.numpy()[agree], np.asarray(want.numpy())[agree], **tolerance)


def test_percentile_of_the_minimum_is_the_minimum():
    """A percentile whose order statistic is the minimum: numpy and the port
    give the minimum, the reference's value bisection one float above it
    (its upper end only ever moves to midpoints above the minimum)."""
    low = np.nextafter(np.float32(1.0), np.float32(2.0))  # an odd last bit: the midpoint rounds up
    values = np.array([4.0, low, 3.0, 2.0] * ht.communication._cpu_mesh_size(), np.float32)
    theirs, mine = both(values, 0)
    assert ht.percentile(mine, 0.0).numpy() == low == np.percentile(values, 0.0)
    assert ref.percentile(theirs, 0.0).numpy() == np.nextafter(low, np.float32(2.0))


@pytest.mark.parametrize("interpolation", INTERPOLATIONS)
@pytest.mark.parametrize("keepdims", [False, True])
@pytest.mark.parametrize("axis", [None, 0, 1])
@pytest.mark.parametrize("split", SPLITS)
def test_percentile_by_sort(split, axis, keepdims, interpolation):
    values = _order_inputs(13 * 7, "float32", seed=1).reshape(13, 7)
    values[4, 2] = np.nan if axis == 1 else values[4, 2]
    theirs, mine = both(values, split)
    q = [10.0, 50.0, 90.0]
    got = ht.percentile(mine, q, axis=axis, interpolation=interpolation, keepdims=keepdims)
    want = ref.percentile(theirs, q, axis=axis, interpolation=interpolation, keepdims=keepdims)
    assert got.dtype is ht.float32 and got.gshape == tuple(want.shape) and got.split is None
    expected = np.percentile(values.astype(np.float64), q, axis=axis, method=interpolation, keepdims=keepdims)
    np.testing.assert_allclose(got.numpy(), expected, equal_nan=True, **INTERPOLATED["float32"])
    if interpolation != "nearest":  # see the case below
        np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()), equal_nan=True, **INTERPOLATED["float32"])


def test_percentile_nearest_rounds_half_to_even_as_numpy_does():
    """numpy's 'nearest' rounds a position of k + 1/2 to the even neighbour;
    the reference's dense path (jnp.percentile) takes the lower one. The
    port sides with numpy. Its bisection path rounds half to even too."""
    values = np.arange(6, dtype=np.float64)  # q=70 -> position 3.5
    theirs, mine = both(values, None)
    assert np.percentile(values, 70, method="nearest") == 4.0
    # 3.0 with jnp.percentile's rule (the reference's), 4.0 where jax rounds as numpy
    assert float(ref.percentile(theirs, 70.0, interpolation="nearest").item()) in (3.0, 4.0)
    assert float(ht.percentile(mine, 70.0, interpolation="nearest").item()) == 4.0
    assert float(ht.percentile(ht.array(values, split=0), 70.0, interpolation="nearest").item()) == 4.0


@pytest.mark.parametrize("keepdims", [False, True])
@pytest.mark.parametrize("axis", [None, 0, 1])
@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("dtype", ["float32", "float64", "int64"])
def test_median(dtype, split, axis, keepdims):
    values = _order_inputs(12 * 8, dtype, seed=2).reshape(12, 8)
    theirs, mine = both(values, split)
    got = ht.median(mine, axis=axis, keepdims=keepdims)
    want = ref.median(theirs, axis=axis, keepdims=keepdims)
    expected = np.median(values, axis=axis, keepdims=keepdims)
    assert got.gshape == tuple(want.shape) and got.split == want.split
    np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()), **INTERPOLATED["float64" if dtype != "float32" else "float32"])
    np.testing.assert_allclose(got.numpy(), expected, **INTERPOLATED["float64" if dtype != "float32" else "float32"])
    assert mine.median(axis=axis).gshape == got.gshape if not keepdims else True


def test_median_is_numpys_not_torchs():
    values = np.array([4.0, 1.0, 3.0, 2.0], np.float32)
    assert float(torch.median(torch.from_numpy(values))) == 2.0
    for split in (None, 0):
        assert float(ht.median(ht.array(values, split=split)).item()) == 2.5


def test_bisection_reads_nothing_back(monkeypatch):
    """No step of the bisection converts a tensor to a host value."""
    values = _order_inputs(24 * ht.communication._cpu_mesh_size(), "float32", seed=3)
    mine = ht.array(values, split=0)
    for name in ("item", "tolist", "__bool__", "__float__", "__int__"):
        monkeypatch.setattr(torch.Tensor, name, lambda *a, _n=name: pytest.fail(f"Tensor.{_n}"))
    got = ht.percentile(mine, [1.0, 50.0, 99.0])
    monkeypatch.undo()
    np.testing.assert_allclose(got.numpy(), np.percentile(values.astype(np.float64), [1, 50, 99]), rtol=1e-6)


@pytest.mark.parametrize("split", [None, 0])
@pytest.mark.parametrize("dtype", ["int32", "int64"])
def test_bincount(dtype, split):
    values = np.random.default_rng(4).integers(0, 9, 41).astype(dtype)
    weights = data((41,), "float64")
    theirs, mine = both(values, split)
    check(ht.bincount(mine), ref.bincount(theirs), np.bincount(values), **EXACT)
    check(ht.bincount(mine, minlength=12), ref.bincount(theirs, minlength=12), np.bincount(values, minlength=12), **EXACT)
    w_ref, w_mine = both(weights, split)
    check(ht.bincount(mine, weights=w_mine), ref.bincount(theirs, weights=w_ref), np.bincount(values, weights), **REDUCTION["float64"])
    with pytest.raises(TypeError):
        ht.bincount(ht.array(weights))


@pytest.mark.parametrize("right", [False, True])
@pytest.mark.parametrize("split", SPLITS)
def test_bucketize_and_digitize(split, right):
    values = np.round(data((13, 7), "float32", -4, 4), 0)  # on the boundaries too
    theirs, mine = both(values, split)
    inc = np.array([-3.0, -1.0, 0.0, 2.0, 3.0], np.float32)
    expected = np.searchsorted(inc, values, side="right" if right else "left")
    check(ht.bucketize(mine, ht.array(inc), right=right), ref.bucketize(theirs, ref.array(inc), right=right), expected, **EXACT)
    check(ht.bucketize(mine, inc, out_int32=True), ref.bucketize(theirs, inc, out_int32=True), np.searchsorted(inc, values), **EXACT)
    for bins in (inc, inc[::-1].copy()):
        check(ht.digitize(mine, bins, right=right), ref.digitize(theirs, bins, right=right), np.digitize(values, bins, right=right), **EXACT)
    with pytest.raises(ValueError):
        ht.digitize(mine, np.array([0.0, 2.0, 1.0]))


def test_digitize_takes_decreasing_bins_where_torch_does_not():
    bins = np.array([5.0, 2.0, 0.0])
    values = np.array([6.0, 5.0, 3.0, 2.0, 1.0, 0.0, -1.0])
    for right in (False, True):
        np.testing.assert_array_equal(ht.digitize(ht.array(values), bins, right=right).numpy(), np.digitize(values, bins, right=right))


@pytest.mark.parametrize("split", [None, 0])
@pytest.mark.parametrize("dtype", ["float32", "float64", "int32"])
def test_histc(dtype, split):
    values = data((13, 7), dtype, -5, 5)
    theirs, mine = both(values, split)
    for args in ((10, 0.0, 0.0), (7, -2.0, 3.0), (4, 1.0, 1.0)):
        got = ht.histc(mine, *args)
        expected = torch.histc(torch.from_numpy(values).double(), *args).numpy().astype(dtype)
        if args[1] == args[2] != 0:
            # torch.histc takes the data's range; the reference [min - 1, max + 1]
            np.testing.assert_array_equal(got.numpy(), expected)
            assert ref.histc(theirs, *args).numpy().sum() < values.size
            continue
        check(got, ref.histc(theirs, *args), expected, **EXACT)


@pytest.mark.parametrize("split", [None, 0])
@pytest.mark.parametrize("dtype", ["float32", "float64", "int64"])
def test_histogram(dtype, split):
    values = data((13, 7), dtype, -5, 5)
    theirs, mine = both(values, split)
    for kwargs in (dict(), dict(bins=4, range=(-2.0, 3.0)), dict(bins=np.array([-5.0, -1.0, 0.0, 4.0])), dict(bins=6, density=True)):
        (h, e), (rh, re_) = ht.histogram(mine, **kwargs), ref.histogram(theirs, **kwargs)
        nh, ne = np.histogram(values, **kwargs)
        assert h.gshape == tuple(rh.shape) and e.gshape == tuple(re_.shape)
        # XLA may contract the edges' a(1 - s) + b s into one FMA: an ulp
        np.testing.assert_allclose(e.numpy(), np.asarray(re_.numpy()), **INTERPOLATED["float32" if dtype == "float32" else "float64"])
        np.testing.assert_allclose(h.numpy(), np.asarray(rh.numpy()), **INTERPOLATED["float32" if dtype == "float32" else "float64"])
        np.testing.assert_allclose(h.numpy(), nh, rtol=1e-6)
        if not kwargs.get("density"):
            assert h.dtype is ht.int64
    weights = data((13, 7), "float64", 0, 1)
    (h, _), (rh, _) = ht.histogram(mine, bins=5, weights=ht.array(weights)), ref.histogram(theirs, bins=5, weights=ref.array(weights))
    np.testing.assert_allclose(h.numpy(), np.asarray(rh.numpy()), **INTERPOLATED["float64"])


# ---------------------------------------------------------------------------
# faults C8-C10 and C12 of ROADMAP queue C: the port on explicit meshes of 3
# and 5 shards, against numpy (and the reference where it agrees with numpy)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("p", [3, 5])
@pytest.mark.parametrize(
    "values,bins,range_",
    [
        (np.array([-3, -1, 0, 1, 2], np.int32), 10, None),  # the C8 repro
        (np.arange(-50, 50, dtype=np.int64), 7, None),
        (np.random.default_rng(SEED_C).normal(size=1001).astype(np.float32), 10, None),
        (np.random.default_rng(SEED_C).normal(size=1001).astype(np.float32), 12, (-1.5, 2.5)),
        (np.linspace(0, 1, 41, dtype=np.float64), 8, None),
    ],
)
def test_histogram_bins_values_on_an_edge_as_numpy_does(values, bins, range_, p):
    # exact: numpy's linspace edges and its index correction at the edges
    hist, edges = ht.histogram(ht.array(values, split=0, comm=_mesh(p)), bins=bins, range=range_)
    expected, expected_edges = np.histogram(values, bins=bins, range=range_)
    np.testing.assert_array_equal(hist.numpy(), expected)
    assert edges.numpy().dtype == expected_edges.dtype
    np.testing.assert_array_equal(edges.numpy(), expected_edges)


@pytest.mark.parametrize("p", [3, 5])
@pytest.mark.parametrize("split", [None, 0, 2])
@pytest.mark.parametrize("axis", [(0, 1), (1, 2), (0, 2), (-1, 0)])
def test_order_statistics_take_a_tuple_axis(axis, split, p):
    values = data((6, 5, 4), "float32", seed=SEED_C)
    x = ht.array(values, split=split, comm=_mesh(p))
    # float32 order statistics are exact; the interpolation within 1e-6
    for keepdims in (False, True):
        mine = ht.median(x, axis=axis, keepdims=keepdims)
        np.testing.assert_allclose(mine.numpy(), np.median(values, axis=axis, keepdims=keepdims), rtol=1e-6)
        theirs = ref.median(ref.array(values, split=split), axis=axis, keepdims=keepdims)
        assert mine.split == theirs.split and mine.gshape == tuple(theirs.shape)
    mine = ht.percentile(x, [30, 75], axis=axis)
    np.testing.assert_allclose(mine.numpy(), np.percentile(values, [30, 75], axis=axis), rtol=1e-6, atol=1e-6)
    theirs = ref.percentile(ref.array(values, split=split), [30, 75], axis=axis)
    np.testing.assert_allclose(mine.numpy(), theirs.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("p", [3, 5])
@pytest.mark.parametrize("split", [None, 0])
def test_bincount_of_bool_counts_false_and_true(split, p):
    values = data((17,), "bool", seed=SEED_C)
    mine = ht.bincount(ht.array(values, split=split, comm=_mesh(p)))
    np.testing.assert_array_equal(mine.numpy(), np.bincount(values))
    np.testing.assert_array_equal(mine.numpy(), ref.bincount(ref.array(values, split=split)).numpy())


@pytest.mark.parametrize("p", [3, 5])
@pytest.mark.parametrize("q", [150, -1, [20, 101]])
def test_percentile_outside_0_100_raises_value_error(q, p):
    values = data((13,), "float32", seed=SEED_C)
    with pytest.raises(ValueError):
        np.percentile(values, q)
    with pytest.raises(ValueError):
        ht.percentile(ht.array(values, split=0, comm=_mesh(p)), q)


# ---------------------------------------------------------------------------
# fault C16 of ROADMAP queue C: a negative bincount value raises numpy's
# ValueError, on explicit meshes of 3 and 5 shards
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("p", [3, 5])
@pytest.mark.parametrize("split", [None, 0])
def test_bincount_of_a_negative_value_raises_value_error(split, p):
    values = np.array([1, -1, 2, 4, 0, 3, 1], np.int64)
    with pytest.raises(ValueError):
        np.bincount(values)
    with pytest.raises(ValueError):
        ht.bincount(ht.array(values, split=split, comm=_mesh(p)))
    good = np.abs(values)
    np.testing.assert_array_equal(ht.bincount(ht.array(good, split=split, comm=_mesh(p))).numpy(), np.bincount(good))
