"""heat_tpu_torch's manipulations, indexing and the new factories against
heat_tpu and numpy on the CPU mesh: resplit, reshape (its new_split
default), concatenate, stack, vstack/hstack, expand_dims, squeeze,
flatten/ravel, broadcast_to/broadcast_arrays, swapaxes/moveaxis, flip,
transpose, where, nonzero, copy, *_like and linspace. Cases from
test_manipulations.py and test_ragged.py. Every result is checked for
type, split, shape and its shards; the values are exact."""

import numpy as np
import pytest
import torch

import heat_tpu as ref
import heat_tpu_torch as ht
from test_torch_parity import EXACT, SHAPES, both, check, check_layout, data, on_cpu  # noqa: F401

SPLITS = [None, 0, 1]
TYPES = ["bool", "int32", "int64", "float32", "float64"]


def _pair(shape=SHAPES["ragged"], split=None, dtype="float32", seed=0):
    values = data(shape, dtype, seed=seed)
    return (values,) + both(values, split)


@pytest.mark.parametrize("shape", list(SHAPES.values()), ids=list(SHAPES))
@pytest.mark.parametrize("target", SPLITS)
@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("dtype", TYPES)
def test_resplit(dtype, split, target, shape):
    values, theirs, mine = _pair(shape, split, dtype)
    got = ht.resplit(mine, target)
    check(got, ref.resplit(theirs, target), values, **EXACT)
    check(mine.resplit(target), theirs.resplit(target), values, **EXACT)
    assert mine.split == split  # out of place
    if target == split:  # a copy, not a view
        assert all(a.data_ptr() != b.data_ptr() for a, b in zip(got.shards, mine.shards))


@pytest.mark.parametrize(
    "shape,new_shape,new_split",
    [
        ((13, 7), (7, 13), None), ((13, 7), (91,), None), ((13, 7), (91, 1), None),
        ((13, 7), (1, 91), 1), ((12, 8), (4, 3, 8), None), ((12, 8), (4, 24), 1),
        ((12, 8), (-1, 6), None), ((12, 8), (2, -1), 0), ((1000,), (10, 100), None),
    ],
    ids=str,
)
@pytest.mark.parametrize("split", SPLITS)
def test_reshape(shape, new_shape, new_split, split):
    if split is not None and split >= len(shape):
        split = 0
    values, theirs, mine = _pair(shape, split, "float64")
    check(
        ht.reshape(mine, new_shape, new_split=new_split),
        ref.reshape(theirs, new_shape, new_split=new_split),
        values.reshape(new_shape), **EXACT,
    )
    check(mine.reshape(*new_shape), theirs.reshape(*new_shape), values.reshape(new_shape), **EXACT)
    with pytest.raises(ValueError):
        ht.reshape(mine, (5, 5))


@pytest.mark.parametrize("axis", [0, 1, -1])
@pytest.mark.parametrize("splits", [(None, None), (0, 0), (1, 1), (0, None), (None, 1)], ids=str)
def test_concatenate_and_stack(splits, axis):
    a = data((13, 7), "float32")
    b = data((13, 7), "int32", seed=1)
    (ra, ma), (rb, mb) = both(a, splits[0]), both(b, splits[1])
    check(ht.concatenate([ma, mb], axis), ref.concatenate([ra, rb], axis), np.concatenate([a, b], axis), **EXACT)
    check(ht.concatenate((ma, ma, ma), axis), ref.concatenate((ra, ra, ra), axis), np.concatenate([a, a, a], axis), **EXACT)
    c = data((13, 7), "float32", seed=2)
    rc, mc = both(c, splits[0])
    check(ht.stack([ma, mc], axis), ref.stack([ra, rc], axis), np.stack([a, c], axis), **EXACT)
    with pytest.raises(ValueError):
        ht.stack([ma, ht.zeros((2, 2))])
    with pytest.raises(TypeError):
        ht.concatenate(ma)


@pytest.mark.parametrize("split", SPLITS)
def test_vstack_hstack(split):
    a, b = data((13, 7), "float64"), data((13, 7), "float64", seed=1)
    (ra, ma), (rb, mb) = both(a, split), both(b, split)
    check(ht.vstack([ma, mb]), ref.vstack([ra, rb]), np.vstack([a, b]), **EXACT)
    check(ht.hstack([ma, mb]), ref.hstack([ra, rb]), np.hstack([a, b]), **EXACT)
    check(ht.row_stack([ma, mb]), ref.row_stack([ra, rb]), np.vstack([a, b]), **EXACT)
    check(ht.column_stack([ma, mb]), ref.column_stack([ra, rb]), np.column_stack([a, b]), **EXACT)
    v, w = data((9,), "float64"), data((9,), "float64", seed=1)
    (rv, mv), (rw, mw) = both(v, None if split is None else 0), both(w, None if split is None else 0)
    check(ht.hstack([mv, mw]), ref.hstack([rv, rw]), np.hstack([v, w]), **EXACT)
    check(ht.vstack([mv, mw]), ref.vstack([rv, rw]), np.vstack([v, w]), **EXACT)
    check(ht.column_stack([mv, mw]), ref.column_stack([rv, rw]), np.column_stack([v, w]), **EXACT)


@pytest.mark.parametrize("axis", [0, 1, 2, -1])
@pytest.mark.parametrize("split", SPLITS)
def test_expand_dims_squeeze(split, axis):
    values, theirs, mine = _pair(split=split)
    check(ht.expand_dims(mine, axis), ref.expand_dims(theirs, axis), np.expand_dims(values, axis), **EXACT)
    expanded, ref_expanded = ht.expand_dims(mine, axis), ref.expand_dims(theirs, axis)
    check(ht.squeeze(expanded), ref.squeeze(ref_expanded), values, **EXACT)
    check(expanded.squeeze(axis), ref_expanded.squeeze(axis), values, **EXACT)
    with pytest.raises(ValueError):
        ht.squeeze(mine, 0)


@pytest.mark.parametrize("shape", [(1, 7), (13, 1), (1, 1)], ids=str)
@pytest.mark.parametrize("split", [0, 1])
def test_squeeze_the_split_axis(split, shape):
    values, theirs, mine = _pair(shape, split, "int64")
    check(ht.squeeze(mine), ref.squeeze(theirs), np.squeeze(values), **EXACT)


@pytest.mark.parametrize("shape", list(SHAPES.values()), ids=list(SHAPES))
@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("dtype", TYPES)
def test_flatten_ravel(dtype, split, shape):
    values, theirs, mine = _pair(shape, split, dtype)
    check(ht.flatten(mine), ref.flatten(theirs), values.ravel(), **EXACT)
    check(mine.ravel(), theirs.ravel(), values.ravel(), **EXACT)


@pytest.mark.parametrize("split", SPLITS)
def test_broadcast(split):
    values, theirs, mine = _pair((1, 7), split if split != 0 else None, "float32")
    check(ht.broadcast_to(mine, (13, 7)), ref.broadcast_to(theirs, (13, 7)), np.broadcast_to(values, (13, 7)), **EXACT)
    check(ht.broadcast_to(mine, (4, 13, 7)), ref.broadcast_to(theirs, (4, 13, 7)), np.broadcast_to(values, (4, 13, 7)), **EXACT)
    col = data((13, 1), "float32", seed=2)
    rc, mc = both(col, split if split != 1 else None)
    got, want = ht.broadcast_arrays(mine, mc), ref.broadcast_arrays(theirs, rc)
    for g, w, e in zip(got, want, np.broadcast_arrays(values, col)):
        check(g, w, e, **EXACT)


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("case", [(0, 1), (1, 0), (-1, 0)], ids=str)
def test_swapaxes_moveaxis_transpose(case, split):
    values, theirs, mine = _pair((13, 7, 3), split)
    check(ht.swapaxes(mine, *case), ref.swapaxes(theirs, *case), np.swapaxes(values, *case), **EXACT)
    check(ht.moveaxis(mine, *case), ref.moveaxis(theirs, *case), np.moveaxis(values, *case), **EXACT)
    check(mine.T, theirs.T, values.T, **EXACT)
    check(ht.transpose(mine, (1, 2, 0)), ref.transpose(theirs, (1, 2, 0)), values.transpose(1, 2, 0), **EXACT)
    check(ht.moveaxis(mine, (0, 1), (2, 0)), ref.moveaxis(theirs, (0, 1), (2, 0)), np.moveaxis(values, (0, 1), (2, 0)), **EXACT)


@pytest.mark.parametrize("axis", [None, 0, 1, (0, 1)], ids=str)
@pytest.mark.parametrize("split", SPLITS)
def test_flip(split, axis):
    values, theirs, mine = _pair(split=split)
    check(ht.flip(mine, axis), ref.flip(theirs, axis), np.flip(values, axis), **EXACT)
    check(ht.flipud(mine), ref.flipud(theirs), np.flipud(values), **EXACT)
    check(ht.fliplr(mine), ref.fliplr(theirs), np.fliplr(values), **EXACT)


@pytest.mark.parametrize("layout", [(None, None, None), (0, 0, 0), (1, 1, 1), (0, None, 1), (None, 0, None), (1, None, 0)], ids=str)
def test_where(layout):
    cond = data((13, 7), "bool", seed=3)
    x, y = data((13, 7), "float32"), data((13, 7), "int32", seed=1)
    (rc, mc), (rx, mx), (ry, my) = both(cond, layout[0]), both(x, layout[1]), both(y, layout[2])
    check(ht.where(mc, mx, my), ref.where(rc, rx, ry), np.where(cond, x, y), **EXACT)
    check(ht.where(mc, mx, 0.5), ref.where(rc, rx, 0.5), np.where(cond, x, 0.5), **EXACT)
    check(ht.where(mc, -1, my), ref.where(rc, -1, ry), np.where(cond, -1, y), **EXACT)
    check(ht.where(mc, 0, 1), ref.where(rc, 0, 1), np.where(cond, 0, 1), **EXACT)
    check(ht.where(mx > 0, mx, -mx), ref.where(rx > 0, rx, -rx), np.where(x > 0, x, -x), **EXACT)
    row = data((7,), "float32", seed=4)
    rr, mr = both(row)
    check(ht.where(mc, mx, mr), ref.where(rc, rx, rr), np.where(cond, x, row), **EXACT)
    with pytest.raises(TypeError):
        ht.where(mc, mx)


@pytest.mark.parametrize("shape", [(13,), (13, 7), (4, 5, 3)], ids=str)
@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("dtype", ["bool", "int32", "float64"])
def test_nonzero(dtype, split, shape):
    if split is not None and split >= len(shape):
        split = 0
    values, theirs, mine = _pair(shape, split, dtype)
    expected = np.stack(np.nonzero(values), axis=1) if len(shape) > 1 else np.nonzero(values)[0]
    check(ht.nonzero(mine), ref.nonzero(theirs), expected, **EXACT)
    check(ht.where(mine), ref.where(theirs), expected, **EXACT)


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("dtype", TYPES)
def test_copy(dtype, split):
    values, theirs, mine = _pair(split=split, dtype=dtype)
    got = ht.copy(mine)
    check(got, ref.copy(theirs), values, **EXACT)
    assert all(a.data_ptr() != b.data_ptr() for a, b in zip(got.shards, mine.shards))
    check(mine.copy(), theirs.copy(), values, **EXACT)


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("dtype", [None, "int32", "float64"])
def test_like_factories(dtype, split):
    values, theirs, mine = _pair(split=split)
    kw = {} if dtype is None else {"dtype": dtype}
    for name, npfn in (("zeros_like", np.zeros_like), ("ones_like", np.ones_like)):
        check(getattr(ht, name)(mine, **kw), getattr(ref, name)(theirs, **kw), npfn(values, **kw), **EXACT)
    check(ht.full_like(mine, 3, **kw), ref.full_like(theirs, 3, **kw), np.full(values.shape, 3), **EXACT)
    got, want = ht.empty_like(mine, **kw), ref.empty_like(theirs, **kw)
    assert (got.dtype.__name__, got.split, got.gshape) == (want.dtype.__name__, want.split, tuple(want.shape))
    check(ht.zeros_like(mine, split=0), ref.zeros_like(theirs, split=0), np.zeros_like(values), **EXACT)


@pytest.mark.parametrize("split", [None, 0])
@pytest.mark.parametrize("args", [(0, 1, 5), (-2.5, 7, 13), (3, -3, 50), (1, 1, 1)], ids=str)
@pytest.mark.parametrize("endpoint", [True, False])
def test_linspace(args, endpoint, split):
    """float32 by default in the port, as heat's factories; the reference
    takes JAX's default float there, float64 in the tests' x64 mode, so the
    two are held to each other at an explicit dtype."""
    for dtype in ("float32", "float64"):
        check(
            ht.linspace(*args, endpoint=endpoint, split=split, dtype=getattr(ht, dtype)),
            ref.linspace(*args, endpoint=endpoint, split=split, dtype=getattr(ref, dtype)),
            np.linspace(*args, endpoint=endpoint, dtype=dtype),
            rtol=1e-6 if dtype == "float32" else 1e-12, atol=1e-6 if dtype == "float32" else 1e-12,
        )
    got = ht.linspace(*args, endpoint=endpoint, split=split)
    assert got.dtype is ht.float32
    np.testing.assert_allclose(got.numpy(), np.linspace(*args, endpoint=endpoint), rtol=1e-6, atol=1e-6)
    _, step = ht.linspace(*args, endpoint=endpoint, retstep=True)
    assert step == pytest.approx(ref.linspace(*args, endpoint=endpoint, retstep=True)[1])


# ---------------------------------------------------------------------------
# the rest of the array layer (the sort slice): pad in every mode, roll,
# rot90, tile, repeat, diag/diagonal, the split family, balance, collect,
# redistribute, logspace, meshgrid, from_partitioned and the sanitizers.
# Exact, but for the float 'mean'/'linear_ramp' pads and logspace (1e-6
# relative in float32: their arithmetic runs in other orders).
# ---------------------------------------------------------------------------
PAD_MODES = ["constant", "edge", "reflect", "symmetric", "wrap", "linear_ramp", "maximum", "minimum", "mean", "median"]


@pytest.mark.parametrize("mode", PAD_MODES + ["empty"])
@pytest.mark.parametrize("width", [2, ((1, 3), (2, 0)), ((0, 9), (8, 1))], ids=str)
@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_pad_every_mode(dtype, split, width, mode):
    if mode == "linear_ramp" and dtype == "int32":
        # numpy 2 rounds an integer ramp down, numpy 1 toward zero; the
        # port rounds down (numpy 2), checked below on the non-negative side
        values = data((5, 4), dtype, 0, 9)
        got = ht.pad(ht.array(values, split=split), width, mode=mode)
        np.testing.assert_array_equal(got.numpy(), np.pad(values, width, mode=mode))
        return
    values = data((5, 4), dtype, -9, 9)
    theirs, mine = both(values, split)
    got = ht.pad(mine, width, mode=mode)
    want = ref.pad(theirs, width, mode=mode)
    if mode == "empty":  # numpy leaves the new values undefined: the shape and the interior
        assert got.gshape == tuple(want.shape) and got.split == want.split
        inner = tuple(slice(w[0], w[0] + n) for w, n in zip(np.broadcast_to(width, (2, 2)), values.shape))
        np.testing.assert_array_equal(got.numpy()[inner], values)
        return
    expected = np.pad(values, width, mode=mode)
    loose = dtype == "float32" and mode in ("mean", "linear_ramp", "median")
    check(got, want, expected, **(dict(rtol=1e-6, atol=1e-6) if loose else EXACT))


@pytest.mark.parametrize("split", SPLITS)
def test_pad_constant_values_and_errors(split):
    values = data((5, 4), "float64")
    theirs, mine = both(values, split)
    for width, cv in ((1, 7.5), (((1, 2), (0, 1)), ((1.0, 2.0), (3.0, 4.0))), ((2, 1), -1)):
        check(ht.pad(mine, width, constant_values=cv), ref.pad(theirs, width, constant_values=cv),
              np.pad(values, width, constant_values=cv), **EXACT)
    with pytest.raises(ValueError):
        ht.pad(mine, -1)
    with pytest.raises(ValueError):
        ht.pad(mine, 1, mode="bogus")
    with pytest.raises(ValueError):
        ht.pad(ht.zeros((0, 3)), 1, mode="edge")


@pytest.mark.parametrize("shift,axis", [(3, None), (-2, 0), (4, 1), ((1, -2), (0, 1)), (15, 0)], ids=str)
@pytest.mark.parametrize("split", SPLITS)
def test_roll(split, shift, axis):
    values = data((13, 7), "int64")
    theirs, mine = both(values, split)
    check(ht.roll(mine, shift, axis), ref.roll(theirs, shift, axis), np.roll(values, shift, axis), **EXACT)
    check(mine.roll(shift, axis), theirs.roll(shift, axis), np.roll(values, shift, axis), **EXACT)


@pytest.mark.parametrize("k,axes", [(1, (0, 1)), (2, (0, 1)), (3, (1, 0)), (-1, (0, 2)), (1, (2, 1))], ids=str)
@pytest.mark.parametrize("split", [None, 0, 1, 2])
def test_rot90(split, k, axes):
    values = data((5, 4, 3), "float32")
    theirs, mine = both(values, split)
    check(ht.rot90(mine, k, axes), ref.rot90(theirs, k, axes), np.rot90(values, k, axes), **EXACT)
    with pytest.raises(ValueError):
        ht.rot90(mine, 1, (0, 0))


@pytest.mark.parametrize("reps", [2, (2, 1), (1, 3), (2, 1, 2)], ids=str)
@pytest.mark.parametrize("split", SPLITS)
def test_tile(split, reps):
    values = data((5, 4), "int32")
    theirs, mine = both(values, split)
    check(ht.tile(mine, reps), ref.tile(theirs, reps), np.tile(values, reps), **EXACT)


@pytest.mark.parametrize("repeats,axis", [(2, None), (3, 0), ([1, 0, 2, 1], 1), (2, 1)], ids=str)
@pytest.mark.parametrize("split", SPLITS)
def test_repeat(split, repeats, axis):
    values = data((5, 4), "float64")
    theirs, mine = both(values, split)
    check(ht.repeat(mine, repeats, axis), ref.repeat(theirs, repeats, axis), np.repeat(values, repeats, axis), **EXACT)
    if isinstance(repeats, list):
        check(ht.repeat(mine, ht.array(repeats), axis), ref.repeat(theirs, ref.array(repeats), axis),
              np.repeat(values, repeats, axis), **EXACT)
    with pytest.raises(TypeError):
        ht.repeat(mine, 1.5)


@pytest.mark.parametrize("offset", [0, 1, -2])
@pytest.mark.parametrize("split", SPLITS)
def test_diag_and_diagonal(split, offset):
    m = data((6, 5), "float32")
    theirs, mine = both(m, split)
    check(ht.diag(mine, offset), ref.diag(theirs, offset), np.diag(m, offset), **EXACT)
    check(ht.diagonal(mine, offset, 1, 0), ref.diagonal(theirs, offset, 1, 0), np.diagonal(m, offset, 1, 0), **EXACT)
    v = data((7,), "int32")
    theirs, mine = both(v, None if split == 1 else split)
    check(ht.diag(mine, offset), ref.diag(theirs, offset), np.diag(v, offset), **EXACT)
    cube = data((4, 3, 5), "float64")
    for s in (None, 0, 1, 2):
        theirs, mine = both(cube, s)
        check(ht.diagonal(mine, 0, 0, 2), ref.diagonal(theirs, 0, 0, 2), np.diagonal(cube, 0, 0, 2), **EXACT)
    with pytest.raises(ValueError):
        ht.diagonal(mine, 0, 1, 1)


@pytest.mark.parametrize("sections", [2, [1, 4], [3, 3, 9]], ids=str)
@pytest.mark.parametrize("split", SPLITS)
def test_split_family(split, sections):
    values = data((6, 4, 2), "int64")
    theirs, mine = both(values, split)
    for name, axis in (("split", 0), ("vsplit", 0), ("hsplit", 1), ("dsplit", 2)):
        if name == "dsplit" and sections != 2:
            continue
        got = getattr(ht, name)(mine, sections) if name != "split" else ht.split(mine, sections, axis)
        expected = getattr(np, name)(values, sections)
        assert len(got) == len(expected)
        if any(e.size == 0 for e in expected) or sorted(np.atleast_1d(sections)) != list(np.atleast_1d(sections)) \
                or np.max(sections) > values.shape[axis]:
            # the reference cannot place an empty piece, and jnp.split refuses
            # split points past the axis, which numpy takes: numpy alone
            for g, e in zip(got, expected):
                assert g.gshape == e.shape and g.split == split
                np.testing.assert_array_equal(g.numpy(), e)
            continue
        want = getattr(ref, name)(theirs, sections) if name != "split" else ref.split(theirs, sections, axis)
        for g, w, e in zip(got, want, expected):
            check(g, w, e, **EXACT)
    with pytest.raises(ValueError):
        ht.split(mine, 4, 0)
    flat = ht.array(np.arange(6), split=None if split is None else 0)
    assert [p.numpy().tolist() for p in ht.hsplit(flat, 3)] == [[0, 1], [2, 3], [4, 5]]


@pytest.mark.parametrize("split", SPLITS)
def test_balance_collect_redistribute_vstack_ravel(split):
    values = data((13, 7), "float32")
    theirs, mine = both(values, split)
    assert ht.balance(mine) is mine
    copied = ht.balance(mine, copy=True)
    check(copied, ref.balance(theirs, copy=True), values, **EXACT)
    assert all(a.data_ptr() != b.data_ptr() for a, b in zip(copied.shards, mine.shards))
    check(ht.collect(mine), ref.collect(theirs), values, **EXACT)
    check(mine.redistribute(), theirs.redistribute(), values, **EXACT)
    check(ht.vstack([mine, mine]), ref.vstack([theirs, theirs]), np.vstack([values, values]), **EXACT)
    check(ht.ravel(mine), ref.ravel(theirs), values.ravel(), **EXACT)


@pytest.mark.parametrize("split", [None, 0])
def test_logspace_meshgrid_from_partitioned(split):
    for args, kwargs in (((0, 3, 7), {}), ((1.0, 2.0, 5), dict(base=2.0, endpoint=False)), ((-1, 1, 4), dict(dtype=ht.float64))):
        ref_kwargs = {k: (ref.float64 if v is ht.float64 else v) for k, v in kwargs.items()}
        got, want = ht.logspace(*args, split=split, **kwargs), ref.logspace(*args, split=split, **ref_kwargs)
        expected = np.logspace(*args, **{k: v for k, v in kwargs.items() if k != "dtype"})
        # heat's float32 by default; the reference's linspace gives float64 in x64 mode
        assert got.dtype is kwargs.get("dtype", ht.float32) and got.split == want.split
        np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()), rtol=1e-6)
        np.testing.assert_allclose(got.numpy(), expected, rtol=1e-6)
    x, y = data((4,), "float32"), data((3,), "float32", seed=1)
    for indexing in ("xy", "ij"):
        (rx, mx), (ry, my) = both(x, split), both(y, None)
        got = ht.meshgrid(mx, my, indexing=indexing)
        want = ref.meshgrid(rx, ry, indexing=indexing)
        for g, w, e in zip(got, want, np.meshgrid(x, y, indexing=indexing)):
            check(g, w, e, **EXACT)
    assert ht.meshgrid() == []
    with pytest.raises(ValueError):
        ht.meshgrid(ht.array(x), indexing="xx")
    check(ht.from_partitioned(x), ref.from_partitioned(x), x, **EXACT)


def test_sanitizers():
    values = data((13, 7), "float32")
    theirs, mine = both(values, 0)
    other = ht.array(values, split=1)
    got = ht.sanitize_distribution(other, target=mine)
    assert got.split == 0 and other.split == 1
    np.testing.assert_array_equal(got.numpy(), values)
    ht.sanitize_lshape(mine, torch.zeros(mine.lshape))
    with pytest.raises(ValueError):
        ht.sanitize_lshape(mine, torch.zeros((1, 1)))
    ht.sanitize_in_tensor(torch.zeros(2))
    with pytest.raises(TypeError):
        ht.sanitize_in_tensor(np.zeros(2))
    assert ht.scalar_to_1d(ht.array(3.0)).gshape == (1,) == tuple(ref.scalar_to_1d(ref.array(3.0)).shape)
    assert ht.sanitize_slice(slice(-3, None, -1), 13) == ref.sanitize_slice(slice(-3, None, -1), 13)
    assert ht.sanitize_memory_layout(mine, "F") is mine
    with pytest.raises(ValueError):
        ht.sanitize_memory_layout(mine, "X")


# ---------------------------------------------------------------------------
# faults C9 and C12 of ROADMAP queue C: the port on explicit meshes of 3 and
# 5 shards against numpy's values and error types
# ---------------------------------------------------------------------------
def _mesh(p):
    from heat_tpu_torch.core.communication import MeshCommunication

    return MeshCommunication([torch.device("cpu")] * p)


@pytest.mark.parametrize("p", [3, 5])
@pytest.mark.parametrize("split", [None, 0, 2])
@pytest.mark.parametrize("axis", [(0, 1), (0, 3), (-1, 1), (4, 0, 2), 3])
def test_expand_dims_takes_a_tuple_axis(axis, split, p):
    values = data((7, 3, 2), "float32")
    mine = ht.expand_dims(ht.array(values, split=split, comm=_mesh(p)), axis)
    expected = np.expand_dims(values, axis)
    np.testing.assert_array_equal(mine.numpy(), expected)
    assert mine.gshape == expected.shape
    if split is not None:
        # the split follows its axis to its place among the new ones
        assert mine.gshape[mine.split] == values.shape[split]
    check_layout(mine)


@pytest.mark.parametrize("p", [3, 5])
def test_concatenate_of_mismatched_shapes_raises_value_error(p):
    a = ht.zeros((4, 3), split=0, comm=_mesh(p))
    for other in (ht.zeros((2, 2), split=0, comm=_mesh(p)), ht.zeros((2,), split=0, comm=_mesh(p))):
        with pytest.raises(ValueError):
            np.concatenate([np.zeros((4, 3)), np.zeros(other.gshape)])
        with pytest.raises(ValueError):
            ht.concatenate([a, other])


@pytest.mark.parametrize("p", [3, 5])
@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("shape,axis", [((0, 4), 1), ((0, 4), 0), ((3, 0), 0)])
def test_unique_of_an_empty_array_along_an_axis(shape, axis, split, p):
    values = np.zeros(shape, np.float32)
    mine = ht.unique(ht.array(values, split=split, comm=_mesh(p)), axis=axis)
    assert mine.gshape == np.unique(values, axis=axis).shape


@pytest.mark.parametrize("p", [3, 5])
def test_pad_and_split_refuse_a_float_as_numpy_does(p):
    values = data((4, 3), "float32")
    x = ht.array(values, split=0, comm=_mesh(p))
    with pytest.raises(TypeError):
        np.pad(values, 1.5)
    with pytest.raises(TypeError):
        ht.pad(x, 1.5)
    with pytest.raises(ValueError):
        np.split(values, 1.5)
    with pytest.raises(ValueError):
        ht.split(x, 1.5)
    # a float that divides the axis is a number of sections, as in numpy
    assert [s.gshape for s in ht.split(x, 2.0)] == [s.shape for s in np.split(values, 2.0)]


# ---------------------------------------------------------------------------
# fault C16 of ROADMAP queue C: numpy's error types for a negative repeat
# count and for split indices that are not one-dimensional, on explicit
# meshes of 3 and 5 shards
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("p", [3, 5])
@pytest.mark.parametrize("split", [None, 0])
def test_repeat_of_a_negative_count_raises_value_error(split, p):
    x = ht.array(np.array([1, 2, 3], np.int64), split=split, comm=_mesh(p))
    for repeats in ([1, -1, 2], np.array([1, -1, 2]), ht.array(np.array([1, -1, 2]), comm=_mesh(p)), -1):
        with pytest.raises(ValueError):
            np.repeat(np.array([1, 2, 3]), np.asarray(repeats.numpy() if isinstance(repeats, ht.DNDarray) else repeats))
        with pytest.raises(ValueError):
            ht.repeat(x, repeats)
    np.testing.assert_array_equal(ht.repeat(x, [1, 0, 2]).numpy(), np.repeat([1, 2, 3], [1, 0, 2]))


@pytest.mark.parametrize("p", [3, 5])
def test_split_of_two_dimensional_indices_raises_type_error(p):
    x = ht.arange(6, split=0, comm=_mesh(p))
    m = ht.zeros((6, 4), split=0, comm=_mesh(p))
    for fn, arr, np_fn, np_arr in ((ht.split, x, np.split, np.arange(6)), (ht.hsplit, x, np.hsplit, np.arange(6)), (ht.vsplit, m, np.vsplit, np.zeros((6, 4)))):
        with pytest.raises(TypeError):
            np_fn(np_arr, np.array([[1, 2]]))
        with pytest.raises(TypeError):
            fn(arr, np.array([[1, 2]]))
        with pytest.raises(TypeError):
            ref.split(ref.arange(6), np.array([[1, 2]]))
    parts = ht.split(x, np.array([1, 2]))
    assert [q.numpy().tolist() for q in parts] == [q.tolist() for q in np.split(np.arange(6), [1, 2])]
