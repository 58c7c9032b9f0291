"""heat_tpu_torch's indexing against heat_tpu and numpy on the CPU mesh:
``__getitem__``/``__setitem__`` (basic, negative-step, integer-array,
boolean and mixed keys, the split of each result), ``fill_diagonal``,
``lloc``, iteration, and the out-of-range case where the port follows
numpy's ``IndexError`` and the reference clamps. Cases from
test_indexing_advanced.py, test_setitem_getitem_ref.py and test_ragged.py.
Every result is exact: indexing moves values and computes nothing."""

import numpy as np
import pytest
import torch

import heat_tpu as ref
import heat_tpu_torch as ht
from test_torch_parity import EXACT, both, check, data, on_cpu  # noqa: F401

SPLITS = [None, 0, 1]
SHAPE = (13, 7)  # ragged over 3, 5 and 8 shards
SHAPE_3D = (5, 6, 4)


def _key(key, values):
    """The key as numpy takes it: array parts of the port as numpy."""
    if isinstance(key, tuple):
        return tuple(_key(k, values) for k in key)
    if isinstance(key, list):
        return np.asarray(key, dtype=np.int64 if not key else None)
    return key


BASIC = [
    np.s_[3], np.s_[-1], np.s_[2:9], np.s_[::3, 2:6], np.s_[-5:], np.s_[::-1], np.s_[::-3],
    np.s_[10:2:-2], np.s_[:, ::-2], np.s_[..., 4], np.s_[None, 1:4], np.s_[:, None, 2],
    np.s_[4, 2], np.s_[1:1], np.s_[::-1, ::-1], np.s_[12:0:-5, -1:2:-3], np.s_[:, 1:6],
]
ADVANCED = [
    [0, 5, 12], [[1, 2], [3, 4]], np.s_[:, [1, 3]], np.s_[[3, 5, 7], 2], np.s_[3, [0, 2]],
    np.s_[[1, 2], [0, 1]], np.s_[None, [1, 2, 3, 4]], np.s_[..., [0, 1]], [], np.s_[[-1, -13], ::-2],
    np.s_[[2, 2, 0]], np.s_[:, [6, -7]],
]


@pytest.mark.parametrize("key", BASIC + ADVANCED, ids=str)
@pytest.mark.parametrize("split", SPLITS)
def test_getitem(split, key):
    values = data(SHAPE, "float32")
    theirs, mine = both(values, split)
    expected = values[_key(key, values)]
    if not expected.size and split == 1:
        # the reference cannot place an empty result split along its
        # columns (jax's sharding check fails): numpy alone
        got = mine[key]
        assert got.gshape == expected.shape and got.split == mine._result_split(key)
        return
    k_ref = tuple(np.asarray(k) if isinstance(k, list) else k for k in key) if isinstance(key, tuple) else key
    check(mine[key], theirs[k_ref if isinstance(key, tuple) else key], expected, **EXACT)


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("dtype", ["bool", "int32", "int64", "float64"])
def test_getitem_of_every_type(dtype, split):
    values = data(SHAPE, dtype)
    theirs, mine = both(values, split)
    for key in (np.s_[2:11:4], np.s_[::-2, 3], np.array([4, 0, 9])):
        check(mine[key], theirs[key], values[key], **EXACT)


@pytest.mark.parametrize("split", SPLITS)
def test_boolean_masks(split):
    values = data(SHAPE, "float32")
    theirs, mine = both(values, split)
    check(mine[mine > 1.0], theirs[theirs > 1.0], values[values > 1.0], **EXACT)
    rows = values[:, 0] > 0
    check(mine[rows], theirs[rows], values[rows], **EXACT)
    check(mine[ht.array(rows)], theirs[ref.array(rows)], values[rows], **EXACT)
    cols = np.arange(SHAPE[1]) % 2 == 0
    check(mine[:, cols], theirs[:, cols], values[:, cols], **EXACT)
    check(mine[rows.tolist()], theirs[rows], values[rows], **EXACT)


@pytest.mark.parametrize("key", [np.s_[0], np.s_[:, 2], np.s_[:, :, 0], np.s_[1:4, ::-2], [1, 4], np.s_[:, [0, 5]],
                                 np.s_[np.array([True, False, True, True, False]), 2:5], np.s_[..., ::-1]], ids=str)
@pytest.mark.parametrize("split", [None, 0, 1, 2])
def test_getitem_3d_split_bookkeeping(split, key):
    values = data(SHAPE_3D, "int64")
    theirs, mine = both(values, split)
    k_ref = np.asarray(key) if isinstance(key, list) else key
    check(mine[key], theirs[k_ref], values[k_ref], **EXACT)


@pytest.mark.parametrize("split", SPLITS)
def test_dndarray_and_zero_d_keys(split):
    values = data(SHAPE, "float64")
    theirs, mine = both(values, split)
    idx = np.array([0, 5, 12, 3])
    for isplit in (None, 0):
        check(mine[ht.array(idx, split=isplit)], theirs[ref.array(idx, split=isplit)], values[idx], **EXACT)
    check(mine[10, np.array(2)], theirs[10, np.array(2)], values[10, 2], **EXACT)
    check(mine[ht.array(4)], theirs[ref.array(4)], values[4], **EXACT)
    check(mine[np.int64(3), np.int32(1)], theirs[np.int64(3), np.int32(1)], values[3, 1], **EXACT)


@pytest.mark.parametrize("split", SPLITS)
def test_multiple_advanced_keys_give_split_none(split):
    values = data(SHAPE, "float32")
    theirs, mine = both(values, split)
    got = mine[np.array([1, 2, 12]), np.array([0, 1, 6])]
    assert got.split is None
    check(got, theirs[np.array([1, 2, 12]), np.array([0, 1, 6])], values[[1, 2, 12], [0, 1, 6]], **EXACT)


@pytest.mark.parametrize("split", SPLITS)
def test_negative_steps_follow_numpy(split):
    x = np.arange(13, dtype=np.float32)
    theirs, mine = both(x, None if split == 1 else split)
    np.testing.assert_array_equal(mine[::-3].numpy(), [12, 9, 6, 3, 0])
    check(mine[::-3], theirs[::-3], x[::-3], **EXACT)
    for key in (np.s_[10:2:-2], np.s_[-2::-4], np.s_[3:8:-1], np.s_[:-14:-1]):
        check(mine[key], theirs[key], x[key], **EXACT)


@pytest.mark.parametrize("split", SPLITS)
def test_a_result_never_aliases_its_source(split):
    values = data(SHAPE, "float32")
    mine = ht.array(values, split=split)
    for key in (np.s_[1:4], np.s_[:, 2], np.s_[3], np.s_[::2], np.s_[...]):
        y = mine[key]
        y[0] = 7.0
        np.testing.assert_array_equal(mine.numpy(), values)
    z = mine[1:4]
    mine[1:4] = -1.0  # and a write to the source leaves an earlier result alone
    np.testing.assert_array_equal(z.numpy(), values[1:4])
    w = ht.expand_dims(mine, 0)  # a view inside the package: the write copies first
    w[0, 0] = 5.0
    assert mine.numpy()[0, 0] == values[0, 0]


@pytest.mark.parametrize("split", SPLITS)
def test_out_of_range_raises_where_the_reference_clamps(split):
    """numpy raises IndexError; heat_tpu clamps the index (x[20] of 13 rows
    gives row 12) and drops the write. The port sides with numpy."""
    values = np.arange(13, dtype=np.float32)
    theirs, mine = both(values, None if split == 1 else split)
    np.testing.assert_array_equal(theirs[20].numpy(), 12.0)
    np.testing.assert_array_equal(theirs[ref.array([0, 20])].numpy(), [0.0, 12.0])
    clamped = ref.array(values, split=theirs.split)
    clamped[ref.array([0, 20])] = -1.0
    expected = values.copy()
    expected[0] = -1.0
    np.testing.assert_array_equal(clamped.numpy(), expected)
    for key in (20, -14, [0, 20], np.array([-14, 1]), ht.array([0, 20]), np.s_[3, 1]):
        with pytest.raises(IndexError):
            mine[key]
        with pytest.raises(IndexError):
            mine[key] = -1.0
        with pytest.raises(IndexError):
            values[key.numpy() if isinstance(key, ht.DNDarray) else _key(key, values)]
    np.testing.assert_array_equal(mine.numpy(), values)


SET_CASES = [
    (np.s_[2:9], 5.5),
    (np.s_[::-2], -1),
    (np.s_[[0, 5, 12]], "row"),
    (np.s_[:, 1], 3),
    (np.s_[1:4, 1], 2.0),
    (np.s_[10, np.array(0)], 1),
    (np.s_[-1], 1),
    (np.s_[:, [6, 0]], 9.25),
    (np.s_[1:-1, 1:-1], "block"),
    (np.s_[[1, 3, 5], ::-3], "block"),
    (np.s_[...], 0.5),
    (np.s_[3:8:-1], 4.0),
]


@pytest.mark.parametrize("key,value", SET_CASES, ids=str)
@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_setitem(dtype, split, key, value):
    values = data(SHAPE, dtype)
    expected = values.copy()
    target_shape = expected[key].shape
    if value == "row":
        value = data(target_shape[1:], "float64", seed=1)
    elif value == "block":
        value = data(target_shape, "float64", seed=2)
    expected[key] = value  # cast to the destination type
    theirs, mine = both(values, split)
    mine[key] = value
    theirs[key] = value
    check(mine, theirs, expected, **EXACT)


@pytest.mark.parametrize("split", SPLITS)
def test_setitem_with_masks_and_arrays(split):
    values = data(SHAPE, "float64")
    expected = values.copy()
    theirs, mine = both(values, split)
    expected[expected > 1.0] = 0.0
    mine[mine > 1.0] = 0.0
    theirs[theirs > 1.0] = 0.0
    check(mine, theirs, expected, **EXACT)
    block = data((4, 7), "float32", seed=3)
    expected[[1, 3, 5, 7]] = block
    for vsplit in (None, 0):
        mine[np.array([1, 3, 5, 7])] = ht.array(block, split=vsplit)
        theirs[np.array([1, 3, 5, 7])] = ref.array(block, split=vsplit)
        check(mine, theirs, expected, **EXACT)
    rows = np.arange(13) % 4 == 1
    expected[rows, 2] = -2
    mine[rows, 2] = -2
    check(mine, theirs.__setitem__((rows, 2), -2) or theirs, expected, **EXACT)
    other = ht.zeros(SHAPE, split=1, dtype=ht.float64)  # the value split otherwise
    mine[:, :] = other
    np.testing.assert_array_equal(mine.numpy(), np.zeros(SHAPE))
    assert mine.split == split


@pytest.mark.parametrize("split", SPLITS)
def test_setitem_from_itself(split):
    values = data(SHAPE, "float32")
    expected = values.copy()
    expected[1:] = values[:-1].copy()
    theirs, mine = both(values, split)
    mine[1:] = mine[:-1]
    theirs[1:] = theirs[:-1]
    check(mine, theirs, expected, **EXACT)


@pytest.mark.parametrize("shape", [(6, 6), (7, 4), (4, 9)], ids=str)
@pytest.mark.parametrize("split", SPLITS)
def test_fill_diagonal(split, shape):
    values = data(shape, "float32")
    expected = values.copy()
    np.fill_diagonal(expected, 9.0)
    theirs, mine = both(values, split)
    assert mine.fill_diagonal(9.0) is mine
    check(mine, theirs.fill_diagonal(9.0), expected, **EXACT)


@pytest.mark.parametrize("split", SPLITS)
def test_lloc_and_iteration(split):
    values = data(SHAPE, "int32")
    theirs, mine = both(values, split)
    check(mine.lloc[2:5], theirs.lloc[2:5], values[2:5], **EXACT)
    mine.lloc[0] = 1
    theirs.lloc[0] = 1
    expected = values.copy()
    expected[0] = 1
    check(mine, theirs, expected, **EXACT)
    rows = list(mine)
    assert len(rows) == SHAPE[0]
    for got, want, row in zip(rows, theirs, expected):
        check(got, want, row, **EXACT)


def test_key_helpers_match_the_reference():
    values = data(SHAPE, "float32")
    theirs, mine = both(values, 0)
    assert isinstance(ht.DNDarray._unwrap_key([], torch.device("cpu")), torch.Tensor)
    assert ht.DNDarray._unwrap_key([], torch.device("cpu")).dtype == torch.int64
    for key in (np.s_[..., 2], np.s_[None, [1, 2]], np.s_[np.ones(13, bool)], np.s_[1:3, None, ...], np.s_[:, 3]):
        assert mine._result_split(key) == theirs._result_split(key), key
    with pytest.raises(IndexError):
        mine[np.array([1.0, 2.0])]
