"""heat_tpu_torch's sorting family against heat_tpu and numpy on the CPU
mesh: ``sort`` (the merge-exchange network along the split axis, shard by
shard along another axis), ``topk`` (its one-allreduce merge path and the
sort path), ``mpi_topk`` and ``unique`` (its distributed path and the dense
one). Cases from test_sort_distributed.py and test_ragged.py.

Tolerance: exact everywhere. Sorting moves values: the values, the int64
indices of the stable order, topk's values and indices and the unique
values equal the reference's and numpy's stable argsort bit for bit, NaN
where NaN is."""

import numpy as np
import pytest
import torch

import heat_tpu as ref
import heat_tpu_torch as ht
from test_torch_parity import EXACT, P, both, check, data, on_cpu  # noqa: F401

SPLITS = [None, 0, 1]


def _stable(values: np.ndarray, axis: int, descending: bool):
    """numpy's stable order: descending as the reference's, ties in order."""
    if descending:
        flipped = np.flip(values, axis)
        order = np.flip(np.argsort(flipped, axis=axis, kind="stable"), axis)
        order = values.shape[axis] - 1 - order
    else:
        order = np.argsort(values, axis=axis, kind="stable")
    return np.take_along_axis(values, order, axis), order


def _with_ties_and_nans(n: int, dtype: str, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    values = rng.integers(-4, 5, n).astype(dtype)
    if dtype.startswith("float") and n > 4:
        values[rng.choice(n, 3, replace=False)] = np.nan
        values[rng.choice(n, 1)] = -np.inf
    return values


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "float64", "int32", "int64"])
@pytest.mark.parametrize("n", [1, 2, 7, 13, 16, 41])
def test_sort_along_the_split_axis(n, dtype, descending):
    values = _with_ties_and_nans(n, dtype, seed=n)
    theirs, mine = both(values, 0)
    ev, ei = _stable(values, 0, descending)
    check(ht.sort(mine, descending=descending), ref.sort(theirs, descending=descending), (ev, ei), **EXACT)


@pytest.mark.parametrize("descending", [False, True])
def test_sort_bool_and_all_equal(descending):
    b = np.random.default_rng(1).random(23) < 0.5
    theirs, mine = both(b, 0)
    check(ht.sort(mine, descending=descending), ref.sort(theirs, descending=descending), _stable(b, 0, descending), **EXACT)
    same = ht.sort(ht.full((11,), 4.0, split=0))
    np.testing.assert_array_equal(same[0].numpy(), np.full(11, 4.0))
    np.testing.assert_array_equal(same[1].numpy(), np.arange(11))


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("axis", [0, 1, -1])
@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("shape", [(13, 7), (16, 5), (3, 19)], ids=str)
def test_sort_2d(shape, split, axis, descending):
    values = _with_ties_and_nans(int(np.prod(shape)), "float32", seed=2).reshape(shape)
    theirs, mine = both(values, split)
    ev, ei = _stable(values, axis, descending)
    check(
        ht.sort(mine, axis=axis, descending=descending), ref.sort(theirs, axis=axis, descending=descending),
        (ev, ei), **EXACT,
    )


@pytest.mark.parametrize("descending", [False, True])
def test_nan_and_the_pad_sentinels_in_a_ragged_split_sort(descending):
    """Ascending pads are NaN and must sort after real NaNs; descending they
    are -inf and must sort after a real -inf; none leaks into the result."""
    values = np.array([3.0, np.nan, 1.0, -np.inf, np.nan, 2.0, -np.inf, 7.0, np.nan, 0.0, 5.0], np.float32)
    theirs, mine = both(values, 0)
    # NaN into every padding slot as well: the sentinel must overwrite it
    for s, c in zip(mine.shards, mine.counts_displs()[0]):
        s[c:] = np.nan
    v, i = ht.sort(mine, descending=descending)
    ev, ei = _stable(values, 0, descending)
    check((v, i), ref.sort(theirs, descending=descending), (ev, ei), **EXACT)
    assert (i.numpy() < values.size).all()
    for s, c in zip(i.shards, i.counts_displs()[0]):  # the pad indices stay in the padding
        assert (s[c:] >= values.size).all()


def test_stable_ties_ascending_and_descending():
    values = np.array([2, 1, 2, 1, 2, 1, 3, 3, 0, 2, 1, 3, 0], np.int32)
    theirs, mine = both(values, 0)
    for descending in (False, True):
        _, i = ht.sort(mine, descending=descending)
        np.testing.assert_array_equal(i.numpy(), _stable(values, 0, descending)[1])
        tv, ti = torch.sort(torch.from_numpy(values), descending=descending, stable=True)
        np.testing.assert_array_equal(i.numpy(), ti.numpy())


def test_merge_exchange_rounds_use_ppermute_only(monkeypatch):
    """p rounds, each one ppermute of the values and one of the indices;
    no allgather and no whole-array assembly on the split axis."""
    values = _with_ties_and_nans(101, "float32", seed=5)
    mine = ht.array(values, split=0)
    comm = mine.comm
    calls = []
    for verb in ("ppermute", "allgather", "allreduce", "alltoall", "bcast"):
        original = getattr(type(comm), verb)
        monkeypatch.setattr(comm, verb, lambda *a, _v=verb, _o=original, **k: calls.append(_v) or _o(comm, *a, **k))
    if P > 1:
        monkeypatch.setattr(type(mine), "larray", property(lambda self: pytest.fail("the sort assembled the array")))
    v, i = ht.sort(mine)
    monkeypatch.undo()
    expected = ["ppermute"] * (2 * P) if P > 1 else []
    assert calls == expected
    np.testing.assert_array_equal(v.numpy(), _stable(values, 0, False)[0])


def test_sort_out_and_complex():
    values = data((13,), "float64")
    theirs, mine = both(values, 0)
    out = ht.zeros(13, dtype=ht.float64, split=0)
    got, idx = ht.sort(mine, out=out)
    assert got is out
    np.testing.assert_array_equal(out.numpy(), np.sort(values))
    z = np.array([3 + 1j, 1 + 2j, 1 + 1j, 2 + 0j, 1 + 1j], np.complex64)
    np.testing.assert_array_equal(ht.sort(ht.array(z))[0].numpy(), np.sort_complex(z))


@pytest.mark.parametrize("largest", [True, False])
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("n", [24, 40, 13])
def test_topk_along_the_split_axis(n, k, largest):
    values = _with_ties_and_nans(n, "float32", seed=k).astype(np.float32)
    values[np.isnan(values)] = 9.0
    theirs, mine = both(values, 0)
    ev, ei = _stable(values, 0, largest)
    check(ht.topk(mine, k, largest=largest), ref.topk(theirs, k, largest=largest), (ev[:k], ei[:k]), **EXACT)


def test_topk_merge_path_is_one_allreduce(monkeypatch):
    values = np.arange(8 * P, dtype=np.float32)[::-1].copy()
    mine = ht.array(values, split=0)
    comm = mine.comm
    calls = []
    for verb in ("ppermute", "allgather", "allreduce"):
        original = getattr(type(comm), verb)
        monkeypatch.setattr(comm, verb, lambda *a, _v=verb, _o=original, **k: calls.append(_v) or _o(comm, *a, **k))
    v, i = ht.topk(mine, 3)
    monkeypatch.undo()
    assert calls == (["allreduce"] if P > 1 else [])
    np.testing.assert_array_equal(v.numpy(), values[:3])
    np.testing.assert_array_equal(i.numpy(), [0, 1, 2])


@pytest.mark.parametrize("dim", [0, 1])
@pytest.mark.parametrize("split", SPLITS)
def test_topk_2d(split, dim):
    values = data((16, 9), "float64")
    theirs, mine = both(values, split)
    ev, ei = _stable(values, dim, True)
    check(ht.topk(mine, 2, dim=dim), ref.topk(theirs, 2, dim=dim), (np.take(ev, [0, 1], dim), np.take(ei, [0, 1], dim)), **EXACT)
    with pytest.raises(ValueError):
        ht.topk(mine, 100, dim=dim)


def test_mpi_topk_merges_two_partials():
    a = (torch.tensor([[5.0, 3.0]]), torch.tensor([[0, 4]]))
    b = (torch.tensor([[5.0, 4.0]]), torch.tensor([[7, 9]]))
    mv, mi = ht.mpi_topk(a, b, 3)
    rv, ri = ref.mpi_topk(tuple(np.asarray(t) for t in a), tuple(np.asarray(t) for t in b), 3)
    np.testing.assert_array_equal(mv.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(mi.numpy(), np.asarray(ri))


@pytest.mark.parametrize("dtype", ["float32", "int32", "int64", "bool"])
@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("shape", [(41,), (13, 7)], ids=str)
def test_unique(shape, split, dtype):
    if split == 1 and len(shape) == 1:
        split = 0
    values = _with_ties_and_nans(int(np.prod(shape)), "float32" if dtype == "bool" else dtype, seed=3).reshape(shape)
    values = values > 0 if dtype == "bool" else values
    theirs, mine = both(values, split)
    check(ht.unique(mine), ref.unique(theirs), np.unique(values), **EXACT)


def test_unique_collapses_nan():
    """torch.unique keeps each NaN; numpy and the reference give one."""
    values = np.array([1.0, np.nan, 2.0, np.nan, 1.0, np.nan, 2.0], np.float32)
    assert torch.unique(torch.from_numpy(values)).numel() == 5
    for split in (None, 0):
        theirs, mine = both(values, split)
        got = ht.unique(mine)
        check(got, ref.unique(theirs), np.unique(values), **EXACT)
        assert got.gshape == (3,)


@pytest.mark.parametrize("split", [None, 0])
def test_unique_inverse_axis_and_degenerate(split):
    values = _with_ties_and_nans(13, "int32", seed=4)
    theirs, mine = both(values, split)
    u, inv = ht.unique(mine, return_inverse=True)
    ru, rinv = ref.unique(theirs, return_inverse=True)
    check((u, inv), (ru, rinv), np.unique(values, return_inverse=True), **EXACT)
    m = np.array([[1, 2], [3, 4], [1, 2], [0, 0], [3, 4]], np.int64)
    theirs, mine = both(m, split)
    check(ht.unique(mine, axis=0), ref.unique(theirs, axis=0), np.unique(m, axis=0), **EXACT)
    for values in (np.full(13, 2.0, np.float32), np.arange(13, dtype=np.float32)[::-1].copy(), np.empty(0, np.float32)):
        got = ht.unique(ht.array(values, split=split))
        np.testing.assert_array_equal(got.numpy(), np.unique(values))
