"""heat_tpu_torch's halos and distribution bookkeeping against heat_tpu and
numpy on the CPU mesh: ``get_halo``/``array_with_halos``/``halo_prev``/
``halo_next``, ``ranked_shards``, ``is_balanced``/``balance_``/
``redistribute_``, ``create_lshape_map``, ``stride``/``strides``,
``lnumel``/``lnbytes`` and ``cpu``. Cases from test_halo.py,
test_ragged.py and test_tiling_parity.py. Exact: halos move rows."""

import numpy as np
import pytest
import torch

import heat_tpu as ref
import heat_tpu_torch as ht
from test_torch_parity import P, both, data, on_cpu  # noqa: F401


def _expected_halos(values: np.ndarray, h: int, p: int, split: int) -> np.ndarray:
    """Each shard's [from_prev | shard | from_next] along ``split``, zeros
    past the ends and in the padding, concatenated."""
    n = values.shape[split]
    block = -(-n // p)
    moved = np.moveaxis(values, split, 0)
    padded = np.concatenate([moved, np.zeros((block * p - n,) + moved.shape[1:], moved.dtype)])
    out = []
    for d in range(p):
        window = np.zeros((block + 2 * h,) + moved.shape[1:], moved.dtype)
        for j in range(block + 2 * h):
            g = d * block - h + j
            if h <= j < block + h:
                window[j] = padded[g]
            elif 0 <= g < n:
                window[j] = padded[g]
        out.append(window)
    return np.moveaxis(np.concatenate(out), 0, split)


@pytest.mark.parametrize("h", [1, 2])
@pytest.mark.parametrize("shape,split", [((24,), 0), ((23, 3), 0), ((4, 17), 1), ((26,), 0)], ids=str)
def test_halos_equal_the_neighbours_rows(shape, split, h):
    values = data(shape, "float64")
    theirs, mine = both(values, split)
    mine.get_halo(h)
    theirs.get_halo(h)
    block = -(-shape[split] // P)
    if P == 1 or h > block:
        assert mine.halos is None
        np.testing.assert_array_equal(np.asarray(mine.array_with_halos), values)
        return
    got = mine.array_with_halos.numpy()
    np.testing.assert_array_equal(got, _expected_halos(values, h, P, split))
    if not mine.padded:  # the reference's padding is zeros too only while it is fresh
        np.testing.assert_array_equal(got, np.asarray(theirs.array_with_halos))
    from_prev, from_next = mine.halos
    assert (from_prev[0] == 0).all() and (from_next[-1] == 0).all()  # zeros at the ends


def test_halo_exchange_is_two_ppermutes(monkeypatch):
    values = data((5 * P + 2, 3), "float32")
    mine = ht.array(values, split=0)
    comm = mine.comm
    calls = []
    for verb in ("ppermute", "allgather", "allreduce"):
        original = getattr(type(comm), verb)
        monkeypatch.setattr(comm, verb, lambda *a, _v=verb, _o=original, **k: calls.append(_v) or _o(comm, *a, **k))
    mine.get_halo(2)
    monkeypatch.undo()
    assert calls == (["ppermute"] * 2 if P > 1 else [])


def test_halo_errors_and_properties():
    values = np.arange(16, dtype=np.float32)
    theirs, mine = both(values, 0)
    with pytest.raises(TypeError):
        mine.get_halo(1.5)
    with pytest.raises(ValueError):
        mine.get_halo(-1)
    mine.get_halo(2)
    theirs.get_halo(2)
    if P > 1:
        np.testing.assert_array_equal(mine.halo_prev.numpy(), np.asarray(theirs.halo_prev))
        np.testing.assert_array_equal(mine.halo_next.numpy(), np.asarray(theirs.halo_next))
    else:
        assert mine.halo_prev is None and mine.halo_next is None
    assert mine.create_lshape_map().numpy().tolist() == np.asarray(theirs.create_lshape_map().numpy()).tolist()
    wide = ht.arange(2 * P, split=0)
    wide.get_halo(5)
    assert tuple(wide.array_with_halos.shape) == (2 * P,)


@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("shape", [(13, 7), (2, 3), (16, 8)], ids=str)
def test_distribution_bookkeeping(shape, split):
    values = data(shape, "float32")
    theirs, mine = both(values, split)
    assert mine.is_balanced() and mine.balanced and theirs.is_balanced()
    assert mine.balance_() is mine
    assert mine.stride == theirs.stride and mine.strides == theirs.strides == values.strides
    assert mine.lnumel == theirs.lnumel and mine.lnbytes == theirs.lnbytes
    assert mine.gnbytes == theirs.gnbytes == values.nbytes
    mine_blocks = [(r, b) for r, b in mine.ranked_shards()]
    their_blocks = [(r, np.asarray(b)) for r, b in theirs.ranked_shards()]
    assert [r for r, _ in mine_blocks] == [r for r, _ in their_blocks]
    for (_, a), (_, b) in zip(mine_blocks, their_blocks):
        np.testing.assert_array_equal(a, b)
    identity = mine.lshape_map
    assert mine.redistribute_(target_map=identity) is mine
    if split is not None and P > 1:
        skewed = identity.numpy().copy()
        skewed[0, split] += 1
        skewed[-1, split] -= 1
        with pytest.raises(NotImplementedError):
            mine.redistribute_(target_map=skewed)
        with pytest.raises(NotImplementedError):
            theirs.redistribute_(target_map=skewed)
    assert mine.cpu() is mine
    np.testing.assert_array_equal(ht.redistribute(mine, target_map=identity).numpy(), values)
