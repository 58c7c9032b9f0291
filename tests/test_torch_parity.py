"""The parity harness of the port's operator tests, and its own checks.

One numpy input, made from a seed and cast explicitly, goes through
``heat_tpu`` (its eager engines, the recorder off) and ``heat_tpu_torch``
on the CPU mesh of the tests (``HEAT_TPU_TEST_DEVICES`` shards, 8 by
default). :func:`check` holds the port's result against the reference's
(type, split, shape and values) and its shards against
``counts_displs_shape``; the callers hold both against numpy too.

Tolerances (``tol``):
* exact for integer, bool, comparison and logical results and for
  ``min``/``max``/``argmin``/``argmax``;
* float32 elementwise transcendentals: 1e-6 relative (XLA's and torch's CPU
  implementations are a few ulp apart), with an absolute floor of 1e-6 where
  a result crosses zero;
* float32 reductions: 1e-5 relative (the sums run in other orders);
* float64: 1e-12;
* bfloat16: 2^-6 relative, two ulp of its 8-bit mantissa, since torch may
  round the last bit otherwise than XLA.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import heat_tpu as ref
import heat_tpu_torch as ht

P = ht.communication._cpu_mesh_size()
SEED = 20261016
SHAPES = {"ragged": (13, 7), "even": (16, 8)}
DTYPES = ["bool", "int32", "int64", "float32", "float64"]

EXACT = dict(rtol=0, atol=0)
ELEMENTWISE = {"float32": dict(rtol=1e-6, atol=1e-6), "float64": dict(rtol=1e-12, atol=1e-12), "bfloat16": dict(rtol=2**-6, atol=2**-6)}
REDUCTION = {"float32": dict(rtol=1e-5, atol=1e-6), "float64": dict(rtol=1e-12, atol=1e-12), "bfloat16": dict(rtol=2**-6, atol=2**-6)}


def tol(dtype: str, table=ELEMENTWISE) -> dict:
    """The tolerance of a result of type ``dtype`` (a name), from a table."""
    return table.get(dtype, EXACT)


@pytest.fixture(autouse=True)
def on_cpu():
    """The port on the CPU mesh, the reference with its recorder off."""
    ht.use_device("cpu")
    was = ref.fusion.set_enabled(False)
    yield
    ref.fusion.set_enabled(was)
    ht.use_comm(None)
    ht.use_device(None)


@pytest.fixture
def eager_engines():
    """The port's fusion recorder off as well, for the tests that hold the
    eager engines' accounting (dispatches, syncs, collectives, errstate at
    the op) against the reference's eager engines; the recorder's own
    accounting is held in test_torch_fusion_runtime.py."""
    with ht.core.fusion.disabled():
        yield


def data(shape, dtype: str, low: float = -3.0, high: float = 3.0, seed: int = SEED) -> np.ndarray:
    """Seeded input of a type: bool half true, integers in [low, high),
    floats uniform in [low, high) (bfloat16 inputs are float32 values that
    bfloat16 holds exactly)."""
    rng = np.random.default_rng(seed)
    if dtype == "bool":
        return rng.random(shape) < 0.5
    if dtype.startswith("int"):
        return rng.integers(int(low), int(high), size=shape).astype(dtype)
    values = rng.uniform(low, high, size=shape)
    if dtype == "bfloat16":
        return torch.from_numpy(values).to(torch.bfloat16).float().numpy()
    return values.astype(dtype)


def both(values: np.ndarray, split=None, dtype: str = None):
    """The same array in the reference and in the port."""
    dtype = dtype or values.dtype.name
    return (
        ref.array(values, dtype=getattr(ref, dtype), split=split),
        ht.array(values, dtype=getattr(ht, dtype), split=split),
    )


def as_numpy(x) -> np.ndarray:
    """Values of a DNDarray of either package (bfloat16 as float32)."""
    out = np.asarray(x.numpy())
    return out.astype(np.float32) if out.dtype.name == "bfloat16" else out


def check_layout(x: "ht.DNDarray") -> None:
    """The port's pad+mask layout: one shard per device, ``ceil(n/p)`` rows
    along the split axis, the logical rows where counts_displs_shape puts
    them."""
    assert len(x.shards) == x.comm.size
    if x.split is None:
        for s in x.shards:
            assert tuple(s.shape) == x.gshape
        return
    counts, displs = x.comm.counts_displs_shape(x.gshape, x.split)
    block = -(-x.gshape[x.split] // x.comm.size) if x.gshape[x.split] else 0
    whole = x.larray
    for s, ls, c, d in zip(x.shards, x.lshards, counts, displs):
        expected = list(x.gshape)
        expected[x.split] = block
        assert tuple(s.shape) == tuple(expected)
        assert ls.shape[x.split] == c
        torch.testing.assert_close(ls, whole.narrow(x.split, d, c), rtol=0, atol=0, equal_nan=True)


def check(mine, theirs, expected=None, **tolerance) -> None:
    """The port's result against the reference's: type, split, shape, layout
    and values; and against numpy's ``expected`` values when given."""
    if isinstance(mine, tuple):
        assert isinstance(theirs, tuple) and len(mine) == len(theirs)
        for m, t, e in zip(mine, theirs, expected or (None,) * len(mine)):
            check(m, t, e, **tolerance)
        return
    assert mine.dtype.__name__ == theirs.dtype.__name__, (mine.dtype, theirs.dtype)
    assert mine.split == theirs.split, (mine.split, theirs.split)
    assert mine.gshape == tuple(theirs.shape), (mine.gshape, theirs.shape)
    check_layout(mine)
    got = as_numpy(mine)
    np.testing.assert_allclose(got, as_numpy(theirs), equal_nan=True, **tolerance)
    if expected is not None:
        np.testing.assert_allclose(got, np.asarray(expected, dtype=got.dtype), equal_nan=True, **tolerance)


# ---------------------------------------------------------------------------
# the harness's own checks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", list(SHAPES.values()))
@pytest.mark.parametrize("split", [None, 0, 1])
def test_layout_of_a_new_array_matches_the_reference(shape, split):
    values = data(shape, "float32")
    theirs, mine = both(values, split)
    check(mine, theirs, values, **EXACT)
    assert mine.lshape_map.numpy().tolist() == np.asarray(theirs.lshape_map.numpy()).tolist()


@pytest.mark.parametrize("dtype", DTYPES + ["bfloat16"])
def test_inputs_are_seeded_and_of_their_type(dtype):
    a, b = data((5, 3), dtype), data((5, 3), dtype)
    np.testing.assert_array_equal(a, b)
    theirs, mine = both(a, dtype=dtype)
    assert mine.dtype.__name__ == theirs.dtype.__name__ == dtype
