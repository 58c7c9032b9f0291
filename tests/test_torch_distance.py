"""heat_tpu_torch.spatial (cdist, manhattan, rbf and the distance engine
with its two ring schedules) against heat_tpu.spatial at the test mesh
size (HEAT_TPU_TEST_DEVICES, default 8), and against scipy at meshes 2-5,
on the CPU.

On the CPU the exact metrics run kernel B2's plain version; the kernel is
held against it on the card by chip_smoke.py. Inputs are made with numpy
from a seed. Tolerances:

* exact metrics (difference first): rtol = atol = 1e-5 in float32 and
  1e-12 in float64, the same differences summed over f in another order;
* quadratic expansion: rtol 1e-4 and atol 1e-2 in float32 (1e-9 in
  float64), both packages compute |x|² + |y|² − 2x·yᵀ with the product
  summed in another order, and it cancels near d = 0, where the sqrt
  magnifies the difference; in float64 the symmetric case holds d² to
  numpy's evaluation of the same formula and to heat_tpu's d² at that
  bound, and d itself off the diagonal, since the square root of a sum
  cancelled to ~u|x|² is ~1e-8 in any summation order;
* the ring against one shard: bit for bit, each element is the same sum
  over the same features whatever the tile, and a mirrored tile is an
  exact transpose since (a − b)² = (b − a)².
"""

import numpy as np
import pytest
import torch
from scipy.spatial.distance import cdist as scipy_cdist

import heat_tpu as ref
import heat_tpu_torch as ht
from heat_tpu.spatial.distance import _sym_schedule as ref_sym_schedule
from heat_tpu_torch.core.communication import MeshCommunication
from heat_tpu_torch.ops import pairwise
from heat_tpu_torch.spatial import distance

EXACT = {np.float32: dict(rtol=1e-5, atol=1e-5), np.float64: dict(rtol=1e-12, atol=1e-12)}
QUAD = {np.float32: dict(rtol=1e-4, atol=1e-2), np.float64: dict(rtol=1e-9, atol=1e-9)}
SIGMA = 2.0


@pytest.fixture(autouse=True)
def _on_cpu():
    ht.use_device("cpu")
    yield
    ht.use_comm(None)
    ht.use_device(None)


def _data(n, f=4, seed=0, dtype=np.float32):
    return np.random.default_rng(seed).random((n, f)).astype(dtype)


def _cpu_mesh(p):
    return MeshCommunication(["cpu"] * p)


def _both(fn, a, b, sa, sb, **kwargs):
    """``fn`` of the port and of heat_tpu on the same data and splits; b None
    is the symmetric case."""
    X = ht.array(a, split=sa)
    mine = getattr(ht.spatial, fn)(X, None if b is None else ht.array(b, split=sb), **kwargs)
    RX = ref.array(a, split=sa)
    theirs = getattr(ref.spatial, fn)(RX, None if b is None else ref.array(b, split=sb), **kwargs)
    return mine, theirs


# ---------------------------------------------------------------------------
# against heat_tpu at the test mesh
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("quad", [False, True])
@pytest.mark.parametrize("sa,sb", [(None, None), (None, 0), (0, None), (0, 0)])
def test_cdist_splits_match_reference(sa, sb, quad):
    # tests/test_ml.py::test_cdist_oracle's operands
    a, b = _data(16, seed=0), _data(24, seed=1)
    mine, theirs = _both("cdist", a, b, sa, sb, quadratic_expansion=quad)
    assert mine.shape == theirs.shape == (16, 24)
    assert mine.split == theirs.split == (0 if sa == 0 else None)
    np.testing.assert_allclose(mine.numpy(), theirs.numpy(), **(QUAD if quad else EXACT)[np.float32])
    np.testing.assert_allclose(mine.numpy(), scipy_cdist(a, b), rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("quad", [False, True])
@pytest.mark.parametrize("n", [16, 13, 5])
def test_cdist_symmetric_ring_matches_reference(n, quad, dtype):
    # n = 13 and 5 are ragged at mesh 8: zero rows pad the ring's operands
    a = _data(n, f=3, seed=n, dtype=dtype)
    mine, theirs = _both("cdist", a, None, 0, None, quadratic_expansion=quad)
    assert mine.split == theirs.split == 0 and mine.shape == (n, n)
    assert mine.dtype.__name__ == theirs.dtype.__name__ == np.dtype(dtype).name
    if quad and dtype == np.float64:
        # sqrt(s) of a cancelled sum s ~ u|x|² near d = 0 is ~1e-8 whatever
        # the summation order, so the diagonal is held before the square
        # root: d² against numpy's max(|x|² + |y|² - 2x·y, 0) on the same
        # input and against heat_tpu's d², and d itself off the diagonal
        sq = (a * a).sum(1)
        formula = np.maximum(sq[:, None] + sq[None, :] - 2 * a @ a.T, 0)
        off = ~np.eye(n, dtype=bool)
        np.testing.assert_allclose(mine.numpy() ** 2, formula, **QUAD[dtype])
        np.testing.assert_allclose(mine.numpy() ** 2, theirs.numpy() ** 2, **QUAD[dtype])
        np.testing.assert_allclose(mine.numpy()[off], np.sqrt(formula)[off], **QUAD[dtype])
        np.testing.assert_allclose(mine.numpy()[off], theirs.numpy()[off], **QUAD[dtype])
    else:
        np.testing.assert_allclose(mine.numpy(), theirs.numpy(), **(QUAD if quad else EXACT)[dtype])
    if not quad:
        np.testing.assert_array_equal(np.diag(mine.numpy()), 0.0)
        np.testing.assert_array_equal(mine.numpy(), mine.numpy().T)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n,m", [(16, 8), (13, 21), (3, 10)])
def test_general_ring_matches_reference(n, m, dtype):
    a, b = _data(n, f=3, seed=n, dtype=dtype), _data(m, f=3, seed=m + 100, dtype=dtype)
    for fn, kwargs in [("cdist", {}), ("manhattan", {}), ("rbf", {"sigma": SIGMA})]:
        mine, theirs = _both(fn, a, b, 0, 0, **kwargs)
        assert mine.shape == theirs.shape == (n, m) and mine.split == 0
        np.testing.assert_allclose(mine.numpy(), theirs.numpy(), **EXACT[dtype])


@pytest.mark.parametrize("quad", [False, True])
@pytest.mark.parametrize("split", [None, 0])
def test_rbf_and_manhattan_match_reference(split, quad):
    # tests/test_ml.py::test_rbf_manhattan, at a ragged size
    a = _data(11, f=3, seed=2)
    mine, theirs = _both("rbf", a, None, split, None, sigma=SIGMA, quadratic_expansion=quad)
    np.testing.assert_allclose(mine.numpy(), theirs.numpy(), **(QUAD if quad else EXACT)[np.float32])
    expected = np.exp(-scipy_cdist(a, a) ** 2 / (2 * SIGMA**2))
    np.testing.assert_allclose(mine.numpy(), expected, rtol=1e-3, atol=1e-4)
    mine, theirs = _both("manhattan", a, None, split, None)
    np.testing.assert_allclose(mine.numpy(), theirs.numpy(), **EXACT[np.float32])
    np.testing.assert_allclose(mine.numpy(), scipy_cdist(a, a, metric="cityblock"), rtol=1e-5, atol=1e-5)


def test_integer_input_promotes_like_reference():
    a = np.arange(30, dtype=np.int32).reshape(10, 3)
    mine, theirs = _both("cdist", a, None, 0, None)
    assert mine.dtype is ht.float32 and theirs.dtype.__name__ == "float32"
    np.testing.assert_allclose(mine.numpy(), theirs.numpy(), **EXACT[np.float32])


def test_input_checks_match_reference():
    with pytest.raises(NotImplementedError):
        ht.spatial.cdist(ht.arange(4))
    with pytest.raises(NotImplementedError):
        ht.spatial.cdist(ht.ones((4, 2)), ht.ones((4,)))
    with pytest.raises(ValueError):
        ht.spatial.cdist(ht.ones((4, 2)), ht.ones((4, 3)))
    with pytest.raises(TypeError):
        ht.spatial.manhattan(np.ones((4, 2)))


# ---------------------------------------------------------------------------
# the ring schedules at other mesh sizes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("p", [2, 3, 4, 5])
def test_rings_match_scipy_at_mesh_size(p):
    comm = _cpu_mesh(p)
    a, b = _data(23, f=5, seed=p), _data(11, f=5, seed=p + 50)
    X, Y = ht.array(a, split=0, comm=comm), ht.array(b, split=0, comm=comm)
    assert X.comm.size == p
    for fn, args, metric in [
        ("cdist", {}, "euclidean"),
        ("manhattan", {}, "cityblock"),
    ]:
        np.testing.assert_allclose(getattr(ht.spatial, fn)(X, **args).numpy(), scipy_cdist(a, a, metric), **EXACT[np.float32])
        np.testing.assert_allclose(getattr(ht.spatial, fn)(X, Y, **args).numpy(), scipy_cdist(a, b, metric), **EXACT[np.float32])
    np.testing.assert_allclose(
        ht.spatial.cdist(X, Y, quadratic_expansion=True).numpy(), scipy_cdist(a, b), **QUAD[np.float32]
    )
    expected = np.exp(-scipy_cdist(a, a) ** 2 / (2 * SIGMA**2))
    for quad in (False, True):
        got = ht.spatial.rbf(X, sigma=SIGMA, quadratic_expansion=quad).numpy()
        np.testing.assert_allclose(got, expected, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("p", [2, 3, 4, 5, 8])
def test_symmetric_ring_tile_count_and_bits(p, dtype):
    # p·(1 + h + [p even]) tiles: ⌈p/2⌉ rotations, not p − 1
    calls = []

    def counted(x, y, out=None):
        calls.append((x.shape[0], y.shape[0]))
        return distance._euclidian(x, y, out)

    a = _data(4 * p + 3, f=6, seed=p, dtype=dtype)
    ring = distance._dist(ht.array(a, split=0, comm=_cpu_mesh(p)), None, counted)
    paired, self_paired = distance._sym_schedule(p)
    assert len(calls) == p * (1 + len(paired) + int(self_paired))
    one = ht.spatial.cdist(ht.array(a, split=0, comm=_cpu_mesh(1)))
    np.testing.assert_array_equal(ring.numpy(), one.numpy())
    assert [tuple(s.shape) for s in ring.lshards] == [tuple(s.shape) for s in ht.array(ring.numpy(), split=0, comm=_cpu_mesh(p)).lshards]


@pytest.mark.parametrize("p", [2, 3, 4, 5, 8])
def test_general_ring_tile_count_and_bits(p):
    calls = []

    def counted(x, y, out=None):
        calls.append(1)
        return distance._manhattan(x, y, out)

    a, b = _data(3 * p + 1, f=6, seed=p), _data(2 * p + 5, f=6, seed=p + 9)
    mesh = _cpu_mesh(p)
    ring = distance._dist(ht.array(a, split=0, comm=mesh), ht.array(b, split=0, comm=mesh), counted)
    assert len(calls) == p * p
    one = ht.spatial.manhattan(ht.array(a, split=0, comm=_cpu_mesh(1)), ht.array(b, split=0, comm=_cpu_mesh(1)))
    np.testing.assert_array_equal(ring.numpy(), one.numpy())


@pytest.mark.parametrize("p", range(1, 10))
def test_sym_schedule_matches_reference(p):
    assert distance._sym_schedule(p) == ref_sym_schedule(p)


def test_ring_ignores_the_shards_padding_content():
    # fill the padding rows of the operand's shards with NaN: the ring pads
    # the logical rows with zeros itself
    comm = _cpu_mesh(4)
    a = _data(10, f=3, seed=4)
    X = ht.array(a, split=0, comm=comm)
    for s, c in zip(X.shards, X.counts_displs()[0]):
        s[c:] = float("nan")
    got = ht.spatial.cdist(X).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, scipy_cdist(a, a), **EXACT[np.float32])


def test_cpu_path_launches_no_kernel():
    before = pairwise.LAUNCHES
    ht.spatial.cdist(ht.array(_data(17), split=0))
    ht.spatial.rbf(ht.array(_data(17), split=0), ht.array(_data(9), split=0))
    assert pairwise.LAUNCHES == before


def test_quadratic_expansion_in_row_blocks(monkeypatch):
    a, b = _data(19, seed=5, dtype=np.float64), _data(7, seed=6, dtype=np.float64)
    X, Y = ht.array(a), ht.array(b)
    whole = ht.spatial.cdist(X, Y, quadratic_expansion=True).numpy()
    monkeypatch.setattr(distance, "QUADRATIC_ELEMENTS", 8)
    # the product of a block of rows may be summed in another order
    blocks = ht.spatial.cdist(X, Y, quadratic_expansion=True).numpy()
    np.testing.assert_allclose(blocks, whole, rtol=1e-12, atol=1e-12)
    ref_sq = distance._sq_euclidian_fast(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(whole, np.sqrt(ref_sq), rtol=1e-12, atol=1e-12)
