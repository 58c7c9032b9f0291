"""heat_tpu_torch's type system, communication verbs and eager L3 engines
against heat_tpu and numpy on the CPU mesh: promotion over every pair of
types, result_type with Python scalars, can_cast, finfo/iinfo; bcast,
exscan, scan and allreduce with every op; the engines' split rules
(dominance, explicit resplit, broadcasting against unsplit and length-1
operands), padding that stays in the padding, out= and where=, and the
README quickstart's array lines. Tolerances: see test_torch_parity."""

import itertools

import jax
import numpy as np
import pytest
import torch

import heat_tpu as ref
import heat_tpu_torch as ht
from heat_tpu_torch.core.communication import MeshCommunication
from test_torch_parity import EXACT, P, REDUCTION, SHAPES, both, check, data, on_cpu, tol  # noqa: F401

TYPE_NAMES = [
    "bool", "int8", "int16", "int32", "int64", "uint8", "float16", "bfloat16",
    "float32", "float64", "complex64", "complex128",
]


# ---------------------------------------------------------------------------
# types
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("a,b", list(itertools.product(TYPE_NAMES, TYPE_NAMES)))
def test_promote_types_matches_the_reference(a, b):
    assert ht.promote_types(getattr(ht, a), getattr(ht, b)).__name__ == ref.promote_types(getattr(ref, a), getattr(ref, b)).__name__


@pytest.mark.parametrize("scalar", [True, 1, -7, 1.5, 2j], ids=repr)
@pytest.mark.parametrize("name", TYPE_NAMES)
def test_result_type_with_a_python_scalar(name, scalar):
    assert ht.result_type(getattr(ht, name), scalar).__name__ == ref.result_type(getattr(ref, name), scalar).__name__
    assert ht.result_type(scalar, getattr(ht, name)).__name__ == ref.result_type(scalar, getattr(ref, name)).__name__


@pytest.mark.parametrize("scalars", list(itertools.combinations_with_replacement([True, 1, 1.5, 2j], 2)), ids=str)
def test_result_type_of_scalars_and_arrays(scalars):
    assert ht.result_type(*scalars).__name__ == ref.result_type(*scalars).__name__
    values = np.arange(6, dtype=np.int32).reshape(2, 3)
    theirs, mine = both(values, 0)
    assert ht.result_type(mine, *scalars).__name__ == ref.result_type(theirs, *scalars).__name__
    assert ht.result_type(mine, np.float64(2.0)).__name__ == ref.result_type(theirs, np.float64(2.0)).__name__
    assert ht.result_type(mine, values.astype(np.int64)).__name__ == ref.result_type(theirs, values.astype(np.int64)).__name__


@pytest.mark.parametrize("casting", ["intuitive", "safe", "same_kind", "no", "unsafe"])
@pytest.mark.parametrize("a", TYPE_NAMES)
def test_can_cast_types(a, casting):
    for b in TYPE_NAMES:
        if casting == "same_kind" and "bfloat16" in (a, b):
            continue  # numpy has no bfloat16: the reference's same_kind is ml_dtypes' own table
        assert ht.can_cast(getattr(ht, a), getattr(ht, b), casting) == ref.can_cast(getattr(ref, a), getattr(ref, b), casting), (a, b)


@pytest.mark.parametrize("value", [0, 1, -1, 300, 2**40, 2.5, 3.0, 1e300, float("inf"), 1j, 2 + 0j, True])
def test_can_cast_scalar_values(value):
    for name in TYPE_NAMES:
        if name == "bfloat16":
            continue  # numpy has no bfloat16 for the reference's value rule
        for casting in ("intuitive", "no"):
            assert ht.can_cast(value, getattr(ht, name), casting) == ref.can_cast(value, getattr(ref, name), casting), (value, name, casting)


@pytest.mark.parametrize("name", TYPE_NAMES)
def test_type_predicates_and_limits(name):
    mine, theirs = getattr(ht, name), getattr(ref, name)
    for pred in ("heat_type_is_exact", "heat_type_is_inexact", "heat_type_is_complexfloating"):
        assert getattr(ht, pred)(mine) == getattr(ref, pred)(theirs)
    for abstract in ("integer", "signedinteger", "unsignedinteger", "floating", "complexfloating", "number", "generic"):
        assert ht.issubdtype(mine, getattr(ht, abstract)) == ref.issubdtype(theirs, getattr(ref, abstract))
    assert ht.canonical_heat_type(mine.torch_type()) is mine
    assert ht.canonical_heat_type(name) is mine
    if ht.heat_type_is_inexact(mine):
        for attr in ("bits", "eps", "max", "min", "tiny"):
            assert getattr(ht.finfo(mine), attr) == getattr(ref.finfo(theirs), attr)
    elif name != "bool":
        for attr in ("bits", "max", "min"):
            assert getattr(ht.iinfo(mine), attr) == getattr(ref.iinfo(theirs), attr)


def test_type_aliases():
    for alias, target in [("byte", "int8"), ("short", "int16"), ("ubyte", "uint8"), ("half", "float16"),
                          ("cfloat", "complex64"), ("csingle", "complex64"), ("cdouble", "complex128")]:
        assert getattr(ht, alias) is getattr(ht, target)
        assert getattr(ref, alias).__name__ == target
    assert ht.complex is ht.complexfloating
    with pytest.raises(TypeError):
        ht.finfo(ht.int32)
    with pytest.raises(TypeError):
        ht.iinfo(ht.float32)


# ---------------------------------------------------------------------------
# the communication verbs
# ---------------------------------------------------------------------------
def _ref_verb(verb, x, **kwargs):
    comm = ref.get_comm()
    xs = jax.device_put(jax.numpy.asarray(x), comm.sharding(x.ndim, 0))
    out = comm.apply(lambda s: getattr(comm, verb)(s, **kwargs), xs, in_splits=[0], out_splits=0)
    return np.asarray(out)


def _port_verb(verb, x, p, **kwargs):
    shards = list(torch.from_numpy(x).chunk(p))
    return torch.cat(getattr(MeshCommunication([torch.device("cpu")] * p), verb)(shards, **kwargs)).numpy()


@pytest.mark.parametrize("op", ["sum", "prod", "max", "min"])
@pytest.mark.parametrize("verb", ["exscan", "scan", "allreduce"])
def test_verbs_match_the_reference(verb, op):
    x = data((P * 4, 3), "float64", 0.5, 1.5)
    np.testing.assert_allclose(_port_verb(verb, x, P, op=op), _ref_verb(verb, x, op=op), rtol=1e-12)
    if op in ("max", "min"):
        # a NaN on one shard reaches every shard, numpy's rule (the
        # reference's allreduce, lax.pmax/pmin, drops it: ROADMAP queue C)
        x[P * 4 - 3, 1] = np.nan
        got = _port_verb(verb, x, P, op=op).reshape(P, 4, 3)
        fold = np.maximum if op == "max" else np.minimum
        blocks = x.reshape(P, 4, 3)
        prefix = [blocks[0]]
        for b in blocks[1:]:
            prefix.append(fold(prefix[-1], b))
        expected = {"allreduce": [prefix[-1]] * P, "scan": prefix, "exscan": [None] + prefix[:-1]}[verb]
        for d, e in enumerate(expected):
            if e is not None:
                np.testing.assert_array_equal(got[d], e)


@pytest.mark.parametrize("root", [0, P - 1])
def test_bcast_matches_the_reference(root):
    x = data((P * 2, 3), "int64")
    np.testing.assert_array_equal(_port_verb("bcast", x, P, root=root), _ref_verb("bcast", x, root=root))


@pytest.mark.parametrize("p", [1, 3, 5])
@pytest.mark.parametrize("op", ["land", "lor"])
def test_logical_verbs_and_callable_ops(p, op):
    comm = MeshCommunication([torch.device("cpu")] * p)
    shards = [torch.tensor([i % 2 == 0, True, False]) for i in range(p)]
    fold = np.logical_and if op == "land" else np.logical_or
    expected = shards[0].numpy()
    for s in shards[1:]:
        expected = fold(expected, s.numpy())
    for out in comm.allreduce(shards, op):
        np.testing.assert_array_equal(out.numpy(), expected)
    pairs = [(torch.tensor([float(i)]), torch.tensor([i])) for i in range(p)]
    scanned = comm.exscan(pairs, ht.mpi_argmax, neutral=(torch.tensor([-np.inf]), torch.tensor([0])))
    assert [int(i) for _, i in scanned] == [0] + list(range(p - 1))
    with pytest.raises(ValueError):
        comm.exscan(pairs, ht.mpi_argmax)
    with pytest.raises(ValueError):
        comm.allreduce(shards, "xor")


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("splits", [(0, 1), (1, 0), (0, None), (None, 1)], ids=str)
def test_binary_same_shape_other_split_is_resplit_first(splits):
    """The result takes the first split operand's split; a same-shape
    operand split along another axis is resplit to it (reference
    _operations.py:83-100)."""
    a, b = data((13, 7), "float32"), data((13, 7), "float32", seed=1)
    (ra, ma), (rb, mb) = both(a, splits[0]), both(b, splits[1])
    check(ma + mb, ra + rb, a + b, **EXACT)
    assert (ma + mb).split == next(s for s in splits if s is not None)


@pytest.mark.parametrize("split", [0, 1])
def test_padding_garbage_stays_in_the_padding(split):
    """log of the zero padding is -inf; the logical result and every
    reduction over it ignore it."""
    values = data((13, 7), "float64", 0.5, 2.0)
    theirs, mine = both(values, split)
    logged = ht.log(mine)
    assert logged.padded == bool(values.shape[split] % P)
    assert torch.isinf(torch.cat(logged.shards, split)).any() == logged.padded
    check(logged, ref.log(theirs), np.log(values), **tol("float64"))
    for axis in (None, 0, 1):
        check(ht.sum(logged, axis), ref.sum(ref.log(theirs), axis), np.log(values).sum(axis), **REDUCTION["float64"])
        check(ht.min(logged, axis), ref.min(ref.log(theirs), axis), np.log(values).min(axis), **EXACT)
    check(ht.cumsum(logged, split), ref.cumsum(ref.log(theirs), split), np.cumsum(np.log(values), split), **REDUCTION["float64"])


@pytest.mark.parametrize("split", [None, 0, 1])
def test_out_takes_the_results_split(split):
    a, b = data((13, 7), "float32"), data((13, 7), "float32", seed=1)
    (ra, ma), (rb, mb) = both(a, split), both(b, split)
    mo, ro = ht.empty((13, 7), dtype=ht.float64, split=0), ref.empty((13, 7), dtype=ref.float64, split=0)
    got = ht.mul(ma, mb, out=mo)
    assert got is mo and mo.split == ref.mul(ra, rb, out=ro).split == split
    check(mo, ro, a.astype(np.float64) * b, **tol("float32"))


@pytest.mark.parametrize("p", [1, 2, 3, 5, 7, 13, 16])
def test_engines_at_every_mesh_size(p):
    comm = MeshCommunication([torch.device("cpu")] * p)
    a, b = data((13, 7), "float64", 0.5, 1.5), data((13, 7), "float64", 0.5, 1.5, seed=1)
    for sa, sb in [(0, 0), (0, 1), (1, None), (None, 0)]:
        x, y = ht.array(a, split=sa, comm=comm), ht.array(b, split=sb, comm=comm)
        np.testing.assert_allclose((x * 2 + y / 3).numpy(), a * 2 + b / 3, rtol=1e-15)
        np.testing.assert_allclose(ht.exp(x).numpy(), np.exp(a), rtol=1e-15)
        np.testing.assert_allclose(ht.cumprod(x, 0).numpy(), np.cumprod(a, 0), rtol=1e-13)
        np.testing.assert_allclose(ht.cumsum(x, 1).numpy(), np.cumsum(a, 1), rtol=1e-13)
        np.testing.assert_allclose((x + ht.array(b[:1], split=sa, comm=comm)).numpy(), a + b[:1], rtol=1e-15)
        np.testing.assert_allclose(ht.std(x, 0, ddof=1).numpy(), a.std(0, ddof=1), rtol=1e-12)
        np.testing.assert_allclose(ht.reshape(x, (7, 13)).numpy(), a.reshape(7, 13))


# ---------------------------------------------------------------------------
# the array's protocol and the quickstart
# ---------------------------------------------------------------------------
def test_methods_and_conversions():
    values = data((13, 7), "float64")
    theirs, mine = both(values, 0)
    for name in ("sum", "mean", "var", "std", "min", "max", "argmax", "argmin", "prod", "cumsum", "exp", "abs", "all", "any"):
        args = (0,) if name == "cumsum" else ()
        check(getattr(mine, name)(*args), getattr(theirs, name)(*args), **tol("float64", REDUCTION))
    scalar = ht.sum(mine)
    assert float(scalar) == pytest.approx(values.sum())
    assert bool(ht.array([1.0])) and int(ht.array([3])) == 3 and len(mine) == 13
    assert mine.tolist() == values.tolist()
    assert mine.lshape == tuple(theirs.lshape)
    assert mine.nbytes == values.nbytes
    assert np.array_equal(np.asarray(mine), values)
    with pytest.raises(ValueError):
        mine.item()


def test_readme_quickstart_matches_the_reference():
    """README.md:29-33 with explicit data for randn (the two generators
    differ, ROADMAP A2)."""
    noise = np.random.default_rng(7).standard_normal(1_000_000).astype(np.float32)
    results = {}
    for pkg in (ref, ht):
        x = pkg.arange(1_000_000, dtype=pkg.float32, split=0)
        y = pkg.array(noise, split=0)
        z = x * 2 + y
        s = pkg.sum(z)
        m = pkg.mean(z.reshape((1000, 1000)), axis=0)
        results[pkg.__name__] = (z, s, m)
    (rz, rs, rm), (z, s, m) = results["heat_tpu"], results["heat_tpu_torch"]
    expected = np.arange(1_000_000, dtype=np.float64) * 2 + noise
    check(z, rz, expected, **tol("float32"))
    check(s, rs, expected.sum(), rtol=1e-5)
    check(m, rm, expected.reshape(1000, 1000).mean(0), rtol=1e-5)
    assert m.gshape == (1000,) and z.split == 0
