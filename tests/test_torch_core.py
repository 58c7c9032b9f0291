"""heat_tpu_torch core against heat_tpu: mesh arithmetic, collectives, the
pad+mask DNDarray, factories, types, the random contract, and the import
boundary (the port never imports jax or heat_tpu). CPU only."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import heat_tpu as ref
import heat_tpu_torch as ht
from heat_tpu.core.communication import MeshCommunication as RefMesh
from heat_tpu_torch.core.communication import MeshCommunication

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _on_cpu():
    ht.use_device("cpu")
    yield
    ht.use_comm(None)
    ht.use_device(None)


def _cpu_mesh(p):
    return MeshCommunication([torch.device("cpu")] * p)


# ---------------------------------------------------------------------------
# mesh arithmetic and collectives
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("p", [1, 3, 5, 8])
@pytest.mark.parametrize("shape,split", [((13, 4), 0), ((13, 4), 1), ((8, 3), 0), ((0, 2), 0), ((5,), 0), ((7, 2), None)])
def test_block_arithmetic_matches_reference(p, shape, split):
    if p > len(jax.devices()):
        pytest.skip(f"the reference mesh has {len(jax.devices())} devices, fewer than {p}")
    mine, theirs = _cpu_mesh(p), RefMesh(jax.devices()[:p])
    assert mine.size == theirs.size == p
    for rank in range(p):
        assert mine.chunk(shape, split, rank) == theirs.chunk(shape, split, rank)
    np.testing.assert_array_equal(mine.lshape_map(shape, split), theirs.lshape_map(shape, split))
    if split is not None:
        assert mine.counts_displs_shape(shape, split) == theirs.counts_displs_shape(shape, split)


def test_default_cpu_mesh_matches_the_test_mesh():
    p = int(os.environ.get("HEAT_TPU_TEST_DEVICES", "8"))
    assert ht.get_comm().size == p == ref.get_comm().size


def test_allreduce_and_allgather_over_shards():
    comm = _cpu_mesh(4)
    shards = [torch.full((2, 3), float(i)) for i in range(4)]
    for out in comm.allreduce(shards):
        torch.testing.assert_close(out, torch.full((2, 3), 6.0))
    for out in comm.allgather(shards):
        torch.testing.assert_close(out, torch.cat(shards))
    with pytest.raises(ValueError):
        comm.allreduce(shards[:3])


# ---------------------------------------------------------------------------
# DNDarray in the pad+mask layout
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [13, 16, 3])
def test_dndarray_layout_matches_reference(n):
    data = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    mine, theirs = ht.array(data, split=0), ref.array(data, split=0)
    assert mine.shape == theirs.shape and mine.split == theirs.split == 0
    assert mine.padded == theirs.padded
    assert tuple(mine.parray.shape) == tuple(theirs.parray.shape)
    np.testing.assert_array_equal(mine.numpy(), data)
    np.testing.assert_array_equal(mine.larray.numpy(), np.asarray(theirs.larray))
    for a, b in zip(mine.lshards, theirs.lshards):
        np.testing.assert_array_equal(a.numpy(), b)
    np.testing.assert_array_equal(mine.lshape_map.numpy(), theirs.lshape_map.numpy())
    assert all(s.shape[0] == -(-n // mine.comm.size) for s in mine.shards)


def test_resplit_astype_item_repr():
    data = np.arange(30, dtype=np.float32).reshape(5, 6)
    x = ht.array(data, split=0)
    x.resplit_(1)
    assert x.split == 1 and x.shards[0].shape == (5, -(-6 // x.comm.size))
    np.testing.assert_array_equal(x.numpy(), data)
    x.resplit_(None)
    assert x.split is None and not x.padded
    np.testing.assert_array_equal(x.numpy(), data)
    y = x.astype(ht.float64)
    assert y.dtype is ht.float64 and y.larray.dtype == torch.float64
    assert x.dtype is ht.float32
    assert ht.array([[2.5]]).item() == 2.5
    with pytest.raises(ValueError):
        x.item()
    text = repr(ht.array([1.0, 2.0], split=0))
    assert "DNDarray" in text and "split=0" in text and "float32" in text


@pytest.mark.parametrize(
    "name,args,kwargs",
    [
        ("zeros", ((7, 3),), {"split": 0}),
        ("ones", ((7, 3),), {"split": 1}),
        ("empty", ((4,),), {}),
        ("full", ((5, 2), 3.5), {"split": 0}),
        ("full", ((5, 2), 3), {}),
        ("arange", (10,), {"split": 0}),
        ("arange", (1, 4, 0.5), {}),
    ],
)
def test_factories_match_reference(name, args, kwargs):
    mine = getattr(ht, name)(*args, **kwargs)
    theirs = getattr(ref, name)(*args, **kwargs)
    assert mine.shape == theirs.shape and mine.split == theirs.split
    assert mine.dtype.__name__ == theirs.dtype.__name__
    if name != "empty":
        np.testing.assert_array_equal(mine.numpy(), theirs.numpy())


def test_array_dtype_rules():
    assert ht.array([1.5, 2.0]).dtype is ht.float32  # python floats: float32
    assert ht.array(np.zeros(3)).dtype is ht.float64  # numpy keeps its dtype
    assert ht.array([1, 2]).dtype is ht.int64
    t = torch.ones(3)
    assert ht.array(t).larray.data_ptr() != t.data_ptr()
    assert ht.array(t, copy=False).larray.data_ptr() == t.data_ptr()


@pytest.mark.parametrize(
    "a,b", [("float32", "int32"), ("int32", "int64"), ("bool", "float64"), ("float32", "float64"), ("int64", "float32")]
)
def test_promote_types_matches_reference(a, b):
    mine = ht.promote_types(getattr(ht, a), getattr(ht, b))
    theirs = ref.promote_types(getattr(ref, a), getattr(ref, b))
    assert mine.__name__ == theirs.__name__


def test_canonical_heat_type():
    assert ht.canonical_heat_type(torch.float32) is ht.float32
    assert ht.canonical_heat_type("bfloat16") is ht.bfloat16
    assert ht.canonical_heat_type(np.int32) is ht.int32
    assert ht.canonical_heat_type(float) is ht.float32
    assert ht.heat_type_of(torch.zeros(1, dtype=torch.int64)) is ht.int64
    assert ht.types.index_dtype() == torch.int64
    with pytest.raises(TypeError):
        ht.canonical_heat_type(torch.complex64)


# ---------------------------------------------------------------------------
# the random contract
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fn,args", [("rand", (23, 3)), ("randn", (23, 3)), ("randint", (0, 9, (23, 3)))])
def test_random_same_seed_same_values_at_every_mesh_size(fn, args):
    results = []
    for p in (1, 3, 8):
        ht.random.seed(1234)
        x = getattr(ht.random, fn)(*args, split=0, comm=_cpu_mesh(p))
        assert x.comm.size == p
        results.append(x.numpy())
    for other in results[1:]:
        np.testing.assert_array_equal(results[0], other)


def test_random_state_round_trip():
    ht.random.seed(99)
    ht.random.rand(5)
    state = ht.random.get_state()
    a = ht.random.randn(7).numpy()
    ht.random.rand(3)
    ht.random.set_state(state)
    np.testing.assert_array_equal(ht.random.randn(7).numpy(), a)
    assert ht.random.get_state()[0] == "Torch" and ht.random.get_state()[1] == 99
    with pytest.raises(ValueError):
        ht.random.set_state(("Threefry", 1, 0, 0, 0.0))
    # successive draws differ
    assert not np.array_equal(ht.random.rand(10).numpy(), ht.random.rand(10).numpy())


def test_random_distributions():
    ht.random.seed(7)
    u = ht.random.rand(200_000, split=0).numpy()
    assert u.dtype == np.float32 and u.min() >= 0.0 and u.max() < 1.0
    assert abs(u.mean() - 0.5) < 0.005 and abs(u.var() - 1 / 12) < 0.002
    g = ht.random.randn(200_000, dtype=ht.float64).numpy()
    assert g.dtype == np.float64
    assert abs(g.mean()) < 0.01 and abs(g.std() - 1.0) < 0.01
    r = ht.random.randint(3, 8, (100_000,)).numpy()
    assert r.dtype == np.int32 and r.min() == 3 and r.max() == 7
    counts = np.bincount(r - 3, minlength=5)
    assert np.all(np.abs(counts / 100_000 - 0.2) < 0.01)
    with pytest.raises(ValueError):
        ht.random.randint(5, 5, (3,))


# ---------------------------------------------------------------------------
# the card is the default device; the port's import boundary
# ---------------------------------------------------------------------------
def test_no_device_means_the_gpu_and_raises_without_cuda():
    ht.use_device(None)
    assert ht.get_device() is ht.gpu
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ht.zeros((3,))
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ht.random.rand(3)
    x = ht.zeros((3,), device="cpu")
    assert x.device is ht.cpu and x.larray.device.type == "cpu"


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_heat_tpu():
    files = sorted((ROOT / "heat_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "heat_tpu"), f"{path} imports {mod}"


def test_importing_the_port_loads_no_jax():
    code = "import sys, heat_tpu_torch; sys.exit(1 if 'jax' in sys.modules or 'heat_tpu' in sys.modules else 0)"
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
