"""heat_tpu_torch.core.io, the native CSV codec, signal.convolve and the
dataset loaders against heat_tpu and numpy. CPU only.

Every format must round trip bit for bit (exact comparisons throughout:
the files hold the values themselves) at splits None/0/1, with uneven
shards (13 rows) and with empty ones (2 rows over more shards), and a file
written from one mesh size must load at another. Files written by one
package load in the other. ``convolve`` is held to float64 numpy within
1e-5 (float32 sums over at most 9 taps of values below 4 in magnitude), to
heat_tpu within the same bound, and a split signal to the unsplit one bit
for bit.
"""

from __future__ import annotations

import os

import jax
import numpy as np
import pytest
import torch

import heat_tpu as ref
import heat_tpu_torch as ht
from heat_tpu_torch import _native
from heat_tpu_torch.core import io
from heat_tpu_torch.core.communication import MeshCommunication
from test_torch_parity import check_layout, on_cpu  # noqa: F401

SEED = 20261017
MESHES = [1, 3, 5]


def _mesh(p):
    return MeshCommunication([torch.device("cpu")] * p)


def _values(shape, dtype, seed=SEED):
    rng = np.random.default_rng(seed)
    if dtype == "bool":
        return rng.random(shape) < 0.5
    if dtype.startswith("int"):
        return rng.integers(-1000, 1000, shape).astype(dtype)
    return (rng.standard_normal(shape) * 10.0 ** rng.integers(-3, 4, shape)).astype(dtype)


def _save(fmt, x, path):
    if fmt == "npy":
        io.save_npy(x, path)
    elif fmt == "h5":
        io.save_hdf5(x, path, "data")
    elif fmt == "nc4":
        io.save_netcdf(x, path, "data")
    elif fmt == "nc3":
        io.save_netcdf(x, path, "data", format="NETCDF3_64BIT")
    else:
        io.save_csv(x, path)


def _load(fmt, path, dtype, split, comm):
    if fmt == "npy":
        return io.load_npy(path, split=split, comm=comm)
    if fmt == "h5":
        return io.load_hdf5(path, "data", dtype=dtype, split=split, comm=comm)
    if fmt in ("nc4", "nc3"):
        return io.load_netcdf(path, "data", dtype=dtype, split=split, comm=comm)
    return io.load_csv(path, dtype=dtype, split=split, comm=comm)


_EXT = {"npy": ".npy", "h5": ".h5", "nc4": ".nc", "nc3": ".nc", "csv": ".csv"}
_DTYPES = {
    "npy": ["float32", "float64", "int64", "bool"],
    "h5": ["float32", "float64", "int32", "bool"],
    "nc4": ["float32", "int64"],
    "nc3": ["float32", "float64", "int32"],
    "csv": ["float32", "float64", "int32"],
}
_CASES = [(fmt, dtype) for fmt, dtypes in _DTYPES.items() for dtype in dtypes]


# ---------------------------------------------------------------------------
# round trips
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("save_p", MESHES)
@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("rows", [13, 2])
@pytest.mark.parametrize("fmt,dtype", _CASES)
def test_every_format_round_trips_bit_for_bit(fmt, dtype, rows, split, save_p, tmp_path):
    values = _values((rows, 3), dtype)
    path = str(tmp_path / f"x{_EXT[fmt]}")
    _save(fmt, ht.array(values, split=split, comm=_mesh(save_p)), path)
    for load_p in MESHES:
        for load_split in (split, 0):
            got = _load(fmt, path, getattr(ht, dtype), load_split, _mesh(load_p))
            assert got.gshape == values.shape and got.split == load_split and got.comm.size == load_p
            assert got.dtype is getattr(ht, dtype)
            np.testing.assert_array_equal(got.numpy(), values)
            check_layout(got)


@pytest.mark.parametrize("p", MESHES)
@pytest.mark.parametrize("split", [None, 0, 1])
def test_npy_and_hdf5_files_hold_numpys_bytes(split, p, tmp_path):
    values = _values((13, 4), "float32")
    x = ht.array(values, split=split, comm=_mesh(p))
    io.save_npy(x, str(tmp_path / "a.npy"))
    with open(tmp_path / "b.npy", "wb") as fh:
        np.save(fh, values)
    assert (tmp_path / "a.npy").read_bytes() == (tmp_path / "b.npy").read_bytes()  # no padding written
    import h5py

    io.save_hdf5(x, str(tmp_path / "a.h5"), "d")
    with h5py.File(tmp_path / "a.h5", "r") as f:
        assert f["d"].shape == values.shape
        np.testing.assert_array_equal(f["d"][...], values)


def test_the_dispatchers_and_the_methods(tmp_path):
    values = _values((13, 4), "float32")
    x = ht.array(values, split=0, comm=_mesh(3))
    for ext, args, kwargs in ((".npy", (), {}), (".h5", ("d",), {"dataset": "d"}), (".nc", ("d",), {"variable": "d"}), (".csv", (), {})):
        path = str(tmp_path / f"x{ext}")
        ht.save(x, path, *args)
        np.testing.assert_array_equal(ht.load(path, split=0, **kwargs).numpy(), values)
        x.save(path, *args)  # the DNDarray method
        np.testing.assert_array_equal(ht.load(path, **kwargs).numpy(), values)
    x.save_csv(str(tmp_path / "m.csv"))
    x.save_hdf5(str(tmp_path / "m.h5"), "d")
    x.save_netcdf(str(tmp_path / "m.nc"), "d")
    np.testing.assert_array_equal(ht.load_csv(str(tmp_path / "m.csv")).numpy(), values)
    np.testing.assert_array_equal(ht.load_hdf5(str(tmp_path / "m.h5"), "d").numpy(), values)
    np.testing.assert_array_equal(ht.load_netcdf(str(tmp_path / "m.nc"), "d").numpy(), values)
    assert ht.supports_hdf5() and ht.supports_netcdf()


def test_the_port_exports_heat_tpus_io_names():
    assert [name for name in ref.core.io.__all__ if not hasattr(ht, name)] == []
    assert hasattr(ht, "convolve")
    for name in ("save", "save_csv", "save_hdf5", "save_netcdf"):
        assert callable(getattr(ht.DNDarray, name))


def test_bfloat16_saves_as_float32_values(tmp_path):
    values = torch.randn(9, generator=torch.Generator().manual_seed(SEED)).bfloat16()
    x = ht.array(values, split=0, comm=_mesh(3))
    io.save_npy(x, str(tmp_path / "b.npy"))
    got = io.load_npy(str(tmp_path / "b.npy"), dtype=ht.bfloat16, split=0)
    assert got.dtype is ht.bfloat16 and torch.equal(got.larray, values)


# ---------------------------------------------------------------------------
# the other package's files
# ---------------------------------------------------------------------------
def _ref_comm(p):
    from heat_tpu.core.communication import MeshCommunication as RefMesh

    return RefMesh(jax.devices()[: min(p, len(jax.devices()))])


@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("fmt", ["npy", "h5", "nc", "csv"])
def test_files_cross_between_the_packages(fmt, split, tmp_path):
    values = _values((13, 4), "float32")
    ext = {"npy": ".npy", "h5": ".h5", "nc": ".nc", "csv": ".csv"}[fmt]
    args = () if fmt in ("npy", "csv") else ("data",)
    kwargs = {} if fmt in ("npy", "csv") else ({"dataset": "data"} if fmt == "h5" else {"variable": "data"})
    theirs = str(tmp_path / f"ref{ext}")
    mine = str(tmp_path / f"port{ext}")
    ref.save(ref.array(values, split=split, comm=_ref_comm(3)), theirs, *args)
    ht.save(ht.array(values, split=split, comm=_mesh(5)), mine, *args)
    for p in (3, 5):
        np.testing.assert_array_equal(ht.load(theirs, split=split, comm=_mesh(p), **kwargs).numpy(), values)
        np.testing.assert_array_equal(np.asarray(ref.load(mine, split=split, comm=_ref_comm(p), **kwargs).numpy()), values)


@pytest.mark.parametrize("p", [3, 5])
def test_netcdf3_written_by_the_port_reads_in_scipy_and_heat_tpu(p, tmp_path):
    import scipy.io as sio

    values = _values((13, 4), "float64")
    path = str(tmp_path / "c.nc")
    io.save_netcdf(ht.array(values, split=1, comm=_mesh(p)), path, "v", dimension_names=["rows", "cols"], format="NETCDF3_CLASSIC")
    f = sio.netcdf_file(path, "r", mmap=False)
    assert f.dimensions == {"rows": 13, "cols": 4}
    np.testing.assert_array_equal(f.variables["v"][:], values)
    f.close()
    back = ref.load_netcdf(path, "v", dtype=ref.float64, split=0, comm=_ref_comm(p))
    np.testing.assert_array_equal(np.asarray(back.numpy()), values)
    with pytest.raises(TypeError):
        io.save_netcdf(ht.arange(4, dtype=ht.int64), str(tmp_path / "i.nc"), "v", format="NETCDF3_CLASSIC")
    with pytest.raises(ValueError):
        io.save_netcdf(ht.arange(4, dtype=ht.int32), path, "v", mode="a", format="NETCDF3_CLASSIC")


# ---------------------------------------------------------------------------
# the native CSV codec against the Python path
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("decimals", [-1, 3])
def test_native_codec_equals_the_python_path(decimals, split, tmp_path, monkeypatch):
    values = _values((13, 5), "float32")
    x = ht.array(values, split=split, comm=_mesh(3))
    before = dict(_native.CALLS)
    io.save_csv(x, str(tmp_path / "native.csv"), decimals=decimals)
    native = io.load_csv(str(tmp_path / "native.csv"), split=split)
    assert _native.CALLS["csv_write"] > before["csv_write"] and _native.CALLS["csv_parse"] > before["csv_parse"]
    monkeypatch.setattr(_native, "native_available", lambda: False)
    io.save_csv(x, str(tmp_path / "python.csv"), decimals=decimals)
    python = io.load_csv(str(tmp_path / "python.csv"), split=split)
    counted = dict(_native.CALLS)
    np.testing.assert_array_equal(native.numpy(), python.numpy())
    if decimals < 0:  # shortest round-trip text on both paths: the values themselves
        np.testing.assert_array_equal(native.numpy(), values)
    else:
        np.testing.assert_array_equal(native.numpy(), np.round(values.astype(np.float64), 3).astype(np.float32))
    monkeypatch.undo()
    # each file parses the same through the other path
    np.testing.assert_array_equal(io.load_csv(str(tmp_path / "python.csv")).numpy(), python.numpy())
    assert _native.CALLS["csv_parse"] > counted["csv_parse"]
    # and through heat_tpu's
    np.testing.assert_array_equal(np.asarray(ref.load_csv(str(tmp_path / "native.csv")).numpy()), native.numpy())


def test_native_module_matches_heat_tpus(tmp_path):
    from heat_tpu import _native as ref_native

    data = _values((9, 4), "float64")
    _native.csv_write(str(tmp_path / "a.csv"), data)
    assert _native.csv_scan(str(tmp_path / "a.csv")) == (9, 4)
    np.testing.assert_array_equal(_native.csv_parse(str(tmp_path / "a.csv")), data)
    if ref_native.native_available():
        ref_native.csv_write(str(tmp_path / "b.csv"), data)
        assert (tmp_path / "a.csv").read_bytes() == (tmp_path / "b.csv").read_bytes()
    with pytest.raises(ValueError):
        _native.csv_write(str(tmp_path / "c.csv"), np.zeros(3))


def test_integer_csv_stays_exact(tmp_path):
    values = np.array([[2**53 + 1, -3], [7, 2**40]], np.int64)
    io.save_csv(ht.array(values, split=0, comm=_mesh(3)), str(tmp_path / "i.csv"))
    assert (tmp_path / "i.csv").read_text().splitlines()[0] == f"{2**53 + 1},-3"


# ---------------------------------------------------------------------------
# errors, as test_io_errors.py has them
# ---------------------------------------------------------------------------
def test_dispatch_errors():
    with pytest.raises(ValueError, match=r"\.unknown_ext.*\.csv.*\.npy.*\.h5"):
        ht.load("data.unknown_ext")
    with pytest.raises(ValueError):
        ht.save(ht.ones(4), "data.unknown_ext")
    with pytest.raises(TypeError):
        ht.load(42)


def test_hdf5_errors(tmp_path):
    import h5py

    with pytest.raises((IOError, OSError, FileNotFoundError)):
        ht.load_hdf5("/nonexistent/dir/file.h5", "data")
    path = str(tmp_path / "d.h5")
    with h5py.File(path, "w") as f:
        f["present"] = np.arange(100.0).astype(np.float32)
    with pytest.raises(KeyError):
        ht.load_hdf5(path, "absent")
    with pytest.raises(TypeError):
        ht.load_hdf5(1, "data")
    with pytest.raises(TypeError):
        ht.load_hdf5("f.h5", dataset=7)
    with pytest.raises(ValueError):
        ht.load_hdf5(path, "present", load_fraction=1.5)
    part = ht.load_hdf5(path, "present", load_fraction=0.5, split=0, comm=_mesh(3))
    assert part.gshape == (50,)
    np.testing.assert_array_equal(part.numpy(), np.arange(50.0, dtype=np.float32))
    ht.save_hdf5(ht.arange(6, dtype=ht.float32), path, "one")
    ht.save_hdf5(ht.arange(4, dtype=ht.float32), path, "two", mode="a")
    assert ht.load_hdf5(path, "one").gshape == (6,) and ht.load_hdf5(path, "two").gshape == (4,)
    with pytest.raises(ValueError):
        ht.save_hdf5(ht.arange(4), path, "x", mode="x")
    with pytest.raises(FileNotFoundError):
        ht.save_hdf5(ht.arange(4), str(tmp_path / "none.h5"), "x", mode="r+")


def test_csv_errors_headers_and_separators(tmp_path):
    with pytest.raises(TypeError):
        ht.load_csv("x.csv", sep=3)
    path = tmp_path / "h.csv"
    path.write_text("col_a,col_b\n1,2\n3,4\n")
    for split in (None, 0):
        np.testing.assert_array_equal(ht.load_csv(str(path), header_lines=1, split=split).numpy(), [[1.0, 2.0], [3.0, 4.0]])
    path = tmp_path / "s.csv"
    path.write_text("1;2;3\n4;5;6\n")
    np.testing.assert_array_equal(ht.load_csv(str(path), sep=";").numpy(), [[1, 2, 3], [4, 5, 6]])
    path = tmp_path / "t.csv"
    path.write_text("1.0,2.0,3.0\n4.0,")
    with pytest.raises(ValueError):
        ht.load_csv(str(path), split=0)
    with pytest.raises(ValueError):
        ht.load_csv(str(path))
    with pytest.raises(ValueError):
        ht.save_csv(ht.zeros((2, 2, 2)), str(tmp_path / "3d.csv"))
    io.save_csv(ht.arange(4, dtype=ht.float32), str(tmp_path / "h2.csv"), header_lines=["a"], sep=";")
    assert (tmp_path / "h2.csv").read_text().splitlines()[0] == "a"
    np.testing.assert_array_equal(io.load_csv(str(tmp_path / "h2.csv"), header_lines=1).numpy()[:, 0], np.arange(4.0))


def test_truncated_files_raise(tmp_path):
    import h5py

    path = str(tmp_path / "trunc.npy")
    ht.save_npy(ht.arange(16, dtype=ht.float32), path)
    head = open(path, "rb").read(4)
    open(path, "wb").write(head)
    for split in (None, 0):
        with pytest.raises((ValueError, OSError)):
            ht.load_npy(path, split=split)
    ht.save_npy(ht.arange(64, dtype=ht.float32), path)
    size = os.path.getsize(path)
    with open(path, "rb+") as f:
        f.truncate(size - 64)
    with pytest.raises((ValueError, OSError)):
        ht.load_npy(path, split=0)
    path = str(tmp_path / "trunc.h5")
    with h5py.File(path, "w") as f:
        f["data"] = np.arange(4096, dtype=np.float32)
    with open(path, "rb+") as f:
        f.truncate(os.path.getsize(path) // 2)
    with pytest.raises((OSError, KeyError)):
        ht.load_hdf5(path, "data", split=0)
    path = str(tmp_path / "c.nc")
    open(path, "wb").write(b"CDF\x01" + b"\x00" * 32)
    with pytest.raises((ValueError, OSError, RuntimeError, TypeError, KeyError, IndexError)):
        ht.load_netcdf(path, variable="v")


def test_netcdf3_classic_written_by_scipy(tmp_path):
    import scipy.io as sio

    path = str(tmp_path / "classic3.nc")
    values = np.arange(60, dtype=np.float32).reshape(15, 4)
    f = sio.netcdf_file(path, "w")
    f.createDimension("rows", 15)
    f.createDimension("cols", 4)
    f.createVariable("data", "f", ("rows", "cols"))[:] = values
    f.close()
    x = ht.load_netcdf(path, variable="data", split=0, comm=_mesh(4))
    assert x.split == 0 and x.gshape == (15, 4)
    np.testing.assert_array_equal(x.numpy(), values)
    assert ht.load_netcdf(path, variable="data").split is None
    with pytest.raises(KeyError):
        ht.load_netcdf(path, variable="nope")
    x = ht.arange(10, dtype=ht.int32, split=0)
    ht.save_netcdf(x, str(tmp_path / "t.nc"), "v")
    back = ht.load_netcdf(str(tmp_path / "t.nc"), variable="v", split=0, dtype=ht.int32)
    assert back.dtype is ht.int32
    np.testing.assert_array_equal(back.numpy(), np.arange(10))


@pytest.mark.parametrize("fmt", ["npy", "h5", "nc4", "nc3", "csv"])
def test_a_failed_save_leaves_the_old_file(fmt, tmp_path, monkeypatch):
    path = str(tmp_path / f"p{_EXT[fmt]}")
    old = _values((6, 4), "float32")
    _save(fmt, ht.array(old, split=0, comm=_mesh(3)), path)
    before = open(path, "rb").read()

    blocks = io._shard_blocks

    def failing(data):  # the first shard is written, then the disk fills
        yield next(blocks(data))
        raise OSError("disk full")

    monkeypatch.setattr(io, "_shard_blocks", failing)
    with pytest.raises(OSError, match="disk full"):
        _save(fmt, ht.array(_values((6, 4), "float32", seed=1), split=0, comm=_mesh(3)), path)
    assert open(path, "rb").read() == before
    assert sorted(os.listdir(tmp_path)) == [os.path.basename(path)]


# ---------------------------------------------------------------------------
# convolve (test_halo.py::TestConvolve*, test_manipulations.py::TestSignal)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("p", [1, 3, 5])
@pytest.mark.parametrize("mode", ["full", "same", "valid"])
@pytest.mark.parametrize("n,k", [(13, 3), (40, 9), (12, 5), (4, 3), (9, 4), (7, 1), (3, 9)])
def test_convolve_matches_numpy_and_heat_tpu(n, k, mode, p):
    if mode == "same" and k % 2 == 0:
        with pytest.raises(ValueError):
            ht.convolve(ht.arange(n, dtype=ht.float32), ht.ones(k), mode="same")
        return
    rng = np.random.default_rng(SEED + n + k)
    a, v = rng.uniform(-2, 2, n).astype(np.float32), rng.uniform(-2, 2, k).astype(np.float32)
    comm = _mesh(p)
    got = ht.convolve(ht.array(a, split=0, comm=comm), ht.array(v, comm=comm), mode=mode)
    expected = np.convolve(a.astype(np.float64), v.astype(np.float64), mode=mode)
    assert got.gshape == expected.shape and got.dtype is ht.float32
    np.testing.assert_allclose(got.numpy(), expected, rtol=1e-5, atol=1e-5)
    check_layout(got)
    # the split signal equals the unsplit one bit for bit
    one = ht.convolve(ht.array(a, comm=_mesh(1)), ht.array(v, comm=_mesh(1)), mode=mode)
    np.testing.assert_array_equal(got.numpy(), one.numpy())
    theirs = ref.convolve(ref.array(a, split=0), ref.array(v), mode=mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(theirs.numpy()), rtol=1e-5, atol=1e-5)
    assert got.split == theirs.split


@pytest.mark.parametrize("a_dtype,v_dtype", [("int32", "int32"), ("int64", "float32"), ("float64", "float32"), ("bool", "int32")])
def test_convolve_dtype_rules_match_heat_tpu(a_dtype, v_dtype):
    a = _values((11,), a_dtype) if a_dtype != "bool" else np.arange(11) % 2 == 0
    v = np.array([1, 2, 1], dtype=v_dtype)
    for split in (None, 0):
        got = ht.convolve(ht.array(a, split=split), ht.array(v), mode="same")
        theirs = ref.convolve(ref.array(a, split=split), ref.array(v), mode="same")
        assert got.dtype.__name__ == theirs.dtype.__name__ and got.split == theirs.split
        np.testing.assert_allclose(got.numpy(), np.asarray(theirs.numpy()), rtol=1e-6)


def test_convolve_errors_and_swap():
    with pytest.raises(ValueError):
        ht.convolve(ht.zeros((3, 3)), ht.ones(3))
    with pytest.raises(ValueError):
        ht.convolve(ht.arange(5, dtype=ht.float32), ht.ones(3), mode="bad")
    short, long = np.array([1.0, -1.0, 2.0], np.float32), np.arange(8, dtype=np.float32)
    np.testing.assert_allclose(ht.convolve(short, long).numpy(), np.convolve(short, long), rtol=1e-6)
    np.testing.assert_allclose(ht.convolve(long.tolist(), short.tolist(), mode="valid").numpy(), np.convolve(long, short, "valid"), rtol=1e-6)


# ---------------------------------------------------------------------------
# the dataset loaders (test_datasets_real.py)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("split", [None, 0, 1])
def test_dataset_loaders_match_heat_tpu(split):
    mine, labels = ht.datasets.load_iris(split=split, return_labels=True)
    theirs, their_labels = ref.datasets.load_iris(split=split, return_labels=True)
    assert mine.gshape == (150, 4) and mine.split == theirs.split and labels.split == their_labels.split
    np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs.numpy()))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(their_labels.numpy()))
    assert np.bincount(labels.numpy()).tolist() == [50, 50, 50]
    x, y = ht.datasets.load_diabetes(split=split, return_y=True)
    xr, yr = ref.datasets.load_diabetes(split=split, return_y=True)
    assert x.gshape == (442, 11) and x.dtype.__name__ == xr.dtype.__name__
    np.testing.assert_array_equal(x.numpy(), np.asarray(xr.numpy()))
    np.testing.assert_array_equal(y.numpy(), np.asarray(yr.numpy()))
    nc = ht.load_netcdf(ht.datasets.path("iris.nc"), "data", split=split)
    np.testing.assert_allclose(nc.numpy(), mine.numpy(), rtol=1e-6)
    with pytest.raises(FileNotFoundError):
        ht.datasets.path("absent.csv")


def test_materialize_writes_the_seeded_sets(tmp_path):
    paths = ht.datasets.materialize(str(tmp_path))
    assert sorted(paths) == ["diabetes.h5", "iris.csv", "iris.h5"]
    np.testing.assert_array_equal(ht.load_csv(paths["iris.csv"]).numpy(), ht.datasets.iris_like().numpy())
    np.testing.assert_array_equal(ht.load_hdf5(paths["diabetes.h5"], "x").numpy(), ht.datasets.diabetes_like().numpy())
    theirs = ref.datasets.materialize(str(tmp_path / "ref"))
    for name in paths:
        a = ht.load(paths[name], **({} if name.endswith(".csv") else {"dataset": "data" if name == "iris.h5" else "x"}))
        b = ht.load(theirs[name], **({} if name.endswith(".csv") else {"dataset": "data" if name == "iris.h5" else "x"}))
        np.testing.assert_array_equal(a.numpy(), b.numpy())


# ---------------------------------------------------------------------------
# retries, fault sites and events (test_resilience_io.py)
# ---------------------------------------------------------------------------
from heat_tpu.core import resilience as ref_res  # noqa: E402
from heat_tpu.core import telemetry as ref_tel  # noqa: E402
from heat_tpu_torch.core import resilience as res  # noqa: E402
from heat_tpu_torch.core import telemetry as tel  # noqa: E402


@pytest.fixture
def fast_retries(monkeypatch):
    """Both packages with no backoff sleep and telemetry at mode 1."""
    for module in (res, ref_res):
        monkeypatch.setattr(module, "retry_policy", module.RetryPolicy(retries=2, base_delay=0.0))
    was = tel.set_mode(1), ref_tel.set_mode(1)
    tel.reset()
    ref_tel.reset()
    yield
    tel.set_mode(was[0])
    ref_tel.set_mode(was[1])


def _ref_save(fmt, x, path):
    if fmt == "npy":
        ref.save_npy(x, path)
    elif fmt == "h5":
        ref.save_hdf5(x, path, "data")
    elif fmt == "nc4":
        ref.save_netcdf(x, path, "data")
    else:
        ref.save_csv(x, path)


@pytest.mark.parametrize("p", MESHES)
@pytest.mark.parametrize("fmt", ["npy", "h5", "nc4", "nc3", "csv"])
def test_an_io_write_fault_every_second_attempt_is_retried_to_the_same_bytes(fmt, p, tmp_path, fast_retries):
    values = _values((13, 3), "float32")
    x = ht.array(values, split=0, comm=_mesh(p))
    clean = str(tmp_path / f"clean{_EXT[fmt]}")
    _save(fmt, x, clean)
    paths = [str(tmp_path / f"f{i}{_EXT[fmt]}") for i in range(2)]
    with res.inject("io.write", exc=OSError, every=2, times=None) as spec:
        for path in paths:
            _save(fmt, x, path)
    assert spec.fired == 1 and tel.io_retries() == {"io.write": 1}
    if fmt in ("npy", "nc3", "csv"):  # HDF5 files carry timestamps
        for path in paths:
            assert open(path, "rb").read() == open(clean, "rb").read()
    for path in paths:
        np.testing.assert_array_equal(_load(fmt, path, ht.float32, 0, _mesh(p)).numpy(), values)
    assert sorted(os.listdir(tmp_path)) == sorted(os.path.basename(q) for q in [clean] + paths)


@pytest.mark.parametrize("fmt", ["npy", "h5", "csv"])
def test_write_retries_count_as_heat_tpus(fmt, tmp_path, fast_retries):
    values = _values((12, 3), "float32")
    for name, pkg, module, t, save, comm in (
        ("port", ht, res, tel, _save, _mesh(3)),
        ("ref", ref, ref_res, ref_tel, _ref_save, _ref_comm(3)),
    ):
        x = pkg.array(values, split=0, comm=comm)
        with module.inject("io.write", exc=OSError, every=2, times=None):
            for i in range(3):
                save(fmt, x, str(tmp_path / f"{name}{i}{_EXT[fmt]}"))
        with module.inject("io.rename", exc=OSError, times=1):
            save(fmt, x, str(tmp_path / f"{name}r{_EXT[fmt]}"))
    # the rename fault is retried by the write attempt around it
    assert tel.io_retries() == ref_tel.io_retries() == {"io.write": 3}
    assert tel.fault_events() == ref_tel.fault_events()


@pytest.mark.parametrize("p", MESHES)
@pytest.mark.parametrize("fmt", ["npy", "h5", "nc3", "csv"])
def test_an_io_read_fault_every_second_block_is_retried(fmt, p, tmp_path, fast_retries):
    values = _values((13, 3), "float32")
    path = str(tmp_path / f"r{_EXT[fmt]}")
    _save(fmt, ht.array(values, split=0, comm=_mesh(p)), path)
    with res.inject("io.read", exc=OSError, every=2, times=None) as spec:
        got = _load(fmt, path, ht.float32, 0, _mesh(p))
    np.testing.assert_array_equal(got.numpy(), values)
    assert tel.io_retries().get("io.read", 0) == spec.fired >= (1 if p > 1 else 0)


def test_exhausted_or_hard_faults_leave_the_old_file(tmp_path, fast_retries):
    path = str(tmp_path / "x.npy")
    old = _values((6, 4), "float32")
    io.save_npy(ht.array(old, split=0, comm=_mesh(3)), path)
    before = open(path, "rb").read()
    new = ht.array(_values((6, 4), "float32", seed=1), split=0, comm=_mesh(3))
    with res.inject("io.write", exc=OSError, times=None):
        with pytest.raises(OSError):
            io.save_npy(new, path)
    with res.inject("io.rename"):
        with pytest.raises(res.FaultInjected):
            io.save_npy(new, path)
    assert tel.io_retries() == {"io.write": 2}
    assert open(path, "rb").read() == before and os.listdir(tmp_path) == ["x.npy"]


@pytest.mark.skipif(not io.supports_hdf5(), reason="h5py does not import")
def test_a_failed_append_keeps_the_original_intact(tmp_path, fast_retries):
    path = str(tmp_path / "a.h5")
    io.save_hdf5(ht.array(np.arange(6.0), split=0, comm=_mesh(3)), path, "first")
    before = open(path, "rb").read()
    with res.inject("io.rename"):
        with pytest.raises(res.FaultInjected):
            io.save_hdf5(ht.array(np.ones(4), split=0, comm=_mesh(3)), path, "second", mode="a")
    assert open(path, "rb").read() == before and os.listdir(tmp_path) == ["a.h5"]
    io.save_hdf5(ht.array(np.ones(4), split=0, comm=_mesh(3)), path, "second", mode="a")
    np.testing.assert_array_equal(ht.load_hdf5(path, "first", dtype=ht.float64).numpy(), np.arange(6.0))


@pytest.mark.parametrize("p", MESHES)
def test_the_io_events_of_a_save_and_a_load_match_heat_tpus(p, tmp_path, fast_retries):
    values = _values((13, 3), "float32")
    seen = []
    p = min(p, len(jax.devices()))
    for name, pkg, t, save, comm in (("port", ht, tel, _save, _mesh(p)), ("ref", ref, ref_tel, _ref_save, _ref_comm(p))):
        t.set_mode(2)
        t.reset()
        path = str(tmp_path / f"{name}.npy")
        save("npy", pkg.array(values, split=0, comm=comm), path)
        pkg.load_npy(path, split=0, comm=comm)
        seen.append([(e["op"], e["bytes"], e["blocks"]) for e in t.events() if e["kind"] == "io"])
    assert seen[0] == seen[1]
    assert [op for op, _, _ in seen[0]] == (["stream_blocks", "sharded_ingest"] if p > 1 else ["sharded_ingest"])
