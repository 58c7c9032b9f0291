"""heat_tpu_torch core against heat_tpu: mesh arithmetic, collectives, the
pad+mask DNDarray, factories, types, the random contract, and the import
boundary (the port never imports jax or heat_tpu). CPU only."""

import ast
import os
import re
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


def _ref_verb(verb, x, **kwargs):
    """A heat_tpu verb over the test mesh, on x split along axis 0."""
    comm = ref.get_comm()
    xs = jax.device_put(jax.numpy.asarray(x), comm.sharding(x.ndim, 0))
    out = comm.apply(lambda s: getattr(comm, verb)(s, **kwargs), xs, in_splits=[0], out_splits=0)
    return np.asarray(out)


def _port_verb(verb, x, p, **kwargs):
    """The port's verb over p CPU shards of x, its results concatenated."""
    shards = list(torch.from_numpy(x).chunk(p))
    return torch.cat(getattr(_cpu_mesh(p), verb)(shards, **kwargs)).numpy()


@pytest.mark.parametrize("kwargs", [{"shift": 1}, {"shift": -1}, {"shift": 3}, {"perm": "right"}, {"perm": "partial"}])
def test_ppermute_matches_reference_verb(kwargs):
    p = ref.get_comm().size
    if kwargs.get("perm") == "right":
        kwargs = {"perm": [(j, (j + 1) % p) for j in range(p)]}
    elif kwargs.get("perm") == "partial":  # shard 0 receives nothing: zeros
        kwargs = {"perm": [(j, j + 1) for j in range(p - 1)]}
    x = np.arange(p * 3 * 2, dtype=np.float64).reshape(p * 3, 2)
    np.testing.assert_array_equal(_port_verb("ppermute", x, p, **kwargs), _ref_verb("ppermute", x, **kwargs))


@pytest.mark.parametrize("split_axis,concat_axis", [(0, 0), (0, 1), (1, 0)])
def test_alltoall_matches_reference_verb(split_axis, concat_axis):
    p = ref.get_comm().size
    x = np.arange(p * p * 2 * p, dtype=np.float32).reshape(p * p * 2, p)
    got = _port_verb("alltoall", x, p, split_axis=split_axis, concat_axis=concat_axis)
    want = _ref_verb("alltoall", x, split_axis=split_axis, concat_axis=concat_axis)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("p", [3, 4, 5])
def test_ring_verbs_match_numpy(p):
    x = np.arange(p * 3, dtype=np.float64).reshape(p * 3)
    for shift in (1, -1, 2):
        np.testing.assert_array_equal(
            _port_verb("ppermute", x, p, shift=shift), np.roll(x.reshape(p, 3), -shift, axis=0).reshape(-1)
        )
    y = np.arange(p * p * 2 * 5, dtype=np.float64).reshape(p * p * 2, 5)
    np.testing.assert_array_equal(
        _port_verb("alltoall", y, p), y.reshape(p, p, 2, 5).transpose(1, 0, 2, 3).reshape(-1, 5)
    )
    comm = _cpu_mesh(p)
    with pytest.raises(ValueError):
        comm.alltoall([torch.zeros(p + 1, 2)] * p)
    with pytest.raises(ValueError):
        comm.ppermute([torch.zeros(2)] * p, perm=[(0, 1), (2, 1)])
    with pytest.raises(ValueError):
        comm.ppermute([torch.zeros(2)] * (p - 1))


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
    assert ht.canonical_heat_type(torch.complex64) is ht.complex64
    with pytest.raises(TypeError):
        ht.canonical_heat_type(torch.complex32)


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


SUBPACKAGES = (
    "analysis", "classification", "cluster", "datasets", "graph", "naive_bayes", "nn", "ops", "optim", "parallel",
    "regression", "spatial", "utils",
)


FORBIDDEN = ("jax", "jaxlib", "heat_tpu", "flax", "optax", "ml_dtypes")
#: modules beyond the subpackages' own that must exist and obey the rule
MODULES = (
    "_native", "core.io", "core.signal", "utils.checkpoint", "utils.data", "utils.data.partial_dataset",
    "core.version", "core.telemetry", "core.resilience", "utils.profiling", "telemetry",
    "core.memledger", "core.health_runtime", "utils.health", "core.fusion", "core.numlens", "core.serving",
    "core.tracelens", "core.opsplane", "core.multihost", "core.elastic", "core.autoscale", "scripts",
    "scripts.launch_multiproc", "scripts.multiproc_trainer",
)


def test_port_imports_neither_jax_nor_heat_tpu():
    files = sorted((ROOT / "heat_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    # every subpackage and module of the port is under the rule
    for sub in SUBPACKAGES:
        assert ROOT / "heat_tpu_torch" / sub / "__init__.py" in files, sub
    for mod in MODULES:
        path = ROOT / "heat_tpu_torch" / mod.replace(".", "/")
        assert (path / "__init__.py" if path.is_dir() else path.with_suffix(".py")) in files, mod
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in FORBIDDEN, f"{path} imports {mod}"


#: the knobs each runtime module must read, as its reference module does
REQUIRED_KNOBS = {
    "core/numlens.py": {
        "HEAT_TPU_NUMLENS", "HEAT_TPU_NUMLENS_SAMPLE_EVERY", "HEAT_TPU_NUMLENS_SHADOW_EVERY",
        "HEAT_TPU_NUMLENS_CANARY_EVERY", "HEAT_TPU_NUMLENS_MAX_ULP",
    },
    "core/serving.py": {
        "HEAT_TPU_ADMISSION_RATE", "HEAT_TPU_ADMISSION_BURST", "HEAT_TPU_ADMISSION_POLICY",
        "HEAT_TPU_PROGRAM_CACHE_DIR",
    },
    "core/telemetry.py": {"HEAT_TPU_TRACE_DELAY_MS"},
    "core/tracelens.py": {
        "HEAT_TPU_TRACELENS_SYNC_STORM_K", "HEAT_TPU_TRACELENS_RETRACE_K", "HEAT_TPU_TRACELENS_IDLE_GAP_MS",
        "HEAT_TPU_TRACELENS_STRAGGLER_MS",
    },
    "core/opsplane.py": {
        "HEAT_TPU_OPS_PORT", "HEAT_TPU_OPS_HOST", "HEAT_TPU_OPS_INTERVAL_S", "HEAT_TPU_OPS_RETAIN",
        "HEAT_TPU_SLO_TARGET", "HEAT_TPU_SLO_FAST_S", "HEAT_TPU_SLO_SLOW_S", "HEAT_TPU_SLO_BURN",
        "HEAT_TPU_SLO_BURN_MIN",
    },
    "core/elastic.py": {"HEAT_TPU_ELASTIC_SIGNALS", "HEAT_TPU_ELASTIC_DRAIN_MS"},
    "core/autoscale.py": {
        "HEAT_TPU_AUTOSCALE", "HEAT_TPU_AUTOSCALE_INTERVAL_S", "HEAT_TPU_AUTOSCALE_COOLDOWN_S",
        "HEAT_TPU_AUTOSCALE_SHRINK_AFTER_S", "HEAT_TPU_AUTOSCALE_MAX_ACTIONS", "HEAT_TPU_AUTOSCALE_MIN_DEVICES",
        "HEAT_TPU_AUTOSCALE_SHRINK", "HEAT_TPU_AUTOSCALE_SHED_TIERS",
    },
}


@pytest.mark.parametrize(
    "module", ["core/memledger.py", "core/health_runtime.py", "utils/health.py", "core/fusion.py", "core/telemetry.py",
               "core/numlens.py", "core/serving.py", "core/tracelens.py", "core/opsplane.py", "core/elastic.py",
               "core/autoscale.py"]
)
def test_runtime_modules_read_only_the_references_knobs(module):
    """Every HEAT_TPU_* variable a runtime module of the port reads is one
    the reference module of the same name reads: no knob of the port's own.
    The recorder reads the knobs of its collective half too (its collective
    nodes and root batching); the numerics lens, the serving layer, the
    trace analyzer and the ops plane read every knob of theirs, telemetry
    the straggler seam's delay, the elastic supervisor and the autoscale
    controller every knob of theirs."""
    mine = set(re.findall(r"HEAT_TPU_[A-Z0-9_]+", (ROOT / "heat_tpu_torch" / module).read_text()))
    theirs = set(re.findall(r"HEAT_TPU_[A-Z0-9_]+", (ROOT / "heat_tpu" / module).read_text()))
    assert mine <= theirs, sorted(mine - theirs)
    assert REQUIRED_KNOBS.get(module, set()) <= mine, sorted(REQUIRED_KNOBS[module] - mine)
    if module != "utils/health.py":
        assert mine
    collective = {"HEAT_TPU_FUSION_COLLECTIVES", "HEAT_TPU_FUSION_BATCH", "HEAT_TPU_FUSION_BATCH_BYTES"}
    if module == "core/fusion.py":
        assert collective <= mine
    else:
        assert not mine & collective, sorted(mine & collective)


def test_importing_the_port_loads_no_jax():
    modules = ", ".join(f"heat_tpu_torch.{m}" for m in SUBPACKAGES + MODULES)
    code = (
        f"import sys, heat_tpu_torch as ht, {modules}; "
        f"assert all(getattr(ht, s).__name__ == 'heat_tpu_torch.' + s for s in {SUBPACKAGES!r}); "
        f"sys.exit(1 if set({FORBIDDEN!r}) & set(sys.modules) else 0)"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    # the analyzer's command line, as a user runs it, loads no forbidden
    # module either: its lint and rule table never touch the reference
    for argv in (["rules"], ["lint", "heat_tpu_torch"]):
        code = (
            "import runpy, sys\n"
            f"sys.argv = ['heat_tpu_torch.analysis'] + {argv!r}\n"
            "try:\n"
            "    runpy.run_module('heat_tpu_torch.analysis', run_name='__main__', alter_sys=True)\n"
            "except SystemExit as exc:\n"
            "    rc = exc.code\n"
            f"loaded = sorted(set({FORBIDDEN!r}) & set(sys.modules))\n"
            "print('forbidden:', loaded)\n"
            "sys.exit(3 if loaded else rc)\n"
        )
        proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, (argv, proc.stdout[-2000:], proc.stderr[-2000:])
        assert "forbidden: []" in proc.stdout


#: names of heat_tpu's ``__all__`` that exist only because of jax (ROADMAP
#: "Only a difference from numpy ... counts as a fault"), and ``defer_op``,
#: a kept divergence of the recorder
JAX_ONLY_NAMES = {
    "heat_tpu.core.devices": {"tpu"},
    "heat_tpu.core.fusion": {"defer_op"},
    "heat_tpu.core.sanitation": {"is_concrete"},
    "heat_tpu.ops": {"flash_attention_tpu"},
    "heat_tpu.ops.flash": {"flash_attention_tpu", "pallas_attention_supported"},
    "heat_tpu.ops.lloyd": {"fused_sharded_supported"},
    "heat_tpu.ops.pairwise": {"pallas_supported"},
}
#: heat_tpu's modules that declare ``__all__``, by their dotted names
REFERENCE_MODULES = sorted(
    ".".join(path.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
    for path in (ROOT / "heat_tpu").rglob("*.py")
    if "__all__" in path.read_text() and path.name != "_compat.py"
)


@pytest.mark.parametrize("module", REFERENCE_MODULES)
def test_c21_every_public_name_of_the_reference_is_the_ports(module):
    """C21 (ROADMAP Queue C): every name in a heat_tpu module's ``__all__``
    is in the ``__all__`` of the port's module of the same path, less the
    jax-only names (:data:`JAX_ONLY_NAMES`); ``core/_compat.py`` holds jax
    shims and has no counterpart."""
    import importlib

    theirs = importlib.import_module(module)
    if not hasattr(theirs, "__all__"):
        pytest.skip(f"{module} builds no __all__")
    mine = importlib.import_module("heat_tpu_torch" + module.removeprefix("heat_tpu"))
    missing = set(theirs.__all__) - set(getattr(mine, "__all__", ())) - JAX_ONLY_NAMES.get(module, set())
    assert not missing, sorted(missing)
    for name in getattr(mine, "__all__", ()):
        assert hasattr(mine, name), name


# ---------------------------------------------------------------------------
# fault C11 of ROADMAP queue C: the reference's surface, on explicit meshes of
# 3 and 5 shards
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("p", [3, 5])
def test_factories_take_order(p):
    comm = _cpu_mesh(p)
    a = ht.ones((4, 3), split=0, comm=comm)
    for fn in (ht.ones_like, ht.zeros_like, ht.empty_like):
        assert fn(a, order="F").gshape == (4, 3)
    assert ht.full_like(a, 2.0, order="F").gshape == (4, 3)
    for fn in (ht.zeros, ht.ones, ht.empty):
        assert fn((5, 2), split=0, comm=comm, order="F").gshape == (5, 2)
    assert ht.full((5, 2), 3.0, split=1, comm=comm, order="F").numpy().tolist() == np.full((5, 2), 3.0).tolist()
    values = np.asfortranarray(np.arange(12.0).reshape(4, 3))
    np.testing.assert_array_equal(ht.array(values, order="F", split=0, comm=comm).numpy(), values)
    np.testing.assert_array_equal(ht.asarray(values, order="F", is_split=0, comm=comm).numpy(), values)


@pytest.mark.parametrize("p", [3, 5])
def test_tolist_device_and_estimator_predicates(p):
    x = ht.arange(7, split=0, comm=_cpu_mesh(p))
    assert x.tolist(keepsplit=True) == x.tolist() == list(range(7))
    d = ht.Device("cpu", 0)
    assert d.device_type == "cpu" and d.device_id == 0 and d == ht.cpu
    km, lasso, nb = ht.cluster.KMeans(), ht.regression.Lasso(), ht.naive_bayes.GaussianNB()
    assert ht.is_estimator(km) and ht.is_clusterer(km) and not ht.is_classifier(km)
    assert ht.is_regressor(lasso) and ht.is_classifier(nb) and not ht.is_transformer(km)

    class Scale(ht.BaseEstimator, ht.TransformMixin):
        def fit(self, x):
            self.m = float(x.max().item())
            return self

        def transform(self, x):
            return x / self.m

    scaled = Scale().fit_transform(x.astype(ht.float32))
    assert ht.is_transformer(Scale()) and scaled.numpy().max() == 1.0


@pytest.mark.parametrize("p", [3, 5])
@pytest.mark.parametrize("n,m", [(7, 11), (11, 7), (9, 9)])
def test_larray_setter_repads(n, m, p):
    comm = _cpu_mesh(p)
    a = ht.arange(n, split=0, comm=comm)
    a.larray = torch.arange(m, dtype=torch.int64)
    assert a.gshape == (m,) and a.dtype is ht.int64
    assert a.shards[0].shape[0] == -(-m // p)
    np.testing.assert_array_equal(a.numpy(), np.arange(m))
    b = ht.zeros((3, 4), split=1, comm=comm)
    b.larray = torch.ones(5)  # no axis 1 left: replicated
    assert b.split is None and b.gshape == (5,)
    with pytest.raises(TypeError):
        a.larray = np.arange(3)


def test_the_native_codec_builds_only_into_the_build_directory(tmp_path):
    from heat_tpu_torch import _native
    from heat_tpu_torch.ops import _build

    assert _native.native_available()
    path = tmp_path / "x.csv"
    _native.csv_write(str(path), np.arange(6.0).reshape(3, 2))
    np.testing.assert_array_equal(_native.csv_parse(str(path)), np.arange(6.0).reshape(3, 2))
    libraries = sorted((ROOT / "heat_tpu_torch").rglob("*.so"))
    assert libraries and all(p.parent == _build.BUILD_DIR for p in libraries), libraries
    assert not list((ROOT / "heat_tpu_torch" / "_native").glob("*.so"))


# ---------------------------------------------------------------------------
# fault C15 of ROADMAP queue C: an array fill value is broadcast to the shape,
# with the reference's dtype rule, on explicit meshes of 3 and 5 shards
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("p", [3, 5])
@pytest.mark.parametrize("split", [None, 0, 1])
def test_full_broadcasts_an_array_fill_value(split, p):
    comm, theirs = _cpu_mesh(p), RefMesh(jax.devices()[: min(p, len(jax.devices()))])
    cases = [
        (lambda pkg, c: pkg.full((4, 3), pkg.array(5, dtype=pkg.int32), split=split, comm=c), np.full((4, 3), 5, np.int32)),
        (lambda pkg, c: pkg.full((4, 3), np.array([1, 2, 3], np.int32), split=split, comm=c), np.full((4, 3), [1, 2, 3], np.int32)),
        (lambda pkg, c: pkg.full((4, 3), np.array([1.5, 2.0, -3.0], np.float32), split=split, comm=c), np.full((4, 3), [1.5, 2.0, -3.0], np.float32)),
        (lambda pkg, c: pkg.full((4, 3), np.array(2.5, np.float32), split=split, comm=c), np.full((4, 3), 2.5, np.float32)),
        (
            lambda pkg, c: pkg.full_like(pkg.zeros((4, 3), split=split, comm=c), pkg.array(2.0)),
            np.full((4, 3), 2.0, np.float32),
        ),
    ]
    for make, expected in cases:
        mine, want = make(ht, comm), make(ref, theirs)
        np.testing.assert_array_equal(mine.numpy(), expected)
        np.testing.assert_array_equal(mine.numpy(), np.asarray(want.numpy()))
        assert str(mine.dtype).split(".")[-1] == str(want.dtype).split(".")[-1] == expected.dtype.name
        assert mine.split == want.split == split
