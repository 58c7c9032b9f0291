"""heat_tpu_torch.core.resilience against heat_tpu's (tests/test_resilience.py,
tests/test_resilience_io.py). CPU only.

The spec grammar, the ``ci`` preset and the seeded ``p=``/``every=`` firing
rules are held to heat_tpu's call for call: the same spec string fires at
the same check indices in both packages. Every fault site the port wires
(the verbs, the reshard, halo and matmul sites, the declared linear
algebra) fires before the array changes, and a retry equals the fault-free
result exactly. ``errstate`` is held to the reference's per-op decisions
at meshes 1, 3 and 5.
"""

from __future__ import annotations

import errno
import os
import threading
import warnings

import jax
import numpy as np
import pytest
import torch

import heat_tpu as ref
import heat_tpu_torch as ht
from heat_tpu.core import resilience as ref_res
from heat_tpu.core import telemetry as ref_tel
from heat_tpu.core.communication import MeshCommunication as RefMesh
from heat_tpu_torch.core import resilience as res
from heat_tpu_torch.core import telemetry as tel
from heat_tpu_torch.core.communication import MeshCommunication
from test_torch_parity import eager_engines, on_cpu  # noqa: F401

# every test here holds the eager engines' accounting against heat_tpu's
pytestmark = pytest.mark.usefixtures("eager_engines")

MESHES = [1, 3, 5]


@pytest.fixture(autouse=True)
def clean():
    """Clean fault counts and telemetry at mode 1 in both packages; the
    environment's specs suspended by each test's own inject blocks."""
    was = tel.set_mode(1), ref_tel.set_mode(1)
    for m in (res, ref_res):
        m.reset()
        m.reset_device_faults()
    tel.reset()
    ref_tel.reset()
    yield
    tel.set_mode(was[0])
    ref_tel.set_mode(was[1])
    tel.reset()
    ref_tel.reset()


def _mesh(p):
    return MeshCommunication([torch.device("cpu")] * p)


def _ref_mesh(p):
    """The reference's mesh of p shards (capped at the JAX CPU mesh's size)."""
    return RefMesh(jax.devices()[:p])


# ---------------------------------------------------------------------------
# the harness: parsing and firing (TestFaultHarness)
# ---------------------------------------------------------------------------
SPECS = [
    "ci",
    "CI",
    "off",
    "",
    "io.write:exc=OSError:every=5,fusion.execute:every=11",
    "collective.*:p=0.25:seed=3, io.read:exc=TimeoutError:times=2",
    "a.b:every=2:times=3:p=0.5:seed=9",
    "bad.entry:nope=1,ok.site:times=1",
    "x:exc=NoSuchError",
    "y:every=abc",
]


def _spec_view(specs):
    return [(s.pattern, s.exc.__name__, s.times, s.every, s.p) for s in specs]


@pytest.mark.parametrize("text", SPECS)
def test_spec_parsing_equals_heat_tpus(text):
    with warnings.catch_warnings(record=True) as mine:
        warnings.simplefilter("always")
        got = res._parse_env(text)
    with warnings.catch_warnings(record=True) as theirs:
        warnings.simplefilter("always")
        want = ref_res._parse_env(text)
    assert _spec_view(got) == _spec_view(want)
    assert len(mine) == len(theirs)
    assert res._PRESETS == ref_res._PRESETS


FIRING = [
    ("s.t", dict(p=0.3, seed=7)),
    ("s.*", dict(every=3)),
    ("s.t", dict(every=2, times=2)),
    ("s.?", dict(p=0.5, every=2, seed=1, times=None)),
    ("s.t", dict(times=0)),
]


def _fired_at(module, pattern, kwargs, sites):
    out = []
    with module.inject(pattern, **kwargs):
        for i, site in enumerate(sites):
            try:
                module.check(site)
            except module.FaultInjected:
                out.append(i)
    return out


@pytest.mark.parametrize("pattern,kwargs", FIRING)
def test_seeded_specs_fire_at_the_same_calls(pattern, kwargs):
    sites = ["s.t", "s.u", "x.t", "s.tt"] * 25
    fired = _fired_at(res, pattern, kwargs, sites)
    assert fired == _fired_at(ref_res, pattern, kwargs, sites)
    assert res.fault_counts() == ref_res.fault_counts()


@pytest.mark.parametrize("text", ["s.t:every=4,s.u:p=0.4:seed=11", "s.*:exc=OSError:every=3"])
def test_environment_specs_fire_at_the_same_calls(text, monkeypatch):
    sites = ["s.t", "s.u", "q"] * 20
    seen = []
    for module in (res, ref_res):
        monkeypatch.setattr(module, "_BACKGROUND", module._parse_env(text))
        monkeypatch.setattr(module, "_ARMED", True)
        fired = []
        for i, site in enumerate(sites):
            try:
                module.check(site)
            except (module.FaultInjected, OSError) as exc:
                fired.append((i, type(exc).__name__, getattr(exc, "errno", None)))
        seen.append(fired)
    assert seen[0] == seen[1] and seen[0]


def test_inject_suspends_the_environments_specs(monkeypatch):
    monkeypatch.setattr(res, "_BACKGROUND", res._parse_env("a.b"))
    monkeypatch.setattr(res, "_ARMED", True)
    with res.inject("c.d", times=0):
        res.check("a.b")  # suspended
    with res.suspended():
        res.check("a.b")
    with pytest.raises(res.FaultInjected):
        res.check("a.b")
    assert res._ARMED


def test_inject_arms_and_disarms():
    assert not res._ARMED
    with res.inject("x", times=2) as spec:
        assert res._ARMED
        for _ in range(3):
            try:
                res.check("x")
            except res.FaultInjected:
                pass
    assert spec.fired == 2 and not res._ARMED
    assert res.fault_counts() == {"x": 2}
    assert tel.fault_events() == {"x": 2}


def test_injected_oserrors_are_transient_by_construction():
    for module in (res, ref_res):
        for exc, code in ((OSError, errno.EIO), (TimeoutError, errno.ETIMEDOUT)):
            made = module.FaultSpec("s", exc=exc).make("s")
            assert made.errno == code and module.retry_policy.is_transient(made)


def test_device_fault_ledger_crosses_its_threshold_once():
    with pytest.warns(res.MeshDegradedWarning):
        results = [res.note_device_fault("cuda:1") for _ in range(4)]
    assert results == [False, False, True, False]
    assert res.degraded_devices() == {"cuda:1"} and res.device_fault_counts() == {"cuda:1": 4}
    res.reset_device_faults()
    assert res.degraded_devices() == set()


@pytest.mark.parametrize(
    "exc", [res.FaultInjected("x"), TypeError(), ValueError(), IndexError(), ZeroDivisionError(), MemoryError(), KeyError()]
)
def test_recovery_policies_classify_as_heat_tpus(exc):
    ref_exc = ref_res.FaultInjected("x") if isinstance(exc, res.FaultInjected) else exc
    assert res.record_recoverable(exc) == ref_res.record_recoverable(ref_exc)
    assert res.force_recoverable(exc) == ref_res.force_recoverable(ref_exc)
    assert not res.force_recoverable(res.NonFiniteError()) and not res.force_recoverable(res.StallError())


# ---------------------------------------------------------------------------
# retries (TestRetry)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("code", sorted(errno.errorcode))
def test_retry_policy_classifies_every_errno_as_heat_tpus(code):
    err = OSError(code, "x")
    assert res.retry_policy.is_transient(err) == ref_res.retry_policy.is_transient(err)


def test_call_with_retries_retries_transient_errors_only():
    fast = res.RetryPolicy(retries=2, base_delay=0.0)
    calls = []

    def flaky(code, fail):
        calls.append(1)
        if len(calls) <= fail:
            raise OSError(code, "flaky")
        return "ok"

    assert res.call_with_retries("io.read", flaky, errno.EIO, 2, policy=fast) == "ok"
    assert len(calls) == 3 and tel.io_retries() == {"io.read": 2}
    calls.clear()
    with pytest.raises(OSError):
        res.call_with_retries("io.read", flaky, errno.EIO, 5, policy=fast)
    assert len(calls) == 3
    calls.clear()
    with pytest.raises(FileNotFoundError):
        res.call_with_retries("io.read", flaky, errno.ENOENT, 1, policy=fast)
    assert len(calls) == 1
    with res.inject("io.read", exc=OSError, times=1) as spec:
        calls.clear()
        assert res.call_with_retries("io.read", flaky, errno.EIO, 0, policy=fast) == "ok"
    assert spec.fired == 1 and len(calls) == 1


# ---------------------------------------------------------------------------
# atomic writes (test_resilience_io.py)
# ---------------------------------------------------------------------------
def test_a_crash_inside_atomic_write_leaves_the_target(tmp_path):
    path = str(tmp_path / "f.bin")
    open(path, "wb").write(b"old")
    with pytest.raises(RuntimeError):
        with res.atomic_write(path) as tmp:
            open(tmp, "wb").write(b"partial")
            raise RuntimeError("crash")
    assert open(path, "rb").read() == b"old" and os.listdir(tmp_path) == ["f.bin"]
    with res.inject("io.rename"):
        with pytest.raises(res.FaultInjected):
            with res.atomic_write(path) as tmp:
                open(tmp, "wb").write(b"new")
    assert open(path, "rb").read() == b"old" and os.listdir(tmp_path) == ["f.bin"]
    with res.atomic_write(path, preserve=True) as tmp:
        assert open(tmp, "rb").read() == b"old"
        open(tmp, "ab").write(b"+new")
    assert open(path, "rb").read() == b"old+new"
    with res.atomic_write(str(tmp_path / "nothing")):
        pass
    assert sorted(os.listdir(tmp_path)) == ["f.bin"]


# ---------------------------------------------------------------------------
# the fault sites of the port's seams
# ---------------------------------------------------------------------------
def _table(comm, seed=0):
    return ht.array(np.random.default_rng(seed).standard_normal((4 * comm.size + 3, 4)).astype(np.float32), split=0, comm=comm)


def _tall(comm):
    return ht.array(np.random.default_rng(5).standard_normal((8 * comm.size, 3)).astype(np.float32), split=0, comm=comm)


def _tri(comm):
    n = 4 * comm.size
    t = np.tril(np.random.default_rng(6).standard_normal((n, n))) + 4 * np.eye(n)
    return ht.array(t.astype(np.float32), split=0, comm=comm), ht.array(np.ones(n, np.float32), split=0, comm=comm)


#: (site, the call that must fire it at p > 1, whether it fires at p = 1)
SITES = [
    ("collective.allreduce", lambda c: ht.sum(_table(c), axis=0), False),
    ("collective.exscan", lambda c: ht.cumsum(_table(c), axis=0), False),
    ("collective.allgather", lambda c: ht.matmul(_table(c), ht.array(np.ones((4, 2), np.float32), split=0, comm=c)), False),
    ("collective.ppermute", lambda c: ht.spatial.cdist(_table(c), _table(c, 1)), False),
    ("collective.bcast", lambda c: ht.linalg.qr(ht.array(np.eye(4 * c.size, 2 * c.size, dtype=np.float32) + 1, split=1, comm=c)), False),
    ("collective.alltoall", lambda c: ht.nn.attention.ulysses_attention(*(torch.ones(1, 2 * c.size, c.size, 4),) * 3, comm=c), True),
    ("collective.halo", lambda c: _table(c).get_halo(1), False),
    ("collective.reshard", lambda c: _table(c).resplit(1), True),
    ("collective.reshard", lambda c: _table(c).resplit_(1), True),
    ("collective.matmul", lambda c: ht.matmul(ht.ones((4 * c.size, 4), split=0, comm=c), ht.ones((4, 4), comm=c)), True),
    ("collective.allgather", lambda c: ht.linalg.qr(_tall(c), method="tsqr"), False),
    ("collective.allreduce", lambda c: ht.linalg.solve_triangular(*_tri(c), lower=True), False),
]


@pytest.mark.parametrize("p", MESHES)
@pytest.mark.parametrize("i", range(len(SITES)))
def test_each_site_fires_where_the_port_collects(i, p):
    site, call, on_one = SITES[i]
    comm = _mesh(p)
    with res.inject(site) as spec:
        if p > 1 or on_one:
            with pytest.raises(res.FaultInjected, match=site):
                call(comm)
        else:
            call(comm)
    assert spec.fired == (1 if p > 1 or on_one else 0)
    call(comm)  # unarmed, the call succeeds


@pytest.mark.parametrize("p", MESHES)
def test_a_verb_fault_leaves_the_array_and_the_retry_equals_the_fault_free_result(p):
    comm = _mesh(p)
    x = _table(comm)
    before = [s.clone() for s in x.shards]
    want_sum = ht.sum(x, axis=0).numpy()
    want_halo = None
    with res.inject("collective.*", times=3):
        for call in (lambda: ht.sum(x, axis=0), lambda: x.resplit_(1), lambda: x.get_halo(2)):
            try:
                call()
            except res.FaultInjected:
                pass
    assert x.split == 0 and all(torch.equal(a, b) for a, b in zip(before, x.shards))
    assert x.halos is want_halo or p == 1
    np.testing.assert_array_equal(ht.sum(x, axis=0).numpy(), want_sum)
    x.resplit_(1)
    np.testing.assert_array_equal(x.numpy(), np.concatenate([s.numpy() for s in before])[: x.gshape[0]])


@pytest.mark.parametrize("p", [3, 5])
def test_a_declared_schedule_fires_once_as_heat_tpus_does(p):
    """Every third check fires: the blocked substitution checks once, not
    once per stage, so both packages see the same check sequence."""
    p = min(p, len(jax.devices()))
    comm, rcomm = _mesh(p), _ref_mesh(p)
    n = 4 * p
    t = (np.tril(np.random.default_rng(6).standard_normal((n, n))) + 4 * np.eye(n)).astype(np.float32)
    outcomes = []
    for pkg, module, c in ((ht, res, comm), (ref, ref_res, rcomm)):
        seen = []
        with module.inject("collective.allreduce", every=3, times=None):
            for _ in range(6):
                try:
                    pkg.linalg.solve_triangular(pkg.array(t, split=0, comm=c), pkg.array(np.ones(n, np.float32), split=0, comm=c), lower=True)
                    seen.append(True)
                except module.FaultInjected:
                    seen.append(False)
        outcomes.append(seen)
    assert outcomes[0] == outcomes[1] == ([True, True, False] * 2 if p > 1 else [True] * 6)


# ---------------------------------------------------------------------------
# errstate (TestErrstate)
# ---------------------------------------------------------------------------
OPS = [
    ("log0", lambda pkg, x: pkg.log(x * 0.0)),
    ("sqrt_neg", lambda pkg, x: pkg.sqrt(x - 10.0)),
    ("div0", lambda pkg, x: x / (x * 0.0)),
    ("exp_big", lambda pkg, x: pkg.exp(x * 1000.0)),
    ("sum_inf", lambda pkg, x: pkg.sum(x / 0.0, axis=0)),
    ("finite", lambda pkg, x: pkg.sum(x * 2.0 + 1.0, axis=0)),
    ("cumsum", lambda pkg, x: pkg.cumsum(x, axis=0)),
    ("int", lambda pkg, x: pkg.floor_divide(pkg.ones((5,), dtype=pkg.int32, comm=x.comm), 0)),
    ("cum_overflow", lambda pkg, x: pkg.cumsum(pkg.full((7, 3), 2e38, dtype=pkg.float32, split=0, comm=x.comm), axis=0)),
    ("sum_overflow", lambda pkg, x: pkg.sum(pkg.full((7, 3), 2e38, dtype=pkg.float32, split=0, comm=x.comm), axis=0)),
]


@pytest.mark.parametrize("p", MESHES)
@pytest.mark.parametrize("op", [o[0] for o in OPS])
def test_errstate_raises_at_the_same_ops_as_heat_tpu(op, p):
    fn = dict(OPS)[op]
    v = np.abs(np.random.default_rng(4).standard_normal((7, 3)).astype(np.float32)) + 0.5
    outcomes = []
    for pkg, module, comm in ((ht, res, _mesh(p)), (ref, ref_res, _ref_mesh(p))):
        x = pkg.array(v, split=0, comm=comm)
        with module.errstate(nonfinite="raise"):
            try:
                fn(pkg, x)
                outcomes.append("ok")
            except module.NonFiniteError:
                outcomes.append("raised")
    assert outcomes[0] == outcomes[1]
    raising = ("log0", "sqrt_neg", "div0", "exp_big", "sum_inf", "cum_overflow", "sum_overflow")
    assert (op in raising) == (outcomes[0] == "raised")


def test_errstate_nests_is_reusable_and_counts():
    x = ht.array(np.zeros(6, np.float32), split=0, comm=_mesh(3))
    state = res.errstate(nonfinite="raise")
    with state:
        with pytest.raises(res.NonFiniteError):
            ht.log(x)
        with res.errstate(nonfinite="warn"):
            with pytest.warns(res.NonFiniteWarning):
                ht.log(x)
            with res.errstate(nonfinite="ignore"):
                ht.log(x)
        with pytest.raises(res.NonFiniteError):
            ht.log(x)
    ht.log(x)  # ignore again
    with state:
        with state:
            with pytest.raises(res.NonFiniteError):
                ht.log(x)
        with pytest.raises(res.NonFiniteError):
            ht.log(x)
    assert res._ERRSTATE is None
    assert tel.nonfinite_counts() == {"eager": 5}
    with pytest.raises(ValueError):
        res.errstate(nonfinite="loud")
    assert ht.errstate is res.errstate


@pytest.mark.parametrize("p", [3, 5])
def test_errstate_never_reads_the_padding(p):
    x = ht.array(np.ones((7, 2), np.float32), split=0, comm=_mesh(p))
    assert x.padded
    x.shards[-1][-1] = float("nan")  # a padding row
    with res.errstate(nonfinite="raise"):
        ht.abs(x)
        ht.sum(x, axis=1)


def test_errstate_checks_bfloat16_and_skips_integers():
    comm = _mesh(3)
    b = ht.array(np.zeros(6, np.float32), dtype=ht.bfloat16, split=0, comm=comm)
    with res.errstate(nonfinite="raise"):
        with pytest.raises(res.NonFiniteError, match="bfloat16"):
            ht.log(b)
        ht.abs(ht.arange(6, split=0, comm=comm))
    res.check_nonfinite(torch.tensor([1, 2]), "x")
    with res.errstate(nonfinite="raise"):
        res.check_nonfinite(torch.tensor([1, 2]), "x")
        res.check_nonfinite([], "x")
        with pytest.raises(res.NonFiniteError, match="fused program p7"):
            res.check_nonfinite([torch.ones(2), torch.tensor([float("inf")])], "force", program="p7", cid=3)


def test_the_policy_is_process_wide_as_in_heat_tpu():
    """``errstate`` sets one module-level policy, so a worker thread's op
    sees it too, in both packages."""
    x, rx = ht.array(np.zeros(3, np.float32), comm=_mesh(1)), ref.array(np.zeros(3, np.float32))
    caught = []

    def worker(log, arr):
        try:
            log(arr)
        except Exception as exc:  # noqa: BLE001 - the exception is the result
            caught.append(type(exc).__name__)

    for module, log, arr in ((res, ht.log, x), (ref_res, ref.log, rx)):
        with module.errstate(nonfinite="raise"):
            t = threading.Thread(target=worker, args=(log, arr))
            t.start()
            t.join()
    assert caught == ["NonFiniteError", "NonFiniteError"]
    ht.log(x)


VERBS = [
    ("allreduce", lambda c, s: c.allreduce(s), 0),
    ("allgather", lambda c, s: c.allgather(s), 0),
    ("bcast", lambda c, s: c.bcast(s, root=c.size - 1), -1),
    ("exscan", lambda c, s: c.exscan(s), 0),
    ("scan", lambda c, s: c.scan(s), 0),
    ("ppermute", lambda c, s: c.ppermute(s), 0),
    ("alltoall", lambda c, s: c.alltoall(s), 0),
]


@pytest.mark.parametrize("p", MESHES)
@pytest.mark.parametrize("verb", [v[0] for v in VERBS])
def test_every_verb_records_and_fires_its_site_before_it_moves_anything(verb, p):
    """Each verb records one participant's payload (the root's for bcast)
    and fires ``collective.<verb>`` before it returns anything."""
    call, payload = {v[0]: v[1:] for v in VERBS}[verb]
    comm = _mesh(p)
    shards = [torch.full((2 * p, 3), float(d), dtype=torch.float64) for d in range(p)]
    shards[-1] = torch.full((2 * p, 5), float(p), dtype=torch.float64) if verb == "bcast" and p > 1 else shards[-1]
    before = [s.clone() for s in shards]
    with res.inject("collective." + verb) as spec:
        with pytest.raises(res.FaultInjected):
            call(comm, shards)
    assert spec.fired == 1 and all(torch.equal(a, b) for a, b in zip(before, shards))
    assert tel.fault_events() == {"collective." + verb: 1}
    tel.reset()  # the faulted call was recorded first, as in heat_tpu
    call(comm, shards)
    nbytes = shards[payload].numel() * 8
    assert tel.collectives() == {verb: {"count": 1, "bytes": nbytes, "axes": {"split": 1}, "dtypes": {"float64": 1}}}
    with tel.enabled(0):
        call(comm, shards)
    with ht.core.communication._declared():
        call(comm, shards)
    assert tel.collective_counts() == {verb: 1}
