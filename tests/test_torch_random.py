"""heat_tpu_torch.random's new draws against heat_tpu and the
distributions they name: ``standard_normal``, ``normal``, ``random`` and
its aliases, ``uniform``, ``permutation``, ``randperm`` and
``random_integer``. Cases from test_random_depth.py.

The port draws with ``torch.Generator``; it cannot reproduce jax's
threefry bits, so its parity with the reference is distributional: both
packages' samples pass scipy's Kolmogorov-Smirnov test against the named
distribution at 20,000 samples, and a two-sample test against each
other, at significance 1e-5 (a right sample fails once in 10^5 seeds, a
wrong distribution at this size always). What is exact is the port's own
contract: the same seed gives the same values at meshes 1 and 5 and at
every split, and ``get_state``/``set_state`` round-trip."""

import numpy as np
import pytest
import torch
from scipy import stats

import heat_tpu as ref
import heat_tpu_torch as ht
from heat_tpu_torch.core.communication import MeshCommunication
from test_torch_parity import on_cpu  # noqa: F401

N = 20_000
ALPHA = 1e-5


def _mesh(p):
    return MeshCommunication([torch.device("cpu")] * p)


DRAWS = {
    "standard_normal": (lambda m, **k: m.random.standard_normal((N,), **k), stats.norm().cdf),
    "normal": (lambda m, **k: m.random.normal(3.0, 2.0, (N,), **k), stats.norm(3.0, 2.0).cdf),
    "random": (lambda m, **k: m.random.random((N,), **k), stats.uniform().cdf),
    "random_sample": (lambda m, **k: m.random.random_sample((N,), **k), stats.uniform().cdf),
    "ranf": (lambda m, **k: m.random.ranf((N,), **k), stats.uniform().cdf),
    "sample": (lambda m, **k: m.random.sample((N,), **k), stats.uniform().cdf),
    "uniform": (lambda m, **k: m.random.uniform(-2.0, 5.0, (N,), **k), stats.uniform(-2.0, 7.0).cdf),
}


@pytest.mark.parametrize("name", list(DRAWS))
def test_distributions_pass_ks_as_the_reference_does(name):
    draw, cdf = DRAWS[name]
    ht.random.seed(11)
    ref.random.seed(11)
    mine = draw(ht, split=0)
    theirs = draw(ref, split=0)
    assert mine.dtype is ht.float32 and mine.gshape == (N,) and mine.split == 0
    assert mine.dtype.__name__ == theirs.dtype.__name__
    assert stats.kstest(mine.numpy(), cdf).pvalue > ALPHA
    assert stats.kstest(np.asarray(theirs.numpy()), cdf).pvalue > ALPHA
    assert stats.ks_2samp(mine.numpy(), np.asarray(theirs.numpy())).pvalue > ALPHA


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_float64_draws_and_array_parameters(dtype):
    ht.random.seed(3)
    x = ht.random.normal(ht.array(np.full(N, 1.0)), 0.5, (N,), dtype=getattr(ht, dtype))
    assert x.dtype.__name__ == "float64"  # an f64 mean promotes, as in the reference
    assert stats.kstest(x.numpy(), stats.norm(1.0, 0.5).cdf).pvalue > ALPHA
    u = ht.random.uniform(0.0, 1.0, (N,), dtype=getattr(ht, dtype))
    assert u.dtype.__name__ == dtype and u.numpy().min() >= 0.0 and u.numpy().max() < 1.0
    assert ht.random.standard_normal().gshape == ()


@pytest.mark.parametrize("name", list(DRAWS) + ["randperm", "permutation", "random_integer"])
def test_same_seed_same_values_at_meshes_1_and_5(name):
    draw = DRAWS[name][0] if name in DRAWS else {
        "randperm": lambda m, **k: m.random.randperm(41, **k),
        "permutation": lambda m, **k: m.random.permutation(41, **k),
        "random_integer": lambda m, **k: m.random.random_integer(0, 9, (41,), **k),
    }[name]
    results = []
    for p in (1, 5):
        for split in (None, 0):
            ht.random.seed(1234)
            x = draw(ht, split=split, comm=_mesh(p))
            assert x.comm.size == p and x.split == split
            results.append(x.numpy())
    for other in results[1:]:
        np.testing.assert_array_equal(results[0], other)


def test_state_round_trips():
    ht.random.seed(99)
    ht.random.normal(shape=(3,))
    state = ht.random.get_state()
    a = [ht.random.uniform(size=(5,)).numpy(), ht.random.randperm(9).numpy(), ht.random.standard_normal((4,)).numpy()]
    ht.random.set_state(state)
    b = [ht.random.uniform(size=(5,)).numpy(), ht.random.randperm(9).numpy(), ht.random.standard_normal((4,)).numpy()]
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert ht.random.get_state()[2] == state[2] + 3


@pytest.mark.parametrize("split", [None, 0])
def test_permutations(split):
    ht.random.seed(5)
    ref.random.seed(5)
    p = ht.random.randperm(1000, split=split)
    assert p.dtype is ht.int64 and p.split == split
    np.testing.assert_array_equal(np.sort(p.numpy()), np.arange(1000))
    theirs = ref.random.randperm(1000, split=split)
    assert theirs.dtype.__name__ == p.dtype.__name__
    assert ht.random.randperm(10, dtype=ht.int32).dtype is ht.int32
    q = ht.random.permutation(1000)
    np.testing.assert_array_equal(np.sort(q.numpy()), np.arange(1000))
    # a permutation is uniform: each value lands in each half about equally
    first_half = np.mean([int((ht.random.randperm(50).numpy()[:25] == 0).any()) for _ in range(400)])
    assert abs(first_half - 0.5) < 0.1
    rows = np.arange(39, dtype=np.float32).reshape(13, 3)
    shuffled = ht.random.permutation(ht.array(rows, split=split))
    assert shuffled.split == split
    got = shuffled.numpy()
    np.testing.assert_array_equal(got[np.argsort(got[:, 0])], rows)
    with pytest.raises(TypeError):
        ht.random.permutation(2.5)
    with pytest.raises(TypeError):
        ht.random.randperm(2.5)


def test_random_integer_is_randint():
    assert ht.random.random_integer is ht.random.randint
    ht.random.seed(2)
    r = ht.random.random_integer(3, 8, (N,)).numpy()
    assert r.min() == 3 and r.max() == 7
    assert stats.chisquare(np.bincount(r - 3)).pvalue > ALPHA


# ---------------------------------------------------------------------------
# fault C13 of ROADMAP queue C: seed(None) draws from the OS's entropy, so two
# calls in the same millisecond give different streams
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("p", [3, 5])
def test_seed_none_twice_at_once_gives_two_streams(p, monkeypatch):
    import time

    monkeypatch.setattr(time, "time", lambda: 1.0e9)  # a frozen clock
    draws, seeds = [], set()
    for _ in range(4):
        ht.random.seed(None)
        seeds.add(ht.random.get_state()[1])
        draws.append(ht.random.rand(16, split=0, comm=_mesh(p)).numpy())
    assert len(seeds) == 4
    assert not any(np.array_equal(draws[i], draws[j]) for i in range(4) for j in range(i + 1, 4))
