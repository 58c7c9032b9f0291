"""heat_tpu_torch's estimators against heat_tpu's on the CPU, at the test
mesh size (HEAT_TPU_TEST_DEVICES, default 8): KMedians, KMedoids, the
batch-parallel init, Lasso, GaussianNB, KNeighborsClassifier and the
seeded datasets. The same seeded numpy inputs, cast explicitly, go
through heat_tpu (its fusion recorder off) and through the port.

Tolerances, float32 throughout:

* KMedians and KMedoids, from one precomputed init: labels and n_iter_
  equal; KMedoids centers exactly equal (rows of the data); KMedians
  centers rtol = atol = 1e-6 (the same sorted values, averaged the same
  way); inertia rtol 1e-5 (a sum over n in another order), plus, for each
  row within rounding of its center (a medoid's own row), the square root
  of the quadratic expansion's rounding error, 8u(|x|² + |c|²): there
  both packages take the root of a cancelled difference;
* the batch-parallel init: heat_tpu's own check (blob centers within 1.5)
  and one ``allgather``; its draws are torch's, not jax's;
* Lasso: θ within atol 1e-5 of heat_tpu's (the same sweep in float32) and
  1e-3 of the float64 numpy oracle of tests/test_ml.py; n_iter equal;
* GaussianNB: theta_ and var_ rtol 1e-5, class_count_ and predict equal,
  predict_log_proba atol 1e-4;
* KNN: labels equal, ties included;
* datasets: bit for bit.
"""

import os
import warnings

import numpy as np
import pytest
import torch

import heat_tpu as ref
import heat_tpu_torch as ht
from heat_tpu_torch.core.communication import MeshCommunication
from torch_counting import CountingMesh

P = ht.communication._cpu_mesh_size()
DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "heat_tpu", "datasets", "data")
ESTIMATORS = ("KMedians", "KMedoids")


@pytest.fixture(autouse=True)
def on_cpu():
    """The port on the CPU mesh, the reference with its recorder off."""
    ht.use_device("cpu")
    was = ref.fusion.set_enabled(False)
    yield
    ref.fusion.set_enabled(was)
    ht.use_comm(None)
    ht.use_device(None)


def _blobs(n, f, k, seed, scale=6.0):
    rng = np.random.default_rng(seed)
    means = rng.standard_normal((k, f)) * scale
    data = means[rng.integers(0, k, n)] + rng.standard_normal((n, f))
    init = data[rng.choice(n, k, replace=False)]
    return data.astype(np.float32), init.astype(np.float32)


def _both_fit(name, data, init, split, max_iter=20, **kwargs):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        theirs = getattr(ref.cluster, name)(
            n_clusters=init.shape[0], init=ref.array(init), max_iter=max_iter, **kwargs
        ).fit(ref.array(data, split=split))
    mine = getattr(ht.cluster, name)(
        n_clusters=init.shape[0], init=ht.array(init), max_iter=max_iter, **kwargs
    ).fit(ht.array(data, split=split))
    return mine, theirs


def _inertia_allowance(data, centers):
    """Σ √(8u(|x|² + |c|²)) over the rows whose exact squared distance to
    one of ``centers`` lies below that rounding error of the expansion."""
    x, c = data.astype(np.float64), centers.astype(np.float64)
    d2 = ((x[:, None, :] - c[None, :, :]) ** 2).sum(-1)
    nearest = np.argmin(d2, axis=1)
    error = 8 * 2.0**-24 * ((x * x).sum(1) + (c[nearest] ** 2).sum(1))
    close = d2[np.arange(len(x)), nearest] < error
    return float(np.sqrt(error[close]).sum())


def _assert_same_fit(name, mine, theirs, data=None, init=None):
    assert mine.n_iter_ == theirs.n_iter_
    np.testing.assert_array_equal(mine.labels_.numpy(), theirs.labels_.numpy())
    assert mine.labels_.split == theirs.labels_.split
    centers, want = mine.cluster_centers_.numpy(), theirs.cluster_centers_.numpy()
    if name == "KMedoids":
        np.testing.assert_array_equal(centers, want)
    else:
        np.testing.assert_allclose(centers, want, rtol=1e-6, atol=1e-6)
    atol = 0.0
    if data is not None:
        # the inertia is against the last iteration's input centers: the
        # returned ones once converged, the init after one iteration
        atol = _inertia_allowance(data, np.concatenate([want, init]))
    np.testing.assert_allclose(mine.inertia_, theirs.inertia_, rtol=1e-5, atol=atol)


def _numpy_medians(data, labels, k, old):
    """Each cluster's column medians (numpy averages an even count's two
    middle values); an empty cluster keeps its old center."""
    return np.stack([np.median(data[labels == c], axis=0) if np.any(labels == c) else old[c] for c in range(k)])


# ---------------------------------------------------------------------------
# KMedians and KMedoids
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ESTIMATORS)
@pytest.mark.parametrize("split", [0, None])
@pytest.mark.parametrize("shape", [(203, 4, 3), (1001, 16, 8)])
def test_fit_matches_reference(name, split, shape):
    data, init = _blobs(*shape, seed=shape[0])
    mine, theirs = _both_fit(name, data, init, split)
    _assert_same_fit(name, mine, theirs, data, init)


@pytest.mark.parametrize("name", ESTIMATORS)
def test_fit_runs_chunks_until_max_iter(name):
    data, init = _blobs(400, 5, 4, seed=3)
    kwargs = {"tol": -1.0} if name == "KMedians" else {}
    mine, theirs = _both_fit(name, data, init, 0, max_iter=11, **kwargs)
    assert mine.n_iter_ == theirs.n_iter_ == 11 if name == "KMedians" else mine.n_iter_ == theirs.n_iter_
    _assert_same_fit(name, mine, theirs, data, init)


@pytest.mark.parametrize("name", ESTIMATORS)
def test_even_counts_take_the_mean_of_the_two_middle_values(name):
    # two clusters of 20 rows each: a port taking the lower middle value
    # (torch.median) would miss the centers
    rng = np.random.default_rng(7)
    data = np.concatenate([rng.standard_normal((20, 3)), rng.standard_normal((20, 3)) + 10]).astype(np.float32)
    init = data[[0, 20]].copy()
    mine, theirs = _both_fit(name, data, init, 0, max_iter=1)
    _assert_same_fit(name, mine, theirs, data, init)
    if name == "KMedians":
        labels = mine.labels_.numpy()
        assert np.bincount(labels).tolist() == [20, 20]
        want = _numpy_medians(data, labels, 2, init)
        np.testing.assert_allclose(mine.cluster_centers_.numpy(), want, rtol=1e-6, atol=1e-6)
        lower = np.stack([np.sort(data[labels == c], axis=0)[9] for c in range(2)])
        assert np.abs(mine.cluster_centers_.numpy() - lower).max() > 1e-3


@pytest.mark.parametrize("name", ESTIMATORS)
def test_an_empty_cluster_keeps_its_center(name):
    data, init = _blobs(150, 3, 3, seed=11)
    init = np.concatenate([init, np.full((1, 3), 1e4, np.float32)])
    mine, theirs = _both_fit(name, data, init, 0, max_iter=3)
    _assert_same_fit(name, mine, theirs, data, init)
    np.testing.assert_array_equal(mine.cluster_centers_.numpy()[3], init[3])
    assert 3 not in mine.labels_.numpy()


def test_kmedians_beyond_torch_quantile_limit_on_one_shard():
    # n·f = 17.6e6 > 2^24, the most torch.quantile takes
    rng = np.random.default_rng(13)
    n, f, k = 1_100_000, 16, 3
    data = (rng.standard_normal((n, f)) + rng.integers(0, k, n)[:, None] * 5.0).astype(np.float32)
    init = np.stack([np.full(f, 5.0 * c, np.float32) for c in range(k)])
    one = MeshCommunication([torch.device("cpu")])
    km = ht.cluster.KMedians(n_clusters=k, init=ht.array(init, comm=one), max_iter=1)
    km.fit(ht.array(data, split=0, comm=one))
    labels = km.labels_.numpy()
    want = _numpy_medians(data, labels, k, init)
    np.testing.assert_allclose(km.cluster_centers_.numpy(), want, rtol=1e-6, atol=1e-6)


def test_kmedoids_centers_are_rows_of_the_data():
    data, init = _blobs(300, 4, 5, seed=17)
    km = ht.cluster.KMedoids(n_clusters=5, init="kmeans++", random_state=3).fit(ht.array(data, split=0))
    for c in km.cluster_centers_.numpy():
        assert np.any(np.all(data == c, axis=1))


def test_snap_takes_the_lowest_index_on_a_tie():
    from heat_tpu_torch.cluster.kmedians import _snap_to_members

    data = torch.tensor([[0.0], [2.0], [1.0], [3.0], [1.0], [9.0]])
    labels = torch.tensor([0, 0, 0, 0, 0, 1])
    med = torch.tensor([[1.0], [9.0]])
    np.testing.assert_array_equal(_snap_to_members(data, labels, 2, med).numpy(), [[1.0], [9.0]])
    # two members equally far from the median: the lower row wins
    med = torch.tensor([[1.5], [9.0]])
    np.testing.assert_array_equal(_snap_to_members(data, labels, 2, med).numpy(), [[2.0], [9.0]])


@pytest.mark.parametrize("name", ESTIMATORS)
def test_errors_match_the_reference(name):
    x = np.zeros((4, 2), np.float32)
    for pkg, err in ((ref, None), (ht, None)):
        with pytest.raises(ValueError):
            getattr(pkg.cluster, name)(n_clusters=3, init=pkg.array(x))
        with pytest.raises(ValueError):
            getattr(pkg.cluster, name)(init="nope")
        with pytest.raises(ValueError):
            getattr(pkg.cluster, name)(n_clusters=2).fit(x)
        with pytest.raises(ValueError):
            getattr(pkg.cluster, name)(n_clusters=2).fit(pkg.array(x[0]))
        with pytest.raises(RuntimeError):
            getattr(pkg.cluster, name)(n_clusters=2).predict(pkg.array(x))


# ---------------------------------------------------------------------------
# the batch-parallel init (tests/test_ml.py:377-396)
# ---------------------------------------------------------------------------
def _four_blobs(p, seed=0):
    rng = np.random.default_rng(seed)
    blobs = np.concatenate([rng.standard_normal((40 * max(p, 2), 4)) + c * 8 for c in range(4)])
    rng.shuffle(blobs)
    return blobs


def test_batchparallel_recovers_blobs():
    x = ht.array(_four_blobs(P), split=0)
    km = ht.cluster.KMeans(n_clusters=4, init="batchparallel", max_iter=50).fit(x)
    np.testing.assert_allclose(np.sort(km.cluster_centers_.numpy()[:, 0]), [0, 8, 16, 24], atol=1.5)


@pytest.mark.parametrize("p", [2, 4])
def test_batchparallel_gathers_once(p):
    mesh = CountingMesh([torch.device("cpu")] * p)
    x = ht.array(_four_blobs(p, seed=p), split=0, comm=mesh)
    km = ht.cluster.KMeans(n_clusters=4, init="batchparallel", random_state=5)
    centers = km._initialize_cluster_centers(x)
    assert dict(mesh.calls) == {"allgather": 1}
    assert centers.shape == (4, 4)
    # every center is a row of the data
    assert all(bool(torch.any(torch.all(x.larray == c, dim=1))) for c in centers)
    km.fit(x)
    np.testing.assert_allclose(np.sort(km.cluster_centers_.numpy()[:, 0]), [0, 8, 16, 24], atol=1.5)


def test_batchparallel_falls_back_on_ragged_or_single_device():
    rng = np.random.default_rng(1)
    x = ht.array(rng.standard_normal((4 * P + 1, 3)), split=0)
    km = ht.cluster.KMeans(n_clusters=2, init="batchparallel", max_iter=10).fit(x)
    assert km.cluster_centers_.shape == (2, 3)
    # no gather where the init is kmeans++: padded, replicated, too few rows
    mesh = CountingMesh([torch.device("cpu")] * 4)
    for data, split in ((rng.standard_normal((17, 3)), 0), (rng.standard_normal((16, 3)), None), (rng.standard_normal((8, 3)), 0)):
        km = ht.cluster.KMeans(n_clusters=3, init="batchparallel")
        km._initialize_cluster_centers(ht.array(data, split=split, comm=mesh))
    assert mesh.calls["allgather"] == 0


# ---------------------------------------------------------------------------
# Lasso
# ---------------------------------------------------------------------------
def _numpy_lasso_cd(X, y, lam, max_iter, tol):
    """Oracle: the reference's exact coordinate descent (tests/test_ml.py:328)."""
    n, m = X.shape
    theta = np.zeros(m, dtype=np.float64)
    for _ in range(max_iter):
        old = theta.copy()
        for j in range(m):
            X_j = X[:, j]
            rho = np.mean(X_j * (y - X @ theta + theta[j] * X_j))
            theta[j] = rho if j == 0 else np.sign(rho) * max(abs(rho) - lam, 0.0)
        if tol is not None and np.sqrt(np.mean((theta - old) ** 2)) < tol:
            break
    return theta


def _lasso_data(n, m, seed):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, m)).astype(np.float32)
    X /= np.sqrt(np.mean(X**2, axis=0))
    X[:, 0] = 1.0
    coef = np.zeros(m, np.float32)
    coef[: min(m, 6)] = [0.5, 2.0, -1.5, 0.0, 0.0, 1.0][: min(m, 6)]
    y = (X @ coef + 0.01 * rng.standard_normal(n)).astype(np.float32)
    return X, y


@pytest.mark.parametrize("split", [None, 0])
@pytest.mark.parametrize("mode,n,m,lam", [("gram", 80, 6, 0.01), ("gram", 64, 64, 0.05), ("residual", 12, 30, 0.05), ("residual", 9, 40, 0.01)])
def test_lasso_matches_reference_and_numpy(split, mode, n, m, lam):
    X, y = _lasso_data(n, m, seed=n + m)
    theirs = ref.regression.Lasso(lam=lam, max_iter=40).fit(ref.array(X, split=split), ref.array(y, split=split))
    mine = ht.regression.Lasso(lam=lam, max_iter=40).fit(ht.array(X, split=split), ht.array(y, split=split))
    assert mine.n_iter == theirs.n_iter
    theta = mine.theta.numpy().reshape(-1)
    np.testing.assert_allclose(theta, theirs.theta.numpy().reshape(-1), atol=1e-5)
    expected = _numpy_lasso_cd(X.astype(np.float64), y.astype(np.float64), lam, 40, 1e-6)
    np.testing.assert_allclose(theta, expected, atol=1e-3)
    assert mine.theta.shape == (m, 1) and mine.theta.split is None
    assert mine.coef_.shape == (m - 1, 1)
    np.testing.assert_allclose(float(mine.intercept_.item()), theta[0])
    pred = mine.predict(ht.array(X, split=split))
    assert pred.split == split
    np.testing.assert_allclose(pred.numpy().reshape(-1), theirs.predict(ref.array(X, split=split)).numpy().reshape(-1), atol=1e-4)


def test_lasso_tol_none_runs_every_sweep():
    X, y = _lasso_data(50, 5, seed=1)
    mine = ht.regression.Lasso(lam=0.1, max_iter=7, tol=None).fit(ht.array(X, split=0), ht.array(y, split=0))
    theirs = ref.regression.Lasso(lam=0.1, max_iter=7, tol=None).fit(ref.array(X, split=0), ref.array(y, split=0))
    assert mine.n_iter == theirs.n_iter == 7
    np.testing.assert_allclose(mine.theta.numpy(), theirs.theta.numpy(), atol=1e-5)
    np.testing.assert_allclose(mine.theta.numpy().reshape(-1), _numpy_lasso_cd(X.astype(np.float64), y.astype(np.float64), 0.1, 7, None), atol=1e-3)


@pytest.mark.parametrize("p", [1, 3, 4])
def test_lasso_collectives(p):
    mesh = CountingMesh([torch.device("cpu")] * p)
    X, y = _lasso_data(103, 6, seed=5)
    lasso = ht.regression.Lasso(lam=0.01, max_iter=30)
    lasso.fit(ht.array(X, split=0, comm=mesh), ht.array(y, split=0, comm=mesh))
    # Gram mode: X'X and X'y, one allreduce each, whatever the sweeps
    assert dict(mesh.calls) == ({"allreduce": 2} if p > 1 else {})
    one = ht.regression.Lasso(lam=0.01, max_iter=30).fit(ht.array(X), ht.array(y))
    assert lasso.n_iter == one.n_iter
    np.testing.assert_allclose(lasso.theta.numpy(), one.theta.numpy(), atol=1e-6)
    # residual mode: one allreduce per coordinate
    mesh.calls.clear()
    Xw, yw = _lasso_data(13, 20, seed=6)
    wide = ht.regression.Lasso(lam=0.05, max_iter=4, tol=None)
    wide.fit(ht.array(Xw, split=0, comm=mesh), ht.array(yw, split=0, comm=mesh))
    assert dict(mesh.calls) == ({"allreduce": 4 * 20} if p > 1 else {})
    np.testing.assert_allclose(wide.theta.numpy(), ht.regression.Lasso(lam=0.05, max_iter=4, tol=None).fit(ht.array(Xw), ht.array(yw)).theta.numpy(), atol=1e-6)


def test_lasso_on_diabetes_by_numpys_math():
    # the reference's demo protocol on the bundled diabetes file
    # (tests/test_datasets_real.py:74-88), read by the port's loader;
    # heat_tpu's own test of it fails, so the port is held to numpy
    x, y = ht.datasets.load_diabetes(split=0, return_y=True)
    assert x.gshape == (442, 11) and y.gshape == (442,)
    x = x / ht.sqrt(ht.mean(x**2, axis=0))
    X, yv = x.numpy(), y.numpy()
    lasso = ht.regression.Lasso(max_iter=100, lam=0.1).fit(x, ht.reshape(y, (442, 1)))
    expected = _numpy_lasso_cd(X.astype(np.float64), yv.astype(np.float64), 0.1, 100, 1e-6)
    np.testing.assert_allclose(lasso.theta.numpy().reshape(-1), expected, atol=1e-3 * max(1.0, np.abs(expected).max()))
    pred = lasso.predict(x).numpy().ravel()
    assert 1.0 - ((pred - yv) ** 2).sum() / ((yv - yv.mean()) ** 2).sum() > 0.3


def test_lasso_errors_match_the_reference():
    X, y = _lasso_data(10, 3, seed=2)
    for pkg in (ref, ht):
        with pytest.raises(TypeError):
            pkg.regression.Lasso().fit(X, y)
        with pytest.raises(ValueError):
            pkg.regression.Lasso().fit(pkg.array(X[:, 0]), pkg.array(y))
        with pytest.raises(ValueError):
            pkg.regression.Lasso().fit(pkg.array(X), pkg.array(np.zeros((10, 1, 1), np.float32)))
        with pytest.raises(RuntimeError):
            pkg.regression.Lasso().predict(pkg.array(X))
        lasso = pkg.regression.Lasso(lam=0.3)
        assert lasso.lam == 0.3 and lasso.coef_ is None and lasso.intercept_ is None
        lasso.lam = 0.2
        assert lasso.lam == 0.2


# ---------------------------------------------------------------------------
# GaussianNB
# ---------------------------------------------------------------------------
def _nb_data(n=300, f=5, c=3, seed=9):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, c, n).astype(np.int32)
    X = (rng.standard_normal((n, f)) * (1 + y[:, None]) + y[:, None] * 2.0).astype(np.float32)
    return X, y


def _assert_same_nb(mine, theirs, X, split):
    np.testing.assert_allclose(mine.theta_.numpy(), np.asarray(theirs.theta_), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(mine.var_.numpy(), np.asarray(theirs.var_), rtol=1e-5)
    np.testing.assert_array_equal(mine.class_count_.numpy(), np.asarray(theirs.class_count_))
    np.testing.assert_array_equal(mine.classes_.numpy(), np.asarray(theirs.classes_))
    np.testing.assert_allclose(mine.class_prior_.numpy(), np.asarray(theirs.class_prior_), rtol=1e-6)
    np.testing.assert_allclose(mine.epsilon_, theirs.epsilon_, rtol=1e-5)
    xm, xr = ht.array(X, split=split), ref.array(X, split=split)
    pred = mine.predict(xm)
    np.testing.assert_array_equal(pred.numpy(), theirs.predict(xr).numpy())
    assert pred.split == split
    lp = mine.predict_log_proba(xm).numpy()
    np.testing.assert_allclose(lp, theirs.predict_log_proba(xr).numpy(), atol=1e-4)
    proba = mine.predict_proba(xm).numpy()
    np.testing.assert_allclose(proba.sum(axis=1), 1.0, rtol=1e-5)
    np.testing.assert_allclose(proba, np.exp(lp), rtol=1e-6)


@pytest.mark.parametrize("split", [None, 0])
@pytest.mark.parametrize("weighted", [False, True])
def test_gaussian_nb_fit_matches_reference(split, weighted):
    X, y = _nb_data()
    w = np.random.default_rng(4).uniform(0.1, 3.0, X.shape[0]).astype(np.float32) if weighted else None
    theirs = ref.naive_bayes.GaussianNB().fit(ref.array(X, split=split), ref.array(y, split=split), sample_weight=w)
    mine = ht.naive_bayes.GaussianNB().fit(ht.array(X, split=split), ht.array(y, split=split), sample_weight=w)
    _assert_same_nb(mine, theirs, X, split)
    if weighted:
        # heat_tpu's check: the weights change the estimates
        plain = ht.naive_bayes.GaussianNB().fit(ht.array(X), ht.array(y))
        assert not np.allclose(mine.theta_.numpy(), plain.theta_.numpy())


@pytest.mark.parametrize("split", [None, 0])
def test_gaussian_nb_partial_fit_matches_reference(split):
    X, y = _nb_data(n=401, seed=12)
    cut = 150
    models = []
    for pkg in (ref, ht):
        nb = pkg.naive_bayes.GaussianNB(var_smoothing=1e-6)
        nb.partial_fit(pkg.array(X[:cut], split=split), pkg.array(y[:cut], split=split), classes=pkg.array([0, 1, 2, 3]))
        nb.partial_fit(pkg.array(X[cut:], split=split), pkg.array(y[cut:], split=split))
        models.append(nb)
    theirs, mine = models
    _assert_same_nb(mine, theirs, X, split)
    assert mine.class_count_.numpy()[3] == 0
    # the Chan merge of two batches gives fit's moments on the whole
    whole = ht.naive_bayes.GaussianNB(var_smoothing=1e-6).fit(ht.array(X), ht.array(y))
    np.testing.assert_allclose(mine.theta_.numpy()[:3], whole.theta_.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(mine.var_.numpy()[:3], whole.var_.numpy(), rtol=1e-4)


def test_gaussian_nb_priors_and_errors_match_the_reference():
    X, y = _nb_data(seed=3)
    for pkg in (ref, ht):
        nb = pkg.naive_bayes.GaussianNB(priors=pkg.array([0.2, 0.3, 0.5])).fit(pkg.array(X), pkg.array(y))
        np.testing.assert_allclose(np.asarray(nb.class_prior_ if pkg is ref else nb.class_prior_.numpy()), [0.2, 0.3, 0.5], rtol=1e-6)
        assert nb.sigma_ is nb.var_
        for priors, message in (([0.5, 0.5], "match"), ([0.5, 0.6, 0.2], "sum"), ([1.2, -0.1, -0.1], "non-negative")):
            with pytest.raises(ValueError, match=message):
                pkg.naive_bayes.GaussianNB(priors=pkg.array(priors)).fit(pkg.array(X), pkg.array(y))
        with pytest.raises(RuntimeError):
            pkg.naive_bayes.GaussianNB().predict(pkg.array(X))
        with pytest.raises(ValueError):
            pkg.naive_bayes.GaussianNB().fit(X, y)
        with pytest.raises(ValueError):
            pkg.naive_bayes.GaussianNB().fit(pkg.array(X[:, 0]), pkg.array(y))
        with pytest.raises(ValueError):
            pkg.naive_bayes.GaussianNB().fit(pkg.array(X), pkg.array(y[:10]))
    mine = ht.naive_bayes.GaussianNB(priors=ht.array([0.2, 0.3, 0.5])).fit(ht.array(X), ht.array(y))
    theirs = ref.naive_bayes.GaussianNB(priors=ref.array([0.2, 0.3, 0.5])).fit(ref.array(X), ref.array(y))
    _assert_same_nb(mine, theirs, X, None)


# ---------------------------------------------------------------------------
# KNeighborsClassifier
# ---------------------------------------------------------------------------
def _iris():
    x = np.loadtxt(os.path.join(DATA, "iris.csv"), delimiter=";").astype(np.float32)
    y = np.loadtxt(os.path.join(DATA, "iris_labels.csv")).astype(np.int32)
    return x, y


def _boundary_on_duplicate_k(x):
    """The smallest k in 3..12 for which some row's k-th and (k+1)-th
    nearest rows of x (exact float64 distances) are one point twice."""
    d = np.sqrt(((x[:, None, :].astype(np.float64) - x[None, :, :]) ** 2).sum(-1))
    order = np.argsort(d, axis=1, kind="stable")
    for k in range(3, 13):
        a, b = order[:, k - 1], order[:, k]
        if np.any(np.all(x[a] == x[b], axis=1) & (a != b)):
            return k
    raise AssertionError("no k in 3..12 has a duplicate row at its boundary")


def _knn_both(xtr, ytr, xte, k, split):
    theirs = ref.classification.KNeighborsClassifier(k).fit(ref.array(xtr, split=split), ref.array(ytr, split=split))
    mine = ht.classification.KNeighborsClassifier(k).fit(ht.array(xtr, split=split), ht.array(ytr, split=split))
    want = theirs.predict(ref.array(xte, split=split))
    got = mine.predict(ht.array(xte, split=split))
    assert got.split == want.split
    assert got.dtype == ht.canonical_heat_type(want.dtype.__name__)
    return got.numpy(), want.numpy()


def _near_tie_queries(xtr, xte, k):
    """Queries whose k-th and (k+1)-th nearest training rows are distinct
    points within the quadratic expansion's rounding of each other in d²,
    2(f + 4)u(|q|² + |x|²): there the two packages may order them either
    way. Duplicate rows are exactly tied in both and are not exempt."""
    q, t = xte.astype(np.float64), xtr.astype(np.float64)
    d2 = ((q[:, None, :] - t[None, :, :]) ** 2).sum(-1)
    order = np.argsort(d2, axis=1, kind="stable")
    rows = np.arange(len(q))
    a, b = order[:, k - 1], order[:, k]
    scale = (q * q).sum(1) + np.maximum((t[a] ** 2).sum(1), (t[b] ** 2).sum(1))
    err = 2 * (q.shape[1] + 4) * 2.0**-24 * scale
    return (np.abs(d2[rows, b] - d2[rows, a]) <= err) & np.any(xtr[a] != xtr[b], axis=1)


@pytest.mark.parametrize("split", [None, 0])
@pytest.mark.parametrize("k", ["5", "duplicate boundary", "1"])
@pytest.mark.parametrize("labels", ["integer", "one-hot", "random integer"])
def test_knn_on_iris_matches_reference_ties_included(split, k, labels):
    x, y = _iris()
    k = {"5": 5, "1": 1, "duplicate boundary": None}[k]
    k = _boundary_on_duplicate_k(x) if k is None else k
    if labels == "random integer":
        # labels that differ between duplicate rows, so that the tie order shows
        y = np.random.default_rng(0).integers(0, 3, y.shape[0]).astype(np.int32)
    ytr = np.eye(3, dtype=np.float32)[y] if labels == "one-hot" else y
    got, want = _knn_both(x, ytr, x, k, split)
    exempt = _near_tie_queries(x, x, k)
    assert exempt.mean() < 0.25
    np.testing.assert_array_equal(got[~exempt], want[~exempt])
    if labels != "random integer":
        assert np.mean(got == y) > 0.9


def test_knn_tie_takes_the_lower_index():
    from heat_tpu_torch.classification.kneighborsclassifier import _k_smallest

    d = torch.tensor([[3.0, 1.0, 2.0, 1.0, 2.0, 0.5], [1.0, 1.0, 1.0, 1.0, 1.0, 1.0]])
    np.testing.assert_array_equal(np.sort(_k_smallest(d, 3).numpy(), axis=1), [[1, 3, 5], [0, 1, 2]])
    np.testing.assert_array_equal(np.sort(_k_smallest(d, 4).numpy(), axis=1), [[1, 2, 3, 5], [0, 1, 2, 3]])
    np.testing.assert_array_equal(np.sort(_k_smallest(d, 6).numpy(), axis=1), [[0, 1, 2, 3, 4, 5]] * 2)


def test_knn_demo_folds_match_reference():
    # examples/knn_demo.py's five folds over iris_like
    X, Y = ht.datasets.iris_like(split=0, return_labels=True)
    RX, RY = ref.datasets.iris_like(split=0, return_labels=True)
    n = X.shape[0]
    fold = n // 5
    for k in range(5):
        mask = np.ones(n, dtype=bool)
        mask[k * fold : (k + 1) * fold] = False
        train, test = np.nonzero(mask)[0], np.arange(k * fold, (k + 1) * fold)
        mine = ht.classification.KNeighborsClassifier(5).fit(X[train], Y[train]).predict(X[test])
        theirs = ref.classification.KNeighborsClassifier(5).fit(RX[train], RY[train]).predict(RX[test])
        np.testing.assert_array_equal(mine.numpy(), theirs.numpy())
        assert np.mean(mine.numpy() == Y[test].numpy()) > 0.8


def test_knn_errors_match_the_reference():
    x, y = _iris()
    for pkg in (ref, ht):
        with pytest.raises(TypeError):
            pkg.classification.KNeighborsClassifier().fit(x, y)
        with pytest.raises(ValueError):
            pkg.classification.KNeighborsClassifier().fit(pkg.array(x[:10]), pkg.array(y[:5]))
        with pytest.raises(ValueError):
            pkg.classification.KNeighborsClassifier().fit(pkg.array(x[:4]), pkg.array(np.zeros((4, 2, 2))))
        with pytest.raises(RuntimeError):
            pkg.classification.KNeighborsClassifier().predict(pkg.array(x))
        knn = pkg.classification.KNeighborsClassifier().fit(pkg.array(x), pkg.array(y))
        with pytest.raises(TypeError):
            knn.predict(x)


# ---------------------------------------------------------------------------
# the seeded datasets and the package surface
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("split", [None, 0])
def test_datasets_equal_the_reference_bit_for_bit(split):
    mx, my = ht.datasets.iris_like(split=split, return_labels=True)
    rx, ry = ref.datasets.iris_like(split=split, return_labels=True)
    for mine, theirs in ((mx, rx), (my, ry), (ht.datasets.iris_like(split=split), ref.datasets.iris_like(split=split)),
                         (ht.datasets.diabetes_like(split=split), ref.datasets.diabetes_like(split=split))):
        assert mine.shape == theirs.shape and mine.split == theirs.split
        assert mine.dtype == ht.canonical_heat_type(theirs.dtype.__name__)
        np.testing.assert_array_equal(mine.numpy(), theirs.numpy())


def test_the_estimators_share_the_reference_signatures():
    import inspect

    pairs = [
        (ht.cluster.KMedians, ref.cluster.KMedians), (ht.cluster.KMedoids, ref.cluster.KMedoids),
        (ht.cluster.Spectral, ref.cluster.Spectral), (ht.graph.Laplacian, ref.graph.Laplacian),
        (ht.regression.Lasso, ref.regression.Lasso), (ht.naive_bayes.GaussianNB, ref.naive_bayes.GaussianNB),
        (ht.classification.KNeighborsClassifier, ref.classification.KNeighborsClassifier),
        (ht.datasets.iris_like, ref.datasets.iris_like), (ht.datasets.diabetes_like, ref.datasets.diabetes_like),
    ]
    for mine, theirs in pairs:
        assert inspect.signature(mine) == inspect.signature(theirs), mine
        for method in ("fit", "predict", "partial_fit", "predict_proba", "predict_log_proba", "construct"):
            if hasattr(theirs, method):
                assert inspect.signature(getattr(mine, method)) == inspect.signature(getattr(theirs, method)), (mine, method)
    assert ht.base.ClassificationMixin and ht.base.RegressionMixin
    for pkg in (ht, ref):
        est = pkg.regression.Lasso()
        assert est.get_params() == {"lam": 0.1, "max_iter": 100, "tol": 1e-6}
