"""heat_tpu_torch's graph Laplacian and Spectral clustering against
heat_tpu's on the CPU, at the test mesh size (HEAT_TPU_TEST_DEVICES,
default 8). The same seeded numpy points, cast to float32, go through
heat_tpu (its fusion recorder off) and through the port.

Tolerances:

* the Laplacian: rtol 1e-5 and atol 1e-6 in every definition, mode and
  threshold key (the degrees are sums over n in another order), from each
  package's own ``rbf`` and from one Euclidean distance matrix given to
  both (the packages' quadratic-expansion ``cdist`` differ by more near
  d = 0, tests/test_torch_distance.py);
* Spectral: the eigenvalues of T within atol 1e-4 of heat_tpu's (Lanczos
  from the same start vector, float32, full reorthogonalization, run to
  m = n so that T holds the whole spectrum); labels equal up to a
  permutation of the clusters on separated blobs;
* two blobs (tests/test_graph_spectral_depth.py:68, a test heat_tpu
  fails): held to numpy's math, T's two smallest
  eigenvalues within 1e-4 of numpy's float64 eigenvalues of the Laplacian
  and each blob one cluster.
"""

import numpy as np
import pytest

import heat_tpu as ref
import heat_tpu_torch as ht
from heat_tpu_torch.ops import lloyd

LAPLACIAN_TOL = dict(rtol=1e-5, atol=1e-6)
EIGEN_ATOL = 1e-4


@pytest.fixture(autouse=True)
def on_cpu():
    """The port on the CPU mesh, the reference with its recorder off."""
    ht.use_device("cpu")
    was = ref.fusion.set_enabled(False)
    yield
    ref.fusion.set_enabled(was)
    ht.use_comm(None)
    ht.use_device(None)


def _blobs(n_per, centers, std, seed):
    rng = np.random.default_rng(seed)
    centers = np.asarray(centers, np.float64)
    x = np.concatenate([rng.normal(c, std, size=(n_per, centers.shape[1])) for c in centers])
    y = np.repeat(np.arange(len(centers)), n_per)
    perm = rng.permutation(len(y))
    return x[perm].astype(np.float32), y[perm]


def _same_partition(a, b):
    """True when the labels a and b split the rows alike, up to renaming."""
    pairs = set(zip(a.tolist(), b.tolist()))
    return len(pairs) == len(set(a.tolist())) == len(set(b.tolist()))


# ---------------------------------------------------------------------------
# the Laplacian
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("split", [0, None])
@pytest.mark.parametrize("definition", ["norm_sym", "simple"])
@pytest.mark.parametrize(
    "mode,key,weighted",
    [("fully_connected", "upper", True), ("eNeighbour", "upper", True), ("eNeighbour", "upper", False),
     ("eNeighbour", "lower", True), ("eNeighbour", "lower", False)],
)
@pytest.mark.parametrize("metric", ["rbf", "euclidean matrix"])
def test_laplacian_matches_reference(split, definition, mode, key, weighted, metric):
    x, _ = _blobs(13, [(0, 0, 0), (4, 4, 0), (0, 4, 4)], 1.0, seed=1)
    value = 0.5 if metric == "rbf" else 3.0
    dist = np.sqrt(((x[:, None].astype(np.float64) - x[None]) ** 2).sum(-1)).astype(np.float32)
    out = []
    for pkg in (ref, ht):
        if metric == "rbf":
            sim = lambda z, pkg=pkg: pkg.spatial.rbf(z, sigma=2.0, quadratic_expansion=True)
        else:
            sim = lambda z, pkg=pkg: pkg.array(dist, split=z.split)
        lap = pkg.graph.Laplacian(sim, weighted=weighted, definition=definition, mode=mode,
                                  threshold_key=key, threshold_value=value)
        out.append(lap.construct(pkg.array(x, split=split)))
    theirs, mine = out
    assert mine.shape == theirs.shape == (39, 39)
    assert mine.split == theirs.split
    assert mine.dtype == ht.float32
    L = mine.numpy()
    np.testing.assert_allclose(L, theirs.numpy(), **LAPLACIAN_TOL)
    np.testing.assert_allclose(L, L.T, **LAPLACIAN_TOL)
    if definition == "norm_sym":
        np.testing.assert_array_equal(np.diag(L), 1.0)
    else:
        np.testing.assert_allclose(L.sum(axis=1), 0.0, atol=1e-4)


@pytest.mark.parametrize("n", [1, 7, 40])
def test_laplacian_shards_keep_their_diagonal(n):
    # ragged row shards: each shard's diagonal sits at its global offset
    rng = np.random.default_rng(n)
    x = rng.standard_normal((n, 2)).astype(np.float32)
    lap = ht.graph.Laplacian(lambda z: ht.spatial.rbf(z, sigma=1.0, quadratic_expansion=True))
    L = lap.construct(ht.array(x, split=0))
    assert L.split == 0
    for s, c in zip(L.shards, L.counts_displs()[0]):
        assert s.shape[0] == -(-n // L.comm.size)
    np.testing.assert_array_equal(np.diag(L.numpy()), 1.0)
    d2 = ((x[:, None] - x[None]) ** 2).sum(-1).astype(np.float64)
    a = np.exp(-d2 / 2.0)
    np.fill_diagonal(a, 0.0)
    deg = a.sum(1)
    scale = np.where(deg > 0, 1 / np.sqrt(np.where(deg > 0, deg, 1)), 0)
    want = -a * scale[:, None] * scale[None, :]
    np.fill_diagonal(want, 1.0)
    np.testing.assert_allclose(L.numpy(), want, rtol=1e-4, atol=1e-5)


def test_laplacian_errors_match_the_reference():
    for pkg in (ref, ht):
        with pytest.raises(NotImplementedError):
            pkg.graph.Laplacian(lambda z: z, definition="rw")
        with pytest.raises(NotImplementedError):
            pkg.graph.Laplacian(lambda z: z, mode="kNN")
        with pytest.raises(ValueError):
            pkg.graph.Laplacian(lambda z: z, threshold_key="middle")


# ---------------------------------------------------------------------------
# Spectral
# ---------------------------------------------------------------------------
THREE = [(0, 0), (6, 6), (0, 6)]


@pytest.mark.parametrize("split", [0, None])
@pytest.mark.parametrize("metric,laplacian", [("rbf", "fully_connected"), ("rbf", "eNeighbour"), ("euclidean", "eNeighbour")])
def test_spectral_eigenvalues_match_reference(split, metric, laplacian):
    x, _ = _blobs(12, THREE, 0.8, seed=2)
    kwargs = dict(n_clusters=3, gamma=0.1, metric=metric, laplacian=laplacian, n_lanczos=x.shape[0],
                  threshold=0.2 if metric == "rbf" else 4.0, boundary="lower" if metric == "rbf" else "upper")
    theirs, _ = ref.cluster.Spectral(**kwargs)._spectral_embedding(ref.array(x, split=split))
    mine, emb = ht.cluster.Spectral(**kwargs)._spectral_embedding(ht.array(x, split=split))
    np.testing.assert_allclose(mine.numpy(), np.asarray(theirs), atol=EIGEN_ATOL)
    assert emb.shape == (x.shape[0], x.shape[0]) and emb.split == split


@pytest.mark.parametrize("split", [0, None])
@pytest.mark.parametrize("n_lanczos", [20, 60])
def test_spectral_labels_match_reference(split, n_lanczos):
    x, y = _blobs(20, THREE, 0.4, seed=4)
    fits = []
    for pkg in (ref, ht):
        sp = pkg.cluster.Spectral(n_clusters=3, gamma=0.5, n_lanczos=n_lanczos, random_state=7, init="kmeans++")
        fits.append(sp.fit(pkg.array(x, split=split)))
    theirs, mine = fits
    labels = mine.labels_.numpy()
    assert mine.labels_.split == theirs.labels_.split
    assert _same_partition(labels, theirs.labels_.numpy())
    assert _same_partition(labels, y)
    assert _same_partition(mine.fit_predict(ht.array(x, split=split)).numpy(), labels)


def test_spectral_smallest_eigenvalues_converge_when_m_is_less_than_n():
    x, _ = _blobs(30, THREE, 0.5, seed=6)
    theirs, _ = ref.cluster.Spectral(n_clusters=3, gamma=0.5, n_lanczos=40)._spectral_embedding(ref.array(x, split=0))
    mine, _ = ht.cluster.Spectral(n_clusters=3, gamma=0.5, n_lanczos=40)._spectral_embedding(ht.array(x, split=0))
    np.testing.assert_allclose(mine.numpy()[:3], np.asarray(theirs)[:3], atol=EIGEN_ATOL)


def test_spectral_eigengap_picks_the_reference_cluster_count():
    x, _ = _blobs(15, [(0, 0), (8, 0), (0, 8), (8, 8)], 0.5, seed=5)
    fits = []
    for pkg in (ref, ht):
        sp = pkg.cluster.Spectral(n_clusters=None, gamma=0.5, n_lanczos=x.shape[0], random_state=3, init="kmeans++")
        fits.append(sp.fit(pkg.array(x, split=0)))
    theirs, mine = fits
    assert mine.n_clusters == theirs.n_clusters
    assert mine._cluster.n_clusters == mine.n_clusters
    assert _same_partition(mine.labels_.numpy(), theirs.labels_.numpy())


def test_spectral_two_blobs_by_numpys_math():
    # tests/test_graph_spectral_depth.py:68-79's geometry
    rng = np.random.default_rng(3)
    a = rng.standard_normal((16, 2)).astype(np.float32) * 0.3 + 4
    b = rng.standard_normal((16, 2)).astype(np.float32) * 0.3 - 4
    pts = np.concatenate([a, b])
    model = ht.cluster.Spectral(n_clusters=2, gamma=0.5, n_lanczos=12, random_state=0)
    evals, _ = model._spectral_embedding(ht.array(pts, split=0))
    d2 = ((pts[:, None].astype(np.float64) - pts[None]) ** 2).sum(-1)
    adj = np.exp(-0.5 * d2)
    np.fill_diagonal(adj, 0.0)
    scale = 1 / np.sqrt(adj.sum(1))
    L = np.eye(32) - adj * scale[:, None] * scale[None, :]
    np.testing.assert_allclose(evals.numpy()[:2], np.linalg.eigvalsh(L)[:2], atol=EIGEN_ATOL)
    labels = model.fit(ht.array(pts, split=0)).labels_.numpy()
    first, second = labels[:16], labels[16:]
    assert len(np.unique(first)) == 1 and len(np.unique(second)) == 1
    assert first[0] != second[0]


def test_spectral_clusters_through_the_fused_lloyd_path():
    # on a CUDA tensor this is kernel B1; on the CPU its plain version runs
    x, _ = _blobs(20, THREE, 0.4, seed=8)
    sp = ht.cluster.Spectral(n_clusters=3, gamma=0.5, n_lanczos=30, random_state=1)
    before = lloyd.LAUNCHES
    sp.fit(ht.array(x, split=0))
    assert lloyd.LAUNCHES == before
    assert sp._cluster._fused_mode(ht.zeros((60, 3), split=0)) == "sharded"
    assert sp._cluster.n_iter_ >= 1


def test_spectral_raises_where_the_reference_raises():
    x, _ = _blobs(5, THREE, 0.4, seed=9)
    for pkg in (ref, ht):
        for kwargs in ({"metric": "cosine"}, {"laplacian": "kNN"}, {"assign_labels": "discretize"}):
            with pytest.raises(NotImplementedError):
                pkg.cluster.Spectral(**kwargs)
        sp = pkg.cluster.Spectral(n_clusters=2)
        with pytest.raises(ValueError):
            sp.fit(x)
        with pytest.raises(NotImplementedError):
            sp.fit(pkg.array(x, split=1))
        with pytest.raises(ValueError):
            sp.predict(x)
        assert sp.labels_ is None


@pytest.mark.parametrize("name", ["KMeans", "KMedians", "KMedoids", "Spectral"])
def test_cluster_demo_on_iris_like(name):
    # examples/cluster_demo.py's lines over 20 fixed draws of the init,
    # held to tests/test_ml.py's accuracy thresholds: a draw that puts two
    # centers into one class is the algorithm's local minimum, and heat_tpu
    # itself meets the thresholds on 17 of 20 kmeans++ draws and on 37 of
    # 50 of Spectral's random ones, so at least half must (0.5% to fail at 74%)
    x, y = ht.datasets.iris_like(split=0, return_labels=True)
    y = y.numpy()
    make, least = {
        "KMeans": (lambda s: ht.cluster.KMeans(n_clusters=3, init="kmeans++", random_state=s), 0.9),
        "KMedians": (lambda s: ht.cluster.KMedians(n_clusters=3, init="kmeans++", random_state=s), 0.9),
        "KMedoids": (lambda s: ht.cluster.KMedoids(n_clusters=3, init="kmeans++", random_state=s), 0.9),
        "Spectral": (lambda s: ht.cluster.Spectral(n_clusters=3, gamma=0.5, n_lanczos=50, random_state=s), 0.85),
    }[name]
    met = 0
    for seed in range(20):
        labels = make(seed).fit(x).labels_.numpy()
        assert np.bincount(labels, minlength=3).sum() == 150
        # the best matching of clusters to classes
        best = max(
            np.mean(np.array(perm)[labels] == y)
            for perm in ((0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0))
        )
        met += best > least
    assert met >= 10, (name, met)
