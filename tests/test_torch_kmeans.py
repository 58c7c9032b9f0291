"""heat_tpu_torch KMeans.fit end to end against heat_tpu's KMeans on the CPU,
at the test mesh size (HEAT_TPU_TEST_DEVICES, default 8), from the same
precomputed init: heat_tpu on its jnp path (use_fused=False) and on its
Pallas path in interpret mode (use_fused=True), the port on its fused path
(the kernel's plain version on the CPU) and on its torch path.

Tolerances: labels and n_iter equal; centers rtol/atol 1e-5 and inertia
rtol 1e-4 — the same arithmetic in float32, summed in another order.
"""

import warnings

import numpy as np
import pytest
import torch

import heat_tpu as ref
import heat_tpu_torch as ht
from heat_tpu_torch.ops import lloyd
from heat_tpu_torch.utils import interop

N, F, K = 203, 4, 3


@pytest.fixture(autouse=True)
def _on_cpu():
    ht.use_device("cpu")
    yield
    ht.use_device(None)


def _blobs(n=N, f=F, k=K, seed=0):
    rng = np.random.default_rng(seed)
    means = rng.standard_normal((k, f)) * 6
    data = means[rng.integers(0, k, n)] + rng.standard_normal((n, f))
    init = data[rng.choice(n, k, replace=False)]
    return data.astype(np.float32), init.astype(np.float32)


def _ref_fit(data, init, split, use_fused, max_iter=20, tol=1e-4):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        km = ref.cluster.KMeans(
            n_clusters=init.shape[0], init=ref.array(init), max_iter=max_iter, tol=tol,
            use_fused=use_fused,
        )
        return km.fit(ref.array(data, split=split))


def _port_fit(data, init, split, use_fused, max_iter=20, tol=1e-4):
    km = ht.cluster.KMeans(
        n_clusters=init.shape[0], init=ht.array(init), max_iter=max_iter, tol=tol,
        use_fused=use_fused,
    )
    return km.fit(ht.array(data, split=split))


def _assert_same_fit(mine, theirs):
    assert mine.n_iter_ == theirs.n_iter_
    np.testing.assert_array_equal(mine.labels_.numpy(), theirs.labels_.numpy())
    np.testing.assert_allclose(
        mine.cluster_centers_.numpy(), theirs.cluster_centers_.numpy(), rtol=1e-5, atol=1e-5
    )
    np.testing.assert_allclose(mine.inertia_, theirs.inertia_, rtol=1e-4)


@pytest.mark.parametrize(
    "split,port_fused,ref_fused",
    [
        (0, None, False),
        (0, None, True),
        (0, False, False),
        (0, False, True),
        (None, None, False),
        (None, False, False),
    ],
)
def test_fit_matches_reference(split, port_fused, ref_fused):
    data, init = _blobs(seed=1)
    mine = _port_fit(data, init, split, port_fused)
    theirs = _ref_fit(data, init, split, ref_fused)
    _assert_same_fit(mine, theirs)
    assert mine.labels_.split == theirs.labels_.split
    assert mine.labels_.dtype is ht.int64


def test_fit_runs_chunks_until_converged_or_max_iter():
    data, init = _blobs(seed=2)
    mine = _port_fit(data, init, 0, None, max_iter=11, tol=-1.0)
    theirs = _ref_fit(data, init, 0, False, max_iter=11, tol=-1.0)
    assert mine.n_iter_ == theirs.n_iter_ == 11
    _assert_same_fit(mine, theirs)


def test_fit_ragged_many_clusters_at_mesh_size():
    data, init = _blobs(n=1001, f=16, k=8, seed=3)
    mine = _port_fit(data, init, 0, None, max_iter=16)
    theirs = _ref_fit(data, init, 0, True, max_iter=16)
    assert mine.cluster_centers_.shape == (8, 16)
    _assert_same_fit(mine, theirs)


def test_fused_path_on_cpu_tensors_launches_no_kernel():
    data, init = _blobs(seed=4)
    before = lloyd.LAUNCHES
    _port_fit(data, init, 0, True)
    assert lloyd.LAUNCHES == before


def test_shape_limits_choose_the_torch_path_or_raise():
    rng = np.random.default_rng(5)
    data = rng.standard_normal((300, 520)).astype(np.float32)
    init = data[:3]
    with pytest.raises(ValueError, match="f <= 512"):
        _port_fit(data, init, 0, True, max_iter=2)
    auto = _port_fit(data, init, 0, None, max_iter=2)
    pinned = _port_fit(data, init, 0, False, max_iter=2)
    _assert_same_fit(auto, pinned)


def test_bf16_data_streams_as_bf16_like_the_reference():
    # both quantize the centers to bf16 for the dot; products of bf16
    # values are exact in f32, so only the order of the sums differs
    data, init = _blobs(n=512, f=8, k=4, seed=6)
    mine = ht.cluster.KMeans(n_clusters=4, init=ht.array(init), max_iter=8).fit(
        ht.array(data, split=0).astype(ht.bfloat16)
    )
    theirs = ref.cluster.KMeans(n_clusters=4, init=ref.array(init), max_iter=8, use_fused=True).fit(
        ref.array(data, split=0).astype(ref.bfloat16)
    )
    assert mine.cluster_centers_.dtype is ht.float32
    _assert_same_fit(mine, theirs)


@pytest.mark.parametrize("init", ["random", "kmeans++", "probability_based"])
def test_sampled_inits_give_a_finite_fit(init):
    data, _ = _blobs(seed=7)
    km = ht.cluster.KMeans(n_clusters=K, init=init, max_iter=10, random_state=3)
    km.fit(ht.array(data, split=0))
    assert km.cluster_centers_.shape == (K, F)
    assert np.isfinite(km.cluster_centers_.numpy()).all() and km.inertia_ > 0
    # the same seed gives the same fit
    again = ht.cluster.KMeans(n_clusters=K, init=init, max_iter=10, random_state=3)
    again.fit(ht.array(data, split=0))
    np.testing.assert_array_equal(km.cluster_centers_.numpy(), again.cluster_centers_.numpy())


def test_predict_matches_reference_predict():
    data, init = _blobs(seed=8)
    mine = _port_fit(data, init, 0, None)
    theirs = _ref_fit(data, init, 0, False)
    new = _blobs(n=77, seed=9)[0]
    np.testing.assert_array_equal(
        mine.predict(ht.array(new, split=0)).numpy(), theirs.predict(ref.array(new, split=0)).numpy()
    )
    assert mine.fit_predict(ht.array(data, split=0)).shape == (N,)


def test_kmeans_from_state_of_a_reference_fit_predicts_the_same():
    data, init = _blobs(seed=10)
    theirs = _ref_fit(data, init, 0, False)
    state = {
        "cluster_centers_": theirs.cluster_centers_.numpy(),
        "labels_": theirs.labels_.numpy(),
        "inertia_": theirs.inertia_,
        "n_iter_": theirs.n_iter_,
        "n_clusters": K,
    }
    mine = interop.kmeans_from_state(state)
    assert mine.n_iter_ == theirs.n_iter_ and mine.inertia_ == pytest.approx(theirs.inertia_)
    np.testing.assert_array_equal(mine.labels_.numpy(), state["labels_"])
    x = interop.dndarray_from_numpy(data, split=0)
    assert x.dtype is ht.float32 and x.split == 0
    np.testing.assert_array_equal(mine.predict(x).numpy(), theirs.predict(ref.array(data, split=0)).numpy())
    with pytest.raises(ValueError):
        interop.kmeans_from_state({**state, "n_clusters": K + 1})


def test_fit_input_checks():
    km = ht.cluster.KMeans(n_clusters=2)
    with pytest.raises(ValueError):
        km.fit(torch.zeros(4, 2))
    with pytest.raises(ValueError):
        km.fit(ht.zeros((4,)))
    with pytest.raises(RuntimeError):
        km.predict(ht.zeros((4, 2)))
    with pytest.raises(ValueError):
        ht.cluster.KMeans(n_clusters=3, init=ht.zeros((2, 2)))
    with pytest.raises(ValueError):
        ht.cluster.KMeans(init="nope")
    assert ht.cluster.KMeans(init="batchparallel").init == "batchparallel"
    assert ht.cluster.KMeans(n_clusters=5).get_params()["n_clusters"] == 5


def test_cdist_matches_reference():
    data, init = _blobs(seed=11)
    for quad in (False, True):
        mine = ht.spatial.cdist(ht.array(data, split=0), ht.array(init), quadratic_expansion=quad)
        theirs = ref.spatial.cdist(ref.array(data, split=0), ref.array(init), quadratic_expansion=quad)
        assert mine.split == theirs.split == 0
        # the quadratic expansion cancels near 0, where the sqrt magnifies it
        atol = 1e-2 if quad else 1e-4
        np.testing.assert_allclose(mine.numpy(), theirs.numpy(), rtol=1e-4, atol=atol)
    # two row-split operands: the symmetric ring at the test mesh size
    mine = ht.spatial.cdist(ht.array(data, split=0))
    theirs = ref.spatial.cdist(ref.array(data, split=0))
    assert mine.split == theirs.split == 0
    np.testing.assert_allclose(mine.numpy(), theirs.numpy(), rtol=1e-4, atol=1e-4)


def test_draw_index_is_the_inverse_cdf_and_skips_zero_weights():
    """The kmeans++ draws pick the first row whose cumulative weight
    exceeds the uniform draw, over int64 fixed-point weights (an exact
    sum), and never a row of weight zero."""
    from heat_tpu_torch.cluster._kcluster import _draw_index

    rng = np.random.default_rng(11)
    w = rng.random(1_000)
    w[rng.random(1_000) < 0.3] = 0.0
    prob = torch.tensor(w / w.sum(), dtype=torch.float32)
    cum = np.cumsum(np.floor(prob.double().numpy() * 2.0**40))
    for r in rng.random(200).astype(np.float32):
        got = int(_draw_index(prob, torch.tensor(r)))
        assert got == int(np.searchsorted(cum, np.floor(float(r) * cum[-1]), side="right"))
        assert w[got] > 0.0
    assert int(_draw_index(torch.zeros(5), torch.tensor(0.5))) == 4
