"""heat_tpu_torch.ops.lloyd against heat_tpu.ops.lloyd (Pallas kernel in
interpret mode) and heat_tpu.cluster.kmeans._lloyd_iter, on the CPU.

On the CPU the wrapper runs the kernel's plain PyTorch version; the CUDA
kernel itself is held against that version on the card by chip_smoke.py.
Inputs are float32, made with numpy from a seed; the tolerances are those
of tests/test_lloyd_fused.py: labels equal, centers rtol/atol 1e-5,
inertia rtol 1e-4 (the same arithmetic, summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import heat_tpu as ref
import heat_tpu_torch as ht
from heat_tpu.cluster.kmeans import _lloyd_iter as ref_lloyd_iter
from heat_tpu.cluster.kmeans import _lloyd_run as ref_lloyd_run
from heat_tpu.ops import lloyd as ref_lloyd
from heat_tpu_torch.cluster.kmeans import _lloyd_iter, _lloyd_run
from heat_tpu_torch.ops import lloyd

SHAPES = [(8192, 16, 8), (5000, 16, 8), (300, 4, 3), (2048, 64, 17)]


@pytest.fixture(autouse=True)
def _on_cpu():
    ht.use_device("cpu")
    yield
    ht.use_device(None)


def _inputs(n, f, k, seed):
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((n, f)).astype(np.float32)
    centers = (rng.standard_normal((k, f)) * 2).astype(np.float32)
    return data, centers


def _assert_iter_close(got, want):
    c, labels, inertia, shift = got
    np.testing.assert_array_equal(labels.numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(c.numpy(), np.asarray(want[0]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(inertia), float(want[2]), rtol=1e-4)
    np.testing.assert_allclose(float(shift), float(want[3]), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("n,f,k", SHAPES)
def test_fused_iter_matches_pallas_interpret_and_jnp_oracle(n, f, k):
    data, centers = _inputs(n, f, k, seed=n + f + k)
    got = lloyd.fused_lloyd_iter(torch.from_numpy(data), torch.from_numpy(centers), k)
    pallas = ref_lloyd.fused_lloyd_iter(jnp.asarray(data), jnp.asarray(centers), k, interpret=True)
    oracle = jax.jit(ref_lloyd_iter, static_argnames="k")(jnp.asarray(data), jnp.asarray(centers), k)
    _assert_iter_close(got, pallas)
    _assert_iter_close(got, oracle)


@pytest.mark.parametrize("n,f,k", SHAPES)
def test_plain_accumulators_match_pallas_kernel_with_poisoned_padding(n, f, k):
    data, centers = _inputs(n, f, k, seed=7 * n + k)
    pad = np.full((37, f), np.nan, np.float32)
    pad[::2] = np.inf
    poisoned = np.concatenate([data, pad])
    sums, counts, inertia, labels = lloyd.lloyd_accumulate(
        torch.from_numpy(poisoned), torch.from_numpy(centers), n, return_labels=True
    )
    sumsT, r_counts, r_inertia = ref_lloyd._kernel_call(
        jnp.asarray(poisoned), jnp.asarray(centers), k, jnp.asarray(n, jnp.int32), True
    )
    assert torch.isfinite(sums).all() and torch.isfinite(inertia)
    assert counts.sum().item() == n
    np.testing.assert_array_equal(counts.numpy(), np.asarray(r_counts)[:, 0])
    np.testing.assert_allclose(sums.numpy(), np.asarray(sumsT).T, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(float(inertia), float(r_inertia[0, 0]), rtol=1e-4)
    oracle_labels = np.asarray(jax.jit(ref_lloyd_iter, static_argnames="k")(
        jnp.asarray(data), jnp.asarray(centers), k)[1])
    np.testing.assert_array_equal(labels.numpy(), oracle_labels)


def test_fused_run_matches_pallas_interpret_and_jnp_oracle():
    data, centers = _inputs(4096, 8, 5, seed=4)
    got = lloyd.fused_lloyd_run(torch.from_numpy(data), torch.from_numpy(centers), 5, 4)
    pallas = ref_lloyd.fused_lloyd_run(jnp.asarray(data), jnp.asarray(centers), 5, 4, interpret=True)
    oracle = ref_lloyd_run(jnp.asarray(data), jnp.asarray(centers), 5, 4)
    for want in (pallas, oracle):
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=1e-4)


@pytest.mark.parametrize("n", [4 * 8 + 3, 203, 64])
def test_sharded_run_matches_pallas_sharded_at_mesh_size(n):
    f, k, steps = 6, 4, 3
    data, centers = _inputs(n, f, k, seed=n)
    mine = ht.array(data, split=0)
    theirs = ref.array(data, split=0)
    assert mine.comm.size == theirs.comm.size
    assert tuple(mine.parray.shape) == tuple(theirs.parray.shape)
    got = lloyd.fused_lloyd_run_sharded(
        mine.shards, torch.from_numpy(centers), k, mine.comm, n, steps
    )
    want = ref_lloyd.fused_lloyd_run_sharded(
        theirs.parray, jnp.asarray(centers), k, theirs.comm, n, steps, interpret=True
    )
    assert got[1].shape == (n,)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=1e-4)
    np.testing.assert_allclose(float(got[3]), float(want[3]), rtol=1e-4, atol=1e-6)


def test_bf16_stream_matches_pallas_bf16():
    data, centers = _inputs(4096, 16, 4, seed=11)
    x16 = torch.from_numpy(data).bfloat16()
    got = lloyd.fused_lloyd_run(x16, torch.from_numpy(centers), 4, 2)
    want = ref_lloyd.fused_lloyd_run(
        jnp.asarray(data).astype(jnp.bfloat16), jnp.asarray(centers), 4, 2, interpret=True
    )
    # products of bf16 values are exact in f32: only the order of the sums differs
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=1e-4)
    # labels agree with the counts the accumulation produced
    _, counts, _, labels = lloyd.lloyd_accumulate(x16, got[0], 4096, return_labels=True)
    np.testing.assert_array_equal(np.bincount(labels.numpy(), minlength=4), counts.numpy())


def test_empty_cluster_keeps_center():
    data = torch.zeros(128, 2)
    centers = torch.tensor([[0.0, 0.0], [100.0, 100.0]])
    new_c, labels, _, _ = lloyd.fused_lloyd_iter(data, centers, 2)
    assert (labels == 0).all()
    torch.testing.assert_close(new_c[1], centers[1])


def test_tie_goes_to_lowest_index():
    data = torch.tensor([[1.0, 0.0], [0.0, 0.0]])
    centers = torch.tensor([[0.0, 1.0], [1.0, 0.0], [0.0, 1.0], [1.0, 0.0]])
    _, counts, _, labels = lloyd.lloyd_accumulate(data, centers, 2, return_labels=True)
    assert labels.tolist() == [1, 0]
    assert counts.tolist() == [1.0, 1.0, 0.0, 0.0]


@pytest.mark.parametrize("n,f,k", SHAPES[:2])
def test_torch_oracle_matches_jnp_oracle(n, f, k):
    data, centers = _inputs(n, f, k, seed=3)
    got = _lloyd_iter(torch.from_numpy(data), torch.from_numpy(centers), k)
    want = jax.jit(ref_lloyd_iter, static_argnames="k")(jnp.asarray(data), jnp.asarray(centers), k)
    _assert_iter_close(got, want)
    run = _lloyd_run(torch.from_numpy(data), torch.from_numpy(centers), k, 3)
    want_run = ref_lloyd_run(jnp.asarray(data), jnp.asarray(centers), k, 3)
    np.testing.assert_allclose(run[0].numpy(), np.asarray(want_run[0]), rtol=1e-4, atol=1e-4)


def test_wrapper_checks_and_cpu_dispatch():
    data, centers = (torch.from_numpy(a) for a in _inputs(100, 4, 3, seed=1))
    before = lloyd.LAUNCHES
    got = lloyd.lloyd_accumulate(data, centers, 90)
    plain = lloyd.lloyd_accumulate_plain(data, centers, 90)
    for a, b in zip(got, plain):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert lloyd.LAUNCHES == before  # the plain version is no launch
    with pytest.raises(TypeError):
        lloyd.lloyd_accumulate(data.double(), centers, 100)
    with pytest.raises(TypeError):
        lloyd.lloyd_accumulate(data, centers.double(), 100)
    with pytest.raises(ValueError):
        lloyd.lloyd_accumulate(data.T.contiguous().T, centers, 100)
    with pytest.raises(ValueError):
        lloyd.lloyd_accumulate(data, centers, 101)
    with pytest.raises(ValueError):
        lloyd.lloyd_accumulate(torch.zeros(4, 513), torch.zeros(2, 513), 4)
    with pytest.raises(ValueError):
        lloyd.lloyd_accumulate(torch.zeros(4, 2), torch.zeros(129, 2), 4)
    assert lloyd.fused_supported(512, 128) and not lloyd.fused_supported(513, 8)


def test_kernel_source_is_shipped_and_not_built_on_import():
    from heat_tpu_torch.ops import _build

    assert (_build.SOURCE_DIR / "lloyd.cu").is_file()
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)
    assert "lloyd" not in _build._LOADED


@pytest.mark.parametrize("p", [3, 5])
@pytest.mark.parametrize("rows", ["ragged", "even"])
def test_c21_fused_iter_sharded_keeps_the_reference_contract(p, rows):
    """C21: ``ops.lloyd.fused_lloyd_iter_sharded`` is one step of the fused
    sharded run, with heat_tpu's return contract (tests/test_lloyd_fused.py:78,
    :198, :267): new centers, labels of the n_global logical rows against
    the input centers, inertia and shift, held against the reference's
    Pallas kernel in interpret mode on a mesh of the same size."""
    from heat_tpu.core.communication import MeshCommunication as RefMesh

    if len(jax.devices()) < p:
        pytest.skip(f"the reference's CPU mesh has {len(jax.devices())} devices")
    n = 4 * p + 3 if rows == "ragged" else 8 * p
    f, k = (6, 4) if rows == "ragged" else (5, 3)
    data, centers = _inputs(n, f, k, seed=7 + p)
    mine = ht.array(data, split=0, comm=ht.communication.MeshCommunication([torch.device("cpu")] * p))
    theirs = ref.array(data, split=0, comm=RefMesh(jax.devices()[:p]))
    got = lloyd.fused_lloyd_iter_sharded(mine.shards, torch.from_numpy(centers), k, mine.comm, n)
    want = ref_lloyd.fused_lloyd_iter_sharded(theirs.parray, jnp.asarray(centers), k, theirs.comm, n, interpret=True)
    assert got[1].shape == (n,)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1])[:n])
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=1e-4)
    np.testing.assert_allclose(float(got[3]), float(want[3]), rtol=1e-4, atol=1e-6)
    assert ht.ops.fused_lloyd_iter_sharded is lloyd.fused_lloyd_iter_sharded
    assert (ht.ops.fused_lloyd_iter, ht.ops.fused_lloyd_run) == (lloyd.fused_lloyd_iter, lloyd.fused_lloyd_run)
