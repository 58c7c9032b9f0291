"""heat_tpu_torch.ops.pairwise against heat_tpu.ops.pairwise (the Pallas
kernel in interpret mode), on the CPU, on the cases of
tests/test_ops_pallas.py.

On the CPU the wrapper runs the kernel's plain PyTorch version; the CUDA
kernel itself is held against that version on the card by chip_smoke.py.
Inputs are made with numpy from a seed. Tolerance: rtol = atol = 1e-5 in
float32, as tests/test_ops_pallas.py holds the Pallas kernel to its numpy
oracle: the same differences, squared or absolute, summed over f in
another order.
"""

import numpy as np
import pytest
import torch

import heat_tpu  # noqa: F401 - establishes the reference mesh
from heat_tpu.ops import pairwise as ref_pairwise
from heat_tpu_torch.ops import pairwise

TOL = dict(rtol=1e-5, atol=1e-5)


def _ref(x, y=None, **kwargs):
    return np.asarray(ref_pairwise.pairwise_distance(x, y, interpret=True, **kwargs))


@pytest.mark.parametrize("p", [1, 2])
def test_matches_pallas_interpret_on_ragged_shapes(p):
    rng = np.random.default_rng(0)
    # not multiples of the TPU kernel's 256-row tile or its 128 lanes
    x = rng.standard_normal((300, 7)).astype(np.float32)
    y = rng.standard_normal((130, 7)).astype(np.float32)
    got = pairwise.pairwise_distance(torch.from_numpy(x), torch.from_numpy(y), p=p)
    assert got.shape == (300, 130) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _ref(x, y, p=p), **TOL)


def test_self_distance_and_squared_match_pallas_interpret():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((64, 16)).astype(np.float32)
    d = pairwise.pairwise_distance(torch.from_numpy(x)).numpy()
    assert d.shape == (64, 64)
    np.testing.assert_allclose(d, _ref(x), **TOL)
    np.testing.assert_array_equal(np.diag(d), 0.0)
    d2 = pairwise.pairwise_distance(torch.from_numpy(x), squared=True).numpy()
    np.testing.assert_allclose(d2, _ref(x, squared=True), **TOL)
    np.testing.assert_allclose(d2, d * d, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize(
    "dtype,promoted", [(torch.float64, torch.float64), (torch.int32, torch.float32), (torch.bfloat16, torch.float32)]
)
def test_promotes_to_at_least_float32(dtype, promoted):
    x = torch.arange(12).reshape(4, 3).to(dtype)
    got = pairwise.pairwise_distance(x, p=1)
    assert got.dtype == promoted
    np.testing.assert_allclose(got.numpy(), _ref(x.float().numpy(), p=1), **TOL)


def test_gating():
    # the CPU is not a card, and wide features are refused everywhere
    assert not pairwise.pairwise_kernel_supported(10_000)
    assert not ref_pairwise.pallas_supported(10_000)
    with pytest.raises(ValueError):
        pairwise.pairwise_distance(torch.zeros(4, 4), p=3)
    with pytest.raises(ValueError):
        pairwise.pairwise_distance(torch.zeros(4, 7), torch.zeros(4, 9))
    with pytest.raises(ValueError):
        pairwise.pairwise_distance(torch.zeros(4, 600))
    with pytest.raises(ValueError):
        pairwise.pairwise_distance(torch.zeros(4))


def test_kernel_wrapper_writes_a_column_block_in_place():
    # the ring's use: a tile written through a leading dimension wider than m
    rng = np.random.default_rng(2)
    x = rng.standard_normal((37, 5))
    y = rng.standard_normal((11, 5))
    wide = torch.full((37, 40), -1.0, dtype=torch.float64)
    tile = wide[:, 13:24]
    got = pairwise.pairwise_kernel(torch.from_numpy(x), torch.from_numpy(y), 1, False, out=tile)
    assert got.data_ptr() == tile.data_ptr()
    np.testing.assert_allclose(wide[:, 13:24].numpy(), _ref(x, y, p=1), rtol=1e-12, atol=1e-12)
    assert (wide[:, :13] == -1).all() and (wide[:, 24:] == -1).all()


def test_plain_version_works_in_bounded_row_blocks(monkeypatch):
    # blocks of one row give the same result as one block
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((9, 4)))
    y = torch.from_numpy(rng.standard_normal((6, 4)))
    whole = pairwise.pairwise_plain(x, y, 2, True)
    monkeypatch.setattr(pairwise, "PLAIN_ELEMENTS", 1)
    torch.testing.assert_close(pairwise.pairwise_plain(x, y, 2, True), whole, rtol=0, atol=0)


def test_cpu_tensors_launch_no_kernel_and_other_checks_raise():
    before = pairwise.LAUNCHES
    pairwise.pairwise_kernel(torch.ones(3, 2), torch.zeros(4, 2))
    assert pairwise.LAUNCHES == before
    with pytest.raises(TypeError):
        pairwise.pairwise_kernel(torch.ones(3, 2), torch.ones(4, 2, dtype=torch.float64))
    with pytest.raises(ValueError):
        pairwise.pairwise_kernel(torch.ones(3, 2), torch.ones(4, 2), out=torch.empty(4, 3))
    with pytest.raises(ValueError):
        pairwise.pairwise_kernel(torch.ones(3, 2), torch.ones(4, 2), p=3)
    assert pairwise.pairwise_kernel(torch.ones(0, 2), torch.ones(4, 2)).shape == (0, 4)
    assert pairwise.pairwise_kernel(torch.ones(3, 2), torch.ones(0, 2)).shape == (3, 0)


def test_vector_access_needs_an_aligned_base_and_row_stride():
    # float32: 16 bytes are 4 elements
    assert pairwise.aligned16(0x1000, 64, 4)
    assert pairwise.aligned16(0x1000, 2000, 4)  # a column block at offset 1024 of a 2000-wide output
    assert not pairwise.aligned16(0x1000 + 650 * 4, 2000, 4)  # the block at offset 650
    assert not pairwise.aligned16(0x1000, 1305, 4)  # a row stride of 1305 elements
    assert not pairwise.aligned16(0x1004, 64, 4)
    # float64: 16 bytes are 2 elements
    assert pairwise.aligned16(0x1010, 34, 8)
    assert not pairwise.aligned16(0x1010, 33, 8)
    assert not pairwise.aligned16(0x1008, 34, 8)


def test_vector_access_of_real_views():
    wide = torch.empty(8, 2000)
    assert pairwise.aligned16(wide.data_ptr(), wide.stride(0), 4)
    for c0, aligned in ((650, False), (1024, True), (1, False), (4, True)):
        block = wide[:, c0:c0 + 100]
        assert pairwise.aligned16(block.data_ptr(), block.stride(0), 4) == aligned
    odd = torch.empty(8, 1305)[:, :1303]
    assert not pairwise.aligned16(odd.data_ptr(), odd.stride(0), 4)
