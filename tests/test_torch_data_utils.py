"""heat_tpu_torch.utils.data against heat_tpu's and numpy, with local arrays
and files only (test_long_tail_surface.py::TestDataUtilities). CPU only.

Shuffles must permute the rows of every array of a dataset alike; the
matrix gallery's matrices are held to their definitions (exact for the
Parter matrix, 1e-5 for the float32 products); the HDF5 streaming loader
and the TFRecord/npz converters must give heat_tpu's batches and files,
exactly.
"""

from __future__ import annotations

import importlib.util
import os
import struct

import numpy as np
import pytest
import torch

import heat_tpu as ref
import heat_tpu_torch as ht
from heat_tpu.utils.data import _utils as ref_utils
from heat_tpu_torch.core.communication import MeshCommunication
from heat_tpu_torch.utils.data import (
    DataLoader,
    Dataset,
    PartialH5DataLoaderIter,
    PartialH5Dataset,
    dataset_irecv,
    dataset_ishuffle,
    dataset_shuffle,
    hermitian,
    parter,
    random_known_rank,
)
from heat_tpu_torch.utils.data import _utils
from test_torch_parity import on_cpu  # noqa: F401

SEED = 20261017


def _mesh(p):
    return MeshCommunication([torch.device("cpu")] * p)


@pytest.mark.parametrize("p", [1, 3, 5])
@pytest.mark.parametrize("shuffle", [dataset_shuffle, dataset_ishuffle])
def test_shuffle_permutes_the_rows_of_every_array_alike(shuffle, p):
    ht.random.seed(3)
    data = ht.arange(26, split=0, comm=_mesh(p)).reshape((13, 2))
    labels = ht.arange(13, split=0, comm=_mesh(p))
    ds = Dataset([data, labels])
    shuffle(ds)
    dataset_irecv(ds)
    x, y = ds.arrays[0].numpy(), ds.arrays[1].numpy()
    assert sorted(map(tuple, x.tolist())) == [(2 * i, 2 * i + 1) for i in range(13)]
    np.testing.assert_array_equal(x[:, 0] // 2, y)  # rows and labels moved together
    assert not np.array_equal(y, np.arange(13))
    assert ds.arrays[0].split == 0 and ds.arrays[0].gshape == (13, 2)


def test_dataset_and_loader_contract():
    x = ht.arange(20, dtype=ht.float32).reshape((10, 2))
    ds = Dataset(x, transform=lambda t: t * 2)
    assert len(ds) == 10 and torch.equal(ds[3], torch.tensor([12.0, 14.0]))
    with pytest.raises(ValueError):
        Dataset([x, ht.arange(9)])
    loader = DataLoader(ds, batch_size=4)
    assert len(loader) == 2 and [b.shape[0] for b in loader] == [4, 4]
    loader = DataLoader(lcl_dataset=x, batch_size=4, drop_last=False)
    assert len(loader) == 3 and [b.shape[0] for b in loader] == [4, 4, 2]
    shuffled = DataLoader(Dataset([ht.arange(12), ht.arange(12) * 10]), batch_size=5, shuffle=True)
    for a, b in shuffled:
        torch.testing.assert_close(b, a * 10)
    with pytest.raises(TypeError):
        DataLoader(np.zeros(3))
    with pytest.raises(ValueError):
        DataLoader(ds, batch_size=0)


@pytest.mark.parametrize("split", [None, 0, 1])
def test_matrix_gallery(split):
    n = 12
    a = parter(n, split=split)
    i = np.arange(n, dtype=np.float32)
    np.testing.assert_array_equal(a.numpy(), 1.0 / (i[:, None] - i[None, :] + 0.5))
    np.testing.assert_array_equal(a.numpy(), np.asarray(ref.utils.data.parter(n, split=split).numpy()))
    assert a.split == split
    # the Parter matrix's singular values cluster at pi
    s = np.linalg.svd(a.numpy().astype(np.float64), compute_uv=False)
    assert np.sum(np.abs(s - np.pi) < 1e-2) >= n // 2
    h = hermitian(n, split=split).numpy()
    assert h.dtype == np.complex64
    np.testing.assert_allclose(h, h.conj().T, rtol=0, atol=0)
    hp = hermitian(n, split=split, dtype=ht.float64, positive_definite=True).numpy()
    np.testing.assert_allclose(hp, hp.T, rtol=1e-12)
    assert np.linalg.eigvalsh(hp).min() > 0
    m, (u, v) = random_known_rank(9, 7, 3, split=split)
    assert m.gshape == (9, 7) and np.linalg.matrix_rank(m.numpy().astype(np.float64), tol=1e-4) == 3
    np.testing.assert_allclose(m.numpy(), u.numpy() @ v.numpy().T, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        random_known_rank(3, 3, 4)


def _h5(path, n=23):
    import h5py

    rng = np.random.default_rng(SEED)
    with h5py.File(path, "w") as f:
        f["data"] = rng.standard_normal((n, 3)).astype(np.float32)
        f["labels"] = np.arange(n, dtype=np.int64)


@pytest.mark.parametrize("shuffle", [False, True])
def test_partial_h5_loader_gives_heat_tpus_batches(shuffle, tmp_path):
    path = str(tmp_path / "d.h5")
    _h5(path)
    mine = PartialH5Dataset(path, dataset_names=["data", "labels"], initial_load=10, transforms=[None, lambda y: y * 2])
    theirs = ref.utils.data.PartialH5Dataset(path, dataset_names=["data", "labels"], initial_load=10, transforms=[None, lambda y: y * 2])
    assert len(mine) == len(theirs) == 23
    got = list(PartialH5DataLoaderIter(mine, batch_size=4, shuffle=shuffle, seed=1))
    want = list(ref.utils.data.PartialH5DataLoaderIter(theirs, batch_size=4, shuffle=shuffle, seed=1))
    assert len(got) == len(want) == 4  # two per window of 10 rows, none of the 3 left
    for (x, y), (xr, yr) in zip(got, want):
        np.testing.assert_array_equal(x, xr)
        np.testing.assert_array_equal(y, yr)
    with pytest.raises(TypeError):
        iter(mine)


def _tfrecord(path, payloads):
    with open(path, "wb") as f:
        for payload in payloads:
            f.write(struct.pack("<Q", len(payload)) + b"\0" * 4 + payload + b"\0" * 4)


def test_tfrecord_index_and_npz_merge_match_heat_tpu(tmp_path):
    for name in ("train", "val"):
        (tmp_path / name).mkdir()
        _tfrecord(tmp_path / name / "shard-0", [b"abc", b"", b"x" * 17])
    for pkg, out in ((_utils, "mine"), (ref_utils, "ref")):
        pkg.dali_tfrecord2idx(str(tmp_path / "train"), str(tmp_path / out / "ti"), str(tmp_path / "val"), str(tmp_path / out / "vi"))
    for sub in ("ti", "vi"):
        mine = (tmp_path / "mine" / sub / "shard-0").read_text()
        assert mine == (tmp_path / "ref" / sub / "shard-0").read_text()
        assert mine.splitlines() == ["0 19", "19 16", "35 33"]
    _tfrecord(tmp_path / "bad", [b"abcd"])
    with open(tmp_path / "bad", "rb+") as f:
        f.truncate(10)
    with pytest.raises(ValueError):
        list(_utils._iter_tfrecord_offsets(str(tmp_path / "bad")))
    shards = tmp_path / "npz"
    shards.mkdir()
    rng = np.random.default_rng(SEED)
    for i in range(2):
        np.savez(shards / f"train-{i}.npz", images=rng.integers(0, 255, (3, 2, 2), dtype=np.uint8), labels=np.arange(3) + i)
    np.savez(shards / "val-0.npz", images=np.zeros((2, 2, 2), np.uint8), labels=np.arange(2))
    _utils.merge_files_imagenet_tfrecord(str(shards), str(tmp_path / "mine_h5"))
    ref_utils.merge_files_imagenet_tfrecord(str(shards), str(tmp_path / "ref_h5"))
    import h5py

    for name in ("imagenet_merged.h5", "imagenet_merged_validation.h5"):
        with h5py.File(tmp_path / "mine_h5" / name) as a, h5py.File(tmp_path / "ref_h5" / name) as b:
            for key in ("images", "metadata"):
                np.testing.assert_array_equal(a[key][...], b[key][...])
    with pytest.raises((FileNotFoundError, OSError, ValueError, NotImplementedError)):
        _utils.merge_files_imagenet_tfrecord("/nonexistent/path", str(tmp_path / "out"))


def test_mnist_dataset_contract(tmp_path):
    from heat_tpu_torch.utils.data.mnist import MNISTDataset

    assert issubclass(MNISTDataset, Dataset) and ht.utils.data.MNISTDataset is MNISTDataset
    if importlib.util.find_spec("torchvision") is None:
        with pytest.raises(ImportError):  # the optional dependency, asked for only here
            MNISTDataset(str(tmp_path))
    assert not os.listdir(tmp_path)
