"""Dataset and DataLoader (reference: heat/utils/data/datatools.py,
heat_tpu/utils/data/datatools.py).

The reference keeps each rank's shard in memory and reshuffles between
epochs by exchanging half-shards (datatools.py:246-343). Here, as in
heat_tpu, a dataset holds global DNDarrays and a shuffle is one global
permutation of their rows, drawn from the port's generator; batches are
tensors on the mesh's first device.
"""

from __future__ import annotations

from typing import Iterator

import torch

from ...core import random as ht_random
from ...core.dndarray import DNDarray

__all__ = ["DataLoader", "Dataset", "dataset_shuffle", "dataset_ishuffle", "dataset_irecv"]


class Dataset:
    """An in-memory dataset of one or more arrays aligned along their
    first axis (reference datatools.py:30-148).

    Parameters
    ----------
    array : DNDarray or sequence of DNDarray
        The data (and labels, ...).
    transform : callable, optional
        Applied to the first array's item.
    ishuffle : bool
        Kept for the reference's signature; the DataLoader shuffles.
    """

    def __init__(self, array, transform=None, ishuffle: bool = False, test_set=None):
        self.arrays = [array] if isinstance(array, DNDarray) else list(array)
        n = self.arrays[0].shape[0]
        for a in self.arrays[1:]:
            if a.shape[0] != n:
                raise ValueError("all arrays must have the same first dimension")
        self.transform = transform
        self.ishuffle = ishuffle
        self.test_set = test_set

    def __len__(self) -> int:
        return self.arrays[0].shape[0]

    def __getitem__(self, index):
        items = [a.larray[index] for a in self.arrays]
        if self.transform is not None:
            items[0] = self.transform(items[0])
        return items[0] if len(items) == 1 else tuple(items)

    def shuffle(self) -> None:
        """One random permutation of the rows of every array (reference
        datatools.py:246-297)."""
        first = self.arrays[0]
        perm = ht_random.randperm(len(self), device=first.device, comm=first.comm).larray
        for a in self.arrays:
            a.larray = a.larray[perm.to(a.larray.device)]

    def ishuffle_(self) -> None:
        """The reference's non-blocking shuffle (:298-343): the same
        permutation, as torch's launches are asynchronous already."""
        self.shuffle()


class DataLoader:
    """An iterator of batches (reference datatools.py:149-245).

    Parameters
    ----------
    dataset : Dataset or DNDarray
    batch_size : int
    shuffle : bool
        Reshuffle at the start of every epoch.
    drop_last : bool
        Drop the trailing short batch.
    """

    def __init__(self, dataset=None, batch_size: int = 1, shuffle: bool = False, drop_last: bool = True, lcl_dataset=None):
        if dataset is None and lcl_dataset is not None:
            dataset = lcl_dataset
        if isinstance(dataset, DNDarray):
            dataset = Dataset(dataset)
        if not isinstance(dataset, Dataset):
            raise TypeError(f"dataset must be a Dataset or DNDarray, got {type(dataset)}")
        if batch_size < 1:
            raise ValueError(f"batch_size must be positive, got {batch_size}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator:
        if self.shuffle:
            self.dataset.shuffle()
        n, bs = len(self.dataset), self.batch_size
        stop = (n // bs) * bs if self.drop_last else n
        for start in range(0, stop, bs):
            yield self.dataset[start : min(start + bs, n)]


def dataset_shuffle(dataset: Dataset, attrs=None) -> None:
    """Module-level shuffle hook (reference datatools.py:246-297)."""
    dataset.shuffle()


def dataset_ishuffle(dataset: Dataset, attrs=None) -> None:
    """Non-blocking shuffle hook (reference datatools.py:298-343)."""
    dataset.ishuffle_()


def dataset_irecv(dataset: Dataset, attrs=None) -> None:
    """Completion hook of the non-blocking shuffle (reference
    datatools.py:344-392): waits until the shuffled shards are written."""
    for a in dataset.arrays:
        for shard in a.shards:
            if shard.is_cuda:
                torch.cuda.synchronize(shard.device)
