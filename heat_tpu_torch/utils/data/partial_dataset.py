"""Out-of-core HDF5 streaming dataset (reference: heat/utils/data/partial_dataset.py,
heat_tpu/utils/data/partial_dataset.py).

The reference's ``PartialH5Dataset`` (partial_dataset.py:32-230) keeps only a
window of a large HDF5 file in memory, with background threads loading and
converting the next window while the current one trains. Here the same
double-buffering uses a single loader thread (h5py releases the GIL for I/O)
and batches come back as numpy arrays.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, List, Optional

import numpy as np

__all__ = ["PartialH5Dataset", "PartialH5DataLoaderIter", "queue_thread"]


def queue_thread(q: "queue.Queue") -> threading.Thread:
    """Spawn a daemon worker draining work items from ``q`` until a ``None``
    sentinel (the reference's background load/convert thread pool primitive,
    reference partial_dataset.py:20-31). An item is a bare callable or a
    ``(fn, *args)`` tuple. ``task_done`` is guaranteed per item so ``q.join()``
    cannot deadlock on a raising work function."""

    def worker():
        while True:
            item = q.get()
            try:
                if item is None:
                    return
                if callable(item):
                    item()
                else:
                    fn, *args = item
                    # allow both (fn, (a, b)) and (fn, a, b)
                    if len(args) == 1 and isinstance(args[0], tuple):
                        args = args[0]
                    fn(*args)
            except Exception:  # noqa: BLE001 - background worker must survive
                import traceback

                traceback.print_exc()
            finally:
                q.task_done()

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    return t


class PartialH5Dataset:
    """Windowed loader over one or more datasets of an HDF5 file
    (reference partial_dataset.py:32-142).

    Parameters
    ----------
    file : str
        HDF5 path.
    comm : unused, kept for parity.
    dataset_names : list of str
        Names of the HDF5 datasets to stream (first axes aligned).
    initial_load : int
        Window size (number of rows held in memory).
    load_length : int
        Rows loaded per background refill.
    transforms : callable or list, optional
    use_gpu : bool
        Parity flag; placement is mesh-driven.
    """

    def __init__(
        self,
        file: str,
        comm=None,
        dataset_names="data",
        transforms=None,
        use_gpu: bool = True,
        validate_set: bool = False,
        initial_load: int = 7000,
        load_length: int = 1000,
    ):
        import h5py

        self.file = file
        self.dataset_names = (
            [dataset_names] if isinstance(dataset_names, str) else list(dataset_names)
        )
        self.transforms = transforms if isinstance(transforms, (list, tuple)) else (
            [transforms] if transforms is not None else None
        )
        self.initial_load = initial_load
        self.load_length = load_length
        with h5py.File(file, "r") as handle:
            self.total_size = handle[self.dataset_names[0]].shape[0]
        self.length = self.total_size

    def __len__(self) -> int:
        return self.length

    def __iter__(self):
        raise TypeError("iterate via PartialH5DataLoaderIter")


class PartialH5DataLoaderIter:
    """Batched iterator with a background prefetch thread
    (reference partial_dataset.py:143-230)."""

    def __init__(self, dataset: PartialH5Dataset, batch_size: int, shuffle: bool = True, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed

    def __len__(self) -> int:
        return len(self.dataset) // self.batch_size

    def __iter__(self) -> Iterator[List[np.ndarray]]:
        import h5py

        ds = self.dataset
        window = ds.initial_load
        q: "queue.Queue" = queue.Queue(maxsize=2)

        def loader():
            with h5py.File(ds.file, "r") as handle:
                handles = [handle[name] for name in ds.dataset_names]
                for start in range(0, ds.total_size, window):
                    stop = min(start + window, ds.total_size)
                    q.put([np.asarray(h[start:stop]) for h in handles])
            q.put(None)

        t = threading.Thread(target=loader, daemon=True)
        t.start()

        rng = np.random.default_rng(self.seed)
        while True:
            chunk = q.get()
            if chunk is None:
                break
            n = chunk[0].shape[0]
            order = rng.permutation(n) if self.shuffle else np.arange(n)
            for bstart in range(0, n - self.batch_size + 1, self.batch_size):
                idx = order[bstart : bstart + self.batch_size]
                batch = [c[idx] for c in chunk]
                if ds.transforms is not None:
                    batch = [
                        (tf(b) if tf is not None else b)
                        for tf, b in zip(ds.transforms, batch)
                    ]
                yield batch if len(batch) > 1 else batch[0]
        t.join()
