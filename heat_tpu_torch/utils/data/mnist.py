"""MNIST as a Dataset (reference: heat/utils/data/mnist.py:16-127,
heat_tpu/utils/data/mnist.py).

The reference subclasses torchvision's MNIST. torchvision is optional: it
is imported when a dataset is made, and downloads the data then.
"""

from __future__ import annotations

import numpy as np

from ...core import factories
from .datatools import Dataset

__all__ = ["MNISTDataset"]


class MNISTDataset(Dataset):
    """MNIST images (float32 in [0, 1]) and int32 labels as a Dataset
    (reference mnist.py:16-127).

    Parameters
    ----------
    root : str
        Download and cache directory.
    train : bool
    transform : callable, optional
    split : int or None
        The split of the image and label arrays.
    """

    def __init__(self, root: str, train: bool = True, transform=None, target_transform=None, split=0):
        from torchvision import datasets as tv_datasets  # optional dependency, needed only here

        base = tv_datasets.MNIST(root, train=train, download=True)
        images = np.asarray(base.data.numpy(), dtype=np.float32) / 255.0
        labels = np.asarray(base.targets.numpy(), dtype=np.int32)
        super().__init__([factories.array(images, split=split), factories.array(labels, split=split)], transform=transform)
        self.train = train
