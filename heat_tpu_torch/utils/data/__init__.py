"""Data-loading utilities (reference: heat/utils/data/__init__.py,
heat_tpu/utils/data/__init__.py)."""

from . import _utils, datatools, matrixgallery, partial_dataset
from .datatools import *
from .matrixgallery import *
from .partial_dataset import *

try:  # the MNIST dataset needs torchvision, which is optional (reference mnist.py)
    from .mnist import MNISTDataset
except ImportError:  # pragma: no cover - the module itself imports; torchvision loads on use
    MNISTDataset = None
