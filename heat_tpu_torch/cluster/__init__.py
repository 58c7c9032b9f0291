"""Distributed clustering (reference: heat/cluster/__init__.py)."""

from .kmeans import *
from .kmedians import *
from .kmedoids import *
from .spectral import *
