"""Graph algorithms (reference: heat/graph/__init__.py)."""

from .laplacian import *
