"""Spatial algorithms (reference: heat/spatial): ``cdist``, ``manhattan``
and ``rbf``."""

from .distance import *
