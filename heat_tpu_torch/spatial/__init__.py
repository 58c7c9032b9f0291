"""Spatial algorithms (reference: heat/spatial)."""

from .distance import *
