"""Distributed clustering (reference: heat/cluster/__init__.py)."""

from .kmeans import *
