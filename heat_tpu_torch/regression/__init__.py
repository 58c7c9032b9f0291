"""Regression (reference: heat/regression/__init__.py)."""

from .lasso import *
