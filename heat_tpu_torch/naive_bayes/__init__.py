"""Naive Bayes (reference: heat/naive_bayes/__init__.py)."""

from .gaussianNB import *
