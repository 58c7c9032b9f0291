"""Utilities."""

from . import interop
