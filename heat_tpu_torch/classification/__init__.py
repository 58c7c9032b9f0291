"""Classification (reference: heat/classification/__init__.py)."""

from .kneighborsclassifier import *
