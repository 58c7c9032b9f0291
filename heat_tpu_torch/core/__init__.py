"""The distributed array and its runtime (reference: heat/core)."""

from .constants import *
from .types import *
from .devices import *
from .communication import *
from .dndarray import *
from .factories import *
from .base import *
from .sanitation import *
from .stride_tricks import *
from . import random
