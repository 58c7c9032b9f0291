"""The distributed array and its runtime (reference: heat/core)."""

from . import version
from .version import __version__
from . import telemetry
from . import resilience
from . import memledger
from . import health_runtime
from . import fusion
from .resilience import errstate
from .constants import *
from .types import *
from .devices import *
from .communication import *
from .dndarray import *
from .factories import *
from .memory import *
from .base import *
from .sanitation import *
from .stride_tricks import *
from .arithmetics import *
from .relational import *
from .logical import *
from .rounding import *
from .exponential import *
from .trigonometrics import *
from .complex_math import *
from .statistics import *
from .manipulations import *
from .indexing import *
from .printing import *
from .tiling import *
from .io import *
from .signal import *
from . import linalg
from .linalg import *
from . import io, printing, random, signal, tiling
