"""Mathematical constants (reference: heat/core/constants.py)."""

import math

INF = float("inf")
NAN = float("nan")
NINF = -float("inf")
PI = math.pi
E = math.e

inf = INF
nan = NAN
pi = PI
e = E

# capitalized aliases (reference constants.py:7,26,38)
Inf = INF
Infty = INF
Infinity = INF
NaN = NAN
Euler = E

__all__ = [
    "e",
    "Euler",
    "inf",
    "Inf",
    "Infty",
    "Infinity",
    "nan",
    "NaN",
    "pi",
    "E",
    "INF",
    "NAN",
    "NINF",
    "PI",
]
