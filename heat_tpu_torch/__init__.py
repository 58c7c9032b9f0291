"""heat_tpu_torch — the PyTorch/CUDA port of heat_tpu.

The same distributed n-dimensional array with a single ``split`` axis and
the same estimators, on torch tensors, with the kernels hand-written in CUDA
for NVIDIA Hopper. Arrays live on the GPU unless the caller asks for the CPU
(``use_device("cpu")``). The JAX package ``heat_tpu`` is the reference it is
tested against.
"""

from .core import *
from .core import linalg, random
from . import (
    classification, cluster, datasets, graph, naive_bayes, nn, ops, optim, parallel, regression, spatial, utils,
)
from .utils import checkpoint  # ht.checkpoint, as heat_tpu/__init__.py:12 exports it
from .core import health_runtime as flight  # ht.flight, as heat_tpu/__init__.py:52 exports it
from .core import (
    arithmetics,
    base,
    communication,
    complex_math,
    constants,
    devices,
    exponential,
    factories,
    indexing,
    io,
    logical,
    manipulations,
    memory,
    numlens,
    printing,
    relational,
    resilience,
    rounding,
    sanitation,
    serving,
    signal,
    statistics,
    stride_tricks,
    telemetry,
    tiling,
    trigonometrics,
    types,
    version,
)
from .core.version import __version__


def _bind_dndarray_methods():
    """Bind the operator library onto DNDarray as methods: ``x.sum()`` as
    well as ``ht.sum(x)`` (the reference's list, heat_tpu/__init__.py:56-97,
    as far as it is ported)."""
    from .core.dndarray import DNDarray

    sources = {
        arithmetics: [
            "add", "sub", "mul", "div", "pow", "fmod", "mod", "cumsum", "cumprod",
            "prod", "sum", "nansum", "nanprod", "diff",
        ],
        rounding: ["abs", "ceil", "clip", "fabs", "floor", "modf", "round", "trunc", "sign", "sgn"],
        exponential: ["exp", "expm1", "exp2", "log", "log2", "log10", "log1p", "sqrt", "square"],
        trigonometrics: [
            "sin", "cos", "tan", "sinh", "cosh", "tanh", "arcsin", "arccos", "arctan",
            "arcsinh", "arccosh", "arctanh",
        ],
        logical: ["all", "any", "allclose", "isclose"],
        statistics: [
            "argmax", "argmin", "average", "max", "mean", "median", "min", "percentile",
            "std", "var", "kurtosis", "skew",
        ],
        manipulations: [
            "expand_dims", "flatten", "ravel", "reshape", "resplit", "squeeze", "unique",
            "flip", "roll", "repeat", "tile", "moveaxis", "swapaxes", "collect",
            "balance", "redistribute", "rot90",
        ],
        complex_math: ["conj"],
        indexing: ["nonzero"],
        io: ["save", "save_hdf5", "save_netcdf", "save_csv"],
        memory: ["copy"],
        linalg: ["transpose", "tril", "triu", "dot", "qr"],
    }
    for module, names in sources.items():
        for name in names:
            if not hasattr(DNDarray, name):
                setattr(DNDarray, name, getattr(module, name))


_bind_dndarray_methods()
del _bind_dndarray_methods
