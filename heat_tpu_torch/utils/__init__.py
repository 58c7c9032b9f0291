"""Utilities (reference: heat/utils/__init__.py): interop with the JAX
package's models, checkpoints, the data utilities and profiling."""

from . import checkpoint, data, interop, profiling
