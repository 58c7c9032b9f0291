"""Utilities (reference: heat/utils/__init__.py): interop with the JAX
package's models, checkpoints, the data utilities, mesh health and
profiling."""

from . import checkpoint, data, health, interop, profiling
