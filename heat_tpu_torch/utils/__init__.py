"""Utilities (reference: heat/utils/__init__.py): interop with the JAX
package's models, checkpoints, and the data utilities."""

from . import checkpoint, data, interop
