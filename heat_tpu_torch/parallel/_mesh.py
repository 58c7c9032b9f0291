"""Named multi-axis meshes of torch devices (counterpart of
heat_tpu/parallel/__init__.py's ``make_mesh``)."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.communication import MeshCommunication, get_comm

__all__ = ["Mesh", "axis_comm", "make_mesh"]


class Mesh:
    """Torch devices laid out on named axes (counterpart of
    ``jax.sharding.Mesh``). A device may appear more than once, so several
    shards can share one card or the CPU.

    Parameters
    ----------
    devices : numpy.ndarray
        An object array of ``torch.device``, one axis per name.
    axis_names : sequence of str
    """

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim} device axes for the names {tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        """The size of each axis, by name."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def comms(self, axis: str) -> List[MeshCommunication]:
        """One communication context per line of the mesh along ``axis``:
        the shards that differ in ``axis`` alone, in row-major order of the
        other axes."""
        if axis not in self.axis_names:
            raise ValueError(f"mesh axes {self.axis_names} have no axis {axis!r}")
        lines = np.moveaxis(self.devices, self.axis_names.index(axis), -1)
        return [MeshCommunication(list(line)) for line in lines.reshape(-1, lines.shape[-1])]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {self.devices.flat[0].type})"


def make_mesh(
    axes: Sequence[Tuple[str, int]],
    devices: Optional[Sequence[Union[torch.device, str]]] = None,
) -> Mesh:
    """Build a named multi-axis mesh, e.g. ``make_mesh([("dp", 2), ("tp", 4)])``.

    Axis sizes must multiply to the device count. ``devices`` defaults to
    the default mesh's devices (every GPU; on the CPU the tests' mesh). Axis
    order fixes locality: later axes are nearest neighbours, so put 'tp'
    last.
    """
    devices = list(get_comm().devices if devices is None else devices)
    sizes = tuple(int(s) for _, s in axes)
    total = int(np.prod(sizes))
    if total != len(devices):
        raise ValueError(f"mesh axes {dict(axes)} need {total} devices, have {len(devices)}")
    grid = np.empty(len(devices), dtype=object)
    grid[:] = [torch.device(d) for d in devices]
    return Mesh(grid.reshape(sizes), [n for n, _ in axes])


def axis_comm(mesh: Union[Mesh, MeshCommunication], axis: str) -> MeshCommunication:
    """The first line of ``mesh`` along ``axis``; a MeshCommunication is a
    mesh of one axis and is its own line. The lines of a mesh compute the
    same replicated result, so one line stands for all of them."""
    return mesh if isinstance(mesh, MeshCommunication) else mesh.comms(axis)[0]
