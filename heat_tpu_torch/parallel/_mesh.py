"""Named multi-axis meshes of torch devices, or of the ranks of a mesh whose
ranks span processes (counterpart of heat_tpu/parallel/__init__.py's
``make_mesh``)."""

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

    Over a mesh whose ranks span processes (``comm``), no process holds
    every device: the entries are then ``comm``'s global ranks, and a line
    is ``comm.sub`` of its ranks, in-process where its ranks are this
    process's, over a process group where they span processes.

    Parameters
    ----------
    devices : numpy.ndarray
        An object array of ``torch.device``, or an integer array of
        ``comm``'s ranks, one axis per name.
    axis_names : sequence of str
    comm : MeshCommunication, optional
        The mesh whose ranks ``devices`` holds.
    """

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str], comm: Optional[MeshCommunication] = None):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim} device axes for the names {tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.comm = comm

    @property
    def shape(self) -> Dict[str, int]:
        """The size of each axis, by name."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def lines(self, axis: str) -> np.ndarray:
        """The entries of each line along ``axis``, one row per line: the
        entries that differ in ``axis`` alone, in row-major order of the
        other axes."""
        if axis not in self.axis_names:
            raise ValueError(f"mesh axes {self.axis_names} have no axis {axis!r}")
        lines = np.moveaxis(self.devices, self.axis_names.index(axis), -1)
        return lines.reshape(-1, lines.shape[-1])

    def comms(self, axis: str) -> List[MeshCommunication]:
        """One communication context per line of the mesh along ``axis``.
        Over ranks, every process builds every line in the same order (a
        line over processes creates its process group in each), and a line
        of other processes' ranks is a ``ForeignSubMesh``."""
        lines = self.lines(axis)
        if self.comm is not None:
            return [self.comm.sub([int(r) for r in line]) for line in lines]
        return [MeshCommunication(list(line)) for line in lines]

    def __repr__(self) -> str:
        if self.comm is not None:
            return f"Mesh({self.shape}, ranks of {self.comm!r})"
        return f"Mesh({self.shape}, {self.devices.flat[0].type})"


def make_mesh(
    axes: Sequence[Tuple[str, int]],
    devices: Optional[Sequence[Union[torch.device, str]]] = None,
    *,
    comm: Optional[MeshCommunication] = None,
) -> Mesh:
    """Build a named multi-axis mesh, e.g. ``make_mesh([("dp", 2), ("tp", 4)])``.

    Axis sizes must multiply to the device count. ``devices`` defaults to
    the devices of ``comm`` (default: the default mesh; every GPU, on the
    CPU the tests' mesh); over a mesh whose ranks span processes the axes
    lay out its ranks. Axis order fixes locality: later axes are nearest
    neighbours, so put 'tp' last (within a process, where the ranks span
    processes).
    """
    sizes = tuple(int(s) for _, s in axes)
    total = int(np.prod(sizes))
    names = [n for n, _ in axes]
    if devices is None:
        comm = get_comm() if comm is None else comm
        if comm.spans_processes:
            if total != comm.size:
                raise ValueError(f"mesh axes {dict(axes)} need {total} ranks, have {comm.size}")
            return Mesh(np.arange(comm.size).reshape(sizes), names, comm)
        devices = comm.devices
    devices = list(devices)
    if total != len(devices):
        raise ValueError(f"mesh axes {dict(axes)} need {total} devices, have {len(devices)}")
    grid = np.empty(len(devices), dtype=object)
    grid[:] = [torch.device(d) for d in devices]
    return Mesh(grid.reshape(sizes), names)


def axis_comm(mesh: Union[Mesh, MeshCommunication], axis: str) -> MeshCommunication:
    """The first line of ``mesh`` along ``axis`` that holds one of this
    process's ranks; a MeshCommunication is a mesh of one axis and is its
    own line. The lines of a mesh compute the same replicated result, so one
    line stands for all of them: each process runs a line it holds."""
    if isinstance(mesh, MeshCommunication):
        return mesh
    comms = mesh.comms(axis)
    return next(c for c in comms if len(c.local_ranks))
