"""Tensor (model) parallelism: Megatron's sharded Dense pair (counterpart of
heat_tpu/parallel/tensor.py).

heat_tpu annotates the kernels with ``PartitionSpec``s and lets GSPMD
insert the collective; the port's single controller writes the schedule
out. Given ``comm``, the line of 'tp' shards:

* :class:`ColumnParallelDense` holds its kernel (in, features) as one
  block of columns per shard, block j on shard j's device, and returns
  the activation still sharded: a list of per-shard column blocks.
* :class:`RowParallelDense` holds its kernel as the matching row blocks,
  multiplies each shard's block of the activation by its own, sums the
  partial products in shard order with one ``allreduce`` and adds the bias
  once. Nothing is gathered.

Without ``comm`` each layer is one plain matmul (heat_tpu's layers outside
a mesh). Blocks follow the mesh's ceil-division rule
(``counts_displs_shape``), so a width need not divide the shard count.

:class:`TPMLPBlock` also takes a :func:`make_mesh` mesh, as heat_tpu's block
runs under one: the kernels are cut over its ``tp_axis``, held on the
first 'tp' line, and the input's rows are cut over the other axes (the
'dp' lines), each line running its rows with the blocks copied to its
devices. Autograd sums the copies' gradients into the blocks, so a dp×tp
step leaves each block's gradient summed over 'dp' and the kernels still
cut over 'tp'.
"""

from __future__ import annotations

from typing import List, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..core.communication import MeshCommunication
from ..nn import _init
from ._mesh import Mesh

__all__ = ["ColumnParallelDense", "RowParallelDense", "TPMLPBlock"]

Sharded = Union[torch.Tensor, List[torch.Tensor]]


def _widths(n: int, comm: Optional[MeshCommunication]) -> List[int]:
    return [n] if comm is None else list(comm.counts_displs_shape((n,), 0)[0])


def _blocks(full: torch.Tensor, widths: List[int], dim: int, comm) -> nn.ParameterList:
    """``full`` cut along ``dim`` into blocks of ``widths``, block j on the
    j-th shard's device (all on ``full``'s without a mesh)."""
    devices = [full.device] if comm is None else comm.devices
    return nn.ParameterList(
        nn.Parameter(b.to(d).contiguous()) for b, d in zip(full.split(widths, dim=dim), devices)
    )


def _kernel(in_features: int, features: int, dtype, device, generator) -> torch.Tensor:
    """A lecun-normal (in, out) kernel (flax's default)."""
    device = _init.torch_device(device)
    generator = _init.generator(generator, device)
    w = torch.empty(in_features, features, dtype=dtype or torch.float32, device=device)
    return _init.lecun_normal_(w, in_features, generator)


class ColumnParallelDense(nn.Module):
    """Dense ``x @ kernel + bias`` with the kernel's columns cut over the
    'tp' shards of ``comm``; the output stays sharded (a list of column
    blocks) for a :class:`RowParallelDense` to contract.

    Parameters
    ----------
    in_features, features : int
        The kernel's shape (flax infers ``in_features`` from the input).
    use_bias : bool
        A zero-initialized bias, cut like the columns.
    dtype : torch.dtype, optional
        The parameters' type (float32 by default); the product runs in the
        promoted type of input and kernel.
    comm : MeshCommunication, optional
        The 'tp' line; None: one block, a plain Dense.
    device, generator
        Where and from what the lecun-normal kernel is drawn.
    """

    def __init__(self, in_features: int, features: int, use_bias: bool = True, dtype=None, *,
                 comm: Optional[MeshCommunication] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.comm = comm
        self.widths = _widths(features, comm)
        full = _kernel(in_features, features, dtype, device, generator)
        self.kernel = _blocks(full, self.widths, 1, comm)
        self.bias = _blocks(torch.zeros_like(full[0]), self.widths, 0, comm) if use_bias else None

    def forward(self, x: torch.Tensor) -> Sharded:
        return self._on(x, self.comm)

    def _on(self, x: torch.Tensor, comm: Optional[MeshCommunication]) -> Sharded:
        """The product on ``comm``'s devices, a line of this layer's size."""
        devices = [x.device] if comm is None else comm.devices
        out = []
        for j, d in enumerate(devices):
            a, w = _init.promote(None, x.to(d), self.kernel[j].to(d))
            y = a @ w
            out.append(y if self.bias is None else y + self.bias[j].to(d))
        return out[0] if comm is None else out


class RowParallelDense(nn.Module):
    """Dense ``x @ kernel + bias`` with the kernel's rows cut over the 'tp'
    shards of ``comm``: each shard multiplies its block of the activation
    (a :class:`ColumnParallelDense` output, or a tensor, which is cut here)
    by its rows, one ``allreduce`` sums the partial products in shard
    order, and the replicated bias is added once. Returns one tensor, on
    the first shard's device. Parameters as :class:`ColumnParallelDense`.
    """

    def __init__(self, in_features: int, features: int, use_bias: bool = True, dtype=None, *,
                 comm: Optional[MeshCommunication] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.comm = comm
        self.widths = _widths(in_features, comm)
        full = _kernel(in_features, features, dtype, device, generator)
        self.kernel = _blocks(full, self.widths, 0, comm)
        first = full.device if comm is None else comm.devices[0]
        self.bias = nn.Parameter(torch.zeros_like(full[0], device=first)) if use_bias else None

    def forward(self, h: Sharded) -> torch.Tensor:
        return self._on(h, self.comm)

    def _on(self, h: Sharded, comm: Optional[MeshCommunication]) -> torch.Tensor:
        """The contraction on ``comm``, a line of this layer's size."""
        if isinstance(h, torch.Tensor):
            h = list(h.split(self.widths, dim=-1))
        partial = [_init.promote(None, a, self.kernel[j].to(a.device)) for j, a in enumerate(h)]
        partial = [a @ w for a, w in partial]
        y = partial[0] if comm is None else comm.allreduce(partial)[0]
        return y if self.bias is None else y + self.bias.to(y.device)


class TPMLPBlock(nn.Module):
    """The canonical two-layer tensor-parallel block: column-parallel
    up-projection to ``hidden``, flax's (tanh) gelu on each shard,
    row-parallel down-projection to ``features``; one ``allreduce`` per
    block on each 'tp' line, as in Megatron.

    ``comm`` is the 'tp' line (a MeshCommunication), or a :class:`Mesh`
    whose ``tp_axis`` cuts the kernels and whose other axes cut the input's
    rows, one block of rows per 'tp' line in the mesh's row-major order;
    None: plain matmuls.
    """

    def __init__(self, hidden: int, features: int, in_features: int, *,
                 comm: Union[MeshCommunication, Mesh, None] = None, tp_axis: str = "tp",
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = _init.torch_device(device)
        generator = _init.generator(generator, device)
        self.lines = comm.comms(tp_axis) if isinstance(comm, Mesh) else [comm]
        self.up = ColumnParallelDense(in_features, hidden, comm=self.lines[0], device=device, generator=generator)
        self.down = RowParallelDense(hidden, features, comm=self.lines[0], device=device, generator=generator)

    def _on(self, x: torch.Tensor, line: Optional[MeshCommunication]) -> torch.Tensor:
        h = self.up._on(x, line)
        h = F.gelu(h, approximate="tanh") if isinstance(h, torch.Tensor) else [
            F.gelu(b, approximate="tanh") for b in h
        ]
        return self.down._on(h, line)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if len(self.lines) == 1:
            return self._on(x, self.lines[0])
        rows = MeshCommunication([line.devices[0] for line in self.lines])
        counts, displs = rows.counts_displs_shape(x.shape, 0)
        first = self.lines[0].devices[0]
        return torch.cat([
            self._on(x.narrow(0, o, c), line).to(first) for c, o, line in zip(counts, displs, self.lines)
        ])
