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

Over a mesh whose ranks span processes a layer holds the blocks of its
line's ranks in this process, and a :class:`TPMLPBlock` over a
:func:`make_mesh` of such a mesh holds the blocks of its first line here:
each process runs the lines it holds (``communication.share`` hands them
the parameters, and sums their gradients over every line in the backward,
whichever process ran it), and the whole output is joined in every process
in line order. Forward and gradients equal the one-process mesh's bit for
bit.
"""

from __future__ import annotations

from typing import List, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..core import communication
from ..core.communication import MeshCommunication
from ..nn import _init
from ._mesh import Mesh, axis_comm

__all__ = ["ColumnParallelDense", "RowParallelDense", "TPMLPBlock"]

Sharded = Union[torch.Tensor, List[torch.Tensor]]


def _widths(n: int, comm: Optional[MeshCommunication]) -> List[int]:
    return [n] if comm is None else list(comm.counts_displs_shape((n,), 0)[0])


def _blocks(full: torch.Tensor, widths: List[int], dim: int, comm) -> nn.ParameterList:
    """``full`` cut along ``dim`` into blocks of ``widths``: the blocks of
    this process's ranks of ``comm``, each on its rank's device (one block,
    on ``full``'s, without a mesh)."""
    blocks = full.split(widths, dim=dim)
    if comm is None:
        return nn.ParameterList(nn.Parameter(b.contiguous()) for b in blocks)
    return nn.ParameterList(
        nn.Parameter(blocks[r].to(d).contiguous()) for r, d in zip(comm.local_ranks, comm.local_devices)
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
    blocks, this process's) for a :class:`RowParallelDense` to contract.

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

    def _on(self, x: torch.Tensor, comm: Optional[MeshCommunication], params=None) -> Sharded:
        """The product on this process's ranks of ``comm``, a line of this
        layer's size, with ``params`` (this process's kernel and bias
        blocks; the layer's own by default). ``x`` is every rank's input:
        across processes its gradient is summed over the line's ranks in
        the backward."""
        kernel, bias = params or (list(self.kernel), None if self.bias is None else list(self.bias))
        if comm is None:
            xs, devices = [x], [x.device]
        else:
            devices = comm.local_devices
            xs = communication.share(comm, {"x": x}, [("x", r) for r in range(comm.size)], {"x": tuple(x.shape)})
        out = []
        for j, (xj, d) in enumerate(zip(xs, devices)):
            a, w = _init.promote(None, xj, kernel[j].to(d))
            y = a @ w
            out.append(y if bias is None else y + bias[j].to(d))
        return out[0] if comm is None else out


class RowParallelDense(nn.Module):
    """Dense ``x @ kernel + bias`` with the kernel's rows cut over the 'tp'
    shards of ``comm``: each shard multiplies its block of the activation
    (a :class:`ColumnParallelDense` output, or a tensor, which is cut here)
    by its rows, one ``allreduce`` sums the partial products in shard
    order, and the replicated bias is added once. Returns one tensor, on
    ``comm.home``. Parameters as :class:`ColumnParallelDense`.
    """

    def __init__(self, in_features: int, features: int, use_bias: bool = True, dtype=None, *,
                 comm: Optional[MeshCommunication] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.comm = comm
        self.widths = _widths(in_features, comm)
        full = _kernel(in_features, features, dtype, device, generator)
        self.kernel = _blocks(full, self.widths, 0, comm)
        first = full.device if comm is None else comm.home
        self.bias = nn.Parameter(torch.zeros_like(full[0], device=first)) if use_bias else None

    def forward(self, h: Sharded) -> torch.Tensor:
        return self._on(h, self.comm)

    def _on(self, h: Sharded, comm: Optional[MeshCommunication], params=None) -> torch.Tensor:
        """The contraction on ``comm``, a line of this layer's size, with
        ``params`` (this process's kernel blocks and the bias; the layer's
        own by default)."""
        kernel, bias = params or (list(self.kernel), self.bias)
        if isinstance(h, torch.Tensor):
            if comm is None or communication.differentiable(comm):
                h = list(h.split(self.widths, dim=-1))
            else:
                held = [(r, h.device) for r in comm.local_ranks]
                h = communication.take_blocks(comm, h, self.widths, h.dim() - 1, held, range(comm.size))
        partial = [_init.promote(None, a, kernel[j].to(a.device)) for j, a in enumerate(h)]
        partial = [a @ w for a, w in partial]
        y = partial[0] if comm is None else communication.sum_to_all(comm, partial)
        return y if bias is None else y + bias.to(y.device)


def _row_counts(rows: int, lines: int) -> List[int]:
    """The rows of each line under the mesh's ceil-division block rule."""
    block = -(-rows // lines) if rows else 0
    return [max(0, min(block, rows - i * block)) for i in range(lines)]


class TPMLPBlock(nn.Module):
    """The canonical two-layer tensor-parallel block: column-parallel
    up-projection to ``hidden``, flax's (tanh) gelu on each shard,
    row-parallel down-projection to ``features``; one ``allreduce`` per
    block on each 'tp' line, as in Megatron.

    ``comm`` is the 'tp' line (a MeshCommunication), or a :class:`Mesh`
    whose ``tp_axis`` cuts the kernels and whose other axes cut the input's
    rows, one block of rows per 'tp' line in the mesh's row-major order;
    None: plain matmuls. Over a mesh of ranks that span processes each
    process holds the kernels' blocks of its ranks' 'tp' positions, which
    must be the same in every line it holds.
    """

    def __init__(self, hidden: int, features: int, in_features: int, *,
                 comm: Union[MeshCommunication, Mesh, None] = None, tp_axis: str = "tp",
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = _init.torch_device(device)
        generator = _init.generator(generator, device)
        self.mesh, self.tp_axis = (comm, tp_axis) if isinstance(comm, Mesh) else (None, tp_axis)
        self.lines = comm.comms(tp_axis) if isinstance(comm, Mesh) else [comm]
        line = axis_comm(comm, tp_axis) if isinstance(comm, Mesh) else comm
        self.up = ColumnParallelDense(in_features, hidden, comm=line, device=device, generator=generator)
        self.down = RowParallelDense(hidden, features, comm=line, device=device, generator=generator)

    def _on(self, x: torch.Tensor, line: Optional[MeshCommunication], params=None) -> torch.Tensor:
        up, down = params or (None, None)
        h = self.up._on(x, line, up)
        h = F.gelu(h, approximate="tanh") if isinstance(h, torch.Tensor) else [
            F.gelu(b, approximate="tanh") for b in h
        ]
        return self.down._on(h, line, down)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if len(self.lines) == 1:
            return self._on(x, self.lines[0])
        if self.mesh.comm is not None and self.mesh.comm.spans_processes:
            return self._spanning(x)
        rows = MeshCommunication([line.devices[0] for line in self.lines])
        counts, displs = rows.counts_displs_shape(x.shape, 0)
        first = self.lines[0].devices[0]
        return torch.cat([
            self._on(x.narrow(0, o, c), line).to(first) for c, o, line in zip(counts, displs, self.lines)
        ])

    def _spanning(self, x: torch.Tensor) -> torch.Tensor:
        """The lines this process holds, each on its block of rows, with
        the parameters shared over every line; the lines' outputs joined in
        every process in line order."""
        world = self.mesh.comm
        grid = self.mesh.lines(self.tp_axis)
        n_lines, tp = grid.shape
        local = set(world.local_ranks)
        held = [i for i in range(n_lines) if local & {int(r) for r in grid[i]}]
        positions = {i: [j for j in range(tp) if int(grid[i][j]) in local] for i in held}
        mine = positions[held[0]]
        if any(positions[i] != mine for i in held):
            raise ValueError(f"over {self.mesh!r} this process holds other 'tp' positions in other lines: "
                             f"{positions}; lay the mesh out so that they are the same")
        params, uses, shapes, shadows = self._shared(grid, mine)
        copies = iter(communication.share(world, params, [(key, rank) for key, rank, _ in uses], shapes,
                                          [(key, rank) for key, rank, _ in shadows]))
        # the copies come in use order, then the shadows': each to its line
        per_line = {i: {} for i in held}
        for key, rank, line in (*uses, *shadows):
            if rank in local:
                per_line[line][key] = next(copies)
        counts = _row_counts(x.shape[0], n_lines)
        everywhere = all({world.placements[int(r)].process_index for r in line} == set(range(len(world.counts)))
                         for line in grid)
        senders = [int(line[0]) for line in grid]
        xs = communication.take_blocks(world, x, counts, 0, [(i, x.device) for i in held], senders)
        ys = []
        for i, xi in zip(held, xs):
            c = per_line[i]
            up = ([c[("up.kernel", j)] for j in mine], [c[("up.bias", j)] for j in mine])
            down = ([c[("down.kernel", j)] for j in mine], c["down.bias"])
            ys.append(self._on(xi, self.lines[i], (up, down)))
        return communication.join_blocks(world, ys, held, counts, 0, senders, world.home, everywhere)

    def _shared(self, grid, mine):
        """This process's parameters by key; every line's use of every
        parameter in the one-process order, as (key, rank, line): the
        kernels' blocks of position j by the line's rank j, the down bias by
        its first rank; the shapes; and the shadow uses of the down bias by
        the lines this process holds but whose first rank is another
        process's."""
        up, down = self.up, self.down
        tp = grid.shape[1]
        params = {}
        for idx, j in enumerate(mine):
            params[("up.kernel", j)] = up.kernel[idx]
            params[("up.bias", j)] = up.bias[idx]
            params[("down.kernel", j)] = down.kernel[idx]
        params["down.bias"] = down.bias
        in_features, features = up.kernel[0].shape[0], down.kernel[0].shape[1]
        shapes = {"down.bias": (features,)}
        for j in range(tp):
            shapes[("up.kernel", j)] = (in_features, up.widths[j])
            shapes[("up.bias", j)] = (up.widths[j],)
            shapes[("down.kernel", j)] = (down.widths[j], features)
        uses, shadows = [], []
        local = set(self.mesh.comm.local_ranks)
        for i, line in enumerate(grid):
            ranks = [int(r) for r in line]
            for j, r in enumerate(ranks):
                uses += [(("up.kernel", j), r, i), (("up.bias", j), r, i), (("down.kernel", j), r, i)]
            uses.append(("down.bias", ranks[0], i))
            held = [r for r in ranks if r in local]
            if held and ranks[0] not in local:
                shadows.append(("down.bias", held[0], i))
        return params, uses, shapes, shadows
