"""Pipeline parallelism: the GPipe microbatch schedule over a mesh axis
(counterpart of heat_tpu/parallel/pipeline.py).

Each shard of the axis owns one stage's parameters; activations hop stage
to stage by ``ppermute`` (one neighbour exchange per tick), and the
fill/drain ramp runs ``M + P − 1`` ticks for M microbatches on P stages.
heat_tpu's ``shard_map`` program runs every stage at every tick; the
port's single controller runs a stage only at the ticks where it holds a
microbatch and sends zeros from the idle ones, which changes no result.
Over a mesh whose ranks span processes each process runs its own ranks'
stages, and the hops between processes are point-to-point pairs; there the
schedule runs forward (heat_tpu's tests run it forward), and a gradient
through it raises ``CrossProcessMeshError``.

Stages must be homogeneous (the same activation shape in and out), the
standard transformer-block setting.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence, Union

import torch

from ..core import communication
from ..core.communication import CrossProcessMeshError, MeshCommunication
from ._mesh import Mesh, axis_comm

__all__ = ["pipeline_apply", "pipeline_stage_params", "tree_map"]


def tree_map(fn: Callable, *trees):
    """``fn`` over the leaves (tensors) of nested dicts, lists and tuples."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(tree_map(fn, *leaves) for leaves in zip(*trees))
    return fn(*trees)


def pipeline_stage_params(per_stage_params: Sequence[Any]):
    """Stack a list of per-stage parameter trees along a new leading axis."""
    return tree_map(lambda *leaves: torch.stack(leaves), *per_stage_params)


def pipeline_apply(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stacked_params: Any,
    x: torch.Tensor,
    mesh: Union[Mesh, MeshCommunication],
    axis: str = "pp",
    n_microbatches: Optional[int] = None,
) -> torch.Tensor:
    """Run ``x`` through the P stages of ``mesh``'s ``axis``:
    ``stage_fn(params_p, act)`` per stage, microbatched over the leading
    (batch) axis.

    ``stacked_params`` has a leading stage axis of size P (see
    :func:`pipeline_stage_params`); stage p's slice moves to shard p's
    device. The last stage's outputs are broadcast to every stage
    (replicated) and returned on x's device. ``mesh`` is a :class:`Mesh`
    or a MeshCommunication, a mesh of one axis.
    """
    comm = axis_comm(mesh, axis)
    if not communication.differentiable(comm) and torch.is_grad_enabled() and any(
            t.requires_grad for t in _leaves((x, stacked_params))):
        raise CrossProcessMeshError(
            "pipeline_apply's backward over a mesh whose ranks span processes is not ported yet (ROADMAP "
            "A11.5b(c2b)): its forward runs there, as heat_tpu's tests run it; call it under torch.no_grad()")
    n_stages = comm.size
    m = n_microbatches or n_stages
    batch = x.shape[0]
    if batch % m:
        raise ValueError(f"batch {batch} not divisible by {m} microbatches")
    micro = x.reshape(m, batch // m, *x.shape[1:])
    # this process's stages and their slices of the parameters
    stages = list(zip(comm.local_ranks, comm.local_devices))
    params = [tree_map(lambda a, s=s, d=d: a[s].to(d), stacked_params) for s, d in stages]
    fwd = [(i, (i + 1) % n_stages) for i in range(n_stages)]
    buf = [torch.zeros_like(micro[0], device=d) for _, d in stages]
    outs = []
    for t in range(m + n_stages - 1):
        # stage s holds microbatch t - s while 0 <= t - s < m: stage 0 reads
        # it from the input, the others from what the previous stage sent
        sent = []
        for i, (s, d) in enumerate(stages):
            if 0 <= t - s < m:
                inp = micro[t].to(d) if s == 0 else buf[i]
                sent.append(stage_fn(params[i], inp))
            else:
                sent.append(torch.zeros_like(buf[i]))
        if t >= n_stages - 1 and n_stages - 1 in comm.local_ranks:
            outs.append(sent[-1])
        buf = comm.ppermute(sent, perm=fwd)
    last = torch.stack(outs) if outs else None
    root = n_stages - 1
    replicated = comm.bcast([last if s == root else None for s, _ in stages], root=root)[0]
    return replicated.to(x.device).reshape(batch, *replicated.shape[2:])


def _leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out
