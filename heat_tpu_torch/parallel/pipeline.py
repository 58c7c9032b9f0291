"""Pipeline parallelism: the GPipe microbatch schedule over a mesh axis
(counterpart of heat_tpu/parallel/pipeline.py).

Each shard of the axis owns one stage's parameters; activations hop stage
to stage by ``ppermute`` (one neighbour exchange per tick), and the
fill/drain ramp runs ``M + P − 1`` ticks for M microbatches on P stages.
heat_tpu's ``shard_map`` program runs every stage at every tick; the
port's single controller runs a stage only at the ticks where it holds a
microbatch and sends zeros from the idle ones, which changes no result.

Stages must be homogeneous (the same activation shape in and out), the
standard transformer-block setting.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence, Union

import torch

from ..core.communication import MeshCommunication
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
    n_stages = comm.size
    m = n_microbatches or n_stages
    batch = x.shape[0]
    if batch % m:
        raise ValueError(f"batch {batch} not divisible by {m} microbatches")
    micro = x.reshape(m, batch // m, *x.shape[1:])
    params = [tree_map(lambda a, s=s, d=d: a[s].to(d), stacked_params) for s, d in enumerate(comm.devices)]
    fwd = [(i, (i + 1) % n_stages) for i in range(n_stages)]
    buf = [torch.zeros_like(micro[0], device=d) for d in comm.devices]
    outs = []
    for t in range(m + n_stages - 1):
        # stage s holds microbatch t - s while 0 <= t - s < m: stage 0 reads
        # it from the input, the others from what the previous stage sent
        sent = []
        for s, d in enumerate(comm.devices):
            if 0 <= t - s < m:
                inp = micro[t].to(d) if s == 0 else buf[s]
                sent.append(stage_fn(params[s], inp))
            else:
                sent.append(torch.zeros_like(buf[s]))
        if t >= n_stages - 1:
            outs.append(sent[-1])
        buf = comm.ppermute(sent, perm=fwd)
    last = torch.stack(outs)
    replicated = comm.bcast([last if s == n_stages - 1 else None for s in range(n_stages)], root=n_stages - 1)
    return replicated[0].to(x.device).reshape(batch, *replicated[0].shape[2:])
