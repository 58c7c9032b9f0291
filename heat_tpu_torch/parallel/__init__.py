"""Parallelism strategies beyond the data axis (counterpart of
heat_tpu/parallel).

- :func:`make_mesh` — a named multi-axis mesh ('dp', 'tp', 'pp', 'ep', ...)
  of torch devices; :meth:`Mesh.comms` gives one
  :class:`~heat_tpu_torch.core.communication.MeshCommunication` per line
  along an axis.
- :mod:`tensor <heat_tpu_torch.parallel.tensor>` — Megatron's column/row
  parallel Dense pair: kernels cut into one block per 'tp' shard, the
  column output left sharded, the row layer's partial products summed by
  one ``allreduce``.
- :mod:`pipeline <heat_tpu_torch.parallel.pipeline>` — the GPipe schedule
  over a mesh axis, activations hopping stage to stage by ``ppermute``.
- :mod:`expert <heat_tpu_torch.parallel.expert>` — top-1 mixture of experts
  with ``alltoall`` token dispatch over the expert axis.

heat_tpu expresses them as ``shard_map`` programs and GSPMD annotations
over a ``jax.sharding.Mesh``; the port's single controller runs the same
schedules over the shard lists of its in-process collectives. Sequence
parallelism (ring / Ulysses attention) lives in
:mod:`heat_tpu_torch.nn.attention` and composes with these meshes.
"""

from __future__ import annotations

from ._mesh import Mesh, make_mesh
from .expert import MoELayer, moe_apply
from .pipeline import pipeline_apply, pipeline_stage_params
from .tensor import ColumnParallelDense, RowParallelDense, TPMLPBlock

__all__ = [
    "ColumnParallelDense",
    "Mesh",
    "MoELayer",
    "RowParallelDense",
    "TPMLPBlock",
    "make_mesh",
    "moe_apply",
    "pipeline_apply",
    "pipeline_stage_params",
]
