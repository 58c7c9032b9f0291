"""Data-parallel model training (counterpart of heat_tpu/nn/data_parallel.py).

heat_tpu's ``DataParallel`` runs each step as one jitted program over the
row-sharded batch. The port keeps what that program computes, one replica
of the module per shard of the mesh:

* the batch is split by rows as ``ht.array(..., split=0)`` splits it (the
  shards may differ by a row; a shard may be empty);
* each replica runs the forward of its shard. A module with BatchNorm
  normalizes with the statistics of the whole batch, reduced over the mesh
  (the replicas' forwards run in lockstep, :mod:`._lockstep`);
* the logits of every shard are gathered in shard order and ``loss_fn`` is
  evaluated once, on the whole batch, so a loss that is not a mean over
  rows is still the reference's;
* one ``backward()`` gives each replica its part of the gradient; the
  parts are summed over the mesh in shard order and every replica takes
  the same optimizer step, so the replicas stay equal.

Over a mesh whose ranks span processes every process feeds the same global
batch and holds the replicas of its own ranks (the parameters of its first
on ``home``): the BatchNorm meetings and the gradient's sum go across
processes through the mesh's verbs, the logits of every rank are gathered
for the one loss, and every process gets the same loss and the same
update.

As in the JAX package, ``DataParallel`` owns the train step:
``dp.train_step(batch, labels)`` runs forward, backward and the update and
returns the loss; ``dp(x)`` is the forward with the running averages.
"""

from __future__ import annotations

import copy
from collections.abc import Mapping
from functools import partial
from typing import Callable, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..core import numlens
from ..core.communication import MeshCommunication, sanitize_comm
from ..core.dndarray import DNDarray
from . import _init, _lockstep

__all__ = ["DataParallel", "DataParallelMultiGPU"]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """optax's softmax cross entropy over the last axis, averaged over every
    other position: integer labels, or probabilities when ``labels`` has the
    rank of ``logits``."""
    if labels.dim() == logits.dim():
        return -(labels * F.log_softmax(logits, dim=-1)).sum(-1).mean()
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1).long())


def as_tensor(x, device: torch.device) -> torch.Tensor:
    """A DNDarray, tensor or array-like as one tensor on ``device``."""
    if isinstance(x, DNDarray):
        x = x.larray
    elif not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x))
    return x.to(device)


def split_rows(x, comm: MeshCommunication) -> List[torch.Tensor]:
    """One block of rows per shard of ``comm`` that this process holds, each
    on its shard's device, as ``ht.array(x, split=0)`` lays them out."""
    if isinstance(x, DNDarray) and x.split == 0 and x.comm.size == comm.size:
        return [s.to(d) for s, d in zip(x.lshards, comm.local_devices)]
    t = as_tensor(x, comm.home)
    counts, displs = comm.local_counts_displs(t.shape, 0)
    return [t.narrow(0, o, c).to(d) for c, o, d in zip(counts, displs, comm.local_devices)]


def bind(module: torch.nn.Module, rng_seed: int, sample: torch.Tensor) -> bool:
    """Move ``module`` to the sample's device and pass the sample through it
    once: a layer whose input width waits for data draws its weights then,
    from a generator seeded with ``rng_seed``. True if it holds BatchNorm."""
    module.to(sample.device)
    gen = torch.Generator(device=sample.device).manual_seed(rng_seed)
    for m in module.modules():
        if isinstance(m, _init.LazyDense):
            m.generator = gen
    stateful = any(isinstance(m, _init.BatchNorm) for m in module.modules())
    with torch.no_grad():
        module(sample, train=False) if stateful else module(sample)
    return stateful


def replicate(module: torch.nn.Module, devices) -> List[torch.nn.Module]:
    """``module`` itself for the first shard and a copy for each other."""
    return [module] + [copy.deepcopy(module).to(d) for d in devices[1:]]


def flat_grads(module: torch.nn.Module) -> torch.Tensor:
    """Every parameter's gradient in one vector, zeros where there is none."""
    return torch.cat([
        (p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
        for p in module.parameters()
    ])


def set_grads(module: torch.nn.Module, flat: torch.Tensor) -> None:
    """Give each parameter its slice of ``flat`` as its gradient."""
    offset = 0
    for p in module.parameters():
        p.grad = flat[offset:offset + p.numel()].view_as(p)
        offset += p.numel()


def load_tree(module: torch.nn.Module, tree: Mapping) -> None:
    """Copy the named tensors of ``tree`` (parameters, buffers or both)
    into ``module``; a name the module lacks raises ``KeyError``."""
    unexpected = module.load_state_dict(dict(tree), strict=False).unexpected_keys
    if unexpected:
        raise KeyError(f"the module has no tensors named {unexpected}")


class DataParallel:
    """Replica training over the mesh (reference data_parallel.py:21-139
    constructor contract).

    Parameters
    ----------
    module : torch.nn.Module
        The network; its weights are the replicas' starting point.
    comm : MeshCommunication, optional
        The mesh whose shards split the batch.
    optimizer : callable, optional
        A factory ``optimizer(params) -> torch.optim.Optimizer``, such as
        ``heat_tpu_torch.optim.Adam(1e-3)``. Defaults to ``SGD(0.01)``.
    loss_fn : callable(logits, labels) -> scalar, optional
        Defaults to softmax cross entropy. Evaluated once per step, on the
        whole batch.
    blocking_parameter_updates : bool
        Parity flag: both reference modes give the same step here; the flag
        is recorded and changes nothing.
    """

    def __init__(
        self,
        module: torch.nn.Module,
        comm: Optional[MeshCommunication] = None,
        optimizer: Optional[Callable] = None,
        loss_fn: Optional[Callable] = None,
        blocking_parameter_updates: bool = False,
    ):
        from ..optim import SGD

        self.module = module
        self.comm = sanitize_comm(comm)
        self.optimizer = optimizer if optimizer is not None else SGD(0.01)
        self.loss_fn = loss_fn if loss_fn is not None else cross_entropy
        self.blocking_parameter_updates = blocking_parameter_updates
        self.replicas: Optional[List[torch.nn.Module]] = None
        self.optimizers: Optional[List[torch.optim.Optimizer]] = None
        self._stateful = False
        self._lockstep: Optional[_lockstep.Lockstep] = None

    def init(self, rng_seed: int, sample_input) -> "DataParallel":
        """Bind the trainer to the mesh: the module moves to the first shard's
        device and sees ``sample_input`` once (layers whose input width
        waits for data draw their weights from ``rng_seed``); every shard
        gets a replica of it and an optimizer."""
        self._stateful = bind(self.module, rng_seed, as_tensor(sample_input, self.comm.home))
        self._replicate()
        return self

    def _replicate(self) -> None:
        self.replicas = replicate(self.module, self.comm.local_devices)
        self.optimizers = [self.optimizer(r.parameters()) for r in self.replicas]
        self._lockstep = _lockstep.Lockstep(self.comm) if self._stateful and self.comm.size > 1 else None

    def _apply(self, replica: torch.nn.Module, x: torch.Tensor, train: bool) -> torch.Tensor:
        return replica(x, train=train) if self._stateful else replica(x)

    def __call__(self, x) -> torch.Tensor:
        """Forward pass with the running averages (reference
        data_parallel.py:140-174)."""
        if self.replicas is None:
            raise RuntimeError("DataParallel.init must be called before the forward pass")
        return self._apply(self.module, as_tensor(x, self.comm.home), False)

    forward = __call__

    def train_step(self, x, y) -> float:
        """One optimization step on a batch (tensor, array or DNDarray);
        returns the loss."""
        if self.replicas is None:
            raise RuntimeError("DataParallel.init must be called before training")
        if self.comm.spans_processes:
            return self._train_step_spanning(x, y)
        xs, ys = split_rows(x, self.comm), split_rows(y, self.comm)
        active = [r for r, s in enumerate(xs) if s.shape[0] > 0]
        fns = [partial(self._apply, self.replicas[r], xs[r], True) for r in active]
        if self._stateful and len(active) > 1:
            outs = self._lockstep.run(active, fns)
        else:
            outs = [f() for f in fns]
        first = self.comm.devices[0]
        # one shard's logits are the batch's: no copy (at the README's
        # TransformerLM 4 x 4096 tokens they are 3.3 GB)
        logits = outs[0].to(first) if len(outs) == 1 else torch.cat([o.to(first) for o in outs])
        labels = torch.cat([ys[r].to(first) for r in active])
        loss = self.loss_fn(logits, labels)
        for opt in self.optimizers:
            opt.zero_grad()
        loss.backward()
        return self._update(loss)

    def _train_step_spanning(self, x, y) -> float:
        """:meth:`train_step` over a mesh whose ranks span processes. Every
        rank of this process runs its forward, a rank without rows on an
        empty block (inside the BatchNorm meetings when the step has them,
        else with the running averages): its logits are empty and its
        meeting sums zero, what the one-process mesh puts in for a rank
        without rows. The logits of every rank are gathered in rank order
        into one leaf, the loss is taken on it as on one process, and its
        gradient is handed back to this process's logits."""
        comm = self.comm
        xs = split_rows(x, comm)
        rows = x.gshape[0] if isinstance(x, DNDarray) else int(np.shape(x)[0])
        counts = comm.counts_displs_shape((rows,), 0)[0]
        active = [r for r in range(comm.size) if counts[r]]
        meet = self._stateful and len(active) > 1
        fns = [partial(self._apply, replica, t, meet or r in active)
               for r, replica, t in zip(comm.local_ranks, self.replicas, xs)]
        outs = self._lockstep.run(list(comm.local_ranks), fns) if meet else [f() for f in fns]
        logits = comm.allgather([o.detach() for o in outs], dim=0)[0].requires_grad_()
        labels = as_tensor(y, comm.home)
        loss = self.loss_fn(logits, labels)
        for opt in self.optimizers:
            opt.zero_grad()
        loss.backward()
        _, displs = comm.local_counts_displs((rows,), 0)
        grads = [logits.grad.narrow(0, o, out.shape[0]).to(out.device) for o, out in zip(displs, outs)]
        torch.autograd.backward(outs, grads)
        return self._update(loss)

    def _update(self, loss: torch.Tensor) -> float:
        """The gradient summed over the mesh in rank order, every replica's
        optimizer step, and the loss read once."""
        if self.comm.size > 1:
            summed = self.comm.allreduce([flat_grads(r) for r in self.replicas])
            for replica, flat in zip(self.replicas, summed):
                set_grads(replica, flat)
        # the numerics lens's stream: the optimizers update in place, so the
        # parameters before the step are copied, and only with the lens on
        prev = [p.detach().clone() for p in self.module.parameters()] if numlens._MODE else None
        for opt in self.optimizers:
            opt.step()
        value = loss.item()
        if prev is not None:
            numlens.note_training("data_parallel.step", loss=value, params=list(self.module.parameters()),
                                  prev_params=prev)
        return value

    # ------------------------------------------------------------------
    # checkpoint / resume: the JAX package's full-trainer-state meaning
    # ------------------------------------------------------------------
    def state_dict(self) -> dict:
        """Full resumable state: ``params`` and ``state`` (the BatchNorm
        running averages) by name, and the optimizer's state dict."""
        if self.replicas is None:
            raise RuntimeError("DataParallel.init must be called before state_dict")
        return {
            "params": {n: p.detach() for n, p in self.module.named_parameters()},
            "state": dict(self.module.named_buffers()),
            "opt_state": self.optimizers[0].state_dict(),
        }

    def load_state_dict(self, sd: Mapping) -> "DataParallel":
        """Restore :meth:`state_dict` output into every replica. A bare tree
        of named parameters (and buffers) is also accepted; the optimizer
        then restarts."""
        if self.replicas is None:
            raise RuntimeError("DataParallel.init must be called before load_state_dict")
        full = isinstance(sd, Mapping) and "params" in sd and "opt_state" in sd
        tree = {**sd["params"], **sd.get("state", {})} if full else sd
        for replica in self.replicas:
            load_tree(replica, tree)
        if full:
            for opt in self.optimizers:
                # a loaded state tensor is kept as given: each optimizer
                # needs its own, or the replicas would step it p times
                opt.load_state_dict(copy.deepcopy(sd["opt_state"]))
        else:
            self.optimizers = [self.optimizer(r.parameters()) for r in self.replicas]
        return self

    def save(self, directory: str, step: int = 0, keep: int = 3) -> str:
        """Write :meth:`state_dict` as the checkpoint
        ``directory/ckpt_{step}.manifest.json`` and its payload files (the
        manifest's rename is the commit point); keep the newest ``keep``
        (reference data_parallel.py:243-249). Returns the manifest's path."""
        from ..utils.checkpoint import save_checkpoint

        return save_checkpoint(directory, self.state_dict(), step=step, keep=keep)

    def restore(self, directory: str, step: Optional[int] = None, strict: bool = False) -> "DataParallel":
        """Resume from a checkpoint written by :meth:`save`: the newest that
        verifies for ``step=None`` (an unverifiable newer one is skipped
        with a warning, or raises under ``strict``), else that step
        (reference data_parallel.py:251-266)."""
        from ..utils.checkpoint import load_checkpoint

        return self.load_state_dict(load_checkpoint(directory, _template(self.state_dict()), step=step, strict=strict))

    def rebind(self, comm: Optional[MeshCommunication] = None) -> "DataParallel":
        """Re-target the trainer onto another mesh, carrying its state."""
        sd = copy.deepcopy(self.state_dict()) if self.replicas is not None else None
        self.comm = sanitize_comm(comm)
        if sd is not None:
            self.module.to(self.comm.home)
            self._replicate()
            self.load_state_dict(sd)
        return self

    def fit(self, batches, **kwargs) -> dict:
        """Preemption-tolerant training over ``batches``, ``(x, y)`` pairs:
        :func:`heat_tpu_torch.elastic.fit` (its knobs in ``core/elastic.py``;
        reference data_parallel.py:236-241)."""
        from ..core import elastic

        return elastic.fit(self, batches, **kwargs)


class DataParallelMultiGPU(DataParallel):
    """Node-local data parallelism bound to a DASO optimizer (reference
    data_parallel.py:314-376).

    Constructed with a :class:`~heat_tpu_torch.optim.DASO`, it attaches the
    module to it (``daso.add_model``) and ``step``/``forward`` delegate to
    DASO's schedule. Without a DASO it is a plain :class:`DataParallel`
    over the whole mesh, whose ``step`` is ``train_step`` (heat_tpu's
    ``step`` there calls a ``DataParallel.step`` that does not exist).
    """

    def __init__(self, module, optimizer=None, comm=None, rng_seed: int = 0,
                 sample_input=None, **kwargs):
        from ..optim.dp_optimizer import DASO

        self.daso: Optional[DASO] = None
        if isinstance(optimizer, DASO):
            if sample_input is None:
                raise ValueError(
                    "binding DataParallelMultiGPU to a DASO requires sample_input "
                    "(the reference's DDP wrapper likewise needs a model pass "
                    "to register its gradient hooks)"
                )
            self.daso = optimizer
            self.module = module
            self.comm = optimizer.comm
            optimizer.add_model(module, rng_seed, sample_input)
            return
        super().__init__(module, comm=comm, optimizer=optimizer, **kwargs)

    def step(self, x, y) -> float:
        if self.daso is not None:
            return self.daso.step(x, y)
        return self.train_step(x, y)

    def forward(self, x) -> torch.Tensor:
        if self.daso is not None:
            return self.daso.forward(x)
        return super().forward(x)

    __call__ = forward

    def rebind(self, comm: Optional[MeshCommunication] = None) -> "DataParallelMultiGPU":
        if self.daso is not None:
            self.daso.rebind(comm)
            self.comm = self.daso.comm
            return self
        return super().rebind(comm)

    def state_dict(self) -> dict:
        """The bound DASO's state, else :meth:`DataParallel.state_dict`."""
        if self.daso is not None:
            return self.daso.state_dict()
        return super().state_dict()

    def load_state_dict(self, sd: Mapping) -> "DataParallelMultiGPU":
        if self.daso is not None:
            self.daso.load_state_dict(sd)
            return self
        return super().load_state_dict(sd)

    def save(self, directory: str, step: int = 0, keep: int = 3) -> str:
        """The bound DASO's checkpoint, else :meth:`DataParallel.save`
        (reference data_parallel.py:320-323)."""
        if self.daso is not None:
            return self.daso.save(directory, step=step, keep=keep)
        return super().save(directory, step=step, keep=keep)

    def restore(self, directory: str, step: Optional[int] = None, strict: bool = False) -> "DataParallelMultiGPU":
        """Resume the bound DASO, else as :meth:`DataParallel.restore`
        (reference data_parallel.py:325-330)."""
        if self.daso is not None:
            self.daso.restore(directory, step=step, strict=strict)
            return self
        return super().restore(directory, step=step, strict=strict)


def _template(sd: dict) -> dict:
    """A trainer's state dict as the template of its restore: the
    optimizer's per-parameter state left open (an empty dict), so that a
    trainer that has not stepped yet, and has none, takes the saved one."""
    return {**sd, "opt_state": {**sd["opt_state"], "state": {}}}
