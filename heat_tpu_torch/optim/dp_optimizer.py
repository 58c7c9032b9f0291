"""Hierarchical data-parallel optimizers (counterpart of
heat_tpu/optim/dp_optimizer.py; reference heat/optim/dp_optimizer.py).

DASO groups the shards of the mesh as ``nodes × ici``: ``nodes`` groups
(the reference's compute nodes, the JAX package's 'dcn' axis) of ``ici``
shards each (the GPUs of a node, the 'ici' axis). Each shard holds its own
replica, which steps on its own block of the batch. On a synced batch the
replicas of a group average their parameters, their gradients and their
BatchNorm statistics over the group; on a solo batch (the local-skip
cadence) each replica steps alone, with no collective at all. Every
``global_skip + 1`` batches all replicas are merged with the reference's
stale weighting, ``(global + waits·local)/(waits + 1)``, the global mean
travelling in bfloat16 (reference dp_optimizer.py:21-43, 501-589).

Over a mesh whose ranks span processes each process holds the replicas of
its own ranks and averages over the groups it holds ranks of (a group is a
sub-mesh, in one process or over several); the global merge and the
step's loss go across the whole mesh.
"""

from __future__ import annotations

import warnings
from collections.abc import Mapping
from typing import Callable, List, Optional

import torch

from ..core import numlens
from ..core.communication import MeshCommunication, sanitize_comm
from ..nn.data_parallel import as_tensor, bind, cross_entropy, flat_grads, load_tree, replicate, set_grads
from .utils import DetectMetricPlateau

__all__ = ["DASO", "DataParallelOptimizer"]


class DataParallelOptimizer:
    """An optimizer factory bound to a dict of parameters (reference
    dp_optimizer.py:836-877 wraps a torch optimizer and gates its step).

    ``init(params)`` binds the factory to the tensors of ``params`` and
    returns the torch optimizer (``self.torch_optimizer``);
    ``step(grads, params)`` gives each tensor its gradient from ``grads``,
    steps, and returns ``params``, updated in place.
    """

    def __init__(self, optimizer: Callable, blocking: bool = False):
        if not isinstance(blocking, bool):
            raise TypeError(f"blocking parameter must be a bool, currently {type(blocking)}")
        self.optimizer = optimizer
        self.blocking = blocking
        self.torch_optimizer: Optional[torch.optim.Optimizer] = None
        self._names: List[str] = []

    def init(self, params: Mapping) -> torch.optim.Optimizer:
        self._names = list(params)
        self.torch_optimizer = self.optimizer([params[n] for n in self._names])
        return self.torch_optimizer

    def step(self, grads: Mapping, params: Mapping) -> Mapping:
        if self.torch_optimizer is None:
            raise RuntimeError("DataParallelOptimizer.init must be called before step")
        if list(params) != self._names:
            raise ValueError(f"step got parameters {list(params)}, init bound {self._names}")
        for n in self._names:
            params[n].grad = grads[n]
        self.torch_optimizer.step()
        return params

    def zero_grad(self) -> None:
        if self.torch_optimizer is not None:
            self.torch_optimizer.zero_grad()


def _flat(tensors) -> torch.Tensor:
    return torch.cat([t.detach().reshape(-1) for t in tensors])


@torch.no_grad()
def _copy_flat(tensors, flat: torch.Tensor) -> None:
    """Copy consecutive slices of ``flat`` into ``tensors``."""
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


def _stack(trees: List):
    """Trees of equal structure into one whose tensors gain a leading
    replica axis; a value that is not a tensor is taken from the first."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return torch.stack([t.to(first.device) for t in trees])
    if isinstance(first, Mapping):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_stack(list(v)) for v in zip(*trees))
    return first


def _take(tree, i: int):
    """A copy of replica ``i`` of a stacked tree; ``i`` None merges the
    replicas (floating tensors averaged, others from replica 0)."""
    if isinstance(tree, torch.Tensor):
        if i is None:
            return tree.mean(0) if tree.is_floating_point() else tree[0].clone()
        return tree[i].clone()
    if isinstance(tree, Mapping):
        return {k: _take(v, i) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_take(v, i) for v in tree)
    return tree


def _broadcast(tree, n: int):
    """A merged tree with a leading replica axis of ``n`` equal replicas."""
    if isinstance(tree, torch.Tensor):
        return tree.unsqueeze(0).expand((n,) + tree.shape)
    if isinstance(tree, Mapping):
        return {k: _broadcast(v, n) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_broadcast(v, n) for v in tree)
    return tree


def _default_nodes(n_dev: int) -> int:
    return 2 if n_dev % 2 == 0 and n_dev > 1 else 1


class DASO:
    """Distributed Asynchronous and Selective Optimization (reference
    dp_optimizer.py:46-180 constructor contract).

    Parameters
    ----------
    local_optimizer : callable
        The per-replica optimizer factory, such as
        ``heat_tpu_torch.optim.SGD(0.1)``.
    total_epochs : int
    comm : MeshCommunication, optional
        The shards to organize as ``nodes × ici``.
    nodes : int, optional
        Number of groups; defaults to 2 when the shard count is even.
    warmup_epochs, cooldown_epochs : int
        Full-synchronization phases at both ends (reference :60-66).
    max_global_skips : int
        Ceiling on the skip schedule.
    stability_level : float
        Plateau threshold driving the schedule (reference :336-431).
    downcast_type : torch.dtype
        Wire format of the global merge (default bfloat16).
    scheduler : optional
        Parity argument, recorded.
    sending_chunk_size, use_mpi_groups, skip_batches
        Parity arguments: the merge is one collective here.
    local_skip_factor : int
        The local skip is the global skip divided by this factor.
    """

    def __init__(
        self,
        local_optimizer: Callable,
        total_epochs: int,
        comm: Optional[MeshCommunication] = None,
        nodes: Optional[int] = None,
        warmup_epochs: int = 4,
        cooldown_epochs: int = 4,
        scheduler=None,
        stability_level: float = 0.05,
        max_global_skips: int = 8,
        sending_chunk_size: int = 10_000_000,
        downcast_type: torch.dtype = torch.bfloat16,
        use_mpi_groups: bool = True,
        skip_batches: Optional[int] = None,
        local_skip_factor: int = 4,
        verbose: bool = False,
    ):
        if not isinstance(total_epochs, int):
            raise TypeError(f"total_epochs must be an int, currently {type(total_epochs)}")
        if warmup_epochs < 0 or cooldown_epochs < 0:
            raise ValueError("warmup/cooldown epochs must be non-negative")
        self.comm = sanitize_comm(comm)
        n_dev = self.comm.size
        if nodes is None:
            nodes = _default_nodes(n_dev)
        if n_dev % nodes != 0:
            raise ValueError(f"device count {n_dev} not divisible into {nodes} DCN groups")
        self.nodes = nodes
        self._group()

        self.local_optimizer = local_optimizer
        self.total_epochs = total_epochs
        self.warmup_epochs = warmup_epochs
        self.cooldown_epochs = cooldown_epochs
        self.scheduler = scheduler
        self.max_gs = max_global_skips
        self.verbose = verbose
        self.downcast_type = downcast_type

        # skip schedule state (reference dp_optimizer.py:60-66, 432-475)
        self.global_skip = 0
        self.local_skip = 0
        self.local_skip_factor = int(local_skip_factor)
        self.batches_to_wait = 0
        self.epoch = 0
        self.current_batch = 0
        self._solo_steps = 0  # batches stepped without a group sync
        self._warned_remainder = False

        self.stability = DetectMetricPlateau(
            patience=2, threshold=stability_level, threshold_mode="rel"
        )
        self.split = None  # parity attribute

        self.module: Optional[torch.nn.Module] = None
        self.replicas: Optional[List[torch.nn.Module]] = None
        self.optimizers: Optional[List[torch.optim.Optimizer]] = None
        self.loss_fn = cross_entropy
        self._stateful = False

    def _group(self) -> None:
        """The ``nodes`` groups of ``ici`` consecutive shards (every process
        makes every group's sub-mesh, in group order)."""
        self.ici_size = self.comm.size // self.nodes
        ici = self.ici_size
        self.groups = [self.comm.sub(range(g * ici, (g + 1) * ici)) for g in range(self.nodes)]

    # ------------------------------------------------------------------
    # wiring
    # ------------------------------------------------------------------
    def add_model(self, module: torch.nn.Module, rng_seed: int, sample_input) -> "DASO":
        """Attach the network (the reference receives a DataParallelMultiGPU
        wrapper, dp_optimizer.py:197-230); every shard gets a replica."""
        self.module = module
        self._stateful = bind(module, rng_seed, as_tensor(sample_input, self.comm.home))
        self._replicate()
        return self

    def _replicate(self) -> None:
        self.replicas = replicate(self.module, self.comm.local_devices)
        self.optimizers = [self.local_optimizer(r.parameters()) for r in self.replicas]

    def _group_mean(self, flats: List[torch.Tensor]) -> List[torch.Tensor]:
        """Each replica's vector (one per rank of this process) averaged over
        its group: summed in shard order and scaled by 1/ici, as XLA's
        ``pmean`` scales."""
        if self.ici_size == 1:
            return flats
        ici = self.ici_size
        out = list(flats)
        ranks = list(self.comm.local_ranks)
        for g, group in enumerate(self.groups):
            held = [i for i, r in enumerate(ranks) if g * ici <= r < (g + 1) * ici]
            if held:
                for i, t in zip(held, group.allreduce([flats[i] for i in held])):
                    out[i] = t * (1.0 / ici)
        return out

    # ------------------------------------------------------------------
    # training surface
    # ------------------------------------------------------------------
    def step(self, x, y) -> float:
        """One DASO batch (reference dp_optimizer.py:730-815): every replica
        steps on its block of rows, synced over its group or solo by the
        local-skip cadence; the global merge when the skip schedule says so.
        Returns the mean of the replicas' losses."""
        if self.replicas is None:
            raise RuntimeError("add_model must be called before step")
        devices = self.comm.local_devices
        x, y = as_tensor(x, self.comm.home), as_tensor(y, self.comm.home)
        n_dev = self.comm.size
        rem = x.shape[0] % n_dev
        if rem:
            # equal blocks per replica, as a drop_last loader gives them
            if x.shape[0] < n_dev:
                raise ValueError(f"batch of {x.shape[0]} is smaller than the {n_dev}-device mesh")
            if not self._warned_remainder:
                warnings.warn(
                    f"batch size {x.shape[0]} is not divisible by the {n_dev}-device "
                    f"mesh; dropping the last {rem} sample(s) each step"
                )
                self._warned_remainder = True
            x, y = x[: x.shape[0] - rem], y[: y.shape[0] - rem]
        ls = self._effective_local_skip()
        solo = ls > 1 and (self.current_batch % ls) != 0
        if solo:
            self._solo_steps += 1
        else:
            # re-converge the group after a local-skip window
            means = self._group_mean([_flat(r.parameters()) for r in self.replicas])
            for r, flat in zip(self.replicas, means):
                _copy_flat(r.parameters(), flat)
        losses = []
        ranks = self.comm.local_ranks
        xbs, ybs = x.chunk(n_dev)[ranks.start:ranks.stop], y.chunk(n_dev)[ranks.start:ranks.stop]
        for replica, opt, xb, yb, d in zip(self.replicas, self.optimizers, xbs, ybs, devices):
            xb, yb = xb.to(d), yb.to(d)
            out = replica(xb, train=True) if self._stateful else replica(xb)
            loss = self.loss_fn(out, yb)
            opt.zero_grad()
            loss.backward()
            losses.append(loss.detach())
        if not solo:
            for r, flat in zip(self.replicas, self._group_mean([flat_grads(r) for r in self.replicas])):
                set_grads(r, flat)
        for opt in self.optimizers:
            opt.step()
        if self._stateful and not solo:
            for r, flat in zip(self.replicas, self._group_mean([_flat(r.buffers()) for r in self.replicas])):
                _copy_flat(r.buffers(), flat)

        self.current_batch += 1
        if self.comm.spans_processes:
            # every rank's loss, in rank order
            losses = self.comm.allgather([loss.reshape(1) for loss in losses])[0]
        value = sum(loss.item() for loss in losses) / n_dev
        gs = self._effective_global_skip()
        if gs == 0 or self.current_batch % (gs + 1) == 0:
            # the numerics lens's per-merge stream over every replica (the
            # flat copies are taken before the merge writes in place)
            pre = [_flat(r.parameters()) for r in self.replicas] if numlens._MODE else None
            self._merge(float(min(self.batches_to_wait, gs)))
            if pre is not None:
                numlens.note_training("daso.merge", loss=value, params=[_flat(r.parameters()) for r in self.replicas],
                                      prev_params=pre)
        return value

    def _merge(self, waits: float) -> None:
        """Stale-weighted global merge (reference dp_optimizer.py:501-589):
        every replica's parameters travel in the wire dtype; their sum,
        accumulated in float32 and rounded once to the wire dtype, is scaled
        by 1/p in float32 (what the JAX package's jitted ``pmean`` of
        bfloat16 followed by its cast computes), and the global mean is
        blended with the local
        parameters as (global + waits·local)/(waits + 1)."""
        local = [_flat(r.parameters()) for r in self.replicas]
        wire = [t.to(self.downcast_type) for t in local]
        totals = self.comm.allreduce(wire, op=lambda a, b: a.float() + b.float())
        for replica, total, own in zip(self.replicas, totals, local):
            gmean = total.to(self.downcast_type).to(own.dtype) * (1.0 / self.comm.size)
            _copy_flat(replica.parameters(), (gmean + waits * own) / (waits + 1.0))

    def _effective_global_skip(self) -> int:
        if self.epoch < self.warmup_epochs or self.epoch >= self.total_epochs - self.cooldown_epochs:
            return 0
        return self.global_skip

    def _effective_local_skip(self) -> int:
        """Group-sync cadence: synced in warmup and cooldown, the scheduled
        ``local_skip`` while cycling."""
        if self.epoch < self.warmup_epochs or self.epoch >= self.total_epochs - self.cooldown_epochs:
            return 0
        return self.local_skip

    def epoch_loss_logic(self, loss, loss_globally_averaged: bool = False) -> None:
        """End-of-epoch schedule update (reference dp_optimizer.py:336-431):
        entering the cycling phase starts at 4 global skips; a loss plateau
        halves the skips; stability at one skip resets them upward."""
        loss_val = float(loss)
        self.epoch += 1
        self.current_batch = 0
        if self.epoch == self.warmup_epochs:
            self.global_skip = 4
            self.local_skip = max(1, 4 // self.local_skip_factor)
            self.batches_to_wait = 1
            self._print0(f"warmup done; global_skips={self.global_skip}")
            return
        if self.epoch < self.warmup_epochs or self.epoch > self.total_epochs - self.cooldown_epochs:
            return
        stable = self.stability.test_if_improving(loss_val)
        if stable and self.global_skip > 1:
            self.global_skip //= 2
            self.local_skip = max(1, self.local_skip // 2)
            self.batches_to_wait = max(self.batches_to_wait // 2, 1)
            self._print0(f"loss plateau; global_skips -> {self.global_skip}")
        elif self.global_skip == 1 and stable:
            self.global_skip = min(self.max_gs, 4)
            self.local_skip = max(1, self.global_skip // self.local_skip_factor)
            self.batches_to_wait = 1
            self.stability.reset()
            self._print0(f"resetting skips upward -> {self.global_skip}")

    def _print0(self, msg: str) -> None:
        if self.verbose and self.comm.rank == 0:
            print(f"[DASO] {msg}")

    def forward(self, x) -> torch.Tensor:
        """Replica 0's forward, with its running averages."""
        x = as_tensor(x, self.comm.home)
        return self.module(x, train=False) if self._stateful else self.module(x)

    __call__ = forward

    def zero_grad(self) -> None:
        """Clear every replica's gradients (reference dp_optimizer.py:816-833)."""
        for opt in self.optimizers or ():
            opt.zero_grad()

    # ------------------------------------------------------------------
    # checkpoint / resume
    # ------------------------------------------------------------------
    def _schedule(self) -> dict:
        return {
            "epoch": self.epoch,
            "current_batch": self.current_batch,
            "global_skip": self.global_skip,
            "local_skip": self.local_skip,
            "batches_to_wait": self.batches_to_wait,
        }

    def _load_schedule(self, sd: Mapping) -> None:
        for key, value in sd["schedule"].items():
            setattr(self, key, int(value))
        self.stability.set_state(sd["stability"])

    def state_dict(self) -> dict:
        """Full resumable state; every tensor has a leading replica axis, so
        it restores onto a mesh of the same size."""
        return {
            "params": _stack([{n: p.detach() for n, p in r.named_parameters()} for r in self.replicas]),
            "state": _stack([dict(r.named_buffers()) for r in self.replicas]),
            "opt_state": _stack([o.state_dict() for o in self.optimizers]),
            "schedule": self._schedule(),
            "stability": self.stability.get_state(),
        }

    def load_state_dict(self, sd: Mapping) -> "DASO":
        for i, (replica, opt) in enumerate(zip(self.replicas, self.optimizers)):
            load_tree(replica, {**_take(sd["params"], i), **_take(sd["state"], i)})
            opt.load_state_dict(_take(sd["opt_state"], i))
        self._load_schedule(sd)
        return self

    def elastic_state_dict(self) -> dict:
        """Mesh-size-independent resumable state: the replica axis merged out
        (floating tensors averaged, others from replica 0), exact whenever
        the replicas agree (warmup, cooldown, right after a merge)."""
        sd = self.state_dict()
        for key in ("params", "state", "opt_state"):
            sd[key] = _take(sd[key], None)
        return sd

    def load_elastic_state_dict(self, sd: Mapping) -> "DASO":
        """Restore :meth:`elastic_state_dict` state onto the current mesh:
        every replica gets the merged one."""
        n = self.comm.size
        return self.load_state_dict({
            **sd, **{k: _broadcast(sd[k], n) for k in ("params", "state", "opt_state")}
        })

    def save(self, directory: str, step: int = 0, keep: int = 3) -> str:
        """Write :meth:`state_dict` (the replica axis included) as the
        checkpoint ``directory/ckpt_{step}.manifest.json``; keep the newest
        ``keep`` (reference dp_optimizer.py:547-553)."""
        from ..utils.checkpoint import save_checkpoint

        return save_checkpoint(directory, self.state_dict(), step=step, keep=keep)

    def restore(self, directory: str, step=None, strict: bool = False) -> "DASO":
        """Resume from a checkpoint written by :meth:`save` onto a mesh of
        the same size: the newest that verifies for ``step=None``, else that
        step (reference dp_optimizer.py:555-570)."""
        from ..nn.data_parallel import _template
        from ..utils.checkpoint import load_checkpoint

        return self.load_state_dict(load_checkpoint(directory, _template(self.state_dict()), step=step, strict=strict))

    def rebind(self, comm: Optional[MeshCommunication] = None) -> "DASO":
        """Re-target the trainer onto another mesh: the merged state carries
        over, the group count falls back to the default where it no longer
        divides the shard count."""
        sd = self.elastic_state_dict() if self.replicas is not None else None
        self.comm = sanitize_comm(comm)
        n_dev = self.comm.size
        if self.nodes > n_dev or n_dev % self.nodes != 0:
            self.nodes = _default_nodes(n_dev)
        self._group()
        if sd is not None:
            self.module.to(self.comm.home)
            self._replicate()
            self.load_elastic_state_dict(sd)
        return self
