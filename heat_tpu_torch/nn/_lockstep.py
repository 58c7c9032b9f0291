"""Whole-batch statistics for the shards of one batch.

heat_tpu's ``DataParallel`` runs its step as one program over the
row-sharded batch, so a BatchNorm there normalizes with the mean and
variance of the whole batch, not of a shard. The port runs one replica per
shard. :class:`Lockstep` runs their forwards on one worker thread each;
the threads meet at every BatchNorm, and the last to arrive normalizes
every shard at once through :class:`_CrossShardNorm`, one autograd node whose
forward reduces Σx and Σx² over the mesh and whose backward reduces Σdy and
Σdy·x̂ the same way. The caller then runs one ``backward()`` from its own
thread: in one process no collective waits inside autograd, so the shards
may share one device. Over a mesh whose ranks span processes each process
runs the threads of its own ranks, and each meeting's sums, forward and
backward, go across processes through the mesh's ``allreduce``, the
forward's with each shard's count of values: every process meets at every
BatchNorm, in the same order.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor, wait
from typing import Callable, List, Optional, Sequence

import torch

__all__ = ["Lockstep", "current"]

_local = threading.local()


def current() -> Optional["_Meeting"]:
    """The meeting of the calling thread's lockstep run, or None outside one."""
    return getattr(_local, "meeting", None)


class Lockstep:
    """Runs the forwards of a mesh's shards in lockstep, shard r on a worker
    thread of its own (an executor of one thread: a run never waits for a
    thread that another shard holds), for this process's ranks. The
    workers persist from run to run: torch keeps caches per thread (cuDNN's
    execution plans among them), which a new thread would build again at
    every step.

    Parameters
    ----------
    comm : MeshCommunication
        The mesh; its ``allreduce`` combines the statistics in shard order,
        with zeros for the shards that hold no rows.
    """

    def __init__(self, comm):
        self.comm = comm
        self._workers = {
            r: ThreadPoolExecutor(max_workers=1, thread_name_prefix=f"shard-{r}") for r in comm.local_ranks
        }

    def run(self, active: Sequence[int], fns: Sequence[Callable[[], torch.Tensor]]) -> List[torch.Tensor]:
        """Call ``fns[i]``, the forward of shard ``active[i]`` (a rank of this
        process), on that shard's worker and return their results in order;
        a failure in one breaks every meeting and is raised here."""
        meeting = _Meeting(self.comm, active)
        futures = [
            self._workers[r].submit(meeting.work, slot, fn) for slot, (r, fn) in enumerate(zip(active, fns))
        ]
        wait(futures)
        failures = [f.exception() for f in futures if f.exception() is not None]
        if failures:
            raise next(
                (e for e in failures if not isinstance(e, threading.BrokenBarrierError)), failures[0]
            )
        return [f.result() for f in futures]


class _Meeting:
    """One lockstep run: the active shards meet at every BatchNorm."""

    def __init__(self, comm, active: Sequence[int]):
        self.comm = comm
        self.active = list(active)
        self._posted: List = [None] * len(self.active)
        self._normalized: List[torch.Tensor] = []
        self._barrier = threading.Barrier(len(self.active), action=self._meet)

    def work(self, slot: int, fn: Callable[[], torch.Tensor]) -> torch.Tensor:
        _local.meeting, _local.slot = self, slot
        try:
            return fn()
        except Exception:
            self._barrier.abort()  # release the shards waiting at a meeting
            raise
        finally:
            _local.meeting = None

    def normalize(self, layer, x: torch.Tensor) -> torch.Tensor:
        """x̂ of this thread's shard at one BatchNorm, normalized with the
        whole batch's statistics; waits for every other shard."""
        slot = _local.slot
        self._posted[slot] = (layer, x)
        self._barrier.wait()
        return self._normalized[slot]

    def _meet(self) -> None:
        # run by the last thread to arrive, before any thread is released;
        # the results of the previous meeting were read by then
        layers, xs = zip(*self._posted)
        self._normalized = list(_CrossShardNorm.apply(self, layers, *xs))

    def allreduce(self, values: Sequence[tuple]) -> List[tuple]:
        """Sum one tuple of tensors per active shard over the whole mesh, in
        shard order (zeros for this process's other shards); each active
        shard gets the sums on its own device."""
        first = self.comm.first_rank
        full = [None] * len(self.comm.local_devices)
        for r, v in zip(self.active, values):
            full[r - first] = v
        for i, d in enumerate(self.comm.local_devices):
            if full[i] is None:
                full[i] = tuple(torch.zeros_like(t, device=d) for t in values[0])
        summed = self.comm.allreduce(full)
        return [summed[r - first] for r in self.active]


def _channel_view(t: torch.Tensor, ndim: int) -> torch.Tensor:
    return t.view((1, -1) + (1,) * (ndim - 2))


class _CrossShardNorm(torch.autograd.Function):
    """x̂ = (x − μ)/sqrt(σ² + eps) of every shard, with μ and the biased σ²
    of the whole batch (flax's E[x²] − E[x]², clamped at 0) over every axis
    but the channel axis 1."""

    @staticmethod
    def forward(ctx, meeting: _Meeting, layers, *xs):
        ndim = xs[0].dim()
        dims = [d for d in range(ndim) if d != 1]
        counts = [x.numel() // x.shape[1] for x in xs]
        values = [(x.sum(dims), (x * x).sum(dims)) for x in xs]
        spanning = meeting.comm.spans_processes
        if spanning:
            # the other processes' shards are counted through the verb
            values = [v + (torch.tensor(c, device=x.device),) for v, c, x in zip(values, counts, xs)]
        sums = meeting.allreduce(values)
        n = int(sums[0][2]) if spanning else sum(counts)
        xhats, invstds = [], []
        for x, (s1, s2, *_), layer in zip(xs, sums, layers):
            mean = s1 / n
            var = torch.clamp(s2 / n - mean * mean, min=0.0)
            invstd = torch.rsqrt(var + layer.eps)
            xhats.append((x - _channel_view(mean, ndim)) * _channel_view(invstd, ndim))
            invstds.append(invstd)
            layer.update_averages(mean, var)
        ctx.meeting, ctx.n, ctx.dims = meeting, n, dims
        ctx.save_for_backward(*xhats, *invstds)
        return tuple(xhats)

    @staticmethod
    def backward(ctx, *dys):
        saved = ctx.saved_tensors
        k = len(dys)
        xhats, invstds = saved[:k], saved[k:]
        ndim, n = xhats[0].dim(), ctx.n
        sums = ctx.meeting.allreduce(
            [(dy.sum(ctx.dims), (dy * xh).sum(ctx.dims)) for dy, xh in zip(dys, xhats)]
        )
        dxs = [
            _channel_view(invstd, ndim)
            * (dy - _channel_view(a / n, ndim) - xh * _channel_view(b / n, ndim))
            for dy, xh, invstd, (a, b) in zip(dys, xhats, invstds, sums)
        ]
        return (None, None, *dxs)
